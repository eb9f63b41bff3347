"""Film / image-IO / CLI tests (reference: src/color.h, src/image.h,
src/main.cc stdin menu)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracing_implementation_tpu.models import film
from cpu_ray_tracing_implementation_tpu.utils import image_io


def test_gamma_and_clamp():
    """Gamma 1/2.2 with clamp — fixing the reference's >255 overflow for
    emissive pixels (src/color.h:32-35, SURVEY appendix item 1)."""
    img = jnp.array([[[0.0, 1.0, 4.0]]])
    b = film.to_bytes(img)
    assert b.dtype == np.uint8
    assert b[0, 0, 0] == 0
    assert b[0, 0, 1] == 255  # exactly 1.0 clamps to max
    assert b[0, 0, 2] == 255  # >1.0 emissive clamps instead of overflowing


def test_gamma_midtone():
    img = jnp.array([[[0.5, 0.5, 0.5]]])
    b = film.to_bytes(img)
    expect = int(255.999 * 0.5 ** (1 / 2.2))
    assert abs(int(b[0, 0, 0]) - expect) <= 1


def test_nan_pixels_dont_poison_output():
    img = jnp.array([[[jnp.nan, jnp.inf, -1.0]]])
    b = film.to_bytes(img)
    assert b[0, 0, 0] == 0 and b[0, 0, 1] == 255 and b[0, 0, 2] == 0


def test_ppm_roundtrip(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import parity_check

    img = np.random.default_rng(0).uniform(0, 1, (4, 5, 3)).astype(np.float32)
    path = str(tmp_path / "t.ppm")
    film.write_ppm(path, img)
    back = parity_check.read_ppm(path)
    assert back.shape == (4, 5, 3)
    # write applies gamma; compare against the gamma-encoded original
    expect = np.asarray(film.to_bytes(jnp.asarray(img))) / 255.0
    np.testing.assert_allclose(back, expect, atol=0.005)


def test_image_loader_missing_file_magenta():
    arr = image_io.load_image("/nonexistent/file.png")
    assert arr.shape == (1, 1, 3)
    np.testing.assert_array_equal(arr[0, 0], [255.0, 0.0, 255.0])


def _decode_png(blob):
    """(width, height, [H,W,3] uint8) of an 8-bit RGB, filter-0 PNG."""
    import struct
    import zlib

    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag, body = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()     # filter type None on every row
    return w, h, rows[:, 1:].reshape(h, w, 3)


def test_write_png_round_trips_through_zlib(tmp_path):
    img = np.random.default_rng(0).random((5, 7, 3)) * 1.5
    path = tmp_path / "x.png"
    film.write_png(str(path), img)
    w, h, data = _decode_png(path.read_bytes())
    assert (w, h) == (7, 5)
    np.testing.assert_array_equal(data, film.to_bytes(img))


def test_write_png_needs_no_pillow(tmp_path, monkeypatch):
    """PNG output is standard library only: PIL is optional (textures)."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.zeros((2, 3, 3)); img[0, 1] = (1.0, 0.5, 0.0)
    path = tmp_path / "y.png"
    film.write_png(str(path), img, tonemap_mode="aces")
    _, _, data = _decode_png(path.read_bytes())
    np.testing.assert_array_equal(data, film.to_bytes(img, "aces"))


def test_earthmap_loads_if_present():
    p = image_io.reference_asset("earthmap.jpg")
    if not os.path.exists(p):
        return
    arr = image_io.load_image(p)
    assert arr.ndim == 3 and arr.shape[-1] == 3
    assert 0 <= arr.min() and arr.max() <= 255.0


def test_procedural_sky_shape_and_range():
    sky = image_io.procedural_sky(height=32, width=64)
    assert sky.shape == (32, 64, 3)
    assert (sky >= 0).all() and (sky <= 255).all()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"   # the CLI subprocess renders on the CPU
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "render.py"), *args],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def test_cli_list():
    r = _run_cli(["--list"], cwd=REPO)
    assert r.returncode == 0
    assert "cornell_box" in r.stdout
    # 22 reference scenes + catalog extensions (see catalog.SCENES)
    from cpu_ray_tracing_implementation_tpu.models import catalog

    assert len(r.stdout.strip().splitlines()) == len(catalog.SCENES)


def test_cli_render_and_config_roundtrip(tmp_path):
    out = str(tmp_path / "ws.png")
    cfg = str(tmp_path / "cfg.json")
    r = _run_cli(["white_sphere", "--width", "8", "--spp", "1",
                  "--max-depth", "2", "-o", out, "--save-config", cfg],
                 cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)
    saved = json.load(open(cfg))
    assert saved["scene"] == "white_sphere" and saved["width"] == 8

    out2 = str(tmp_path / "ws2.png")
    r2 = _run_cli(["--config", cfg, "-o", out2], cwd=str(tmp_path))
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert os.path.exists(out2)
