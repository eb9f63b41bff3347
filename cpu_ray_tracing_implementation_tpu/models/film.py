"""Film: tone mapping + image output.

Replaces reference src/color.h:16-36 (gamma 1/2.2 then "R G B" PPM rows).
Divergence fix (SURVEY.md appendix item 1): the reference never clamps, so
emissive pixels >1.0 write bytes >255 into the P3 file; we clamp to [0, 1).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import jax.numpy as jnp

GAMMA = 1.0 / 2.2


def linear_to_gamma(img: jnp.ndarray) -> jnp.ndarray:
    return jnp.power(jnp.maximum(img, 0.0), GAMMA)


def tonemap(img, mode: str | None = None):
    """HDR -> displayable-range operator applied BEFORE gamma.

    None/"none": the reference behavior (hard clamp at the byte stage —
    emissive pixels blow out). "reinhard": x/(1+x). "aces": the
    Narkowicz 2015 rational fit of the ACES filmic curve. Both map
    radiance >1 smoothly into [0,1) instead of clipping highlights."""
    x = jnp.maximum(jnp.asarray(img), 0.0)
    if mode in (None, "none"):
        return x
    if mode == "reinhard":
        return x / (1.0 + x)
    if mode == "aces":
        return jnp.clip((x * (2.51 * x + 0.03))
                        / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)
    raise ValueError(f"unknown tonemap mode {mode!r}")


def to_bytes(img, tonemap_mode: str | None = None) -> np.ndarray:
    """linear [H,W,3] float -> uint8: optional tone map, gamma 1/2.2,
    clamp."""
    g = np.asarray(linear_to_gamma(tonemap(jnp.asarray(img),
                                           tonemap_mode)))
    g = np.nan_to_num(g, nan=0.0, posinf=1.0, neginf=0.0)
    return (255.999 * np.clip(g, 0.0, 0.999)).astype(np.uint8)


def write_ppm(path: str, img) -> None:
    """P3 PPM, matching the reference's output container (src/camera.h:149-151)."""
    data = to_bytes(img)
    h, w, _ = data.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        flat = data.reshape(-1, 3)
        f.write("\n".join(f"{r} {g} {b}" for r, g, b in flat))
        f.write("\n")


def encode_png(data: np.ndarray) -> bytes:
    """8-bit RGB PNG of a [H,W,3] uint8 array (zlib + struct only)."""
    h, w, _ = data.shape

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    # filter type 0 (None) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(data, np.uint8).reshape(h, -1)],
                         axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img, tonemap_mode: str | None = None) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(to_bytes(img, tonemap_mode)))


def write_exr(path: str, img, half: bool = False) -> None:
    """Full-fidelity linear-radiance HDR output (no gamma, no clamp) via
    the self-contained EXR codec (utils/exr.py) — the output side the
    reference's vendored tinyexr never exposes."""
    from cpu_ray_tracing_implementation_tpu.utils import exr

    a = np.asarray(img, np.float32)  # handles numpy AND jax arrays
    exr.write_exr(path, np.nan_to_num(a, nan=0.0), half=half)
