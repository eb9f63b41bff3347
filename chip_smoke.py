"""Smoke test of the path tracer on NVIDIA GPUs, through the user entry points.

    python chip_smoke.py               # one GPU: phases 1-5 below
    python chip_smoke.py --devices 4   # four GPUs: the sharded paths only

Phases on one GPU, in order; any failure exits nonzero:

1. device check: the first JAX device must be a GPU (no CPU fallback);
2. the fused cull+select kernel (ops/pallas_select.py), compiled for the
   card, against the XLA near-matrix select at the colonnade's real widths
   (K = 2015 chunk boxes, V = 16, R = 8192 camera and bounce rays), and the
   per-ray closest hit through it against the chunk-scan oracle;
3. seven catalog scenes at the golden workload (16 px, 4 spp, depth 3,
   key 42), rendered on the GPU and on the CPU in this process;
4. the main path at full width: ``render.main`` on Cornell 512 px 256 spp
   depth 8, the colonnade and the sphereflake at their reference workloads,
   and ``diff.loss_and_grads`` on Cornell 512 px 256 spp depth 8 (one step
   that compiles, one warm);
5. the ``gpu``-marked tests (tests/test_gpu_kernels.py), in process.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; it is printed
only when every phase passed. Images go to chiprun_out/smoke/.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

OUT_DIR = os.path.join("chiprun_out", "smoke")
T_MIN = 1e-3          # the integrator's ray-interval start (models/integrator.py)

# Phase 2 tolerances. The kernel's nears are the exact nears with the low
# IDB mantissa bits cleared, so they lie in [exact * (1 - 2^-(23-IDB)),
# exact]; ids agree except where two chunks' coarsened nears tie (then the
# kernel orders by id). Through planar_closest_perray the kernel route and
# the XLA select route run the same sweep arithmetic: t must be bitwise
# equal, pid equal except at exact-t ties. Against the chunk-scan oracle
# (einsum form) t agrees to rounding, rtol 1e-5, pid except at ties within
# that rtol. Neither formulation is watertight: on a ray that grazes a
# shared edge, or leaves its surface at a grazing angle within a few T_MIN,
# rounding decides which triangle is hit. Such rays are printed and capped
# at EDGE_MAX_SHARE of the batch.
T_RTOL = 1e-5
EDGE_MAX_SHARE = 1e-3
# Phase 3: the golden test's tolerance, applied per pixel on average.
GOLDEN_WORKLOAD = dict(width=16, spp=4, max_depth=3)
GOLDEN_SCENES = ("cornell_box", "cornell_box_with_volume", "sphereflake",
                 "sponza", "dispersion_prism", "sunlit_spheres",
                 "three_material_ball_with_defocus_blur")
MEAN_ABS_TOL = 2e-3
# --devices 4: the sharded results against one card. Per-path radiance is
# keyed by (pixel, sample), so only the summation order differs.
SHARD_RTOL, SHARD_ATOL = 1e-4, 1e-5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}") from e
    return out.strip()


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


# ------------------------------------------------------------------ phase 2
def colonnade_rays(scene, cam, R: int, seed: int):
    """[(org, dirs)] for R camera rays at random pixels and one bounce of
    cosine-ish scattered rays from their hits (misses keep the camera ray)."""
    import jax
    import jax.numpy as jnp

    from cpu_ray_tracing_implementation_tpu.models import camera as cam_mod
    from cpu_ray_tracing_implementation_tpu.ops import chunked

    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    pix = jax.random.randint(k1, (R,), 0, cam.width * cam.height)
    org, dirs, _ = cam_mod.generate_rays(cam, pix,
                                         jax.random.uniform(k2, (R, 5)))
    t, (unorm, *_rest) = chunked.planar_closest(org, dirs, scene.tri_chunks,
                                                T_MIN, triangle=True)
    hit = jnp.isfinite(t)
    p = org + jnp.where(hit, t, 0.0)[:, None] * dirs
    n = jnp.where((jnp.sum(dirs * unorm, -1) < 0)[:, None], unorm, -unorm)
    r = jax.random.normal(k3, (R, 3))
    d2 = n + r / jnp.linalg.norm(r, axis=-1, keepdims=True)
    d2 = d2 / jnp.maximum(jnp.linalg.norm(d2, axis=-1, keepdims=True), 1e-12)
    org2 = jnp.where(hit[:, None], p, org)
    dirs2 = jnp.where(hit[:, None], d2, dirs)
    return [("camera", org, dirs), ("bounce", org2, dirs2)]


def coarsen(x, idb: int):
    import numpy as np

    bits = np.asarray(x, np.float32).view(np.int32) & np.int32(-(1 << idb))
    return bits.view(np.float32)


def compare_select(ids_k, nears_k, ids_x, nears_x, rest_x_coarse_extra, idb):
    """Kernel lists against the exact XLA lists of the same phase. Returns
    the number of slots whose ids differ at a coarsened-near tie; raises
    on any other difference. ``rest_x_coarse_extra``: coarsened exact nears
    that continue the XLA order past these lists (for ties that straddle
    the list's end)."""
    import numpy as np

    ids_k, nears_k = np.asarray(ids_k), np.asarray(nears_k)
    ids_x, nears_x = np.asarray(ids_x), np.asarray(nears_x)
    fin = np.isfinite(nears_x)
    check((np.isfinite(nears_k) == fin).all(), "finite slots differ")
    nk, nx = nears_k[fin], nears_x[fin]
    rel = 2.0 ** -(23 - idb)
    check((nk <= nx).all(), f"kernel near above exact: {np.max(nk - nx)}")
    check((nk >= nx * (1 - rel)).all(), "kernel near below the packed bound")
    cx = np.where(fin, coarsen(nears_x, idb), np.inf)
    order = np.concatenate([cx, rest_x_coarse_extra], axis=1)
    ties = 0
    for r, v in zip(*np.nonzero((ids_k != ids_x) & fin)):
        same = np.sum(order[r] == cx[r, v])
        check(same > 1, f"ray {r} slot {v}: id {ids_k[r, v]} vs "
                        f"{ids_x[r, v]} without a tie")
        ties += 1
    return ties


def phase_kernel_parity(dev):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cpu_ray_tracing_implementation_tpu.models import catalog
    from cpu_ray_tracing_implementation_tpu.ops import chunked
    from cpu_ray_tracing_implementation_tpu.ops import pallas_select as ps
    from cpu_ray_tracing_implementation_tpu.ops import perray

    scene, cam = catalog.sponza()
    chunks = scene.tri_chunks
    K = chunks.lo.shape[0]
    V, R = 16, 8192
    check(K == 2015, f"colonnade has {K} chunks, expected 2015")
    check(perray._use_select_kernel(T_MIN), "GPU route does not pick kernel")
    idb = ps.id_bits(K)
    boxes = ps.pack_boxes(chunks.lo, chunks.hi)
    for label, org, dirs in colonnade_rays(scene, cam, R, seed=7):
        cap = jnp.full((R,), jnp.inf)
        nr = perray._near_matrix(org, dirs, chunks.lo, chunks.hi, T_MIN, cap)
        ids_x1, nears_x1, nr2 = perray._select_block(nr, V)
        ids_x2, nears_x2, nr3 = perray._select_block(nr2, V)
        _, nears_x3, _ = perray._select_block(nr3, 2)
        rays, Rp = ps.pack_rays(org, dirs, cap)
        t0 = time.time()
        ids_k1, nears_k1, _ = ps.cull_select(
            rays, boxes, jnp.zeros((Rp,), jnp.int32), V, K, T_MIN)
        ids_k1.block_until_ready()
        t_first = time.time() - t0
        ids_k2, nears_k2, rest_k2 = ps.cull_select(
            rays, boxes, ps.last_key(ids_k1, nears_k1), V, K, T_MIN)
        c2 = np.where(np.isfinite(nears_x2), coarsen(nears_x2, idb), np.inf)
        c3 = np.where(np.isfinite(nears_x3), coarsen(nears_x3, idb), np.inf)
        ties1 = compare_select(ids_k1, nears_k1, ids_x1, nears_x1, c2, idb)
        # phase 2 continues the order of phase 1: ties may straddle both
        c1 = np.where(np.isfinite(nears_x1), coarsen(nears_x1, idb), np.inf)
        ties2 = compare_select(ids_k2, nears_k2, ids_x2, nears_x2,
                               np.concatenate([c1, c3], axis=1), idb)
        rest_x2 = np.asarray(nears_x3)[:, 0]
        rk2 = np.asarray(rest_k2)
        fin = np.isfinite(rest_x2)
        check((np.isfinite(rk2) == fin).all(), "rest finite slots differ")
        check((rk2[fin] <= rest_x2[fin]).all(), "rest above exact")

        t_k, p_k = closest(org, dirs, chunks, kernel=True)
        t_x, p_x = closest(org, dirs, chunks, kernel=False)
        t_o, (_, _, _, _, p_o) = chunked.planar_closest(
            org, dirs, chunks, T_MIN, triangle=True)
        t_k, t_x, t_o = np.asarray(t_k), np.asarray(t_x), np.asarray(t_o)
        p_k, p_x, p_o = np.asarray(p_k), np.asarray(p_x), np.asarray(p_o)
        np.testing.assert_array_equal(t_k, t_x, "kernel vs XLA select route")
        route_ties = int(np.sum(p_k != p_x))
        hit = np.isfinite(t_o) & np.isfinite(t_k)
        with np.errstate(invalid="ignore"):
            agree = (hit & (np.abs(t_k - t_o) <= T_RTOL * np.abs(t_o))) | (
                ~np.isfinite(t_o) & ~np.isfinite(t_k))
        edge = np.nonzero(~agree)[0]
        for r in edge[:8]:
            print(f"    {label} ray {r}: t {t_k[r]:.6g} (kernel) vs "
                  f"{t_o[r]:.6g} (oracle), pid {p_k[r]} vs {p_o[r]}")
        check(len(edge) <= EDGE_MAX_SHARE * R,
              f"{label}: {len(edge)} rays disagree with the oracle")
        ok = hit & agree
        oracle_ties = int(np.sum(ok & (p_k != p_o)))
        print(f"  {label}: select compile+run {t_first:.2f} s; id ties "
              f"phase1 {ties1} phase2 {ties2}; hits {int(hit.sum())}/{R}; "
              f"pid ties vs XLA route {route_ties}, vs oracle "
              f"{oracle_ties}; edge/grazing disagreements {len(edge)}; "
              f"max rel dt {np.max(np.abs(t_k[ok] - t_o[ok]) / t_o[ok]):.2e}")


def closest(org, dirs, chunks, kernel: bool):
    """(t, pid) of planar_closest_perray through the kernel or XLA select."""
    import jax

    from cpu_ray_tracing_implementation_tpu.ops import perray

    route = perray._use_select_kernel
    if not kernel:
        perray._use_select_kernel = lambda tmin: False
    try:
        t, payload = jax.jit(lambda o, d, c: perray.planar_closest_perray(
            o, d, c, T_MIN, True))(org, dirs, chunks)
        return t, payload[4]
    finally:
        perray._use_select_kernel = route


# ------------------------------------------------------------------ phase 3
def phase_gpu_vs_cpu():
    import jax
    import numpy as np

    from cpu_ray_tracing_implementation_tpu.models import catalog, integrator

    cpu = jax.devices("cpu")[0]

    def render(name):
        scene, cam = catalog.SCENES[name](**GOLDEN_WORKLOAD)
        return np.asarray(integrator.render_image(scene, cam,
                                                  jax.random.key(42)))

    for name in GOLDEN_SCENES:
        g = render(name)
        with jax.default_device(cpu):
            c = render(name)
        d = np.abs(g - c)
        print(f"  {name}: mean |d| {d.mean():.3e}, max {d.max():.3e}, "
              f"share > 1e-3 {np.mean(d.max(-1) > 1e-3):.4f}, "
              f"means gpu {g.mean():.6f} cpu {c.mean():.6f}")
        check(np.isfinite(g).all(), f"{name}: non-finite GPU pixels")
        check(d.mean() <= MEAN_ABS_TOL, f"{name}: mean |d| {d.mean()}")


# ------------------------------------------------------------------ phase 4
FULL_WIDTH_RENDERS = (
    ["cornell_box", "--width", "512", "--spp", "256", "--max-depth", "8"],
    ["sponza"], ["sphereflake"])
GRAD_STEP = dict(width=512, spp=256, max_depth=8)


def phase_full_width(dev, renders=FULL_WIDTH_RENDERS, grad=GRAD_STEP):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import render
    from cpu_ray_tracing_implementation_tpu.models import catalog, diff, film
    from cpu_ray_tracing_implementation_tpu.utils import accel

    check(accel.native_available(), "native BVH builder fell back to numpy")
    captured = {}
    write_png = film.write_png

    def capture(path, img, **kw):
        captured[path] = np.asarray(img)
        write_png(path, img, **kw)

    film.write_png = capture
    try:
        for argv in renders:
            out = os.path.join(OUT_DIR, f"{argv[0]}.png")
            t0 = time.time()
            rc = render.main(argv + ["-o", out])
            dt = time.time() - t0
            check(rc == 0, f"render.main{argv} returned {rc}")
            img = captured[out]
            check(np.isfinite(img).all(), f"{argv[0]}: non-finite pixels")
            check(img.mean() > 1e-3, f"{argv[0]}: black image")
            print(f"  render.main {' '.join(argv)}: wall {dt:.2f} s incl. "
                  f"compile, mean {img.mean():.4f}, peak_bytes_in_use "
                  f"{peak_bytes(dev)}")
    finally:
        film.write_png = write_png

    scene, cam = catalog.cornell_box(**grad)
    target = jnp.zeros((cam.height, cam.width, 3))
    walls = []
    for seed in (0, 1):        # the second call runs the compiled step
        t0 = time.time()
        loss, (gs, gc) = diff.loss_and_grads(scene, cam, jax.random.key(seed),
                                             target, spp=cam.spp)
        leaves = jax.tree.leaves((loss, gs, gc))
        jax.block_until_ready(leaves)
        walls.append(time.time() - t0)
        check(all(np.isfinite(np.asarray(x)).all() for x in leaves),
              "non-finite gradients")
        check(np.abs(np.asarray(gs["tex_color0"])).max() > 0,
              "tex_color0 gradient is zero")
    print(f"  diff.loss_and_grads cornell {grad}: wall {walls[0]:.2f} s "
          f"incl. compile, {walls[1]:.2f} s warm, loss {float(loss):.6f}, "
          f"peak_bytes_in_use {peak_bytes(dev)}")


# ------------------------------------------------------------------ phase 5
def phase_gpu_tests():
    import pytest

    class Tally:
        def __init__(self):
            self.counts = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.counts[report.outcome] = (
                    self.counts.get(report.outcome, 0) + 1)

    tally = Tally()
    # --noconftest: tests/conftest.py pins the suite to 8 virtual CPU devices
    rc = pytest.main(["-q", "-m", "gpu", "--noconftest", "-p",
                      "no:cacheprovider", "tests/test_gpu_kernels.py"],
                     plugins=[tally])
    print(f"  gpu tests: {tally.counts}")
    check(rc == 0, f"pytest exit code {rc}")
    check(tally.counts.get("passed", 0) > 0
          and not tally.counts.get("skipped")
          and not tally.counts.get("failed"), "gpu tests did not all pass")


# ------------------------------------------------------------ four devices
SHARDED_RENDER = dict()                      # the colonnade's own workload
SHARDED_GRAD = dict(width=512, spp=256, max_depth=8)


def phase_sharded(devs, render=SHARDED_RENDER, grad=SHARDED_GRAD):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cpu_ray_tracing_implementation_tpu.models import catalog, diff
    from cpu_ray_tracing_implementation_tpu.models import integrator
    from cpu_ray_tracing_implementation_tpu.parallel import mesh as pm

    mesh = pm.make_mesh(devs)
    key = jax.random.key(0)

    def compare(label, a, b):
        a, b = np.asarray(a), np.asarray(b)
        bitwise = a.shape == b.shape and np.array_equal(a, b)
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        print(f"    {label}: bitwise {bitwise}, max |d| {err:.3e}")
        np.testing.assert_allclose(a, b, rtol=SHARD_RTOL, atol=SHARD_ATOL,
                                   err_msg=label)

    scene, cam = catalog.sponza(**render)
    t0 = time.time()
    one = integrator.render_image_wavefront(scene, cam, key)
    one = np.asarray(one)
    t1 = time.time()
    shard = np.asarray(pm.render_image_wavefront_sharded(scene, cam, key,
                                                         mesh))
    t2 = time.time()
    print(f"  colonnade wavefront: one card {t1 - t0:.2f} s, "
          f"{len(devs)} cards {t2 - t1:.2f} s (both incl. compile)")
    compare("colonnade image", shard, one)

    scene, cam = catalog.cornell_box(**grad)
    target = jnp.zeros((cam.height, cam.width, 3))
    t0 = time.time()
    loss1, g1 = diff.loss_and_grads(scene, cam, key, target, spp=cam.spp)
    jax.block_until_ready(g1)
    t1 = time.time()
    loss4, g4 = pm.render_loss_and_grad_sharded(scene, cam, key, target,
                                                mesh, spp=cam.spp)
    jax.block_until_ready(g4)
    t2 = time.time()
    print(f"  cornell {grad} gradient step: one card "
          f"{t1 - t0:.2f} s, {len(devs)} cards {t2 - t1:.2f} s "
          f"(both incl. compile)")
    compare("loss", loss4, loss1)
    # per group (scene, camera): atol 1e-5 of the group's largest gradient,
    # so structurally-zero leaves (e.g. focal_length, which a perspective
    # image does not depend on) compare as the noise they are
    n_leaves, bitwise = 0, True
    for grp1, grp4 in zip(g1, g4):
        flat1 = jax.tree_util.tree_flatten_with_path(grp1)[0]
        flat4 = dict(jax.tree_util.tree_flatten_with_path(grp4)[0])
        scale = max(float(np.max(np.abs(np.asarray(a)))) for _, a in flat1)
        for path, a in flat1:
            a, b = np.asarray(a), np.asarray(flat4[path])
            bitwise &= np.array_equal(a, b)
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-5 * scale,
                                       err_msg=jax.tree_util.keystr(path))
            n_leaves += 1
    print(f"    gradients: {n_leaves} leaves allclose (rtol 1e-3, atol 1e-5 "
          f"x the group's largest); bitwise {bitwise}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded paths on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"FAIL: no GPU (JAX found {devs[0].platform})", file=sys.stderr)
        return 1
    if len(devs) < args.devices:
        print(f"FAIL: {args.devices} GPUs asked, {len(devs)} found",
              file=sys.stderr)
        return 1
    devs = devs[:args.devices]

    from cpu_ray_tracing_implementation_tpu.utils import compile_cache

    os.makedirs(OUT_DIR, exist_ok=True)
    print(f"compile cache: {compile_cache.enable()}")
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")

    if args.devices == 4:
        phases = [("sharded paths against one card",
                   lambda: phase_sharded(devs))]
    else:
        phases = [
            ("kernel parity at the colonnade's widths",
             lambda: phase_kernel_parity(devs[0])),
            ("GPU against CPU at the golden workload", phase_gpu_vs_cpu),
            ("main path at full width", lambda: phase_full_width(devs[0])),
            ("compiled GPU tests", phase_gpu_tests),
        ]
    for i, (name, fn) in enumerate(phases, start=2 if args.devices == 1
                                   else 1):
        print(f"phase {i}: {name}", flush=True)
        t0 = time.time()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - reported, then exit nonzero
            import traceback

            traceback.print_exc()
            print(f"FAIL: phase {i} ({name}): {e}", file=sys.stderr)
            return 1
        print(f"phase {i} passed in {time.time() - t0:.1f} s", flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
