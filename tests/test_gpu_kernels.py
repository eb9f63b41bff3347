"""Compiled GPU paths against their oracles. These tests need an NVIDIA GPU:
the Triton kernel has no CPU compile, and interpret mode (covered by
tests/test_pallas_select.py) is not the card's compiler. They skip on the
CPU; chip_smoke.py runs them on the card:

    python chip_smoke.py            # phase 5 runs this file in process
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpu_ray_tracing_implementation_tpu.models import scene as scene_mod
from cpu_ray_tracing_implementation_tpu.ops import chunked

pytestmark = pytest.mark.gpu

TMIN = 1e-3


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernel)")


@functools.lru_cache(maxsize=None)
def _sphere_scene():
    rng = np.random.default_rng(7)
    b = scene_mod.SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for c in rng.normal(0, 3.0, (700, 3)):
        b.sphere(c, rng.uniform(0.05, 0.3), m)
    return b.build()


@functools.lru_cache(maxsize=None)
def _big_tri_scene():
    """2016 chunks of random triangles: the colonnade's chunk count."""
    rng = np.random.default_rng(3)
    n = 2016 * chunked.CHUNK
    b = scene_mod.SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    centers = rng.normal(0, 20, (n, 3))
    b.triangles(centers[:, None, :] + rng.normal(0, 0.2, (n, 3, 3)), m)
    return b.build()


def _rand_rays(rng, n, spread=3.0):
    org = jnp.asarray(rng.normal(0, spread, (n, 3)), jnp.float32)
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, jnp.asarray(d, jnp.float32)


def test_compiled_select_matches_xla_select(gpu):
    """Compiled kernel vs the exact XLA select at R = 8192, K = 2016."""
    from cpu_ray_tracing_implementation_tpu.ops import pallas_select as ps
    from cpu_ray_tracing_implementation_tpu.ops import perray

    chunks = _big_tri_scene().tri_chunks
    K, V, R = chunks.lo.shape[0], 16, 8192
    org, dirs = _rand_rays(np.random.default_rng(1), R, spread=20.0)
    cap = jnp.full((R,), jnp.inf)
    nr = perray._near_matrix(org, dirs, chunks.lo, chunks.hi, TMIN, cap)
    ids_x, nears_x, nr2 = perray._select_block(nr, V)
    _, nears_next, _ = perray._select_block(nr2, 2)   # ties past slot V
    rays, Rp = ps.pack_rays(org, dirs, cap)
    ids_k, nears_k, _ = ps.cull_select(rays, ps.pack_boxes(chunks.lo,
                                                           chunks.hi),
                                       jnp.zeros((Rp,), jnp.int32), V, K,
                                       TMIN)
    ids_k, nears_k = np.asarray(ids_k), np.asarray(nears_k)
    ids_x, nears_x = np.asarray(ids_x), np.asarray(nears_x)
    fin = np.isfinite(nears_x)
    np.testing.assert_array_equal(fin, np.isfinite(nears_k))
    assert fin.sum() > R
    idb = ps.id_bits(K)
    assert (nears_k[fin] <= nears_x[fin]).all()
    assert (nears_k[fin] >= nears_x[fin] * (1 - 2.0 ** -(23 - idb))).all()
    order = np.concatenate([nears_x, np.asarray(nears_next)], axis=1)
    coarse = (order.view(np.int32) & np.int32(-(1 << idb))).view(np.float32)
    for r, v in zip(*np.nonzero((ids_k != ids_x) & fin)):
        assert np.sum(coarse[r] == coarse[r, v]) > 1, (r, v)


def test_compiled_select_in_perray_matches_oracle(gpu):
    """planar_closest_perray through the compiled kernel (the GPU route)
    == the chunk-scan oracle at the colonnade's chunk count."""
    from cpu_ray_tracing_implementation_tpu.ops import perray

    assert perray._use_select_kernel(TMIN)
    chunks = _big_tri_scene().tri_chunks
    org, dirs = _rand_rays(np.random.default_rng(4), 4096, spread=20.0)
    t_r, (_, _, _, _, p_r) = jax.jit(
        lambda o, d: perray.planar_closest_perray(o, d, chunks, TMIN,
                                                  True))(org, dirs)
    t_c, (_, _, _, _, p_c) = chunked.planar_closest(org, dirs, chunks, TMIN,
                                                    triangle=True)
    hit = np.isfinite(np.asarray(t_c))
    np.testing.assert_array_equal(hit, np.isfinite(np.asarray(t_r)))
    assert hit.sum() > 500
    # atol: t's rounding scales with the ray origin's magnitude (~20-60
    # here, f32 eps 1.2e-7), not with t, so near hits need an absolute term
    np.testing.assert_allclose(np.asarray(t_r)[hit], np.asarray(t_c)[hit],
                               rtol=1e-5, atol=2e-5)
    assert np.mean(np.asarray(p_r)[hit] != np.asarray(p_c)[hit]) < 1e-3


def test_compiled_sphere_perray_matches_oracle(gpu):
    from cpu_ray_tracing_implementation_tpu.ops import perray

    chunks = _sphere_scene().sphere_chunks
    org, dirs = _rand_rays(np.random.default_rng(5), 2048)
    time = jnp.zeros((2048,), jnp.float32)
    t_r, _ = perray.sphere_closest_perray(org, dirs, time, chunks, TMIN)
    t_c, _ = chunked.sphere_closest(org, dirs, time, chunks, TMIN)
    hit = np.isfinite(np.asarray(t_c))
    np.testing.assert_array_equal(hit, np.isfinite(np.asarray(t_r)))
    # rtol: the oracle's expanded |o - c|^2 cancels in f32 (sphere_ts note)
    np.testing.assert_allclose(np.asarray(t_r)[hit], np.asarray(t_c)[hit],
                               rtol=2e-3)


def _on_cpu(fn, *args):
    """``fn`` run by XLA on the host CPU: the oracle for a GPU compile."""
    cpu = jax.devices("cpu")[0]
    return fn(*jax.device_put(args, cpu))


def test_dense_spheres_match_cpu(gpu):
    """The dense [R,S] sphere test (the small-scene path) on the card vs
    the same function on the CPU. rtol 2e-3: the expanded |o - c|^2
    cancels in f32, so the two compilers' different FMA contraction shows
    (the quad test below, with no cancellation, holds 1e-5)."""
    from cpu_ray_tracing_implementation_tpu.models import catalog
    from cpu_ray_tracing_implementation_tpu.ops import intersect as isect

    scene, _ = catalog.three_material_ball(width=32, spp=1, max_depth=2)
    assert scene.sphere_chunks is None
    org, dirs = _rand_rays(np.random.default_rng(6), 2048)
    time = jnp.zeros((2048,), jnp.float32)
    fn = jax.jit(lambda o, d, t, s: jnp.min(
        isect.sphere_ts(o, d, t, s, TMIN, jnp.inf), axis=-1))
    t_g = np.asarray(fn(org, dirs, time, scene.spheres))
    t_c = np.asarray(_on_cpu(fn, org, dirs, time, scene.spheres))
    hit = np.isfinite(t_c)
    np.testing.assert_array_equal(hit, np.isfinite(t_g))
    assert hit.sum() > 50
    np.testing.assert_allclose(t_g[hit], t_c[hit], rtol=2e-3)


def test_dense_quads_match_cpu(gpu):
    """Cornell's dense quads (pinned-precision einsums) on the card vs the
    CPU at f32 rounding (TF32 would keep ~3 digits)."""
    from cpu_ray_tracing_implementation_tpu.models import catalog
    from cpu_ray_tracing_implementation_tpu.ops import intersect as isect

    scene, _ = catalog.cornell_box(width=32, spp=1, max_depth=2)
    assert scene.quad_chunks is None
    rng = np.random.default_rng(6)
    org = jnp.asarray(rng.uniform(100, 450, (2048, 3)), jnp.float32)
    _, dirs = _rand_rays(rng, 2048)
    fn = jax.jit(lambda o, d, q: jnp.min(
        isect.quad_ts(o, d, q, TMIN, jnp.inf), axis=-1))
    t_g = np.asarray(fn(org, dirs, scene.quads))
    t_c = np.asarray(_on_cpu(fn, org, dirs, scene.quads))
    hit = np.isfinite(t_c)
    np.testing.assert_array_equal(hit, np.isfinite(t_g))
    assert hit.sum() > 1500
    np.testing.assert_allclose(t_g[hit], t_c[hit], rtol=1e-5)


def test_compiled_packet_matches_scan(gpu):
    from cpu_ray_tracing_implementation_tpu.ops import packet as pkt

    chunks = _sphere_scene().sphere_chunks
    org, dirs = _rand_rays(np.random.default_rng(2), 2048)
    time = jnp.zeros((2048,), jnp.float32)
    t_c, _ = chunked.sphere_closest(org, dirs, time, chunks, TMIN)
    t_p, _ = pkt.sphere_closest_packet(org, dirs, time, chunks, TMIN)
    hit = np.isfinite(np.asarray(t_c))
    np.testing.assert_array_equal(hit, np.isfinite(np.asarray(t_p)))
    # rtol: both expand the sphere quadratic, which cancels in f32, and
    # they contract in different orders ([G,T,C] batches vs the scan)
    np.testing.assert_allclose(np.asarray(t_p)[hit], np.asarray(t_c)[hit],
                               rtol=2e-3)
