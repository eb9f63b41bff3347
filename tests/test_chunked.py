"""Chunk-scan intersection (ops/chunked.py) vs the dense oracle.

The chunked path is the vectorised counterpart of BVH traversal (reference
src/bvh_node.h): BVH-ordered fixed chunks + whole-batch AABB culls + per-ray
closest-t tightening. Must agree with the dense single-pass intersection.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import cpu_ray_tracing_implementation_tpu.ops.chunked as ch
from cpu_ray_tracing_implementation_tpu.models.scene import SceneBuilder
from cpu_ray_tracing_implementation_tpu.ops import intersect as isect


@pytest.fixture()
def dense_override():
    old = ch.DENSE_MAX
    yield lambda: setattr(ch, "DENSE_MAX", 10 ** 9)
    ch.DENSE_MAX = old


def _rand_rays(rng, n):
    org = jnp.asarray(rng.uniform(-12, 12, (n, 3)).astype(np.float32))
    dirs = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    return org, dirs, jnp.zeros((n,)), jnp.full((n, 1), 0.5)


def _compare(s_chunk, s_dense, rng, n=512):
    org, dirs, t, uv = _rand_rays(rng, n)
    h1 = isect.intersect_brute(s_chunk, org, dirs, t, 1e-3, uv)
    h2 = isect.intersect_brute(s_dense, org, dirs, t, 1e-3, uv)
    v1, v2 = np.asarray(h1.valid), np.asarray(h2.valid)
    np.testing.assert_array_equal(v1, v2)
    assert v1.sum() > 10, "test scene barely hit — not meaningful"
    np.testing.assert_allclose(np.asarray(h1.t)[v1], np.asarray(h2.t)[v1],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(h1.normal)[v1],
                               np.asarray(h2.normal)[v1], atol=5e-3)
    np.testing.assert_array_equal(np.asarray(h1.mat)[v1], np.asarray(h2.mat)[v1])


def test_spheres_chunked_matches_dense(dense_override):
    rng = np.random.default_rng(0)
    centers = rng.uniform(-10, 10, (700, 3))
    radii = rng.uniform(0.1, 0.6, 700)

    def build():
        b = SceneBuilder()
        mats = [b.lambertian((1, 1, 1)), b.metal((1, 1, 1)), b.dielectric(1.5)]
        for i, (c, r) in enumerate(zip(centers, radii)):
            b.sphere(c, r, mats[i % 3])
        return b.build()

    s_chunk = build()
    assert s_chunk.sphere_chunks is not None
    dense_override()
    s_dense = build()
    assert s_dense.sphere_chunks is None
    _compare(s_chunk, s_dense, rng)


def test_triangles_chunked_matches_dense(dense_override):
    rng = np.random.default_rng(1)
    base = rng.uniform(-10, 10, (600, 3))

    def build():
        b = SceneBuilder()
        m = b.lambertian((1, 1, 1))
        for p in base:
            e1 = rng2.normal(size=3)
            e2 = rng2.normal(size=3)
            b.triangle(p, p + e1, p + e2, m)
        return b.build()

    rng2 = np.random.default_rng(2)
    s_chunk = build()
    assert s_chunk.tri_chunks is not None
    rng2 = np.random.default_rng(2)
    dense_override()
    s_dense = build()
    _compare(s_chunk, s_dense, rng)


def test_quads_chunked_matches_dense(dense_override):
    rng = np.random.default_rng(3)

    def build():
        b = SceneBuilder()
        m = b.lambertian((1, 1, 1))
        r = np.random.default_rng(4)
        for _ in range(600):
            c = r.uniform(-10, 10, 3)
            b.quad(c, r.normal(size=3), r.normal(size=3), m)
        return b.build()

    s_chunk = build()
    assert s_chunk.quad_chunks is not None
    dense_override()
    s_dense = build()
    _compare(s_chunk, s_dense, rng)


def test_moving_sphere_chunked(dense_override):
    rng = np.random.default_rng(5)
    centers = rng.uniform(-8, 8, (600, 3))

    def build():
        b = SceneBuilder()
        m = b.lambertian((1, 1, 1))
        for c in centers:
            b.moving_sphere(c, c + [0.5, 0, 0], 0.4, m)
        return b.build()

    s_chunk = build()
    dense_override()
    s_dense = build()
    org, dirs, _, uv = _rand_rays(rng, 256)
    tm = jnp.full((256,), 0.7)
    h1 = isect.intersect_brute(s_chunk, org, dirs, tm, 1e-3, uv)
    h2 = isect.intersect_brute(s_dense, org, dirs, tm, 1e-3, uv)
    v = np.asarray(h1.valid)
    np.testing.assert_array_equal(v, np.asarray(h2.valid))
    np.testing.assert_allclose(np.asarray(h1.t)[v], np.asarray(h2.t)[v],
                               rtol=1e-3, atol=1e-3)


def test_tmax_respected_on_chunked_path(dense_override):
    """A finite tmax must clip hits beyond it on the chunk-scan path (it was
    once silently ignored beyond the dense threshold)."""
    rng = np.random.default_rng(9)
    b = SceneBuilder()
    m = b.lambertian((1, 1, 1))
    for i in range(600):
        b.sphere((0, 0, -10.0 - i * 0.01), 0.2, m)
    s = b.build()
    assert s.sphere_chunks is not None
    org = jnp.zeros((4, 3))
    dirs = jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (4, 1))
    t = jnp.zeros((4,))
    uv = jnp.full((4, 1), 0.5)
    h_hit = isect.intersect_brute(s, org, dirs, t, 1e-3, uv, tmax=jnp.inf)
    assert bool(h_hit.valid.all())
    h_clip = isect.intersect_brute(s, org, dirs, t, 1e-3, uv, tmax=5.0)
    assert not bool(h_clip.valid.any())
