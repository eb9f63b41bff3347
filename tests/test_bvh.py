"""Device-side threaded-BVH traversal (ops/bvh.py) vs the chunk-scan oracle.

The traversal must agree with ops.chunked (same primitives, same DFS
primitive order, same strict-< tie-breaks) — the device-side counterpart of checking
the reference's bvh_node::hit against its linear hittable_list scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpu_ray_tracing_implementation_tpu.models import scene as scene_mod
from cpu_ray_tracing_implementation_tpu.ops import bvh as bvh_mod
from cpu_ray_tracing_implementation_tpu.ops import chunked
from cpu_ray_tracing_implementation_tpu.utils import accel


def _rand_rays(rng, n, spread=3.0):
    org = jnp.asarray(rng.normal(0, spread, (n, 3)), jnp.float32)
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, jnp.asarray(d, jnp.float32)


@pytest.fixture(scope="module")
def sphere_scene():
    """~700 random spheres (above DENSE_MAX) -> chunks + traversal tree."""
    rng = np.random.default_rng(7)
    b = scene_mod.SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for c in rng.normal(0, 3.0, (700, 3)):
        b.sphere(c, rng.uniform(0.05, 0.3), m)
    return b.build()


@pytest.fixture(scope="module")
def tri_scene():
    rng = np.random.default_rng(8)
    b = scene_mod.SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    centers = rng.normal(0, 3.0, (700, 3))
    for c in centers:
        v = c + rng.normal(0, 0.3, (3, 3))
        b.triangle(v[0], v[1], v[2], m)
    return b.build()


def test_threaded_links_invariants():
    """Every leaf reachable, links in-range, skip(root) == sentinel."""
    rng = np.random.default_rng(0)
    c = rng.normal(0, 1, (300, 3)).astype(np.float32)
    lo, hi = c - 0.1, c + 0.1
    order, nodes = accel.build_bvh((lo + hi) / 2, lo, hi, max_leaf=8)
    assert nodes is not None, "native builder must be available in CI"
    hit, miss, first, count = accel.threaded_links(nodes)
    n = len(nodes)
    idx = np.arange(n)
    is_leaf = count > 0
    # DFS layout: descending is always +1; a leaf's subtree is itself, so
    # its skip (== hit == miss) is also +1
    np.testing.assert_array_equal(hit, idx + 1)
    np.testing.assert_array_equal(miss[is_leaf], idx[is_leaf] + 1)
    # an internal node's miss jumps past its whole subtree
    assert (miss[~is_leaf] > idx[~is_leaf] + 1).all()
    assert (miss <= n).all()
    # leaves cover all primitives exactly once
    cover = np.zeros(300, bool)
    for f, cn in zip(first[is_leaf], count[is_leaf]):
        assert not cover[f:f + cn].any()
        cover[f:f + cn] = True
    assert cover.all()


def test_sphere_traversal_matches_chunked(sphere_scene):
    rng = np.random.default_rng(1)
    org, dirs = _rand_rays(rng, 512)
    time = jnp.zeros((512,), jnp.float32)
    t_c, (ctr_c, rad_c, m_c, p_c) = chunked.sphere_closest(
        org, dirs, time, sphere_scene.sphere_chunks, 1e-3)
    t_b, (ctr_b, rad_b, m_b, p_b) = bvh_mod.sphere_closest_bvh(
        org, dirs, time, sphere_scene.sphere_tree, 1e-3)
    hit_c = np.isfinite(np.asarray(t_c))
    hit_b = np.isfinite(np.asarray(t_b))
    np.testing.assert_array_equal(hit_c, hit_b)
    assert hit_c.sum() > 50, "fixture should produce plenty of hits"
    # rtol 2e-3: the chunk scan contracts via einsum, traversal via
    # elementwise mul+sum — near-tangent quadratics amplify the op-order ulps
    np.testing.assert_allclose(np.asarray(t_b)[hit_b], np.asarray(t_c)[hit_c],
                               rtol=2e-3)
    np.testing.assert_array_equal(np.asarray(m_b)[hit_b],
                                  np.asarray(m_c)[hit_c])
    np.testing.assert_allclose(np.asarray(ctr_b)[hit_b],
                               np.asarray(ctr_c)[hit_c], atol=1e-5)


def test_tri_traversal_matches_chunked(tri_scene):
    rng = np.random.default_rng(2)
    org, dirs = _rand_rays(rng, 512)
    t_c, (n_c, u_c, v_c, m_c, _p) = chunked.planar_closest(
        org, dirs, tri_scene.tri_chunks, 1e-3, triangle=True)
    t_b, (n_b, u_b, v_b, m_b, _pb) = bvh_mod.planar_closest_bvh(
        org, dirs, tri_scene.tri_tree, 1e-3, triangle=True)
    hit_c = np.isfinite(np.asarray(t_c))
    hit_b = np.isfinite(np.asarray(t_b))
    np.testing.assert_array_equal(hit_c, hit_b)
    assert hit_c.sum() > 30
    np.testing.assert_allclose(np.asarray(t_b)[hit_b], np.asarray(t_c)[hit_c],
                               rtol=2e-3)
    np.testing.assert_allclose(np.asarray(n_b)[hit_b], np.asarray(n_c)[hit_c],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(u_b)[hit_b], np.asarray(u_c)[hit_c],
                               atol=1e-3)


def test_traversal_respects_tmax(sphere_scene):
    rng = np.random.default_rng(3)
    org, dirs = _rand_rays(rng, 256)
    time = jnp.zeros((256,), jnp.float32)
    t_full, _ = bvh_mod.sphere_closest_bvh(
        org, dirs, time, sphere_scene.sphere_tree, 1e-3)
    tmax = 2.0
    t_cut, _ = bvh_mod.sphere_closest_bvh(
        org, dirs, time, sphere_scene.sphere_tree, 1e-3, tmax=tmax)
    tc = np.asarray(t_cut)
    tf = np.asarray(t_full)
    assert (tc[np.isfinite(tc)] <= tmax).all()
    keep = np.isfinite(tf) & (tf <= tmax)
    np.testing.assert_allclose(tc[keep], tf[keep], rtol=1e-6)
    assert not np.isfinite(tc[~keep]).any()


def test_all_miss_terminates(sphere_scene):
    """Rays pointing away from the whole scene: traversal exits, all inf."""
    n = 64
    org = jnp.full((n, 3), 100.0, jnp.float32)
    dirs = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32), (n, 1))
    time = jnp.zeros((n,), jnp.float32)
    t, _ = bvh_mod.sphere_closest_bvh(org, dirs, time,
                                      sphere_scene.sphere_tree, 1e-3)
    assert not np.isfinite(np.asarray(t)).any()


def test_accel_vjp_matches_chunked(tri_scene):
    """The custom-VJP wrapper differentiates through the chunk-scan
    backward: gradients must equal differentiating chunked.planar_closest
    directly."""
    rng = np.random.default_rng(4)
    org, dirs = _rand_rays(rng, 128)
    chs, tree = tri_scene.tri_chunks, tri_scene.tri_tree

    def f_accel(o):
        t, _ = bvh_mod.planar_closest_accel(o, dirs, chs, tree, 1e-3, True)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    def f_chunk(o):
        t, _ = chunked.planar_closest(o, dirs, chs, 1e-3, triangle=True)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    g_a = np.asarray(jax.grad(f_accel)(org))
    g_c = np.asarray(jax.grad(f_chunk)(org))
    np.testing.assert_allclose(g_a, g_c, rtol=1e-5, atol=1e-6)


def test_scene_render_same_image_bvh_vs_chunked(sphere_scene, monkeypatch):
    """End to end: the integrator under CRT_ACCEL=bvh vs =chunked."""
    from cpu_ray_tracing_implementation_tpu.models import camera as cam_mod
    from cpu_ray_tracing_implementation_tpu.models import integrator

    cam = cam_mod.perspective(width=24, aspect_ratio=1.0, fovy_deg=60.0,
                              pos=(0, 0, 12), lookat=(0, 0, 0),
                              spp=2, max_depth=3)
    key = jax.random.key(0)
    monkeypatch.setenv("CRT_ACCEL", "chunked")
    img_c = np.asarray(integrator.render_image(sphere_scene, cam, key, spp=2))
    monkeypatch.setenv("CRT_ACCEL", "bvh")
    img_b = np.asarray(integrator.render_image(sphere_scene, cam, key, spp=2))
    assert np.isfinite(img_b).all()
    # identical primitives, order and tie-breaks -> images agree except for
    # possible last-ulp winner flips (none expected at this scale)
    np.testing.assert_allclose(img_b, img_c, atol=1e-4)
