"""Per-ray visit-list closest-hit (ops/perray.py) vs the chunk-scan oracle.

The per-ray accel selects each ray's V nearest crossed chunks, sweeps them
front-to-back, and loops until no ray's nearest unvisited chunk can beat
its best hit — it must return the same hits as scanning every chunk
(ops/chunked.py) for ANY V, including V far below the per-ray culled
count (the exactness loop's job).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpu_ray_tracing_implementation_tpu.models import scene as scene_mod
from cpu_ray_tracing_implementation_tpu.ops import chunked
from cpu_ray_tracing_implementation_tpu.ops import perray


def _rand_rays(rng, n, spread=3.0):
    org = jnp.asarray(rng.normal(0, spread, (n, 3)), jnp.float32)
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, jnp.asarray(d, jnp.float32)


@pytest.fixture(scope="module")
def sphere_scene():
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
    for c in rng.normal(0, 3.0, (700, 3)):
        v = c + rng.normal(0, 0.3, (3, 3))
        b.triangle(v[0], v[1], v[2], m)
    return b.build()


def _check_planar(scene, V, monkeypatch, n=512, tmax=perray.INF):
    monkeypatch.setenv("CRT_RAYV", str(V))
    rng = np.random.default_rng(2)
    org, dirs = _rand_rays(rng, n)
    t_c, (n_c, u_c, v_c, m_c, p_c) = chunked.planar_closest(
        org, dirs, scene.tri_chunks, 1e-3, triangle=True, tmax=tmax)
    t_r, (n_r, u_r, v_r, m_r, p_r) = perray.planar_closest_perray(
        org, dirs, scene.tri_chunks, 1e-3, True, tmax=tmax)
    hit_c = np.isfinite(np.asarray(t_c))
    hit_r = np.isfinite(np.asarray(t_r))
    np.testing.assert_array_equal(hit_c, hit_r)
    assert hit_c.sum() > 30
    # elementwise vs einsum contraction order: equal up to f32 rounding
    np.testing.assert_allclose(np.asarray(t_r)[hit_r], np.asarray(t_c)[hit_c],
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(n_r)[hit_r], np.asarray(n_c)[hit_c],
                               atol=1e-3)
    np.testing.assert_array_equal(np.asarray(m_r)[hit_r],
                                  np.asarray(m_c)[hit_c])
    np.testing.assert_array_equal(np.asarray(p_r)[hit_r],
                                  np.asarray(p_c)[hit_c])


@pytest.mark.parametrize("V", [32, 3])  # V=3 forces many exactness phases
def test_tri_perray_matches_chunked(tri_scene, V, monkeypatch):
    _check_planar(tri_scene, V, monkeypatch)


def test_tri_perray_respects_tmax(tri_scene, monkeypatch):
    _check_planar(tri_scene, 8, monkeypatch, tmax=4.0)


@pytest.mark.parametrize("V", [32, 3])
def test_sphere_perray_matches_chunked(sphere_scene, V, monkeypatch):
    monkeypatch.setenv("CRT_RAYV", str(V))
    rng = np.random.default_rng(1)
    org, dirs = _rand_rays(rng, 777)
    time = jnp.zeros((777,), jnp.float32)
    t_c, (ctr_c, rad_c, m_c, p_c) = chunked.sphere_closest(
        org, dirs, time, sphere_scene.sphere_chunks, 1e-3)
    t_r, (ctr_r, rad_r, m_r, p_r) = perray.sphere_closest_perray(
        org, dirs, time, sphere_scene.sphere_chunks, 1e-3)
    hit_c = np.isfinite(np.asarray(t_c))
    hit_r = np.isfinite(np.asarray(t_r))
    np.testing.assert_array_equal(hit_c, hit_r)
    assert hit_c.sum() > 50
    # the per-ray quadratic uses the direct (org - center) form, the chunk
    # scan the matmul-expanded form — equal up to f32 rounding
    np.testing.assert_allclose(np.asarray(t_r)[hit_r], np.asarray(t_c)[hit_c],
                               rtol=5e-4)
    np.testing.assert_array_equal(np.asarray(m_r)[hit_r],
                                  np.asarray(m_c)[hit_c])
    np.testing.assert_allclose(np.asarray(ctr_r)[hit_r],
                               np.asarray(ctr_c)[hit_c], atol=1e-4)


def test_perray_per_ray_cap(tri_scene, monkeypatch):
    """Per-ray tmax caps (dead lanes at tmin) produce misses, not hits."""
    monkeypatch.setenv("CRT_RAYV", "16")
    rng = np.random.default_rng(5)
    org, dirs = _rand_rays(rng, 256)
    cap = jnp.where(jnp.arange(256) % 2 == 0, 1e-3, jnp.inf)
    t_r, _ = perray.planar_closest_perray(org, dirs, tri_scene.tri_chunks,
                                          1e-3, True, tmax=cap)
    t = np.asarray(t_r)
    assert not np.isfinite(t[::2]).any()          # capped lanes: no hits
    t_full, _ = perray.planar_closest_perray(org, dirs, tri_scene.tri_chunks,
                                             1e-3, True)
    np.testing.assert_allclose(t[1::2], np.asarray(t_full)[1::2], rtol=1e-6)


def test_perray_gradients_match_chunked(tri_scene):
    """custom_vjp routes the backward through the chunk scan: gradients of
    a hit-distance loss must match differentiating the oracle directly."""
    rng = np.random.default_rng(6)
    org, dirs = _rand_rays(rng, 128)

    def loss_ray(org):
        t, (n, u, v, m, p) = perray.planar_closest_ray(
            org, dirs, tri_scene.tri_chunks, 1e-3, True)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    def loss_oracle(org):
        t, _ = chunked.planar_closest(org, dirs, tri_scene.tri_chunks,
                                      1e-3, triangle=True)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    g_ray = jax.grad(loss_ray)(org)
    g_orc = jax.grad(loss_oracle)(org)
    np.testing.assert_allclose(np.asarray(g_ray), np.asarray(g_orc),
                               rtol=1e-4, atol=1e-6)


def test_integrator_matches_packet_on_chunked_scene(tri_scene, monkeypatch):
    """Full intersect_brute routing: auto (= ray) vs packet on a chunked
    scene returns identical hits."""
    from cpu_ray_tracing_implementation_tpu.ops import intersect as isect

    rng = np.random.default_rng(9)
    org, dirs = _rand_rays(rng, 333)
    time = jnp.zeros((333,), jnp.float32)
    u_vol = jnp.zeros((333, 0), jnp.float32)
    monkeypatch.setenv("CRT_ACCEL", "ray")
    h_r = isect.intersect_brute(tri_scene, org, dirs, time, 1e-3, u_vol)
    monkeypatch.setenv("CRT_ACCEL", "packet")
    h_p = isect.intersect_brute(tri_scene, org, dirs, time, 1e-3, u_vol)
    np.testing.assert_array_equal(np.asarray(h_r.valid), np.asarray(h_p.valid))
    m = np.asarray(h_r.valid)
    np.testing.assert_allclose(np.asarray(h_r.t)[m], np.asarray(h_p.t)[m],
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(h_r.mat)[m],
                                  np.asarray(h_p.mat)[m])


def test_perray_miss_mat_sentinel(tri_scene, monkeypatch):
    """Miss rays carry the chunk-scan oracle's payload contract: mat == 0
    (pid is left at its 0 init; the winner-mat recovery must not leak
    chunks.mat[0,0] into miss lanes — ADVICE r04)."""
    monkeypatch.setenv("CRT_RAYV", "8")
    rng = np.random.default_rng(11)
    org, dirs = _rand_rays(rng, 256)
    t_c, (_, _, _, m_c, _) = chunked.planar_closest(
        org, dirs, tri_scene.tri_chunks, 1e-3, triangle=True)
    t_r, (_, _, _, m_r, _) = perray.planar_closest_perray(
        org, dirs, tri_scene.tri_chunks, 1e-3, True)
    miss = ~np.isfinite(np.asarray(t_r))
    assert miss.sum() > 10
    np.testing.assert_array_equal(np.asarray(m_r)[miss],
                                  np.asarray(m_c)[miss])
    np.testing.assert_array_equal(np.asarray(m_r)[miss], 0)

    time = jnp.zeros((256,), jnp.float32)
    # sphere path shares the recovery; use the tri scene's rays against a
    # fresh sphere scene via the module fixture machinery is overkill —
    # an empty-direction miss is enough to exercise the gate
    t_s, (_, _, m_s, _) = perray.sphere_closest_perray(
        org + 1e4, dirs, time,
        _sphere_chunks_for_miss(), 1e-3)
    assert not np.isfinite(np.asarray(t_s)).any()
    np.testing.assert_array_equal(np.asarray(m_s), 0)


def _sphere_chunks_for_miss():
    b = scene_mod.SceneBuilder()
    b.lambertian((0.1, 0.1, 0.1))      # claim id 0 (never used)
    m = b.metal((0.5, 0.5, 0.5), 0.1)  # mat id 1: a mat[0,0] leak is visible
    assert m != 0
    rng = np.random.default_rng(3)
    for c in rng.normal(0, 2.0, (600, 3)):
        b.sphere(c, 0.1, m)
    chunks = b.build().sphere_chunks
    assert int(np.asarray(chunks.mat)[0, 0]) != 0
    return chunks


@pytest.mark.parametrize("CS", [32, 64])
def test_subtile_planar_matches_chunked(tri_scene, CS, monkeypatch):
    """Sub-tile selection (CRT_SUBTILE, finer traversal altitude) returns
    the chunk-scan oracle's hits exactly — same contract as the chunk-
    granular per-ray path, any CS."""
    monkeypatch.setenv("CRT_SUBTILE", "1")
    monkeypatch.setenv("CRT_SUBC", str(CS))
    monkeypatch.setenv("CRT_RAYV_SUB", "8")  # force many exactness phases
    _check_planar(tri_scene, 8, monkeypatch)


def test_subtile_planar_tmax_and_caps(tri_scene, monkeypatch):
    monkeypatch.setenv("CRT_SUBTILE", "1")
    _check_planar(tri_scene, 8, monkeypatch, tmax=4.0)


def test_subtile_sphere_matches_chunked(sphere_scene, monkeypatch):
    monkeypatch.setenv("CRT_SUBTILE", "1")
    monkeypatch.setenv("CRT_RAYV_SUB", "8")
    rng = np.random.default_rng(21)
    org, dirs = _rand_rays(rng, 512)
    time = jnp.zeros((512,), jnp.float32)
    t_c, (ctr_c, rad_c, m_c, p_c) = chunked.sphere_closest(
        org, dirs, time, sphere_scene.sphere_chunks, 1e-3)
    t_r, (ctr_r, rad_r, m_r, p_r) = perray.sphere_closest_perray(
        org, dirs, time, sphere_scene.sphere_chunks, 1e-3)
    hit_c = np.isfinite(np.asarray(t_c))
    hit_r = np.isfinite(np.asarray(t_r))
    np.testing.assert_array_equal(hit_c, hit_r)
    assert hit_c.sum() > 50
    # winner pid equality is the strong check; t gets an atol besides the
    # oracle rtol because near-origin hits (t ~ 5e-2) carry f32 quadratic
    # cancellation noise ~2e-4 in BOTH paths
    np.testing.assert_array_equal(np.asarray(p_r)[hit_r],
                                  np.asarray(p_c)[hit_c])
    np.testing.assert_allclose(np.asarray(t_r)[hit_r], np.asarray(t_c)[hit_c],
                               rtol=5e-4, atol=3e-4)
    np.testing.assert_array_equal(np.asarray(m_r)[hit_r],
                                  np.asarray(m_c)[hit_c])
