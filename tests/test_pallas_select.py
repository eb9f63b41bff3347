"""Fused cull+select kernel (ops/pallas_select.py) in interpret mode vs the
XLA near-matrix + selection-rounds path it replaces on the GPU, plus the
routing and shape handling around it. tests/test_gpu_kernels.py runs the
compiled kernel on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpu_ray_tracing_implementation_tpu.models import scene as scene_mod
from cpu_ray_tracing_implementation_tpu.ops import chunked
from cpu_ray_tracing_implementation_tpu.ops import pallas_select as ps
from cpu_ray_tracing_implementation_tpu.ops import perray

TMIN = 1e-3


def _rand_rays(rng, n, spread=3.0):
    org = jnp.asarray(rng.normal(0, spread, (n, 3)), jnp.float32)
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, jnp.asarray(d, jnp.float32)


def _tri_scene(seed, n):
    rng = np.random.default_rng(seed)
    b = scene_mod.SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for c in rng.normal(0, 3.0, (n, 3)):
        v = c + rng.normal(0, 0.3, (3, 3))
        b.triangle(v[0], v[1], v[2], m)
    return b.build()


@pytest.fixture(scope="module")
def tri_scene():
    return _tri_scene(8, 700)


@pytest.fixture(scope="module")
def big_tri_scene():
    """24 chunks: several BLOCK_K tiles, K not a multiple of 16."""
    sc = _tri_scene(11, 24 * chunked.CHUNK - 40)
    assert sc.tri_chunks.lo.shape[0] % 16 != 0
    return sc


def _kernel_select(chunks, org, dirs, cap, V, excl=None, **blocks):
    """Kernel phase on unpadded rays -> (ids, nears, rest) [R, ...]."""
    R = org.shape[0]
    block_r = blocks.get("block_r", ps.BLOCK_R)
    block_k = blocks.get("block_k", ps.BLOCK_K)
    boxes = ps.pack_boxes(chunks.lo, chunks.hi, block_k=block_k)
    rays, Rp = ps.pack_rays(org, dirs, cap, block_r=block_r)
    if excl is None:
        excl = jnp.zeros((Rp,), jnp.int32)
    ids, nears, rest = ps.cull_select(rays, boxes, excl, V,
                                      chunks.lo.shape[0], TMIN,
                                      interpret=True, **blocks)
    return ids[:R], nears[:R], rest[:R]


def _assert_matches_exact(ids_k, nears_k, ids_x, nears_x, K, nears_next=None):
    """Packed-key lists vs the exact lists: same finite slots, nears
    rounded down within the packed bound, ids equal except where two
    chunks' coarsened nears tie (the kernel then orders by id).
    ``nears_next``: exact nears that follow the list, for ties that
    straddle its end."""
    ids_k, nears_k = np.asarray(ids_k), np.asarray(nears_k)
    ids_x, nears_x = np.asarray(ids_x), np.asarray(nears_x)
    fin = np.isfinite(nears_x)
    np.testing.assert_array_equal(fin, np.isfinite(nears_k))
    idb = ps.id_bits(K)
    rel = 2.0 ** -(23 - idb)
    assert (nears_k[fin] <= nears_x[fin]).all()
    assert (nears_k[fin] >= nears_x[fin] * (1 - rel)).all()
    order = nears_x if nears_next is None else np.concatenate(
        [nears_x, np.asarray(nears_next)], axis=1)
    coarse = (order.view(np.int32) & np.int32(-(1 << idb))).view(np.float32)
    for r, v in zip(*np.nonzero((ids_k != ids_x) & fin)):
        assert np.sum(coarse[r] == coarse[r, v]) > 1, (r, v)


def test_kernel_matches_xla_select(tri_scene):
    chunks = tri_scene.tri_chunks
    K = chunks.lo.shape[0]
    rng = np.random.default_rng(3)
    org, dirs = _rand_rays(rng, 200)
    cap = jnp.full((200,), 50.0)
    V = min(8, K)

    nr = perray._near_matrix(org, dirs, chunks.lo, chunks.hi, TMIN, cap)
    ids_x, nears_x, nr_rest = perray._select_block(nr, V)
    rest_x = np.asarray(jnp.min(nr_rest, axis=1))

    ids_k, nears_k, rest_k = _kernel_select(chunks, org, dirs, cap, V)
    _assert_matches_exact(ids_k, nears_k, ids_x, nears_x, K)
    rest_k = np.asarray(rest_k)
    fin_r = np.isfinite(rest_x)
    np.testing.assert_array_equal(fin_r, np.isfinite(rest_k))
    assert (rest_k[fin_r] <= rest_x[fin_r]).all()
    np.testing.assert_allclose(rest_k[fin_r], rest_x[fin_r], rtol=1e-3)


@pytest.mark.parametrize("R,V,block_k", [
    (100, 8, 16), (100, 16, 16), (64, 8, 8), (64, 16, 8),
    (33, 16, 16), (32, 8, 64)])
def test_kernel_matches_xla_select_shapes(big_tri_scene, R, V, block_k):
    """R not a multiple of BLOCK_R, K not a multiple of BLOCK_K, several
    K tiles per program, V in {8, 16}."""
    chunks = big_tri_scene.tri_chunks
    K = chunks.lo.shape[0]
    rng = np.random.default_rng(R + V + block_k)
    org, dirs = _rand_rays(rng, R, spread=2.0)
    cap = jnp.full((R,), 50.0)
    nr = perray._near_matrix(org, dirs, chunks.lo, chunks.hi, TMIN, cap)
    ids_x, nears_x, nr2 = perray._select_block(nr, V)
    _, nears_next, _ = perray._select_block(nr2, 2)
    ids_k, nears_k, _ = _kernel_select(chunks, org, dirs, cap, V,
                                       block_k=block_k)
    assert ids_k.shape == (R, V) and nears_k.shape == (R, V)
    assert np.isfinite(np.asarray(nears_x)).sum() > R
    _assert_matches_exact(ids_k, nears_k, ids_x, nears_x, K, nears_next)


def test_kernel_phases_partition_the_visit_order(tri_scene):
    """Phase 2 with the exclusion key must return exactly slots V..2V of
    the single-pass ordering."""
    chunks = tri_scene.tri_chunks
    K = chunks.lo.shape[0]
    if K < 4:
        pytest.skip("needs several chunks")
    rng = np.random.default_rng(4)
    org, dirs = _rand_rays(rng, 64)
    cap = jnp.full((64,), 50.0)
    V = 2

    nr = perray._near_matrix(org, dirs, chunks.lo, chunks.hi, TMIN, cap)
    ids_a, nears_a, nr2 = perray._select_block(nr, V)
    ids_b, nears_b, _ = perray._select_block(nr2, V)

    ids_1, nears_1, _ = _kernel_select(chunks, org, dirs, cap, V)
    _assert_matches_exact(ids_1, nears_1, ids_a, nears_a, K)
    ids_2, nears_2, _ = _kernel_select(chunks, org, dirs, cap, V,
                                       excl=ps.last_key(ids_1, nears_1))
    _assert_matches_exact(ids_2, nears_2, ids_b, nears_b, K)


def test_kernel_phase_partition_with_exhausted_list(tri_scene):
    """Phases cover every chunk exactly once; once a ray's list runs out
    its slots read NaN and the next phase excludes everything."""
    chunks = tri_scene.tri_chunks
    K = chunks.lo.shape[0]
    V = 4
    n_phases = -(-K // V)
    rng = np.random.default_rng(6)
    org, dirs = _rand_rays(rng, 16)
    cap = jnp.full((16,), jnp.inf)
    Rp = -(-16 // ps.BLOCK_R) * ps.BLOCK_R
    excl = jnp.zeros((Rp,), jnp.int32)
    seen = []
    for _ in range(n_phases):
        ids, nears, rest = _kernel_select(chunks, org, dirs, cap, V,
                                          excl=excl)
        ids, nears = np.asarray(ids), np.asarray(nears)
        real = ~np.isnan(nears)
        seen.append(np.where(real, ids, -1))
        excl = jnp.pad(ps.last_key(jnp.asarray(ids), jnp.asarray(nears)),
                       (0, Rp - 16))
    seen = np.concatenate(seen, axis=1)
    for r in range(16):
        got = sorted(seen[r][seen[r] >= 0].tolist())
        assert got == list(range(K)), (r, got)
    assert np.isnan(np.asarray(rest)).all()
    assert (np.asarray(excl[:16]) == ps.EXHAUSTED).all()
    ids, nears, rest = _kernel_select(chunks, org, dirs, cap, V, excl=excl)
    assert np.isnan(np.asarray(nears)).all()
    assert np.isnan(np.asarray(rest)).all()


def _interpret_loop(monkeypatch):
    monkeypatch.setattr(perray, "_run_select_loop", functools.partial(
        perray._run_select_loop, interpret=True))


def test_perray_with_pallas_loop_matches_oracle(tri_scene, monkeypatch):
    """Full planar_closest_perray through the kernel phase loop (interpret)
    == the chunk-scan oracle."""
    _interpret_loop(monkeypatch)
    monkeypatch.setenv("CRT_RAYV", "4")  # force several phases
    rng = np.random.default_rng(5)
    org, dirs = _rand_rays(rng, 300)
    t_c, (n_c, u_c, v_c, m_c, p_c) = chunked.planar_closest(
        org, dirs, tri_scene.tri_chunks, TMIN, triangle=True)
    t_r, (n_r, u_r, v_r, m_r, p_r) = perray.planar_closest_perray(
        org, dirs, tri_scene.tri_chunks, TMIN, True)
    hit_c = np.isfinite(np.asarray(t_c))
    hit_r = np.isfinite(np.asarray(t_r))
    np.testing.assert_array_equal(hit_c, hit_r)
    assert hit_c.sum() > 20
    np.testing.assert_allclose(np.asarray(t_r)[hit_r], np.asarray(t_c)[hit_c],
                               rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(p_r)[hit_r],
                                  np.asarray(p_c)[hit_c])


def test_packed_keys_conservative_and_same_ids(tri_scene):
    """Per-ray selected-id SETS equal the exact XLA select's, nears
    rounded DOWN by at most the stolen id bits."""
    chunks = tri_scene.tri_chunks
    K = chunks.lo.shape[0]
    rng = np.random.default_rng(9)
    org, dirs = _rand_rays(rng, 128)
    cap = jnp.full((128,), 50.0)
    V = min(8, K)

    nr = perray._near_matrix(org, dirs, chunks.lo, chunks.hi, TMIN, cap)
    ids_e, nears_e, _ = perray._select_block(nr, V)
    ids_p, nears_p, _ = _kernel_select(chunks, org, dirs, cap, V)
    ne = np.asarray(nears_e)
    npk = np.asarray(nears_p)
    fin = np.isfinite(ne)
    assert not np.isfinite(npk[~fin]).any()
    rel = 2.0 ** -(23 - ps.id_bits(K))
    assert (npk[fin] <= ne[fin] + 1e-12).all()
    assert (npk[fin] >= ne[fin] * (1 - 2 * rel) - 1e-12).all()
    for r in range(128):
        a = set(np.asarray(ids_e[r])[fin[r]].tolist())
        b = set(np.asarray(ids_p[r])[fin[r]].tolist())
        assert a == b, (r, a, b)


def test_packed_phase_loop_matches_exact_end_to_end(tri_scene, monkeypatch):
    """Full per-ray accel through the kernel's packed-key phases == the
    exact XLA select loop (bit-identical winners: coarsening only
    reorders tie visits)."""
    monkeypatch.setenv("CRT_RAYV", "4")
    rng = np.random.default_rng(10)
    org, dirs = _rand_rays(rng, 256)

    t_e, (_, _, _, _, p_e) = perray.planar_closest_perray(
        org, dirs, tri_scene.tri_chunks, TMIN, True)
    _interpret_loop(monkeypatch)
    t_p, (_, _, _, _, p_p) = perray.planar_closest_perray(
        org, dirs, tri_scene.tri_chunks, TMIN, True)
    hit = np.isfinite(np.asarray(t_e))
    np.testing.assert_array_equal(hit, np.isfinite(np.asarray(t_p)))
    assert hit.sum() > 20
    np.testing.assert_array_equal(np.asarray(t_p)[hit], np.asarray(t_e)[hit])
    np.testing.assert_array_equal(np.asarray(p_p)[hit], np.asarray(p_e)[hit])


def test_sphere_perray_kernel_loop_matches_oracle(monkeypatch):
    """The sphere per-ray accel through the kernel phase loop (interpret)
    == the sphere chunk-scan oracle."""
    rng = np.random.default_rng(7)
    b = scene_mod.SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for c in rng.normal(0, 3.0, (700, 3)):
        b.sphere(c, rng.uniform(0.05, 0.3), m)
    chunks = b.build().sphere_chunks
    _interpret_loop(monkeypatch)
    monkeypatch.setenv("CRT_RAYV", "4")
    org, dirs = _rand_rays(rng, 200)
    time = jnp.zeros((200,), jnp.float32)
    t_c, (_, _, _, p_c) = chunked.sphere_closest(org, dirs, time, chunks,
                                                 TMIN)
    t_r, (_, _, _, p_r) = perray.sphere_closest_perray(org, dirs, time,
                                                       chunks, TMIN)
    hit = np.isfinite(np.asarray(t_c))
    np.testing.assert_array_equal(hit, np.isfinite(np.asarray(t_r)))
    assert hit.sum() > 20
    # rtol: the oracle expands |o - c|^2 (ops/intersect.py sphere_ts note),
    # which cancels in f32; the sweep's quadratic uses o - c directly
    np.testing.assert_allclose(np.asarray(t_r)[hit], np.asarray(t_c)[hit],
                               rtol=2e-3)
    np.testing.assert_array_equal(np.asarray(p_r)[hit], np.asarray(p_c)[hit])


# ------------------------------------------------------------------ routing
def test_routing_on_cpu_picks_xla(tri_scene, monkeypatch):
    """On the CPU backend the per-ray accel never calls the kernel."""
    assert jax.default_backend() == "cpu"
    assert not perray._use_select_kernel(TMIN)

    def boom(*a, **k):
        raise AssertionError("kernel called on the CPU backend")

    monkeypatch.setattr(ps, "cull_select", boom)
    org, dirs = _rand_rays(np.random.default_rng(1), 32)
    t, _ = perray.planar_closest_perray(org, dirs, tri_scene.tri_chunks,
                                        TMIN, True)
    assert np.isfinite(np.asarray(t)).any()


def test_routing_on_gpu_picks_compiled_kernel(tri_scene, monkeypatch):
    """With the GPU backend the phase loop calls the kernel, and never in
    interpret mode; a traced or non-positive tmin takes the XLA select."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert perray._use_select_kernel(TMIN)
    assert not perray._use_select_kernel(0.0)
    assert not jax.jit(
        lambda t: jnp.float32(perray._use_select_kernel(t)))(1.0)

    calls = []
    real = ps.cull_select

    def spy(*args, **kwargs):
        calls.append(kwargs.get("interpret", False))
        kwargs["interpret"] = True   # no card here: run it interpreted
        return real(*args, **kwargs)

    monkeypatch.setattr(ps, "cull_select", spy)
    org, dirs = _rand_rays(np.random.default_rng(2), 32)
    perray.planar_closest_perray(org, dirs, tri_scene.tri_chunks, TMIN, True)
    assert calls and not any(calls)


def test_cull_select_rejects_nonpositive_tmin(tri_scene):
    chunks = tri_scene.tri_chunks
    boxes = ps.pack_boxes(chunks.lo, chunks.hi)
    org, dirs = _rand_rays(np.random.default_rng(0), 8)
    rays, Rp = ps.pack_rays(org, dirs, jnp.full((8,), 1.0))
    with pytest.raises(ValueError, match="tmin > 0"):
        ps.cull_select(rays, boxes, jnp.zeros((Rp,), jnp.int32), 4,
                       chunks.lo.shape[0], 0.0, interpret=True)


def test_pack_shapes_pad_to_blocks():
    org = jnp.ones((70, 3)); dirs = jnp.ones((70, 3))
    rays, Rp = ps.pack_rays(org, dirs, jnp.full((70,), 2.0), block_r=32)
    assert rays.shape == (8, 96) and Rp == 96
    assert float(jnp.abs(rays[:, 70:]).max()) == 0.0
    lo = jnp.zeros((2015, 3)); hi = jnp.ones((2015, 3))
    boxes = ps.pack_boxes(lo, hi, block_k=64)
    assert boxes.shape == (8, 2048)
    # padded chunks are inverted boxes: lo = +BIG > hi = -BIG
    assert (np.asarray(boxes[0:3, 2015:]) > np.asarray(boxes[3:6, 2015:])).all()


@pytest.mark.parametrize("K,V", [(2015, 16), (8060, 24)])
def test_kernel_lowers_for_triton(K, V):
    """The kernel lowers to Triton IR for the CUDA platform at the
    colonnade's widths (chunk and sub-tile granularity); only the card's
    compiler is left for the GPU tests."""
    R = 8192
    fn = jax.jit(lambda r, b, e: ps.cull_select(r, b, e, V, K, TMIN))
    Kp = -(-K // ps.BLOCK_K) * ps.BLOCK_K
    lowered = fn.trace(jax.ShapeDtypeStruct((8, R), jnp.float32),
                       jax.ShapeDtypeStruct((8, Kp), jnp.float32),
                       jax.ShapeDtypeStruct((R,), jnp.int32)).lower(
        lowering_platforms=("cuda",))
    assert "cull_select" in lowered.as_text()
