"""Per-ray visit-list closest-hit: BVH-grade pruning in batched form.

The tile-packet accelerator (ops/packet.py) shares one front-to-back visit
list per 2048-ray tile. On the 258k-tri colonnade (tools/packet_stats.py
counts it) a single ray's [tmin, cap] interval crosses only ~16 of the 2015
chunk AABBs (p90 31), and only ~12 lie before its closest hit — but a
TILE's union is 220-900 chunks once bounces diverge, so every ray pays
20-60x the chunk visits it needs. This module gives each ray its own visit
list, which is what the reference's per-ray BVH descent
(src/bvh_node.h:49-58) achieves with a pointer stack — done here with three
batched passes, no pointer chasing:

 1. CULL: [R,K] slab test of every ray against every chunk AABB, computed
    per-axis on [R,K] planes (structure-of-arrays: no [R,K,3] layout).
 2. SELECT: each ray's V nearest crossed chunks, ascending entry t, by V
    rounds of (min, argmin, mask) over the [R,K] near matrix — batched
    vector reductions, not a sort. On the GPU the fused kernel
    ops/pallas_select.py does CULL + SELECT without the [R,K] matrix.
 3. SWEEP: a while_loop over visit slots; slot s gathers each ray's s-th
    chunk row from a fused [K, F*C] component table (one XLA row gather)
    and runs the [R,C] intersection test with the running per-ray t_best
    as tmax.
    Early exit: a slot where no ray's next entry t beats its t_best ends
    the sweep — the same front-to-back pruning as the reference's
    right-subtree interval clamp.

EXACTNESS: a ray needing more than V visits (closest hit not found among
its V nearest chunks) is handled by an outer while_loop that re-selects
the next V nearest from the remaining [R,K] matrix until no ray's nearest
unvisited chunk can beat its best hit. Result == the chunk-scan oracle
(ops/chunked.py) for every ray, independent of V.

Differentiability: forward-only + custom VJP that replays the forward's
winning primitive in O(R) (ops/replay.py — round 2 re-ran the full XLA
chunk scan backward instead).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cpu_ray_tracing_implementation_tpu.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu.ops import tables as tbl

INF = jnp.inf


def _visit_block() -> int:
    """Visit slots selected per phase (env CRT_RAYV). Colonnade per-ray
    culled counts: mean 16 / p90 31 / max 135. Small blocks suit this:
    most rays find their hit in ~12 visits and the exactness loop
    re-selects only while some ray still needs more. The default was set
    on the previous accelerator; its re-check on the card is ROADMAP A4."""
    import os

    return int(os.environ.get("CRT_RAYV", "16"))


# ------------------------------------------------------------------ cull
def _near_matrix(org, dirs, lo, hi, tmin, cap):
    """[R,K] entry t of each ray into each chunk AABB; +inf where the ray's
    [tmin, cap] interval misses the box. SoA per axis — no [...,3] arrays."""
    R, K = org.shape[0], lo.shape[0]
    near = jnp.full((R, K), -INF, org.dtype)
    far = jnp.full((R, K), INF, org.dtype)
    for a in range(3):
        d = dirs[:, a]
        inv = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
        t0 = (lo[:, a][None, :] - org[:, a, None]) * inv[:, None]
        t1 = (hi[:, a][None, :] - org[:, a, None]) * inv[:, None]
        near = jnp.maximum(near, jnp.minimum(t0, t1))
        far = jnp.minimum(far, jnp.maximum(t0, t1))
    ok = (near <= far) & (far >= tmin) & (near <= cap[:, None])
    return jnp.where(ok, jnp.maximum(near, tmin), INF)


# --------------------------------------------------------------- select
def _select_block(nr, V):
    """(ids [R,V], nears [R,V] ascending, nr') — each ray's V nearest
    remaining chunks, masked out of the returned nr'."""
    K = nr.shape[1]
    col = jnp.arange(K, dtype=jnp.int32)[None, :]

    def step(nr, _):
        m = jnp.min(nr, axis=1)
        a = jnp.argmin(nr, axis=1).astype(jnp.int32)
        nr = jnp.where(col == a[:, None], INF, nr)
        return nr, (a, m)

    nr, (ids, nears) = jax.lax.scan(step, nr, None, length=V)
    return ids.T, nears.T, nr


def _use_select_kernel(tmin) -> bool:
    """The fused cull+select kernel (ops/pallas_select.py) replaces the XLA
    near matrix + selection rounds on the GPU backend. It needs a static
    ``tmin > 0`` (callers pass the positive T_MIN literal); anything else,
    and every other backend, takes the XLA select."""
    return (jax.default_backend() == "gpu"
            and not isinstance(tmin, jax.core.Tracer) and tmin > 0.0)


def _kernel_phase_loop(org, dirs, cap, lo, hi, tmin, V, sweep_fn, best0,
                       interpret=False):
    """Exactness phase loop with the fused kernel: phases carry only each
    ray's last selected key; the [R,K] near matrix never exists (see
    pallas_select.py phase semantics)."""
    from cpu_ray_tracing_implementation_tpu.ops import pallas_select as ps

    R = org.shape[0]
    boxes = ps.pack_boxes(lo, hi)
    rays, Rp = ps.pack_rays(org, dirs, cap)
    K_real = lo.shape[0]

    def phase(excl):
        ids, nears, rest = ps.cull_select(rays, boxes, excl, V, K_real,
                                          float(tmin), interpret=interpret)
        return ids, nears, rest[:R]

    ids, nears, rest = phase(jnp.zeros((Rp,), jnp.int32))
    best = sweep_fn(ids[:R], nears[:R], best0)

    def cond(state):
        rest, best = state[1], state[2:]
        return jnp.any(rest < best[0])

    def body(state):
        excl, _, best = state[0], state[1], state[2:]
        ids, nears, rest = phase(excl)
        best = sweep_fn(ids[:R], nears[:R], best)
        return (ps.last_key(ids, nears), rest) + best

    out = jax.lax.while_loop(cond, body,
                             (ps.last_key(ids, nears), rest) + best)
    return out[2:]


# ---------------------------------------------------------------- sweeps
def _comp(row, i, C):
    return jax.lax.dynamic_slice_in_dim(row, i * C, C, axis=1)


def _dot3(ax, ay, az, b):
    """[R,C] dot of per-ray-chunk component vectors with a [R,3] vector."""
    return ax * b[:, 0, None] + ay * b[:, 1, None] + az * b[:, 2, None]


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _planar_table(chunks: ch.PlanarChunks):
    """[K, 9*C] fused rows: corner/eu/ev components ONLY — the t-test's
    working set. ``active`` is baked in (inactive lanes get eu=ev=0, which
    kills the plane test intrinsically: d_n == 0 -> ok0 false), and mat is
    NOT fetched per visit — the winner's chunk mat row is gathered once
    after the phase loop (_recover_mat). 11 -> 9 comps = 18% fewer sweep
    bytes on the bandwidth-bound row gather (BASELINE.md round-4)."""
    act = chunks.active[..., None].astype(bool)
    eu = jnp.where(act, chunks.eu, 0.0)
    ev = jnp.where(act, chunks.ev, 0.0)
    comps = [chunks.corner[..., a] for a in range(3)]
    comps += [eu[..., a] for a in range(3)]
    comps += [ev[..., a] for a in range(3)]
    return jnp.concatenate(comps, axis=1)


def _recover_mat(chunk_mat, pid, hit):
    """[R] mat of chunk-order primitive ``pid`` — one row gather + one-hot
    lane select (the same row-gather shape the sweep uses, no
    take_along_axis). ``hit`` gates the recovery: miss rays keep the 0-init
    sentinel the chunk-scan oracle's payload carries (pid stays at its 0
    init on a miss, and chunks.mat[0,0] would leak through otherwise)."""
    C = chunk_mat.shape[1]
    rows = chunk_mat[pid // C]                       # [R, C]
    mat = jnp.round(jnp.sum(
        tbl.onehot(pid % C, C) * rows.astype(jnp.float32),
        axis=-1)).astype(jnp.int32)
    return jnp.where(hit, mat, 0)


def _planar_row_ts(org, dirs, row, C, tmin, t_best, triangle):
    """[R,C] candidate ts for each ray against ITS gathered chunk row —
    the per-ray-chunk form of ops.chunked._planar_chunk_ts (same guards,
    sentinels, and interior tests; elementwise instead of einsum)."""
    cx, cy, cz = (_comp(row, i, C) for i in range(3))
    eux, euy, euz = (_comp(row, i, C) for i in range(3, 6))
    evx, evy, evz = (_comp(row, i, C) for i in range(6, 9))

    nx, ny, nz = _cross3(eux, euy, euz, evx, evy, evz)
    nn = nx * nx + ny * ny + nz * nz
    inv_len = jax.lax.rsqrt(jnp.maximum(nn, 1e-30))
    unx, uny, unz = nx * inv_len, ny * inv_len, nz * inv_len
    d_plane = unx * cx + uny * cy + unz * cz
    inv_nn = 1.0 / jnp.maximum(nn, 1e-20)
    wx, wy, wz = nx * inv_nn, ny * inv_nn, nz * inv_nn
    ewx, ewy, ewz = _cross3(evx, evy, evz, wx, wy, wz)       # evw
    wex, wey, wez = _cross3(wx, wy, wz, eux, euy, euz)       # weu

    o_n = _dot3(unx, uny, unz, org)
    d_n = _dot3(unx, uny, unz, dirs)
    ok0 = jnp.abs(d_n) > 1e-20
    t = jnp.where(ok0, (d_plane - o_n) / jnp.where(ok0, d_n, 1.0), 1e30)

    a = jnp.clip(_dot3(ewx, ewy, ewz, org) + t * _dot3(ewx, ewy, ewz, dirs)
                 - (ewx * cx + ewy * cy + ewz * cz), -1e30, 1e30)
    b = jnp.clip(_dot3(wex, wey, wez, org) + t * _dot3(wex, wey, wez, dirs)
                 - (wex * cx + wey * cy + wez * cz), -1e30, 1e30)
    if triangle:
        interior = (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
    else:
        interior = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    # no `active` term: inactive lanes carry eu=ev=0 -> d_n == 0 -> ok0
    # already false (the table bakes the flag in, _planar_table)
    ok = ok0 & (t >= tmin) & (t <= t_best[:, None]) & interior
    return jnp.where(ok, t, INF), a, b, (unx, uny, unz)


def _planar_sweep(org, dirs, table, C, ids, nears, tmin, triangle, best):
    """Visit each ray's slot-s chunk while any ray's next entry t can beat
    its best; gathers rows per slot and tightens t_best front-to-back."""
    V = ids.shape[1]

    def cond(state):
        s = state[0]
        t_best = state[1]
        ns = jax.lax.dynamic_slice_in_dim(nears, s, 1, axis=1)[:, 0]
        return (s < V) & jnp.any(ns < t_best)

    def body(state):
        s, t_best, n_b, u_b, v_b, m_b, p_b = state
        ids_s = jax.lax.dynamic_slice_in_dim(ids, s, 1, axis=1)[:, 0]
        row = table[ids_s]                                   # [R, 9C]
        ts, a, b, (unx, uny, unz) = _planar_row_ts(
            org, dirs, row, C, tmin, t_best, triangle)
        t_c = jnp.min(ts, axis=-1)
        idx = jnp.argmin(ts, axis=-1)
        oh = tbl.onehot(idx, C)
        better = t_c < t_best
        sel = lambda comp: jnp.sum(oh * comp, axis=-1)
        n_c = jnp.stack([sel(unx), sel(uny), sel(unz)], axis=-1)
        # mat rides as dead state: recovered once from the winner pid
        # after the phase loop (_recover_mat)
        return (s + 1,
                jnp.where(better, t_c, t_best),
                jnp.where(better[:, None], n_c, n_b),
                jnp.where(better, sel(a), u_b),
                jnp.where(better, sel(b), v_b),
                m_b,
                jnp.where(better, ids_s * C + idx, p_b))

    state = jax.lax.while_loop(cond, body, (jnp.int32(0),) + best)
    return state[1:]


def planar_closest_perray(org, dirs, chunks: ch.PlanarChunks, tmin,
                          triangle: bool, tmax=INF):
    """Drop-in for ops.chunked.planar_closest (forward only; exact).

    ``tmax``: scalar or per-ray [R] traversal cap (see _near_matrix).
    Returns (t [R], (unorm [R,3], u [R], v [R], mat [R], pid [R]))."""
    R = org.shape[0]
    f32 = org.dtype
    K, C = chunks.corner.shape[0], chunks.corner.shape[1]
    V = min(_visit_block(), K)
    cap = jnp.broadcast_to(jnp.asarray(tmax, f32), (R,))
    table = _planar_table(chunks)

    if _use_q16_sweep():
        return _planar_closest_q16(org, dirs, chunks, tmin, triangle,
                                   cap, V, K, C)
    if _use_subtile() and C % _subtile_c() == 0:
        return _planar_closest_subtile(org, dirs, chunks, tmin, triangle,
                                       cap)

    t_init = cap
    best0 = (t_init, jnp.zeros((R, 3), f32), jnp.zeros((R,), f32),
             jnp.zeros((R,), f32), jnp.zeros((R,), jnp.int32),
             jnp.zeros((R,), jnp.int32))
    sweep = lambda ids, nears, best: _planar_sweep(
        org, dirs, table, C, jnp.clip(ids, 0, K - 1), nears, tmin,
        triangle, best)

    t, n, u, v, m, p = _run_select_loop(org, dirs, cap, chunks.lo,
                                        chunks.hi, tmin, V, sweep, best0)
    return jnp.where(t < t_init, t, INF), (
        n, u, v, _recover_mat(chunks.mat, p, t < t_init), p)


def _sphere_table(chunks: ch.SphereChunks):
    """[K, 7*C] fused rows: c0/c1 components + rad — the t-test working
    set. ``active`` is baked in (inactive lanes get rad=0: the quadratic's
    disc = 4((d.oc)^2 - |d|^2|oc|^2) <= 0 by Cauchy-Schwarz, never a hit)
    and mat is recovered once per winner (_recover_mat). 9 -> 7 comps =
    22% fewer sweep bytes."""
    comps = [chunks.c0[..., a] for a in range(3)]
    comps += [chunks.c1[..., a] for a in range(3)]
    comps += [jnp.where(chunks.active.astype(bool), chunks.rad, 0.0)]
    return jnp.concatenate(comps, axis=1)


def _sphere_row_ts(org, dirs, time, row, C, tmin, t_best):
    """[R,C] sphere ts per gathered row — mirrors _sphere_chunk_ts."""
    c0x, c0y, c0z = (_comp(row, i, C) for i in range(3))
    c1x, c1y, c1z = (_comp(row, i, C) for i in range(3, 6))
    rad = _comp(row, 6, C)
    tt = time[:, None]
    ctx = c0x + tt * (c1x - c0x)
    cty = c0y + tt * (c1y - c0y)
    ctz = c0z + tt * (c1z - c0z)

    # oc = org - center(t); standard quadratic (src/sphere.h:40-74 form)
    ocx = org[:, 0, None] - ctx
    ocy = org[:, 1, None] - cty
    ocz = org[:, 2, None] - ctz
    a = (dirs * dirs).sum(-1)[:, None]
    b = 2.0 * (dirs[:, 0, None] * ocx + dirs[:, 1, None] * ocy
               + dirs[:, 2, None] * ocz)
    c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = b * b - 4.0 * a * c
    has = disc > 0.0
    sq = jnp.sqrt(jnp.where(has, disc, 1.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    in0 = (t0 >= tmin) & (t0 <= t_best[:, None])
    in1 = (t1 >= tmin) & (t1 <= t_best[:, None])
    t = jnp.where(in0, t0, jnp.where(in1, t1, INF))
    # no `active` term: inactive lanes carry rad=0 -> disc <= 0 -> no hit
    ts = jnp.where(has, t, INF)
    return ts, (ctx, cty, ctz), rad


def _sphere_sweep(org, dirs, time, table, C, ids, nears, tmin, best):
    V = ids.shape[1]

    def cond(state):
        s, t_best = state[0], state[1]
        ns = jax.lax.dynamic_slice_in_dim(nears, s, 1, axis=1)[:, 0]
        return (s < V) & jnp.any(ns < t_best)

    def body(state):
        s, t_best, ctr_b, rad_b, m_b, p_b = state
        ids_s = jax.lax.dynamic_slice_in_dim(ids, s, 1, axis=1)[:, 0]
        row = table[ids_s]
        ts, (ctx, cty, ctz), rad = _sphere_row_ts(
            org, dirs, time, row, C, tmin, t_best)
        t_c = jnp.min(ts, axis=-1)
        idx = jnp.argmin(ts, axis=-1)
        oh = tbl.onehot(idx, C)
        better = t_c < t_best
        sel = lambda comp: jnp.sum(oh * comp, axis=-1)
        ctr_c = jnp.stack([sel(ctx), sel(cty), sel(ctz)], axis=-1)
        # mat rides as dead state: recovered per winner after the loop
        return (s + 1,
                jnp.where(better, t_c, t_best),
                jnp.where(better[:, None], ctr_c, ctr_b),
                jnp.where(better, jnp.maximum(sel(rad), 1e-20), rad_b),
                m_b,
                jnp.where(better, ids_s * C + idx, p_b))

    state = jax.lax.while_loop(cond, body, (jnp.int32(0),) + best)
    return state[1:]


def sphere_closest_perray(org, dirs, time, chunks: ch.SphereChunks, tmin,
                          tmax=INF):
    """Drop-in for ops.chunked.sphere_closest (forward only; exact).
    Returns (t [R], (center_at_t [R,3], rad [R], mat [R], pid [R]))."""
    R = org.shape[0]
    f32 = org.dtype
    K, C = chunks.rad.shape
    V = min(_visit_block(), K)
    cap = jnp.broadcast_to(jnp.asarray(tmax, f32), (R,))
    if _use_subtile() and C % _subtile_c() == 0:
        return _sphere_closest_subtile(org, dirs, time, chunks, tmin, cap)
    table = _sphere_table(chunks)

    t_init = cap
    best0 = (t_init, jnp.zeros((R, 3), f32), jnp.ones((R,), f32),
             jnp.zeros((R,), jnp.int32), jnp.zeros((R,), jnp.int32))
    sweep = lambda ids, nears, best: _sphere_sweep(
        org, dirs, time, table, C, jnp.clip(ids, 0, K - 1), nears, tmin,
        best)

    t, ctr, rad, m, p = _run_select_loop(org, dirs, cap, chunks.lo,
                                         chunks.hi, tmin, V, sweep, best0)
    return jnp.where(t < t_init, t, INF), (
        ctr, rad, _recover_mat(chunks.mat, p, t < t_init), p)



# ----------------- sub-tile selection (finer traversal altitude, round 5)
# The C=128 chunk is the selection granule of every path above: a visited
# chunk costs 128 masked primitive tests even though the ray's interval
# typically overlaps a small part of it (V=16 x 128 = 2048 tests/ray), so
# further wins need FEWER TESTS, not cheaper bytes. This mode selects at
# sub-tile granularity (CS-prim slices of each chunk, default 32, with
# their own AABBs) and sweeps P = 128/CS selected
# sub-tiles per slot packed into one full 128-lane test:
#
#  - selection sees 4x more, 4x tighter boxes (the cull+select kernel
#    and the exactness phase loop are reused unchanged — only the
#    box table and the id space change);
#  - every swept 128-lane row is assembled from the ray's P NEAREST
#    crossed sub-tiles (possibly from different chunks), so the lanes are
#    all candidates instead of 1 tight region + 96 bystanders;
#  - pid stays the global chunk-major primitive index (sub-tiles are
#    contiguous slices), so winner-mat recovery, replay VJPs, and
#    tri_attrs indexing are untouched.
#
# Exactness argument is the chunk path's, verbatim: testing extra
# primitives never breaks closest-hit correctness, selection order is
# front-to-back by (near, id), and the phase loop re-selects until no
# ray's nearest unvisited sub-tile can beat its best.


def _use_subtile() -> bool:
    """Opt-in (CRT_SUBTILE=1) while being measured; see BASELINE.md."""
    import os

    return os.environ.get("CRT_SUBTILE", "0") == "1"


def _subtile_c() -> int:
    import os

    return int(os.environ.get("CRT_SUBC", "32"))


def _visit_block_sub() -> int:
    """Sub-tile visit slots per phase (multiple of P = 128/CS)."""
    import os

    return int(os.environ.get("CRT_RAYV_SUB", "24"))


def _subtile_bounds_planar(chunks: ch.PlanarChunks, CS: int):
    """([K*G,3] lo, hi) sub-tile AABBs from the chunk tables (in-graph;
    inactive lanes excluded — they'd otherwise pin every padded box to the
    origin). Same +-1e-4 degenerate-axis pad as the build (src/aabb.h:81)."""
    K, C = chunks.mat.shape
    G = C // CS
    act = chunks.active[..., None].astype(bool)
    eu = jnp.where(act, chunks.eu, 0.0)
    ev = jnp.where(act, chunks.ev, 0.0)
    c = chunks.corner
    pts = jnp.stack([c, c + eu, c + ev, c + eu + ev])      # [4,K,C,3]
    lane_lo = jnp.where(act, pts.min(0) - 1e-4, INF)
    lane_hi = jnp.where(act, pts.max(0) + 1e-4, -INF)
    lo = lane_lo.reshape(K, G, CS, 3).min(axis=2).reshape(K * G, 3)
    hi = lane_hi.reshape(K, G, CS, 3).max(axis=2).reshape(K * G, 3)
    return lo, hi


def _subtile_bounds_sphere(chunks: ch.SphereChunks, CS: int):
    K, C = chunks.mat.shape
    G = C // CS
    act = chunks.active[..., None].astype(bool)
    rad = jnp.where(chunks.active.astype(bool), chunks.rad, 0.0)[..., None]
    lane_lo = jnp.where(act, jnp.minimum(chunks.c0, chunks.c1) - rad, INF)
    lane_hi = jnp.where(act, jnp.maximum(chunks.c0, chunks.c1) + rad, -INF)
    lo = lane_lo.reshape(K, G, CS, 3).min(axis=2).reshape(K * G, 3)
    hi = lane_hi.reshape(K, G, CS, 3).max(axis=2).reshape(K * G, 3)
    return lo, hi


def _table_sub(table, K: int, F: int, C: int, CS: int):
    """[K, F*C] fused rows -> [K*G, F*CS] sub-tile rows (G = C/CS)."""
    G = C // CS
    return (table.reshape(K, F, G, CS).transpose(0, 2, 1, 3)
            .reshape(K * G, F * CS))


def _gather_pack(table_sub, ids_p, F: int, CS: int):
    """Gather P sub-rows per ray and repack components contiguously:
    [R,P] ids -> [R, F*(P*CS)] row whose component i is the concatenation
    of the P sub-tiles' component i (the exact layout _planar_row_ts /
    _sphere_row_ts expect at C = P*CS)."""
    R, P = ids_p.shape
    rows = table_sub[ids_p]                                # [R, P, F*CS]
    return (rows.reshape(R, P, F, CS).transpose(0, 2, 1, 3)
            .reshape(R, F * P * CS))


def _winner_pid(ids_p, idx, CS: int):
    """Global pid of the winning lane: sub-tile j = idx // CS holds lanes
    [id*CS, id*CS+CS)."""
    P = ids_p.shape[1]
    sub_j = idx // CS
    sid = jnp.sum(tbl.onehot(sub_j, P) * ids_p.astype(jnp.float32),
                  axis=-1).astype(jnp.int32)
    return sid * CS + idx % CS


def _planar_sweep_sub(org, dirs, table_sub, CS, KG, ids, nears, tmin,
                      triangle, best):
    """_planar_sweep at sub-tile granularity: each iteration consumes P
    selected sub-tiles packed into one 128-lane test."""
    V = ids.shape[1]
    P = max(1, 128 // CS)
    CP = P * CS
    ids = jnp.clip(ids, 0, KG - 1)

    def cond(state):
        s = state[0]
        t_best = state[1]
        ns = jax.lax.dynamic_slice_in_dim(nears, s, 1, axis=1)[:, 0]
        return (s < V) & jnp.any(ns < t_best)

    def body(state):
        s, t_best, n_b, u_b, v_b, m_b, p_b = state
        ids_p = jax.lax.dynamic_slice_in_dim(ids, s, P, axis=1)  # [R,P]
        row = _gather_pack(table_sub, ids_p, 9, CS)              # [R,9*CP]
        ts, a, b, (unx, uny, unz) = _planar_row_ts(
            org, dirs, row, CP, tmin, t_best, triangle)
        t_c = jnp.min(ts, axis=-1)
        idx = jnp.argmin(ts, axis=-1)
        oh = tbl.onehot(idx, CP)
        better = t_c < t_best
        sel = lambda comp: jnp.sum(oh * comp, axis=-1)
        n_c = jnp.stack([sel(unx), sel(uny), sel(unz)], axis=-1)
        return (s + P,
                jnp.where(better, t_c, t_best),
                jnp.where(better[:, None], n_c, n_b),
                jnp.where(better, sel(a), u_b),
                jnp.where(better, sel(b), v_b),
                m_b,
                jnp.where(better, _winner_pid(ids_p, idx, CS), p_b))

    state = jax.lax.while_loop(cond, body, (jnp.int32(0),) + best)
    return state[1:]


def _sphere_sweep_sub(org, dirs, time, table_sub, CS, KG, ids, nears, tmin,
                      best):
    V = ids.shape[1]
    P = max(1, 128 // CS)
    CP = P * CS
    ids = jnp.clip(ids, 0, KG - 1)

    def cond(state):
        s, t_best = state[0], state[1]
        ns = jax.lax.dynamic_slice_in_dim(nears, s, 1, axis=1)[:, 0]
        return (s < V) & jnp.any(ns < t_best)

    def body(state):
        s, t_best, ctr_b, rad_b, m_b, p_b = state
        ids_p = jax.lax.dynamic_slice_in_dim(ids, s, P, axis=1)
        row = _gather_pack(table_sub, ids_p, 7, CS)
        ts, (ctx, cty, ctz), rad = _sphere_row_ts(
            org, dirs, time, row, CP, tmin, t_best)
        t_c = jnp.min(ts, axis=-1)
        idx = jnp.argmin(ts, axis=-1)
        oh = tbl.onehot(idx, CP)
        better = t_c < t_best
        sel = lambda comp: jnp.sum(oh * comp, axis=-1)
        ctr_c = jnp.stack([sel(ctx), sel(cty), sel(ctz)], axis=-1)
        return (s + P,
                jnp.where(better, t_c, t_best),
                jnp.where(better[:, None], ctr_c, ctr_b),
                jnp.where(better, jnp.maximum(sel(rad), 1e-20), rad_b),
                m_b,
                jnp.where(better, _winner_pid(ids_p, idx, CS), p_b))

    state = jax.lax.while_loop(cond, body, (jnp.int32(0),) + best)
    return state[1:]


def _run_select_loop(org, dirs, cap, lo, hi, tmin, V, sweep, best0,
                     interpret=False):
    """Shared select/sweep driver: the fused kernel's phase loop on the GPU
    (or in interpret mode where a test asks for it), the [R,K] near-matrix
    while_loop otherwise (boxes = whatever granularity the caller
    passes)."""
    if interpret or _use_select_kernel(tmin):
        return _kernel_phase_loop(org, dirs, cap, lo, hi, tmin, V, sweep,
                                  best0, interpret=interpret)
    nr = _near_matrix(org, dirs, lo, hi, tmin, cap)

    def cond(state):
        nr, best = state[0], state[1:]
        return jnp.any(jnp.min(nr, axis=1) < best[0])

    def body(state):
        nr, best = state[0], state[1:]
        ids, nears, nr = _select_block(nr, V)
        best = sweep(ids, nears, best)
        return (nr,) + best

    return jax.lax.while_loop(cond, body, (nr,) + best0)[1:]


def _planar_closest_subtile(org, dirs, chunks, tmin, triangle, cap):
    R = org.shape[0]
    f32 = org.dtype
    K, C = chunks.mat.shape
    CS = min(_subtile_c(), C)
    KG = K * (C // CS)
    P = max(1, 128 // CS)
    V = min(-(-_visit_block_sub() // P) * P, -(-KG // P) * P)
    lo, hi = _subtile_bounds_planar(chunks, CS)
    table_sub = _table_sub(_planar_table(chunks), K, 9, C, CS)

    t_init = cap
    best0 = (t_init, jnp.zeros((R, 3), f32), jnp.zeros((R,), f32),
             jnp.zeros((R,), f32), jnp.zeros((R,), jnp.int32),
             jnp.zeros((R,), jnp.int32))
    sweep = lambda ids, nears, best: _planar_sweep_sub(
        org, dirs, table_sub, CS, KG, ids, nears, tmin, triangle, best)
    t, n, u, v, m, p = _run_select_loop(org, dirs, cap, lo, hi, tmin, V,
                                        sweep, best0)
    return jnp.where(t < t_init, t, INF), (
        n, u, v, _recover_mat(chunks.mat, p, t < t_init), p)


def _sphere_closest_subtile(org, dirs, time, chunks, tmin, cap):
    R = org.shape[0]
    f32 = org.dtype
    K, C = chunks.mat.shape
    CS = min(_subtile_c(), C)
    KG = K * (C // CS)
    P = max(1, 128 // CS)
    V = min(-(-_visit_block_sub() // P) * P, -(-KG // P) * P)
    lo, hi = _subtile_bounds_sphere(chunks, CS)
    table_sub = _table_sub(_sphere_table(chunks), K, 7, C, CS)

    t_init = cap
    best0 = (t_init, jnp.zeros((R, 3), f32), jnp.ones((R,), f32),
             jnp.zeros((R,), jnp.int32), jnp.zeros((R,), jnp.int32))
    sweep = lambda ids, nears, best: _sphere_sweep_sub(
        org, dirs, time, table_sub, CS, KG, ids, nears, tmin, best)
    t, ctr, rad, m, p = _run_select_loop(org, dirs, cap, lo, hi, tmin, V,
                                         sweep, best0)
    return jnp.where(t < t_init, t, INF), (
        ctr, rad, _recover_mat(chunks.mat, p, t < t_init), p)


# ------------------------------- quantized-row sweep (opt-in, CRT_SWEEP_Q16)
def _use_q16_sweep() -> bool:
    """Opt-in (CRT_SWEEP_Q16=1) chunk-local quantized sweep for PLANAR
    chunks. Where the sweep row gather is bandwidth-bound its time scales
    with row bytes, so the rows store each triangle/quad's
    three defining points as u16 coordinates in the CHUNK AABB's frame —
    5*C packed f32 lanes (2.6 KB/row) instead of 9*C (4.6 KB).

    This is the compressed-leaf trade every production GPU tracer ships:
    dequantization perturbs vertices by at most extent * 2^-16 per axis
    (the colonnade: ~30 um on a ~2 m chunk), and the sweep then tests the
    DEQUANTIZED geometry exactly — no approximate margins, no candidate
    re-ranking. Edge vectors are integer differences of quantized points,
    so primitives sharing vertices in one chunk stay watertight; only
    cross-chunk shared edges can open sub-quantum cracks. A first
    attempt ranked bf16-approximate candidates with conservative margins
    instead — abandoned: correct bf16 margins scale with the term
    magnitudes (q = o + t d - c cancels), and at scene distances the
    margin floods the candidate set with edge-grazing junk that crowds
    the true winner out of any fixed top-k.

    It was speed-neutral on the previous accelerator once the 9-comp row
    diet made the sweep compute-bound (halving row bytes buys back what the
    u16 unpack + dequant add); on the card it is not measured (ROADMAP C1).
    Kept opt-in as the documented quantization experiment; the exact f32
    sweep stays the oracle-pinned default. Quality asserted by
    tests/test_q16_sweep.py."""
    import os

    return os.environ.get("CRT_SWEEP_Q16", "0") == "1"


def _q16_pack_pair(a, b):
    """One f32 lane holding u16 ``a`` in the high 16 bits, ``b`` low."""
    ai = a.astype(jnp.uint32) << 16
    bi = b.astype(jnp.uint32) & jnp.uint32(0xFFFF)
    return jax.lax.bitcast_convert_type(ai | bi, jnp.float32)


def _q16_unpack_pair(x):
    xi = jax.lax.bitcast_convert_type(x, jnp.uint32)
    return ((xi >> 16).astype(jnp.float32),
            (xi & jnp.uint32(0xFFFF)).astype(jnp.float32))


def _planar_table_q16(chunks: ch.PlanarChunks):
    """([K, 5*C] packed rows, lo [K,3], scale [K,3]) — the three defining
    points (corner, corner+eu, corner+ev) quantized to u16 in the chunk
    AABB frame. Inactive lanes quantize all three points equal -> integer
    edge diffs are exactly zero -> the plane test's d_n == 0 guard kills
    them, same as the exact table's encoding."""
    lo, hi = chunks.lo, chunks.hi
    ext = jnp.maximum(hi - lo, 1e-20)
    scale = ext / 65535.0
    inv = 65535.0 / ext

    act = chunks.active[..., None].astype(bool)
    p0 = chunks.corner
    p1 = p0 + jnp.where(act, chunks.eu, 0.0)
    p2 = p0 + jnp.where(act, chunks.ev, 0.0)

    def q(p):
        u = jnp.clip(jnp.round((p - lo[:, None, :]) * inv[:, None, :]),
                     0.0, 65535.0)
        return u.astype(jnp.uint16)

    q0, q1, q2 = q(p0), q(p1), q(p2)
    pairs = [(q0[..., 0], q0[..., 1]), (q0[..., 2], q1[..., 0]),
             (q1[..., 1], q1[..., 2]), (q2[..., 0], q2[..., 1]),
             (q2[..., 2], jnp.zeros_like(q2[..., 2]))]
    row = jnp.concatenate([_q16_pack_pair(a, b) for a, b in pairs], axis=1)
    return row, lo, scale


def _planar_row_ts_q16(org, dirs, row, lo_s, scale_s, C, tmin, t_best,
                       triangle):
    """[R,C] candidate ts + attributes against the DEQUANTIZED row — the
    exact _planar_row_ts math on the perturbed-by-quantization geometry
    (no margins). ``lo_s``/``scale_s`` are the gathered [R,3] chunk
    frames; edge vectors are integer point differences times scale, so
    they carry only the two endpoints' quantization error."""
    p = [_q16_unpack_pair(_comp(row, i, C)) for i in range(5)]
    q0x, q0y = p[0]
    q0z, q1x = p[1]
    q1y, q1z = p[2]
    q2x, q2y = p[3]
    q2z, _ = p[4]

    sx = scale_s[:, 0, None]
    sy = scale_s[:, 1, None]
    sz = scale_s[:, 2, None]
    cx = lo_s[:, 0, None] + q0x * sx
    cy = lo_s[:, 1, None] + q0y * sy
    cz = lo_s[:, 2, None] + q0z * sz
    eux = (q1x - q0x) * sx
    euy = (q1y - q0y) * sy
    euz = (q1z - q0z) * sz
    evx = (q2x - q0x) * sx
    evy = (q2y - q0y) * sy
    evz = (q2z - q0z) * sz

    nx, ny, nz = _cross3(eux, euy, euz, evx, evy, evz)
    nn = nx * nx + ny * ny + nz * nz
    inv_len = jax.lax.rsqrt(jnp.maximum(nn, 1e-30))
    unx, uny, unz = nx * inv_len, ny * inv_len, nz * inv_len
    d_plane = unx * cx + uny * cy + unz * cz
    inv_nn = 1.0 / jnp.maximum(nn, 1e-20)
    wx, wy, wz = nx * inv_nn, ny * inv_nn, nz * inv_nn
    ewx, ewy, ewz = _cross3(evx, evy, evz, wx, wy, wz)
    wex, wey, wez = _cross3(wx, wy, wz, eux, euy, euz)

    o_n = _dot3(unx, uny, unz, org)
    d_n = _dot3(unx, uny, unz, dirs)
    ok0 = jnp.abs(d_n) > 1e-20
    t = jnp.where(ok0, (d_plane - o_n) / jnp.where(ok0, d_n, 1.0), 1e30)

    a = jnp.clip(_dot3(ewx, ewy, ewz, org) + t * _dot3(ewx, ewy, ewz, dirs)
                 - (ewx * cx + ewy * cy + ewz * cz), -1e30, 1e30)
    b = jnp.clip(_dot3(wex, wey, wez, org) + t * _dot3(wex, wey, wez, dirs)
                 - (wex * cx + wey * cy + wez * cz), -1e30, 1e30)
    if triangle:
        interior = (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
    else:
        interior = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    ok = ok0 & (t >= tmin) & (t <= t_best[:, None]) & interior
    return jnp.where(ok, t, INF), a, b, (unx, uny, unz)


def _planar_sweep_q16(org, dirs, tableq, lo, scale, C, ids, nears, tmin,
                      triangle, best):
    """_planar_sweep on quantized rows (same state/masks/tie-breaks)."""
    V = ids.shape[1]

    def cond(state):
        s = state[0]
        t_best = state[1]
        ns = jax.lax.dynamic_slice_in_dim(nears, s, 1, axis=1)[:, 0]
        return (s < V) & jnp.any(ns < t_best)

    def body(state):
        s, t_best, n_b, u_b, v_b, m_b, p_b = state
        ids_s = jax.lax.dynamic_slice_in_dim(ids, s, 1, axis=1)[:, 0]
        row = tableq[ids_s]                                  # [R, 5C]
        ts, a, b, (unx, uny, unz) = _planar_row_ts_q16(
            org, dirs, row, lo[ids_s], scale[ids_s], C, tmin, t_best,
            triangle)
        t_c = jnp.min(ts, axis=-1)
        idx = jnp.argmin(ts, axis=-1)
        oh = tbl.onehot(idx, C)
        better = t_c < t_best
        sel = lambda comp: jnp.sum(oh * comp, axis=-1)
        n_c = jnp.stack([sel(unx), sel(uny), sel(unz)], axis=-1)
        return (s + 1,
                jnp.where(better, t_c, t_best),
                jnp.where(better[:, None], n_c, n_b),
                jnp.where(better, sel(a), u_b),
                jnp.where(better, sel(b), v_b),
                m_b,
                jnp.where(better, ids_s * C + idx, p_b))

    state = jax.lax.while_loop(cond, body, (jnp.int32(0),) + best)
    return state[1:]


def _planar_closest_q16(org, dirs, chunks, tmin, triangle, cap, V, K, C):
    """planar_closest_perray body for the quantized-row sweep."""
    R = org.shape[0]
    f32 = org.dtype
    tableq, lo, scale = _planar_table_q16(chunks)
    t_init = cap
    best0 = (t_init, jnp.zeros((R, 3), f32), jnp.zeros((R,), f32),
             jnp.zeros((R,), f32), jnp.zeros((R,), jnp.int32),
             jnp.zeros((R,), jnp.int32))
    sweep = lambda ids, nears, best: _planar_sweep_q16(
        org, dirs, tableq, lo, scale, C, jnp.clip(ids, 0, K - 1), nears,
        tmin, triangle, best)

    out = _run_select_loop(org, dirs, cap, chunks.lo, chunks.hi, tmin, V,
                           sweep, best0)
    t, n, u, v, m, p = out
    return jnp.where(t < t_init, t, INF), (
        n, u, v, _recover_mat(chunks.mat, p, t < t_init), p)


# ------------------------------------------------------------- autodiff glue
# Backward = winner replay (ops/replay.py): the forward's payload carries
# the winning primitive id, so the VJP re-intersects exactly that primitive
# in O(R) instead of re-running the full chunk scan (round 2 paid the
# 2,015-chunk colonnade sweep per gradient step — VERDICT weak 3).
@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def planar_closest_ray(org, dirs, chunks, tmin, triangle, tmax=INF):
    """Per-ray-visit-list forward + O(R) winner-replay backward."""
    return planar_closest_perray(org, dirs, chunks, tmin, triangle, tmax=tmax)


def _planar_fwd(org, dirs, chunks, tmin, triangle, tmax):
    out = planar_closest_perray(org, dirs, chunks, tmin, triangle, tmax=tmax)
    return out, (org, dirs, chunks, tmax, out[1][4])


def _planar_bwd(tmin, triangle, res, ct):
    from cpu_ray_tracing_implementation_tpu.ops import replay

    org, dirs, chunks, tmax, pid = res
    _, vjp = jax.vjp(
        lambda o, d, c: replay.planar_chunks_winner(o, d, c, pid, tmin,
                                                    triangle, tmax),
        org, dirs, chunks)
    return vjp(ct) + (jnp.zeros_like(tmax),)


planar_closest_ray.defvjp(_planar_fwd, _planar_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def sphere_closest_ray(org, dirs, time, chunks, tmin, tmax=INF):
    """Per-ray-visit-list forward + O(R) winner-replay backward."""
    return sphere_closest_perray(org, dirs, time, chunks, tmin, tmax=tmax)


def _sphere_fwd(org, dirs, time, chunks, tmin, tmax):
    out = sphere_closest_perray(org, dirs, time, chunks, tmin, tmax=tmax)
    return out, (org, dirs, time, chunks, tmax, out[1][3])


def _sphere_bwd(tmin, res, ct):
    from cpu_ray_tracing_implementation_tpu.ops import replay

    org, dirs, time, chunks, tmax, pid = res
    _, vjp = jax.vjp(
        lambda o, d, tm, c: replay.sphere_chunks_winner(o, d, tm, c, pid,
                                                        tmin, tmax),
        org, dirs, time, chunks)
    return vjp(ct) + (jnp.zeros_like(tmax),)


sphere_closest_ray.defvjp(_sphere_fwd, _sphere_bwd)
