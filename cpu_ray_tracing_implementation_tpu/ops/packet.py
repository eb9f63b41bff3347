"""Tile-packet culled closest-hit: BVH traversal shaped for batches.

Why not per-ray node traversal? Lockstep executes the MAX visit count over
all rays while the mean is far lower (tools/bvh_stats.py counts both), and
every step is a per-lane row gather (ops/bvh.py keeps that implementation as
the oracle / an option). The chunk scan (ops/chunked.py) has the opposite
problem: every ray tests every chunk, and the [R, C] elementwise work is
compute-bound, so the only way to go faster is to visit FEWER (ray, chunk)
pairs.

This module restructures the reference's per-ray BVH descent
(src/bvh_node.h:49-58) as *packet traversal* at tile granularity:

 - rays are processed in coherent tiles of TILE (camera rays arrive in
   pixel order, so a tile spans a small frustum);
 - per tile, one dense fused pass computes, for every chunk, whether ANY
   ray's [tmin, tmax] slab interval crosses the chunk AABB and the smallest
   entry t — [K] reductions over the tile, no [T,K] materialization, no
   gathers (the chunk AABBs come straight from the SAH builder's
   depth-first chunk order, utils/accel.py, which is what makes them tight);
 - hit chunks are visited front-to-back (argsort by near t) in a per-tile
   loop whose trip count is that tile's ACTUAL visit count; a tile exits
   once its nearest unvisited chunk starts beyond every ray's current
   closest hit — the same interval tightening the reference gets from its
   right-subtree clamp (src/bvh_node.h:53-57). Per-ray caps
   (intersect._packet_cap) bound miss rays at their scene-AABB exit and
   dead lanes at tmin, so sky-heavy and late-bounce tiles stop early too.

Two schedules exist (env CRT_PACKET, measured in tools/packet_stats.py):
 - ``map`` (default): ``lax.map`` over tiles, per-tile ``while_loop`` —
   total trips = SUM of per-tile visits, each trip [T,C] work. Wins when
   visit counts are skewed (divergent bounces: colonnade p50 104 / max 604
   culled chunks per tile) because a tile pays only its own visits.
 - ``lockstep``: ONE ``while_loop``, all tiles step together — trips =
   MAX per-tile visits, each trip [G,T,C] work (finished tiles ride along
   masked). Fewer, bigger dispatches; loses bounce-level skew (measured
   ~16.5 s vs ~1.35 s PER SAMPLE on colonnade 200px; the 30spp frame is
   ~66 s vs ~5.4 s at spp=4) but wins when visits are uniform. Kept for
   uniform-visit scenes and as the comparison baseline.

Differentiability: forward-only + custom VJP that replays the forward's
winning primitive in O(R) (ops/replay.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cpu_ray_tracing_implementation_tpu.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu.ops import tables as tbl

INF = jnp.inf


def _default_tile() -> int:
    """Rays per packet (env CRT_TILE, read per call): smaller = tighter
    frusta and finer per-tile culling, but the lockstep trip count is the
    max visit count over MORE tiles. Per-step compute is tile-invariant
    ([G*T, C] with G*T = R fixed)."""
    import os

    return int(os.environ.get("CRT_TILE", "2048"))


def _pad_tiles(arrs, R, tile):
    """Pad leading dim to a tile multiple and reshape to [G, tile, ...]."""
    g = (R + tile - 1) // tile
    out = []
    for a in arrs:
        pad = g * tile - R
        if pad:
            a = jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)
        out.append(a.reshape((g, tile) + a.shape[1:]))
    return out


def _chunk_hits(org, dirs, lo, hi, tmin, tmax):
    """Per-chunk (hit_any [K], near_min [K]) for one ray tile; ``tmax`` is
    the per-ray [T] traversal cap (world-AABB exit for miss rays, tmin for
    dead lanes — see intersect._packet_cap).

    The [T,K,3] slab arithmetic fuses into the K-wise reductions, so only
    [K] lives in HBM.
    """
    inv = 1.0 / jnp.where(jnp.abs(dirs) > 1e-20, dirs, 1e-20)   # [T,3]
    t0 = (lo[None, :, :] - org[:, None, :]) * inv[:, None, :]   # [T,K,3]
    t1 = (hi[None, :, :] - org[:, None, :]) * inv[:, None, :]
    near = jnp.max(jnp.minimum(t0, t1), axis=-1)                # [T,K]
    far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    ok = (near <= far) & (far >= tmin) & (near <= tmax[:, None])
    hit_any = jnp.any(ok, axis=0)                               # [K]
    near_c = jnp.min(jnp.where(ok, jnp.maximum(near, tmin), INF), axis=0)
    return hit_any, near_c


def _schedule() -> str:
    """Traversal schedule (env CRT_PACKET): 'map' or 'lockstep' — see the
    module docstring for the measured trade."""
    import os

    return os.environ.get("CRT_PACKET", "map")


def _planar_tile(org, dirs, chunks: ch.PlanarChunks, tmin, triangle, tmax):
    """Closest planar hit for one [T] ray tile (``tmax``: per-ray [T] cap)."""
    T = org.shape[0]
    K, C = chunks.corner.shape[0], chunks.corner.shape[1]
    f32 = org.dtype
    hit_any, near_c = _chunk_hits(org, dirs, chunks.lo, chunks.hi, tmin, tmax)
    keyed = jnp.where(hit_any, near_c, INF)
    order, near_sorted = jnp.argsort(keyed), jnp.sort(keyed)

    t_init = tmax
    init = (jnp.int32(0), t_init,
            jnp.zeros((T, 3), f32), jnp.zeros((T,), f32),
            jnp.zeros((T,), f32), jnp.zeros((T,), jnp.int32),
            jnp.zeros((T,), jnp.int32))

    def cond(state):
        s, t_best = state[0], state[1]
        return (s < K) & (near_sorted[s] <= jnp.max(t_best)) \
            & jnp.isfinite(near_sorted[s])

    def body(state):
        s, t_best, n_b, u_b, v_b, m_b, p_b = state
        k = order[s]
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, k, 1, axis=0)[0]
        corner, eu, ev = sl(chunks.corner), sl(chunks.eu), sl(chunks.ev)
        active = sl(chunks.active)
        mat = sl(chunks.mat)
        ts, a, b, unorm = ch._planar_chunk_ts(
            org, dirs, corner, eu, ev, active, tmin, t_best, triangle)
        t_c = jnp.min(ts, axis=-1)
        idx = jnp.argmin(ts, axis=-1)
        oh = tbl.onehot(idx, C)
        better = t_c < t_best
        mm = lambda tab: jnp.matmul(oh, tab, precision="highest")
        return (s + 1,
                jnp.where(better, t_c, t_best),
                jnp.where(better[:, None], mm(unorm), n_b),
                jnp.where(better, jnp.sum(oh * a, axis=-1), u_b),
                jnp.where(better, jnp.sum(oh * b, axis=-1), v_b),
                jnp.where(better,
                          jnp.round(mm(mat.astype(f32)[:, None]))[:, 0]
                          .astype(jnp.int32), m_b),
                jnp.where(better, k * C + idx, p_b))

    _, t, n, u, v, m, p = jax.lax.while_loop(cond, body, init)
    return jnp.where(t < t_init, t, INF), n, u, v, m, p


def _sphere_tile(org, dirs, time, chunks: ch.SphereChunks, tmin, tmax):
    """Closest sphere hit for one [T] ray tile (``tmax``: per-ray [T] cap)."""
    T = org.shape[0]
    K, C = chunks.rad.shape
    f32 = org.dtype
    hit_any, near_c = _chunk_hits(org, dirs, chunks.lo, chunks.hi, tmin, tmax)
    keyed = jnp.where(hit_any, near_c, INF)
    order, near_sorted = jnp.argsort(keyed), jnp.sort(keyed)

    t_init = tmax
    init = (jnp.int32(0), t_init,
            jnp.zeros((T, 3), f32), jnp.ones((T,), f32),
            jnp.zeros((T,), jnp.int32), jnp.zeros((T,), jnp.int32))

    def cond(state):
        s, t_best = state[0], state[1]
        return (s < K) & (near_sorted[s] <= jnp.max(t_best)) \
            & jnp.isfinite(near_sorted[s])

    def body(state):
        s, t_best, ctr_b, rad_b, m_b, p_b = state
        k = order[s]
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, k, 1, axis=0)[0]
        c0, c1, rad = sl(chunks.c0), sl(chunks.c1), sl(chunks.rad)
        active, mat = sl(chunks.active), sl(chunks.mat)
        ts = ch._sphere_chunk_ts(org, dirs, time, c0, c1, rad, active,
                                 tmin, t_best)
        t_c = jnp.min(ts, axis=-1)
        idx = jnp.argmin(ts, axis=-1)
        oh = tbl.onehot(idx, C)
        better = t_c < t_best
        mm = lambda tab: jnp.matmul(oh, tab, precision="highest")
        c0_w, c1_w = mm(c0), mm(c1)
        ctr_c = c0_w + time[:, None] * (c1_w - c0_w)
        return (s + 1,
                jnp.where(better, t_c, t_best),
                jnp.where(better[:, None], ctr_c, ctr_b),
                jnp.where(better,
                          jnp.maximum(mm(rad[:, None])[:, 0], 1e-20), rad_b),
                jnp.where(better,
                          jnp.round(mm(mat.astype(f32)[:, None]))[:, 0]
                          .astype(jnp.int32), m_b),
                jnp.where(better, k * C + idx, p_b))

    _, t, ctr, rad, m, p = jax.lax.while_loop(cond, body, init)
    return jnp.where(t < t_init, t, INF), ctr, rad, m, p


def _visit_orders(org_t, dirs_t, tmax_t, lo, hi, tmin):
    """Per-tile front-to-back visit order.

    Inputs are tiled [G,T,...]; returns ([G,K] chunk ids nearest-first,
    [G,K] ascending entry t, +inf = no more chunks for that tile)."""
    hit_any, near_c = jax.vmap(
        lambda o, d, tx: _chunk_hits(o, d, lo, hi, tmin, tx)
    )(org_t, dirs_t, tmax_t)
    keyed = jnp.where(hit_any, near_c, INF)                     # [G,K]
    return jnp.argsort(keyed, axis=-1), jnp.sort(keyed, axis=-1)


def _tiles_live(near_sorted, s, t_best):
    """[G] bool: tile still has a chunk that could beat its best hit.

    Monotone in ``s`` per tile (entry ts ascend, bests only shrink), so a
    shared step counter across tiles is sound: a finished tile stays
    finished and its updates are no-ops."""
    ns = jax.lax.dynamic_slice_in_dim(near_sorted, s, 1, axis=1)[:, 0]
    return jnp.isfinite(ns) & (ns <= jnp.max(t_best, axis=1))


def _planar_packet_tiled(org_t, dirs_t, tmax_t, chunks: ch.PlanarChunks,
                         tmin, triangle):
    """Closest planar hit for [G,T] tiled rays in one lockstep loop."""
    G, T = org_t.shape[:2]
    K, C = chunks.corner.shape[0], chunks.corner.shape[1]
    f32 = org_t.dtype
    order, near_sorted = _visit_orders(org_t, dirs_t, tmax_t,
                                       chunks.lo, chunks.hi, tmin)

    t_init = tmax_t
    init = (jnp.int32(0), t_init,
            jnp.zeros((G, T, 3), f32), jnp.zeros((G, T), f32),
            jnp.zeros((G, T), f32), jnp.zeros((G, T), jnp.int32),
            jnp.zeros((G, T), jnp.int32))

    def cond(state):
        s, t_best = state[0], state[1]
        return (s < K) & jnp.any(_tiles_live(near_sorted, s, t_best))

    def body(state):
        s, t_best, n_b, u_b, v_b, m_b, p_b = state
        k = jax.lax.dynamic_slice_in_dim(order, s, 1, axis=1)[:, 0]  # [G]
        corner, eu, ev = chunks.corner[k], chunks.eu[k], chunks.ev[k]
        active, mat = chunks.active[k], chunks.mat[k]
        ts, a, b, unorm = jax.vmap(
            lambda o, d, cn, u_, v_, ac, tb: ch._planar_chunk_ts(
                o, d, cn, u_, v_, ac, tmin, tb, triangle)
        )(org_t, dirs_t, corner, eu, ev, active, t_best)    # [G,T,C]
        t_c = jnp.min(ts, axis=-1)                          # [G,T]
        idx = jnp.argmin(ts, axis=-1)
        oh = tbl.onehot(idx, C)                             # [G,T,C]
        better = t_c < t_best
        mm = lambda tab: jnp.einsum("gtc,gcj->gtj", oh, tab,
                                    precision="highest")
        return (s + 1,
                jnp.where(better, t_c, t_best),
                jnp.where(better[..., None], mm(unorm), n_b),
                jnp.where(better, jnp.sum(oh * a, axis=-1), u_b),
                jnp.where(better, jnp.sum(oh * b, axis=-1), v_b),
                jnp.where(better,
                          jnp.round(mm(mat.astype(f32)[..., None]))[..., 0]
                          .astype(jnp.int32), m_b),
                jnp.where(better, (k * C)[:, None] + idx, p_b))

    _, t, n, u, v, m, p = jax.lax.while_loop(cond, body, init)
    return jnp.where(t < t_init, t, INF), n, u, v, m, p


def planar_closest_packet(org, dirs, chunks: ch.PlanarChunks, tmin,
                          triangle: bool, tmax=INF, tile: int | None = None):
    """Drop-in for ops.chunked.planar_closest (forward only).

    ``tmax``: scalar or per-ray [R] traversal cap (see _chunk_hits).
    Returns (t [R], (unorm [R,3], u [R], v [R], mat [R]))."""
    R = org.shape[0]
    tile = min(tile or _default_tile(), max(R, 1))
    tmax_r = jnp.broadcast_to(jnp.asarray(tmax, org.dtype), (R,))
    org_t, dirs_t, tmax_t = _pad_tiles([org, dirs, tmax_r], R, tile)
    if _schedule() == "lockstep":
        t, n, u, v, m, p = _planar_packet_tiled(org_t, dirs_t, tmax_t,
                                                chunks, tmin, triangle)
    else:
        t, n, u, v, m, p = jax.lax.map(
            lambda xs: _planar_tile(xs[0], xs[1], chunks, tmin, triangle,
                                    xs[2]),
            (org_t, dirs_t, tmax_t))
    flat = lambda a: a.reshape((-1,) + a.shape[2:])[:R]
    return flat(t), (flat(n), flat(u), flat(v), flat(m), flat(p))


def _sphere_packet_tiled(org_t, dirs_t, time_t, tmax_t,
                         chunks: ch.SphereChunks, tmin):
    """Closest sphere hit for [G,T] tiled rays in one lockstep loop."""
    G, T = org_t.shape[:2]
    K, C = chunks.rad.shape
    f32 = org_t.dtype
    order, near_sorted = _visit_orders(org_t, dirs_t, tmax_t,
                                       chunks.lo, chunks.hi, tmin)

    t_init = tmax_t
    init = (jnp.int32(0), t_init,
            jnp.zeros((G, T, 3), f32), jnp.ones((G, T), f32),
            jnp.zeros((G, T), jnp.int32), jnp.zeros((G, T), jnp.int32))

    def cond(state):
        s, t_best = state[0], state[1]
        return (s < K) & jnp.any(_tiles_live(near_sorted, s, t_best))

    def body(state):
        s, t_best, ctr_b, rad_b, m_b, p_b = state
        k = jax.lax.dynamic_slice_in_dim(order, s, 1, axis=1)[:, 0]  # [G]
        c0, c1, rad = chunks.c0[k], chunks.c1[k], chunks.rad[k]
        active, mat = chunks.active[k], chunks.mat[k]
        ts = jax.vmap(
            lambda o, d, tm, a0, a1, r_, ac, tb: ch._sphere_chunk_ts(
                o, d, tm, a0, a1, r_, ac, tmin, tb)
        )(org_t, dirs_t, time_t, c0, c1, rad, active, t_best)  # [G,T,C]
        t_c = jnp.min(ts, axis=-1)
        idx = jnp.argmin(ts, axis=-1)
        oh = tbl.onehot(idx, C)
        better = t_c < t_best
        mm = lambda tab: jnp.einsum("gtc,gcj->gtj", oh, tab,
                                    precision="highest")
        c0_w, c1_w = mm(c0), mm(c1)
        ctr_c = c0_w + time_t[..., None] * (c1_w - c0_w)
        return (s + 1,
                jnp.where(better, t_c, t_best),
                jnp.where(better[..., None], ctr_c, ctr_b),
                jnp.where(better,
                          jnp.maximum(mm(rad[..., None])[..., 0], 1e-20),
                          rad_b),
                jnp.where(better,
                          jnp.round(mm(mat.astype(f32)[..., None]))[..., 0]
                          .astype(jnp.int32), m_b),
                jnp.where(better, (k * C)[:, None] + idx, p_b))

    _, t, ctr, rad, m, p = jax.lax.while_loop(cond, body, init)
    return jnp.where(t < t_init, t, INF), ctr, rad, m, p


def sphere_closest_packet(org, dirs, time, chunks: ch.SphereChunks, tmin,
                          tmax=INF, tile: int | None = None):
    """Drop-in for ops.chunked.sphere_closest (forward only).

    ``tmax``: scalar or per-ray [R] traversal cap (see _chunk_hits).
    Returns (t [R], (center_at_t [R,3], rad [R], mat [R], pid [R]))."""
    R = org.shape[0]
    tile = min(tile or _default_tile(), max(R, 1))
    tmax_r = jnp.broadcast_to(jnp.asarray(tmax, org.dtype), (R,))
    org_t, dirs_t, time_t, tmax_t = _pad_tiles([org, dirs, time, tmax_r],
                                               R, tile)
    if _schedule() == "lockstep":
        t, ctr, rad, m, p = _sphere_packet_tiled(org_t, dirs_t, time_t,
                                                 tmax_t, chunks, tmin)
    else:
        t, ctr, rad, m, p = jax.lax.map(
            lambda xs: _sphere_tile(xs[0], xs[1], xs[2], chunks, tmin,
                                    xs[3]),
            (org_t, dirs_t, time_t, tmax_t))
    flat = lambda a: a.reshape((-1,) + a.shape[2:])[:R]
    return flat(t), (flat(ctr), flat(rad), flat(m), flat(p))


# ------------------------------------------------------------- autodiff glue
# Backward = winner replay (ops/replay.py): O(R) re-intersection of the
# forward's winning primitive instead of the full chunk-scan VJP — see
# ops/perray.py's glue for the rationale.
@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def planar_closest_accel(org, dirs, chunks, tmin, triangle, tmax=INF):
    """Packet forward + O(R) winner-replay backward: the differentiable
    default accelerator for large planar tables. ``tmax`` may be scalar or
    per-ray [R] (a traced operand; it is a traversal *bound*, so it carries
    no gradient)."""
    return planar_closest_packet(org, dirs, chunks, tmin, triangle, tmax=tmax)


def _planar_fwd(org, dirs, chunks, tmin, triangle, tmax):
    out = planar_closest_packet(org, dirs, chunks, tmin, triangle, tmax=tmax)
    return out, (org, dirs, chunks, tmax, out[1][4])


def _planar_bwd(tmin, triangle, res, ct):
    from cpu_ray_tracing_implementation_tpu.ops import replay

    org, dirs, chunks, tmax, pid = res
    _, vjp = jax.vjp(
        lambda o, d, c: replay.planar_chunks_winner(o, d, c, pid, tmin,
                                                    triangle, tmax),
        org, dirs, chunks)
    return vjp(ct) + (jnp.zeros_like(tmax),)


planar_closest_accel.defvjp(_planar_fwd, _planar_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def sphere_closest_accel(org, dirs, time, chunks, tmin, tmax=INF):
    """Packet forward + O(R) winner-replay backward for sphere chunks.
    ``tmax``: scalar or per-ray [R] bound (no gradient)."""
    return sphere_closest_packet(org, dirs, time, chunks, tmin, tmax=tmax)


def _sphere_fwd(org, dirs, time, chunks, tmin, tmax):
    out = sphere_closest_packet(org, dirs, time, chunks, tmin, tmax=tmax)
    return out, (org, dirs, time, chunks, tmax, out[1][3])


def _sphere_bwd(tmin, res, ct):
    from cpu_ray_tracing_implementation_tpu.ops import replay

    org, dirs, time, chunks, tmax, pid = res
    _, vjp = jax.vjp(
        lambda o, d, tm, c: replay.sphere_chunks_winner(o, d, tm, c, pid,
                                                        tmin, tmax),
        org, dirs, time, chunks)
    return vjp(ct) + (jnp.zeros_like(tmax),)


sphere_closest_accel.defvjp(_sphere_fwd, _sphere_bwd)
