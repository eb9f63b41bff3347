"""Pallas kernel (Triton route): fused per-ray chunk cull + top-V select.

The XLA form of the per-ray accelerator's select (ops/perray.py
``_near_matrix`` + ``_select_block``) writes an [R,K] near matrix to device
memory and reads and rewrites it in each of V (min, argmin, mask) rounds.
This kernel keeps it out of device memory: each program takes BLOCK_R rays
and loops over the K chunk AABBs in BLOCK_K tiles. A tile's slab test
produces [BLOCK_R, BLOCK_K] packed keys in registers, and the tile is merged
into a running per-ray list of the V+1 smallest keys, also in registers. Only
the [R,V] (ids, nears) lists and the (V+1)-th key leave the program.

Keys: one int32 per (ray, chunk) = (f32 near bits, low IDB bits replaced by
the chunk id). ``near >= tmin > 0``, so the f32 bit pattern orders as a
positive int32 and (coarsened near, id) is one total order with distinct
keys. The near a caller gets back is rounded DOWN by the stolen bits
(relative 2^-(23-IDB)), which is conservative everywhere it is used: the
sweep's can-this-slot-improve masks and the phase loop's rest-vs-best test
only ever do MORE work for a smaller near. Chunks whose nears coarsen equal
are visited in id order rather than exact-near order, so two primitives in
different chunks with exactly equal hit t can resolve to a different, still
deterministic, winner than the exact XLA select (tests/test_pallas_select.py).

Phases: a phase excludes every key at or below the previous phase's last
selected key, so consecutive phases partition the full ordered visit list
without the [R,K] matrix being carried between them. Phase 1 passes 0
(every real key is > 0); a ray whose list ran out passes ``EXHAUSTED``, which
excludes everything.

Merge: per tile, while any ray of the block has a tile key below the largest
key of its list, that key replaces the largest one. Most tiles hold no chunk
a ray crosses in front of its current list, so most tiles cost one round.
The list is sorted once at the end.

Forward only: the per-ray accelerator wraps it in a custom VJP whose
backward replays the winning primitive (ops/replay.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

BIG = 1e30
EXHAUSTED = 0x7FFFFFFF      # > every real key; excludes all in a phase

# Tuned on the colonnade's phase shapes (R = 8192, K = 2015, V = 16) on an
# H100 over block_r {16,32,64} x block_k {32,64,128} x warps {2,4,8}
# (PERF.md, kernel decisions).
BLOCK_R = 16
BLOCK_K = 32
NUM_WARPS = 4
NUM_STAGES = 2


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def id_bits(K: int) -> int:
    """Low key bits holding the chunk id."""
    return max(11, (K - 1).bit_length())


def _kernel(rays_ref, boxes_ref, excl_ref, ids_ref, nears_ref, rest_ref,
            *, V: int, K_real: int, n_tiles: int, block_k: int, tmin: float):
    BR = excl_ref.shape[0]
    VO = ids_ref.shape[1]               # V rounded up to a power of two
    W = _pow2(V + 1)                    # list width; slots >= V+1 are dead
    IDB = id_bits(K_real)
    HMASK = jnp.int32(-(1 << IDB))      # high (near) bits
    IDMASK = jnp.int32((1 << IDB) - 1)  # low (id) bits
    MASKV = jnp.int32(EXHAUSTED)

    o = [rays_ref[a, :][:, None] for a in range(3)]
    inv = []
    for a in range(3):
        d = rays_ref[3 + a, :][:, None]
        inv.append(1.0 / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20))
    cap = rays_ref[6, :][:, None]
    excl = excl_ref[...][:, None]

    slot = jax.lax.broadcasted_iota(jnp.int32, (BR, W), 1)
    # live slots start at distinct sentinels above every real key (so the
    # largest one is unique), dead slots at -1 (never the largest)
    lst0 = jnp.where(slot < V + 1, MASKV - 1 - slot, jnp.int32(-1))

    def tile(k, lst):
        start = k * block_k
        col = start + jax.lax.broadcasted_iota(jnp.int32, (BR, block_k), 1)
        near = jnp.full((BR, block_k), -BIG, jnp.float32)
        far = jnp.full((BR, block_k), BIG, jnp.float32)
        for a in range(3):
            lo = boxes_ref[a, pl.ds(start, block_k)][None, :]
            hi = boxes_ref[3 + a, pl.ds(start, block_k)][None, :]
            t0 = (lo - o[a]) * inv[a]
            t1 = (hi - o[a]) * inv[a]
            near = jnp.maximum(near, jnp.minimum(t0, t1))
            far = jnp.minimum(far, jnp.maximum(t0, t1))
        ok = (near <= far) & (far >= tmin) & (near <= cap)
        nearm = jnp.where(ok, jnp.maximum(near, tmin), jnp.inf)
        key = (jax.lax.bitcast_convert_type(nearm, jnp.int32) & HMASK) | col
        # padding chunks and everything earlier phases took are excluded
        key = jnp.where((key <= excl) | (col >= K_real), MASKV, key)

        def cond(st):
            key, lst = st
            m = jnp.min(key, axis=1)
            mx = jnp.max(lst, axis=1)
            return jnp.max((m < mx).astype(jnp.int32)) > 0

        def body(st):
            key, lst = st
            m = jnp.min(key, axis=1)[:, None]
            mx = jnp.max(lst, axis=1)[:, None]
            enter = m < mx
            lst = jnp.where(enter & (lst == mx), m, lst)
            key = jnp.where(enter & (key == m), MASKV, key)
            return key, lst

        return jax.lax.while_loop(cond, body, (key, lst))[1]

    lst = jax.lax.fori_loop(0, n_tiles, tile, lst0)

    # sort the V+1 live slots ascending; sentinels read as EXHAUSTED
    lst = jnp.where((slot < V + 1) & (lst < MASKV - W), lst, MASKV)
    out = jnp.zeros((BR, VO), jnp.int32)
    vcol = jax.lax.broadcasted_iota(jnp.int32, (BR, VO), 1)
    for v in range(V):
        m = jnp.min(lst, axis=1)[:, None]
        out = jnp.where(vcol == v, m, out)
        lst = jnp.where(lst == m, MASKV, lst)
    # EXHAUSTED slots repeat: after the first is taken, min stays MASKV
    rest = jnp.min(lst, axis=1)
    ids_ref[...] = out & IDMASK
    nears_ref[...] = jax.lax.bitcast_convert_type(out & HMASK, jnp.float32)
    rest_ref[...] = jax.lax.bitcast_convert_type(rest & HMASK, jnp.float32)


@functools.partial(jax.jit,
                   static_argnames=("V", "K_real", "tmin", "interpret",
                                    "block_r", "block_k"))
def cull_select(rays, boxes, excl, V: int, K_real: int, tmin: float,
                interpret: bool = False, block_r: int = BLOCK_R,
                block_k: int = BLOCK_K):
    """(ids [R,V] int32, nears [R,V] f32 ascending, rest [R] f32).

    ``rays``: [8, R] (ox oy oz dx dy dz cap pad), R a multiple of
    ``block_r`` (pad_rays); ``boxes``: [8, Kp] (lox loy loz hix hiy hiz **)
    from pack_boxes, Kp a multiple of ``block_k``; ``excl``: [R] int32, the
    previous phase's last key (0 for phase 1, see last_key).

    nears come back rounded DOWN by the id bits (NaN for exhausted slots);
    ``rest`` is the (V+1)-th key's near. Requires ``tmin > 0``: with
    tmin == 0 a ray starting inside chunk 0's AABB gets key 0, which the
    phase-1 exclusion would swallow. Callers with ``tmin <= 0`` use the XLA
    select (ops/perray.py).
    """
    if tmin <= 0.0:
        raise ValueError(f"cull_select needs tmin > 0, got {tmin}")
    R = rays.shape[1]
    Kp = boxes.shape[1]
    assert R % block_r == 0 and Kp % block_k == 0, (R, block_r, Kp, block_k)
    VO = _pow2(V)
    kern = functools.partial(_kernel, V=V, K_real=K_real,
                             n_tiles=Kp // block_k, block_k=block_k,
                             tmin=tmin)
    ids, nears, rest = pl.pallas_call(
        kern,
        grid=(R // block_r,),
        in_specs=[
            pl.BlockSpec((8, block_r), lambda i: (0, i)),
            pl.BlockSpec((8, Kp), lambda i: (0, 0)),
            pl.BlockSpec((block_r,), lambda i: (i,)),
        ],
        out_specs=[
            pl.BlockSpec((block_r, VO), lambda i: (i, 0)),
            pl.BlockSpec((block_r, VO), lambda i: (i, 0)),
            pl.BlockSpec((block_r,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((R, VO), jnp.int32),
            jax.ShapeDtypeStruct((R, VO), jnp.float32),
            jax.ShapeDtypeStruct((R,), jnp.float32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="cull_select",
    )(rays, boxes, excl)
    return ids[:, :V], nears[:, :V], rest


def last_key(ids, nears):
    """[R] int32 exclusion key of each ray's last selected slot: the packed
    key itself (nears carry only the high bits, ids the low ones)."""
    return (jax.lax.bitcast_convert_type(nears[:, -1], jnp.int32)
            | ids[:, -1])


def pack_rays(org, dirs, cap, block_r: int = BLOCK_R):
    """([8, Rp] ray pack, Rp): rows ox oy oz dx dy dz cap 0, rays padded
    with zeros to a multiple of ``block_r``."""
    R = org.shape[0]
    Rp = -(-R // block_r) * block_r
    pack = jnp.concatenate(
        [org.T, dirs.T, cap[None, :], jnp.zeros((1, R), org.dtype)], axis=0)
    return jnp.pad(pack, ((0, 0), (0, Rp - R))), Rp


def pack_boxes(lo, hi, block_k: int = BLOCK_K):
    """[8, Kp] AABB pack, chunks padded to a multiple of ``block_k`` with
    inverted boxes (the kernel also excludes them by id)."""
    K = lo.shape[0]
    Kp = -(-K // block_k) * block_k
    pack = jnp.full((8, Kp), BIG, jnp.float32)
    pack = pack.at[0:3, :K].set(lo.T)
    pack = pack.at[3:6, :K].set(hi.T)
    pack = pack.at[3:6, K:].set(-BIG)
    return pack
