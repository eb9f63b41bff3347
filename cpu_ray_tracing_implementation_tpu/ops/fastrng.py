"""Cheap counter-based uniforms for path sampling.

The reference draws every random number from one global ``std::rand()``
(src/utility.h:20) — racy under its thread pool and irreproducible. Round 1
replaced it with per-lane ``jax.random.fold_in`` + ``uniform`` (threefry):
deterministic and shard-invariant, but costly: each lane pays a 20-round
threefry hash per fold plus ~one block per two uniforms, a large share of
the forward pass on the previous accelerator (its share on the card is not
measured).

Monte-Carlo pixel sampling does not need a cryptographic stream; it needs a
counter hash with good avalanche so that adjacent (pixel, sample, bounce,
slot) counters decorrelate. This module supplies the standard
graphics-literature answer: a murmur3/xxhash-style 32-bit finalizer chain
(two multiply-xorshift rounds, ~12 integer ops per uniform, ~10x cheaper than
threefry) keyed by a 64-bit seed that IS still derived from the session's
``jax.random`` key — so the public API keeps jax key semantics and the
stream stays deterministic, shard-invariant, and replayable.

Quality: two finalizer rounds pass the avalanche and uniformity checks in
tests/test_fastrng.py (bit-bias < 1e-2, chi-square uniform, decorrelated
across pixel/bounce/slot strides); this matches the hashes used for
per-pixel seeding in production wavefront path tracers. The integrator
selects the implementation per render via ``rng="fast"|"threefry"``
(models/integrator.py); parity/replay tests keep threefry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# murmur3 fmix32 / h2 hash constants — numpy scalars, NOT jnp (a
# module-level jnp.uint32 would initialize the XLA backend at import,
# breaking jax.distributed.initialize in multihost workers)
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_C3 = np.uint32(0x7FEB352D)
_C4 = np.uint32(0x846CA68B)
_GOLD = np.uint32(0x9E3779B9)


def _fmix(x: jnp.ndarray) -> jnp.ndarray:
    """murmur3 32-bit finalizer: full avalanche for a single word."""
    x = x ^ (x >> 16)
    x = x * _C1
    x = x ^ (x >> 13)
    x = x * _C2
    x = x ^ (x >> 16)
    return x


def _mix2(x: jnp.ndarray) -> jnp.ndarray:
    """Second finalizer round (different constants) — the two-round chain
    decorrelates structured counter grids (id + slot*stride patterns)."""
    x = x ^ (x >> 15)
    x = x * _C3
    x = x ^ (x >> 13)
    x = x * _C4
    x = x ^ (x >> 16)
    return x


def seed_words(key, n: int) -> jnp.ndarray:
    """[n, 2] u32 seed-word table: row i hashes ``fold_in(key, i)``.

    Ordinary threefry, once per (sample, bounce) row — amortized over the
    whole lane batch. The classic scan integrator indexes rows by scan
    step; the path-regeneration wavefront gathers rows per lane — both
    read the same table, which is what keeps their streams bitwise equal.
    """
    return jax.vmap(
        lambda i: jax.random.bits(jax.random.fold_in(key, i), (2,),
                                  jnp.uint32))(jnp.arange(n))


def uniforms(s0, s1, ids: jnp.ndarray, nslot: int) -> jnp.ndarray:
    """[R, nslot] uniforms in [0, 1) for integer lane ``ids``.

    ``s0``/``s1``: u32 seed words (scalars, or [R] arrays for per-lane
    (sample, bounce) mixes in the wavefront). Stream contract mirrors
    integrator._per_ray_uniforms: a fixed function of (seed, id, slot)
    only — invariant to batch position, batch size, and device
    partitioning.
    """
    x = ids.astype(jnp.uint32) * _GOLD + jnp.asarray(s0, jnp.uint32)
    slot = jnp.arange(nslot, dtype=jnp.uint32) * _C2
    slot = slot[None, :] + jnp.asarray(s1, jnp.uint32).reshape(-1, 1)
    h = _mix2(_fmix(x)[:, None] ^ slot)
    # 24-bit mantissa path: exact float in [0, 1)
    return (h >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2**-24)
