"""Owen-scrambled Sobol quasi-Monte-Carlo sampling (opt-in camera.qmc).

Beyond-parity extension: the reference draws every sample from rand()
(src/utility.h:20) — pure Monte Carlo, O(1/sqrt(n)) error. Here each
(pixel, sample) path can instead draw from a padded Owen-scrambled Sobol
(0,2)-sequence — the production-renderer standard (PBRT's padded Sobol
sampler; Burley, "Practical Hash-based Owen Scrambling", JCGT 2020):

- Sample ``s`` of a pixel takes point ``s`` of a 2-D Sobol (0,2)-sequence
  per DIMENSION PAIR (pixel jitter, BSDF direction, light UV, ...), so any
  prefix of samples stratifies over every elementary interval of the pair.
- Each (pixel, pair) gets its own Owen scramble, seeded by a counter hash
  of (pixel id, global dimension index, session key): pixels and pairs are
  mutually decorrelated, estimates stay unbiased (Owen scrambling is
  measure-preserving), and the stream remains a fixed function of
  (pixel id, sample index, bounce, slot) — the same contract that makes
  sharded/checkpointed/wavefront renders agree (ops/fastrng.py).

Shape: everything is u32 elementwise work. The Sobol second
dimension is a 32-term XOR reduction over direction vectors; the Owen
scramble is a Laine-Karras-style multiply-xorshift chain applied in
bit-reversed space (each output bit depends only on its own and higher
bits of the reversed input, i.e. a valid nested scramble that PRESERVES
the (0,2)-net property — verified by the elementary-interval tests).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracing_implementation_tpu.ops import fastrng

# Sobol dimension-2 direction vectors: v_1 = 2^31, v_j = v_{j-1} ^ (v_{j-1}
# >> 1) (the Pascal-matrix construction). numpy on purpose — module-level
# jnp would initialize the XLA backend at import (see ops/spectrum.py).
_V1 = np.zeros(32, np.uint32)
_V1[0] = np.uint32(1) << 31
for _j in range(1, 32):
    _V1[_j] = _V1[_j - 1] ^ (_V1[_j - 1] >> np.uint32(1))

_M1 = np.uint32(0x55555555)
_M2 = np.uint32(0x33333333)
_M3 = np.uint32(0x0F0F0F0F)
_M4 = np.uint32(0x00FF00FF)
# Laine-Karras permutation constants (Burley, JCGT 2020, listing 3)
_LK1 = np.uint32(0x3D20ADEA)
_LK2 = np.uint32(0x05526C56)
_LK3 = np.uint32(0x53A22864)


def _reverse_bits(x: jnp.ndarray) -> jnp.ndarray:
    x = ((x >> 1) & _M1) | ((x & _M1) << 1)
    x = ((x >> 2) & _M2) | ((x & _M2) << 2)
    x = ((x >> 4) & _M3) | ((x & _M3) << 4)
    x = ((x >> 8) & _M4) | ((x & _M4) << 8)
    return (x >> 16) | (x << 16)


def _sobol_dim0(index: jnp.ndarray) -> jnp.ndarray:
    """Van der Corput: bit-reversed sample index."""
    return _reverse_bits(index.astype(jnp.uint32))


def _sobol_dim1(index: jnp.ndarray) -> jnp.ndarray:
    """Second Sobol dimension: XOR of direction vectors at set index
    bits."""
    idx = index.astype(jnp.uint32)
    out = jnp.zeros_like(idx)
    for j in range(32):
        out = out ^ jnp.where((idx >> j) & 1, _V1[j], np.uint32(0))
    return out


def _lk_scramble(x: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Laine-Karras permutation (Burley 2020, listing 3): every operation
    (add, multiply-by-odd, xor with x*even) only propagates information
    toward HIGHER bits, which in bit-reversed space means each digit's
    permutation depends only on the digits above it — a valid nested
    (Owen) scramble that preserves (0,2)-net structure."""
    s = seed.astype(jnp.uint32)
    x = x ^ (x * _LK1)
    x = x + s
    x = x * ((s >> 16) | np.uint32(1))
    x = x ^ (x * _LK2)
    x = x ^ (x * _LK3)
    return x


def owen_scramble(x: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Hash-based Owen scramble of a u32 sample coordinate."""
    return _reverse_bits(_lk_scramble(_reverse_bits(x), seed))


def _to_unit(x: jnp.ndarray) -> jnp.ndarray:
    """u32 -> float32 in [0, 1) on the exact 24-bit-mantissa path."""
    return (x >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2 ** -24)


def sobol2d(index, seed0=None, seed1=None) -> jnp.ndarray:
    """[..., 2] point(s) of the (0,2)-sequence, optionally Owen-scrambled
    per coordinate."""
    d0 = _sobol_dim0(jnp.asarray(index))
    d1 = _sobol_dim1(jnp.asarray(index))
    if seed0 is not None:
        d0 = owen_scramble(d0, jnp.asarray(seed0))
    if seed1 is not None:
        d1 = owen_scramble(d1, jnp.asarray(seed1))
    return jnp.stack([_to_unit(d0), _to_unit(d1)], axis=-1)


# ---------------------------------------------------------------- layout
# Slot -> (pair group, dim within pair), chosen so semantically-2D draws
# (BSDF direction, light UV, fuzz disk, pixel jitter, defocus disk) land
# on a shared Sobol pair and get TRUE 2-D stratification.
# Camera slots (models/camera.py): 0,1 jitter; 2 time; 3,4 defocus.
CAM_GROUP = (0, 0, 1, 2, 2)
CAM_DIM = (0, 1, 0, 0, 1)
N_CAM_GROUPS = 3
# Bounce slots (ops/materials.py): 0 decision; 1,2 dir; 3 MIS; 4,5 light
# UV; 6,7 fuzz; 8 light pick; 9+ volume channels (singles).
_BOUNCE_GROUP = (0, 1, 1, 2, 3, 3, 4, 4, 5)
_BOUNCE_DIM = (0, 0, 1, 0, 0, 1, 0, 1, 0)
_N_BOUNCE_GROUPS = 6


def bounce_layout(nslot: int):
    """(groups, dims, n_groups) for a bounce block of ``nslot`` columns
    (NSLOT + n_volumes; volume slots get their own single groups)."""
    extra = nslot - len(_BOUNCE_GROUP)
    groups = _BOUNCE_GROUP + tuple(_N_BOUNCE_GROUPS + i for i in range(extra))
    dims = _BOUNCE_DIM + (0,) * extra
    return groups, dims, _N_BOUNCE_GROUPS + extra


def seed_words(key) -> jnp.ndarray:
    """[2] u32 session words deriving every scramble seed. MUST come from
    the render's base key (NOT a per-sample fold): the Sobol index carries
    the sample progression, the scramble must stay fixed across samples or
    the low-discrepancy property is destroyed."""
    import jax

    return jax.random.bits(key, (2,), jnp.uint32)


def shuffle_index(index: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Owen-shuffle of the sample index (Burley 2020 §10.3: scrambling the
    index is Owen-scrambling an extra 'dimension -1' of the sequence).

    This is what makes PADDING correct: without it, every dimension pair
    takes the SAME underlying (0,2) point at sample s, so the joint
    distribution across pairs collapses onto a 2-D manifold and the
    estimate converges to the wrong value (a bias measured at ~10-20% on
    multi-bounce renders before this was added). Independent per-pair
    index shuffles make the joint fill the full hypercube while each
    pair keeps its net structure.

    The scramble tree is MSB-first over the index (the same orientation as
    value scrambling): a 2^k prefix of sample indices then maps to an
    ALIGNED 2^k block of the sequence with a permuted interior — and any
    aligned block of a (0,2)-sequence is itself a (0,2)-net, so prefix
    stratification survives. (The reversed orientation scatters a prefix
    to hash-random indices and degrades low-spp quality to plain MC —
    measured before this fix.)"""
    return owen_scramble(jnp.asarray(index, jnp.uint32), seed)


def uniforms(words, ids: jnp.ndarray, index, base_group, groups, dims
             ) -> jnp.ndarray:
    """[R, nslot] Owen-scrambled, index-shuffled Sobol uniforms.

    ``words``: [2] session seed words; ``ids``: [R] pixel ids; ``index``:
    sample index (scalar, or [R] in the wavefront); ``base_group``: first
    global pair-group id of this block (traced ok); ``groups``/``dims``:
    static per-slot layout from bounce_layout / CAM_GROUP+CAM_DIM.

    Both dims of a pair share one shuffled index (the pair's 2-D net needs
    a common order); distinct (pixel, pair) combinations get independent
    shuffles and independent value scrambles.
    """
    idx = jnp.asarray(index)
    pid = ids.astype(jnp.uint32) * np.uint32(0x9E3779B9) + words[0]
    base = jnp.asarray(base_group, jnp.uint32)
    cols = []
    for g, d in zip(groups, dims):
        grp = base + np.uint32(g)
        shuf_seed = fastrng._mix2(fastrng._fmix(
            pid ^ (grp * np.uint32(0xC2B2AE35))) ^ words[1])
        si = shuffle_index(idx, shuf_seed)
        coord = _sobol_dim1(si) if d else _sobol_dim0(si)
        gdim = grp * np.uint32(2) + np.uint32(d)
        seed = fastrng._mix2(fastrng._fmix(pid ^ (gdim * np.uint32(
            0x85EBCA6B))) ^ words[1])
        cols.append(_to_unit(owen_scramble(coord, seed)))
    return jnp.stack(cols, axis=-1)
