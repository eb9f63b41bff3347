"""Secondary-ray coherence sorting for the tile-packet traversal.

The packet accelerator (ops/packet.py) prunes chunks per TILE of rays, so
its win collapses when a tile's rays diverge: after the first diffuse
bounce, a tile of camera-order lanes spans the whole scene with random
directions, every chunk AABB passes the any-ray cull, and traversal
degenerates to a serialized brute-force scan (measured: the 258k-tri
colonnade fell from 0.23 s/frame coherent to 9.4 s/frame divergent).

The reference never needs this — its per-ray recursion (src/camera.h:193)
re-descends the BVH per ray — but a vector machine wants the equivalent
batched fix, standard in wavefront GPU path tracers: re-sort the ray batch
every bounce by a spatial-directional key so nearby lanes are coherent
again. The key packs, most-significant first,

    [6b coarse origin Morton | 3b direction octant | 15b fine origin Morton]

i.e. rays are grouped first by scene region, then by direction octant
within the region, then finely by position — each TILE then covers a small
frustum and the per-tile chunk cull bites again.

Everything rides ``lax.sort`` with the ray payload as extra operands
(multi-operand sort keeps lanes together WITHOUT per-lane row gathers);
a carried iota
is re-sorted afterwards to restore the caller's lane order, so sorting is
invisible to the integrator (and differentiable: ``lax.sort`` permutes
tangents with primals).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# sorting pays off once the scene has enough chunks for per-tile culling to
# matter and the batch is big enough to form many tiles
MIN_CHUNKS = 32
MIN_RAYS = 8192


def _part3(x: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 7 bits of x to every 3rd bit (Morton interleave)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def coherence_keys(org, dirs, lo, hi) -> jnp.ndarray:
    """[R] int32 sort key: coarse-Morton | octant | fine-Morton (see module
    docstring). ``lo``/``hi``: world AABB used to quantize origins."""
    ext = jnp.maximum(hi - lo, 1e-6)
    q = jnp.clip((org - lo[None, :]) / ext[None, :], 0.0, 1.0 - 1e-6)
    qi = (q * 128.0).astype(jnp.int32)                       # [R,3] 7 bits
    m = (_part3(qi[:, 0]) | (_part3(qi[:, 1]) << 1)
         | (_part3(qi[:, 2]) << 2))                          # 21-bit Morton
    octant = ((dirs[:, 0] > 0).astype(jnp.int32) * 4
              + (dirs[:, 1] > 0).astype(jnp.int32) * 2
              + (dirs[:, 2] > 0).astype(jnp.int32))
    return ((m >> 15) << 18) | (octant << 15) | (m & 0x7FFF)


def sort_rays(keys, arrays):
    """Sort lanes by ``keys``; returns (sorted arrays, lane_ids).

    ``arrays``: list of [R] or [R,k] arrays (k static, unpacked to scalar
    operands so everything goes through ONE multi-operand ``lax.sort``).
    ``lane_ids``: each sorted lane's original position — pass to
    ``unsort`` to restore caller order.
    """
    R = keys.shape[0]
    iota = jnp.arange(R, dtype=jnp.int32)
    ops, specs = [keys, iota], []
    for a in arrays:
        if a.ndim == 1:
            specs.append(None)
            ops.append(a)
        else:
            specs.append(a.shape[1])
            ops.extend(a[:, i] for i in range(a.shape[1]))
    out = jax.lax.sort(ops, num_keys=1, is_stable=False)
    lane_ids = out[1]
    sorted_arrays, pos = [], 2
    for spec in specs:
        if spec is None:
            sorted_arrays.append(out[pos])
            pos += 1
        else:
            sorted_arrays.append(jnp.stack(out[pos:pos + spec], axis=-1))
            pos += spec
    return sorted_arrays, lane_ids


def unsort(lane_ids, arrays):
    """Inverse of ``sort_rays``: restore original lane order for ``arrays``
    (same [R]/[R,k] convention). Bool/int payloads ride as-is; sorting by
    the carried original positions is an exact inverse permutation."""
    ops, specs = [lane_ids], []
    for a in arrays:
        if a.ndim == 1:
            specs.append((None, a.dtype))
            ops.append(a.astype(jnp.int32) if a.dtype == jnp.bool_ else a)
        else:
            specs.append((a.shape[1], a.dtype))
            ops.extend(a[:, i] for i in range(a.shape[1]))
    out = jax.lax.sort(ops, num_keys=1, is_stable=False)
    res, pos = [], 1
    for spec, dtype in specs:
        if spec is None:
            res.append(out[pos].astype(dtype))
            pos += 1
        else:
            res.append(jnp.stack(out[pos:pos + spec], axis=-1))
            pos += spec
    return res
