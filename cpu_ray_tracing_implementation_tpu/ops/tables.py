"""Table-row lookup by one-hot contraction.

``table[idx]`` with a per-ray computed index is a per-lane row gather. For
the small scene tables this framework uses (materials, textures, per-type
primitive params) it is replaced by a one-hot contraction: build the [R,N]
comparison mask once and contract it against the table. The rule was set
by a measurement on the previous accelerator; its re-check on the card is
ROADMAP A4.

Large tables (noise permutation grids, image texels) keep the native gather:
the [R,N] one-hot would not fit in memory.
"""

from __future__ import annotations

import jax.numpy as jnp

MAX_ONEHOT = 64


def onehot(idx: jnp.ndarray, n: int, dtype=jnp.float32) -> jnp.ndarray:
    """[..., n] one-hot of idx [...] (any leading batch shape)."""
    return (idx[..., None] == jnp.arange(n, dtype=idx.dtype)).astype(dtype)


def take_rows(table: jnp.ndarray, idx: jnp.ndarray, oh: jnp.ndarray | None = None):
    """table[idx] for a 1-D index batch; one-hot matmul when the table is
    small. ``oh``: optionally pass a precomputed one-hot (shared across
    several lookups into same-length tables)."""
    n = table.shape[0]
    if oh is None and n > MAX_ONEHOT:
        return table[idx]
    if oh is None:
        oh = onehot(idx, n)
    # precision="highest": a default-precision f32 matmul may round its
    # operands (TF32 on the GPU), which would corrupt table values (geometry
    # coordinates, material params)
    mm = lambda a, b: jnp.matmul(a, b, precision="highest")
    if jnp.issubdtype(table.dtype, jnp.integer) or table.dtype == jnp.bool_:
        t = table.astype(jnp.float32)
        out = jnp.round(mm(oh, t if t.ndim > 1 else t[:, None]))
        return out.astype(table.dtype) if table.ndim > 1 else out[..., 0].astype(table.dtype)
    t = table.astype(oh.dtype)
    return mm(oh, t) if t.ndim > 1 else mm(oh, t[:, None])[..., 0]
