"""Procedural noise as pure functions of position.

Functional re-design of reference src/noise.h: the C++ classes own mutable tables
built from ``rand()``; here the tables are plain arrays generated host-side
from a seed (``make_perlin_tables`` / ``make_value_grid``) and the noise
functions are pure jnp over [..., 3] points, so they fuse into the shading
kernel and are trivially differentiable w.r.t. position.

Faithfulness notes:
 - the reference XORs three lookups of the *same* permutation table
   (``perm_x`` used for u, v and w — src/noise.h:35); we keep one table.
 - reference ``value_noise`` reads out of bounds for points outside
   [0, res)^3 (src/noise.h:109-116); we clamp indices (documented fix,
   SURVEY.md appendix item 7).
 - worley/voronoi use the same sin-dot hash magic constants
   (src/noise.h:141-145).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from cpu_ray_tracing_implementation_tpu.ops import vecmath as vm

POINT_COUNT = 256


def make_perlin_tables(seed: int = 0):
    """Host-side: 256 random unit gradients + one permutation (src/noise.h:12-20)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1.0, 1.0, size=(POINT_COUNT, 3))
    g /= np.linalg.norm(g, axis=-1, keepdims=True) + 1e-12
    perm = rng.permutation(POINT_COUNT)
    return g.astype(np.float32), perm.astype(np.int32)


def make_value_grid(resolution: int, seed: int = 1):
    """Host-side: [res, res, res] grid of uniforms (src/noise.h:95-103)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, size=(resolution,) * 3).astype(np.float32)


def perlin_noise(p: jnp.ndarray, grad: jnp.ndarray, perm: jnp.ndarray) -> jnp.ndarray:
    """Gradient noise with smoothstep trilinear interpolation (src/noise.h:22-74).

    p: [..., 3]; grad: [256, 3]; perm: [256] int32. Returns [...] in ~[-1, 1].
    """
    pf = jnp.floor(p)
    ip = pf.astype(jnp.int32)
    d = p - pf  # (du, dv, dw) in [0,1)
    iu = jnp.bitwise_and(ip[..., 0], POINT_COUNT - 1)
    iv = jnp.bitwise_and(ip[..., 1], POINT_COUNT - 1)
    iw = jnp.bitwise_and(ip[..., 2], POINT_COUNT - 1)

    s = d * d * (3.0 - 2.0 * d)  # smoothstep weights (uu, vv, ww)

    accum = jnp.zeros(p.shape[:-1], p.dtype)
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                idx = (
                    perm[jnp.bitwise_and(iu + i, POINT_COUNT - 1)]
                    ^ perm[jnp.bitwise_and(iv + j, POINT_COUNT - 1)]
                    ^ perm[jnp.bitwise_and(iw + k, POINT_COUNT - 1)]
                )
                corner_grad = grad[idx]
                weight_v = d - jnp.array([i, j, k], p.dtype)
                w = (
                    (i * s[..., 0] + (1 - i) * (1.0 - s[..., 0]))
                    * (j * s[..., 1] + (1 - j) * (1.0 - s[..., 1]))
                    * (k * s[..., 2] + (1 - k) * (1.0 - s[..., 2]))
                )
                accum = accum + w * vm.dot(corner_grad, weight_v)
    return accum


def perlin_turb(p: jnp.ndarray, grad: jnp.ndarray, perm: jnp.ndarray, depth: int = 7) -> jnp.ndarray:
    """Fractal turbulence: |sum of halving-weight octaves| (src/noise.h:43-53)."""
    accum = jnp.zeros(p.shape[:-1], p.dtype)
    temp_p = p
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * perlin_noise(temp_p, grad, perm)
        weight *= 0.5
        temp_p = temp_p * 2.0
    return jnp.abs(accum)


def value_noise(p: jnp.ndarray, grid: jnp.ndarray) -> jnp.ndarray:
    """Trilinearly interpolated grid of uniforms (src/noise.h:95-137).

    Indices are clamped to the grid (fixing the reference's OOB read).
    """
    res = grid.shape[0]
    pf = jnp.floor(p)
    ip = jnp.clip(pf.astype(jnp.int32), 0, res - 1)
    ip1 = jnp.clip(ip + 1, 0, res - 1)
    f = p - pf

    def g(ix, iy, iz):
        return grid[ix, iy, iz]

    x0, y0, z0 = ip[..., 0], ip[..., 1], ip[..., 2]
    x1, y1, z1 = ip1[..., 0], ip1[..., 1], ip1[..., 2]

    c000, c100 = g(x0, y0, z0), g(x1, y0, z0)
    c010, c110 = g(x0, y1, z0), g(x1, y1, z0)
    c001, c101 = g(x0, y0, z1), g(x1, y0, z1)
    c011, c111 = g(x0, y1, z1), g(x1, y1, z1)

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    y0z0 = vm.lerp(fx, c000, c100)
    y1z0 = vm.lerp(fx, c010, c110)
    y0z1 = vm.lerp(fx, c001, c101)
    y1z1 = vm.lerp(fx, c011, c111)
    z0v = vm.lerp(fy, y0z0, y1z0)
    z1v = vm.lerp(fy, y0z1, y1z1)
    return vm.lerp(fz, z0v, z1v)


def _cell_hash(u: jnp.ndarray) -> jnp.ndarray:
    """sin-dot hash -> pseudo-random offset in [0,1)^3 (src/noise.h:141-145)."""
    rand_v = jnp.stack(
        [
            vm.dot(u, jnp.array([127.1, 311.7, 74.7], u.dtype)),
            vm.dot(u, jnp.array([269.5, 183.3, 246.1], u.dtype)),
            vm.dot(u, jnp.array([113.5, 271.9, 307.7], u.dtype)),
        ],
        axis=-1,
    )
    return vm.fract(jnp.sin(rand_v) * 43758.5453)


def worley_noise(p: jnp.ndarray) -> jnp.ndarray:
    """min squared distance to jittered lattice points over the 27-cell
    neighborhood (src/noise.h:139-168)."""
    floor_p = jnp.floor(p)
    min_dist = jnp.full(p.shape[:-1], jnp.inf, p.dtype)
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            for k in (-1, 0, 1):
                cell = floor_p + jnp.array([i, j, k], p.dtype)
                pos = cell + _cell_hash(cell)
                dist = vm.length(pos - p)
                min_dist = jnp.minimum(min_dist, dist)
    return min_dist * min_dist


def voronoi_noise(p: jnp.ndarray) -> jnp.ndarray:
    """Hash value of the nearest jittered lattice point (src/noise.h:170-201)."""
    floor_p = jnp.floor(p)
    min_dist = jnp.full(p.shape[:-1], jnp.inf, p.dtype)
    color = jnp.zeros(p.shape[:-1], p.dtype)
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            for k in (-1, 0, 1):
                cell = floor_p + jnp.array([i, j, k], p.dtype)
                pos = cell + _cell_hash(cell)
                dist = vm.length(pos - p)
                closer = dist < min_dist
                min_dist = jnp.where(closer, dist, min_dist)
                color = jnp.where(closer, _cell_hash(pos)[..., 0], color)
    return color
