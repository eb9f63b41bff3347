"""Core 3-vector math on [..., 3] arrays.

Batched replacement for the reference's scalar ``vec3``/``onb`` types
(reference: src/vec3.h, src/onb.h, src/utility.h:70-87): everything is a pure
function over batched float32 arrays so XLA can fuse it into the surrounding
integrator. No classes, no scalars.
"""

from __future__ import annotations

import jax.numpy as jnp

EPS = 1e-12


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis; [..., 3] x [..., 3] -> [...]."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length_sq(a: jnp.ndarray) -> jnp.ndarray:
    return dot(a, a)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length_sq(a))


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    """Unit vector; safe at zero (returns ~0 instead of NaN)."""
    return a / jnp.sqrt(length_sq(a) + EPS)[..., None]


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection (reference: src/utility.h:70)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction of unit vector v about unit normal n.

    Matches reference src/utility.h:71-76 (fabs under the sqrt), with an
    epsilon floor so the gradient stays finite at grazing incidence — this
    runs on ALL lanes (masked dispatch), so a NaN d/dx sqrt(0) here would
    leak into every material's gradients through the lane select.
    ``eta`` is the ratio n_in/n_out, shape [...].
    """
    cos_theta = jnp.minimum(dot(-v, n), 1.0)
    r_out_perp = eta[..., None] * (v + cos_theta[..., None] * n)
    k = jnp.maximum(jnp.abs(1.0 - length_sq(r_out_perp)), 1e-12)
    return r_out_perp - jnp.sqrt(k)[..., None] * n


def onb_from_normal(normal: jnp.ndarray):
    """Orthonormal basis (x, y, z) with y = unit(normal).

    Matches the reference's branch on |y.x| > 0.9 (src/onb.h:19-28) as a
    vectorized select so every lane computes both candidates.
    Returns three [..., 3] arrays.
    """
    y = normalize(normal)
    a = jnp.where(
        (jnp.abs(y[..., 0]) > 0.9)[..., None],
        jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], y.dtype), y.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], y.dtype), y.shape),
    )
    z = normalize(cross(y, a))
    x = cross(y, z)
    return x, y, z


def onb_transform(local: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """Local (lx, ly, lz) -> world, with y the normal axis (src/onb.h frame::transform)."""
    return (
        local[..., 0:1] * x + local[..., 1:2] * y + local[..., 2:3] * z
    )


def lerp(t: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(1-t)*a + t*b (src/utility.h:84-85). ``t`` broadcasts against a/b."""
    return (1.0 - t) * a + t * b


def smoothstep(lo, hi, x):
    t = jnp.clip((x - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def fract(x: jnp.ndarray) -> jnp.ndarray:
    return x - jnp.floor(x)
