"""Edge-avoiding à-trous wavelet denoiser, guided by AOVs.

Beyond-parity extension (the reference ships raw Monte-Carlo output only):
a jit-compiled implementation of the à-trous wavelet filter with
edge-stopping functions [Dammertz et al. 2010, "Edge-Avoiding À-Trous
Wavelet Transform for fast Global Illumination Filtering"] — the same
filter family SVGF-style real-time denoisers build on.

Shape: each iteration is 25 statically-unrolled edge-clamped shifts of
the whole [H,W,3] image (pure elementwise work, XLA fuses the weight
products); no gathers, no data-dependent shapes.

Guidance comes from models/aov.py buffers:
- normal: cosine^sigma_normal edge-stop (SVGF's w_n)
- depth: relative-difference edge-stop (scale-free)
- color: luminance-difference edge-stop, sigma halved per iteration so
  later (wider) taps only cross genuinely similar regions
- albedo: demodulated before filtering and re-applied after, so texture
  detail is preserved exactly rather than smoothed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# 1-D B3-spline taps; the 5x5 kernel is their outer product
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shift(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """x[y+dy, x+dx] with edge clamping, same shape."""
    h, w = x.shape[0], x.shape[1]
    ady, adx = abs(dy), abs(dx)
    pad = ((ady, ady), (adx, adx)) + ((0, 0),) * (x.ndim - 2)
    xp = jnp.pad(x, pad, mode="edge")
    return xp[ady + dy:ady + dy + h, adx + dx:adx + dx + w]


def _luminance(c: jnp.ndarray) -> jnp.ndarray:
    return (0.2126 * c[..., 0] + 0.7152 * c[..., 1]
            + 0.0722 * c[..., 2])[..., None]


def _local_std(luma: jnp.ndarray) -> jnp.ndarray:
    """3x3 box-window standard deviation of luminance — the per-pixel
    noise estimate that scales the color edge-stop (the role SVGF's
    filtered variance buffer plays)."""
    s = jnp.zeros_like(luma)
    s2 = jnp.zeros_like(luma)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            q = _shift(luma, dy, dx)
            s = s + q
            s2 = s2 + q * q
    mu = s / 9.0
    return jnp.sqrt(jnp.maximum(s2 / 9.0 - mu * mu, 0.0))


def _despike(img: jnp.ndarray) -> jnp.ndarray:
    """Firefly suppression: a pixel whose luminance exceeds its 8
    neighbors' mean + 3 std collapses to the neighbor mean (color
    direction preserved). Isolated bright speckles otherwise survive the
    wavelet pass — they inflate the local variance estimate enough to
    widen their own color gate and ride through every iteration."""
    luma = _luminance(img)
    s = jnp.zeros_like(luma)
    s2 = jnp.zeros_like(luma)
    csum = jnp.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            q = _shift(luma, dy, dx)
            s = s + q
            s2 = s2 + q * q
            csum = csum + _shift(img, dy, dx)
    mu = s / 8.0
    sd = jnp.sqrt(jnp.maximum(s2 / 8.0 - mu * mu, 0.0))
    spike = luma > mu + 3.0 * sd + 1e-4
    # keep the pixel's chroma, rescale its energy to the neighbor level
    scale = jnp.where(spike, (mu + sd) / jnp.maximum(luma, 1e-8), 1.0)
    return jnp.where(spike, img * scale, img)


@functools.partial(jax.jit, static_argnames=("iterations", "despike"))
def denoise(img: jnp.ndarray, aovs: dict, *, iterations: int = 4,
            sigma_color: float = 3.0, sigma_normal: float = 64.0,
            sigma_depth: float = 0.15, despike: bool = True
            ) -> jnp.ndarray:
    """Denoised [H,W,3] linear-radiance image.

    ``img``: the beauty render (models/integrator.render_image output).
    ``aovs``: dict from models/aov.render_aovs on the same scene/camera.
    ``sigma_color`` is in units of the LOCAL noise level (3x3 luminance
    std), so the color gate adapts: wide where the estimator is noisy,
    tight where it has converged — a converged image passes through
    nearly unchanged.
    """
    normal = aovs["normal"]
    depth = aovs["depth"]
    coverage = aovs["coverage"]

    # demodulate albedo (uncovered pixels — pure background — keep raw
    # radiance: their albedo buffer is 0)
    alb = jnp.where(coverage > 0.5,
                    jnp.maximum(aovs["albedo"], 0.02), 1.0)
    out = img / alb
    if despike:
        out = _despike(out)

    for i in range(iterations):
        step = 1 << i
        sig_c = sigma_color / (1 << i)  # tighter color gate for wide taps
        luma = _luminance(out)
        gate = sig_c * (_local_std(luma) + 1e-3)
        acc = jnp.zeros_like(out)
        wsum = jnp.zeros(out.shape[:2] + (1,), out.dtype)
        for ky, wy in zip((-2, -1, 0, 1, 2), _B3):
            for kx, wx in zip((-2, -1, 0, 1, 2), _B3):
                dy, dx = ky * step, kx * step
                q = _shift(out, dy, dx)
                n_q = _shift(normal, dy, dx)
                z_q = _shift(depth, dy, dx)
                c_q = _shift(coverage, dy, dx)
                l_q = _shift(luma, dy, dx)

                w_n = jnp.maximum(jnp.sum(normal * n_q, -1, keepdims=True),
                                  0.0) ** sigma_normal
                # uncovered pixels carry a zero normal; background-to-
                # background pairs must still average (color gate rules)
                w_n = jnp.minimum(w_n + (1.0 - coverage) * (1.0 - c_q), 1.0)
                # scale-free relative depth difference; hit/miss pairs
                # (depth 0 vs >0) get near-zero weight via coverage below
                dz = jnp.abs(depth - z_q) / (jnp.maximum(depth, z_q) + 1e-4)
                w_z = jnp.exp(-(dz / sigma_depth) ** 2)
                w_c = jnp.exp(-((luma - l_q) / gate) ** 2)
                w_cov = jnp.exp(-8.0 * jnp.abs(coverage - c_q))
                w = (wy * wx) * w_n * w_z * w_c * w_cov
                acc = acc + w * q
                wsum = wsum + w
        out = acc / jnp.maximum(wsum, 1e-8)

    return out * alb
