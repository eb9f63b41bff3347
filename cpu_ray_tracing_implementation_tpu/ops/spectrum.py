"""Spectral power distributions (SPD) and spectrum -> RGB conversion.

Mirror of the reference's spectral scaffolding (reference src/spectrum.h):
75 bins over 380-750 nm at 5 nm steps, arithmetic over SPDs, the piecewise
linear wavelength -> RGB map (src/spectrum.h:140-200) and intensity-weighted
spectrum -> RGB integration (src/spectrum.h:202-231).

Like the reference — whose ``material::spectrum_scatter`` hooks exist but are
never called by a live material (SURVEY.md §2.1 "scaffolding only") — this is
a standalone, fully-tested utility layer: a spectral batch is just an
[..., NUM_BINS] array, so the machinery composes with the wavefront
integrator whenever a spectral material is added.

Redesign notes: the reference's per-wavelength branching becomes a
precomputed [NUM_BINS, 3] RGB basis (built once, host-side); spectrumToRGB is
then one matmul. Everything is differentiable w.r.t. the SPD values.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

WAVELENGTH_MIN = 380
WAVELENGTH_MAX = 750
WAVELENGTH_STEP = 5
NUM_BINS = (WAVELENGTH_MAX - WAVELENGTH_MIN) // WAVELENGTH_STEP + 1  # 75
GAMMA = 0.80  # display gamma of the wavelength map (src/spectrum.h:138)

WAVELENGTHS = np.arange(WAVELENGTH_MIN, WAVELENGTH_MAX + 1, WAVELENGTH_STEP,
                        dtype=np.float64)


def zeros(batch_shape=()) -> jnp.ndarray:
    """All-zero SPD (the reference's default ctor, src/spectrum.h:43-47)."""
    return jnp.zeros((*batch_shape, NUM_BINS), jnp.float32)


def constant(v: float, batch_shape=()) -> jnp.ndarray:
    return jnp.full((*batch_shape, NUM_BINS), v, jnp.float32)


def line(wavelength: float, intensity: float) -> jnp.ndarray:
    """Single-line SPD (src/spectrum.h:51-56): intensity in the bin holding
    ``wavelength``, 0 elsewhere (no rounding, as in the reference)."""
    idx = int((wavelength - WAVELENGTH_MIN) / WAVELENGTH_STEP)
    return jnp.zeros((NUM_BINS,), jnp.float32).at[idx].set(intensity)


def add_line(spd: jnp.ndarray, wavelength: float, intensity: float) -> jnp.ndarray:
    """spectrum::add (src/spectrum.h:58-62)."""
    idx = int((wavelength - WAVELENGTH_MIN) / WAVELENGTH_STEP)
    return spd.at[..., idx].add(intensity)


def _wavelength_to_rgb_scalar(wl: float) -> np.ndarray:
    """Host-side mirror of wavelengthToRGB (src/spectrum.h:140-200),
    returning byte-scale RGB."""
    if wl < 380.0 or wl > 780.0:
        return np.zeros(3)
    r = g = b = 0.0
    if 380 <= wl < 440:
        r, g, b = -(wl - 440) / 60.0, 0.0, 1.0
    elif 440 <= wl < 490:
        r, g, b = 0.0, (wl - 440) / 50.0, 1.0
    elif 490 <= wl < 510:
        r, g, b = 0.0, 1.0, -(wl - 510) / 20.0
    elif 510 <= wl < 580:
        r, g, b = (wl - 510) / 70.0, 1.0, 0.0
    elif 580 <= wl < 645:
        r, g, b = 1.0, -(wl - 645) / 65.0, 0.0
    elif 645 <= wl < 780:
        r, g, b = 1.0, 0.0, 0.0
    if 380 <= wl < 420:
        factor = 0.3 + 0.7 * (wl - 380) / 40.0
    elif 420 <= wl < 701:
        factor = 1.0
    elif 701 <= wl < 781:
        factor = 0.3 + 0.7 * (780 - wl) / 80.0
    else:
        factor = 0.0

    def chan(c):
        return 0.0 if c == 0.0 else round(255 * (c * factor) ** GAMMA)

    return np.array([chan(r), chan(g), chan(b)], np.float64)


# [NUM_BINS, 3] byte-scale RGB basis, built once. Kept as numpy on
# purpose: a module-level jnp.asarray would initialize the XLA backend at
# import time, which breaks jax.distributed.initialize in multi-host
# workers (it must run before any backend init).
RGB_BASIS = np.stack(
    [_wavelength_to_rgb_scalar(w) for w in WAVELENGTHS]).astype(np.float32)


def wavelength_to_rgb(wavelength) -> jnp.ndarray:
    """Batched piecewise map (src/spectrum.h:140-200), byte-scale [..., 3]."""
    wl = jnp.asarray(wavelength, jnp.float32)
    seg = jnp.stack([
        jnp.where((wl >= 380) & (wl < 440), -(wl - 440) / 60.0,
                  jnp.where((wl >= 510) & (wl < 580), (wl - 510) / 70.0,
                            jnp.where(wl >= 580, 1.0, 0.0))),
        jnp.where((wl >= 440) & (wl < 490), (wl - 440) / 50.0,
                  jnp.where((wl >= 490) & (wl < 580), 1.0,
                            jnp.where((wl >= 580) & (wl < 645),
                                      -(wl - 645) / 65.0, 0.0))),
        jnp.where(wl < 490, jnp.where(wl >= 380, 1.0, 0.0),
                  jnp.where(wl < 510, -(wl - 510) / 20.0, 0.0)),
    ], axis=-1)
    seg = jnp.where(((wl < 380) | (wl > 780))[..., None], 0.0, seg)
    factor = jnp.where((wl >= 380) & (wl < 420), 0.3 + 0.7 * (wl - 380) / 40.0,
                       jnp.where((wl >= 420) & (wl < 701), 1.0,
                                 jnp.where((wl >= 701) & (wl < 781),
                                           0.3 + 0.7 * (780 - wl) / 80.0, 0.0)))
    scaled = jnp.where(seg == 0.0, 0.0,
                       jnp.round(255.0 * jnp.power(
                           jnp.maximum(seg * factor[..., None], 0.0), GAMMA)))
    return scaled


def to_rgb(spd: jnp.ndarray) -> jnp.ndarray:
    """Intensity-weighted RGB of an [..., NUM_BINS] SPD
    (spectrumToRGB, src/spectrum.h:202-231): one matmul against the
    precomputed basis, normalized by total intensity. Byte-scale [..., 3]."""
    total = jnp.sum(spd, axis=-1, keepdims=True)
    rgb = jnp.matmul(spd, RGB_BASIS, precision="highest")
    return jnp.where(total > 0, rgb / jnp.maximum(total, 1e-20), 0.0)


def to_linear_rgb(spd: jnp.ndarray) -> jnp.ndarray:
    """[0,1]-scale variant for feeding the film pipeline."""
    return to_rgb(spd) / 255.0


# -------------------------------------------- hero-wavelength dispersion
# The live spectral render mode (Scene.has_dispersion): each (pixel,
# sample) path carries ONE wavelength drawn uniformly from
# [WAVELENGTH_MIN, WAVELENGTH_MAX]; dielectric IOR shifts by a Cauchy term
# and the path's RGB radiance is weighted by the normalized wavelength
# response below. The reference's spectrum.h scaffolding has no render
# path at all — this makes the layer live.

# E_[lambda ~ U(380,750)] of the linear RGB response, per channel: weights
# divide by this so a dispersion-free path stays white in expectation.
_WEIGHT_NORM = np.maximum(
    np.mean([_wavelength_to_rgb_scalar(w)
             for w in np.arange(WAVELENGTH_MIN, WAVELENGTH_MAX + 0.25, 0.5)],
            axis=0) / 255.0,
    1e-6)
# kept as numpy on purpose: a module-level jnp.asarray would initialize
# the XLA backend at import time, which breaks jax.distributed.initialize
# in multi-host workers (it must run before any backend init).
SPECTRAL_WEIGHT_NORM = np.asarray(_WEIGHT_NORM, np.float32)


def spectral_path_weight(wl) -> jnp.ndarray:
    """[..., 3] RGB weight of a hero-wavelength path; mean over uniform
    wavelengths is (1,1,1) per channel."""
    return (wavelength_to_rgb(wl) / 255.0) / SPECTRAL_WEIGHT_NORM


def cauchy_ior_shift(wl_nm) -> jnp.ndarray:
    """(1/lambda_um^2 - 1/0.589^2): multiply by a material's Cauchy B to
    get its IOR offset at ``wl_nm`` (zero at the 589 nm sodium line, where
    Materials.ior is specified)."""
    lam_um = jnp.asarray(wl_nm, jnp.float32) * 1e-3
    return 1.0 / (lam_um * lam_um) - 1.0 / (0.589 * 0.589)
