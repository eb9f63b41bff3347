"""Adaptive sampling: per-pixel variance-driven sample allocation.

Beyond-parity extension (the reference renders a fixed spp everywhere,
src/camera.h:163-171): pixels sample in fixed-size chunks until their 95%
per-channel confidence interval falls under a relative tolerance;
converged pixels stop paying. Flat, directly-lit regions converge in the
first rounds while light edges / glass / shadow penumbrae keep sampling —
the total sample budget concentrates where the estimator is actually
noisy.

Static shapes: the device never sees a dynamic shape. Each round the host
compacts the unconverged pixel ids (numpy nonzero), pads them to the next
power of two (so at most log2(n_pix) distinct shapes ever compile), and
calls one jitted chunk-accumulator over that id array. Because every
sample's RNG is keyed by (pixel id, absolute sample index) — the same
contract that makes sharded and checkpointed renders bitwise equal
(models/integrator.render_sample) — a pixel's samples are IDENTICAL no
matter which round, chunk size, or compaction it lands in: with the
tolerance at 0 the adaptive render equals the uniform max_spp render
exactly.

The stopping rule is the standard adaptive-sampling caveat: stopping on a
sample-dependent statistic introduces a (vanishing, O(1/n)) bias; min_spp
bounds it. [Purgathofer 1987-style confidence-interval termination.]
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cpu_ray_tracing_implementation_tpu.models import integrator
from cpu_ray_tracing_implementation_tpu.ops import qmc


@functools.partial(jax.jit, static_argnames=("spp",))
def _accumulate_subset(scene, camera, key, pixel_ids, sample_offset,
                       spp: int):
    """(sum_rgb [n,3], sum_rgb_sq [n,3]) over samples [sample_offset,
    sample_offset + spp) for the given pixel ids — the same per-sample
    stream as integrator.accumulate_samples. Second moments are tracked
    PER CHANNEL: a luminance-only statistic lets chroma-noisy pixels
    (e.g. red/blue emitters of equal luma, or hero-wavelength color
    noise) report a zero CI and stop while still visibly noisy."""
    n = pixel_ids.shape[0]
    qmc_words = qmc.seed_words(key) if camera.qmc else None

    def one_sample(acc, s):
        s_abs = sample_offset + s
        k = jax.random.fold_in(key, s_abs)
        rad = integrator.render_sample(scene, camera, k, pixel_ids,
                                       sample_idx=s_abs,
                                       qmc_words=qmc_words)
        return (acc[0] + rad, acc[1] + rad * rad), None

    zero = (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n, 3), jnp.float32))
    acc, _ = jax.lax.scan(one_sample, zero, jnp.arange(spp))
    return acc


def _accumulate_subset_sharded(scene, camera, key, pixel_ids,
                               sample_offset, spp: int, mesh):
    """_accumulate_subset with the pixel-id axis sharded over ``mesh``.

    Pixel-id keyed RNG makes the moments bitwise the single-device ones
    (the same contract as every other sharded render); rows added to pad
    the id count to a device multiple re-render pixel 0 and are discarded
    by the caller's host-side slice."""
    import functools

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n = pixel_ids.shape[0]
    n_dev = mesh.devices.size
    pad = (-n) % n_dev
    if pad:
        pixel_ids = jnp.concatenate(
            [pixel_ids, jnp.zeros((pad,), pixel_ids.dtype)])

    @functools.partial(jax.jit, static_argnames=("spp_",))
    def run(scene, camera, key, ids, off, spp_: int):
        @functools.partial(
            shard_map, mesh=mesh, check_vma=False,
            in_specs=(P(), P(), P(), P(mesh.axis_names[0]), P()),
            out_specs=(P(mesh.axis_names[0]), P(mesh.axis_names[0])),
        )
        def sh(scene, camera, key, pids, off):
            return _accumulate_subset.__wrapped__(scene, camera, key, pids,
                                                  off, spp_)

        return sh(scene, camera, key, ids, off)

    return run(scene, camera, key, pixel_ids,
               jnp.asarray(sample_offset, jnp.int32), spp)


def _pad_pow2(ids: np.ndarray) -> np.ndarray:
    """Pad to the next power of two (with id 0; rows past the real length
    are discarded host-side) so jit shapes stay from a log-size family."""
    n = len(ids)
    m = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)
    if m == n:
        return ids
    return np.concatenate([ids, np.zeros(m - n, ids.dtype)])


def render_image_adaptive(scene, camera, key, *, rel_tol: float = 0.05,
                          min_spp: int = 8, max_spp: int | None = None,
                          chunk_spp: int = 8, zero_var_spp: int = 32,
                          return_spp_map: bool = False, mesh=None):
    """Adaptive render: [H,W,3] image (and optionally the [H,W] per-pixel
    sample-count map).

    A pixel stops sampling once EVERY channel's 95% CI half-width of the
    mean is below ``rel_tol * (mean + 0.05)`` (the +0.05 keeps near-black
    pixels from demanding unbounded precision). ``rel_tol=0`` disables
    stopping: the result is exactly the uniform ``max_spp`` render.

    ``mesh`` (optional jax.sharding.Mesh): shard each round's unconverged
    pixel batch over the mesh devices — bitwise the single-device adaptive
    render (pixel-id keyed RNG), including the per-pixel spp map.

    ``zero_var_spp``: a pixel whose samples are ALL ZERO so far has a zero
    confidence interval that proves nothing (a dark indirect-only corner
    looks identical to true black until one lucky path lands); such pixels
    may not stop before this count. Pixels with a nonzero constant value
    (e.g. directly-seen emitters) are genuinely converged and exempt.
    """
    max_spp = camera.spp if max_spp is None else max_spp
    min_spp = min(min_spp, max_spp)
    n_pix = camera.width * camera.height

    sum_rgb = np.zeros((n_pix, 3), np.float64)
    sum_rgb2 = np.zeros((n_pix, 3), np.float64)
    counts = np.zeros((n_pix,), np.int64)

    active = np.arange(n_pix, dtype=np.int32)
    done_spp = 0
    while done_spp < max_spp and active.size:
        step = int(min(chunk_spp, max_spp - done_spp))
        padded = _pad_pow2(active)
        if mesh is not None and mesh.devices.size > 1:
            s_rgb, s_rgb2 = _accumulate_subset_sharded(
                scene, camera, key, jnp.asarray(padded), done_spp, step,
                mesh)
        else:
            s_rgb, s_rgb2 = _accumulate_subset(
                scene, camera, key, jnp.asarray(padded), done_spp, step)
        k = active.size
        sum_rgb[active] += np.asarray(s_rgb)[:k]
        sum_rgb2[active] += np.asarray(s_rgb2)[:k]
        counts[active] += step
        done_spp += step

        if done_spp >= min_spp and rel_tol > 0.0 and done_spp < max_spp:
            n = counts[active].astype(np.float64)[:, None]
            mean = sum_rgb[active] / n                    # [k,3]
            var = np.maximum(sum_rgb2[active] / n - mean * mean, 0.0)
            var *= n / np.maximum(n - 1.0, 1.0)  # Bessel correction
            ci = 1.96 * np.sqrt(var / n)
            # a pixel stops only when EVERY channel's CI is inside
            unconverged = (ci > rel_tol * (mean + 0.05)).any(axis=1)
            unsettled = ((sum_rgb[active].sum(axis=1) == 0.0)
                         & (n[:, 0] < zero_var_spp))
            active = active[unconverged | unsettled]

    img = (sum_rgb / np.maximum(counts, 1)[:, None]).astype(np.float32)
    img = img.reshape(camera.height, camera.width, 3)
    if return_spp_map:
        return img, counts.reshape(camera.height, camera.width)
    return img
