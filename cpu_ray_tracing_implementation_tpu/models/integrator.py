"""Wavefront path-tracing integrator.

Batched re-design of the reference's recursive ``camera::ray_color``
(src/camera.h:193-241): recursion over bounce depth becomes a fixed-length
``lax.scan`` carrying (origin, direction, time, throughput, radiance, alive)
for a whole ray batch; data-dependent material branching becomes masked-lane
selects (ops/materials.py); the shared-state RNG becomes counter-based
``jax.random`` keys folded per (sample, bounce).

Estimator identity with the reference: at each segment the recursive form

    L = emitted + weight * L_next          (src/camera.h:210-240)

unrolls to radiance += throughput * emitted; throughput *= weight, with a
miss adding throughput * background (src/camera.h:180-190) and terminating
the lane, and the depth budget expiring to black (src/camera.h:194-195).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cpu_ray_tracing_implementation_tpu.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu.ops import fastrng
from cpu_ray_tracing_implementation_tpu.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu.ops import materials as mat_ops
from cpu_ray_tracing_implementation_tpu.ops import qmc
from cpu_ray_tracing_implementation_tpu.ops import spectrum
from cpu_ray_tracing_implementation_tpu.ops.textures import eval_texture
from cpu_ray_tracing_implementation_tpu.ops import vecmath as vm

T_MIN = 1e-3  # shadow-acne bias, interval(0.001, inf) (src/camera.h:198)


def _replay_mod():
    from cpu_ray_tracing_implementation_tpu.ops import replay

    return replay


def background_color(scene, dirs: jnp.ndarray) -> jnp.ndarray:
    """Environment lookup on miss (src/camera.h:180-190).

    The reference intersects a unit sphere at the ray origin just to get
    spherical UVs of the direction; that collapses to a direct
    direction -> equirect UV transform (SURVEY.md appendix item 10).
    """
    if scene.background < 0:
        return jnp.zeros(dirs.shape, dirs.dtype)
    unit_d = vm.normalize(dirs)
    u, v = isect.sphere_uv(unit_d)
    tex_id = jnp.full(u.shape, scene.background, jnp.int32)
    return eval_texture(scene, tex_id, u, v, unit_d)


def _rng_impl() -> str:
    """Path-sampling RNG (env CRT_RNG, read at trace time):
    'fast' (default) = counter-hash stream (ops/fastrng.py, ~10x cheaper —
    raygen+RNG measured at ~44% of forward under threefry, BASELINE.md
    Roofline); 'threefry' = per-lane jax.random fold chain (round-1 stream;
    kept for replay/regression comparisons)."""
    import os

    return os.environ.get("CRT_RNG", "fast")


def _per_ray_uniforms(key, ray_ids: jnp.ndarray, nslot: int) -> jnp.ndarray:
    """[R, nslot] uniforms from counter-based per-ray keys.

    Keying by *ray id* (not batch position) makes the stream invariant to
    how the ray batch is split across devices or steps — the property that
    lets sharded and single-chip renders match bitwise (replacing the
    reference's shared std::rand() stream, src/utility.h:20). Both impls
    keep that contract; ``fast`` derives two seed words from ``key`` (one
    scalar threefry, amortized over the batch) and hashes (seed, id, slot).
    """
    if _rng_impl() == "fast":
        w = jax.random.bits(key, (2,), jnp.uint32)
        return fastrng.uniforms(w[0], w[1], ray_ids, nslot)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, ray_ids)
    return jax.vmap(lambda k: jax.random.uniform(k, (nslot,)))(keys)


def _shade_step(scene, org, dirs, time, throughput, radiance, alive, u,
                ior_shift=None, rr_u=None, emis_w=None, nee_shadow=True,
                replay=False):
    """One path segment for every lane: intersect, add miss-background /
    emission, scatter. The shared body of the classic scan integrator and
    the path-regeneration wavefront (estimator: src/camera.h:193-241).

    ``ior_shift``: per-path Cauchy dispersion term (spectral mode; None for
    the RGB render).
    ``rr_u``: optional [R] uniforms enabling Russian-roulette termination
    for this segment (camera.rr_depth): survivors of probability
    p = clamp(max channel of throughput, 0.05, 1) rescale by 1/p —
    unbiased, cuts the deep-path tail. The wavefront integrator turns
    freed lanes into new paths; the classic scan only zeroes them.
    ``emis_w``: [R] carried power-heuristic emission weight — enables
    next-event estimation (camera.nee): emission and env radiance met by
    BSDF-sampled rays are weighted by it, an explicit shadow ray collects
    direct lighting, and the return gains the next segment's emis_w.
    None = the reference-parity one-sample-mixture estimator.
    ``nee_shadow``: scalar bool — the shadow ray estimates the NEXT
    vertex's emission, so the FINAL segment must skip it (the classic
    depth budget never collects light past vertex max_depth,
    src/camera.h:194-195; keeping it would brighten NEE renders ~10%).
    ``replay``: compact-residual intersection for the gradient path
    (ops/replay.py) — saved winner ids + O(R) differentiable replay."""
    nee = emis_w is not None
    isect_fn = _replay_mod().intersect_replay if replay \
        else isect.intersect_brute
    hit = isect_fn(scene, org, dirs, time, T_MIN,
                   u[:, mat_ops.SLOT_VOLUME0:], active=alive)

    # miss -> background, lane terminates. Under NEE the env light (when it
    # is in the light mixture) is also reached by shadow rays, so the
    # BSDF-path's env pickup carries emis_w; directions no light sample can
    # produce have light_pdf = 0 -> emis_w = 1, so plain backgrounds are
    # untouched.
    bg = background_color(scene, dirs)
    if nee:
        bg = bg * emis_w[:, None]
    miss = alive & ~hit.valid
    radiance = radiance + jnp.where(miss[:, None], throughput * bg, 0.0)

    # emission at the hit (front-face diffuse_light); the material-row
    # gathers + texture eval are shared with the scatter path (mat_rows)
    lit = alive & hit.valid
    pre = mat_ops.mat_rows(scene, hit)
    emit = mat_ops.emitted(scene, hit, pre=pre)
    if nee:
        emit = emit * emis_w[:, None]
    radiance = radiance + jnp.where(lit[:, None], throughput * emit, 0.0)

    # scatter
    if nee:
        (new_dir, weight, continues, emis_w_next, nee_dir,
         nee_w) = mat_ops.scatter_nee(scene, hit, dirs, u,
                                      ior_shift=ior_shift, pre=pre)
        if scene.has_lights:
            # Shadow ray: radiance arriving from the sampled light direction.
            # Occluders are non-emissive so `emitted` of the nearest hit IS
            # visibility x L_e; a volume boundary on the way scatters the ray
            # with the analytic probability (a fresh Weyl-shifted uniform
            # decorrelates it from the main segment's volume draw), which
            # estimates the transmittance unbiasedly.
            sh_active = alive & hit.valid & nee_shadow
            u_vol_sh = jnp.mod(u[:, mat_ops.SLOT_VOLUME0:] + 0.61803398875,
                               1.0)
            sh = isect_fn(scene, hit.p, nee_dir, time, T_MIN,
                          u_vol_sh, active=sh_active)
            sh_le = mat_ops.emitted(scene, sh)
            if scene.has_env_light:
                sh_le = sh_le + jnp.where(
                    sh.valid[:, None], 0.0, background_color(scene, nee_dir))
            radiance = radiance + jnp.where(
                sh_active[:, None], throughput * nee_w * sh_le, 0.0)
    else:
        new_dir, weight, continues = mat_ops.scatter(scene, hit, dirs, u,
                                                     ior_shift=ior_shift,
                                                     pre=pre)
    alive = lit & continues
    throughput = jnp.where(alive[:, None], throughput * weight, 0.0)
    if rr_u is not None:
        # lanes with rr_u < 0 are exempt this segment (bounce < rr_depth)
        apply = rr_u >= 0.0
        p = jnp.where(apply,
                      jnp.clip(jnp.max(throughput, axis=-1), 0.05, 1.0),
                      1.0)
        survive = rr_u < p
        throughput = jnp.where((alive & survive)[:, None],
                               throughput / p[:, None], 0.0)
        alive = alive & survive
    org = jnp.where(alive[:, None], hit.p, org)
    dirs = jnp.where(alive[:, None], new_dir, dirs)
    if nee:
        return org, dirs, time, throughput, radiance, alive, emis_w_next
    return org, dirs, time, throughput, radiance, alive


def render_rays(scene, org, dirs, time, key, max_depth: int,
                ray_ids=None, uniforms=None, unroll: int = 1,
                wavelength=None, qmc_words=None, sample_idx=None,
                rr_depth: int = 0, nee: bool = False,
                replay_isect: bool = False) -> jnp.ndarray:
    """Radiance [R,3] for a batch of rays.

    ``ray_ids``: per-ray integer ids used to fold the RNG key (defaults to
    batch position; pass pixel ids for shard-invariant streams).
    ``uniforms``: optional precomputed [max_depth, R, NSLOT+V] block (used by
    the parity tests to replay the exact stream into a NumPy oracle);
    normally drawn per bounce from ``key``.
    ``unroll``: bounce-scan unroll factor (see UNROLL below).
    ``wavelength``: [R] hero wavelength (nm) per path — spectral mode
    (Scene.has_dispersion): dielectrics refract at the Cauchy-shifted IOR
    and the returned radiance is weighted by the normalized
    wavelength->RGB response (spectrum.spectral_path_weight).
    ``qmc_words`` (+ ``sample_idx``): Owen-Sobol mode (camera.qmc):
    bounce uniforms come from the per-(pixel, pair) scrambled
    (0,2)-sequence at ``sample_idx`` instead of the hash PRNG.
    ``rr_depth``: Russian roulette from that bounce on (camera.rr_depth;
    0 = off). The RR stream folds the key with 0x5252 so all existing
    slot streams are untouched.
    ``nee``: next-event estimation (camera.nee) — split light/BSDF samples
    with power-heuristic MIS instead of the reference's 50/50 one-sample
    mixture; same uniform slots, lower variance, one extra (shadow)
    intersect per diffuse bounce.
    ``replay_isect``: compact-residual intersection for gradient callers
    (ops/replay.py) — pair with the save_isect_policy checkpoint policy.
    """
    n_rays = org.shape[0]
    n_vol = scene.n_volumes
    nslot = mat_ops.NSLOT + n_vol
    if ray_ids is None:
        ray_ids = jnp.arange(n_rays, dtype=jnp.int32)
    if scene.world_offset is not None:
        # recentered scene (Scene.world_offset): trace in the shifted frame;
        # position-based textures add the offset back (ops/textures.py)
        org = org - scene.world_offset[None, :]

    ior_shift = None
    if wavelength is not None:
        ior_shift = spectrum.cauchy_ior_shift(wavelength)

    if qmc_words is not None:
        b_groups, b_dims, b_ngroups = qmc.bounce_layout(nslot)
    if rr_depth:
        if uniforms is not None:
            raise ValueError("rr_depth is incompatible with replayed "
                             "uniforms (no bounce index available)")
        k_rr = jax.random.fold_in(key, 0x5252)
    if nee and uniforms is not None:
        raise ValueError("nee is incompatible with replayed uniforms "
                         "(no bounce index to gate the final-segment "
                         "shadow ray)")

    def bounce(carry, inputs):
        org, dirs, time, throughput, radiance, alive = carry[:6]
        emis_w = carry[6] if nee else None
        if uniforms is not None:
            u = inputs
        elif qmc_words is not None:
            bounce_idx = inputs
            u = qmc.uniforms(qmc_words, ray_ids, sample_idx,
                             qmc.N_CAM_GROUPS + bounce_idx * b_ngroups,
                             b_groups, b_dims)
        else:
            bounce_idx = inputs
            u = _per_ray_uniforms(jax.random.fold_in(key, bounce_idx), ray_ids, nslot)
        rr_u = None
        if rr_depth:
            u_rr = _per_ray_uniforms(jax.random.fold_in(k_rr, bounce_idx),
                                     ray_ids, 1)[:, 0]
            rr_u = jnp.where(bounce_idx >= rr_depth, u_rr, -1.0)
        # The shadow ray estimates the NEXT vertex's emission; the final
        # segment must skip it or direct light is collected one vertex past
        # the classic depth budget (src/camera.h:194-195) — measured +5.8%
        # brightening when kept (VERDICT round 2, weak 1).
        nee_shadow = bounce_idx < max_depth - 1 if nee else True
        return _shade_step(scene, org, dirs, time, throughput, radiance,
                           alive, u, ior_shift=ior_shift, rr_u=rr_u,
                           emis_w=emis_w, nee_shadow=nee_shadow,
                           replay=replay_isect), None

    init = (
        org, dirs, time,
        jnp.ones((n_rays, 3), org.dtype),
        jnp.zeros((n_rays, 3), org.dtype),
        jnp.ones((n_rays,), bool),
    )
    if nee:
        init = init + (jnp.ones((n_rays,), jnp.float32),)
    xs = jnp.arange(max_depth) if uniforms is None else uniforms
    out_carry, _ = jax.lax.scan(bounce, init, xs, unroll=unroll)
    radiance = out_carry[4]
    if wavelength is not None:
        # radiance is linear in initial throughput, so weighting after the
        # scan == starting the path at throughput = weight
        radiance = radiance * spectrum.spectral_path_weight(wavelength)
    return radiance


# UNROLL: renders unroll the bounce scan (factor 8) and the sample scan
# (factor 2) — scan semantics (and therefore the sampled streams) are
# unchanged, but XLA fuses across iterations instead of paying the
# while-loop per-iteration overhead: slope-measured +22% forward and
# +30% fwd+bwd on the Cornell bench workload on the previous accelerator
# (the factors' re-check on the card is ROADMAP A4). Gradients default to
# the same factors. Override with CRT_UNROLL="bounces,spp" (CRT_UNROLL=1,1
# turns unrolling off if a compiler fails on grad-of-unrolled-scan).
def _default_unroll() -> tuple:
    import os

    v = os.environ.get("CRT_UNROLL", "8,2")
    b, s = v.split(",")
    return max(int(b), 1), max(int(s), 1)


def render_sample(scene, camera, key, pixel_ids, unroll: int = 1,
                  sample_idx=None, qmc_words=None,
                  replay_isect: bool = False) -> jnp.ndarray:
    """One sample of every pixel in ``pixel_ids``: raygen + integrate.

    All randomness is keyed by pixel id, so any partition of the pixel set
    (tiles across chips, chunks across steps) produces identical samples.
    ``sample_idx``: absolute sample index; enables stratified pixel jitter
    when camera.stratify is set (camera.stratify_pixel_jitter).
    ``qmc_words``: [2] session seed words (qmc.seed_words of the BASE
    render key, not the per-sample fold) — required when camera.qmc is
    set, along with ``sample_idx``.
    """
    k_cam, k_path = jax.random.split(key)
    if camera.qmc:
        if qmc_words is None or sample_idx is None:
            raise ValueError("camera.qmc render needs qmc_words + "
                             "sample_idx (see qmc.seed_words)")
        u_cam = qmc.uniforms(qmc_words, pixel_ids, sample_idx, 0,
                             qmc.CAM_GROUP, qmc.CAM_DIM)
        # Sobol pixel jitter is already stratified; camera.stratify's
        # explicit grid would break the (0,2) progression — skip it.
    else:
        u_cam = _per_ray_uniforms(k_cam, pixel_ids, cam_mod.N_CAM_SLOTS)
        u_cam = cam_mod.stratify_pixel_jitter(camera, u_cam, sample_idx)
    org, dirs, time = cam_mod.generate_rays(camera, pixel_ids, u_cam)
    wavelength = None
    if scene.has_dispersion:
        # hero wavelength per (pixel, sample) path; a derived key keeps the
        # RGB path's (k_cam, k_path) streams untouched when dispersion is off
        u_wl = _per_ray_uniforms(jax.random.fold_in(key, 0x5ec7),
                                 pixel_ids, 1)[:, 0]
        wavelength = (spectrum.WAVELENGTH_MIN
                      + u_wl * (spectrum.WAVELENGTH_MAX
                                - spectrum.WAVELENGTH_MIN))
    rad = render_rays(scene, org, dirs, time, k_path, camera.max_depth,
                      ray_ids=pixel_ids, unroll=unroll,
                      wavelength=wavelength,
                      qmc_words=qmc_words if camera.qmc else None,
                      sample_idx=sample_idx, rr_depth=camera.rr_depth,
                      nee=camera.nee, replay_isect=replay_isect)
    if camera.clamp > 0.0:
        rad = jnp.minimum(rad, camera.clamp)  # firefly clamp (camera.py)
    return rad


def scan_batch_pixels(scene) -> int | None:
    """Auto pixel-batch size for the classic scan on this scene (None =
    whole frame at once). Same batch-coupling effect as wavefront_lanes:
    on PER-RAY-routed scenes the select phases / sweep slots run to the
    worst ray in the batch, so smaller batches early-exit sooner (8192
    was set on the previous accelerator; its re-check on the card is
    ROADMAP A4). Dense and packet-routed scenes keep the full frame.
    Override: CRT_SCAN_TILE=<n|full>."""
    import os

    v = os.environ.get("CRT_SCAN_TILE")
    if v:
        return None if v == "full" else int(v)
    return 8192 if _perray_routed(scene) else None


@functools.partial(jax.jit,
                   static_argnames=("spp", "unroll", "replay_isect",
                                    "batch_pixels"))
def accumulate_samples_subset(scene, camera, key, pixel_ids, sample_offset,
                              spp: int, unroll: tuple = (1, 1),
                              replay_isect: bool = False,
                              batch_pixels: int | None = None) -> jnp.ndarray:
    """Radiance SUM over the sample range for an arbitrary pixel-id
    subset [N,3] — the building block of the full-frame and tiled renders
    (pixel-id keyed RNG makes any pixel partition reproduce the full-frame
    samples).

    ``replay_isect`` (gradient callers): intersection saves one packed
    winner id per lane-bounce (4 bytes) and the remat backward replays
    that single primitive in O(R) instead of recomputing + transposing
    the O(R*N) sweep — ops/replay.py.

    ``batch_pixels`` (STATIC; see scan_batch_pixels): process the pixel
    set in fixed-size batches INSIDE the jit — one scan over
    (sample, batch) steps instead of (sample) steps over the whole frame.
    Pixel-id keyed RNG makes the result bitwise independent of the
    batching; on per-ray-routed scenes smaller batches cut the
    worst-ray coupling of the traversal loops. The remat boundary moves
    to (sample, batch), which only SHRINKS saved residuals."""
    qmc_words = qmc.seed_words(key) if camera.qmc else None
    # remat per sample (per batch-sample under batch_pixels): the backward
    # recomputes each step instead of storing spp x depth of [R,...]
    # residuals — the standard jax.checkpoint FLOPs-for-HBM trade; under
    # replay_isect the winner ids are the one named residual saved through
    policy = _replay_mod().save_isect_policy() if replay_isect else None

    n = pixel_ids.shape[0]
    if batch_pixels is None or batch_pixels >= n:
        sample_fn = jax.checkpoint(
            lambda k, s_abs: render_sample(scene, camera, k, pixel_ids,
                                           unroll=unroll[0], sample_idx=s_abs,
                                           qmc_words=qmc_words,
                                           replay_isect=replay_isect),
            policy=policy)

        def one_sample(accum, s):
            s_abs = sample_offset + s
            k = jax.random.fold_in(key, s_abs)
            return accum + sample_fn(k, s_abs), None

        zero = jnp.zeros((n, 3), jnp.float32)
        accum, _ = jax.lax.scan(one_sample, zero, jnp.arange(spp),
                                unroll=unroll[1])
        return accum

    T = -(-n // batch_pixels)
    pad = T * batch_pixels - n
    ids2 = jnp.concatenate(
        [pixel_ids, jnp.zeros((pad,), pixel_ids.dtype)]).reshape(
            T, batch_pixels)  # pad rows re-render pixel 0; sliced off below

    sample_fn = jax.checkpoint(
        lambda k, s_abs, ids: render_sample(scene, camera, k, ids,
                                            unroll=unroll[0],
                                            sample_idx=s_abs,
                                            qmc_words=qmc_words,
                                            replay_isect=replay_isect),
        policy=policy)

    def one_step(accum, st):
        s, t = st
        s_abs = sample_offset + s
        k = jax.random.fold_in(key, s_abs)
        ids = ids2[t]
        return accum.at[t].add(sample_fn(k, s_abs, ids)), None

    steps = (jnp.repeat(jnp.arange(spp), T), jnp.tile(jnp.arange(T), spp))
    zero = jnp.zeros((T, batch_pixels, 3), jnp.float32)
    accum, _ = jax.lax.scan(one_step, zero, steps, unroll=unroll[1])
    return accum.reshape(T * batch_pixels, 3)[:n]


@functools.partial(jax.jit,
                   static_argnames=("spp", "unroll", "replay_isect",
                                    "batch_pixels"))
def accumulate_samples(scene, camera, key, sample_offset, spp: int,
                       unroll: tuple = (1, 1),
                       replay_isect: bool = False,
                       batch_pixels: int | None = None) -> jnp.ndarray:
    """Radiance SUM over samples [sample_offset, sample_offset+spp) for all
    pixels, flat [H*W, 3]. Sample index (not position in this batch) keys the
    RNG, so any partition of the sample range — across checkpoint chunks or
    across chips — accumulates to the identical image.

    ``unroll``: (bounce, spp) scan unroll factors — (1, 1) when this is
    differentiated (see UNROLL note above).
    """
    n_pix = camera.width * camera.height
    pixel_ids = jnp.arange(n_pix, dtype=jnp.int32)
    return accumulate_samples_subset(scene, camera, key, pixel_ids,
                                     sample_offset, spp, unroll=unroll,
                                     replay_isect=replay_isect,
                                     batch_pixels=batch_pixels)


def _lane_uniforms(keys, n: int) -> jnp.ndarray:
    """[R, n] uniforms from per-lane keys."""
    return jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)


def _perray_routed(scene) -> bool:
    """True when intersect_brute routes this scene to the per-ray
    visit-list accelerator (ops/perray.py) — the batch-coupled path the
    round-5 pool/batch sizing targets."""
    mode = isect.accel_mode()
    n_chunks = 0
    for ch in (scene.sphere_chunks, scene.quad_chunks, scene.tri_chunks):
        if ch is not None:
            n_chunks = max(n_chunks, int(ch.mat.shape[0]))
    return mode == "ray" or (mode == "auto"
                             and n_chunks >= isect.RAY_MIN_CHUNKS)


def wavefront_lanes(scene, L: int) -> int | None:
    """Auto lane-pool size for the wavefront on this scene (None = L).

    On PER-RAY-routed scenes the exactness machinery is batch-coupled —
    every select phase and sweep slot runs until the WORST ray in the pool
    is satisfied, so a smaller pool early-exits sooner. Packet-routed
    scenes want the full pool (coherent tiles amortize shared chunk
    loads). The 8192 pool was set on the previous accelerator; its re-check
    on the card is ROADMAP A4. Pools <= L keep the image BITWISE identical to
    pool == L: path ids issue in order, so at most one sample of any
    pixel is in flight and per-pixel flushes stay in sample order.
    Override: CRT_WF_LANES=<n|full>."""
    import os

    v = os.environ.get("CRT_WF_LANES")
    if v:
        return None if v == "full" else min(int(v), L)
    return min(8192, L) if _perray_routed(scene) else None


@functools.partial(jax.jit, static_argnames=("spp", "lanes"))
def render_wavefront(scene, camera, key, spp: int,
                     pixel_ids: jnp.ndarray | None = None,
                     lanes: int | None = None,
                     sample_offset=0) -> jnp.ndarray:
    """Path-regeneration wavefront render: radiance SUM [H*W, 3].

    ``sample_offset`` (traced scalar — spp-chunked callers do not pay a
    recompile per chunk): render samples [offset, offset + spp) —
    the same absolute-sample-index RNG keying as accumulate_samples, so
    spp-chunked accumulation (utils/checkpoint.py) through the wavefront
    sums to the identical sample set as one uninterrupted render.

    ``pixel_ids`` (optional [L] int32 GLOBAL pixel ids): restrict the lane
    pool to an arbitrary pixel subset — the sum comes back [L, 3] in subset
    order. All RNG is keyed by the global (pixel, sample) pair, so any
    partition of the pixel set (shards across chips, tiles across
    dispatches) reproduces the full-frame paths bitwise — the same
    contract as accumulate_samples_subset on the classic scan.

    The classic integrator (render_image) runs every lane for max_depth
    bounces even after it dies — at depth 8 most lanes are dead after 3-4
    (SURVEY.md §8 known gap). Here a fixed pool of n_pix lanes is kept
    full: the moment a path terminates, its lane flushes radiance into the
    image and starts the next (pixel, sample) path, so total work is the
    ACTUAL number of path segments (+ one tail drain).

    RNG parity: every path reconstructs exactly the classic stream — key
    fold by sample -> split into (camera, path) keys -> fold by bounce ->
    fold by pixel (see render_sample/_per_ray_uniforms) — so each path's
    radiance is bitwise the classic integrator's; only the image summation
    order differs (allclose, not bitwise). Forward-only: the loop is a
    ``lax.while_loop`` (not reverse-differentiable); gradient paths use the
    classic scan.

    NEE (camera.nee): the carried power-heuristic emission weight rides the
    lane state (reset to 1 on refill) and the final-segment shadow-ray skip
    gates per lane on its own bounce index — the same estimator as the
    classic scan (same uniform slots, so each path's radiance matches it).
    """
    nee = camera.nee
    n_pix = camera.width * camera.height
    n_vol = scene.n_volumes
    nslot = mat_ops.NSLOT + n_vol
    max_depth = camera.max_depth
    # L = lane-pool size = pixels this instance owns; path_id enumerates
    # (local pixel, sample) pairs and _gpix maps a local lane to its GLOBAL
    # pixel id (the RNG/camera key), so shards/tiles reproduce full-frame
    # paths bitwise
    L = n_pix if pixel_ids is None else pixel_ids.shape[0]
    _gpix = (lambda lane: lane) if pixel_ids is None \
        else (lambda lane: pixel_ids[lane])
    total = L * spp
    # ``lanes`` (STATIC): pool size, decoupled from L since round 5 —
    # a bigger pool runs the same total path segments in proportionally
    # fewer while_loop iterations (fewer fixed per-iteration costs:
    # select-kernel launches, gather setup, drain tail). Paths are
    # (pixel, sample)-keyed so the pool size never changes any path's
    # radiance — only the flush order into the image (allclose).
    R = L if lanes is None else max(1, min(lanes, total))
    f32 = jnp.float32
    fast = _rng_impl() == "fast"

    if fast:
        # The classic stream's threefry work collapses to one tiny seed-word
        # table outside the loop: row (s, b) holds the two u32s the scan
        # integrator draws via bits(fold_in(split(fold_in(key, s))[1], b)).
        # Lanes gather their row by (sample, bounce) — bitwise the classic
        # per-path stream at O(spp * depth) threefry total instead of
        # O(lanes * segments).
        def _sample_words(s):
            k_cam, k_path = jax.random.split(jax.random.fold_in(key, s))
            cam_w = jax.random.bits(k_cam, (2,), jnp.uint32)
            path_w = jax.vmap(lambda b: jax.random.bits(
                jax.random.fold_in(k_path, b), (2,), jnp.uint32))(
                    jnp.arange(max_depth))
            return cam_w, path_w

        cam_words, path_words = jax.vmap(_sample_words)(
            sample_offset + jnp.arange(spp))

    use_qmc = camera.qmc
    if use_qmc:
        q_words = qmc.seed_words(key)
        qb_groups, qb_dims, qb_ngroups = qmc.bounce_layout(nslot)

    rr_depth = camera.rr_depth
    if rr_depth and fast:
        # RR stream table, bitwise the classic scan's draw: row (s, b)
        # holds bits(fold_in(fold_in(split(fold_in(key, s))[1], 0x5252), b))
        def _rr_words(s):
            _, k_path = jax.random.split(jax.random.fold_in(key, s))
            k_rr = jax.random.fold_in(k_path, 0x5252)
            return jax.vmap(lambda b: jax.random.bits(
                jax.random.fold_in(k_rr, b), (2,), jnp.uint32))(
                    jnp.arange(max_depth))

        rr_words = jax.vmap(_rr_words)(sample_offset + jnp.arange(spp))

    dispersive = scene.has_dispersion
    if dispersive and fast:
        # seed words of the classic hero-wavelength stream: render_sample
        # draws from fold_in(fold_in(key, s), 0x5ec7) per sample
        wl_words = jax.vmap(lambda s: jax.random.bits(
            jax.random.fold_in(jax.random.fold_in(key, s), 0x5ec7),
            (2,), jnp.uint32))(sample_offset + jnp.arange(spp))

    def spawn_wavelength(path_id):
        """Per-lane hero wavelength, bitwise the classic render_sample
        draw for the lane's (pixel, sample) path."""
        pix = _gpix(path_id % L)
        s = jnp.clip(path_id // L, 0, spp - 1)
        if fast:
            u_wl = fastrng.uniforms(wl_words[s, 0], wl_words[s, 1],
                                    pix, 1)[:, 0]
        else:
            ks = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
                key, sample_offset + s)
            kw = jax.vmap(jax.random.fold_in, in_axes=(0, None))(ks, 0x5ec7)
            u_wl = _lane_uniforms(jax.vmap(jax.random.fold_in)(kw, pix),
                                  1)[:, 0]
        return (spectrum.WAVELENGTH_MIN
                + u_wl * (spectrum.WAVELENGTH_MAX - spectrum.WAVELENGTH_MIN))

    def path_keys(path_id):
        """(k_cam, k_path) of a path's sample, per lane (threefry impl)."""
        sample = sample_offset + path_id // L
        ks = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, sample)
        pair = jax.vmap(lambda k: jax.random.split(k))(ks)
        return pair[:, 0], pair[:, 1]

    def spawn(path_id):
        """Camera rays + fresh state for the given path ids (id >= total ->
        inactive lane)."""
        pix = _gpix(path_id % L)
        if use_qmc:
            s = sample_offset + jnp.clip(path_id // L, 0, spp - 1)
            u_cam = qmc.uniforms(q_words, pix, s, 0, qmc.CAM_GROUP,
                                 qmc.CAM_DIM)
        elif fast:
            s = jnp.clip(path_id // L, 0, spp - 1)
            u_cam = fastrng.uniforms(cam_words[s, 0], cam_words[s, 1],
                                     pix, cam_mod.N_CAM_SLOTS)
        else:
            k_cam, _ = path_keys(path_id)
            cam_keys = jax.vmap(jax.random.fold_in)(k_cam, pix)
            u_cam = _lane_uniforms(cam_keys, cam_mod.N_CAM_SLOTS)
        if not use_qmc:
            # per-lane absolute sample index == the classic loop's scalar
            # one (Sobol jitter is already stratified; see render_sample)
            u_cam = cam_mod.stratify_pixel_jitter(
                camera, u_cam, sample_offset + path_id // L)
        org, dirs, time = cam_mod.generate_rays(camera, pix, u_cam)
        if scene.world_offset is not None:
            org = org - scene.world_offset[None, :]
        active = path_id < total
        return org, dirs, time, active

    def body(state):
        (path_id, bounce, org, dirs, time, throughput, radiance, alive,
         issued, image) = state[:10]
        wl = state[10] if dispersive else None
        emis_w = state[11 if dispersive else 10] if nee else None
        lane = path_id % L       # local image row (pool rows may share it)
        pix = _gpix(lane)        # global pixel id (RNG + camera key)
        if use_qmc:
            s = sample_offset + jnp.clip(path_id // L, 0, spp - 1)
            b = jnp.clip(bounce, 0, max_depth - 1)
            u = qmc.uniforms(q_words, pix, s,
                             qmc.N_CAM_GROUPS + b * qb_ngroups,
                             qb_groups, qb_dims)
        elif fast:
            s = jnp.clip(path_id // L, 0, spp - 1)
            b = jnp.clip(bounce, 0, max_depth - 1)
            u = fastrng.uniforms(path_words[s, b, 0], path_words[s, b, 1],
                                 pix, nslot)
        else:
            _, k_path = path_keys(path_id)
            u_keys = jax.vmap(jax.random.fold_in)(
                jax.vmap(jax.random.fold_in)(k_path, bounce), pix)
            u = _lane_uniforms(u_keys, nslot)

        rr_u = None
        if rr_depth:
            s = jnp.clip(path_id // L, 0, spp - 1)
            b = jnp.clip(bounce, 0, max_depth - 1)
            if fast:
                u_rr = fastrng.uniforms(rr_words[s, b, 0], rr_words[s, b, 1],
                                        pix, 1)[:, 0]
            else:
                _, k_path = path_keys(path_id)
                k1 = jax.vmap(jax.random.fold_in, in_axes=(0, None))(
                    k_path, 0x5252)
                k2 = jax.vmap(jax.random.fold_in)(k1, bounce)
                u_rr = _lane_uniforms(jax.vmap(jax.random.fold_in)(k2, pix),
                                      1)[:, 0]
            rr_u = jnp.where(bounce >= rr_depth, u_rr, -1.0)

        ior_shift = spectrum.cauchy_ior_shift(wl) if dispersive else None
        # per-lane final-segment gate: a lane's own bounce index decides
        # whether its shadow ray fits the depth budget (classic scan:
        # render_rays' scalar bounce_idx < max_depth - 1)
        nee_shadow = (bounce < max_depth - 1) if nee else True
        step_out = _shade_step(
            scene, org, dirs, time, throughput, radiance, alive, u,
            ior_shift=ior_shift, rr_u=rr_u, emis_w=emis_w,
            nee_shadow=nee_shadow)
        if nee:
            (org, dirs, time, throughput, radiance, alive2,
             emis_w_next) = step_out
        else:
            org, dirs, time, throughput, radiance, alive2 = step_out
        bounce = bounce + 1
        alive2 = alive2 & (bounce < max_depth)

        done = alive & ~alive2              # path just finished
        flush = radiance
        if dispersive:
            # same post-hoc weighting as render_rays: radiance is linear in
            # initial throughput
            flush = radiance * spectrum.spectral_path_weight(wl)
        if camera.clamp > 0.0:
            flush = jnp.minimum(flush, camera.clamp)  # firefly clamp
        image = image.at[lane].add(jnp.where(done[:, None], flush, 0.0))

        # refill finished lanes with the next unissued paths
        rank = jnp.cumsum(done.astype(jnp.int32)) - 1
        new_id = issued + rank
        take = done & (new_id < total)
        path_id = jnp.where(take, new_id, jnp.where(done, total, path_id))
        issued = issued + jnp.sum(done.astype(jnp.int32))

        s_org, s_dirs, s_time, s_active = spawn(path_id)
        fresh = done
        org = jnp.where(fresh[:, None], s_org, org)
        dirs = jnp.where(fresh[:, None], s_dirs, dirs)
        time = jnp.where(fresh, s_time, time)
        throughput = jnp.where(fresh[:, None], 1.0, throughput)
        radiance = jnp.where(fresh[:, None], 0.0, radiance)
        bounce = jnp.where(fresh, 0, bounce)
        alive = jnp.where(fresh, s_active, alive2)
        out = (path_id, bounce, org, dirs, time, throughput, radiance,
               alive, issued, image)
        if dispersive:
            out += (jnp.where(fresh, spawn_wavelength(path_id), wl),)
        if nee:
            out += (jnp.where(fresh, 1.0, emis_w_next),)
        return out

    def cond(state):
        alive = state[7]
        return jnp.any(alive)

    path0 = jnp.arange(R, dtype=jnp.int32)
    org0, dirs0, time0, active0 = spawn(path0)
    state = (path0, jnp.zeros((R,), jnp.int32), org0, dirs0, time0,
             jnp.ones((R, 3), f32), jnp.zeros((R, 3), f32), active0,
             jnp.int32(R), jnp.zeros((L, 3), f32))
    if dispersive:
        state += (spawn_wavelength(path0),)
    if nee:
        state += (jnp.ones((R,), f32),)
    state = jax.lax.while_loop(cond, body, state)
    return state[9]


def render_image_wavefront(scene, camera, key, spp: int | None = None,
                           tile_pixels: int | None = None):
    """Full image [H,W,3] through the path-regeneration wavefront.

    Dispersive scenes carry each lane's hero wavelength through the refill
    logic (spawn_wavelength reconstructs the classic render_sample draw per
    (pixel, sample) path), so spectral renders match the classic scan.

    ``tile_pixels``: host loop over fixed-size pixel tiles, each a
    wavefront over that tile's lane pool (one compiled shape; the tail
    tile pads with repeated pixel 0 and discards the extras). RNG is
    global-(pixel, sample) keyed, so every path's radiance is bitwise the
    untiled wavefront's; only the per-pixel flush ORDER differs with the
    tile's refill dynamics (allclose, same contract as wavefront-vs-scan)."""
    import numpy as np

    spp = camera.spp if spp is None else spp
    n_pix = camera.width * camera.height
    if tile_pixels is None or tile_pixels >= n_pix:
        accum = render_wavefront(scene, camera, key, spp,
                                 lanes=wavefront_lanes(scene, n_pix))
        return (accum / spp).reshape(camera.height, camera.width, 3)
    tile = tile_pixels
    out = np.zeros((n_pix, 3), np.float32)
    for start in range(0, n_pix, tile):
        n_real = min(tile, n_pix - start)
        ids = np.arange(start, start + tile, dtype=np.int32)
        ids[n_real:] = 0  # pad rows discarded below
        acc = render_wavefront(scene, camera, key, spp,
                               pixel_ids=jnp.asarray(ids),
                               lanes=wavefront_lanes(scene, tile))
        out[start:start + n_real] = np.asarray(acc)[:n_real]
    return jnp.asarray(out / spp).reshape(camera.height, camera.width, 3)


def render_image(scene, camera, key, spp: int | None = None,
                 unroll: tuple | None = None,
                 replay_isect: bool = False) -> jnp.ndarray:
    """Full image [H,W,3] (linear radiance, pre-gamma).

    The sample loop is a ``lax.scan`` (one full-frame wavefront per sample)
    — the batched replacement for the reference's per-pixel sample loop
    (src/camera.h:163-171). spp defaults to camera.spp.

    ``unroll`` defaults to the forward-tuned factors (UNROLL note above);
    gradient callers (models/diff.py) pass (1, 1) — pass that yourself if
    you differentiate through this function and the compiler fails on
    grad-of-unrolled-scan.
    """
    spp = camera.spp if spp is None else spp
    unroll = _default_unroll() if unroll is None else unroll
    accum = accumulate_samples(scene, camera, key, 0, spp, unroll=unroll,
                               replay_isect=replay_isect,
                               batch_pixels=scan_batch_pixels(scene))
    return (accum / spp).reshape(camera.height, camera.width, 3)


def render_image_tiled(scene, camera, key, spp: int | None = None,
                       tile_pixels: int = 1 << 18):
    """render_image for frames too large for one dispatch: the host loops
    over fixed-size pixel tiles (ONE compiled shape — the tail tile pads
    with repeated ids and discards the extras). Pixel-id keyed RNG makes
    the result identical to the untiled render for any tile size; HBM
    high-water per dispatch drops from O(W*H) lanes to O(tile_pixels).
    Beyond-parity: the reference's row-parallel loop (src/camera.h:158)
    holds the whole frame in memory."""
    import numpy as np

    spp = camera.spp if spp is None else spp
    unroll = _default_unroll()
    n_pix = camera.width * camera.height
    tile = min(tile_pixels, n_pix)
    out = np.zeros((n_pix, 3), np.float32)
    for start in range(0, n_pix, tile):
        n_real = min(tile, n_pix - start)
        ids = np.arange(start, start + tile, dtype=np.int32)
        ids[n_real:] = start  # pad rows discarded below
        acc = accumulate_samples_subset(scene, camera, key,
                                        jnp.asarray(ids), 0, spp,
                                        unroll=unroll)
        out[start:start + n_real] = np.asarray(acc)[:n_real]
    return (out / spp).reshape(camera.height, camera.width, 3)
