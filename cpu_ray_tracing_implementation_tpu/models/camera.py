"""Camera models: perspective, orthographic, fisheye, thin-lens DoF.

Batched re-design of reference src/camera.h:18-132,244-296: one pytree of traced
parameters (so images are differentiable w.r.t. camera pose/FoV) with static
mode/resolution, and a batched ``generate_rays`` mapping (pixel id, uniforms)
-> (origin, direction, time). Per-pixel jitter, shutter time, and the
defocus-disk sample come in as explicit uniform slots:
  0,1: pixel jitter; 2: ray time; 3,4: defocus disk.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cpu_ray_tracing_implementation_tpu.ops import sampling as smp
from cpu_ray_tracing_implementation_tpu.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu.utils import pytree

PERSPECTIVE = 0
ORTHOGRAPHIC = 1
FISHEYE = 2
LENS = 3

N_CAM_SLOTS = 5


@pytree.dataclass
class Camera:
    pos: jnp.ndarray          # [3]
    lookat: jnp.ndarray       # [3]
    fovy_deg: jnp.ndarray     # scalar (perspective/fisheye/lens)
    focal_length: jnp.ndarray # scalar (perspective/fisheye)
    ortho_viewport_h: jnp.ndarray  # scalar (orthographic)
    defocus_angle_deg: jnp.ndarray # scalar (lens)
    focus_dist: jnp.ndarray   # scalar (lens)
    mode: int = pytree.static_field(default=PERSPECTIVE)
    width: int = pytree.static_field(default=256)
    height: int = pytree.static_field(default=256)
    spp: int = pytree.static_field(default=16)
    max_depth: int = pytree.static_field(default=5)
    # Stratified pixel jitter (opt-in; cam.replace(stratify=True) or CLI
    # --stratify). The reference README claims stratified sampling but
    # implements uniform jitter only (src/camera.h:293); this is the real
    # thing: sample s of cam.spp jitters within cell s of an exact
    # nx x ny == spp grid over the pixel, cutting pixel variance at equal
    # cost. Off by default so the reference-parity goldens stay valid.
    stratify: bool = pytree.static_field(default=False)
    # Owen-scrambled Sobol sampling (opt-in; cam.replace(qmc=True) or CLI
    # --qmc): every dimension pair of a path (pixel jitter, BSDF dir,
    # light UV, ...) draws from a per-pixel-scrambled (0,2)-sequence
    # indexed by sample (ops/qmc.py) instead of the hash PRNG — lower
    # variance at equal spp, unbiased. Off = reference-parity PRNG.
    qmc: bool = pytree.static_field(default=False)
    # Russian-roulette path termination (opt-in; cam.replace(rr_depth=N) /
    # CLI --rr-depth): from bounce N on, a path survives with probability
    # p = clamp(max channel of throughput, 0.05, 1) and rescales by 1/p.
    # Unbiased; the wavefront integrator turns freed lanes into new paths
    # (real speedup), the classic scan only zeroes them. 0 = off.
    rr_depth: int = pytree.static_field(default=0)
    # Next-event estimation (opt-in; cam.replace(nee=True) or CLI --nee):
    # each diffuse bounce takes an explicit shadow-ray light sample plus a
    # pure BSDF continuation, combined with the power heuristic — lower
    # variance than the reference's 50/50 one-sample mixture
    # (src/pdf.h:48-61) at the cost of one extra intersect per bounce.
    # Off (default) keeps the reference-parity estimator bitwise intact.
    nee: bool = pytree.static_field(default=False)
    # Firefly clamp (opt-in; cam.replace(clamp=C) or CLI --clamp): each
    # path sample's radiance is min'd against C per channel before
    # accumulation — the standard production "max sample brightness"
    # variance/bias trade. 0.0 (default) = off, estimator untouched.
    clamp: float = pytree.static_field(default=0.0)


def _image_height(width: int, aspect_ratio: float) -> int:
    """int(width/aspect), clamped to >=1 (src/camera.h:34-36)."""
    return max(1, int(width / aspect_ratio))


def _mk(mode, width, aspect_ratio, pos, lookat, spp, max_depth, **kw):
    f32 = jnp.float32
    defaults = dict(fovy_deg=90.0, focal_length=1.0, ortho_viewport_h=2.0,
                    defocus_angle_deg=0.0, focus_dist=1.0)
    defaults.update(kw)
    return Camera(
        pos=jnp.asarray(pos, f32),
        lookat=jnp.asarray(lookat, f32),
        fovy_deg=f32(defaults["fovy_deg"]),
        focal_length=f32(defaults["focal_length"]),
        ortho_viewport_h=f32(defaults["ortho_viewport_h"]),
        defocus_angle_deg=f32(defaults["defocus_angle_deg"]),
        focus_dist=f32(defaults["focus_dist"]),
        mode=mode,
        width=int(width),
        height=_image_height(width, aspect_ratio),
        spp=int(spp),
        max_depth=int(max_depth),
    )


def perspective(width, aspect_ratio, pos, lookat, focal_length=1.0, fovy_deg=90.0,
                spp=100, max_depth=5) -> Camera:
    """src/camera.h:21-50"""
    return _mk(PERSPECTIVE, width, aspect_ratio, pos, lookat, spp, max_depth,
               focal_length=focal_length, fovy_deg=fovy_deg)


def orthographic(width, aspect_ratio, viewport_height, pos, lookat,
                 spp=100, max_depth=5) -> Camera:
    """src/camera.h:52-72"""
    return _mk(ORTHOGRAPHIC, width, aspect_ratio, pos, lookat, spp, max_depth,
               ortho_viewport_h=viewport_height)


def fisheye(width, aspect_ratio, pos, lookat, focal_length=1.0, fovy_deg=90.0,
            spp=100, max_depth=5) -> Camera:
    """src/camera.h:74-102"""
    return _mk(FISHEYE, width, aspect_ratio, pos, lookat, spp, max_depth,
               focal_length=focal_length, fovy_deg=fovy_deg)


def lens(width, aspect_ratio, pos, lookat, defocus_angle_deg, focus_dist=1.0,
         fovy_deg=90.0, spp=100, max_depth=5) -> Camera:
    """src/camera.h:104-132 (thin-lens depth of field)"""
    return _mk(LENS, width, aspect_ratio, pos, lookat, spp, max_depth,
               defocus_angle_deg=defocus_angle_deg, focus_dist=focus_dist, fovy_deg=fovy_deg)


def stratum_grid(spp: int) -> tuple:
    """(nx, ny) with nx * ny == spp exactly and nx <= sqrt(spp) maximal.

    An exact factorization keeps the union of cells a uniform cover of the
    pixel square — every jitter distribution stays the unbiased box filter.
    Primes degrade to a 1 x spp grid (1-D stratification, still a strict
    variance improvement over independent jitter)."""
    spp = max(int(spp), 1)
    nx = max(int(np.sqrt(spp)), 1)
    while spp % nx:
        nx -= 1
    return nx, spp // nx


def stratify_pixel_jitter(cam: Camera, u: jnp.ndarray, sample_idx) -> jnp.ndarray:
    """Remap the pixel-jitter uniforms (slots 0,1) into sample ``sample_idx``'s
    stratum cell. No-op when cam.stratify is off or no sample index is known.

    ``sample_idx`` is the ABSOLUTE sample index (scalar or per-lane [R]) —
    the same quantity that keys the RNG fold — so strata, like the random
    stream, are invariant to how samples are split across checkpoint chunks
    or mesh devices. Samples beyond cam.spp wrap (s % spp): still uniform
    per cell, merely less stratified."""
    if not cam.stratify or sample_idx is None:
        return u
    nx, ny = stratum_grid(cam.spp)
    s = jnp.asarray(sample_idx) % cam.spp
    sx = (s % nx).astype(jnp.float32)
    sy = (s // nx).astype(jnp.float32)
    u0 = (sx + u[:, 0]) / nx
    u1 = (sy + u[:, 1]) / ny
    return u.at[:, 0].set(u0).at[:, 1].set(u1)


def _basis(cam: Camera):
    """world_up = +y; right-handed camera frame (src/camera.h:25-28)."""
    world_up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    d = vm.normalize(cam.lookat - cam.pos)
    right = vm.normalize(vm.cross(d, world_up))
    up = vm.cross(right, d)
    return d, right, up


def _viewport(cam: Camera):
    """viewport height/width; lens mode scales by focus_dist (src/camera.h:46-47,125-126)."""
    theta = cam.fovy_deg * (smp.PI / 180.0)
    dist = jnp.where(cam.mode == LENS, cam.focus_dist, cam.focal_length)
    vh = jnp.where(cam.mode == ORTHOGRAPHIC,
                   cam.ortho_viewport_h, 2.0 * jnp.tan(theta / 2.0) * dist)
    vw = vh * (cam.width / cam.height)  # actual integer aspect (src/camera.h:41-47)
    return vh, vw


def generate_rays(cam: Camera, pixel_ids: jnp.ndarray, u: jnp.ndarray):
    """(origin [R,3], direction [R,3], time [R]) for flat pixel ids i*W+j.

    Matches src/camera.h:244-284 per mode; the equisolid fisheye bend is the
    reference's construction verbatim (src/camera.h:259-275) with asin/div
    guards added (the reference NaNs silently at the image corners).
    """
    d, right, up = _basis(cam)
    vh, vw = _viewport(cam)
    W, H = cam.width, cam.height

    delta_u = (vw / W) * right
    delta_v = (-vh / H) * up

    i = (pixel_ids // W).astype(jnp.float32)  # row
    j = (pixel_ids % W).astype(jnp.float32)   # col
    ox = u[:, 0] - 0.5
    oy = u[:, 1] - 0.5
    jx = (j + ox)[:, None]
    iy = (i + oy)[:, None]
    time = u[:, 2]

    if cam.mode == PERSPECTIVE or cam.mode == FISHEYE:
        dir00 = (cam.focal_length * d - vw / 2.0 * right + vh / 2.0 * up
                 + 0.5 * (delta_u + delta_v))
        ray_dir = dir00 + jx * delta_u + iy * delta_v
        if cam.mode == FISHEYE:
            r = vm.length(ray_dir - d)
            theta = jnp.arcsin(jnp.clip(r / cam.focal_length, -1.0, 1.0))
            v1 = d[None, :]
            v2 = vm.normalize(ray_dir)
            dot12 = vm.dot(v1, v2)
            denom = jnp.maximum(1.0 - dot12 * dot12, 1e-12)
            sin_t = jnp.sin(theta)
            b_prime = jnp.sqrt(sin_t * sin_t / denom)
            a_prime = jnp.cos(theta) - b_prime * dot12
            ray_dir = a_prime[:, None] * v1 + b_prime[:, None] * v2
        org = jnp.broadcast_to(cam.pos, ray_dir.shape)
        return org, ray_dir, time

    if cam.mode == ORTHOGRAPHIC:
        pos00 = (cam.pos - vw / 2.0 * right + vh / 2.0 * up + 0.5 * (delta_u + delta_v))
        org = pos00 + jx * delta_u + iy * delta_v
        ray_dir = jnp.broadcast_to(d, org.shape)
        return org, ray_dir, time

    # LENS (src/camera.h:276-283): jittered focus-plane target, origin on the
    # defocus disk; the reference's lens rays carry no time (ray defaults 0).
    fp00 = (cam.pos - vw / 2.0 * right + vh / 2.0 * up + 0.5 * (delta_u + delta_v))
    target = fp00 + jx * delta_u + iy * delta_v + cam.focus_dist * d
    defocus_radius = cam.focus_dist * jnp.tan(
        cam.defocus_angle_deg * (smp.PI / 180.0) / 2.0)
    disk = smp.disk_sample(u[:, 3], u[:, 4])
    org = cam.pos + defocus_radius * (disk[:, 0:1] * right + disk[:, 1:2] * up)
    ray_dir = target - org
    return org, ray_dir, jnp.zeros_like(time)
