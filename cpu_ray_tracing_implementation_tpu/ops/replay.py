"""Compact-residual intersection for the differentiated path.

The remat backward (jax.checkpoint per sample, models/integrator.py)
recomputes each sample's ENTIRE forward inside the VJP — including the
O(R*N) intersection sweep, slope-measured at 36% of forward — and then
differentiates it, transposing every [R,N] einsum (BASELINE.md Roofline
item 2: bwd/fwd = 2.18x).

This module splits intersection into

  1. ``winner_pack``  — the expensive sweep, reduced to ONE int32 per lane
     (type in the top bits, primitive index below, -1 = miss) under
     ``stop_gradient`` and tagged with ``checkpoint_name('isect_ids')``;
  2. ``replay_hit``   — an O(R) differentiable reconstruction: gather the
     winning primitive's parameters and re-intersect just that one
     (the quadratic of src/sphere.h:40-74, the plane equation of
     src/quad.h:30-52 / src/triangle.h:8-15, the -ln(U)/rho sample of
     src/volumne.h:36 — each for a single gathered primitive per ray).

Under ``jax.checkpoint(..., policy=save_only_these_names('isect_ids'))``
the forward saves 4 bytes per lane-bounce, the remat backward DCEs the
sweep entirely (its only consumer is the saved residual), and the VJP
differentiates the O(R) replay instead of the O(R*N) sweep.

Gradient semantics are unchanged: min/argmin already route gradients to
the winning primitive only — replaying the winner computes the same
derivative. Values can differ from the dense path in ulps (the replay
quadratic uses the direct |o-c|^2 form rather than the dense path's matmul
expansion), so this is OPT-IN for gradient paths (models/diff.py); the
default forward render is untouched and stays bitwise golden-pinned.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from cpu_ray_tracing_implementation_tpu.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu.ops import vecmath as vm

INF = jnp.inf

TYPE_SPH, TYPE_QUAD, TYPE_TRI, TYPE_VOL = 0, 1, 2, 3
_SHIFT = 28
_IDX_MASK = (1 << _SHIFT) - 1

RESIDUAL_NAME = "isect_ids"


def save_isect_policy():
    """Checkpoint policy saving only the packed winner ids."""
    return jax.checkpoint_policies.save_only_these_names(RESIDUAL_NAME)


def supported(scene) -> bool:
    """Replay currently covers dense (un-chunked) scene tables; chunked
    scenes fall back to the standard path (their accelerated VJP lives in
    ops/perray.py / ops/chunked.py)."""
    return (scene.sphere_chunks is None and scene.quad_chunks is None
            and scene.tri_chunks is None)


def winner_pack(scene, org, dirs, time, tmin, u_vol, tmax=INF) -> jnp.ndarray:
    """[R] int32: (type << 28) | index of the closest hit, -1 = miss.

    Runs the same dense per-type sweeps as ops.intersect._intersect_core
    (src/hittable_list.h:20-31 semantics) purely for the DECISION; callers
    wrap the result in stop_gradient + checkpoint_name.
    """
    n_sph, n_quad, n_tri, n_vol = scene.counts
    R = org.shape[0]
    inf_t = jnp.full((R,), INF, org.dtype)
    zero_i = jnp.zeros((R,), jnp.int32)

    def best(ts):
        return jnp.min(ts, axis=-1), jnp.argmin(ts, axis=-1)

    t_s, i_s = (best(isect.sphere_ts(org, dirs, time, scene.spheres, tmin,
                                     tmax)) if n_sph else (inf_t, zero_i))
    t_q, i_q = (best(isect.quad_ts(org, dirs, scene.quads, tmin, tmax))
                if n_quad else (inf_t, zero_i))
    t_t, i_t = (best(isect.tri_ts(org, dirs, scene.tris, tmin, tmax))
                if n_tri else (inf_t, zero_i))
    t_surface = jnp.minimum(jnp.minimum(t_s, t_q), t_t)
    if n_vol:
        t_v, i_v, _ = isect.volume_sample(org, dirs, scene.volumes, tmin,
                                          t_surface, u_vol)
    else:
        t_v, i_v = inf_t, zero_i

    t_all = jnp.stack([t_s, t_q, t_t, t_v], axis=-1)
    which = jnp.argmin(t_all, axis=-1).astype(jnp.int32)
    t = jnp.min(t_all, axis=-1)
    idx_all = jnp.stack([i_s, i_q, i_t, i_v], axis=-1)
    idx = jnp.sum(idx_all * jax.nn.one_hot(which, 4, dtype=jnp.int32),
                  axis=-1)
    packed = (which << _SHIFT) | idx
    return jnp.where(jnp.isfinite(t), packed, jnp.int32(-1))


def _sphere_t_one(org, dirs, time, sph, idx, tmin, tmax):
    """[R] t of ray r against sphere idx[r] — the src/sphere.h:40-74
    quadratic with the time-lerped center, in the direct |o-c|^2 form
    (numerically tighter than the dense matmul expansion; ulp-level value
    differences from the dense path are expected and fine on the grad
    path)."""
    n = sph.c0.shape[0]
    oh = tbl.onehot(idx, n) if n <= tbl.MAX_ONEHOT else None
    c0 = tbl.take_rows(sph.c0, idx, oh)
    c1 = tbl.take_rows(sph.c1, idx, oh)
    rad = tbl.take_rows(sph.rad, idx, oh)
    center = c0 + time[:, None] * (c1 - c0)
    oc = org - center
    # max guard: DEAD integrator lanes carry zero-length dirs; a == 0 makes
    # t0/t1 inf primals whose reverse partial (1/2a) is inf, and the masked
    # lane's 0-cotangent times that is NaN in every geometry-table gradient
    # (live lanes have |dirs| ~ 1, so the max is bitwise-neutral for them)
    a = jnp.maximum(vm.dot(dirs, dirs), 1e-20)
    b = 2.0 * vm.dot(dirs, oc)
    c = vm.dot(oc, oc) - rad * rad
    disc = b * b - 4.0 * a * c
    has = disc > 0.0
    sqrtd = jnp.sqrt(jnp.where(has, disc, 1.0))  # double-where: AD-safe
    t0 = (-b - sqrtd) / (2.0 * a)
    t1 = (-b + sqrtd) / (2.0 * a)
    t = jnp.where((t0 >= tmin) & (t0 <= tmax), t0,
                  jnp.where((t1 >= tmin) & (t1 <= tmax), t1, INF))
    return jnp.where(has, t, INF)


def _planar_t_one(org, dirs, corner, eu, ev, idx, oh):
    """[R] plane-equation t of ray r against planar primitive idx[r]
    (src/quad.h:36-44; interior tests are already baked into the saved
    winner decision)."""
    c = tbl.take_rows(corner, idx, oh)
    e1 = tbl.take_rows(eu, idx, oh)
    e2 = tbl.take_rows(ev, idx, oh)
    n = vm.cross(e1, e2)
    unorm = vm.normalize(n)
    d_n = vm.dot(dirs, unorm)
    ok = jnp.abs(d_n) > 1e-20
    return jnp.where(ok, vm.dot(c - org, unorm) / jnp.where(ok, d_n, 1.0),
                     INF)


def _volume_t_one(org, dirs, vols, idx, u_vol, tmin):
    """[R] scatter t of ray r inside volume idx[r]: boundary entry then the
    -ln(U)/rho distance (src/volumne.h:25-36). The exit-clamp indicator is
    part of the saved decision; the value needs only the entry point."""
    nv = vols.center.shape[0]
    oh = tbl.onehot(idx, nv) if nv <= tbl.MAX_ONEHOT else None
    center = tbl.take_rows(vols.center, idx, oh)
    half = tbl.take_rows(vols.half, idx, oh)
    kind = tbl.take_rows(vols.kind, idx, oh)
    nid = tbl.take_rows(vols.neg_inv_density, idx, oh)
    # rot is [V,3,3]; gather via flattened rows
    rot = tbl.take_rows(vols.rot.reshape(nv, 9), idx, oh).reshape(-1, 3, 3)

    rel = org - center
    ol = jnp.einsum("rk,rkl->rl", rel, rot, precision="highest")
    dl = jnp.einsum("rk,rkl->rl", dirs, rot, precision="highest")

    ok = jnp.abs(dl) > 1e-12
    dl_safe = jnp.where(ok, dl, 1.0)
    BIG = 1e30
    lo = jnp.where(ok, (-half - ol) / dl_safe,
                   jnp.where(jnp.abs(ol) <= half, -BIG, BIG))
    hi = jnp.where(ok, (half - ol) / dl_safe,
                   jnp.where(jnp.abs(ol) <= half, BIG, -BIG))
    t1_box = jnp.max(jnp.minimum(lo, hi), axis=-1)

    a = vm.dot(dirs, dirs)
    b = 2.0 * vm.dot(dirs, rel)
    c = vm.dot(rel, rel) - half[:, 0] ** 2
    disc = b * b - 4.0 * a * c
    has = disc > 0.0
    sq = jnp.sqrt(jnp.where(has, disc, 1.0))
    t1_sph = jnp.where(has, (-b - sq) / (2.0 * a), BIG)

    t1 = jnp.where(kind == 0, t1_box, t1_sph)
    t1c = jnp.maximum(t1, tmin)
    # u_vol[r, idx[r]] without a take_along_axis row gather
    V = u_vol.shape[1]
    u_w = jnp.sum(u_vol * jax.nn.one_hot(idx, V, dtype=u_vol.dtype), axis=-1)
    # floor must stay NORMAL in f32: XLA flushes subnormals (e.g. 1e-38,
    # below FLT_MIN 1.175e-38) to zero, and log(0) = -inf turns the
    # non-volume lanes' nid=0 into 0 * -inf = NaN
    hit_dist = nid * jnp.log(jnp.maximum(u_w, 1e-30))
    return t1c + hit_dist / jnp.maximum(vm.length(dirs), 1e-20)


def replay_hit(scene, org, dirs, time, u_vol, packed, tmin, tmax=INF):
    """Differentiable Hit from the packed winner ids — O(R) gathers and a
    single re-intersection per lane; no [R,N] intermediates anywhere."""
    n_sph, n_quad, n_tri, n_vol = scene.counts
    R = org.shape[0]
    valid = packed >= 0
    safe = jnp.where(valid, packed, 0)
    which = safe >> _SHIFT
    idx = safe & _IDX_MASK

    t = jnp.zeros((R,), org.dtype)
    normal = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], org.dtype),
                              org.shape)
    front = jnp.ones((R,), bool)
    uu = jnp.zeros((R,), org.dtype)
    vv = jnp.zeros((R,), org.dtype)
    mat = jnp.zeros((R,), jnp.int32)

    def merge_t(cond, t_k):
        """Winner-masked t: non-winner lanes are zeroed OUTRIGHT (not just
        de-inf'd) — their replayed t can be finite-but-huge (guarded-
        denominator sentinels up to ~1e30), and t * dirs then overflows p
        to inf inside the type's shading, where inf - inf = NaN poisons
        the geometry-table gradients (geo_* params, round-4)."""
        nonlocal t
        t_k = jnp.where(cond & jnp.isfinite(t_k), t_k, 0.0)
        t = jnp.where(cond, t_k, t)
        return t_k

    def merge(cond, attrs):
        nonlocal normal, front, uu, vv, mat
        _, n_k, f_k, u_k, v_k, m_k = attrs
        normal = jnp.where(cond[:, None], n_k, normal)
        front = jnp.where(cond, f_k, front)
        uu = jnp.where(cond, u_k, uu)
        vv = jnp.where(cond, v_k, vv)
        mat = jnp.where(cond, m_k, mat)

    if n_sph:
        cond = valid & (which == TYPE_SPH)
        t_k = _sphere_t_one(org, dirs, time, scene.spheres, idx, tmin, tmax)
        t_m = merge_t(cond, t_k)
        merge(cond, isect.sphere_shading(
            org, dirs, time, scene.spheres, idx, t_m))
    if n_quad:
        cond = valid & (which == TYPE_QUAD)
        nq = scene.quads.corner.shape[0]
        oh = tbl.onehot(idx, nq) if nq <= tbl.MAX_ONEHOT else None
        t_k = _planar_t_one(org, dirs, scene.quads.corner, scene.quads.eu,
                            scene.quads.ev, idx, oh)
        t_m = merge_t(cond, t_k)
        merge(cond, isect.quad_shading(org, dirs, scene.quads, idx, t_m))
    if n_tri:
        cond = valid & (which == TYPE_TRI)
        nt = scene.tris.v0.shape[0]
        oh = tbl.onehot(idx, nt) if nt <= tbl.MAX_ONEHOT else None
        t_k = _planar_t_one(org, dirs, scene.tris.v0,
                            scene.tris.v1 - scene.tris.v0,
                            scene.tris.v2 - scene.tris.v0, idx, oh)
        t_m = merge_t(cond, t_k)
        merge(cond, isect.tri_shading(org, dirs, scene.tris, idx, t_m,
                                      attrs=scene.tri_attrs))
    if n_vol:
        cond = valid & (which == TYPE_VOL)
        t_k = _volume_t_one(org, dirs, scene.volumes, idx, u_vol, tmin)
        merge_t(cond, t_k)
        # volume record: arbitrary normal/front (src/volumne.h:42-43)
        m_v = tbl.take_rows(scene.volumes.mat, idx)
        mat = jnp.where(cond, m_v, mat)

    p = org + t[:, None] * dirs
    return isect.Hit(valid=valid, t=jnp.where(valid, t, INF), p=p,
                     normal=normal, front=front, u=uu, v=vv,
                     mat=jnp.where(valid, mat, 0))


# ------------------------------------------------- chunked-table replay VJPs
# The accelerated intersectors (ops/perray.py, ops/packet.py) are
# forward-only with custom VJPs; through round 2 those VJPs re-ran the XLA
# chunk scan over ALL chunks (VERDICT round 2, weak 3: a colonnade gradient
# step paid the 2,015-chunk sweep the forward took 17.7 s to avoid). The
# forward already knows each ray's winning primitive id — these functions
# re-intersect exactly that primitive, differentiably, in O(R), and the
# accel modules jax.vjp through them in their backward rules. The gather's
# transpose is a scatter-add into the chunk tables: the compact backward.


def planar_chunks_winner(org, dirs, chunks, pid, tmin, triangle, tmax):
    """Differentiable (t, (unorm [R,3], a [R], b [R], mat [R], pid [R])) of
    chunk-order primitive ``pid[r]`` against ray r — the per-winner form of
    ops.chunked._planar_chunk_ts (same guards and sentinels; interior /
    range checks live in the saved winner decision). ``tmin``/``tmax``/
    ``triangle`` are unused for the value but kept for signature parity."""
    del tmin, triangle, tmax
    K, C = chunks.corner.shape[:2]
    flat3 = lambda x: x.reshape(K * C, 3)
    corner = flat3(chunks.corner)[pid]
    eu = flat3(chunks.eu)[pid]
    ev = flat3(chunks.ev)[pid]
    mat = chunks.mat.reshape(K * C)[pid]

    n = vm.cross(eu, ev)
    unorm = vm.normalize(n)
    d_n = vm.dot(dirs, unorm)
    ok = jnp.abs(d_n) > 1e-20
    t = jnp.where(ok, vm.dot(corner - org, unorm)
                  / jnp.where(ok, d_n, 1.0), 1e30)
    w = n / jnp.maximum(vm.dot(n, n), 1e-20)[:, None]
    evw = vm.cross(ev, w)
    weu = vm.cross(w, eu)
    q = org + t[:, None] * dirs - corner
    a = jnp.clip(vm.dot(q, evw), -1e30, 1e30)
    b = jnp.clip(vm.dot(q, weu), -1e30, 1e30)
    return t, (unorm, a, b, mat, pid)


def sphere_chunks_winner(org, dirs, time, chunks, pid, tmin, tmax):
    """Differentiable (t, (center_at_t [R,3], rad [R], mat [R], pid [R]))
    of chunk-order sphere ``pid[r]``. Root rule: the winner's root is t0
    when t0 >= tmin, else t1 (a winner with t0 in range always took t0 —
    a later root can't have beaten the running closest)."""
    del tmax
    K, C = chunks.rad.shape
    flat3 = lambda x: x.reshape(K * C, 3)
    c0 = flat3(chunks.c0)[pid]
    c1 = flat3(chunks.c1)[pid]
    rad = chunks.rad.reshape(K * C)[pid]
    mat = chunks.mat.reshape(K * C)[pid]

    center = c0 + time[:, None] * (c1 - c0)
    oc = org - center
    a = jnp.maximum(vm.dot(dirs, dirs), 1e-20)
    b = 2.0 * vm.dot(dirs, oc)
    c = vm.dot(oc, oc) - rad * rad
    disc = b * b - 4.0 * a * c
    has = disc > 0.0
    sqrtd = jnp.sqrt(jnp.where(has, disc, 1.0))  # double-where: AD-safe
    t0 = (-b - sqrtd) / (2.0 * a)
    t1 = (-b + sqrtd) / (2.0 * a)
    t = jnp.where(t0 >= tmin, t0, t1)
    # eps 1e-12: (1e-20)^2 underflows to 0 in f32 in this guard's div
    # transpose (see ops/intersect.sphere_shading) — NaN on masked lanes
    return t, (center, jnp.maximum(rad, 1e-12), mat, pid)


def intersect_replay(scene, org, dirs, time, tmin, u_vol, tmax=INF,
                     active=None):
    """Drop-in for ops.intersect.intersect_brute on the gradient path:
    saved-decision winner + O(R) differentiable replay (module docstring).
    ``active`` only gates accelerator traversal caps in the brute path and
    is unused by the dense sweep."""
    del active
    packed = jax.lax.stop_gradient(
        winner_pack(scene, org, dirs, time, tmin, u_vol, tmax))
    packed = checkpoint_name(packed, RESIDUAL_NAME)
    return replay_hit(scene, org, dirs, time, u_vol, packed, tmin, tmax)
