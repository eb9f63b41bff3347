"""Batched ray-primitive intersection over flat scene tables.

Batched re-design of the reference's virtual ``hittable::hit`` dispatch + linear
``hittable_list`` scan (src/hittable_list.h:20-31): rays are a [R] batch, each
primitive type is intersected as one dense [R, N] vectorized test, the
closest hit is a masked argmin, and shading attributes are computed only for
the winning primitive of each type. Constant-density volumes
(src/volumne.h:18-46) participate as an RNG-consuming sampling step clipped
by the closest surface hit.

This dense path is the correctness oracle and optimal for small scenes;
tables above the chunking threshold route through the BVH-ordered chunk scan
(ops/chunked.py) or its accelerators (ops/packet.py, ops/perray.py, ops/bvh.py)
behind the same ``Hit`` interface — selected statically per scene here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cpu_ray_tracing_implementation_tpu.ops import chunked
from cpu_ray_tracing_implementation_tpu.ops import tables as tbl
from cpu_ray_tracing_implementation_tpu.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu.ops.sampling import PI
from cpu_ray_tracing_implementation_tpu.utils import pytree

INF = jnp.inf
BIG = 1e30


@pytree.dataclass
class Hit:
    valid: jnp.ndarray   # [R] bool
    t: jnp.ndarray       # [R]
    p: jnp.ndarray       # [R,3]
    normal: jnp.ndarray  # [R,3] face-forward unit normal
    front: jnp.ndarray   # [R] bool (dot(ray_dir, outward_normal) < 0)
    u: jnp.ndarray       # [R]
    v: jnp.ndarray       # [R]
    mat: jnp.ndarray     # [R] int32


def accel_mode() -> str:
    """Large-table accelerator choice (env CRT_ACCEL): ``auto`` picks per
    table size (see _auto_mode), ``ray`` (per-ray visit lists —
    ops/perray.py), ``packet`` (tile-packet culling), ``bvh`` (per-ray
    node traversal oracle), ``chunked`` (pure XLA scan oracle)."""
    import os

    return os.environ.get("CRT_ACCEL", "auto")


# auto: tables with at least this many chunks route to the per-ray accel:
# on the 2015-chunk colonnade a 2048-ray tile's union visits 20-60x a single
# ray's chunks once bounces diverge, while the 58-chunk sphereflake's
# coherent tiles share chunk loads (the per-ray gather re-reads rows per
# lane). The threshold was set on the previous accelerator; its re-check on
# the card is ROADMAP A4 (tools/bench_accel.py times both).
RAY_MIN_CHUNKS = 256


def _auto_mode(n_chunks: int) -> str:
    return "ray" if n_chunks >= RAY_MIN_CHUNKS else "packet"


def _safe_div(num, den, fallback):
    ok = jnp.abs(den) > 1e-20
    den_safe = jnp.where(ok, den, 1.0)
    return jnp.where(ok, num / den_safe, fallback)


def _in_range(t, tmin, tmax):
    return (t >= tmin) & (t <= tmax)


# ------------------------------------------------------------------ spheres
def sphere_ts(org, dirs, time, sph, tmin, tmax):
    """[R,S] hit parameter (inf = miss). Quadratic as in src/sphere.h:40-74,
    with the moving-sphere center lerped by ray time (src/sphere.h:83).

    Matmul formulation: every ray-sphere dot product expands into [R,3]@[3,S]
    contractions against per-sphere constants — the time-lerped center
    enters linearly (d.c(t) = d.c0 + time * d.(c1-c0)), so motion blur costs
    two extra matmuls instead of materializing an [R,S,3] center tensor.
    """
    dc = sph.c1 - sph.c0                                # [S,3]
    # d.center(t), org.center(t): [R,S] via matmuls
    d_c = jnp.einsum("rk,sk->rs", dirs, sph.c0, precision="highest") + time[:, None] * jnp.einsum(
        "rk,sk->rs", dirs, dc, precision="highest")
    o_c = jnp.einsum("rk,sk->rs", org, sph.c0, precision="highest") + time[:, None] * jnp.einsum(
        "rk,sk->rs", org, dc, precision="highest")
    # |center(t)|^2: per-sphere quadratic in time
    c0c0 = vm.dot(sph.c0, sph.c0)                       # [S]
    c0dc = vm.dot(sph.c0, dc)
    dcdc = vm.dot(dc, dc)
    cc = (c0c0[None, :] + 2.0 * time[:, None] * c0dc[None, :]
          + (time * time)[:, None] * dcdc[None, :])    # [R,S]

    a = vm.dot(dirs, dirs)[:, None]                     # [R,1]
    oo = vm.dot(org, org)[:, None]                      # [R,1]
    b = 2.0 * (jnp.einsum("rk,rk->r", dirs, org, precision="highest")[:, None] - d_c)
    # NOTE: the expanded |o-c|^2 = oo - 2 o.c + |c|^2 cancels catastrophically
    # in f32 when |center| >> radius (scene coordinates beyond ~1e3 with unit
    # spheres); the catalog's coordinate ranges are safe. For far-from-origin
    # scenes, recenter geometry at build time.
    c = oo - 2.0 * o_c + cc - (sph.rad * sph.rad)[None, :]
    disc = b * b - 4.0 * a * c
    has = disc > 0.0
    sqrtd = jnp.sqrt(jnp.where(has, disc, 1.0))         # double-where: AD-safe at disc<=0
    t0 = (-b - sqrtd) / (2.0 * a)
    t1 = (-b + sqrtd) / (2.0 * a)
    t = jnp.where(_in_range(t0, tmin, tmax), t0,
                  jnp.where(_in_range(t1, tmin, tmax), t1, INF))
    return jnp.where(has & sph.active[None, :], t, INF)


def sphere_uv(n):
    """Spherical UV from the unit outward normal (src/sphere.h:90-95).

    AD-safe (double-where): arccos has an infinite derivative at +-1 and
    arctan2 undefined partials at (0, 0); the geometry-gradient path
    (geo_sph_* in models/diff.py) reverse-differentiates this on lanes the
    winner-replay later masks, and a masked lane's 0-cotangent times an
    inf partial is NaN, which scatter-add then spreads into the whole
    table gradient. Guarded branches substitute constants, so values are
    bitwise unchanged everywhere (arccos(+-1) and arctan2(0, 0) + pi are
    reproduced exactly)."""
    y = jnp.clip(-n[..., 1], -1.0, 1.0)
    mid = jnp.abs(y) < 1.0
    theta = jnp.where(mid, jnp.arccos(jnp.where(mid, y, 0.0)),
                      jnp.where(y >= 1.0, 0.0, PI))
    nz, nx = -n[..., 2], n[..., 0]
    deg = (nz == 0.0) & (nx == 0.0)  # arctan2(0, 0) == 0 in IEEE
    phi = jnp.where(deg, 0.0,
                    jnp.arctan2(jnp.where(deg, 0.0, nz),
                                jnp.where(deg, 1.0, nx))) + PI
    return phi / (2.0 * PI), theta / PI


def sphere_shading(org, dirs, time, sph, idx, t):
    """Shading attrs for the winning sphere per ray. The outward normal uses
    the time-lerped center — fixing the reference's static-center bug
    (src/sphere.h:69, SURVEY.md appendix item 2)."""
    n = sph.c0.shape[0]
    oh = tbl.onehot(idx, n) if n <= tbl.MAX_ONEHOT else None
    c0 = tbl.take_rows(sph.c0, idx, oh)
    c1 = tbl.take_rows(sph.c1, idx, oh)
    center = c0 + time[:, None] * (c1 - c0)
    rad = tbl.take_rows(sph.rad, idx, oh)
    p = org + t[:, None] * dirs
    # eps 1e-12, NOT 1e-20: the div transpose computes -ct*num/denom^2, and
    # (1e-20)^2 underflows to 0 in f32, so masked lanes (gathered rad == 0
    # when the winner is another type) hit 0/0 = NaN in every geometry
    # gradient; (1e-12)^2 stays normal. Real radii are >> 1e-12, so the
    # forward is bitwise unchanged.
    outward = (p - center) / jnp.maximum(rad, 1e-12)[:, None]
    front = vm.dot(dirs, outward) < 0.0
    normal = jnp.where(front[:, None], outward, -outward)
    u, v = sphere_uv(outward)
    return p, normal, front, u, v, tbl.take_rows(sph.mat, idx, oh)


# ------------------------------------------------------------------ planar
def _planar_ts(org, dirs, corner, eu, ev, active, tmin, tmax, triangle: bool):
    """[R,N] hit parameter for planar primitives (quads src/quad.h:30-52;
    triangles by the same plane + edge-coefficient construction, equal to
    Moller-Trumbore's (t, b0, b1) up to fp rounding — src/triangle.h:8-15).

    Matmul formulation: the per-ray edge coefficients are scalar triple
    products, rewritten so every ray-dependent factor is a dot with a
    *per-primitive constant* vector:

        a = w.(q x ev) = q.(ev x w),   b = w.(eu x q) = q.(w x eu)

    with q = org + t*dirs - corner. Each q.X splits into org.X + t*(dirs.X)
    - corner.X, so the whole test is six [R,3]@[3,N] matmuls (org/dirs
    against unorm / ev x w / w x eu) plus [R,N] elementwise — no [R,N,3]
    intermediates (each contraction pins precision="highest": TF32 would
    keep ~3 digits).
    """
    n = vm.cross(eu, ev)                                # [N,3]
    unorm = vm.normalize(n)
    d_plane = vm.dot(unorm, corner)                     # [N]
    w = n / jnp.maximum(vm.dot(n, n), 1e-20)[:, None]   # [N,3]
    evw = vm.cross(ev, w)                               # [N,3]  a = q . evw
    weu = vm.cross(w, eu)                               # [N,3]  b = q . weu

    o_n = jnp.einsum("rk,nk->rn", org, unorm, precision="highest")
    d_n = jnp.einsum("rk,nk->rn", dirs, unorm, precision="highest")
    # finite sentinel for the intermediate arithmetic: an INF t here would
    # produce 0*inf = NaN *gradients* through a = o_a + t*d_a even on fully
    # masked lanes (the classic where-branch NaN leak)
    hit_plane = jnp.abs(d_n) > 1e-20
    t = jnp.where(hit_plane,
                  (d_plane[None, :] - o_n) / jnp.where(hit_plane, d_n, 1.0), BIG)

    o_a = jnp.einsum("rk,nk->rn", org, evw, precision="highest")
    d_a = jnp.einsum("rk,nk->rn", dirs, evw, precision="highest")
    c_a = vm.dot(corner, evw)[None, :]
    a = o_a + t * d_a - c_a

    o_b = jnp.einsum("rk,nk->rn", org, weu, precision="highest")
    d_b = jnp.einsum("rk,nk->rn", dirs, weu, precision="highest")
    c_b = vm.dot(corner, weu)[None, :]
    b = o_b + t * d_b - c_b

    if triangle:
        interior = (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
    else:
        interior = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    ok = hit_plane & _in_range(t, tmin, tmax) & interior & active[None, :]
    return jnp.where(ok, t, INF)


def quad_ts(org, dirs, qds, tmin, tmax):
    """[R,Q] hit parameter for planar quads (src/quad.h:30-52)."""
    return _planar_ts(org, dirs, qds.corner, qds.eu, qds.ev, qds.active,
                      tmin, tmax, triangle=False)


def quad_shading(org, dirs, qds, idx, t):
    n_tbl = qds.corner.shape[0]
    oh = tbl.onehot(idx, n_tbl) if n_tbl <= tbl.MAX_ONEHOT else None
    corner = tbl.take_rows(qds.corner, idx, oh)
    eu = tbl.take_rows(qds.eu, idx, oh)
    ev = tbl.take_rows(qds.ev, idx, oh)
    n = vm.cross(eu, ev)
    unorm = vm.normalize(n)
    p = org + t[:, None] * dirs
    q = p - corner
    w = n / jnp.maximum(vm.dot(n, n), 1e-20)[:, None]
    u = vm.dot(w, vm.cross(q, ev))
    v = vm.dot(w, vm.cross(eu, q))
    front = vm.dot(dirs, unorm) < 0.0
    normal = jnp.where(front[:, None], unorm, -unorm)
    return p, normal, front, u, v, tbl.take_rows(qds.mat, idx, oh)


# ------------------------------------------------------------------ triangles
def tri_ts(org, dirs, tri, tmin, tmax):
    """[R,T] triangle hit parameter. Same (t, b0, b1) as the reference's
    Moller-Trumbore (src/triangle.h:8-15,27-40) computed through the shared
    plane/edge-coefficient matmul path (see _planar_ts)."""
    return _planar_ts(org, dirs, tri.v0, tri.v1 - tri.v0, tri.v2 - tri.v0,
                      tri.active, tmin, tmax, triangle=True)


def tri_shading(org, dirs, tri, idx, t, attrs=None):
    """Shading attrs for the winning triangle. With ``attrs`` (TriAttrs,
    beyond-parity): barycentric-interpolated smooth normals and UVs;
    without: flat geometric normal, no UV (reference parity,
    src/triangle.h:27-40)."""
    n_tbl = tri.v0.shape[0]
    oh = tbl.onehot(idx, n_tbl) if n_tbl <= tbl.MAX_ONEHOT else None
    v0 = tbl.take_rows(tri.v0, idx, oh)
    e1 = tbl.take_rows(tri.v1, idx, oh) - v0
    e2 = tbl.take_rows(tri.v2, idx, oh) - v0
    outward = vm.normalize(vm.cross(e1, e2))            # flat geometric normal
    p = org + t[:, None] * dirs
    front = vm.dot(dirs, outward) < 0.0
    normal = jnp.where(front[:, None], outward, -outward)
    zero = jnp.zeros_like(t)
    mat = tbl.take_rows(tri.mat, idx, oh)
    if attrs is None:
        return p, normal, front, zero, zero, mat
    # barycentric (a, b) from the edge-coefficient construction (same math
    # as _planar_ts): a = q.(ev x w), b = q.(w x eu), q = p - v0
    n = vm.cross(e1, e2)
    w = n / jnp.maximum(vm.dot(n, n), 1e-20)[:, None]
    q = p - v0
    a = vm.dot(q, vm.cross(e2, w))
    b = vm.dot(q, vm.cross(w, e1))
    normal, u, v = interpolate_tri_attrs(attrs, idx, a, b, normal)
    return p, normal, front, u, v, mat


def interpolate_tri_attrs(attrs, pid, a, b, geo_normal):
    """(normal, u, v) from per-vertex attributes at barycentric (a, b).

    Smooth normals are flipped into the hemisphere of the face-forwarded
    geometric normal so shading stays consistent on back faces; triangles
    without supplied normals keep the flat geometric one.
    """
    n_tbl = attrs.smooth.shape[0]
    oh = tbl.onehot(pid, n_tbl) if n_tbl <= tbl.MAX_ONEHOT else None
    w0 = (1.0 - a - b)[:, None]
    ns = (w0 * tbl.take_rows(attrs.n0, pid, oh)
          + a[:, None] * tbl.take_rows(attrs.n1, pid, oh)
          + b[:, None] * tbl.take_rows(attrs.n2, pid, oh))
    ns = vm.normalize(ns)
    ns = jnp.where(vm.dot(ns, geo_normal)[:, None] < 0.0, -ns, ns)
    smooth = tbl.take_rows(attrs.smooth, pid, oh)
    normal = jnp.where(smooth[:, None], ns, geo_normal)
    uv = (w0 * tbl.take_rows(attrs.uv0, pid, oh)
          + a[:, None] * tbl.take_rows(attrs.uv1, pid, oh)
          + b[:, None] * tbl.take_rows(attrs.uv2, pid, oh))
    return normal, uv[:, 0], uv[:, 1]


# ------------------------------------------------------------------ volumes
def volume_sample(org, dirs, vols, tmin, t_surface, u_vol):
    """Stochastic volume hits clipped by the closest surface (src/volumne.h).

    Returns (t_v [R], vidx [R], valid [R]); ``u_vol`` is [R, V] uniforms, one
    per volume, replacing the reference's shared-state rand() draw.
    """
    # ray in each volume's object frame: row-vector times object->world
    # matrix; precision pinned like every geometry contraction (TF32 would
    # keep ~3 digits of the frame transform)
    rel = org[:, None, :] - vols.center[None, :, :]      # [R,V,3]
    ol = jnp.einsum("rvk,vkl->rvl", rel, vols.rot,
                    precision="highest")                 # R^T applied
    dl = jnp.einsum("rk,vkl->rvl", dirs, vols.rot, precision="highest")

    # entry/exit of the *line* (negative t allowed: the reference probes with
    # interval::universe first, src/volumne.h:21-22)
    # box boundary: slab test against [-half, half]
    ok = jnp.abs(dl) > 1e-12
    dl_safe = jnp.where(ok, dl, 1.0)
    lo = jnp.where(ok, (-vols.half[None] - ol) / dl_safe,
                   jnp.where(jnp.abs(ol) <= vols.half[None], -BIG, BIG))
    hi = jnp.where(ok, (vols.half[None] - ol) / dl_safe,
                   jnp.where(jnp.abs(ol) <= vols.half[None], BIG, -BIG))
    near = jnp.minimum(lo, hi)
    far = jnp.maximum(lo, hi)
    t1_box = jnp.max(near, axis=-1)
    t2_box = jnp.min(far, axis=-1)

    # sphere boundary: quadratic, both roots
    a = vm.dot(dirs, dirs)[:, None]
    b = 2.0 * vm.dot(dirs[:, None, :], rel)
    c = vm.dot(rel, rel) - (vols.half[..., 0] ** 2)[None, :]
    disc = b * b - 4.0 * a * c
    has = disc > 0.0
    sq = jnp.sqrt(jnp.where(has, disc, 1.0))
    t1_sph = jnp.where(has, (-b - sq) / (2.0 * a), BIG)
    t2_sph = jnp.where(has, (-b + sq) / (2.0 * a), -BIG)

    is_box = (vols.kind == 0)[None, :]
    t1 = jnp.where(is_box, t1_box, t1_sph)
    t2 = jnp.where(is_box, t2_box, t2_sph)

    # mesh boundary (VOL_MESH): probe every boundary triangle along the full
    # line (the reference's interval::universe probe, src/volumne.h:21-22);
    # the medium span is [min t, max t] over the volume's triangles — exact
    # for closed convex boundaries, the reference's own assumption. Static
    # branch: scenes without mesh volumes never build this graph.
    if vols.mesh_v0 is not None:
        ts_m = _planar_ts(org, dirs, vols.mesh_v0, vols.mesh_e1, vols.mesh_e2,
                          vols.mesh_active, -BIG, BIG, triangle=True)  # [R,MT]
        hit_m = jnp.isfinite(ts_m)
        n_v = vols.kind.shape[0]
        # [V,MT] ownership mask; the broadcasted [R,V,MT] min/max fuses into
        # the reduce (V is tiny) — no scatter, no per-row gather
        own = (vols.mesh_vid[None, :] == jnp.arange(n_v)[:, None])
        sel = own[None] & hit_m[:, None, :]                     # [R,V,MT]
        t1_mesh = jnp.min(jnp.where(sel, ts_m[:, None, :], BIG), axis=-1)
        t2_mesh = jnp.max(jnp.where(sel, ts_m[:, None, :], -BIG), axis=-1)
        is_mesh = (vols.kind == 2)[None, :]
        t1 = jnp.where(is_mesh, t1_mesh, t1)
        t2 = jnp.where(is_mesh, t2_mesh, t2)

    # clamp to [tmin, closest surface] (src/volumne.h:25-29)
    t1c = jnp.maximum(t1, tmin)
    t2c = jnp.minimum(t2, t_surface[:, None])
    span_ok = (t1c < t2c) & vols.active[None, :]

    dlen = vm.length(dirs)[:, None]
    dist_inside = (t2c - t1c) * dlen
    # -log(U)/rho scatter distance (src/volumne.h:36); U==0 -> +inf -> no hit
    hit_dist = vols.neg_inv_density[None, :] * jnp.log(jnp.maximum(u_vol, 1e-38))
    vhit = span_ok & (hit_dist <= dist_inside)
    t_v = jnp.where(vhit, t1c + hit_dist / dlen, INF)

    # min + argmin as two reductions (no take_along_axis row gather)
    vidx = jnp.argmin(t_v, axis=-1)
    t_best = jnp.min(t_v, axis=-1)
    return t_best, vidx, jnp.isfinite(t_best)


# ------------------------------------------------------------------ combined
def _sort_wanted(scene, n_rays: int) -> bool:
    """Static decision: coherence-sort the batch before intersecting?

    On for large chunked scenes (where the packet accelerator's per-tile
    cull needs coherent tiles to bite — ops/raysort.py docstring has the
    measured collapse) unless CRT_SORT=off; CRT_SORT=on forces it for any
    chunked scene."""
    import os

    mode = os.environ.get("CRT_SORT", "auto")
    if mode == "off" or scene.world_lo is None:
        return False
    ks = [c.corner.shape[0] if hasattr(c, "corner") else c.rad.shape[0]
          for c in (scene.sphere_chunks, scene.quad_chunks, scene.tri_chunks)
          if c is not None]
    kmax = max(ks, default=0)
    if mode == "on":
        return kmax > 0
    accel = accel_mode()
    if accel == "auto":
        accel = _auto_mode(kmax)
    if accel == "ray":
        # per-ray visit lists don't share traversal across a tile, so
        # coherence-sorting the batch buys nothing on the ray accel
        return False
    from cpu_ray_tracing_implementation_tpu.ops import raysort

    return kmax >= raysort.MIN_CHUNKS and n_rays >= raysort.MIN_RAYS


def _packet_cap(scene, org, dirs, active, tmax, tmin):
    """Per-ray traversal cap for the packet accelerator: a ray's closest
    hit cannot lie beyond its exit from the scene AABB, so miss rays stop
    tightening tiles at their world exit instead of riding t=inf through
    every chunk; terminated lanes (``active``=False) get cap=tmin — their
    tiles' front-to-back loop exits after zero visits. A pure bound: wrapped
    in stop_gradient, and every true hit is strictly inside it."""
    cap = jnp.broadcast_to(jnp.asarray(tmax, org.dtype), org.shape[:1])
    if scene.world_lo is not None:
        lo = jnp.asarray(scene.world_lo, org.dtype)
        hi = jnp.asarray(scene.world_hi, org.dtype)
        inv = 1.0 / jnp.where(jnp.abs(dirs) > 1e-20, dirs, 1e-20)
        t0 = (lo[None, :] - org) * inv
        t1 = (hi[None, :] - org) * inv
        far = jnp.min(jnp.maximum(t0, t1), axis=-1)
        cap = jnp.minimum(jnp.maximum(far, tmin) * 1.0001 + 1e-3, cap)
    if active is not None:
        cap = jnp.where(active, cap, tmin)
    return jax.lax.stop_gradient(cap)


def intersect_brute(scene, org, dirs, time, tmin, u_vol, tmax=INF,
                    active=None):
    """Closest hit across all primitive tables -> Hit. ``u_vol``: [R, V].

    Large chunked scenes are intersected in coherence-sorted lane order
    (sorted by origin-Morton/direction-octant key, results restored to the
    caller's order — ops/raysort.py) so the packet accelerator's per-tile
    culling survives post-bounce ray divergence. ``active``: optional [R]
    mask of lanes whose result matters — dead lanes sort to the tail and
    traverse nothing (the wavefront-compaction equivalent for fixed shapes).
    """
    if not _sort_wanted(scene, org.shape[0]):
        return _intersect_core(scene, org, dirs, time, tmin, u_vol, tmax,
                               active)
    from cpu_ray_tracing_implementation_tpu.ops import raysort

    lo = jnp.asarray(scene.world_lo, org.dtype)
    hi = jnp.asarray(scene.world_hi, org.dtype)
    keys = raysort.coherence_keys(org, dirs, lo, hi)
    if active is not None:
        # dead lanes to the tail: their whole tiles then exit immediately
        keys = jnp.where(active, keys, jnp.int32(0x40000000))
    ins = [org, dirs, time]
    if u_vol.shape[1]:
        ins.append(u_vol)
    tmax_arr = jnp.ndim(tmax) == 1
    if tmax_arr:
        ins.append(tmax)
    if active is not None:
        ins.append(active.astype(jnp.int32))
    sorted_ins, lane_ids = raysort.sort_rays(keys, ins)
    s_org, s_dirs, s_time = sorted_ins[:3]
    pos = 3
    s_u = u_vol
    if u_vol.shape[1]:
        s_u = sorted_ins[pos]
        pos += 1
    s_tmax = tmax
    if tmax_arr:
        s_tmax = sorted_ins[pos]
        pos += 1
    s_active = None
    if active is not None:
        s_active = sorted_ins[pos].astype(bool)
    h = _intersect_core(scene, s_org, s_dirs, s_time, tmin, s_u, s_tmax,
                        s_active)
    valid, t, p, normal, front, uu, vv, mat = raysort.unsort(
        lane_ids, [h.valid, h.t, h.p, h.normal, h.front, h.u, h.v, h.mat])
    return Hit(valid=valid, t=t, p=p, normal=normal, front=front,
               u=uu, v=vv, mat=mat)


def _intersect_core(scene, org, dirs, time, tmin, u_vol, tmax=INF,
                    active=None):
    """Closest hit in the caller's lane order (see intersect_brute).

    ``scene.counts`` is static, so primitive types the scene doesn't contain
    never enter the XLA graph (an empty table is padded to one inactive row
    that would otherwise cost a full [R,1] pass per type).
    """
    n_sph, n_quad, n_tri, n_vol = scene.counts
    R = org.shape[0]

    def best(ts):
        # two reductions, no take_along_axis row gather
        return jnp.min(ts, axis=-1), jnp.argmin(ts, axis=-1)

    inf_t = jnp.full((R,), INF, org.dtype)
    zero_i = jnp.zeros((R,), jnp.int32)

    sph_payload = quad_payload = tri_payload = None
    i_s = i_q = i_t = zero_i
    if scene.sphere_chunks is not None:
        from cpu_ray_tracing_implementation_tpu.ops import bvh as bvh_mod
        from cpu_ray_tracing_implementation_tpu.ops import packet as pkt

        mode = accel_mode()
        if mode == "auto":
            mode = _auto_mode(scene.sphere_chunks.rad.shape[0])
        if mode == "ray":
            from cpu_ray_tracing_implementation_tpu.ops import perray
            t_s, sph_payload = perray.sphere_closest_ray(
                org, dirs, time, scene.sphere_chunks, tmin,
                _packet_cap(scene, org, dirs, active, tmax, tmin))
        elif mode == "packet":
            t_s, sph_payload = pkt.sphere_closest_accel(
                org, dirs, time, scene.sphere_chunks, tmin,
                _packet_cap(scene, org, dirs, active, tmax, tmin))
        elif mode == "bvh" and scene.sphere_tree is not None:
            t_s, sph_payload = bvh_mod.sphere_closest_accel(
                org, dirs, time, scene.sphere_chunks, scene.sphere_tree,
                tmin, tmax)
        else:
            t_s, sph_payload = chunked.sphere_closest(
                org, dirs, time, scene.sphere_chunks, tmin, tmax=tmax)
    elif n_sph:
        t_s, i_s = best(sphere_ts(org, dirs, time, scene.spheres, tmin, tmax))
    else:
        t_s = inf_t
    def planar_path(chs, tree, tri_flag):
        """Accelerator routing for a chunked planar table. Default (auto) is
        per-ray visit lists for large tables and tile-packet culling for
        the rest (_auto_mode); CRT_ACCEL selects bvh (per-ray traversal
        oracle) or chunked (scan-everything oracle). All share the
        contract and carry the winning primitive id."""
        from cpu_ray_tracing_implementation_tpu.ops import bvh as bvh_mod
        from cpu_ray_tracing_implementation_tpu.ops import packet as pkt

        mode = accel_mode()
        if mode == "auto":
            mode = _auto_mode(chs.corner.shape[0])
        if mode == "ray":
            from cpu_ray_tracing_implementation_tpu.ops import perray
            return perray.planar_closest_ray(
                org, dirs, chs, tmin, tri_flag,
                _packet_cap(scene, org, dirs, active, tmax, tmin))
        if mode == "packet":
            return pkt.planar_closest_accel(
                org, dirs, chs, tmin, tri_flag,
                _packet_cap(scene, org, dirs, active, tmax, tmin))
        if mode == "bvh" and tree is not None:
            return bvh_mod.planar_closest_accel(org, dirs, chs, tree, tmin,
                                                tri_flag, tmax)
        return chunked.planar_closest(org, dirs, chs, tmin, triangle=tri_flag,
                                      tmax=tmax)

    if scene.quad_chunks is not None:
        t_q, quad_payload = planar_path(scene.quad_chunks, scene.quad_tree,
                                        False)
    elif n_quad:
        t_q, i_q = best(quad_ts(org, dirs, scene.quads, tmin, tmax))
    else:
        t_q = inf_t
    if scene.tri_chunks is not None:
        t_t, tri_payload = planar_path(scene.tri_chunks, scene.tri_tree, True)
    elif n_tri:
        t_t, i_t = best(tri_ts(org, dirs, scene.tris, tmin, tmax))
    else:
        t_t = inf_t

    t_surface = jnp.minimum(jnp.minimum(t_s, t_q), t_t)
    if n_vol:
        t_v, i_v, v_valid = volume_sample(org, dirs, scene.volumes, tmin,
                                          t_surface, u_vol)
    else:
        t_v, i_v = inf_t, zero_i

    t_all = jnp.stack([t_s, t_q, t_t, t_v], axis=-1)    # [R,4]
    which = jnp.argmin(t_all, axis=-1)                  # 0 sph, 1 quad, 2 tri, 3 vol
    t = jnp.min(t_all, axis=-1)
    valid = jnp.isfinite(t)

    # shading attributes: (p, normal, front, u, v, mat) per present type,
    # merged by masked select over the winning type
    p = org + jnp.where(valid, t, 0.0)[:, None] * dirs
    normal = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], org.dtype), org.shape)
    front = jnp.ones((R,), bool)
    uu = jnp.zeros((R,), org.dtype)
    vv = jnp.zeros((R,), org.dtype)
    mat = jnp.zeros((R,), jnp.int32)

    def merge(cond, attrs):
        nonlocal normal, front, uu, vv, mat
        p_k, n_k, f_k, u_k, v_k, m_k = attrs
        c3 = cond[:, None]
        normal = jnp.where(c3, n_k, normal)
        front = jnp.where(cond, f_k, front)
        uu = jnp.where(cond, u_k, uu)
        vv = jnp.where(cond, v_k, vv)
        mat = jnp.where(cond, m_k, mat)

    def planar_attrs(payload, t_k, zero_uv=False, tri_attrs=None):
        """(p, normal, front, u, v, mat) from a chunked planar payload.
        ``zero_uv``: triangles carry no UV in the reference (src/triangle.h),
        matching the dense tri_shading path. ``tri_attrs``: per-vertex
        attribute table (beyond parity) — interpolated at the payload's
        barycentric (u, v) via the winning primitive id."""
        unorm, u_k, v_k, m_k, pid_k = payload
        pk = org + jnp.where(jnp.isfinite(t_k), t_k, 0.0)[:, None] * dirs
        front_k = vm.dot(dirs, unorm) < 0.0
        normal_k = jnp.where(front_k[:, None], unorm, -unorm)
        if tri_attrs is not None:
            normal_k, u_k, v_k = interpolate_tri_attrs(
                tri_attrs, pid_k, u_k, v_k, normal_k)
        elif zero_uv:
            u_k = jnp.zeros_like(u_k)
            v_k = jnp.zeros_like(v_k)
        return pk, normal_k, front_k, u_k, v_k, m_k

    if sph_payload is not None:
        center, rad_w, m_w = sph_payload[:3]
        pk = org + jnp.where(jnp.isfinite(t_s), t_s, 0.0)[:, None] * dirs
        outward = (pk - center) / rad_w[:, None]
        front_k = vm.dot(dirs, outward) < 0.0
        normal_k = jnp.where(front_k[:, None], outward, -outward)
        u_k, v_k = sphere_uv(outward)
        merge(which == 0, (pk, normal_k, front_k, u_k, v_k, m_w))
    elif n_sph:
        merge(which == 0, sphere_shading(org, dirs, time, scene.spheres, i_s,
                                         jnp.where(jnp.isfinite(t_s), t_s, 0.0)))
    if quad_payload is not None:
        merge(which == 1, planar_attrs(quad_payload, t_q))
    elif n_quad:
        merge(which == 1, quad_shading(org, dirs, scene.quads, i_q,
                                       jnp.where(jnp.isfinite(t_q), t_q, 0.0)))
    if tri_payload is not None:
        merge(which == 2, planar_attrs(tri_payload, t_t, zero_uv=True,
                                       tri_attrs=scene.tri_attrs))
    elif n_tri:
        merge(which == 2, tri_shading(org, dirs, scene.tris, i_t,
                                      jnp.where(jnp.isfinite(t_t), t_t, 0.0),
                                      attrs=scene.tri_attrs))
    if n_vol:
        # volume record: arbitrary normal/front_face (src/volumne.h:42-43)
        m_v = tbl.take_rows(scene.volumes.mat, i_v)
        cond = which == 3
        mat = jnp.where(cond, m_v, mat)

    return Hit(valid=valid, t=t, p=p, normal=normal, front=front, u=uu, v=vv,
               mat=jnp.where(valid, mat, 0))
