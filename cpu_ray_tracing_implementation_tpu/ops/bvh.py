"""Device-side per-ray BVH traversal (stackless / threaded).

Counterpart of the reference's recursive BVH descent
(reference src/bvh_node.h:49-58 + the aabb slab test src/aabb.h:28-33):
pointer-chasing recursion becomes a ``lax.while_loop`` that steps a whole
ray batch in lockstep, with the per-ray traversal state reduced to ONE
integer by threading the tree with hit/miss links (utils/accel.threaded_links):

    next = aabb_hit ? hit_link[node] : miss_link[node]

 - hit_link descends (node+1, DFS order) for internal nodes; for leaves it
   equals the skip link (the leaf's primitives are tested in-line first);
 - miss_link is the skip link — the next subtree in DFS order;
 - the loop ends when every ray reaches the sentinel (== n_nodes).

Per iteration each ray gathers one 64-byte node row and (masked) its leaf's
<= max_leaf primitive rows — O(nodes visited) work per ray instead of the
chunk scan's O(all chunks) (ops/chunked.py).

Lockstep traversal runs the MAX visit count over the batch while the mean is
far lower (tools/bvh_stats.py counts both), so this is kept as the
algorithmic oracle (CRT_ACCEL=bvh), not the production accelerator: that is
the per-ray visit lists (ops/perray.py) and the tile-packet culling
(ops/packet.py), which get the same interval-tightened pruning
(src/bvh_node.h:53-57) out of dense math. Its speed on the card is not
measured (ROADMAP A1).

The closest-hit t tightens during traversal (near <= t_best slab bound) —
the same pruning the reference gets from its right-subtree interval clamp.
Traversal order is fixed DFS (no near-child-first), so pruning is somewhat
weaker per visit but needs no per-ray stack.

Differentiability: forward-only traversal + custom VJP whose backward runs
the XLA chunk scan — renders never pay it, gradient paths stay exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cpu_ray_tracing_implementation_tpu.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu.utils import accel
from cpu_ray_tracing_implementation_tpu.utils import pytree

INF = jnp.inf
BIG = 1e30

# node pack rows ([N,16] float32; ints exact below 2^24)
NODE_LO = 0       # 0:3 aabb lo
NODE_HI = 3       # 3:6 aabb hi
NODE_HIT = 6      # hit link
NODE_MISS = 7     # miss link
NODE_FIRST = 8    # leaf: first primitive row in prim_pack
NODE_COUNT = 9    # leaf: primitive count (0 = internal)
NODE_ROWS = 16

# primitive constant pack rows, planar ([P, NROWS] f32)
ROW_UNORM = 0     # 0:3   plane unit normal
ROW_EVW = 3       # 3:6   ev x w   (a = q . evw)
ROW_WEU = 6       # 6:9   w x eu   (b = q . weu)
ROW_DPLANE = 9    # unorm . corner
ROW_CA = 10       # corner . evw
ROW_CB = 11       # corner . weu
ROW_ACTIVE = 12   # 1.0 / 0.0
ROW_MAT = 13      # material id as f32
NROWS = 16        # padded

# primitive constant pack rows, spheres
SROW_C0 = 0       # 0:3
SROW_DC = 3       # 3:6  c1 - c0 (motion)
SROW_C0C0 = 6
SROW_C0DC = 7
SROW_DCDC = 8
SROW_RAD2 = 9
SROW_RAD = 10
SROW_ACTIVE = 11
SROW_MAT = 12
SNROWS = 16

# spare prim-pack row carrying the global (chunk-order) primitive index —
# shared by the planar (ROW_*) and sphere (SROW_*) layouts, which both
# leave rows 14-15 unused
ROW_PID = 14


@pytree.dataclass
class BVHTree:
    """Threaded BVH + flat primitive constants, both gather-addressable.

    ``prim_pack`` rows follow the constant layout above
    (ROW_* for planar, SROW_* for spheres) in BVH depth-first order —
    the same order as the chunk tables, so leaf_first indexes agree.
    """
    node_pack: jnp.ndarray  # [N, 16] f32
    prim_pack: jnp.ndarray  # [P + max_leaf, NROWS] f32 (tail rows inactive)
    max_leaf: int = pytree.static_field(default=8)


def pack_prim_constants(chunks: ch.PlanarChunks) -> jnp.ndarray:
    """[K, NROWS, C] constant pack from chunk-major planar tables."""
    corner, eu, ev = chunks.corner, chunks.eu, chunks.ev      # [K,C,3]
    n = vm.cross(eu, ev)
    unorm = vm.normalize(n)
    w = n / jnp.maximum(vm.dot(n, n), 1e-20)[..., None]
    evw = vm.cross(ev, w)
    weu = vm.cross(w, eu)
    K, C = corner.shape[0], corner.shape[1]
    pack = jnp.zeros((K, NROWS, C), jnp.float32)
    pack = pack.at[:, ROW_UNORM:ROW_UNORM + 3].set(jnp.swapaxes(unorm, 1, 2))
    pack = pack.at[:, ROW_EVW:ROW_EVW + 3].set(jnp.swapaxes(evw, 1, 2))
    pack = pack.at[:, ROW_WEU:ROW_WEU + 3].set(jnp.swapaxes(weu, 1, 2))
    pack = pack.at[:, ROW_DPLANE].set(vm.dot(unorm, corner))
    pack = pack.at[:, ROW_CA].set(vm.dot(corner, evw))
    pack = pack.at[:, ROW_CB].set(vm.dot(corner, weu))
    pack = pack.at[:, ROW_ACTIVE].set(chunks.active.astype(jnp.float32))
    pack = pack.at[:, ROW_MAT].set(chunks.mat.astype(jnp.float32))
    return pack


def pack_sphere_constants(chunks: ch.SphereChunks) -> jnp.ndarray:
    """[K, SNROWS, C] constant pack from chunk-major sphere tables."""
    c0, c1, rad = chunks.c0, chunks.c1, chunks.rad      # [K,C,3], [K,C]
    dc = c1 - c0
    K, C = rad.shape
    pack = jnp.zeros((K, SNROWS, C), jnp.float32)
    pack = pack.at[:, SROW_C0:SROW_C0 + 3].set(jnp.swapaxes(c0, 1, 2))
    pack = pack.at[:, SROW_DC:SROW_DC + 3].set(jnp.swapaxes(dc, 1, 2))
    pack = pack.at[:, SROW_C0C0].set(vm.dot(c0, c0))
    pack = pack.at[:, SROW_C0DC].set(vm.dot(c0, dc))
    pack = pack.at[:, SROW_DCDC].set(vm.dot(dc, dc))
    pack = pack.at[:, SROW_RAD2].set(rad * rad)
    pack = pack.at[:, SROW_RAD].set(rad)
    pack = pack.at[:, SROW_ACTIVE].set(chunks.active.astype(jnp.float32))
    pack = pack.at[:, SROW_MAT].set(chunks.mat.astype(jnp.float32))
    return pack


def build_tree(nodes: np.ndarray, prim_pack: jnp.ndarray,
               max_leaf: int) -> BVHTree:
    """Assemble the device tree from the native builder's node array
    (native/bvh_builder.cc layout) and a [P, NROWS] primitive constant pack
    in the same (BVH depth-first) primitive order."""
    n = len(nodes)
    hit_link, miss_link, leaf_first, leaf_count = accel.threaded_links(nodes)
    pack = np.zeros((n, NODE_ROWS), np.float32)
    pack[:, NODE_LO:NODE_LO + 3] = nodes[:, 0:3]
    pack[:, NODE_HI:NODE_HI + 3] = nodes[:, 3:6]
    pack[:, NODE_HIT] = hit_link
    pack[:, NODE_MISS] = miss_link
    pack[:, NODE_FIRST] = leaf_first
    pack[:, NODE_COUNT] = leaf_count
    nrows = prim_pack.shape[1]
    # global primitive id (chunk-order index) in the shared spare row — the
    # payload uses it to gather per-vertex attributes (smooth normals/UVs)
    prim_pack = prim_pack.at[:, ROW_PID].set(
        jnp.arange(prim_pack.shape[0], dtype=jnp.float32))
    padded = jnp.concatenate(
        [prim_pack, jnp.zeros((max_leaf, nrows), prim_pack.dtype)], axis=0)
    return BVHTree(node_pack=jnp.asarray(pack), prim_pack=padded,
                   max_leaf=int(max_leaf))


def flatten_chunk_pack(pack: jnp.ndarray) -> jnp.ndarray:
    """[K, NROWS, C] chunk-major constant pack -> [K*C, NROWS] row-gatherable."""
    k, nrows, c = pack.shape
    return jnp.transpose(pack, (0, 2, 1)).reshape(k * c, nrows)


def _slab(org, dirs, lo, hi, tmin, t_best):
    """Per-ray AABB slab test bounded by the running closest hit
    (src/aabb.h:28-33 semantics, near/far fold over axes)."""
    inv = 1.0 / jnp.where(jnp.abs(dirs) > 1e-20, dirs, 1e-20)
    t0 = (lo - org) * inv
    t1 = (hi - org) * inv
    near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (near <= far) & (far >= tmin) & (near <= t_best)


def _traverse(org, dirs, tree: BVHTree, tmin, tmax, leaf_fn, payload_init):
    """Shared traversal loop. ``leaf_fn(row, lane_ok, t_best, payload)``
    evaluates one gathered primitive row [R, NROWS] against all rays and
    returns (t_best, payload) updated where it beat the running hit."""
    R = org.shape[0]
    n_nodes = tree.node_pack.shape[0]
    t_init = jnp.minimum(jnp.full((R,), INF, org.dtype), tmax)

    def cond(state):
        it, node, _, _ = state
        return jnp.any(node < n_nodes) & (it < n_nodes + 1)

    def body(state):
        it, node, t_best, payload = state
        alive = node < n_nodes
        row = jnp.take(tree.node_pack, node, axis=0, mode="clip")  # [R,16]
        lo = row[:, NODE_LO:NODE_LO + 3]
        hi = row[:, NODE_HI:NODE_HI + 3]
        hit_box = alive & _slab(org, dirs, lo, hi, tmin, t_best)
        count = row[:, NODE_COUNT].astype(jnp.int32)
        first = row[:, NODE_FIRST].astype(jnp.int32)
        at_leaf = hit_box & (count > 0)

        for j in range(tree.max_leaf):
            prow = jnp.take(tree.prim_pack, first + j, axis=0, mode="clip")
            lane_ok = at_leaf & (j < count)
            t_best, payload = leaf_fn(prow, lane_ok, t_best, payload)

        nxt = jnp.where(hit_box, row[:, NODE_HIT], row[:, NODE_MISS])
        node = jnp.where(alive, nxt.astype(jnp.int32), n_nodes)
        return it + 1, node, t_best, payload

    state = (jnp.int32(0), jnp.zeros((R,), jnp.int32), t_init, payload_init)
    _, _, t, payload = jax.lax.while_loop(cond, body, state)
    return jnp.where(t < t_init, t, INF), payload


# ---------------------------------------------------------------- planar
def planar_closest_bvh(org, dirs, tree: BVHTree, tmin, triangle: bool,
                       tmax=INF):
    """Closest planar hit by traversal. Same contract as
    ops.chunked.planar_closest: (t [R], (unorm [R,3], u [R], v [R], mat [R]))."""
    R = org.shape[0]
    f32 = org.dtype

    def leaf_fn(row, lane_ok, t_best, payload):
        n_b, u_b, v_b, m_b, p_b = payload
        unorm = row[:, ROW_UNORM:ROW_UNORM + 3]
        evw = row[:, ROW_EVW:ROW_EVW + 3]
        weu = row[:, ROW_WEU:ROW_WEU + 3]
        d_plane = row[:, ROW_DPLANE]
        c_a = row[:, ROW_CA]
        c_b = row[:, ROW_CB]
        active = row[:, ROW_ACTIVE] > 0.5
        mat = row[:, ROW_MAT]

        d_n = jnp.sum(dirs * unorm, axis=-1)
        o_n = jnp.sum(org * unorm, axis=-1)
        ok0 = jnp.abs(d_n) > 1e-20
        t = jnp.where(ok0, (d_plane - o_n) / jnp.where(ok0, d_n, 1.0), BIG)
        a = jnp.clip(jnp.sum(org * evw, axis=-1)
                     + t * jnp.sum(dirs * evw, axis=-1) - c_a, -BIG, BIG)
        b = jnp.clip(jnp.sum(org * weu, axis=-1)
                     + t * jnp.sum(dirs * weu, axis=-1) - c_b, -BIG, BIG)
        if triangle:
            interior = (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
        else:
            interior = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
        better = (lane_ok & active & ok0 & interior
                  & (t >= tmin) & (t < t_best))
        return (jnp.where(better, t, t_best),
                (jnp.where(better[:, None], unorm, n_b),
                 jnp.where(better, a, u_b),
                 jnp.where(better, b, v_b),
                 jnp.where(better, mat, m_b),
                 jnp.where(better, row[:, ROW_PID], p_b)))

    payload0 = (jnp.zeros((R, 3), f32), jnp.zeros((R,), f32),
                jnp.zeros((R,), f32), jnp.zeros((R,), f32),
                jnp.zeros((R,), f32))
    t, (n, u, v, m, p) = _traverse(org, dirs, tree, tmin, tmax, leaf_fn,
                                   payload0)
    return t, (n, u, v, jnp.round(m).astype(jnp.int32),
               jnp.round(p).astype(jnp.int32))


# ---------------------------------------------------------------- spheres
def sphere_closest_bvh(org, dirs, time, tree: BVHTree, tmin, tmax=INF):
    """Closest sphere hit by traversal. Same contract as
    ops.chunked.sphere_closest: (t [R], (center_at_t [R,3], rad [R],
    mat [R], pid [R]))."""
    R = org.shape[0]
    f32 = org.dtype
    a_q = jnp.sum(dirs * dirs, axis=-1)          # quadratic coeffs, ray-only
    oo = jnp.sum(org * org, axis=-1)
    do = jnp.sum(dirs * org, axis=-1)
    a_safe = jnp.maximum(a_q, 1e-20)

    def leaf_fn(row, lane_ok, t_best, payload):
        ctr_b, rad_b, m_b, p_b = payload
        c0 = row[:, SROW_C0:SROW_C0 + 3]
        dc = row[:, SROW_DC:SROW_DC + 3]
        c0c0 = row[:, SROW_C0C0]
        c0dc = row[:, SROW_C0DC]
        dcdc = row[:, SROW_DCDC]
        rad2 = row[:, SROW_RAD2]
        rad = row[:, SROW_RAD]
        active = row[:, SROW_ACTIVE] > 0.5
        mat = row[:, SROW_MAT]

        d_c = jnp.sum(dirs * c0, axis=-1) + time * jnp.sum(dirs * dc, axis=-1)
        o_c = jnp.sum(org * c0, axis=-1) + time * jnp.sum(org * dc, axis=-1)
        cc = c0c0 + 2.0 * time * c0dc + time * time * dcdc
        b = 2.0 * (do - d_c)
        c = oo - 2.0 * o_c + cc - rad2
        disc = b * b - 4.0 * a_q * c
        has = disc > 0.0
        sqrtd = jnp.sqrt(jnp.where(has, disc, 1.0))
        t0 = (-b - sqrtd) / (2.0 * a_safe)
        t1 = (-b + sqrtd) / (2.0 * a_safe)
        in0 = (t0 >= tmin) & (t0 < t_best)
        in1 = (t1 >= tmin) & (t1 < t_best)
        t = jnp.where(in0, t0, jnp.where(in1, t1, BIG))
        better = lane_ok & active & has & (in0 | in1) & (t < t_best)
        ctr = c0 + time[:, None] * dc
        return (jnp.where(better, t, t_best),
                (jnp.where(better[:, None], ctr, ctr_b),
                 jnp.where(better, jnp.maximum(rad, 1e-20), rad_b),
                 jnp.where(better, mat, m_b),
                 jnp.where(better, row[:, ROW_PID], p_b)))

    payload0 = (jnp.zeros((R, 3), f32), jnp.ones((R,), f32),
                jnp.zeros((R,), f32), jnp.zeros((R,), f32))
    t, (ctr, rad, m, p) = _traverse(org, dirs, tree, tmin, tmax, leaf_fn,
                                    payload0)
    return t, (ctr, rad, jnp.round(m).astype(jnp.int32),
               jnp.round(p).astype(jnp.int32))


def traversal_stats(org, dirs, tree: BVHTree, tmin, tmax=INF):
    """Diagnostics: (iterations, node_visits [R], leaf_visits [R]) of a
    traversal that skips leaf evaluation (so no t tightening — an upper
    bound on visit counts). Drives the lockstep-waste analysis."""
    R = org.shape[0]
    n_nodes = tree.node_pack.shape[0]
    t_best = jnp.minimum(jnp.full((R,), INF, org.dtype), tmax)

    def cond(state):
        it, node, _, _ = state
        return jnp.any(node < n_nodes) & (it < n_nodes + 1)

    def body(state):
        it, node, nv, lv = state
        alive = node < n_nodes
        row = jnp.take(tree.node_pack, node, axis=0, mode="clip")
        hit_box = alive & _slab(org, dirs, row[:, NODE_LO:NODE_LO + 3],
                                row[:, NODE_HI:NODE_HI + 3], tmin, t_best)
        count = row[:, NODE_COUNT].astype(jnp.int32)
        nxt = jnp.where(hit_box, row[:, NODE_HIT], row[:, NODE_MISS])
        return (it + 1, jnp.where(alive, nxt.astype(jnp.int32), n_nodes),
                nv + alive.astype(jnp.int32),
                lv + (hit_box & (count > 0)).astype(jnp.int32))

    z = jnp.zeros((R,), jnp.int32)
    it, _, nv, lv = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros((R,), jnp.int32), z, z))
    return it, nv, lv


# ------------------------------------------------------------- autodiff glue
@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6))
def planar_closest_accel(org, dirs, chunks, tree, tmin, triangle, tmax=INF):
    """BVH-traversal forward + XLA chunk-scan backward: differentiable
    drop-in for ops.chunked.planar_closest on large scenes. ``chunks`` is
    the same primitive set in chunk-major form (the backward oracle);
    ``tree`` carries no gradients."""
    return planar_closest_bvh(org, dirs, tree, tmin, triangle, tmax=tmax)


def _planar_fwd(org, dirs, chunks, tree, tmin, triangle, tmax):
    out = planar_closest_bvh(org, dirs, tree, tmin, triangle, tmax=tmax)
    return out, (org, dirs, chunks, tree)


def _planar_bwd(tmin, triangle, tmax, res, ct):
    org, dirs, chunks, tree = res
    _, vjp = jax.vjp(
        lambda o, d, c: ch.planar_closest(o, d, c, tmin, triangle, tmax=tmax),
        org, dirs, chunks)
    d_org, d_dirs, d_chunks = vjp(ct)
    d_tree = jax.tree.map(jnp.zeros_like, tree)
    return d_org, d_dirs, d_chunks, d_tree


planar_closest_accel.defvjp(_planar_fwd, _planar_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6))
def sphere_closest_accel(org, dirs, time, chunks, tree, tmin, tmax=INF):
    """BVH-traversal forward + XLA chunk-scan backward for spheres."""
    return sphere_closest_bvh(org, dirs, time, tree, tmin, tmax=tmax)


def _sphere_fwd(org, dirs, time, chunks, tree, tmin, tmax):
    out = sphere_closest_bvh(org, dirs, time, tree, tmin, tmax=tmax)
    return out, (org, dirs, time, chunks, tree)


def _sphere_bwd(tmin, tmax, res, ct):
    org, dirs, time, chunks, tree = res
    _, vjp = jax.vjp(
        lambda o, d, tm, c: ch.sphere_closest(o, d, tm, c, tmin, tmax=tmax),
        org, dirs, time, chunks)
    d_org, d_dirs, d_time, d_chunks = vjp(ct)
    d_tree = jax.tree.map(jnp.zeros_like, tree)
    return d_org, d_dirs, d_time, d_chunks, d_tree


sphere_closest_accel.defvjp(_sphere_fwd, _sphere_bwd)
