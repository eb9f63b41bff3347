"""Host-side acceleration-structure building (native C++ with numpy fallback).

The native library (native/bvh_builder.cc) builds a binned-SAH BVH — the
path tracer's counterpart of the reference's C++ builder (reference
src/bvh_node.h:18-47, which median-splits on a hard-coded x axis;
SURVEY.md appendix item 4). Its outputs serve two consumers:

 - the chunked intersector (ops/chunked.py) uses the depth-first
   primitive ORDER: BVH leaf order is spatially coherent, so fixed-size
   primitive chunks get tight AABBs and whole-batch chunk culls actually fire;
 - the flattened NODE array is available for traversal kernels.

The .so is compiled on demand with g++ into native/build/, under a name keyed
by the source's SHA-256; if no compiler is available, a numpy Morton-order
fallback provides the same interface (slightly looser chunk bounds, identical
rendering results).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SRC = os.path.join(_NATIVE_DIR, "bvh_builder.cc")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_LIB = None
_LIB_TRIED = False


def lib_path(src: str = _SRC, build_dir: str = _BUILD_DIR) -> str:
    """Library path keyed by the SHA-256 of the source: a library built from
    any other source, or on another checkout's copy, is never loaded."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(build_dir, f"libbvh-{digest}.so")


def build_native(src: str = _SRC, build_dir: str = _BUILD_DIR) -> str:
    """Compile the builder (portable flags, no -march=native) unless the
    library for this exact source exists; returns its path."""
    so_path = lib_path(src, build_dir)
    if not os.path.exists(so_path):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        "-o", tmp, src],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)   # atomic: concurrent builders race safely
    return so_path


def _load_native():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        lib = ctypes.CDLL(build_native())
        lib.bvh_build.restype = ctypes.c_int32
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
        _LIB = lib
    except Exception as e:  # noqa: BLE001
        print(f"[accel] native builder unavailable ({e}); using numpy fallback")
        _LIB = None
    return _LIB


def native_available() -> bool:
    """True when BVH builds use the native SAH builder, not the fallback."""
    return _load_native() is not None


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Fallback spatial sort: 3x10-bit Morton codes of quantized centroids."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    extent = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip(((c - lo) / extent * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)


def build_bvh(centroids: np.ndarray, lo: np.ndarray, hi: np.ndarray,
              max_leaf: int = 8):
    """(order [n] int32 new->old, nodes [m,8] float32 or None).

    Node row: [lo(3), hi(3), a, b] — internal: a = right-child index (left is
    row+1), b = 0; leaf: a = first primitive (in the reordered array),
    b = count.
    """
    n = len(centroids)
    if n == 0:
        return np.zeros((0,), np.int32), None
    lib = _load_native()
    if lib is None:
        return _morton_order(centroids), None
    c = np.ascontiguousarray(centroids, np.float32)
    l = np.ascontiguousarray(lo, np.float32)
    h = np.ascontiguousarray(hi, np.float32)
    order = np.zeros((n,), np.int32)
    nodes = np.zeros((2 * n, 8), np.float32)
    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int32)
    count = lib.bvh_build(
        c.ctypes.data_as(fptr), l.ctypes.data_as(fptr), h.ctypes.data_as(fptr),
        n, int(max_leaf), order.ctypes.data_as(iptr),
        nodes.ctypes.data_as(fptr))
    if count < 0:
        return _morton_order(centroids), None
    return order, nodes[:count].copy()


def threaded_links(nodes: np.ndarray):
    """Hit/miss links for stackless ("threaded") BVH traversal.

    The builder emits nodes in DFS order (left child = i+1, right child =
    nodes[i,6] for internal nodes). The *skip* link of a node is the node
    visited after its whole subtree is done: skip(root) = sentinel n,
    skip(left) = right sibling, skip(right) = skip(parent). Traversal then
    needs no stack at all — the per-ray state is one int:

        next = aabb_hit ? hit_link[node] : miss_link[node]

    with hit_link = node+1 (descend) for internal nodes and skip for leaves
    (reference counterpart: the recursive descent in src/bvh_node.h:49-58).

    Returns (hit_link [n] int32, miss_link [n] int32, leaf_first [n] int32,
    leaf_count [n] int32); sentinel = n terminates.
    """
    n = len(nodes)
    skip = np.full(n, n, np.int32)
    stack = [(0, n)]
    while stack:
        i, sk = stack.pop()
        skip[i] = sk
        if nodes[i, 7] == 0:  # internal
            right = int(nodes[i, 6])
            stack.append((i + 1, right))
            stack.append((right, sk))
    is_leaf = nodes[:, 7] > 0
    hit_link = np.where(is_leaf, skip, np.arange(n, dtype=np.int32) + 1)
    leaf_first = np.where(is_leaf, nodes[:, 6], 0).astype(np.int32)
    leaf_count = nodes[:, 7].astype(np.int32)
    return hit_link.astype(np.int32), skip, leaf_first, leaf_count


def chunk_bounds(lo: np.ndarray, hi: np.ndarray, chunk: int):
    """Per-chunk AABBs of an already-ordered primitive array, padded to a
    multiple of ``chunk``. Returns (chunk_lo [K,3], chunk_hi [K,3]); padding
    rows get inverted (empty) boxes that never pass a slab test."""
    n = len(lo)
    k = max(1, (n + chunk - 1) // chunk)
    clo = np.full((k, 3), np.inf, np.float32)
    chi = np.full((k, 3), -np.inf, np.float32)
    for i in range(k):
        s, e = i * chunk, min((i + 1) * chunk, n)
        if s < e:
            clo[i] = lo[s:e].min(axis=0)
            chi[i] = hi[s:e].max(axis=0)
    return clo, chi
