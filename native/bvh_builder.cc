// Native scene-acceleration builder.
//
// The device-side intersector consumes primitives in a spatially coherent order
// (chunk-of-primitives scan with per-chunk AABB culling, ops/chunked.py), and
// future kernels consume the flattened BVH nodes directly. This library does
// the host-side heavy lifting the reference does in C++ too (its recursive
// sort-based builder, reference src/bvh_node.h:18-47) — but with binned SAH
// splits on every axis instead of the reference's hard-coded x-axis median
// (src/bvh_node.h:21, a known quality bug per SURVEY.md appendix item 4).
//
// Exposed C ABI (ctypes):
//   bvh_build(centroids, lo, hi, n, max_leaf,
//             out_order, out_nodes, out_node_count) -> 0 on success
//
// Node layout (8 floats per node, depth-first):
//   [0:3] aabb lo, [3:6] aabb hi,
//   [6] left-or-first: internal -> right-child node index (left child is
//       always node_index+1); leaf -> first primitive in out_order
//   [7] count: 0 for internal nodes, else number of primitives in the leaf
//       (sign carries the tag; count stored as float, exact below 2^24)
//
// Build: g++ -O3 -march=native -shared -fPIC -o libbvh.so bvh_builder.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Prim {
  float c[3];
  float lo[3];
  float hi[3];
  int32_t id;
};

struct Node {
  float lo[3];
  float hi[3];
  float a;  // right child index (internal) or first primitive (leaf)
  float b;  // 0 (internal) or primitive count (leaf)
};

constexpr int kBins = 16;

float surface_area(const float lo[3], const float hi[3]) {
  float dx = std::max(0.f, hi[0] - lo[0]);
  float dy = std::max(0.f, hi[1] - lo[1]);
  float dz = std::max(0.f, hi[2] - lo[2]);
  return 2.f * (dx * dy + dy * dz + dz * dx);
}

void grow(float lo[3], float hi[3], const Prim& p) {
  for (int k = 0; k < 3; ++k) {
    lo[k] = std::min(lo[k], p.lo[k]);
    hi[k] = std::max(hi[k], p.hi[k]);
  }
}

struct Builder {
  std::vector<Prim>& prims;
  std::vector<Node> nodes;
  int max_leaf;

  int build(int begin, int end) {
    int idx = static_cast<int>(nodes.size());
    nodes.push_back(Node{});
    Node& placeholder = nodes.back();
    float lo[3] = {INFINITY, INFINITY, INFINITY};
    float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int i = begin; i < end; ++i) grow(lo, hi, prims[i]);
    for (int k = 0; k < 3; ++k) {
      placeholder.lo[k] = lo[k];
      placeholder.hi[k] = hi[k];
    }
    int n = end - begin;
    if (n <= max_leaf) {
      nodes[idx].a = static_cast<float>(begin);
      nodes[idx].b = static_cast<float>(n);
      return idx;
    }

    // binned SAH over all three axes
    float clo[3] = {INFINITY, INFINITY, INFINITY};
    float chi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int i = begin; i < end; ++i)
      for (int k = 0; k < 3; ++k) {
        clo[k] = std::min(clo[k], prims[i].c[k]);
        chi[k] = std::max(chi[k], prims[i].c[k]);
      }
    int best_axis = -1, best_bin = -1;
    float best_cost = INFINITY;
    for (int axis = 0; axis < 3; ++axis) {
      float extent = chi[axis] - clo[axis];
      if (extent <= 1e-12f) continue;
      float inv = kBins / extent;
      int cnt[kBins] = {0};
      float blo[kBins][3], bhi[kBins][3];
      for (int bi = 0; bi < kBins; ++bi)
        for (int k = 0; k < 3; ++k) {
          blo[bi][k] = INFINITY;
          bhi[bi][k] = -INFINITY;
        }
      for (int i = begin; i < end; ++i) {
        int bi = std::min(kBins - 1,
                          static_cast<int>((prims[i].c[axis] - clo[axis]) * inv));
        ++cnt[bi];
        for (int k = 0; k < 3; ++k) {
          blo[bi][k] = std::min(blo[bi][k], prims[i].lo[k]);
          bhi[bi][k] = std::max(bhi[bi][k], prims[i].hi[k]);
        }
      }
      // sweep: cost(split) = SA_l * n_l + SA_r * n_r
      float rlo[kBins][3], rhi[kBins][3];
      float acc_lo[3] = {INFINITY, INFINITY, INFINITY};
      float acc_hi[3] = {-INFINITY, -INFINITY, -INFINITY};
      int rcnt[kBins] = {0};
      int run = 0;
      for (int bi = kBins - 1; bi >= 1; --bi) {
        for (int k = 0; k < 3; ++k) {
          acc_lo[k] = std::min(acc_lo[k], blo[bi][k]);
          acc_hi[k] = std::max(acc_hi[k], bhi[bi][k]);
          rlo[bi][k] = acc_lo[k];
          rhi[bi][k] = acc_hi[k];
        }
        run += cnt[bi];
        rcnt[bi] = run;
      }
      float llo[3] = {INFINITY, INFINITY, INFINITY};
      float lhi[3] = {-INFINITY, -INFINITY, -INFINITY};
      int lrun = 0;
      for (int bi = 0; bi < kBins - 1; ++bi) {
        for (int k = 0; k < 3; ++k) {
          llo[k] = std::min(llo[k], blo[bi][k]);
          lhi[k] = std::max(lhi[k], bhi[bi][k]);
        }
        lrun += cnt[bi];
        if (lrun == 0 || rcnt[bi + 1] == 0) continue;
        float cost = surface_area(llo, lhi) * lrun +
                     surface_area(rlo[bi + 1], rhi[bi + 1]) * rcnt[bi + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = bi;
        }
      }
    }

    int mid;
    if (best_axis < 0) {
      mid = begin + n / 2;  // degenerate centroids: median split
    } else {
      float extent = chi[best_axis] - clo[best_axis];
      float inv = kBins / extent;
      float split_c = clo[best_axis];
      auto it = std::partition(
          prims.begin() + begin, prims.begin() + end, [&](const Prim& p) {
            int bi = std::min(kBins - 1,
                              static_cast<int>((p.c[best_axis] - split_c) * inv));
            return bi <= best_bin;
          });
      mid = static_cast<int>(it - prims.begin());
      if (mid == begin || mid == end) mid = begin + n / 2;
    }

    build(begin, mid);  // left child = idx+1 by DFS order
    int right = build(mid, end);
    nodes[idx].a = static_cast<float>(right);
    nodes[idx].b = 0.f;
    return idx;
  }
};

}  // namespace

extern "C" {

// centroids/lo/hi: [n,3] row-major float32. out_order: [n] int32 (new->old).
// out_nodes: [2n, 8] float32 (caller-allocated upper bound). Returns node
// count, or -1 on error.
int32_t bvh_build(const float* centroids, const float* lo, const float* hi,
                  int32_t n, int32_t max_leaf, int32_t* out_order,
                  float* out_nodes) {
  if (n <= 0 || max_leaf <= 0) return -1;
  std::vector<Prim> prims(n);
  for (int i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      prims[i].c[k] = centroids[3 * i + k];
      prims[i].lo[k] = lo[3 * i + k];
      prims[i].hi[k] = hi[3 * i + k];
    }
    prims[i].id = i;
  }
  Builder b{prims, {}, max_leaf};
  b.nodes.reserve(2 * n);
  b.build(0, n);
  for (int i = 0; i < n; ++i) out_order[i] = prims[i].id;
  for (size_t i = 0; i < b.nodes.size(); ++i) {
    const Node& nd = b.nodes[i];
    float* row = out_nodes + 8 * i;
    for (int k = 0; k < 3; ++k) row[k] = nd.lo[k];
    for (int k = 0; k < 3; ++k) row[3 + k] = nd.hi[k];
    row[6] = nd.a;
    row[7] = nd.b;
  }
  return static_cast<int32_t>(b.nodes.size());
}

}  // extern "C"
