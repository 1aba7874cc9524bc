// Native SAH BVH builder: the host-side hot loop of the scene build.
//
// A copy of the JAX package's native/bvh_builder.cpp, built by
// geom/bvh_native.py (g++ -O2 -shared -fPIC) into build/ at first use.
// Same algorithm as geom/bvh.py::build_bvh_numpy: top-down bucketed SAH
// (12 buckets, all 3 axes), leaves capped at LEAF_SIZE with a median-split
// fallback, DFS flatten where a node's left child is at index+1 and the
// right child at second_child[i]; the counterpart of the reference's CPU
// builder (bvh.cpp:38-173). It computes in float32, so a split may differ
// from the numpy builder's (float64) where a centroid sits on a bucket
// edge: both trees are valid.
//
// C ABI for ctypes: caller allocates output arrays of capacity 2n.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kLeafSize = 4;
constexpr int kBuckets = 12;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3 lo{1e30f, 1e30f, 1e30f};
  Vec3 hi{-1e30f, -1e30f, -1e30f};
  void expand(const Vec3& a, const Vec3& b) {
    lo = vmin(lo, a);
    hi = vmax(hi, b);
  }
  void expand(const Box& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
  float axis_lo(int a) const { return a == 0 ? lo.x : a == 1 ? lo.y : lo.z; }
  float axis_hi(int a) const { return a == 0 ? hi.x : a == 1 ? hi.y : hi.z; }
};

struct BuildItem {
  int32_t* ids;    // primitive ids for this node (slice of the id pool)
  int32_t count;
  int32_t parent;  // slot in second_child[] to patch, or -1
};

}  // namespace

extern "C" int build_bvh(
    const float* prim_bmin, const float* prim_bmax, int32_t n,
    float* out_bbox_min, float* out_bbox_max, int32_t* out_second_child,
    int32_t* out_start, int32_t* out_end, uint8_t* out_is_leaf,
    int32_t* out_prim_order, int32_t* out_n_nodes) {
  if (n <= 0) return -1;

  std::vector<Vec3> lo(n), hi(n), cen(n);
  for (int i = 0; i < n; ++i) {
    lo[i] = {prim_bmin[3 * i], prim_bmin[3 * i + 1], prim_bmin[3 * i + 2]};
    hi[i] = {prim_bmax[3 * i], prim_bmax[3 * i + 1], prim_bmax[3 * i + 2]};
    cen[i] = {0.5f * (lo[i].x + hi[i].x), 0.5f * (lo[i].y + hi[i].y),
              0.5f * (lo[i].z + hi[i].z)};
  }

  // id pool: children partition their parent's slice in place
  std::vector<int32_t> pool(n);
  for (int i = 0; i < n; ++i) pool[i] = i;
  std::vector<int32_t> scratch(n);

  std::vector<BuildItem> stack;
  stack.reserve(64);
  stack.push_back({pool.data(), n, -1});

  int32_t n_nodes = 0;
  int32_t n_emitted = 0;

  while (!stack.empty()) {
    BuildItem it = stack.back();
    stack.pop_back();
    const int32_t node = n_nodes++;
    if (it.parent >= 0) out_second_child[it.parent] = node;

    Box box;
    for (int i = 0; i < it.count; ++i) {
      int p = it.ids[i];
      box.expand(lo[p], hi[p]);
    }
    out_bbox_min[3 * node] = box.lo.x;
    out_bbox_min[3 * node + 1] = box.lo.y;
    out_bbox_min[3 * node + 2] = box.lo.z;
    out_bbox_max[3 * node] = box.hi.x;
    out_bbox_max[3 * node + 1] = box.hi.y;
    out_bbox_max[3 * node + 2] = box.hi.z;
    out_second_child[node] = -1;
    out_start[node] = 0;
    out_end[node] = -1;
    out_is_leaf[node] = 0;

    if (it.count <= kLeafSize) {
      out_is_leaf[node] = 1;
      out_start[node] = n_emitted;
      for (int i = 0; i < it.count; ++i) out_prim_order[n_emitted++] = it.ids[i];
      out_end[node] = n_emitted - 1;
      continue;
    }

    // bucketed SAH over the node box (matches bvh.cpp:53-107 semantics)
    float best_cost = it.count * box.area();
    int best_axis = -1, best_bucket = -1;

    for (int axis = 0; axis < 3; ++axis) {
      float a_lo = box.axis_lo(axis), a_hi = box.axis_hi(axis);
      float extent = a_hi - a_lo;
      if (extent < 1e-4f) continue;
      float inv = kBuckets / extent;

      int cnt[kBuckets] = {0};
      Box bb[kBuckets];
      for (int i = 0; i < it.count; ++i) {
        int p = it.ids[i];
        float c = axis == 0 ? cen[p].x : axis == 1 ? cen[p].y : cen[p].z;
        int b = std::min(int((c - a_lo) * inv), kBuckets - 1);
        cnt[b]++;
        bb[b].expand(lo[p], hi[p]);
      }

      // suffix sweep
      Box rbox[kBuckets];
      int rcnt[kBuckets];
      Box acc;
      int acc_c = 0;
      for (int b = kBuckets - 1; b >= 1; --b) {
        acc.expand(bb[b]);
        acc_c += cnt[b];
        rbox[b] = acc;
        rcnt[b] = acc_c;
      }
      // prefix sweep + cost
      Box lacc;
      int lc = 0;
      for (int b = 1; b < kBuckets; ++b) {
        lacc.expand(bb[b - 1]);
        lc += cnt[b - 1];
        if (lc == 0 || rcnt[b] == 0) continue;
        float cost = lacc.area() * lc + rbox[b].area() * rcnt[b];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bucket = b;
        }
      }
    }

    int32_t* ids = it.ids;
    int32_t left_n;
    if (best_axis >= 0) {
      float a_lo = box.axis_lo(best_axis);
      float inv = kBuckets / (box.axis_hi(best_axis) - a_lo);
      int32_t l = 0, r = it.count;
      for (int i = 0; i < it.count; ++i) {
        int p = ids[i];
        float c = best_axis == 0 ? cen[p].x
                  : best_axis == 1 ? cen[p].y : cen[p].z;
        int b = std::min(int((c - a_lo) * inv), kBuckets - 1);
        if (b < best_bucket) scratch[l++] = p;
        else scratch[--r] = p;  // tail, reversed below
      }
      // tail was filled backwards; reverse for determinism
      std::reverse(scratch.begin() + l, scratch.begin() + it.count);
      std::memcpy(ids, scratch.data(), it.count * sizeof(int32_t));
      left_n = l;
    } else {
      // median split on the widest centroid spread (builder invariant:
      // leaves stay <= kLeafSize)
      Vec3 clo = cen[ids[0]], chi = cen[ids[0]];
      for (int i = 1; i < it.count; ++i) {
        clo = vmin(clo, cen[ids[i]]);
        chi = vmax(chi, cen[ids[i]]);
      }
      float sx = chi.x - clo.x, sy = chi.y - clo.y, sz = chi.z - clo.z;
      int axis = (sx > sy && sx > sz) ? 0 : (sy > sz ? 1 : 2);
      left_n = it.count / 2;
      std::nth_element(
          ids, ids + left_n, ids + it.count, [&](int32_t a, int32_t b) {
            float ca = axis == 0 ? cen[a].x : axis == 1 ? cen[a].y : cen[a].z;
            float cb = axis == 0 ? cen[b].x : axis == 1 ? cen[b].y : cen[b].z;
            if (ca != cb) return ca < cb;
            return a < b;
          });
    }

    // DFS order: left child emitted next -> push right first
    stack.push_back({ids + left_n, it.count - left_n, node});
    stack.push_back({ids, left_n, -1});
  }

  *out_n_nodes = n_nodes;
  return 0;
}
