// Block-culled hit kernel (K3): closest or any hit of each ray against a
// dense_prims table cut into 64-prim blocks, each block skipped unless
// the ray enters its bounding box.
//
// Replaces the TPU kernel gpu_pathtracer_tpu/geom/dense_tpu.py::
// _blocked_kernel (pallas_call at dense_tpu.py:408), which keeps the
// whole prim table (up to 65,536 rows, 4 MB) and the block boxes resident
// in VMEM and lets an 8192-ray tile enter a block when any of its rays
// hits the block's box.
//
// What bounds it on an H100: the box tests and the prim tests of the
// blocks a ray enters (~24 flops a box, ~40 a triangle), and the spread
// of a warp: its lanes enter different blocks. Visited in row order, a
// ray would enter every block its box test passes until an early row
// gives its closest hit, and a warp would run the 64 prim tests of every
// block any of its lanes entered.
//
// Design:
// - every 128-thread block stages block_bbox in shared memory (at most
//   1,024 boxes, 32 KB; all lanes read the same box at once, a
//   broadcast) and builds a coarse level there: one box per `group`
//   blocks (geom/blocked_cuda.py::GROUP).
//   A ray tests the coarse boxes and the fine boxes of the coarse ones
//   it enters (a child box inside its coarse box cannot pass a slab test
//   the coarse one fails: rounding is monotone);
// - a pass over the boxes keeps, per ray, the kList nearest entered
//   blocks in registers as sorted keys (entry distance, block); the ray
//   then visits them nearest first and stops at the first block that it
//   enters beyond its best t, so the blocks behind its hit are never
//   tested. When the list ran out of room, another pass collects the
//   blocks past the last one visited. The visits of a warp run in step:
//   each lane tests its own block (a per-lane __ldg of each row; the
//   table, 1 MB at 16k prims, stays in L2);
// - inside a block, a ray tests only the rows of the sub-boxes it enters
//   (one box per `sub_rows` rows, the scene's block_sub table, made once
//   by geom/blocked_cuda.py::sub_boxes): lanes of a warp sit in
//   different blocks, so each walks the set bits of its own mask, and
//   the warp runs the most sub-boxes any lane enters, not all of them;
// - the tie rule does not depend on the order of visits: a hit is taken
//   when t < best t, or t == best t and its row is larger, which gives
//   the in-order rule of the plain version geom/blocked.py::
//   blocked_hit_torch (among equal t the last row wins). Any hit takes
//   a hit at t <= tmax, as the plain version does, and leaves a ray at
//   its first hit;
// - two variants, chosen by the wrapper from the scene's prim kinds:
//   triangles only (no type branch) or all kinds. The triangle test
//   (intersect.cuh::tri_cross) does not divide: the best hit is kept as
//   a fraction tnum / |det| and compared by cross products, and the
//   winning triangle's t is computed once at the end with the plain
//   version's arithmetic (tri_hit), so t equals the plain version's
//   wherever the two pick the same row;
// - a ray with an empty interval (intersect.cuh::empty_interval) is a
//   miss at once, and a block whose rays are all empty stages nothing.
// The row choice is held to the plain version within the hit limits
// (PERF.md section 2), not bit for bit.
#include "intersect.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlock = 64;        // prims per culling block (blocked_cuda.BLOCK)
constexpr int kMaxBlocks = 1024;  // blocked_cuda.MAX_BLOCKS: a key's 10 bits
constexpr int kList = 8;          // nearest entered blocks kept per pass
constexpr unsigned kNone = 0xFFFFFFFFu;

// A block entered at distance tn: tn's float bits (tn clamped at 0, so
// the bits order like tn) with the low 10 bits replaced by the block.
// key_t(key) <= tn, since cutting mantissa bits rounds toward 0.
__device__ __forceinline__ unsigned make_key(float tn, int b) {
  return (__float_as_uint(fmaxf(tn, 0.f)) & ~(unsigned)(kMaxBlocks - 1)) |
         (unsigned)b;
}
__device__ __forceinline__ float key_t(unsigned key) {
  return __uint_as_float(key & ~(unsigned)(kMaxBlocks - 1));
}

__device__ __forceinline__ bool box_hit(const float4* box, V3 o, V3 inv,
                                        float tmax_, float* tn) {
  const float4 a = box[0], b = box[1];   // min xyz, max x | max yz, pad
  return slab_hit(mk(a.x, a.y, a.z), mk(a.w, b.x, b.y), o, inv, tmax_, tn);
}

template <bool kAll>
__global__ void __launch_bounds__(kThreads)
    blocked_kernel(const float* __restrict__ prims, int n_prims,
                   const float* __restrict__ bbox, int n_blocks, int group,
                   const float4* __restrict__ sub, int sub_rows,
                   const float* __restrict__ ro,
                   const float* __restrict__ rd,
                   const float* __restrict__ tmin_,
                   const float* __restrict__ tmax_,
                   float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                   uint8_t* __restrict__ found_out, int n, int any_hit) {
  extern __shared__ float4 boxes[];   // fine boxes, then the coarse ones
  const int n_coarse = (n_blocks + group - 1) / group;
  const int per = kBlock / sub_rows;  // sub-boxes a block (<= 32)
  float4* coarse = boxes + 2 * n_blocks;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float t0 = 0.f, best_t = 0.f;
  bool live = false;
  if (i < n) {
    t0 = tmin_[i];
    best_t = tmax_[i];
    live = !empty_interval<kAll>(t0, best_t);
  }
  int best = -1;
  if (__syncthreads_or(live)) {
    const float4* src = reinterpret_cast<const float4*>(bbox);
    for (int j = threadIdx.x; j < 2 * n_blocks; j += blockDim.x) {
      boxes[j] = src[j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < n_coarse; c += blockDim.x) {
      V3 lo = mk(INFINITY, INFINITY, INFINITY);
      V3 hi = mk(-INFINITY, -INFINITY, -INFINITY);
      for (int b = c * group; b < min(c * group + group, n_blocks); ++b) {
        const float4 a = boxes[2 * b], q = boxes[2 * b + 1];
        lo = mk(fminf(lo.x, a.x), fminf(lo.y, a.y), fminf(lo.z, a.z));
        hi = mk(fmaxf(hi.x, a.w), fmaxf(hi.y, q.x), fmaxf(hi.z, q.y));
      }
      coarse[2 * c] = make_float4(lo.x, lo.y, lo.z, hi.x);
      coarse[2 * c + 1] = make_float4(hi.y, hi.z, 0.f, 0.f);
    }
    __syncthreads();
  }
  const float t1 = best_t;   // tmax
  float t = best_t;          // the answer's t: tmax on a miss
  if (live) {
    const V3 o = load3(ro + 3 * i);
    const V3 d = load3(rd + 3 * i);
    const V3 inv = mk(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
    const float4* recs = reinterpret_cast<const float4*>(prims);
    // the best hit so far is tb / ab (tmax / 1 before any); boxes and
    // blocks are culled against cull_t, its t widened by 1e-6 relative,
    // so no block that could hold a hit at t <= best t is skipped
    float tb = best_t, ab = 1.f, cull_t = best_t;
    unsigned floor_key = 0;   // keys below it are visited
    bool more = true;
    while (more) {
      unsigned l[kList];
#pragma unroll
      for (int j = 0; j < kList; ++j) l[j] = kNone;
      int entered = 0;
      for (int c = 0; c < n_coarse; ++c) {
        float tn;
        if (!box_hit(coarse + 2 * c, o, inv, cull_t, &tn)) continue;
        const int b1 = min(c * group + group, n_blocks);
        for (int b = c * group; b < b1; ++b) {
          if (!box_hit(boxes + 2 * b, o, inv, cull_t, &tn)) continue;
          const unsigned key = make_key(tn, b);
          if (key < floor_key) continue;
          ++entered;
          if (key < l[kList - 1]) list_insert(l, key);
        }
      }
      more = entered > kList;   // blocks past the list: another pass
      while (l[0] != kNone) {
        const unsigned key = l[0];
        if (key_t(key) > cull_t) {   // every block left lies beyond the hit
          more = false;
          break;
        }
        const int b = (int)(key & (kMaxBlocks - 1));
        // the block's sub-boxes this ray enters, then their rows, each
        // lane its own: a warp runs the most any of its lanes enters
        unsigned mask = 0;
        const float4* sb = sub + 2 * b * per;
#pragma unroll 8
        for (int j = 0; j < per; ++j) {
          float tn;
          const float4 a = __ldg(sb + 2 * j), q = __ldg(sb + 2 * j + 1);
          if (slab_hit(mk(a.x, a.y, a.z), mk(a.w, q.x, q.y), o, inv, cull_t,
                       &tn)) {
            mask |= 1u << j;
          }
        }
        bool stop = false;
        while (mask && !stop) {
          const int j = __ffs(mask) - 1;
          mask &= mask - 1;
          const int p0 = b * kBlock + j * sub_rows;
          const int p1 = min(p0 + sub_rows, n_prims);
#pragma unroll 4
          for (int p = p0; p < p1; ++p) {
            const float4 q0 = __ldg(recs + 4 * p);
            const float4 q1 = __ldg(recs + 4 * p + 1);
            const float4 q2 = __ldg(recs + 4 * p + 2);
            const V3 v0 = mk(q0.x, q0.y, q0.z);
            const V3 a = mk(q0.w, q1.x, q1.y);
            float tn = 0.f, ad = 1.f;
            bool h;
            if (kAll && q2.y != PRIM_TRIANGLE) {
              // t in [tmin, best t]: tmax itself for any hit
              float s;
              const float bt = tb / ab;
              h = q2.y == PRIM_SPHERE
                  ? sphere_hit(o, d, v0, q2.z, t0, bt, &tn)
                  : q2.y == PRIM_LINE &&
                    line_hit(o, d, v0, a, q2.z, q2.w, t0, bt, &tn, &s);
              ad = 1.f;
            } else {
              h = tri_cross(o, d, v0, a, mk(q1.z, q1.w, q2.x), &tn, &ad) &&
                  q2.y == PRIM_TRIANGLE && tn >= t0 * ad;
            }
            if (any_hit) {   // any hit at t <= tmax, like the plain version
              if (h && tn <= t1 * ad) {
                best = p;
                stop = true;
                break;
              }
              continue;
            }
            // nearer, or as near and a larger row (the plain version's
            // in-order rule, whatever the order of visits; best = -1 lets
            // a hit at tmax itself count)
            const float lhs = tn * ab, rhs = tb * ad;
            if (h && (lhs < rhs || (lhs == rhs && p > best))) {
              tb = tn;
              ab = ad;
              best = p;
            }
          }
        }
        if (any_hit && best >= 0) {
          more = false;
          break;
        }
        if (best >= 0) cull_t = widen_hi(tb / ab);
        floor_key = key + 1;
#pragma unroll
        for (int j = 0; j + 1 < kList; ++j) l[j] = l[j + 1];
        l[kList - 1] = kNone;
      }
    }
    if (!any_hit && best >= 0) {
      const float4* r = recs + 4 * best;
      const float4 q0 = __ldg(r), q1 = __ldg(r + 1), q2 = __ldg(r + 2);
      t = tb;   // a sphere's or a line's t as its test gave it
      if (q2.y == PRIM_TRIANGLE) {   // the plain version's t of this row
        tri_hit(o, d, mk(q0.x, q0.y, q0.z), mk(q0.w, q1.x, q1.y),
                mk(q1.z, q1.w, q2.x), -INFINITY, INFINITY, &t);
      }
    }
  }
  if (i < n) {
    if (any_hit) {
      found_out[i] = best >= 0;
    } else {
      t_out[i] = t;
      prim_out[i] = best;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// all_kinds = 0 takes the triangles-only variant (the scene has no
// sphere and no line). n_blocks <= 1,024, group >= 1 fine boxes per
// coarse box, sub = [n_blocks * 64 / sub_rows, 8] sub-boxes with sub_rows
// dividing 64 and at least 2 (the wrapper checks).
extern "C" int blocked_hit(const float* prims, int n_prims, const float* bbox,
                           int n_blocks, int group, const float* sub,
                           int sub_rows, const float* ro, const float* rd,
                           const float* tmin_, const float* tmax_,
                           float* t_out, int32_t* prim_out,
                           uint8_t* found_out, int n, int any_hit,
                           int all_kinds, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const int n_coarse = (n_blocks + group - 1) / group;
  const size_t smem = sizeof(float4) * 2 * (size_t)(n_blocks + n_coarse);
  const float4* sub4 = reinterpret_cast<const float4*>(sub);
  if (all_kinds) {
    blocked_kernel<true><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        prims, n_prims, bbox, n_blocks, group, sub4, sub_rows, ro, rd, tmin_,
        tmax_, t_out, prim_out, found_out, n, any_hit);
  } else {
    blocked_kernel<false><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        prims, n_prims, bbox, n_blocks, group, sub4, sub_rows, ro, rd, tmin_,
        tmax_, t_out, prim_out, found_out, n, any_hit);
  }
  return (int)cudaGetLastError();
}
