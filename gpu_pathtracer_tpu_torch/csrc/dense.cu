// Dense hit kernel (K1): closest or any hit of each ray against every
// prim of a <= 512-row dense_prims table, brute force.
//
// Replaces the TPU kernel gpu_pathtracer_tpu/geom/dense_tpu.py::_kernel
// (pallas_call at dense_tpu.py:178), which keeps an 8192-ray tile in
// VMEM and streams the prim table as scalars.
//
// What bounds it on an H100: instruction issue. A ray reads 32 bytes and
// writes 8, but runs one test per row (32 rows for cornell_port, up to
// 512): ~33M triangle tests at 1M rays. Every thread of a warp tests the
// same row at the same time, so the table read is a shared-memory
// broadcast and the arithmetic of the test is the cost.
//
// Design:
// - each 128-thread block takes 256 rays and first queues the ones whose
//   interval is not empty (intersect.cuh::empty_interval: VPT's finished
//   lanes, the Tr walk's lanes that stopped walking) in shared memory;
//   the others are misses at once. Its threads then take the queued rays
//   two by two, so a block with few live rays leaves whole warps idle,
//   and a block with none stages nothing;
// - the table is staged in shared memory once per block, with each
//   triangle's normal n = e1 x e2 written into the row's pad columns
//   13-15 (0 for any other row), so a triangle test needs ~21 fused
//   products and sums (intersect.cuh::tri_cross_n) and no division: the
//   best hit is kept as a fraction tnum / |det| and a row wins when
//   tnum * |det_best| < tnum_best * |det| (equal rows give equal
//   products, so the tie rule holds exactly);
// - two rays per thread, so one shared-memory row read serves two tests;
// - two variants, chosen by the wrapper from the scene's prim kinds:
//   triangles only (no type branch: pad rows have n = 0 and never cross),
//   or all kinds (a warp-uniform branch on the row's type);
// - the winning triangle's t is computed once at the end with the plain
//   version's arithmetic (tri_hit), so t equals the plain version's
//   wherever the two pick the same row.
// Closest hit keeps the FIRST row among equal t (strictly nearer wins, as
// geom/dense.py::dense_closest_torch); any hit leaves a ray at its first
// hit. No lane padding and no float-encoded ids: the row is the prim id.
// The row choice is held to the plain version within the hit limits
// (PERF.md section 2), not bit for bit.
#include "intersect.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRays = 2;   // rays per thread
constexpr int kPerBlock = kThreads * kRays;
constexpr int kWarps = kThreads / 32;

template <bool kAll>
__global__ void __launch_bounds__(kThreads)
    dense_kernel(const float* __restrict__ prims, int n_prims,
                 const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ tmin_,
                 const float* __restrict__ tmax_, float* __restrict__ t_out,
                 int32_t* __restrict__ prim_out,
                 uint8_t* __restrict__ found_out, int n, int any_hit) {
  extern __shared__ float4 table[];
  __shared__ int queue[kPerBlock];
  __shared__ int counts[kRays * kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kPerBlock;

  // queue the block's live rays; the others miss
  bool live[kRays];
  int rank[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = base + k * kThreads + threadIdx.x;
    live[k] = false;
    if (i < n) {
      const float t1 = tmax_[i];
      live[k] = !empty_interval<kAll>(tmin_[i], t1);
      if (!live[k]) {
        if (any_hit) {
          found_out[i] = 0;
        } else {
          t_out[i] = t1;
          prim_out[i] = -1;
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, live[k]);
    rank[k] = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) counts[k * kWarps + warp] = __popc(ballot);
  }
  __syncthreads();
  int total = 0;   // the queue's length; before (k, w): their offset
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp && live[k]) {
        queue[total + rank[k]] = base + k * kThreads + threadIdx.x;
      }
      total += counts[k * kWarps + w];
    }
  }
  if (total == 0) return;   // the same for every thread of the block
  stage_rows(table, prims, n_prims);   // ends with a barrier

  // the queued rays, two a thread
  V3 o[kRays], d[kRays];
  float t0[kRays], t1[kRays], tb[kRays], ab[kRays];
  int ray[kRays], prim[kRays];
  bool todo[kRays];
  bool any_todo = false;
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int j = kRays * threadIdx.x + k;
    todo[k] = j < total;
    ray[k] = todo[k] ? queue[j] : 0;
    o[k] = load3(ro + 3 * ray[k]);
    d[k] = load3(rd + 3 * ray[k]);
    t0[k] = tmin_[ray[k]];
    t1[k] = tmax_[ray[k]];
    tb[k] = t1[k];   // best so far: tb / ab (tmax / 1 before any hit)
    ab[k] = 1.f;
    prim[k] = -1;
    any_todo = any_todo || todo[k];
  }
  if (!any_todo) return;
  bool done = false;   // any hit: every ray of the thread has its hit
  for (int p = 0; p < n_prims && !done; ++p) {
    const float4* row = table + 4 * p;
    const float4 q0 = row[0], q1 = row[1], q2 = row[2], q3 = row[3];
    const V3 v0 = mk(q0.x, q0.y, q0.z);
    const V3 a = mk(q0.w, q1.x, q1.y);
    if (kAll && (q2.y == PRIM_SPHERE || q2.y == PRIM_LINE)) {
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        if (!todo[k]) continue;
        const float best = any_hit ? t1[k] : tb[k] / ab[k];
        float tp, s;
        const bool h = q2.y == PRIM_SPHERE
            ? sphere_hit(o[k], d[k], v0, q2.z, t0[k], best, &tp)
            : line_hit(o[k], d[k], v0, a, q2.z, q2.w, t0[k], best, &tp, &s);
        if (h && (any_hit || tp < best)) {
          prim[k] = p;
          tb[k] = tp;
          ab[k] = 1.f;
          if (any_hit) todo[k] = false;
        }
      }
    } else {
      const V3 e2 = mk(q1.z, q1.w, q2.x);
      const V3 nn = mk(q3.y, q3.z, q3.w);
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        float tn, ad;
        const bool x = tri_cross_n(o[k], d[k], v0, a, e2, nn, &tn, &ad);
        // t >= tmin, and t < best (closest) or t <= tmax (any hit)
        const bool h = todo[k] && x && tn >= t0[k] * ad &&
                       (any_hit ? tn <= t1[k] * ad
                                : tn * ab[k] < tb[k] * ad);
        if (h) {
          prim[k] = p;
          tb[k] = tn;
          ab[k] = ad;
          if (any_hit) todo[k] = false;
        }
      }
    }
    if (any_hit) {
      done = true;
#pragma unroll
      for (int k = 0; k < kRays; ++k) done = done && !todo[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    if (kRays * threadIdx.x + k >= total) break;
    const int i = ray[k];
    if (any_hit) {
      found_out[i] = prim[k] >= 0;
      continue;
    }
    float t = t1[k];
    if (prim[k] >= 0) {
      const float4* row = table + 4 * prim[k];
      const float4 q0 = row[0], q1 = row[1], q2 = row[2];
      if (q2.y == PRIM_TRIANGLE) {   // the plain version's t of this row
        tri_hit(o[k], d[k], mk(q0.x, q0.y, q0.z), mk(q0.w, q1.x, q1.y),
                mk(q1.z, q1.w, q2.x), -INFINITY, INFINITY, &t);
      } else {
        t = tb[k];
      }
    }
    t_out[i] = t;
    prim_out[i] = prim[k];
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// all_kinds = 0 takes the triangles-only variant (the scene has no
// sphere and no line).
extern "C" int dense_hit(const float* prims, int n_prims, const float* ro,
                         const float* rd, const float* tmin,
                         const float* tmax_, float* t_out, int32_t* prim_out,
                         uint8_t* found_out, int n, int any_hit,
                         int all_kinds, void* stream) {
  const int blocks = (n + kPerBlock - 1) / kPerBlock;
  const size_t smem = sizeof(float4) * 4 * (size_t)n_prims;
  if (all_kinds) {
    dense_kernel<true><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        prims, n_prims, ro, rd, tmin, tmax_, t_out, prim_out, found_out, n,
        any_hit);
  } else {
    dense_kernel<false><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        prims, n_prims, ro, rd, tmin, tmax_, t_out, prim_out, found_out, n,
        any_hit);
  }
  return (int)cudaGetLastError();
}
