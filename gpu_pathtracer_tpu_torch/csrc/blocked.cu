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
// What bounds it on an H100: the loop over blocks. Every ray slab-tests
// every block box (P / 64 boxes, ~20 flops and 32 bytes each) and runs
// the 64 prim tests of each block it enters; at 16k prims that is 250
// box tests and a few hundred prim tests per ray. The tables are read
// from global memory through the read-only path (__ldg): 4 MB of records
// do not fit shared memory, but they do fit the 50 MB L2, and the 8 KB
// to 32 KB of block boxes every ray reads stay in L1. Rays of a warp
// enter different blocks (divergence), which the ray sort of
// integrators/pt.py reduces.
//
// Design: one thread per ray, 128-thread blocks; no VMEM residency and
// no tile-wide block decision: each ray culls for itself, with the
// running best t, so culling never changes an answer. Inside a block the
// prims are tested in row order and a hit with t <= best t is taken (the
// last of equal hits wins, as in the TPU kernel), the order of the plain
// version geom/blocked.py::blocked_hit_torch, so the two agree bit for
// bit. Any-hit leaves at the first hit.
#include "intersect.cuh"

namespace {

constexpr int kBlock = 64;   // prims per culling block (blocked_cuda.BLOCK)

__global__ void blocked_kernel(const float* __restrict__ prims, int n_prims,
                               const float* __restrict__ bbox, int n_blocks,
                               const float* __restrict__ ro,
                               const float* __restrict__ rd,
                               const float* __restrict__ tmin_,
                               const float* __restrict__ tmax_,
                               float* __restrict__ t_out,
                               int32_t* __restrict__ prim_out,
                               uint8_t* __restrict__ found_out, int n,
                               int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 o = load3(ro + 3 * i);
  const V3 d = load3(rd + 3 * i);
  const V3 inv = mk(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  const float t0 = tmin_[i];
  const float4* boxes = reinterpret_cast<const float4*>(bbox);
  const float4* recs = reinterpret_cast<const float4*>(prims);
  float best_t = tmax_[i];
  int best = -1;
  for (int b = 0; b < n_blocks && !(any_hit && best >= 0); ++b) {
    const float4 lo = __ldg(boxes + 2 * b);       // min xyz, max x
    const float4 hi = __ldg(boxes + 2 * b + 1);   // max yz, pad
    float tn;
    if (!slab_hit(mk(lo.x, lo.y, lo.z), mk(lo.w, hi.x, hi.y), o, inv, best_t,
                  &tn)) {
      continue;
    }
    const int p1 = min(b * kBlock + kBlock, n_prims);
    for (int p = b * kBlock; p < p1; ++p) {
      float4 row[4];
      for (int k = 0; k < 4; ++k) row[k] = __ldg(recs + 4 * p + k);
      float tp;
      if (prim_hit(row, o, d, t0, best_t, &tp)) {
        best_t = tp;
        best = p;
        if (any_hit) break;
      }
    }
  }
  if (any_hit) {
    found_out[i] = best >= 0;
  } else {
    t_out[i] = best_t;
    prim_out[i] = best;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int blocked_hit(const float* prims, int n_prims, const float* bbox,
                           int n_blocks, const float* ro, const float* rd,
                           const float* tmin_, const float* tmax_,
                           float* t_out, int32_t* prim_out,
                           uint8_t* found_out, int n, int any_hit,
                           void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  blocked_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      prims, n_prims, bbox, n_blocks, ro, rd, tmin_, tmax_, t_out, prim_out,
      found_out, n, any_hit);
  return (int)cudaGetLastError();
}
