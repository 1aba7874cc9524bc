// Dense hit kernel: closest or any hit of each ray against every prim of
// a <= 512-row dense_prims table, brute force.
//
// Replaces the TPU kernel gpu_pathtracer_tpu/geom/dense_tpu.py::_kernel
// (pallas_call at dense_tpu.py:178), which keeps an 8192-ray tile in
// VMEM and streams the prim table as scalars.
//
// What bounds it on an H100: arithmetic throughput. A ray reads 32 bytes
// and writes 8, but tests up to 512 prims at ~30-60 flops each, so at
// 1M rays the kernel does ~20 GFLOP against ~40 MB of traffic. Every
// thread of a warp tests the same prim at the same time, so the table
// read is a broadcast.
//
// Design: one thread per ray; each 128-thread block stages the whole
// table (at most 512 x 64 B = 32 KB) in shared memory once, then every
// thread loops over all rows from there (the prim type branch is
// warp-uniform). Any-hit leaves at the first hit. No lane padding and no
// float-encoded ids: the row index is the prim id.
#include "intersect.cuh"

namespace {

__global__ void dense_kernel(const float* __restrict__ prims, int n_prims,
                             const float* __restrict__ ro,
                             const float* __restrict__ rd,
                             const float* __restrict__ tmin,
                             const float* __restrict__ tmax_,
                             float* __restrict__ t_out,
                             int32_t* __restrict__ prim_out,
                             uint8_t* __restrict__ found_out, int n,
                             int any_hit) {
  extern __shared__ float4 table[];
  stage_prims(table, prims, n_prims);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 o = load3(ro + 3 * i);
  const V3 d = load3(rd + 3 * i);
  if (any_hit) {
    found_out[i] = any_loop(table, n_prims, o, d, tmin[i], tmax_[i]);
  } else {
    float t;
    prim_out[i] = closest_loop(table, n_prims, o, d, tmin[i], tmax_[i], &t);
    t_out[i] = t;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int dense_hit(const float* prims, int n_prims, const float* ro,
                         const float* rd, const float* tmin,
                         const float* tmax_, float* t_out, int32_t* prim_out,
                         uint8_t* found_out, int n, int any_hit,
                         void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = sizeof(float4) * 4 * (size_t)n_prims;
  dense_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      prims, n_prims, ro, rd, tmin, tmax_, t_out, prim_out, found_out, n,
      any_hit);
  return (int)cudaGetLastError();
}
