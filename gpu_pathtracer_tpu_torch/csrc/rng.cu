// Philox draw kernel: sites 4 block0 .. 4 (block0 + n_blocks) - 1 of
// stream `tag` for every lane, as float32 rows.
//
// Row 4 b + k of the [4 n_blocks, N] output is
//   bits_to_uniform(word k of philox((lane, block0 + b, tag, 0),
//                                    (seed, iteration)))
// (philox.cuh), bit for bit what core/rng.py's plain version
// (philox4x32_10, which emulates uint32 in int64 with 16-bit limbs) hands
// out through uniform_rows and PhiloxStream.
//
// Replaces no TPU kernel: the JAX package draws with jax.random
// (threefry; one fused XLA op per draw site, e.g. MLT's mutation matrices,
// gpu_pathtracer_tpu/integrators/mlt.py:114-121) and, inside its
// megakernel, from the TPU's own generator (pt_fused.py:910 _uniform).
// The port's plain version costs ~22 elementwise launches a Philox round,
// ~220 for one counter block; this kernel is one launch for all of a
// call's blocks.
//
// What bounds it on an H100: the bytes written. An MLT step writes 136
// rows x 1,048,576 chains x 4 B = 570 MB (0.170 ms at 3.35 TB/s); the
// lanes read are 8 B a lane. The integer work is ~35.7 M Philox blocks a
// step x the kernel's instructions a block (its SASS, counted by
// chip_smoke.py), under the byte bound at the card's integer rate.
// The camera's one block a lane writes 16.8 MB (~0.005 ms).
//
// Design: one thread per (lane, block) pair, lanes along x so that the
// 32 threads of a warp store 32 neighbouring floats of each of the 4
// rows (128-byte lines, row-major as the plain version); blocks along y
// (a grid-stride loop beyond 65,535). No shared memory, no reduction.
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
    philox_uniform_kernel(const int64_t* __restrict__ lanes, int n,
                          uint32_t block0, int n_blocks, uint32_t tag,
                          uint32_t seed, uint32_t iteration,
                          float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t lane = (uint32_t)lanes[i];   // the low 32 bits, & MASK32
  for (int b = blockIdx.y; b < n_blocks; b += gridDim.y) {
    const uint4 w =
        philox(lane, block0 + (uint32_t)b, tag, 0u, seed, iteration);
    float* o = out + (size_t)4 * b * n + i;
    o[0] = bits_to_uniform(w.x);
    o[(size_t)n] = bits_to_uniform(w.y);
    o[(size_t)2 * n] = bits_to_uniform(w.z);
    o[(size_t)3 * n] = bits_to_uniform(w.w);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// lanes: [n] int64 holding uint32 values; out: [4 n_blocks, n] float32.
extern "C" int philox_uniform(const int64_t* lanes, int n, uint32_t block0,
                              int n_blocks, uint32_t tag, uint32_t seed,
                              uint32_t iteration, float* out, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads,
                  n_blocks < kMaxGridY ? n_blocks : kMaxGridY);
  philox_uniform_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      lanes, n, block0, n_blocks, tag, seed, iteration, out);
  return (int)cudaGetLastError();
}
