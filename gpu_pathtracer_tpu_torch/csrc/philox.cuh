// Philox4x32-10 (Salmon et al., SC'11) and its float conversion, the one
// device copy of core/rng.py::philox4x32_10 and bits_to_uniform: the
// draw kernel (rng.cu), the path-trace megakernel (pt_fused.cu), the
// tracking walk (track.cu, through media.cuh) and the wavefronts' shading
// kernels (pt_shade.cu, vpt_shade.cu) all include it, so they draw the
// same bits as the plain version.
//
// Site d of stream `tag` for lane i is
//   bits_to_uniform(word d & 3 of philox((i, d >> 2, tag, 0),
//                                        (seed, iteration)));
// the tracking walk reads counters (i, 0, tag, j) (core/rng.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0,
                                        uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// uint32 word -> U[0, 1) with 24 bits, exact in float32.
__device__ __forceinline__ float bits_to_uniform(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f);
}
