// Media tracking kernels: the per-segment supervoxel majorants of a ray
// (entry point 1, segment_majorants) and the heterogeneous-medium
// tracking walk (entry point 2, track: first collision, or delta / ratio /
// residual-ratio transmittance).
//
// Replaces the TPU kernel gpu_pathtracer_tpu/ops/small_gather.py::_kernel
// (pallas_call at small_gather.py:47), the lookup of one f32 per index in
// the <= 32,768-entry majorant table that media._segment_majorants makes,
// and the XLA candidate loops around it (media._sample_chunk_loop :734 and
// _tr_chunk_loop :893), which evaluate Poisson candidate batches in chunks
// of 32 per lane.
//
// Both entry points gather from the majorant table at random, 42 times a
// ray. Served by L1, a warp's 32 scattered lookups take up to 32 passes;
// from shared memory they take as many as the busiest bank serves (a few).
// sv_res caps the table at 32,768 entries (128 KB), so each persistent
// block copies it into shared memory once.
//
// Entry point 1 is bound by bytes on this card: 168 B of majorants out per
// ray against 32 B of ray in (then by the 43 segment points' divisions).
// One persistent block per SM holds the table; one thread per ray builds
// the segment frame once and computes each of the 43 points once; a warp
// stages its 32 rays' majorants half a row at a time in its shared tile
// and stores them as runs of contiguous floats.
//
// Entry point 2 is bound by the latency of dependent work: each
// candidate's position depends on the previous one's, and each candidate
// reads one 16-byte row of the density table at a data-dependent address
// (the bf16-pair oct grid, ~13 MB for the smoke_port grid, stays in the
// 50 MB L2); device memory moves little. What the design does about it:
// - one exponential per candidate, not per segment: tau = -log(1 - u) is
//   drawn once and carried across segment boundaries, each segment taking
//   sigma * rate_s * (s_end - t) from it; a candidate falls where tau runs
//   out. Piecewise-constant rate and a memoryless exponential: the same
//   Poisson process as a restart at each boundary, at one Philox and one
//   log per candidate plus at most one more per walk (draw 0 at the
//   start, draw j right after candidate j - 1). Segments of zero rate cost
//   only their majorant step;
// - the segment frame is carried: point s + 1 becomes the next segment's
//   point s (media.cuh);
// - only the lanes that walk: a classify pass over all N lanes writes the
//   result of every lane that does not walk (vacuum, a homogeneous
//   medium, an empty box clip) and appends the others to a queue
//   (warp-aggregated atomicAdd); a persistent walk kernel, as many blocks
//   as fit on the card, takes the queue 32 lanes per warp at a time, its
//   length read on the device, so no host sync stands between the two;
// - the medium records and the majorant table live in each walk block's
//   shared memory.
// Every draw reads Philox counter (lane, 0, tag, j), j counting the
// lane's draws (with a per-lane call site array, tag | (site << 4): one
// walk then serves the lanes of several call sites), like the plain
// version (shade/media.py::_track_torch), in the same order, and a lane's
// result does not depend on the thread that walks it, so the two agree
// bit for bit.
#include "media.cuh"

namespace {

using namespace media;

constexpr int kWarp = 32;
constexpr int kMajThreads = 1024;     // threads per block of entry point 1
constexpr int kHalf = kNseg / 2;      // segments a warp stages at a time
constexpr int kTrackThreads = 256;    // lanes per block of the classify pass
constexpr int kWalkThreads = 1024;    // threads per persistent walk block

// Copies n floats (16-byte aligned) from device to shared memory.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int e = threadIdx.x; e < n / 4; e += blockDim.x) d4[e] = s4[e];
  for (int e = 4 * (n / 4) + threadIdx.x; e < n; e += blockDim.x)
    dst[e] = src[e];
}

// Entry point 1: the majorant table in shared memory, then per warp 32
// rays at a time, one thread per ray; each half row of 21 majorants goes
// through the warp's tile (odd stride: no bank conflict) to device memory.
__global__ void __launch_bounds__(kMajThreads, 1)
    majorant_kernel(const float* __restrict__ table,
                    const float* __restrict__ sv_max, int n_sv, int s1,
                    const float* __restrict__ ro, const float* __restrict__ rd,
                    const float* __restrict__ tmax_h,
                    const int32_t* __restrict__ med_idx,
                    float* __restrict__ maj, int n) {
  extern __shared__ float4 smem4[];
  float* ssv = reinterpret_cast<float*>(smem4);
  stage(ssv, sv_max, n_sv);
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  float* tile = ssv + 4 * ((n_sv + 3) / 4) + warp * (kWarp * kHalf);
  __syncthreads();
  const int stride = gridDim.x * kMajThreads;
  for (int base = blockIdx.x * kMajThreads + warp * kWarp; base < n;
       base += stride) {
    const int i = base + lane;
    const int rows = n - base < kWarp ? n - base : kWarp;
    int k = 0;
    float maxd = 0.f;
    bool local_ok = false;
    SegFrame f;
    V3 a, b;
    if (i < n) {
      k = med_idx[i] < 0 ? 0 : med_idx[i];
      const Medium m = load_medium(table + (size_t)k * kMedCols);
      f = seg_frame(m, load3(ro + 3 * i), load3(rd + 3 * i), tmax_h[i], s1);
      a = sv_coord(f, 0);
      b = sv_coord(f, 1);
      local_ok = segments_local(a, b);
      maxd = global_majorant(m);
    }
    for (int h = 0; h < 2; ++h) {
      if (i < n) {
        for (int c = 0; c < kHalf; ++c) {
          const int s = h * kHalf + c;
          float v = maxd;
          if (local_ok) {
            if (s) {
              a = b;
              b = sv_coord(f, s + 1);
            }
            v = segment_majorant(a, b, k, s1, ssv);
          }
          tile[lane * kHalf + c] = v;
        }
      }
      __syncwarp();
      float* dst = maj + (size_t)base * kNseg + h * kHalf;
      for (int e = lane; e < rows * kHalf; e += kWarp) {
        const int r = e / kHalf;
        dst[(size_t)r * kNseg + (e - r * kHalf)] = tile[e];
      }
      __syncwarp();
    }
  }
}

struct TrackArgs {
  const float* table;
  const float* sv_max;
  const uint4* oct4;
  const float* ro;
  const float* rd;
  const float* tmax_;
  const int32_t* med_idx;
  const int64_t* lanes;
  const int32_t* sites;   // NULL, or each lane's call site (tag bits 4-7)
  float* out;
  int32_t* cand;
  int32_t* queue;     // [n] lanes that walk, in no fixed order
  int32_t* counters;  // [0] queue length, [1] next queue entry to take
  int n, n_media, n_sv, s1, dz1, dy1, dx1, mode, iter_max;
  uint32_t seed, iteration, tag;
};

// Classify pass: the result of every lane that does not walk; the others
// join the queue.
__global__ void __launch_bounds__(kTrackThreads) classify_kernel(TrackArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool walk = false;
  if (i < a.n) {
    const bool sample = a.mode == 0;
    const int k = a.med_idx[i];
    float out = sample ? INFINITY : 1.f;
    if (k >= 0) {
      const Medium m = load_medium(a.table + (size_t)k * kMedCols);
      if (m.type == kHeterogeneous) {
        float t0, ln;
        box_clip(m, load3(a.ro + 3 * i), load3(a.rd + 3 * i), a.tmax_[i], &t0,
                 &ln);
        walk = ln > 0.f;
        if (!sample)
          out = tr_out(m.ett == 2, 1.f, ln, 0.5f * global_majorant(m),
                       m.sigma);
      }
    }
    if (!walk) {
      a.out[i] = out;
      a.cand[i] = 0;
    }
  }
  // every thread of the warp reaches the ballot (the grid is whole warps)
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, walk);
  if (mask) {
    const int lane = threadIdx.x & (kWarp - 1);
    const int leader = __ffs(mask) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(a.counters, __popc(mask));
    base = __shfl_sync(0xFFFFFFFFu, base, leader);
    if (walk) a.queue[base + __popc(mask & ((1u << lane) - 1u))] = i;
  }
}

// One lane's walk: lane i is in heterogeneous medium k and its box clip
// is not empty. `table` and `sv_max` are the block's shared copies.
__device__ __forceinline__ void walk_lane(const TrackArgs& a,
                                          const float* table,
                                          const float* sv_max, int i) {
  const bool sample = a.mode == 0;
  const int k = a.med_idx[i];
  const Medium m = load_medium(table + k * kMedCols);
  const V3 ro = load3(a.ro + 3 * i);
  const V3 rd = load3(a.rd + 3 * i);
  float t0, ln;
  box_clip(m, ro, rd, a.tmax_[i], &t0, &ln);
  const V3 ro_h = add(ro, scl(rd, t0));
  const SegFrame f = seg_frame(m, ro_h, rd, ln, a.s1);
  const float maxd = global_majorant(m);
  const float ce = 0.5f * maxd;
  const V3 span = mk(tmax(m.p1.x - m.p0.x, 1e-30f),
                     tmax(m.p1.y - m.p0.y, 1e-30f),
                     tmax(m.p1.z - m.p0.z, 1e-30f));
  const bool residual = !sample && m.ett == 2;
  const uint32_t lane = (uint32_t)a.lanes[i];
  const uint32_t tag =
      a.sites ? a.tag | ((uint32_t)a.sites[i] << 4) : a.tag;
  V3 pa = sv_coord(f, 0);
  V3 pb = sv_coord(f, 1);
  const bool local_ok = segments_local(pa, pb);
  float maj = local_ok ? segment_majorant(pa, pb, k, a.s1, sv_max) : maxd;
  float out = sample ? INFINITY : 1.f;
  float tr = 1.f;
  float t = 0.f;
  int s = 0, nc = 0;
  // draw 0 up front, draw j right after candidate j - 1
  uint4 w = philox(lane, 0u, tag, 0u, a.seed, a.iteration);
  int j = 1;
  float tau = -logf(1.f - bits_to_uniform(w.x));
  for (;;) {
    const float rate = residual ? tmax(maj, ce) : maj;
    const float lam = m.sigma * rate;
    const float s_end = (float)(s + 1) * f.seg;
    const float depth = lam * (s_end - t);
    if (!(tau < depth)) {   // tau outlasts the segment: cross it
      tau = tau - depth;
      t = s_end;
      if (++s == kNseg) break;
      if (local_ok) {
        pa = pb;
        pb = sv_coord(f, s + 1);
        maj = segment_majorant(pa, pb, k, a.s1, sv_max);
      }
      continue;
    }
    t = tmin(t + tau / lam, s_end);   // the candidate
    ++nc;
    const V3 p = add(ro_h, scl(rd, t));
    const V3 pos_norm = mk((p.x - m.p0.x) / span.x, (p.y - m.p0.y) / span.y,
                           (p.z - m.p0.z) / span.z);
    const float dens =
        density_oct(a.oct4, k, m.n, a.dz1, a.dy1, a.dx1, pos_norm);
    const bool hit = dens > bits_to_uniform(w.y) * maj;
    if (sample) {
      if (hit) {
        out = t0 + t;
        break;
      }
    } else {
      if (m.ett == 0) {
        if (hit) tr = 0.f;
      } else if (m.ett == 1) {
        tr = tr * (1.f - dens / tmax(maj, 1e-30f));
      } else {
        tr = tr * (1.f - (dens - ce) / tmax(rate, 1e-30f));
      }
      // Russian roulette below 0.1 (medium.h:95-104, 117-127)
      if (m.ett != 0 && tr < 0.1f && tr >= 0.f)
        tr = bits_to_uniform(w.z) < 1.f - tr ? 0.f : 1.f;
      if (tr == 0.f) break;
    }
    if (j >= a.iter_max) break;
    w = philox(lane, 0u, tag, (uint32_t)j, a.seed, a.iteration);
    ++j;
    tau = -logf(1.f - bits_to_uniform(w.x));
  }
  if (!sample) out = tr_out(residual, tr, ln, ce, m.sigma);
  a.out[i] = out;
  a.cand[i] = nc;
}

// The persistent walk: the block stages the medium records and the
// majorant table in shared memory once, then each warp takes 32 queue
// entries at a time until the queue is empty.
__global__ void __launch_bounds__(kWalkThreads, 1) walk_kernel(TrackArgs a) {
  extern __shared__ float4 smem4[];
  const int count = a.counters[0];
  if ((int)blockIdx.x * kWalkThreads >= count) return;   // blocks to spare
  float* table = reinterpret_cast<float*>(smem4);
  const int n_tab = a.n_media * kMedCols;   // a multiple of 4
  float* sv_max = table + n_tab;
  stage(table, a.table, n_tab);
  stage(sv_max, a.sv_max, a.n_sv);
  __syncthreads();
  const int lane = threadIdx.x & (kWarp - 1);
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(a.counters + 1, kWarp);
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    if (base >= count) break;
    if (base + lane < count) walk_lane(a, table, sv_max, a.queue[base + lane]);
  }
}

size_t majorant_smem_bytes(int n_sv) {
  return (4 * (size_t)((n_sv + 3) / 4) + (size_t)kMajThreads * kHalf) *
         sizeof(float);
}

size_t walk_smem_bytes(int n_media, int n_sv) {
  return ((size_t)n_media * kMedCols + (size_t)n_sv) * sizeof(float);
}

// Blocks of `kernel` that fit on one SM of the current card with `smem`
// bytes of dynamic shared memory each (the occupancy API), after raising
// the kernel's shared-memory limit to `smem`; -1 on a CUDA error.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

// Persistent blocks of `threads` threads for `units` work items, one a
// thread: as many as fit on the current card, at most one per `threads`
// items; 0 with the CUDA error in *rc if none fits.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int threads, size_t smem, int units,
                      int* rc) {
  const int per_sm = blocks_per_sm(kernel, threads, smem);
  int dev = 0, sms = 0;
  if (per_sm < 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    *rc = (int)cudaGetLastError();
    return 0;
  }
  if (per_sm == 0) {
    *rc = (int)cudaErrorInvalidConfiguration;
    return 0;
  }
  const int needed = (units + threads - 1) / threads;
  return per_sm * sms < needed ? per_sm * sms : needed;
}

}  // namespace

// Entry point 1, K5's counterpart: maj [n, 42] of each ray's segments.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int segment_majorants(const float* table, const float* sv_max,
                                 int n_sv, int s1, const float* ro,
                                 const float* rd, const float* tmax_h,
                                 const int32_t* med_idx, float* maj, int n,
                                 void* stream) {
  const size_t smem = majorant_smem_bytes(n_sv);
  int rc = 0;
  const int blocks =
      persistent_blocks(majorant_kernel, kMajThreads, smem, n, &rc);
  if (blocks == 0) return rc;
  majorant_kernel<<<blocks, kMajThreads, smem, (cudaStream_t)stream>>>(
      table, sv_max, n_sv, s1, ro, rd, tmax_h, med_idx, maj, n);
  return (int)cudaGetLastError();
}

// Entry point 2: the tracking walk, mode 0 (first collision) or 1 (Tr):
// the classify pass, then the persistent walk, both on `stream`.
// `sites` NULL: every lane draws at `tag`. `queue` is int32 [n] scratch;
// `counters` two int32, set to 0 here.
extern "C" int track(const float* table, int n_media, const float* sv_max,
                     int n_sv, int s1, const float* oct4, int dz1, int dy1,
                     int dx1, const float* ro, const float* rd,
                     const float* tmax_, const int32_t* med_idx,
                     const int64_t* lanes, const int32_t* sites,
                     uint32_t seed, uint32_t iteration, uint32_t tag,
                     int mode, int iter_max, float* out,
                     int32_t* cand, int32_t* queue, int32_t* counters, int n,
                     void* stream) {
  TrackArgs a;
  a.table = table;
  a.sv_max = sv_max;
  a.oct4 = reinterpret_cast<const uint4*>(oct4);
  a.ro = ro;
  a.rd = rd;
  a.tmax_ = tmax_;
  a.med_idx = med_idx;
  a.lanes = lanes;
  a.sites = sites;
  a.out = out;
  a.cand = cand;
  a.queue = queue;
  a.counters = counters;
  a.n = n;
  a.n_media = n_media;
  a.n_sv = n_sv;
  a.s1 = s1;
  a.dz1 = dz1;
  a.dy1 = dy1;
  a.dx1 = dx1;
  a.mode = mode;
  a.iter_max = iter_max;
  a.seed = seed;
  a.iteration = iteration;
  a.tag = tag;
  const cudaStream_t st = (cudaStream_t)stream;
  int rc = (int)cudaMemsetAsync(counters, 0, 2 * sizeof(int32_t), st);
  if (rc != 0) return rc;
  classify_kernel<<<(n + kTrackThreads - 1) / kTrackThreads, kTrackThreads, 0,
                    st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t smem = walk_smem_bytes(n_media, n_sv);
  const int blocks =
      persistent_blocks(walk_kernel, kWalkThreads, smem, n, &rc);
  if (blocks == 0) return rc;
  walk_kernel<<<blocks, kWalkThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The launch shapes for n_media media and an n_sv-entry majorant table:
// out[0] threads per walk block, out[1] walk blocks per SM (the occupancy
// API), out[2] its shared-memory bytes; out[3..5] the same for entry
// point 1. Returns a CUDA error code. Only this library can ask the
// occupancy API about its kernels; chip_smoke.py reports the answer.
extern "C" int track_occupancy(int n_media, int n_sv, int* out) {
  out[0] = kWalkThreads;
  out[2] = (int)walk_smem_bytes(n_media, n_sv);
  out[1] = blocks_per_sm(walk_kernel, kWalkThreads, out[2]);
  out[3] = kMajThreads;
  out[5] = (int)majorant_smem_bytes(n_sv);
  out[4] = blocks_per_sm(majorant_kernel, kMajThreads, out[5]);
  return out[1] < 0 || out[4] < 0 ? (int)cudaGetLastError() : 0;
}
