// Media tracking kernel: per-segment supervoxel majorants (one thread per
// ray and segment) and the heterogeneous-medium tracking walk (first
// collision, or delta / ratio / residual-ratio transmittance, one thread
// per ray).
//
// Replaces the TPU kernel gpu_pathtracer_tpu/ops/small_gather.py::_kernel
// (pallas_call at small_gather.py:47), the lookup of one f32 per index in
// the <= 32,768-entry majorant table that media._segment_majorants makes,
// and the XLA candidate loops around it (media._sample_chunk_loop :734 and
// _tr_chunk_loop :893), which evaluate Poisson candidate batches in chunks
// of 32 per lane.
//
// What bounds it on an H100: latency of dependent loads. Each candidate's
// position depends on the previous one's, and each reads one 16-byte row
// of the density table at a data-dependent address; the table (the
// bf16-pair oct grid, ~13 MB for the smoke_port grid) and the 125 KB
// majorant table stay in the 50 MB L2, so device memory moves little and
// arithmetic is light (a log and ~60 flops per candidate).
//
// Design: one thread walks one ray in registers: clip to the density box,
// then the 42 segments in order, each with its majorant computed when the
// walk enters it (the same device function that entry point 1 writes out
// for all segments); candidates are exponential steps at rate
// sigma * majorant, restarted at each segment boundary, so empty
// supervoxels cost no load. No chunking, no compaction, no candidate
// queue: a finished ray's thread leaves, and the blocks of the wavefront's
// idle lanes (medium index -1) return at once, so the caller needs no
// host-side gate. Every draw reads Philox counter (lane, 0, tag, j) like
// the plain version (shade/media.py::_track_torch), in the same order, so
// the two agree bit for bit.
#include "media.cuh"

namespace {

using namespace media;

// One thread per (ray, segment), so that a warp's stores to maj [n, 42]
// are contiguous.
__global__ void majorant_kernel(const float* __restrict__ table,
                                const float* __restrict__ sv_max, int s1,
                                const float* __restrict__ ro,
                                const float* __restrict__ rd,
                                const float* __restrict__ tmax_h,
                                const int32_t* __restrict__ med_idx,
                                float* __restrict__ maj, int n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)n * kNseg) return;
  const int i = (int)(e / kNseg), s = (int)(e % kNseg);
  const int k = med_idx[i] < 0 ? 0 : med_idx[i];
  const Medium m = load_medium(table, k);
  const SegFrame f = seg_frame(m, load3(ro + 3 * i), load3(rd + 3 * i),
                               tmax_h[i], s1);
  maj[e] = segment_majorant(f, s, k, s1, sv_max, segments_local(f),
                            global_majorant(m));
}

struct TrackArgs {
  const float* table;
  const float* sv_max;
  const uint4* oct4;
  const float* ro;
  const float* rd;
  const float* tmax_;
  const int32_t* med_idx;
  const int32_t* lanes;
  float* out;
  int32_t* cand;
  int n, s1, dz1, dy1, dx1, mode, iter_max;
  uint32_t seed, iteration, tag;
};

__global__ void track_kernel(TrackArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const bool sample = a.mode == 0;
  const int k = a.med_idx[i];
  float out = sample ? INFINITY : 1.f;
  int nc = 0;
  if (k >= 0) {
    const Medium m = load_medium(a.table, k);
    if (m.type == kHeterogeneous) {
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
      float tr = 1.f;
      if (ln > 0.f) {
        const bool local_ok = segments_local(f);
        const uint32_t lane = (uint32_t)a.lanes[i];
        float t = 0.f;
        int s = 0, j = 0;
        float maj = segment_majorant(f, 0, k, a.s1, a.sv_max, local_ok, maxd);
        while (s < kNseg && j < a.iter_max) {
          const float rate = residual ? tmax(maj, ce) : maj;
          const float lam = m.sigma * rate;
          const float s_end = (float)(s + 1) * f.seg;
          float t_new = INFINITY;
          uint4 w = make_uint4(0u, 0u, 0u, 0u);
          if (lam > 0.f) {
            w = philox((uint32_t)lane, 0u, a.tag, (uint32_t)j, a.seed,
                       a.iteration);
            ++j;
            t_new = t + -logf(1.f - bits_to_uniform(w.x)) / lam;
          }
          if (!(t_new < s_end)) {   // no draw, or past the segment's end
            t = s_end;
            ++s;
            if (s < kNseg)
              maj = segment_majorant(f, s, k, a.s1, a.sv_max, local_ok,
                                     maxd);
            continue;
          }
          t = t_new;
          ++nc;
          const V3 p = add(ro_h, scl(rd, t));
          const V3 pos_norm =
              mk((p.x - m.p0.x) / span.x, (p.y - m.p0.y) / span.y,
                 (p.z - m.p0.z) / span.z);
          const float dens = density_oct(a.oct4, k, m.n, a.dz1, a.dy1, a.dx1,
                                         pos_norm);
          const bool hit = dens > bits_to_uniform(w.y) * maj;
          if (sample) {
            if (hit) {
              out = t0 + t;
              break;
            }
            continue;
          }
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
      }
      if (!sample) out = residual ? tr * expf(-ln * ce * m.sigma) : tr;
    }
  }
  a.out[i] = out;
  a.cand[i] = nc;
}

}  // namespace

// Entry point 1, K5's counterpart: maj [n, 42] of each ray's segments.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int segment_majorants(const float* table, const float* sv_max,
                                 int s1, const float* ro, const float* rd,
                                 const float* tmax_h, const int32_t* med_idx,
                                 float* maj, int n, void* stream) {
  const int threads = 128;
  const size_t total = (size_t)n * kNseg;
  majorant_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                    (cudaStream_t)stream>>>(table, sv_max, s1, ro, rd, tmax_h,
                                            med_idx, maj, n);
  return (int)cudaGetLastError();
}

// Entry point 2: the tracking walk, mode 0 (first collision) or 1 (Tr).
extern "C" int track(const float* table, const float* sv_max, int s1,
                     const float* oct4, int dz1, int dy1, int dx1,
                     const float* ro, const float* rd, const float* tmax_,
                     const int32_t* med_idx, const int32_t* lanes,
                     uint32_t seed, uint32_t iteration, uint32_t tag,
                     int mode, int iter_max, float* out, int32_t* cand, int n,
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
  a.out = out;
  a.cand = cand;
  a.n = n;
  a.s1 = s1;
  a.dz1 = dz1;
  a.dy1 = dy1;
  a.dx1 = dx1;
  a.mode = mode;
  a.iter_max = iter_max;
  a.seed = seed;
  a.iteration = iteration;
  a.tag = tag;
  const int threads = 128;
  track_kernel<<<(n + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
