// Heterogeneous-medium device functions of the tracking kernels
// (csrc/track.cu, the counterpart of the TPU kernel
// gpu_pathtracer_tpu/ops/small_gather.py::_kernel; what bounds its two
// entry points on the H100 and what their design does about it is in
// its header): the packed medium record, the density-box clip, the
// supervoxel frame of a ray's segments and the per-segment majorant step,
// and the trilinear density of the bf16-pair oct table; and the phase
// function of the VPT and BDPT kernels. Each is written
// in the operation order of its plain PyTorch version in shade/media.py
// (built with -fmad=false, no fast math), so the kernel and the plain
// version agree bit for bit.
//
// Segment s of a ray spans the segment points s and s + 1. Both entry
// points of track.cu walk the points in order and carry point s + 1 into
// the next segment as its point s: 43 points per ray, each computed once,
// where a segment that computed both of its ends would compute 84.
#pragma once

#include "philox.cuh"
#include "vec.cuh"

namespace media {

constexpr int kNseg = 42;       // shade/media.py NSEG
constexpr int kMedCols = 24;    // scene/flatten.py MED_COLS
constexpr int kHeterogeneous = 1;
constexpr float kLn2Eps = 1e-30f;

// One row of the scene's med_table (scene/flatten.py::media_table), read
// from device or shared memory.
struct Medium {
  int type, ett;
  float imd, sigma;   // 1 / max density, luminance of sigma_t
  V3 p0, p1, n;
};

__device__ __forceinline__ Medium load_medium(const float* r) {
  Medium m;
  m.type = (int)r[0];
  m.imd = r[11];
  m.ett = (int)r[12];
  m.p0 = mk(r[13], r[14], r[15]);
  m.p1 = mk(r[16], r[17], r[18]);
  m.n = mk(r[19], r[20], r[21]);
  m.sigma = r[22];
  return m;
}

// The scattering columns of a med_table row, read through the read-only
// cache: the VPT step's distance sample, phase function and Beer-Lambert
// Tr (csrc/vpt_shade.cu; shade/media.py::gather_medium).
struct Optics {
  float g, sigma;     // HG asymmetry, luminance of sigma_t
  V3 sigma_s, sigma_t;
};

__device__ __forceinline__ Optics load_optics(const float* r) {
  Optics o;
  o.g = __ldg(r + 1);
  o.sigma_s = mk(__ldg(r + 5), __ldg(r + 6), __ldg(r + 7));
  o.sigma_t = mk(__ldg(r + 8), __ldg(r + 9), __ldg(r + 10));
  o.sigma = __ldg(r + 22);
  return o;
}

// _box_clip: the ray's overlap [t0, t0 + ln] with the density box in
// [0, tmax_].
__device__ __forceinline__ float slab_inv(float d) {
  const float eps = 1e-20f;
  return 1.f / (fabsf(d) > eps ? d : (d >= 0.f ? eps : -eps));
}
__device__ __forceinline__ void box_clip(const Medium& m, V3 ro, V3 rd,
                                         float tmax_, float* t0, float* ln) {
  const V3 inv = mk(slab_inv(rd.x), slab_inv(rd.y), slab_inv(rd.z));
  const V3 t1 = mul(sub(m.p0, ro), inv);
  const V3 t2 = mul(sub(m.p1, ro), inv);
  const float tn = tmax(tmax(tmin(t1.x, t2.x), tmin(t1.y, t2.y)),
                        tmin(t1.z, t2.z));
  const float tf = tmin(tmin(tmax(t1.x, t2.x), tmax(t1.y, t2.y)),
                        tmax(t1.z, t2.z));
  const float a = tmin(tmax(tn, 0.f), tmax_);
  const float b = tmin(tmax(tf, 0.f), tmax_);
  *t0 = a;
  *ln = tmax(b - a, 0.f);
}

// The supervoxel coordinates of the ray's k-th segment point (k = 0..42).
struct SegFrame {
  V3 ro, rd, p0, span;
  float seg, scale;   // segment length, S1 - 1
};

__device__ __forceinline__ SegFrame seg_frame(const Medium& m, V3 ro, V3 rd,
                                              float ln, int s1) {
  SegFrame f;
  f.ro = ro;
  f.rd = rd;
  f.p0 = m.p0;
  f.span = sub(m.p1, m.p0);
  f.seg = ln / (float)kNseg;
  f.scale = (float)s1 - 1.f;
  return f;
}

__device__ __forceinline__ V3 sv_coord(const SegFrame& f, int k) {
  const float tk = (float)k * f.seg;
  const V3 p = add(f.ro, scl(f.rd, tk));
  const V3 q = mk((p.x - f.p0.x) / f.span.x, (p.y - f.p0.y) / f.span.y,
                  (p.z - f.p0.z) / f.span.z);
  return scl(q, f.scale);
}

__device__ __forceinline__ int sv_cell(float lo, int s1) {
  const int c = (int)floorf(lo) + 1;
  return c < 0 ? 0 : (c > s1 - 1 ? s1 - 1 : c);
}

// min(a, b), NaN where either is NaN: the floor of tmin(a, b) without
// its branches (sv_cell maps every NaN to the same cell).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// The local majorants hold when segment 0 (points a = 0, b = 1) spans at
// most one supervoxel on every axis; otherwise every segment of the ray
// takes the global majorant (the plain version decides the same way).
__device__ __forceinline__ bool segments_local(V3 a, V3 b) {
  return fabsf(b.x - a.x) <= 1.f && fabsf(b.y - a.y) <= 1.f &&
         fabsf(b.z - a.z) <= 1.f;
}

// The per-segment step of _segment_majorants (the JAX package's K5
// lookup): the max of the 2x2x2 supervoxel block at the low corner of the
// segment between points a and b, read from medium k's slice of the
// majorant table (a shared-memory copy in both entry points).
__device__ __forceinline__ float segment_majorant(V3 a, V3 b, int k, int s1,
                                                  const float* sv_max) {
  const int cx = sv_cell(nan_min(a.x, b.x), s1);
  const int cy = sv_cell(nan_min(a.y, b.y), s1);
  const int cz = sv_cell(nan_min(a.z, b.z), s1);
  return sv_max[k * (s1 * s1 * s1) + cz * (s1 * s1) + cy * s1 + cx];
}

__device__ __forceinline__ float global_majorant(const Medium& m) {
  return 1.f / tmax(m.imd, kLn2Eps);
}

// _density_oct: trilinear density at pos_norm in [0, 1]^3 of the grid box,
// from ONE 16-byte row of 8 bf16 corners (zero border).
__device__ __forceinline__ float density_oct(const uint4* __restrict__ oct4,
                                             int k, V3 n, int dz1, int dy1,
                                             int dx1, V3 pos_norm) {
  const V3 ps = mul(pos_norm, n);
  const V3 psi = mk(floorf(ps.x), floorf(ps.y), floorf(ps.z));
  const V3 f = sub(ps, psi);
  int xi = (int)psi.x + 1, yi = (int)psi.y + 1, zi = (int)psi.z + 1;
  xi = xi < 0 ? 0 : (xi > dx1 - 1 ? dx1 - 1 : xi);
  yi = yi < 0 ? 0 : (yi > dy1 - 1 ? dy1 - 1 : yi);
  zi = zi < 0 ? 0 : (zi > dz1 - 1 ? dz1 - 1 : zi);
  const int flat = k * (dz1 * dy1 * dx1) + zi * (dy1 * dx1) + yi * dx1 + xi;
  const uint4 v = __ldg(oct4 + flat);
  const uint32_t hm = 0xFFFF0000u;
  const float d00 = __uint_as_float(v.x & hm) * (1.f - f.x) +
                    __uint_as_float(v.x << 16) * f.x;
  const float d10 = __uint_as_float(v.y & hm) * (1.f - f.x) +
                    __uint_as_float(v.y << 16) * f.x;
  const float d01 = __uint_as_float(v.z & hm) * (1.f - f.x) +
                    __uint_as_float(v.z << 16) * f.x;
  const float d11 = __uint_as_float(v.w & hm) * (1.f - f.x) +
                    __uint_as_float(v.w << 16) * f.x;
  const float d0 = d00 * (1.f - f.y) + d10 * f.y;
  const float d1 = d01 * (1.f - f.y) + d11 * f.y;
  return d0 * (1.f - f.z) + d1 * f.z;
}

// What the walk returns in tr mode: the product of the candidates' factors
// tr, times the residual-ratio control exp(-ln * ce * sigma) at ett 2.
__device__ __forceinline__ float tr_out(bool residual, float tr, float ln,
                                        float ce, float sigma) {
  return residual ? tr * expf(-ln * ce * sigma) : tr;
}

// ---------------------------------------------------------------------------
// The phase function (shade/media.py::phase, sample_phase; core/
// sampling.py::hg_phase, hg_sample), shared by the VPT step (vpt_shade.cu)
// and the BDPT step and connections (bdpt.cu).
// ---------------------------------------------------------------------------
constexpr float kInvFourPi = (float)(1.0 / (4.0 * 3.14159265358979323846));

// core/sampling.py::hg_phase
__device__ __forceinline__ float hg_phase(float c, float g) {
  if (g == 0.f) return kInvFourPi;
  const float cubic = 1.f + g * g - 2.f * g * c;
  return kInvFourPi * (1.f - g * g) /
         sqrtf(tmax(cubic * cubic * cubic, 1e-30f));
}

// hg_sample's cosine about wi: the uniform sphere's below |g| 1e-3
__device__ __forceinline__ float hg_costheta(float g, float u1) {
  const float ct_iso = 1.f - 2.f * u1;
  float costheta = ct_iso;
  if (!(fabsf(g) < 1e-3f)) {
    const float sqrt_term = (1.f - g * g) / (1.f - g + 2.f * g * u1);
    costheta = (1.f + g * g - sqrt_term * sqrt_term) / (2.f * g);
  }
  return costheta;
}

// shade/media.py::sample_phase: the HG direction about wi (its pdf, the
// phase value, is hg_phase(hg_costheta(g, u1), g))
__device__ __forceinline__ V3 sample_phase(float g, V3 wi, float u1,
                                           float u2) {
  const float costheta = hg_costheta(g, u1);
  const float sintheta = sqrtf(tmax(1.f - costheta * costheta, 0.f));
  float cphi, sphi;
  sincos_2pi(u2, &cphi, &sphi);
  const V3 d = mk(sintheta * cphi, costheta, sintheta * sphi);
  V3 w;
  const V3 u = make_coordinate(wi, &w);
  return to_world(d, u, wi, w);
}

}  // namespace media
