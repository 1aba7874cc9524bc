// Ray/primitive and ray/box intersection shared by the dense hit kernel
// (dense.cu), the path-trace kernel (pt_fused.cu), the block-culled hit
// kernel (blocked.cu) and the BVH8 walk (bvh8_walk.cu).
//
// The three prim routines match gpu_pathtracer_tpu/geom/traverse.py:63-121
// and dense_tpu.py:54-123 (the reference's mesh.h:45-67, sphere.h:26-69,
// line.h:33-73) and the port's plain versions in geom/dense.py, operation
// for operation. Each returns whether the prim is hit within
// [tmin, tmax] and writes its t. The slab test matches geom/blocked.py::
// slab.
#pragma once

#include "vec.cuh"

// prim type codes of the dense_prims table (column 9); -1 marks pad rows
#define PRIM_TRIANGLE 0.f
#define PRIM_LINE 1.f
#define PRIM_SPHERE 2.f

// Moller-Trumbore against edges e1 = v1 - v0, e2 = v2 - v0.
__device__ __forceinline__ bool tri_hit(V3 ro, V3 rd, V3 v0, V3 e1, V3 e2,
                                        float tmin, float tmax_, float* t) {
  V3 s1 = cross(rd, e2);
  float div = dot(s1, e1);
  bool ok = fabsf(div) >= 1e-8f;
  float inv = 1.f / (ok ? div : 1.f);
  V3 s = sub(ro, v0);
  float b1 = dot(s, s1) * inv;
  ok = ok && (b1 >= 0.f) && (b1 <= 1.f);
  V3 s2 = cross(s, e1);
  float b2 = dot(rd, s2) * inv;
  ok = ok && (b2 >= 0.f) && (b1 + b2 <= 1.f);
  *t = dot(e2, s2) * inv;
  return ok && (*t >= tmin) && (*t <= tmax_);
}

// Quadratic, near root if beyond tmin else far root (sphere.h:42-69).
__device__ __forceinline__ bool sphere_hit(V3 ro, V3 rd, V3 c, float r,
                                           float tmin, float tmax_,
                                           float* t) {
  V3 op = sub(ro, c);
  float b = dot(op, rd);
  float cq = dot(op, op) - r * r;
  float delta = b * b - cq;
  bool ok = delta >= 0.f;
  float sq = sqrtf(tmax(delta, 0.f));
  float t1 = -b - sq;
  float t2 = -b + sq;
  bool use1 = t1 > tmin;
  *t = use1 ? t1 : t2;
  ok = ok && (*t > 0.f) && (*t <= tmax_);
  return ok && (use1 || (t1 > 0.f) || (t2 > tmin));
}

// Ray vs segment p0-p1 of width lerped w0 -> w1 (line.h:33-73); also
// returns the segment parameter s.
__device__ __forceinline__ bool line_hit(V3 ro, V3 rd, V3 p0, V3 p1,
                                         float w0, float w1, float tmin,
                                         float tmax_, float* t, float* s) {
  V3 v = sub(p1, p0);
  V3 w = sub(ro, p0);
  float a = dot(rd, rd);
  float b = dot(rd, v);
  float c = dot(v, v);
  float d = dot(rd, w);
  float e = dot(v, w);
  float det = a * c - b * b;
  bool ok = det != 0.f;
  float det_s = ok ? det : 1.f;
  *t = (b * e - c * d) / det_s;
  *s = tclamp((a * e - b * d) / det_s, 0.f, 1.f);
  ok = ok && (*t >= tmin) && (*t <= tmax_);
  V3 prl = sub(add(ro, scl(rd, *t)), add(p0, scl(v, *s)));
  float d2 = dot(prl, prl);
  float rr = w0 * (1.f - *s) + w1 * *s;
  return ok && (d2 <= rr * rr);
}

// 1 / d with |d| kept >= 1e-20 (sign kept, -0 counts as +): slab planes
// stay finite for axis-parallel rays (dense_tpu.py:324-330).
__device__ __forceinline__ float safe_inv(float d) {
  return 1.f / (fabsf(d) > 1e-20f ? d : (d >= 0.f ? 1e-20f : -1e-20f));
}

// Slab test of the box [lo, hi] against a ray (origin o, inverse
// direction inv): hit when tf > 1e-5, tn <= tf and tn <= tmax_; writes
// the entry distance tn.
__device__ __forceinline__ bool slab_hit(V3 lo, V3 hi, V3 o, V3 inv,
                                         float tmax_, float* tn_out) {
  float t1 = (lo.x - o.x) * inv.x;
  float t2 = (hi.x - o.x) * inv.x;
  float tn = tmin(t1, t2);
  float tf = tmax(t1, t2);
  t1 = (lo.y - o.y) * inv.y;
  t2 = (hi.y - o.y) * inv.y;
  tn = tmax(tn, tmin(t1, t2));
  tf = tmin(tf, tmax(t1, t2));
  t1 = (lo.z - o.z) * inv.z;
  t2 = (hi.z - o.z) * inv.z;
  tn = tmax(tn, tmin(t1, t2));
  tf = tmin(tf, tmax(t1, t2));
  *tn_out = tn;
  return (tf > 1e-5f) && (tn <= tf) && (tn <= tmax_);
}

// ---------------------------------------------------------------------
// Routines of the redesigned hit tests (dense.cu K1, blocked.cu K3,
// bvh8_walk.cu K4 and pt_fused.cu K2's prim loops). They pick rows as
// the plain versions do within the hit limits, not bit for bit:
// - the triangle test compares the barycentric numerators and t's
//   numerator against |det| (signs flipped by det's sign) and does not
//   divide: the kernels keep their best hit as a fraction tnum / |det|
//   and compare fractions by cross products, where the plain version
//   multiplies by 1 / det; equal rows give equal products, so the tie
//   rules hold exactly; the winning triangle's t is then computed with
//   tri_hit, the plain version's arithmetic;
// - its dot and cross products are fused multiply-adds (fdot, fcross,
//   written out: every source is built with -fmad=false, so nothing else
//   fuses and the sphere, line and box tests stay those of the plain
//   versions);
// - K1 and K2 take det and t's numerator from the triangle's normal
//   n = e1 x e2 (staged once per row, stage_rows): det = -d.n,
//   tnum = (o - v0).n, the barycentrics from q = (o - v0) x d.

__device__ __forceinline__ float fdot(V3 a, V3 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, a.z * b.z));
}
__device__ __forceinline__ V3 fcross(V3 a, V3 b) {
  return mk(fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
            fmaf(a.x, b.y, -(a.y * b.x)));
}

// x with its sign flipped where `sb` holds a sign bit
__device__ __forceinline__ float flip(float x, unsigned sb) {
  return __uint_as_float(__float_as_uint(x) ^ sb);
}

// Whether the ray's line crosses triangle (v0, e1, e2) (Moller-Trumbore on
// numerators, |det| >= 1e-8 as in tri_hit); writes t's sign-adjusted
// numerator and |det|.
__device__ __forceinline__ bool tri_cross(V3 o, V3 d, V3 v0, V3 e1, V3 e2,
                                          float* tnum, float* adet) {
  const V3 s1 = fcross(d, e2);
  const float det = fdot(s1, e1);
  const unsigned sb = __float_as_uint(det) & 0x80000000u;
  const V3 s = sub(o, v0);
  const V3 s2 = fcross(s, e1);
  const float u = flip(fdot(s, s1), sb);
  const float v = flip(fdot(d, s2), sb);
  *tnum = flip(fdot(e2, s2), sb);
  *adet = fabsf(det);
  return *adet >= 1e-8f && u >= 0.f && v >= 0.f && u + v <= *adet;
}

// tri_cross from the staged normal n = e1 x e2 (n = 0 never crosses).
__device__ __forceinline__ bool tri_cross_n(V3 o, V3 d, V3 v0, V3 e1, V3 e2,
                                            V3 n, float* tnum,
                                            float* adet) {
  const V3 s = sub(o, v0);
  const float dn = fdot(d, n);                  // det = -dn
  const unsigned sb = (__float_as_uint(dn) & 0x80000000u) ^ 0x80000000u;
  const V3 q = fcross(s, d);
  const float u = flip(fdot(e2, q), sb);
  const float v = flip(-fdot(e1, q), sb);
  *tnum = flip(fdot(s, n), sb);
  *adet = fabsf(dn);
  return *adet >= 1e-8f && u >= 0.f && v >= 0.f && u + v <= *adet;
}

// t widened by 1e-6 relative (infinities stay): a culling bound that is
// never below the exact t of a fraction tnum / |det|.
__device__ __forceinline__ float widen_hi(float t) {
  return t + fabsf(t) * 1e-6f;
}

// Whether the interval [tmin, tmax] can hold no hit: tmax < tmin (no
// triangle or line then), and for a table with spheres also tmax <= 0
// (sphere_hit takes its far root when the near one is at or below tmin,
// which needs only t > 0 and t <= tmax). A NaN tmax holds no hit either.
template <bool kSpheres>
__device__ __forceinline__ bool empty_interval(float tmin, float tmax_) {
  return !(tmax_ >= tmin) && (!kSpheres || !(tmax_ > 0.f));
}

// Stage a [n_prims, 16] dense_prims table into shared memory with each
// triangle's normal n = e1 x e2 in columns 13-15 (0 for any other row);
// column 12 (the prim id) is kept. All threads of the block take part;
// ends with a barrier.
__device__ __forceinline__ void stage_rows(float4* dst, const float* src,
                                           int n_prims) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int p = threadIdx.x; p < n_prims; p += blockDim.x) {
    const float4 q0 = s4[4 * p], q1 = s4[4 * p + 1], q2 = s4[4 * p + 2];
    V3 n = mk(0.f, 0.f, 0.f);
    if (q2.y == PRIM_TRIANGLE) {
      n = fcross(mk(q0.w, q1.x, q1.y), mk(q1.z, q1.w, q2.x));
    }
    dst[4 * p] = q0;
    dst[4 * p + 1] = q1;
    dst[4 * p + 2] = q2;
    dst[4 * p + 3] = make_float4(s4[4 * p + 3].x, n.x, n.y, n.z);
  }
  __syncthreads();
}

// Insert `key` into the ascending list l of N keys (the largest falls
// off): the sorted register lists of K3's blocks and K4's instances.
template <int N>
__device__ __forceinline__ void list_insert(unsigned (&l)[N], unsigned key) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const unsigned lo = min(l[i], key);
    key = max(l[i], key);
    l[i] = lo;
  }
}
