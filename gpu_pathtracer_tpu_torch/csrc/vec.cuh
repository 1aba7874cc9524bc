// 3-vector math and PyTorch-compatible scalar helpers for the port's
// kernels.
//
// Every expression is written in the operation order of the plain
// PyTorch code it mirrors (core/vecmath.py, shade/*.py): the libraries
// are built with -fmad=false and without fast math, so each product,
// sum, division and sqrt rounds exactly as PyTorch's own elementwise
// kernels do, and a kernel can be held to its plain version lane by
// lane. tmax/tmin/tclamp propagate NaN like torch.maximum/torch.clamp
// (fmaxf/fminf would drop it).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return mk(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return mk(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return mk(a.x * b.x, a.y * b.y, a.z * b.z);
}
// s * v (scalar on the left or right: the product is exact either way)
__device__ __forceinline__ V3 scl(V3 a, float s) {
  return mk(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 divs(V3 a, float s) {
  return mk(a.x / s, a.y / s, a.z / s);
}
__device__ __forceinline__ V3 neg(V3 a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tclamp(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}
__device__ __forceinline__ bool finite3(V3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}
__device__ __forceinline__ bool is_black(V3 c) {
  return c.x <= 0.f && c.y <= 0.f && c.z <= 0.f;
}

// core/vecmath.py::normalize: v / sqrt(max(dot(v, v), 1e-30))
__device__ __forceinline__ V3 normalize(V3 v) {
  return divs(v, sqrtf(tmax(dot(v, v), 1e-30f)));
}
// core/vecmath.py::reflect: 2*dot(wi, n)*n - wi
__device__ __forceinline__ V3 reflect(V3 wi, V3 n) {
  return sub(scl(n, 2.f * dot(wi, n)), wi);
}
__device__ __forceinline__ V3 face_forward(V3 n, V3 d) {
  return dot(n, d) < 0.f ? neg(n) : n;
}
// core/vecmath.py::to_world: d.x*u + d.y*v + d.z*w
__device__ __forceinline__ V3 to_world(V3 d, V3 u, V3 v, V3 w) {
  return add(add(scl(u, d.x), scl(v, d.y)), scl(w, d.z));
}

__device__ __forceinline__ V3 load3(const float* p) {
  return mk(p[0], p[1], p[2]);
}
__device__ __forceinline__ void store3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

// core/vecmath.py::make_coordinate(n) -> u (w is returned through *w)
__device__ __forceinline__ V3 make_coordinate(V3 n, V3* w_out) {
  const bool use_x = fabsf(n.x) > fabsf(n.y);
  const float inv_x = 1.f / sqrtf(n.x * n.x + n.z * n.z + 1e-30f);
  const float inv_y = 1.f / sqrtf(n.y * n.y + n.z * n.z + 1e-30f);
  const V3 w = use_x ? mk(n.z * inv_x, 0.f, -n.x * inv_x)
                     : mk(0.f, n.z * inv_y, -n.y * inv_y);
  *w_out = w;
  return cross(w, n);
}
// core/sampling.py::sincos_2pi: (cos, sin) of 2 pi u from one
// transcendental
__device__ __forceinline__ void sincos_2pi(float u, float* c, float* s) {
  *c = cosf((float)(2.0 * 3.14159265358979323846) * u);
  const float r = sqrtf(tmax(1.f - *c * *c, 0.f));
  *s = u <= 0.5f ? r : -r;
}
