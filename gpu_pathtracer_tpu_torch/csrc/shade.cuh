// Per-thread shading of one path-trace bounce, shared by the path-trace
// megakernel (pt_fused.cu, K2) and the wavefront's shading kernel
// (pt_shade.cu): the random sites of a bounce, vector math and sampling,
// the six BSDF models, the hit record rebuilt from a prim_attrs row, the
// texture fetch, the environment light and the emitter credits.
//
// Every routine is the plain PyTorch wavefront's arithmetic
// (integrators/pt.py, shade/*.py) written per thread, in the same
// operation order (vec.cuh), so both kernels shade as their plain
// versions do; one copy keeps the two kernels from drifting apart.
//
// The VPT wavefront's step kernel (vpt_shade.cu) shares it too: the
// light pick (pick_light), the material with its texel (hit_material)
// and the light sample (sample_light). BDPT's kernels (bdpt.cu) share the
// hit record, the material, the BSDFs (sample_bsdf_mode in importance
// transport on the light subpaths) and the light pick, and add the
// camera's primary ray and importance, the area light's emission, pdf,
// Le and sample with its normal, and ConvertPdf (the last section), none
// of which the other kernels call.
//
// Four steps of a bounce exist twice. K2's bounce() (pt_fused.cu) writes
// them inline; hit_material and sample_light here, and nee_contrib and
// continue_path in pt_shade.cu, are the same steps as functions, line for
// line. K2 calling them as functions raised its sky variants from 96 to
// 105-106 registers and slowed them (PERF.md section 6), so the copies
// stay. An edit to one copy must reach the other: chip_smoke.py holds
// each kernel to the plain version (pt_shade.cu and vpt_shade.cu bit for
// bit, phases S and V) and K2 to the wavefront over pt_shade.cu (phase
// C).
#pragma once

#include "intersect.cuh"
#include "philox.cuh"

namespace {

// ---------------------------------------------------------------------------
// constants (double expressions rounded to float, as PyTorch rounds a
// Python float operand to the tensor's float32)
// ---------------------------------------------------------------------------
#define PI_D 3.14159265358979323846
constexpr float kPi = (float)PI_D;
constexpr float kTwoPi = (float)(2.0 * PI_D);
constexpr float kInvPi = (float)(1.0 / PI_D);
constexpr float kInvTwoPi = (float)(1.0 / (2.0 * PI_D));
constexpr float kInvFourPi = (float)(1.0 / (4.0 * PI_D));
constexpr float kSubstrateK = (float)(28.0 / (23.0 * PI_D));
constexpr float kLuma0 = 0.212671f, kLuma1 = 0.715160f, kLuma2 = 0.072169f;

// MaterialType (scene/model.py)
enum { LAMBERTIAN = 0, MIRROR = 1, DIELECTRIC = 2, ROUGHDIELECTRIC = 3,
       ROUGHCONDUCTOR = 4, SUBSTRATE = 5 };

// table layouts (scene/flatten.py)
constexpr int kPrimAttrs = 40;   // v0 v1 v2 | n0 n1 n2 | uv | dpdv | r0 r1 |
                                 // type mat light ...
constexpr int kMatAttrs = 24;    // type aU aV iIOR oIOR | k | eta | diffuse |
                                 // specular | tex_idx | ...
constexpr int kLightAttrs = 24;  // v0 v1 v2 | n0 n1 n2 | radiance | ...
constexpr int kCamDims = 4;      // core/rng.py PSS_CAM_DIMS
constexpr int kBounceDims = 8;   // core/rng.py PSS_BOUNCE_DIMS

__device__ __forceinline__ V3 ldg3(const float* p) {
  return mk(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

// The 8 sites of one bounce: psample rows when given, else Philox.
struct BounceDraws {
  float u[kBounceDims];
};

__device__ __forceinline__ void bounce_draws(BounceDraws* d, int bounce,
                                             uint32_t lane, int lane_col,
                                             int n, uint32_t seed,
                                             uint32_t iteration,
                                             const float* psample) {
  const int base = kCamDims + bounce * kBounceDims;
  if (psample) {
#pragma unroll
    for (int k = 0; k < kBounceDims; ++k)
      d->u[k] = __ldg(psample + (size_t)(base + k) * n + lane_col);
    return;
  }
  const uint32_t blk = (uint32_t)(base >> 2);
  const uint4 a = philox(lane, blk, 0u, 0u, seed, iteration);
  const uint4 b = philox(lane, blk + 1u, 0u, 0u, seed, iteration);
  d->u[0] = bits_to_uniform(a.x);
  d->u[1] = bits_to_uniform(a.y);
  d->u[2] = bits_to_uniform(a.z);
  d->u[3] = bits_to_uniform(a.w);
  d->u[4] = bits_to_uniform(b.x);
  d->u[5] = bits_to_uniform(b.y);
  d->u[6] = bits_to_uniform(b.z);
  d->u[7] = bits_to_uniform(b.w);
}

// ---------------------------------------------------------------------------
// core/vecmath.py, core/sampling.py
// ---------------------------------------------------------------------------
__device__ __forceinline__ float luminance(V3 c) {
  return c.x * kLuma0 + c.y * kLuma1 + c.z * kLuma2;
}
__device__ __forceinline__ bool same_hemisphere(V3 a, V3 b, V3 n) {
  return dot(a, n) * dot(b, n) > 0.f;
}
__device__ __forceinline__ float length(V3 v) {
  return sqrtf(tmax(dot(v, v), 0.f));
}
// refract(wi, n, etai, etat), wi pointing away from the surface
__device__ __forceinline__ V3 refract(V3 wi, V3 n, float etai, float etat) {
  const float cosi = dot(wi, n);
  const bool enter = cosi > 0.f;
  const float ei = enter ? etai : etat;
  const float et = enter ? etat : etai;
  const float eta = ei / et;
  const float sini2 = 1.f - cosi * cosi;
  const float sint2 = sini2 * eta * eta;
  const float cost = sqrtf(tmax(1.f - sint2, 0.f));
  const float sign = enter ? -1.f : 1.f;
  return normalize(add(scl(sub(scl(n, cosi), wi), eta), scl(n, sign * cost)));
}
__device__ __forceinline__ V3 cosine_hemisphere(float u1, float u2,
                                                float* pdf) {
  const float st = sqrtf(tmax(u1, 0.f));
  const float ct = sqrtf(tmax(1.f - u1, 0.f));
  float cphi, sphi;
  sincos_2pi(u2, &cphi, &sphi);
  *pdf = ct * kInvPi;
  return mk(st * cphi, ct, st * sphi);
}
__device__ __forceinline__ V3 uniform_sphere(float u1, float u2) {
  const float ct = 1.f - 2.f * u1;
  const float st = sqrtf(tmax(1.f - ct * ct, 0.f));
  float cphi, sphi;
  sincos_2pi(u2, &cphi, &sphi);
  return mk(st * cphi, ct, st * sphi);
}
__device__ __forceinline__ float power_heuristic(float f, float g) {
  const float denom = f * f + g * g;
  return denom > 0.f ? f * f / denom : 0.f;
}

// ---------------------------------------------------------------------------
// shade/bsdf.py (radiance transport)
// ---------------------------------------------------------------------------
struct Mat {
  int type;
  float au, av, inside, outside;
  V3 k, eta, diffuse, specular;
};

__device__ __forceinline__ Mat gather_material(const float* mats, int idx) {
  const float* a = mats + (size_t)(idx < 0 ? 0 : idx) * kMatAttrs;
  Mat m;
  m.type = (int)__ldg(a);
  m.au = __ldg(a + 1);
  m.av = __ldg(a + 2);
  m.inside = __ldg(a + 3);
  m.outside = __ldg(a + 4);
  m.k = ldg3(a + 5);
  m.eta = ldg3(a + 8);
  m.diffuse = ldg3(a + 11);
  m.specular = ldg3(a + 14);
  return m;
}

__device__ __forceinline__ bool is_delta(int t) {
  return t == MIRROR || t == DIELECTRIC;
}

__device__ __forceinline__ float dielectric_fresnel(float cosi, float cost,
                                                    float etai, float etat) {
  const float d1 = etat * cosi + etai * cost;
  const float d2 = etai * cosi + etat * cost;
  const float rparl = (etat * cosi - etai * cost) / (fabsf(d1) > 1e-30f ? d1
                                                                        : 1.f);
  const float rperp = (etai * cosi - etat * cost) / (fabsf(d2) > 1e-30f ? d2
                                                                        : 1.f);
  return 0.5f * (rparl * rparl + rperp * rperp);
}

__device__ __forceinline__ float conduct_fresnel1(float c, float e, float k) {
  const float tmp = (e * e + k * k) * c * c;
  const float rparl2 =
      (tmp - 2.f * e * c + 1.f) / (tmp + 2.f * e * c + 1.f);
  const float tmp_f = e * e + k * k;
  const float rperp2 =
      (tmp_f - 2.f * e * c + c * c) / (tmp_f + 2.f * e * c + c * c);
  return 0.5f * (rparl2 + rperp2);
}
__device__ __forceinline__ V3 conduct_fresnel(float c, V3 eta, V3 k) {
  return mk(conduct_fresnel1(c, eta.x, k.x), conduct_fresnel1(c, eta.y, k.y),
            conduct_fresnel1(c, eta.z, k.z));
}

__device__ __forceinline__ V3 schlick_fresnel(V3 spec, float costheta) {
  const float c = 1.f - costheta;
  const float c5 = c * c * c * c * c;
  return mk(spec.x + c5 * (1.f - spec.x), spec.y + c5 * (1.f - spec.y),
            spec.z + c5 * (1.f - spec.z));
}

__device__ __forceinline__ float ggx_d(V3 wh, V3 n, V3 dpdu, float au,
                                       float av) {
  const float costheta = dot(wh, n);
  const float ct = tclamp(costheta, 0.f, 1.f);
  const float ct2 = ct * ct;
  const float st2 = 1.f - ct2;
  const float ct4 = ct2 * ct2;
  const float tt2 = st2 / tmax(ct2, 1e-12f);
  const float cosphi = dot(normalize(sub(wh, scl(n, ct))), dpdu);
  const float cosphi2 = cosphi * cosphi;
  const float sinphi2 = 1.f - cosphi2;
  const float sqr = 1.f + tt2 * (cosphi2 / (au * au) + sinphi2 / (av * av));
  const float d = 1.f / (kPi * au * av * tmax(ct4 * sqr * sqr, 1e-30f));
  return costheta > 0.f ? d : 0.f;
}

__device__ __forceinline__ float smith_g(V3 w, V3 n, V3 wh, V3 dpdu, float au,
                                         float av) {
  const float wdn = dot(w, n);
  const bool ok = wdn * dot(w, wh) >= 0.f;
  const float sintheta = sqrtf(tclamp(1.f - wdn * wdn, 0.f, 1.f));
  const float tantheta = sintheta / (fabsf(wdn) > 1e-12f ? wdn : 1e-12f);
  const float cosphi = dot(normalize(sub(w, scl(n, wdn))), dpdu);
  const float cosphi2 = cosphi * cosphi;
  const float sinphi2 = 1.f - cosphi2;
  const float alpha2 = cosphi2 * au * au + sinphi2 * av * av;
  const float sqr = alpha2 * tantheta * tantheta;
  const float g = 2.f / (1.f + sqrtf(1.f + sqr));
  return (ok && isfinite(tantheta)) ? g : 0.f;
}

__device__ __forceinline__ float ggx_g(V3 a, V3 b, V3 n, V3 wh, V3 dpdu,
                                       float au, float av) {
  return smith_g(a, n, wh, dpdu, au, av) * smith_g(b, n, wh, dpdu, au, av);
}

// local (+Y up) GGX half vector; aniso = the scene has an anisotropic
// material (StaticConfig.has_aniso), which selects the tan/atan form
__device__ __forceinline__ V3 sample_ggx(float au, float av, float u1,
                                         float u2, bool aniso) {
  const float denom = u1 * (au * av - 1.f) + 1.f;
  const float ct_iso =
      sqrtf(tclamp((1.f - u1) / tmax(denom, 1e-30f), 0.f, 1.f));
  if (!aniso) {
    float cphi, sphi;
    sincos_2pi(u2, &cphi, &sphi);
    const float st_iso = sqrtf(tclamp(1.f - ct_iso * ct_iso, 0.f, 1.f));
    return mk(st_iso * cphi, ct_iso, st_iso * sphi);
  }
  const float phi_iso = kTwoPi * u2;
  const float base = atanf(av / au * tanf(kTwoPi * u2));
  const float phi_a =
      u2 <= 0.25f ? base : (u2 >= 0.75f ? base + kTwoPi : base + kPi);
  const float sinphi = sinf(phi_a);
  const float cosphi2 = 1.f - sinphi * sinphi;
  const float sinphi2 = sinphi * sinphi;
  const float inv_a = 1.f / (cosphi2 / (au * au) + sinphi2 / (av * av));
  const float theta =
      atanf(sqrtf(tmax(inv_a * u1 / tmax(1.f - u1, 1e-12f), 0.f)));
  const float ct_a = cosf(theta);
  const bool iso = au == av;
  const float costheta = iso ? ct_iso : ct_a;
  const float phi = iso ? phi_iso : phi_a;
  const float sintheta = sqrtf(tclamp(1.f - costheta * costheta, 0.f, 1.f));
  return mk(sintheta * cosf(phi), costheta, sintheta * sinf(phi));
}

__device__ __forceinline__ void substrate_fr_pdf(const Mat& m, V3 wi, V3 wo,
                                                 V3 n, V3 dpdu, V3* fr,
                                                 float* pdf) {
  const float c0 = fabsf(dot(wi, n));
  const float c1 = fabsf(dot(wo, n));
  const float cons0 = 1.f - 0.5f * c0;
  const float cons1 = 1.f - 0.5f * c1;
  const float k5 = (1.f - cons0 * cons0 * cons0 * cons0 * cons0) *
                   (1.f - cons1 * cons1 * cons1 * cons1 * cons1);
  const V3 rd = m.diffuse, rs = m.specular;
  const V3 diffuse = mk(kSubstrateK * rd.x * (1.f - rs.x) * k5,
                        kSubstrateK * rd.y * (1.f - rs.y) * k5,
                        kSubstrateK * rd.z * (1.f - rs.z) * k5);
  const V3 wh = normalize(add(wi, wo));
  const float D = ggx_d(wh, n, dpdu, m.au, m.av);
  const float denom = 4.f * fabsf(dot(wo, wh)) * tmax(c0, c1);
  const float s = D / tmax(denom, 1e-12f);
  const V3 sf = schlick_fresnel(rs, dot(wo, wh));
  *fr = add(diffuse, mk(s * sf.x, s * sf.y, s * sf.z));
  const float dwh = dot(wi, wh);
  *pdf = 0.5f * (c1 * kInvPi + D * fabsf(dot(wh, n)) /
                                   (4.f * (fabsf(dwh) > 1e-12f ? dwh : 1e-12f)));
}

// reflection / refraction scale and pdf of the rough dielectric;
// kImportance: light transport (bsdf.py's IMPORTANCE mode), whose
// refraction leaves out radiance's 1 / eta^2
template <bool kImportance = false>
__device__ __forceinline__ void rough_dielectric_lobes(
    const Mat& m, V3 wi_in, V3 wo, V3 n, V3 wh, V3 dpdu, float ei, float et,
    float eta, float fresnel, float f_refl, float* s_refl, float* pdf_refl,
    float* s_refr, float* pdf_refr) {
  const float D = ggx_d(wh, n, dpdu, m.au, m.av);
  const float G = ggx_g(wi_in, wo, n, wh, dpdu, m.au, m.av);
  const float abs_in_n = fabsf(dot(wi_in, n));
  const float abs_out_n = fabsf(dot(wo, n));
  *s_refl = f_refl * D * G / tmax(4.f * abs_in_n * abs_out_n, 1e-12f);
  *pdf_refl = D * fabsf(dot(wh, n)) / tmax(4.f * fabsf(dot(wh, wi_in)),
                                           1e-12f) * f_refl;
  const float c = et * dot(wo, wh) + ei * dot(wi_in, wh);
  const float c2 = tmax(c * c, 1e-12f);
  float sr = ei * ei * D * G * (1.f - fresnel) * fabsf(dot(wi_in, wh)) *
             fabsf(dot(wo, wh)) / tmax(abs_out_n * abs_in_n * c2, 1e-12f);
  *s_refr = kImportance ? sr : sr * (1.f / tmax(eta * eta, 1e-12f));
  *pdf_refr = (1.f - fresnel) * D * fabsf(dot(wh, n)) * et * et *
              fabsf(dot(wo, wh)) / c2;
}

// Fr dispatch (eval_bsdf): delta models give 0
__device__ void eval_bsdf(const Mat& m, V3 wi, V3 wo, V3 nor, V3 dpdu,
                          V3* fr, float* pdf) {
  *fr = mk(0.f, 0.f, 0.f);
  *pdf = 0.f;
  if (m.type == LAMBERTIAN) {
    if (same_hemisphere(wi, wo, nor)) {
      *fr = scl(m.diffuse, kInvPi);
      *pdf = fabsf(dot(wo, nor)) * kInvPi;
    }
  } else if (m.type == ROUGHCONDUCTOR) {
    if (same_hemisphere(wi, wo, nor)) {
      const V3 n = face_forward(nor, wi);
      const V3 wh = normalize(add(wi, wo));
      const float cosi = dot(wo, wh);
      const float D = ggx_d(wh, n, dpdu, m.au, m.av);
      const float G = ggx_g(wi, wo, n, wh, dpdu, m.au, m.av);
      const V3 F = conduct_fresnel(fabsf(cosi), m.eta, m.k);
      const float denom = 4.f * fabsf(dot(wi, n)) * fabsf(dot(wo, n));
      *fr = scl(mul(m.specular, F), D * G / tmax(denom, 1e-12f));
      *pdf = D * fabsf(dot(wh, n)) / tmax(4.f * fabsf(dot(wi, wh)), 1e-12f);
    }
  } else if (m.type == SUBSTRATE) {
    if (same_hemisphere(wi, wo, nor))
      substrate_fr_pdf(m, wi, wo, face_forward(nor, wi), dpdu, fr, pdf);
  } else if (m.type == ROUGHDIELECTRIC) {
    const V3 wi_in = wi;
    const V3 wn = neg(wi_in);
    const V3 n = nor;
    const bool is_reflect = dot(wi_in, n) * dot(wo, n) > 0.f;
    const bool enter = dot(wn, n) < 0.f;
    const float ei = enter ? m.outside : m.inside;
    const float et = enter ? m.inside : m.outside;
    const V3 wh = normalize(neg(add(scl(wi_in, ei), scl(wo, et))));
    const float eta = ei / et;
    const float cosi = dot(wn, wh);
    const float sint2 = eta * eta * (1.f - cosi * cosi);
    const float cost = sqrtf(tclamp(1.f - sint2, 0.f, 1.f));
    const float fresnel = dielectric_fresnel(fabsf(cost), fabsf(cosi), et, ei);
    float s_refl, pdf_refl, s_refr, pdf_refr;
    rough_dielectric_lobes(m, wi_in, wo, n, wh, dpdu, ei, et, eta, fresnel,
                           fresnel, &s_refl, &pdf_refl, &s_refr, &pdf_refr);
    *fr = scl(m.specular, is_reflect ? s_refl : s_refr);
    *pdf = is_reflect ? pdf_refl : pdf_refr;
  }
}

// SampleBSDF dispatch (sample_bsdf) -> wo, fr, pdf; kImportance: light
// transport, whose refraction does not pick up radiance's eta^2
template <bool kImportance>
__device__ __forceinline__ void sample_bsdf_mode(const Mat& m, V3 wi, V3 nor,
                                                 V3 dpdu, float u1, float u2,
                                                 float u3, bool aniso, V3* wo,
                                                 V3* fr, float* pdf) {
  const V3 zero = mk(0.f, 0.f, 0.f);
  *wo = zero;
  *fr = zero;
  *pdf = 0.f;
  if (m.type == LAMBERTIAN) {
    const V3 n = face_forward(nor, wi);
    const V3 local = cosine_hemisphere(u1, u2, pdf);
    *wo = to_world(local, dpdu, n, cross(dpdu, n));
    *fr = scl(m.diffuse, kInvPi);
  } else if (m.type == MIRROR) {
    *wo = reflect(wi, nor);
    *fr = divs(m.specular, tmax(fabsf(dot(*wo, nor)), 1e-12f));
    *pdf = 1.f;
  } else if (m.type == DIELECTRIC) {
    const V3 wn = neg(wi);
    const V3 n = nor;
    const float cosi = dot(wn, n);
    const bool enter = cosi < 0.f;
    const float ei = enter ? m.outside : m.inside;
    const float et = enter ? m.inside : m.outside;
    const float eta = ei / et;
    const float sint2 = eta * eta * (1.f - cosi * cosi);
    const float cost = sqrtf(tclamp(1.f - sint2, 0.f, 1.f));
    const bool tir = sint2 > 1.f;
    const float fresnel = dielectric_fresnel(fabsf(cost), fabsf(cosi), et, ei);
    const bool refr = !tir && (u1 > fresnel);
    *wo = refr ? refract(wi, nor, m.outside, m.inside) : reflect(wi, n);
    const float abs_cos = tmax(fabsf(dot(*wo, n)), 1e-12f);
    const V3 base = divs(m.specular, abs_cos);
    *fr = refr ? (kImportance ? scl(base, 1.f - fresnel)
                              : scl(scl(base, 1.f - fresnel), eta * eta))
               : scl(base, tir ? 1.f : fresnel);
    *pdf = tir ? 1.f : (refr ? 1.f - fresnel : fresnel);
  } else if (m.type == ROUGHCONDUCTOR) {
    const V3 n = face_forward(nor, wi);
    const V3 wh = to_world(sample_ggx(m.au, m.av, u1, u2, aniso), dpdu, n,
                           cross(dpdu, n));
    *wo = reflect(wi, wh);
    if (same_hemisphere(wi, *wo, nor)) {
      const float cosi = dot(*wo, wh);
      const V3 F = conduct_fresnel(fabsf(cosi), m.eta, m.k);
      const float D = ggx_d(wh, n, dpdu, m.au, m.av);
      const float G = ggx_g(wi, *wo, n, wh, dpdu, m.au, m.av);
      const float denom = 4.f * fabsf(dot(wi, n)) * fabsf(dot(*wo, n));
      *fr = scl(mul(m.specular, F), D * G / tmax(denom, 1e-12f));
      *pdf = D * fabsf(dot(wh, n)) / tmax(4.f * fabsf(dot(wi, wh)), 1e-12f);
    }
  } else if (m.type == SUBSTRATE) {
    const V3 n = face_forward(nor, wi);
    const V3 ww = cross(dpdu, n);
    if (u1 < 0.5f) {
      float unused;
      *wo = to_world(cosine_hemisphere(tmin(u1 * 2.f, 1.f), u2, &unused),
                     dpdu, n, ww);
    } else {
      const float ux = tclamp((u1 - 0.5f) * 2.f, 0.f, 1.f);
      *wo = reflect(wi, to_world(sample_ggx(m.au, m.av, ux, u2, aniso), dpdu,
                                 n, ww));
    }
    if (same_hemisphere(wi, *wo, n)) substrate_fr_pdf(m, wi, *wo, n, dpdu,
                                                      fr, pdf);
  } else if (m.type == ROUGHDIELECTRIC) {
    const V3 wi_in = wi;
    const V3 wn = neg(wi_in);
    const V3 n = nor;
    const V3 wh = to_world(sample_ggx(m.au, m.av, u1, u2, aniso), dpdu, n,
                           cross(dpdu, n));
    const bool enter = dot(wn, n) < 0.f;
    const float ei = enter ? m.outside : m.inside;
    const float et = enter ? m.inside : m.outside;
    const float eta = ei / et;
    const float cosi = dot(wn, wh);
    const float sint2 = eta * eta * (1.f - cosi * cosi);
    const float cost = sqrtf(tclamp(1.f - sint2, 0.f, 1.f));
    const bool tir = sint2 > 1.f;
    const float fresnel = dielectric_fresnel(fabsf(cost), fabsf(cosi), et, ei);
    const bool refr = !tir && (u3 > fresnel);
    if (refr) {
      const float sign = enter ? -1.f : 1.f;
      *wo = normalize(add(scl(sub(wn, scl(wh, cosi)), eta),
                          scl(wh, sign * cost)));
    } else {
      *wo = reflect(wi_in, wh);
    }
    float s_refl, pdf_refl, s_refr, pdf_refr;
    rough_dielectric_lobes<kImportance>(m, wi_in, *wo, n, wh, dpdu, ei, et,
                                        eta, fresnel, tir ? 1.f : fresnel,
                                        &s_refl, &pdf_refl, &s_refr,
                                        &pdf_refr);
    *fr = scl(m.specular, refr ? s_refr : s_refl);
    *pdf = refr ? pdf_refr : pdf_refl;
  }
}

// radiance transport (every kernel but bdpt.cu's light subpaths)
__device__ void sample_bsdf(const Mat& m, V3 wi, V3 nor, V3 dpdu, float u1,
                            float u2, float u3, bool aniso, V3* wo, V3* fr,
                            float* pdf) {
  sample_bsdf_mode<false>(m, wi, nor, dpdu, u1, u2, u3, aniso, wo, fr, pdf);
}

// ---------------------------------------------------------------------------
// geom/traverse.py::_hit_attributes for one lane
// ---------------------------------------------------------------------------
struct Hit {
  V3 pos, nor, dpdu;
  float u, v;  // surface uv (computed when kUV)
  int mat, light;
};

// kAll false: the scene has triangles only (no sphere or line branch)
template <bool kUV, bool kAll = true>
__device__ Hit hit_attributes(const float* prim_attrs, int prim, V3 ro, V3 rd,
                              float t) {
  const float* a = prim_attrs + (size_t)prim * kPrimAttrs;
  const int type = (int)__ldg(a + 29);
  const V3 v0 = ldg3(a);
  Hit h;
  h.pos = add(ro, scl(rd, t));
  h.nor = mk(0.f, 0.f, 0.f);
  h.dpdu = h.nor;
  h.u = h.v = 0.f;
  if (type == 0) {  // triangle: barycentrics recomputed at t
    const V3 e1 = sub(ldg3(a + 3), v0);
    const V3 e2 = sub(ldg3(a + 6), v0);
    const V3 s1 = cross(rd, e2);
    const float divisor = dot(s1, e1);
    const float inv_div = 1.f / (fabsf(divisor) > 1e-30f ? divisor : 1.f);
    const V3 s = sub(ro, v0);
    const float b1 = dot(s, s1) * inv_div;
    const V3 s2 = cross(s, e1);
    const float b2 = dot(rd, s2) * inv_div;
    const float w0 = 1.f - b1 - b2;
    h.nor = normalize(add(add(scl(ldg3(a + 9), w0), scl(ldg3(a + 12), b1)),
                          scl(ldg3(a + 15), b2)));
    h.dpdu = normalize(cross(h.nor, ldg3(a + 24)));
    if (kUV) {
      h.u = __ldg(a + 18) * w0 + __ldg(a + 20) * b1 + __ldg(a + 22) * b2;
      h.v = __ldg(a + 19) * w0 + __ldg(a + 21) * b1 + __ldg(a + 23) * b2;
    }
  } else if (kAll && type == 2) {  // sphere
    h.nor = normalize(sub(h.pos, v0));
    h.dpdu = normalize(mk((float)(-2.0 * PI_D) * h.pos.y, kTwoPi * h.pos.x,
                          0.f));
    if (kUV) {  // sphere.h:72-91
      const float phi = acosf(tclamp(h.nor.x, -1.f, 1.f));
      h.u = (h.nor.z > 0.f ? kTwoPi - phi : phi) * kInvTwoPi;
      h.v = acosf(tclamp(h.nor.y, -1.f, 1.f)) * kInvPi;
    }
  } else if (kAll && type == 1) {  // line: camera-facing normal
    h.nor = neg(rd);
    V3 w;
    h.dpdu = make_coordinate(h.nor, &w);
    if (kUV) {  // line.h:74-84: uv = (s, distance to the axis / width)
      const V3 v1 = ldg3(a + 3);
      const float r0 = __ldg(a + 27), r1 = __ldg(a + 28);
      float tl, s;
      line_hit(ro, rd, v0, v1, r0, r1, 0.f, __int_as_float(0x7f800000), &tl,
               &s);
      const V3 prl = sub(h.pos, add(v0, scl(sub(v1, v0), s)));
      h.u = s;
      h.v = sqrtf(tmax(dot(prl, prl), 0.f)) /
            tmax(r0 * (1.f - s) + r1 * s, 1e-30f);
    }
  }
  h.mat = (int)__ldg(a + 30);
  h.light = (int)__ldg(a + 31);
  return h;
}

// ---------------------------------------------------------------------------
// shade/texture.py: bilinear fetch, floor-modulo wrap then clamp
// ---------------------------------------------------------------------------
__device__ __forceinline__ int wrap_texel(int i, int n) {
  int r = i % n;  // C truncates: make it a floor modulo
  if (r < 0) r += n;
  return r < 0 ? 0 : (r > n - 1 ? n - 1 : r);
}

// (1 - dy) ((1 - dx) c00 + dx c10) + dy ((1 - dx) c01 + dx c11) of the
// four texels around (xx, yy) of a w x h image; fetch(x, y) reads one
template <typename Fetch>
__device__ __forceinline__ V3 bilinear(float xx, float yy, int w, int h,
                                       Fetch fetch) {
  const int x = (int)floorf(xx), y = (int)floorf(yy);
  const float dx = fabsf(xx - (float)x), dy = fabsf(yy - (float)y);
  const int x0 = wrap_texel(x, w), x1 = wrap_texel(x + 1, w);
  const int y0 = wrap_texel(y, h), y1 = wrap_texel(y + 1, h);
  const float ex = 1.f - dx, ey = 1.f - dy;
  const V3 a = add(scl(fetch(x0, y0), ex), scl(fetch(x1, y0), dx));
  const V3 b = add(scl(fetch(x0, y1), ex), scl(fetch(x1, y1), dx));
  return add(scl(a, ey), scl(b, dy));
}

// the diffuse texel of texture `ti` at (u, v): uint8 texels / 255
__device__ __forceinline__ V3 texel(const uint8_t* tex, const int32_t* offs,
                                    const int32_t* ws, const int32_t* hs,
                                    int ti, float u, float v) {
  const int w = __ldg(ws + ti), h = __ldg(hs + ti);
  const uint8_t* base = tex + 3 * (size_t)__ldg(offs + ti);
  return bilinear((float)w * u, (float)h * v, w, h, [&](int x, int y) {
    const uint8_t* c = base + 3 * (size_t)(y * w + x);
    return mk((float)__ldg(c) / 255.f, (float)__ldg(c + 1) / 255.f,
              (float)__ldg(c + 2) / 255.f);
  });
}

// ---------------------------------------------------------------------------
// shade/lights.py (area lights and the environment light)
// ---------------------------------------------------------------------------
struct Env {
  const float* data;  // [h, w, 3]
  int w, h;
  const float *u, *v, *wa;  // the light's frame, [3] each
};

// Infinite::Le (infinite.h:47-59): the sky along d
__device__ __forceinline__ V3 env_le(const Env& e, V3 d) {
  const V3 eu = ldg3(e.u), ev = ldg3(e.v), ew = ldg3(e.wa);
  const float costheta = dot(d, ev);
  const float theta = acosf(tclamp(costheta, -1.f, 1.f));
  const V3 flat = normalize(sub(d, scl(ev, costheta)));
  const float phi0 = acosf(tclamp(dot(flat, eu), -1.f, 1.f));
  const float phi = dot(flat, ew) > 0.f ? kTwoPi - phi0 : phi0;
  const float u = 1.f - phi * kInvTwoPi;
  const float v = theta * kInvPi;
  return bilinear((float)e.w * u, (float)e.h * v, e.w, e.h,
                  [&](int x, int y) {
                    return ldg3(e.data + 3 * (size_t)(y * e.w + x));
                  });
}

__device__ __forceinline__ float tri_area(V3 v0, V3 v1, V3 v2) {
  return 0.5f * length(cross(sub(v1, v0), sub(v2, v0)));
}

// light_choice_pdf: cdf[i + 1] - cdf[i], i clamped to [0, L] (L light
// rows: the area lights, or 1 when there are none)
__device__ __forceinline__ float light_choice_pdf(const float* cdf, int idx,
                                                  int n_rows) {
  const int i = idx < 0 ? 0 : (idx > n_rows ? n_rows : idx);
  return __ldg(cdf + i + 1) - __ldg(cdf + i);
}

// ---------------------------------------------------------------------------
// the emitter credits
// ---------------------------------------------------------------------------
// Emitter radiance reached by the ray (ro, rd) that found `h`, MIS
// weighted against prev_pdf unless `full` (pt.py::_arrival_credit).
// Returns whether the path goes on.
__device__ __forceinline__ bool arrival_credit(const float* lights,
                                               const float* cdf, int n_rows,
                                               const Hit& h, V3 ro, V3 rd,
                                               V3 beta, bool full,
                                               float prev_pdf, V3* li) {
  if (h.light < 0) return true;
  const int lidx = h.light;
  const float* la = lights + (size_t)lidx * kLightAttrs;
  const V3 rad = ldg3(la + 18);
  const V3 le = dot(h.nor, neg(rd)) > 0.f ? rad : mk(0.f, 0.f, 0.f);
  if (!is_black(le)) {
    float w = 1.f;
    if (!full) {
      const float pdf_area =
          1.f / tmax(tri_area(ldg3(la), ldg3(la + 3), ldg3(la + 6)), 1e-30f);
      const float lchoice = light_choice_pdf(cdf, lidx, n_rows);
      const V3 seg = sub(h.pos, ro);
      const float len2 = dot(seg, seg);
      const float cos_l = fabsf(dot(h.nor, rd));
      const float l_pdf = pdf_area * len2 / tmax(cos_l, 1e-30f);
      w = power_heuristic(prev_pdf, l_pdf * lchoice);
    }
    *li = add(*li, scl(mul(beta, le), w));
  }
  return !full;  // bounce-0 / specular emitter hits end the path
}

// The sky seen by a ray that missed, MIS weighted against prev_pdf
// unless `full` (pt.py::_arrival_credit, env_credit_weight).
__device__ __forceinline__ void env_credit(const Env& env, const float* cdf,
                                           int n_lights, int n_rows, V3 rd,
                                           V3 beta, bool full, float prev_pdf,
                                           V3* li) {
  const float w =
      full ? 1.f
           : power_heuristic(prev_pdf, kInvFourPi * light_choice_pdf(
                                           cdf, n_lights, n_rows));
  *li = add(*li, scl(mul(beta, env_le(env, rd)), w));
}

// ---------------------------------------------------------------------------
// the light pick, the material and the light sample (shade steps of the
// wavefront kernels, pt_shade.cu and vpt_shade.cu)
// ---------------------------------------------------------------------------
// torch.searchsorted(cdf, u, right=True) - 1 clamped to [0, n_rows]: the
// same binary search (the first i with cdf[i] > u) over n_rows + 2 entries
__device__ __forceinline__ int pick_light(const float* cdf, int n_rows,
                                          float u) {
  int lo = 0, hi = n_rows + 2;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(__ldg(cdf + mid) > u)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int idx = lo - 1;
  return idx < 0 ? 0 : (idx > n_rows ? n_rows : idx);
}

// The material at hit `h`, its diffuse colour the texel at the hit's uv
// where the material has a texture (shade/bsdf.py::gather_materials).
template <bool kTex>
__device__ __forceinline__ Mat hit_material(const float* mats,
                                            const uint8_t* tex,
                                            const int32_t* tex_offset,
                                            const int32_t* tex_w,
                                            const int32_t* tex_h,
                                            const Hit& h) {
  Mat m = gather_material(mats, h.mat);
  if (kTex) {
    const int ti =
        (int)__ldg(mats + (size_t)(h.mat < 0 ? 0 : h.mat) * kMatAttrs + 17);
    if (ti >= 0)
      m.diffuse = texel(tex, tex_offset, tex_w, tex_h, ti, h.u, h.v);
  }
  return m;
}

// common.py::sample_light toward `pos` of the picked light `idx`: the
// sky (kEnv, idx == n_lights) by a uniform-sphere direction, else an
// area light by a uniform point of its triangle (one-sided). Writes the
// radiance, the unit direction, the solid-angle pdf and the shadow ray's
// tmax.
template <bool kEnv>
__device__ __forceinline__ void sample_light(const float* lights,
                                             int n_lights, const Env& env,
                                             float env_tmax, float eps,
                                             int idx, V3 pos, V3 nor, float u1,
                                             float u2, V3* rad, V3* nd,
                                             float* light_pdf, float* st) {
  if (kEnv && idx == n_lights) {  // the sky: a uniform-sphere direction
    *nd = uniform_sphere(u1, u2);
    *rad = env_le(env, *nd);
    *light_pdf = kInvFourPi;
    *st = env_tmax;
  } else if (n_lights == 0) {
    // the sky alone, of zero power (its texel [0, 0] black): the CDF
    // never picks its slot, and common.sample_light gives no sample
    *rad = mk(0.f, 0.f, 0.f);
    *nd = nor;
    *light_pdf = *st = 0.f;
  } else {
    const float* la =
        lights + (size_t)(idx < n_lights ? idx : n_lights - 1) * kLightAttrs;
    const V3 v0 = ldg3(la), v1 = ldg3(la + 3), v2 = ldg3(la + 6);
    const float su1 = sqrtf(tmax(u1, 0.f));
    const float bu = 1.f - su1;
    const float bv = u2 * su1;
    const float bw = 1.f - bu - bv;
    const V3 lp = add(add(scl(v0, bu), scl(v1, bv)), scl(v2, bw));
    const V3 lnor = normalize(add(add(scl(ldg3(la + 9), bu),
                                      scl(ldg3(la + 12), bv)),
                                  scl(ldg3(la + 15), bw)));
    const V3 d = sub(lp, pos);
    const float dist2 = dot(d, d);
    *nd = normalize(d);
    const float cos_l = fabsf(dot(lnor, *nd));
    *light_pdf = dist2 / tmax(tri_area(v0, v1, v2) * cos_l, 1e-30f);
    if (dot(lnor, d) >= 0.f) *light_pdf = 0.f;
    *rad = *light_pdf != 0.f ? ldg3(la + 18) : mk(0.f, 0.f, 0.f);
    *st = sqrtf(tmax(dist2 - eps, 0.f));
  }
}

// ---------------------------------------------------------------------------
// BDPT (bdpt.cu): the camera's primary ray and importance, the area
// light's emission, pdf, Le and sample with its normal, ConvertPdf
// ---------------------------------------------------------------------------
// the camera fields of integrators/bdpt_shade.py::camera_record
struct Cam {
  V3 pos, u, v, w;
  float res_x, res_y, distance, half_w, half_h, area;
  float p2s_x, p2s_y, ratio, focal, aperture;
};

__device__ __forceinline__ Cam load_camera(const float* c) {
  Cam k;
  k.pos = ldg3(c);
  k.u = ldg3(c + 3);
  k.v = ldg3(c + 6);
  k.w = ldg3(c + 9);
  k.res_x = __ldg(c + 12);
  k.res_y = __ldg(c + 13);
  k.distance = __ldg(c + 14);
  k.half_w = __ldg(c + 15);
  k.half_h = __ldg(c + 16);
  k.area = __ldg(c + 17);
  k.p2s_x = __ldg(c + 18);
  k.p2s_y = __ldg(c + 19);
  k.ratio = __ldg(c + 20);
  k.focal = __ldg(c + 21);
  k.aperture = __ldg(c + 22);
  return k;
}

// shade/camera.py::generate_primary_ray at continuous pixel (x, y) with
// no aperture sample (BDPT has no depth of field): the pinhole, the thin
// lens at the lens centre where the camera has an aperture, or the
// environment camera's sphere of directions
__device__ __forceinline__ void primary_ray(const Cam& c, float x, float y,
                                            bool environment, V3* o, V3* d) {
  if (environment) {
    const float theta = kPi * (1.f - y / c.res_y);
    const float phi = kTwoPi * (1.f - x / c.res_x);
    const float st = sinf(theta);
    const V3 l = mk(st * cosf(phi), cosf(theta), st * sinf(phi));
    *o = c.pos;
    *d = normalize(sub(add(scl(c.u, l.x), scl(c.v, l.y)), scl(c.w, l.z)));
    return;
  }
  const float xx = x * c.p2s_x - c.half_w;
  const float yy = y * c.p2s_y - c.half_h;
  if (c.aperture > 1e-5f) {   // the thin lens (camera.h:63-73)
    const float ax = 0.f * c.aperture, ay = 0.f * c.aperture;
    const float dx = c.ratio * xx - ax, dy = c.ratio * yy - ay;
    *d = normalize(add(add(scl(c.u, dx), scl(c.v, dy)), scl(c.w, -c.focal)));
    *o = add(add(c.pos, scl(c.u, ax)), scl(c.v, ay));
  } else {
    *d = normalize(sub(add(scl(c.u, xx), scl(c.v, yy)), scl(c.w, c.distance)));
    *o = c.pos;
  }
}

// shade/camera.py::sample_camera (camera.h:86-114): the pinhole seen from
// `pos`: the direction, the shadow ray's tmax, the importance we, the pdf
// (0: behind the camera or off the screen) and the raster pixel
__device__ __forceinline__ void sample_camera(const Cam& c, V3 pos, float eps,
                                              V3* nd, float* st, float* we,
                                              float* pdf, int* rx, int* ry) {
  const V3 d = sub(c.pos, pos);
  *nd = normalize(d);
  *st = length(d) - eps;
  const V3 m = neg(*nd);
  const V3 cn = mk(dot(m, c.u), dot(m, c.v), dot(m, c.w));
  bool ok = cn.z < 0.f;
  const float costheta = -cn.z;
  const float scale = -c.distance / (ok ? cn.z : -1.f);
  const float px = cn.x * scale / c.half_w;
  const float py = cn.y * scale / c.half_h;
  ok = ok && fabsf(px) <= 1.f && fabsf(py) <= 1.f;
  const float sx = px * 0.5f + 0.5f;
  const float sy = py * 0.5f + 0.5f;
  *rx = (int)floorf(sx * (c.res_x - 1.f) + 0.5f);
  *ry = (int)floorf(sy * (c.res_y - 1.f) + 0.5f);
  *pdf = ok ? dot(d, d) / tmax(costheta, 1e-30f) : 0.f;
  const float c4 = powf(costheta, 4.f);   // torch's costheta ** 4
  *we = c.distance * c.distance / tmax(c.area * c4, 1e-30f);
}

// shade/camera.py::pdf_camera's pdfW (camera.h:117-121) along d
__device__ __forceinline__ float pdf_camera_w(const Cam& c, V3 d) {
  const float costheta = dot(d, neg(c.w));
  return c.distance * c.distance /
         tmax(c.area * (costheta * costheta * costheta), 1e-30f);
}

// the light_attrs row of light `idx`, clamped into the table's n_rows
__device__ __forceinline__ const float* light_row(const float* lights,
                                                  int idx, int n_rows) {
  const int i = idx < 0 ? 0 : (idx > n_rows - 1 ? n_rows - 1 : idx);
  return lights + (size_t)i * kLightAttrs;
}

// shade/lights.py::sample_area_light_emission (area.h:21-26): a uniform
// point of the light's triangle, a cosine-weighted direction about its
// normal: the point, the direction, the normal, pdfA = 1 / area, pdfW
__device__ __forceinline__ void area_light_emission(const float* la, float u1,
                                                    float u2, float u3,
                                                    float u4, V3* p, V3* d,
                                                    V3* nor, float* pdf_a,
                                                    float* pdf_w) {
  const V3 v0 = ldg3(la), v1 = ldg3(la + 3), v2 = ldg3(la + 6);
  const float su1 = sqrtf(tmax(u1, 0.f));
  const float bu = 1.f - su1;
  const float bv = u2 * su1;
  const float bw = 1.f - bu - bv;
  *p = add(add(scl(v0, bu), scl(v1, bv)), scl(v2, bw));
  *nor = normalize(add(add(scl(ldg3(la + 9), bu), scl(ldg3(la + 12), bv)),
                       scl(ldg3(la + 15), bw)));
  const V3 local = cosine_hemisphere(u3, u4, pdf_w);
  V3 ww;
  const V3 uu = make_coordinate(*nor, &ww);
  *d = to_world(local, uu, *nor, ww);
  *pdf_a = 1.f / tmax(tri_area(v0, v1, v2), 1e-30f);
}

// shade/lights.py::area_light_pdf (area.h:28-32): pdfA = 1 / area and
// pdfW = |cos| / pi
__device__ __forceinline__ void area_light_pdf(const float* la, V3 ray_d,
                                               V3 nor, float* pdf_a,
                                               float* pdf_w) {
  *pdf_a = 1.f / tmax(tri_area(ldg3(la), ldg3(la + 3), ldg3(la + 6)), 1e-30f);
  *pdf_w = fabsf(dot(ray_d, nor)) * kInvPi;
}

// shade/lights.py::area_light_le (area.h:38-41): one-sided emission
__device__ __forceinline__ V3 area_light_le(const float* la, V3 nor,
                                            V3 dir_out) {
  return dot(nor, dir_out) > 0.f ? ldg3(la + 18) : mk(0.f, 0.f, 0.f);
}

// shade/lights.py::sample_area_light (area.h:14-19): a uniform point of
// the light's triangle seen from `pos`; the area branch of sample_light
// with the light's normal at the point too
__device__ __forceinline__ void sample_area_light(const float* la, V3 pos,
                                                  float u1, float u2,
                                                  float eps, V3* rad, V3* nd,
                                                  float* st, V3* lnor,
                                                  float* pdf) {
  const V3 v0 = ldg3(la), v1 = ldg3(la + 3), v2 = ldg3(la + 6);
  const float su1 = sqrtf(tmax(u1, 0.f));
  const float bu = 1.f - su1;
  const float bv = u2 * su1;
  const float bw = 1.f - bu - bv;
  const V3 lp = add(add(scl(v0, bu), scl(v1, bv)), scl(v2, bw));
  *lnor = normalize(add(add(scl(ldg3(la + 9), bu), scl(ldg3(la + 12), bv)),
                        scl(ldg3(la + 15), bw)));
  const V3 d = sub(lp, pos);
  const float dist2 = dot(d, d);
  *nd = normalize(d);
  const float cos_l = fabsf(dot(*lnor, *nd));
  *pdf = dist2 / tmax(tri_area(v0, v1, v2) * cos_l, 1e-30f);
  if (dot(*lnor, d) >= 0.f) *pdf = 0.f;
  *rad = *pdf != 0.f ? ldg3(la + 18) : mk(0.f, 0.f, 0.f);
  *st = sqrtf(tmax(dist2 - eps, 0.f));
}

// integrators/bdpt_shade.py::_convert_pdf (pathtracer.cu:1405-1414): a
// solid-angle pdf at `from` as an area pdf at `to` (no cosine at a medium
// vertex: zero normal)
__device__ __forceinline__ float convert_pdf(float pdf, V3 from, V3 to,
                                             V3 to_nor) {
  const V3 d = sub(from, to);
  const float d2 = tmax(dot(d, d), 1e-30f);
  const float ret = pdf / d2;
  const float c = fabsf(dot(divs(d, sqrtf(d2)), to_nor));
  return dot(to_nor, to_nor) > 0.f ? ret * c : ret;
}

}  // namespace
