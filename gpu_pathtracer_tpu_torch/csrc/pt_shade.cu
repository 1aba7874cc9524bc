// The PT wavefront's shading of one bounce: one thread shades one lane.
//
// Replaces no Pallas kernel: the JAX package runs a bounce of its
// wavefront (gpu_pathtracer_tpu/integrators/pt.py:167, the body of a
// jitted lax.scan) as XLA fusions. The port's plain version is
// integrators/pt_shade.py::shade_torch, hundreds of masked PyTorch
// launches over every lane and gathers of whole table rows.
//
// Per lane, in the plain version's order: the previous bounce's NEE
// credit where its shadow ray was not occluded; the hit record from the
// closest-hit query's (t, prim) and one prim_attrs row; the arrival
// credit of an emitter hit, or of the sky on a miss; a lane that reaches
// a BSSRDF prim ends there (integrators/pt.py's subsurface hook shades
// it); the bounce's 8 random sites (philox.cuh, or psample rows); the
// material and its texel; the light pick (a binary search of the CDF, as
// torch.searchsorted(right=True) - 1); the area or sky light sample,
// giving the shadow ray and its unoccluded credit beta * Ld, kept
// pending until the any-hit query has run; the BSDF sample and the next
// ray; the roulette after bounce 3; and, when the wavefront sorts, the
// next ray's coherence key (pt.py::_sort_key) and the shadow ray's
// (common.py::_shadow_sort_key). The arithmetic is K2's (shade.cuh), so
// the two kernels shade alike.
//
// What bounds it on an H100: the bytes a lane moves. It reads 80 B of
// lane state (t, prim, flags, lane id, ro, rd, li, beta, pdf, pending
// credit) and writes 112 B (the next lane state, the pending credit, the
// shadow ray, two int64 keys): 192 B, 0.06 ms at 1M lanes and 3.35 TB/s.
// Its table reads add up to about 400 B a lane (a prim_attrs row, a
// material row, the light rows, CDF probes, texels); they are shared
// between lanes and mostly hit the cache. The design keeps every
// intermediate in registers (no [N]-wide temporaries, one pass over the
// lanes), reads the tables through the read-only cache (__ldg) and
// counts the traced rays with one atomic per block.
//
// Variants (template flags, as K2's): kEnv, the scene has a sky; kTex,
// textures; kAll, spheres or lines (else the hit record has no type
// branch).
#include "shade.cuh"

namespace {

constexpr int kShadeThreads = 128;
// lane flags (integrators/pt_shade.py)
constexpr int kSpecular = 1, kAlive = 2, kOccluded = 4, kSss = 8;
constexpr long long kDeadKey = 1LL << 20;     // pt.py::_sort_key
constexpr long long kNoShadowKey = 1LL << 24;  // common.py::_shadow_sort_key

struct ShadeParams {
  int n, bounce;
  bool last;  // the epilogue: credits only
  uint32_t seed, iteration;
  const float* psample;
  const float* t;
  const int32_t* prim;
  const float* ro;
  const float* rd;
  const float* li;
  const float* beta;
  const float* prev_pdf;
  const int32_t* flags;
  const int32_t* lanes;
  const float* pending;  // NULL at bounce 0
  const float* prim_attrs;
  const float* mats;
  const float* lights;
  int n_lights, n_rows;
  const float* cdf;
  Env env;
  float env_tmax;
  const uint8_t* tex;
  const int32_t* tex_offset;
  const int32_t* tex_w;
  const int32_t* tex_h;
  float eps;
  bool aniso, bssrdf;
  const float* center;   // the scene's bounding-sphere centre [3]
  float key_inv;         // 1 / (2 max(r, 1e-6)), as PyTorch divides on CUDA
  float shadow_inv;      // 1 / (2 r)
  float* ro_out;
  float* rd_out;
  float* li_out;
  float* beta_out;
  float* pdf_out;
  int32_t* flags_out;
  float* pending_out;
  float* so_out;
  float* sd_out;
  float* st_out;
  int64_t* key_out;         // NULL: the wavefront does not sort
  int64_t* shadow_key_out;  // NULL: it does not sort shadow rays
  unsigned long long* counts;  // [closest rays, shadow rays]
};

// ---------------------------------------------------------------------------
// K2's bounce steps (pt_fused.cu::bounce) as functions, line for line:
// the NEE estimate and the BSDF continuation with the roulette (the
// material with its texel and the light sample are shade.cuh's
// hit_material and sample_light). K2 keeps them inline: factored out,
// they took its sky variants from 96 to 105-106 registers and slowed them
// (PERF.md section 6). An edit here must reach K2's copy.
// ---------------------------------------------------------------------------
// The light sample's estimate where its shadow ray is unoccluded
// (common.py::nee_sample): the power heuristic of the light pdf x the
// pick's pdf against the BSDF's, times fr rad |cos| / that pdf.
__device__ __forceinline__ V3 nee_contrib(const Mat& m, V3 wi, V3 nd, V3 nor,
                                          V3 dpdu, V3 rad, float light_pdf,
                                          float choice_pdf) {
  V3 fr;
  float sample_pdf;
  eval_bsdf(m, wi, nd, nor, dpdu, &fr, &sample_pdf);
  const float denom = light_pdf * choice_pdf;
  const float weight = power_heuristic(denom, sample_pdf);
  const float cos_s = fabsf(dot(nor, nd));
  const float dm = tmax(denom, 1e-30f);
  return mk(weight * fr.x * rad.x * cos_s / dm,
            weight * fr.y * rad.y * cos_s / dm,
            weight * fr.z * rad.z * cos_s / dm);
}

// One BSDF sample at hit `h` from the bounce's sites 3-5 (u1, u2, u3):
// the continuation ray, beta, the specular flag and the MIS pdf; then
// Russian roulette after bounce 3 on site 6 (u_rr) (pt.py). Returns
// whether the path goes on; a path that the roulette ends keeps its
// updated state. (The sites come by value, so a bounce's draws stay in
// registers.)
__device__ __forceinline__ bool continue_path(const Mat& m, const Hit& h,
                                              V3 wi, float u1, float u2,
                                              float u3, float u_rr,
                                              int bounce, bool aniso,
                                              V3* beta, bool* specular,
                                              float* prev_pdf, V3* ro,
                                              V3* rd) {
  V3 wo, fr;
  float pdf;
  sample_bsdf(m, wi, h.nor, h.dpdu, u1, u2, u3, aniso, &wo, &fr, &pdf);
  if (is_black(fr) || pdf <= 0.f) return false;
  const float cos_o = fabsf(dot(h.nor, wo));
  const float pm = tmax(pdf, 1e-30f);
  *beta = mk(beta->x * fr.x * cos_o / pm, beta->y * fr.y * cos_o / pm,
             beta->z * fr.z * cos_o / pm);
  *specular = is_delta(m.type);
  *prev_pdf = pdf;
  *ro = h.pos;
  *rd = wo;
  if (bounce > 3) {
    const float illumate = tclamp(1.f - luminance(*beta), 0.f, 1.f);
    if (u_rr < illumate) return false;
    *beta = scl(*beta, 1.f / tmax(1.f - illumate, 1e-30f));
  }
  return true;
}


// the cell of one coordinate: clamp(((x - c) * inv + 0.5) * scale, 0, hi)
// truncated to int64, as PyTorch computes it on CUDA (a division by a
// Python float is a product with its float32 reciprocal there)
__device__ __forceinline__ long long cell(float x, float c, float inv,
                                          float scale, float hi) {
  return (long long)tclamp(((x - c) * inv + 0.5f) * scale, 0.f, hi);
}

// common.py::morton_bits of the three cells: bit b of axis a at 3 b + a
__device__ __forceinline__ long long morton3(long long qx, long long qy,
                                             long long qz, int bits) {
  long long m = 0;
  for (int b = 0; b < bits; ++b) {
    m |= ((qx >> b) & 1) << (3 * b);
    m |= ((qy >> b) & 1) << (3 * b + 1);
    m |= ((qz >> b) & 1) << (3 * b + 2);
  }
  return m;
}

template <bool kEnv, bool kTex, bool kAll>
__device__ __forceinline__ void shade_lane(const ShadeParams& p, int i,
                                           bool* traced, bool* shadow) {
  const V3 zero = mk(0.f, 0.f, 0.f);
  const int f = p.flags[i];
  bool alive = (f & kAlive) != 0;
  bool specular = (f & kSpecular) != 0;
  V3 ro = load3(p.ro + 3 * i), rd = load3(p.rd + 3 * i);
  V3 li = load3(p.li + 3 * i), beta = load3(p.beta + 3 * i);
  float prev_pdf = p.prev_pdf[i];
  if (p.pending) {   // the previous bounce's NEE credit, unless occluded
    li = add(li, (f & kOccluded) ? zero : load3(p.pending + 3 * i));
  }
  *traced = alive;
  int sss = 0;
  bool cand = false;
  V3 pend = zero, so = zero, sd = zero;
  float st = 0.f;
  if (alive) {
    const int prim = p.prim[i];
    const bool full = specular || (p.bounce == 0 && !p.last);
    alive = false;
    if (prim < 0) {
      if (kEnv) {
        env_credit(p.env, p.cdf, p.n_lights, p.n_rows, rd, beta, full,
                   prev_pdf, &li);
      }
    } else {
      const Hit h = hit_attributes<kTex, kAll>(p.prim_attrs, prim, ro, rd,
                                               p.t[i]);
      const bool on = arrival_credit(p.lights, p.cdf, p.n_rows, h, ro, rd,
                                     beta, full, prev_pdf, &li);
      if (on && !p.last && p.bssrdf &&
          (int)__ldg(p.prim_attrs + (size_t)prim * kPrimAttrs + 32) >= 0) {
        sss = kSss;
      } else if (on && !p.last) {
        BounceDraws u;
        bounce_draws(&u, p.bounce, (uint32_t)p.lanes[i], i, p.n, p.seed,
                     p.iteration, p.psample);
        const Mat m = hit_material<kTex>(p.mats, p.tex, p.tex_offset,
                                         p.tex_w, p.tex_h, h);
        const V3 wi = neg(rd);
        if (!is_delta(m.type)) {
          const int idx = pick_light(p.cdf, p.n_rows, u.u[0]);
          const float choice_pdf = light_choice_pdf(p.cdf, idx, p.n_rows);
          V3 rad, nd;
          float light_pdf, tl;
          sample_light<kEnv>(p.lights, p.n_lights, p.env, p.env_tmax, p.eps,
                             idx, h.pos, h.nor, u.u[1], u.u[2], &rad, &nd,
                             &light_pdf, &tl);
          cand = !is_black(rad) && light_pdf > 0.f;
          if (cand) {
            pend = mul(beta, nee_contrib(m, wi, nd, h.nor, h.dpdu, rad,
                                         light_pdf, choice_pdf));
            so = h.pos;
            sd = nd;
            st = tl;
          }
        }
        alive = continue_path(m, h, wi, u.u[3], u.u[4], u.u[5], u.u[6],
                              p.bounce, p.aniso, &beta, &specular,
                              &prev_pdf, &ro, &rd);
      }
    }
  }
  *shadow = cand;
  store3(p.ro_out + 3 * i, ro);
  store3(p.rd_out + 3 * i, rd);
  store3(p.li_out + 3 * i, li);
  store3(p.beta_out + 3 * i, beta);
  p.pdf_out[i] = prev_pdf;
  p.flags_out[i] = (specular ? kSpecular : 0) | (alive ? kAlive : 0) | sss;
  store3(p.pending_out + 3 * i, pend);
  store3(p.so_out + 3 * i, so);
  store3(p.sd_out + 3 * i, sd);
  p.st_out[i] = st;
  if (p.key_out) {
    long long key = kDeadKey;
    if (alive) {
      const float c0 = __ldg(p.center), c1 = __ldg(p.center + 1),
                  c2 = __ldg(p.center + 2);
      const float s = (float)15.999, hi = 15.f;
      const long long octant =
          (rd.x > 0.f ? 1 : 0) | (rd.y > 0.f ? 2 : 0) | (rd.z > 0.f ? 4 : 0);
      key = (octant << 12) |
            morton3(cell(ro.x, c0, p.key_inv, s, hi),
                    cell(ro.y, c1, p.key_inv, s, hi),
                    cell(ro.z, c2, p.key_inv, s, hi), 4);
    }
    p.key_out[i] = key;
  }
  if (p.shadow_key_out) {
    long long key = kNoShadowKey;
    if (cand && st > 0.f) {
      const float c0 = __ldg(p.center), c1 = __ldg(p.center + 1),
                  c2 = __ldg(p.center + 2);
      const float s = (float)63.999, hi = 63.f;
      key = morton3(cell(so.x, c0, p.shadow_inv, s, hi),
                    cell(so.y, c1, p.shadow_inv, s, hi),
                    cell(so.z, c2, p.shadow_inv, s, hi), 6);
    }
    p.shadow_key_out[i] = key;
  }
}

template <bool kEnv, bool kTex, bool kAll>
__global__ void __launch_bounds__(kShadeThreads)
    pt_shade_kernel(ShadeParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool traced = false, shadow = false;
  if (i < p.n) shade_lane<kEnv, kTex, kAll>(p, i, &traced, &shadow);
  const int n_traced = __syncthreads_count(traced);
  const int n_shadow = __syncthreads_count(shadow);
  if (threadIdx.x == 0) {
    if (n_traced) atomicAdd(p.counts, (unsigned long long)n_traced);
    if (n_shadow) atomicAdd(p.counts + 1, (unsigned long long)n_shadow);
  }
}

template <bool kEnv, bool kTex, bool kAll>
int launch(const ShadeParams& p, cudaStream_t stream) {
  const int blocks = (p.n + kShadeThreads - 1) / kShadeThreads;
  pt_shade_kernel<kEnv, kTex, kAll><<<blocks, kShadeThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// pending NULL: bounce 0 (no credit pending); psample NULL: draw from
// Philox; env_data NULL: no sky; tex_data NULL: no textures; all_kinds
// 0: triangles only; key_out / shadow_key_out NULL: no key written.
// counts (2 x uint64) is set to 0 here, then counts the lanes that traced
// this bounce's closest-hit ray and the shadow rays the bounce made.
extern "C" int pt_shade(
    int n, int bounce, int last, uint32_t seed, uint32_t iteration,
    const float* psample, const float* t, const int32_t* prim,
    const float* ro, const float* rd, const float* li, const float* beta,
    const float* prev_pdf, const int32_t* flags, const int32_t* lanes,
    const float* pending, const float* prim_attrs, const float* mat_attrs,
    const float* light_attrs, int n_lights, const float* light_cdf,
    const float* env_data, int env_w, int env_h, const float* env_u,
    const float* env_v, const float* env_w_axis, float env_tmax,
    const uint8_t* tex_data, const int32_t* tex_offset, const int32_t* tex_w,
    const int32_t* tex_h, int all_kinds, float eps, int aniso, int bssrdf,
    const float* center, float key_inv, float shadow_inv, float* ro_out,
    float* rd_out, float* li_out, float* beta_out, float* pdf_out,
    int32_t* flags_out, float* pending_out, float* so_out, float* sd_out,
    float* st_out, int64_t* key_out, int64_t* shadow_key_out,
    unsigned long long* counts, void* stream) {
  ShadeParams p;
  p.n = n;
  p.bounce = bounce;
  p.last = last != 0;
  p.seed = seed;
  p.iteration = iteration;
  p.psample = psample;
  p.t = t;
  p.prim = prim;
  p.ro = ro;
  p.rd = rd;
  p.li = li;
  p.beta = beta;
  p.prev_pdf = prev_pdf;
  p.flags = flags;
  p.lanes = lanes;
  p.pending = pending;
  p.prim_attrs = prim_attrs;
  p.mats = mat_attrs;
  p.lights = light_attrs;
  p.n_lights = n_lights;
  p.n_rows = n_lights > 1 ? n_lights : 1;
  p.cdf = light_cdf;
  p.env.data = env_data;
  p.env.w = env_w;
  p.env.h = env_h;
  p.env.u = env_u;
  p.env.v = env_v;
  p.env.wa = env_w_axis;
  p.env_tmax = env_tmax;
  p.tex = tex_data;
  p.tex_offset = tex_offset;
  p.tex_w = tex_w;
  p.tex_h = tex_h;
  p.eps = eps;
  p.aniso = aniso != 0;
  p.bssrdf = bssrdf != 0;
  p.center = center;
  p.key_inv = key_inv;
  p.shadow_inv = shadow_inv;
  p.ro_out = ro_out;
  p.rd_out = rd_out;
  p.li_out = li_out;
  p.beta_out = beta_out;
  p.pdf_out = pdf_out;
  p.flags_out = flags_out;
  p.pending_out = pending_out;
  p.so_out = so_out;
  p.sd_out = sd_out;
  p.st_out = st_out;
  p.key_out = key_out;
  p.shadow_key_out = shadow_key_out;
  p.counts = counts;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(counts, 0, 2 * sizeof(uint64_t), s);
  if (rc != cudaSuccess) return (int)rc;
  if (n == 0) return 0;
  const bool env = env_data != nullptr, tex = tex_data != nullptr;
  if (all_kinds) {
    if (env && tex) return launch<true, true, true>(p, s);
    if (env) return launch<true, false, true>(p, s);
    if (tex) return launch<false, true, true>(p, s);
    return launch<false, false, true>(p, s);
  }
  if (env && tex) return launch<true, true, false>(p, s);
  if (env) return launch<true, false, false>(p, s);
  if (tex) return launch<false, true, false>(p, s);
  return launch<false, false, false>(p, s);
}
