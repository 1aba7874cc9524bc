// The VPT wavefront's step: one thread shades one lane (vpt_shade), one
// thread takes one lane's transmittance walk across one segment
// (vpt_tr_round), and one thread settles one lane's last credit
// (vpt_finish).
//
// Replaces no Pallas kernel: the JAX package runs a VPT step
// (gpu_pathtracer_tpu/integrators/vpt.py:128, under lax.scan at :308) as
// one traced XLA program. The port's plain versions are
// integrators/vpt_shade.py::shade_torch, tr_round_torch and finish_torch,
// the step regrouped in PyTorch: hundreds of masked launches over every
// lane and gathers of whole table rows.
//
// A step's launches (integrators/vpt.py::render_lanes): the closest hit
// (K1, K3 or K4), the sample walk (track.cu in sample mode), vpt_shade,
// then TR_MAX_SEGMENTS rounds of (the closest hit of the walk's segment,
// vpt_tr_round, track.cu in tr mode).
//
// vpt_shade, per lane, in the plain version's order: the previous step's
// credit that waited for its walk (the walk's last segment Tr folded in,
// then the credit formed in the order the plain step forms it); the hit
// record; the sky on a miss, MIS weighted; the distance sample's weight
// (the sample walk's first collision, or the homogeneous closed form); a
// medium scatter's light sample, HG phase value and phase sample; the
// emitter arrival (full credit waiting for the segment's Tr, or MIS
// weighted); lanes past max_depth end; the interface pass-through; a
// surface's material (and texel), light sample, BSDF eval and power
// heuristic, BSDF sample, the next medium by crossing side, the depth and
// the roulette. A lane starts at most one walk a step: its medium-scatter
// NEE ray, its surface NEE ray or its emitter segment. The walk's call
// site (TRACK_SCATTER, TRACK_SURFACE, TRACK_EMITTER) keys its draws, so
// one walk serves the lanes that the unregrouped step walks in three.
// vpt_tr_round (shade/media.py::transmittance, one round): the previous
// round's heterogeneous segment Tr folded in; a hit with a real material
// blocks (Tr 0); the segment's length and medium for the round's track
// call (a homogeneous segment's Beer-Lambert Tr at once); the interface
// crossing by side.
//
// Draws: the step's 13 sites (core/rng.py: 4 + 16 s + k) from Philox
// (philox.cuh), four counter blocks a lane; the walks draw in track.cu.
//
// What bounds it on an H100: the bytes a lane moves. vpt_shade reads
// about 140 B of lane state and of the previous walk (with its 48 B of
// pending factors) and writes about 190 B (the next lane state and the
// new walk); vpt_tr_round reads about 70 B and writes about 60 B. The
// table rows (prim_attrs, materials, lights, media) are shared between
// lanes and mostly hit the cache. Each launch is one pass over the lanes,
// every intermediate in registers, the tables read through __ldg, the
// traced rays counted with one atomic a block.
//
// Variants (template flags): vpt_shade kEnv (a sky), kTex (textures),
// kAll (spheres or lines) and kHet (heterogeneous media: the sample
// walk's result and the emitter walk); vpt_tr_round kAll.
#include "media.cuh"
#include "shade.cuh"

// The entry points' arguments (integrators/vpt_shade.py's ctypes
// structures mirror them field for field).
struct VptShadeArgs {
  // the step's closest hit and sample walk (found_t NULL: no
  // heterogeneous medium), the lane ids
  const float* t;
  const int32_t* prim;
  const float* found_t;
  const int64_t* lanes;
  // the lane state
  const float* ro;
  const float* rd;
  const float* li;
  const float* beta;
  const float* prev_pdf;
  const int32_t* depth;
  const int32_t* med;
  const int32_t* flags;
  // the previous step's walk (w_flags NULL at step 0; w_out NULL when
  // no track call ran)
  const float* w_tr;
  const int32_t* w_flags;
  const float* w_pend;
  const float* w_out;
  // the scene's tables
  const float* prim_attrs;
  const float* mats;
  const float* lights;
  const float* cdf;
  const float* med_table;
  const float* env_data;   // NULL: no sky
  const float* env_u;
  const float* env_v;
  const float* env_wa;
  const uint8_t* tex;      // NULL: no textures
  const int32_t* tex_offset;
  const int32_t* tex_w;
  const int32_t* tex_h;
  // the next lane state
  float* ro_out;
  float* rd_out;
  float* li_out;
  float* beta_out;
  float* pdf_out;
  int32_t* depth_out;
  int32_t* med_out;
  int32_t* flags_out;
  float* tmax_out;          // the next closest hit's tmax
  int32_t* med_sample_out;  // the next sample walk's medium (kHet)
  // the new walk
  float* wo_out;
  float* wd_out;
  float* wrem_out;
  int32_t* wmed_out;
  float* wtr_out;
  int32_t* wflags_out;
  int32_t* sites_out;
  float* pend_out;
  float* wtmax_out;         // its first segment's hit tmax
  unsigned long long* rays;  // += the lanes alive at the step's start
  int n, step, max_depth, n_lights, n_rows, all_kinds, env_w, env_h, aniso,
      has_media;
  uint32_t seed, iteration;
  float eps, env_tmax;
};

struct VptTrArgs {
  const float* t;   // the round's closest hit
  const int32_t* prim;
  const float* o;   // the walk
  const float* d;
  const float* rem;
  const int32_t* med;
  const float* tr;
  const int32_t* flags;
  const float* out;   // the previous round's track call (NULL: none)
  const float* prim_attrs;
  const float* med_table;
  float* o_out;
  float* rem_out;
  int32_t* med_out;
  float* tr_out;
  int32_t* flags_out;
  float* tmax_out;         // the next round's hit tmax
  int32_t* track_med_out;  // this round's track call: medium (-1: none)
  float* track_t_out;      // and segment length
  unsigned long long* rays;  // += the lanes walking at the round's start
  int n, all_kinds;
};

struct VptFinishArgs {
  const float* li;
  const float* w_tr;
  const int32_t* w_flags;   // NULL: no walk
  const float* w_pend;
  const float* w_out;
  float* li_out;
  int n;
};

namespace {

constexpr int kThreads = 128;
// lane flags (integrators/vpt_shade.py)
constexpr int kSpecular = 1, kAlive = 2, kFromSurf = 4;
// walk flags: what the walk does next, and the credit that waits for it
constexpr int kWalking = 1, kEmit = 2, kFold = 4;
constexpr int kScatter = 8, kSurface = 16, kEmitter = 32;
constexpr int kCredit = kScatter | kSurface | kEmitter;
constexpr int kPend = 12;   // pending factors a lane
// the walk's call sites (core/rng.py TRACK_*)
constexpr int kSiteScatter = 1, kSiteSurface = 2, kSiteEmitter = 3;

// The credit that waited for the walk (vpt_shade.py::_settle): the last
// heterogeneous segment's Tr folded in where it is owed, then the credit
// in the order the plain step forms it.
__device__ __forceinline__ V3 settle(const float* w_tr, const int32_t* w_flags,
                                     const float* w_pend, const float* w_out,
                                     int i, V3 li) {
  const int f = w_flags[i];
  if (!(f & kCredit)) return li;
  V3 tr = load3(w_tr + 3 * i);
  if (f & kFold) tr = scl(tr, w_out[i]);
  const float* p = w_pend + (size_t)kPend * i;
  const V3 a = load3(p), b = load3(p + 3);
  if (f & kScatter) {   // tr * beta * (ph / denom) * rad
    return add(li, mul(scl(mul(tr, a), p[9]), b));
  }
  if (f & kEmitter) return add(li, mul(mul(tr, a), b));   // tr * beta * le
  // beta * (weight * tr * fr * rad * |cos| / denom)
  const V3 x = divs(scl(mul(mul(scl(tr, p[9]), a), b), p[10]), p[11]);
  return add(li, mul(load3(p + 6), x));
}

// The 13 sites of step s: k = 0 the homogeneous distance sample, 1-3 the
// scatter's light pick and uv, 4-5 the phase sample, 6-8 the surface's
// light pick and uv, 9-11 the BSDF sample, 12 the roulette; site
// 4 + 16 s + k is word k & 3 of counter block 1 + 4 s + (k >> 2).
struct StepDraws {
  float u[13];
};

__device__ __forceinline__ void step_draws(StepDraws* d, int step,
                                           uint32_t lane, uint32_t seed,
                                           uint32_t iteration) {
  const uint32_t blk = 1u + 4u * (uint32_t)step;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint4 w = philox(lane, blk + b, 0u, 0u, seed, iteration);
    d->u[4 * b] = bits_to_uniform(w.x);
    if (b < 3) {
      d->u[4 * b + 1] = bits_to_uniform(w.y);
      d->u[4 * b + 2] = bits_to_uniform(w.z);
      d->u[4 * b + 3] = bits_to_uniform(w.w);
    }
  }
}

__device__ __forceinline__ const float* med_row(const float* table, int k) {
  return table + (size_t)k * media::kMedCols;
}

__device__ __forceinline__ bool heterogeneous(const float* table, int k) {
  return (int)__ldg(med_row(table, k)) == media::kHeterogeneous;
}

// exp(sigma_t * -len) per channel (shade/media.py: Beer-Lambert)
__device__ __forceinline__ V3 beer(V3 sigma_t, float len) {
  return mk(expf(sigma_t.x * -len), expf(sigma_t.y * -len),
            expf(sigma_t.z * -len));
}

template <bool kEnv, bool kTex, bool kAll, bool kHet>
__device__ __forceinline__ void shade_lane(const VptShadeArgs& p, int i,
                                           bool* traced) {
  const V3 zero = mk(0.f, 0.f, 0.f), one = mk(1.f, 1.f, 1.f);
  const int f = p.flags[i];
  bool alive = (f & kAlive) != 0;
  bool specular = (f & kSpecular) != 0;
  bool from_surf = (f & kFromSurf) != 0;
  V3 ro = load3(p.ro + 3 * i), rd = load3(p.rd + 3 * i);
  V3 li = load3(p.li + 3 * i), beta = load3(p.beta + 3 * i);
  float prev_pdf = p.prev_pdf[i];
  int depth = p.depth[i], med = p.med[i];
  if (p.w_flags) li = settle(p.w_tr, p.w_flags, p.w_pend, p.w_out, i, li);
  *traced = alive;

  // the new walk and the credit that waits for it
  int wf = 0, site = 0, wmed = -1;
  V3 w_org = zero, w_dir = zero, wtr = one;
  float wrem = 0.f;
  float pend[kPend];
#pragma unroll
  for (int k = 0; k < kPend; ++k) pend[k] = 0.f;

  const float t = p.t[i];
  const int prim = p.prim[i];
  const bool full = depth == 0 || specular;
  const bool valid = alive && prim >= 0;
  if (kEnv && alive && !valid && (full || from_surf)) {
    const Env env = {p.env_data, p.env_w, p.env_h, p.env_u, p.env_v,
                     p.env_wa};
    env_credit(env, p.cdf, p.n_lights, p.n_rows, rd, beta, full, prev_pdf,
               &li);
  }
  alive = valid;
  Hit h;
  StepDraws u;
  if (alive) {
    h = hit_attributes<kTex, kAll>(p.prim_attrs, prim, ro, rd, t);
    step_draws(&u, p.step, (uint32_t)p.lanes[i], p.seed, p.iteration);
  }

  // the distance sample in the lane's medium over [0, t]
  bool sampled = false;
  float t_med = t;
  if (p.has_media && alive) {
    if (med >= 0) {
      const media::Optics o = media::load_optics(med_row(p.med_table, med));
      V3 weight;
      if (kHet && heterogeneous(p.med_table, med)) {
        const float ft = p.found_t[i];
        sampled = isfinite(ft);
        weight = sampled ? mk(o.sigma_s.x / tmax(o.sigma_t.x, 1e-30f),
                              o.sigma_s.y / tmax(o.sigma_t.y, 1e-30f),
                              o.sigma_s.z / tmax(o.sigma_t.z, 1e-30f))
                         : one;
        t_med = sampled ? ft : t;
      } else {
        const float dist = -logf(tmax(1.f - u.u[0], 1e-30f)) / o.sigma;
        const V3 tr_h = beer(o.sigma_t, dist);
        const float pdf_h = o.sigma * expf(-o.sigma * dist);
        sampled = dist < t;
        weight = sampled ? mk(tr_h.x * o.sigma_s.x / pdf_h,
                              tr_h.y * o.sigma_s.y / pdf_h,
                              tr_h.z * o.sigma_s.z / pdf_h)
                         : mk(o.sigma_t.x * tr_h.x / pdf_h,
                              o.sigma_t.y * tr_h.y / pdf_h,
                              o.sigma_t.z * tr_h.z / pdf_h);
        t_med = dist;
      }
      beta = mul(beta, weight);
    }
    if (is_black(beta)) alive = false;
  }
  const bool at_max = depth >= p.max_depth;
  if (sampled && at_max) alive = false;

  // a medium interaction: the light sample toward the scatter point, its
  // walk pending; the phase sample about -rd
  const bool in_scatter = alive && sampled;
  if (in_scatter) {
    const V3 pos = add(ro, scl(rd, t_med));
    const float g = __ldg(med_row(p.med_table, med) + 1);
    const Env env = {p.env_data, p.env_w, p.env_h, p.env_u, p.env_v,
                     p.env_wa};
    const int idx = pick_light(p.cdf, p.n_rows, u.u[1]);
    const float choice_pdf = light_choice_pdf(p.cdf, idx, p.n_rows);
    V3 rad, nd;
    float light_pdf, st;
    sample_light<kEnv>(p.lights, p.n_lights, env, p.env_tmax, p.eps, idx,
                       pos, pos, u.u[2], u.u[3], &rad, &nd, &light_pdf, &st);
    if (!is_black(rad) && light_pdf > 0.f) {
      const float ph = media::hg_phase(dot(neg(rd), nd), g);
      const float denom = tmax(light_pdf * choice_pdf, 1e-30f);
      pend[0] = beta.x, pend[1] = beta.y, pend[2] = beta.z;
      pend[3] = rad.x, pend[4] = rad.y, pend[5] = rad.z;
      pend[9] = ph / denom;
      wf = kWalking | kScatter;
      site = kSiteScatter;
      w_org = pos;
      w_dir = nd;
      wrem = st;
      wmed = med;
    }
    rd = media::sample_phase(g, neg(rd), u.u[4], u.u[5]);
    ro = pos;
    specular = from_surf = false;
  }

  // the emitter arrival (the full credit waits for the segment's Tr)
  bool on_surface = alive && !sampled;
  if (on_surface && p.n_lights > 0 && h.light >= 0) {
    const float* la = p.lights + (size_t)h.light * kLightAttrs;
    const V3 le = dot(h.nor, neg(rd)) > 0.f ? ldg3(la + 18) : zero;
    if (full) {
      if (med >= 0) {
        if (kHet && heterogeneous(p.med_table, med)) {
          wf = kEmit;   // round 0's track call walks [0, t]
          site = kSiteEmitter;
          w_org = ro;
          w_dir = rd;
          wrem = t;
          wmed = med;
        } else {
          wtr = beer(media::load_optics(med_row(p.med_table, med)).sigma_t,
                     t);
        }
      }
      wf |= kEmitter;
      pend[0] = beta.x, pend[1] = beta.y, pend[2] = beta.z;
      pend[3] = le.x, pend[4] = le.y, pend[5] = le.z;
      alive = on_surface = false;
    } else if (from_surf && !is_black(le)) {
      const float pdf_area =
          1.f / tmax(tri_area(ldg3(la), ldg3(la + 3), ldg3(la + 6)), 1e-30f);
      const float lchoice = light_choice_pdf(p.cdf, h.light, p.n_rows);
      const V3 seg = sub(h.pos, ro);
      const float l_pdf =
          pdf_area * dot(seg, seg) / tmax(fabsf(dot(h.nor, rd)), 1e-30f);
      li = add(li, scl(mul(beta, le), power_heuristic(prev_pdf,
                                                      l_pdf * lchoice)));
    }
  }
  // lanes past max_depth existed only to collect arrival credit
  if (at_max) alive = on_surface = false;

  // a medium interface: pass through, no bounce consumed
  const float* pa = p.prim_attrs + (size_t)(prim < 0 ? 0 : prim) * kPrimAttrs;
  if (on_surface && h.mat == -1) {
    med = (int)__ldg(pa + (dot(rd, h.nor) > 0.f ? 34 : 33));
    ro = h.pos;
    on_surface = false;
  }

  // a surface: the light sample (its walk pending), then the BSDF sample
  Mat m;
  const V3 wi = neg(rd);
  bool surface_nee = false;
  if (on_surface) {
    m = hit_material<kTex>(p.mats, p.tex, p.tex_offset, p.tex_w, p.tex_h,
                           h);
    if (!is_delta(m.type)) {
      const Env env = {p.env_data, p.env_w, p.env_h, p.env_u, p.env_v,
                       p.env_wa};
      const int idx = pick_light(p.cdf, p.n_rows, u.u[6]);
      const float choice_pdf = light_choice_pdf(p.cdf, idx, p.n_rows);
      V3 rad, nd;
      float light_pdf, st;
      sample_light<kEnv>(p.lights, p.n_lights, env, p.env_tmax, p.eps, idx,
                         h.pos, h.pos, u.u[7], u.u[8], &rad, &nd, &light_pdf,
                         &st);
      if (!is_black(rad) && light_pdf > 0.f) {
        V3 fr;
        float sample_pdf;
        eval_bsdf(m, wi, nd, h.nor, h.dpdu, &fr, &sample_pdf);
        const float lc = light_pdf * choice_pdf;
        pend[0] = fr.x, pend[1] = fr.y, pend[2] = fr.z;
        pend[3] = rad.x, pend[4] = rad.y, pend[5] = rad.z;
        pend[6] = beta.x, pend[7] = beta.y, pend[8] = beta.z;
        pend[9] = power_heuristic(lc, sample_pdf);
        pend[10] = fabsf(dot(h.nor, nd));
        pend[11] = tmax(lc, 1e-30f);
        surface_nee = true;
        wf = kWalking | kSurface;
        site = kSiteSurface;
        w_org = h.pos;
        w_dir = nd;
        wrem = st;
        wmed = med;
      }
    }
  }
  // the plain step's li + beta * Ld, Ld = 0 without a surface NEE ray
  if (!surface_nee) li = add(li, scl(beta, 0.f));

  bool surf_go = false;
  if (on_surface) {
    V3 wo, fr;
    float pdf;
    sample_bsdf(m, wi, h.nor, h.dpdu, u.u[9], u.u[10], u.u[11], p.aniso != 0,
                &wo, &fr, &pdf);
    if (is_black(fr) || pdf <= 0.f) {
      alive = false;
    } else {
      surf_go = true;
      const float cos_o = fabsf(dot(h.nor, wo));
      const float pm = tmax(pdf, 1e-30f);
      beta = mk(beta.x * fr.x * cos_o / pm, beta.y * fr.y * cos_o / pm,
                beta.z * fr.z * cos_o / pm);
      const bool delta = is_delta(m.type);
      specular = delta;
      prev_pdf = pdf;
      from_surf = !delta;
      // the next medium by crossing side; reflections keep the current one
      const float cos_wo = dot(wo, h.nor);
      if (!(dot(wi, h.nor) * cos_wo > 0.f))
        med = (int)__ldg(pa + (cos_wo > 0.f ? 34 : 33));
      ro = h.pos;
      rd = wo;
    }
  }
  const bool consumed = in_scatter || surf_go;
  if (consumed) ++depth;
  // Russian roulette, not on interfaces
  if (alive && consumed && depth > 4) {
    const float illumate = tclamp(1.f - luminance(beta), 0.f, 1.f);
    if (u.u[12] < illumate) {
      alive = false;
    } else {
      beta = scl(beta, 1.f / tmax(1.f - illumate, 1e-30f));
    }
  }

  store3(p.ro_out + 3 * i, ro);
  store3(p.rd_out + 3 * i, rd);
  store3(p.li_out + 3 * i, li);
  store3(p.beta_out + 3 * i, beta);
  p.pdf_out[i] = prev_pdf;
  p.depth_out[i] = depth;
  p.med_out[i] = med;
  p.flags_out[i] = (specular ? kSpecular : 0) | (alive ? kAlive : 0) |
                   (from_surf ? kFromSurf : 0);
  p.tmax_out[i] = alive ? INFINITY : 0.f;
  if (kHet) {
    p.med_sample_out[i] =
        alive && med >= 0 && heterogeneous(p.med_table, med) ? med : -1;
  }
  store3(p.wo_out + 3 * i, w_org);
  store3(p.wd_out + 3 * i, w_dir);
  p.wrem_out[i] = wrem;
  p.wmed_out[i] = wmed;
  store3(p.wtr_out + 3 * i, wtr);
  p.wflags_out[i] = wf;
  p.sites_out[i] = site;
  float* po = p.pend_out + (size_t)kPend * i;
#pragma unroll
  for (int k = 0; k < kPend; ++k) po[k] = pend[k];
  p.wtmax_out[i] = (wf & kWalking) ? wrem : 0.f;
}

template <bool kEnv, bool kTex, bool kAll, bool kHet>
__global__ void __launch_bounds__(kThreads) vpt_shade_kernel(VptShadeArgs p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool traced = false;
  if (i < p.n) shade_lane<kEnv, kTex, kAll, kHet>(p, i, &traced);
  const int n_traced = __syncthreads_count(traced);
  if (threadIdx.x == 0 && n_traced)
    atomicAdd(p.rays, (unsigned long long)n_traced);
}

template <bool kAll>
__device__ __forceinline__ void tr_lane(const VptTrArgs& p, int i,
                                        bool* traced) {
  int f = p.flags[i];
  V3 tr = load3(p.tr + 3 * i);
  if (f & kFold) tr = scl(tr, p.out[i]);
  V3 o = load3(p.o + 3 * i);
  float rem = p.rem[i];
  int med = p.med[i];
  bool walking = (f & kWalking) != 0;
  *traced = walking;
  int track_med = -1;
  float track_t = 0.f;
  bool fold = false;
  if (f & kEmit) {   // the emitter segment [0, rem] in medium med
    track_med = med;
    track_t = rem;
    fold = true;
  }
  if (walking) {
    const float t = p.t[i];
    const int prim = p.prim[i];
    const bool valid = prim >= 0;
    const float* pa = p.prim_attrs + (size_t)(valid ? prim : 0) * kPrimAttrs;
    if (valid && (int)__ldg(pa + 30) != -1) {   // a real material blocks
      tr = mk(0.f, 0.f, 0.f);
      walking = false;
    }
    const float seg_len = valid ? t : rem;
    if (walking && med >= 0) {
      const float* row = med_row(p.med_table, med);
      if ((int)__ldg(row) == media::kHeterogeneous) {
        track_med = med;
        track_t = seg_len;
        fold = true;
      } else {
        tr = mul(tr, beer(media::load_optics(row).sigma_t, seg_len));
      }
    }
    walking = walking && valid;
    if (walking) {   // cross the interface: the medium by crossing side
      const V3 d = load3(p.d + 3 * i);
      const Hit h = hit_attributes<false, kAll>(p.prim_attrs, prim, o, d, t);
      med = (int)__ldg(pa + (dot(d, h.nor) > 0.f ? 34 : 33));
      rem = rem - t;
      o = h.pos;
    }
  }
  store3(p.o_out + 3 * i, o);
  p.rem_out[i] = rem;
  p.med_out[i] = med;
  store3(p.tr_out + 3 * i, tr);
  p.flags_out[i] =
      (f & kCredit) | (walking ? kWalking : 0) | (fold ? kFold : 0);
  p.tmax_out[i] = walking ? rem : 0.f;
  p.track_med_out[i] = track_med;
  p.track_t_out[i] = track_t;
}

template <bool kAll>
__global__ void __launch_bounds__(kThreads) vpt_tr_round_kernel(VptTrArgs p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool traced = false;
  if (i < p.n) tr_lane<kAll>(p, i, &traced);
  const int n_traced = __syncthreads_count(traced);
  if (threadIdx.x == 0 && n_traced)
    atomicAdd(p.rays, (unsigned long long)n_traced);
}

__global__ void __launch_bounds__(kThreads) vpt_finish_kernel(VptFinishArgs p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  V3 li = load3(p.li + 3 * i);
  if (p.w_flags) li = settle(p.w_tr, p.w_flags, p.w_pend, p.w_out, i, li);
  // NaN/Inf guard: poisoned lanes are zeroed
  store3(p.li_out + 3 * i, finite3(li) ? li : mk(0.f, 0.f, 0.f));
}

int blocks_of(int n) { return (n + kThreads - 1) / kThreads; }

template <bool kEnv, bool kTex, bool kAll>
int launch_shade(const VptShadeArgs& a, bool het, cudaStream_t s) {
  if (het) {
    vpt_shade_kernel<kEnv, kTex, kAll, true>
        <<<blocks_of(a.n), kThreads, 0, s>>>(a);
  } else {
    vpt_shade_kernel<kEnv, kTex, kAll, false>
        <<<blocks_of(a.n), kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool kEnv, bool kTex>
int launch_kinds(const VptShadeArgs& a, bool het, cudaStream_t s) {
  return a.all_kinds ? launch_shade<kEnv, kTex, true>(a, het, s)
                     : launch_shade<kEnv, kTex, false>(a, het, s);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched); n == 0 launches nothing.
//
// One step's shading; env_data NULL: no sky, tex NULL: no textures,
// found_t NULL: no heterogeneous medium, w_flags NULL: no walk before.
extern "C" int vpt_shade(const VptShadeArgs* a, void* stream) {
  if (a->n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool env = a->env_data != nullptr, tex = a->tex != nullptr;
  const bool het = a->found_t != nullptr;
  if (env && tex) return launch_kinds<true, true>(*a, het, s);
  if (env) return launch_kinds<true, false>(*a, het, s);
  if (tex) return launch_kinds<false, true>(*a, het, s);
  return launch_kinds<false, false>(*a, het, s);
}

// One round of the step's transmittance walk.
extern "C" int vpt_tr_round(const VptTrArgs* a, void* stream) {
  if (a->n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a->all_kinds) {
    vpt_tr_round_kernel<true><<<blocks_of(a->n), kThreads, 0, s>>>(*a);
  } else {
    vpt_tr_round_kernel<false><<<blocks_of(a->n), kThreads, 0, s>>>(*a);
  }
  return (int)cudaGetLastError();
}

// The last step's credit and the NaN guard.
extern "C" int vpt_finish(const VptFinishArgs* a, void* stream) {
  if (a->n == 0) return 0;
  vpt_finish_kernel<<<blocks_of(a->n), kThreads, 0, (cudaStream_t)stream>>>(
      *a);
  return (int)cudaGetLastError();
}
