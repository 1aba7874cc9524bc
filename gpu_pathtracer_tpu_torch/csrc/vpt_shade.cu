// The VPT wavefront's step: one thread shades one listed lane (vpt_shade),
// one thread takes one listed lane's transmittance walk across one
// segment (vpt_tr_round), and one thread settles one lane's last credit
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
// The design. The lane state lives in one Lanes and one Walk for
// the whole spp, each row read and written in place, and each launch
// covers a list of lane rows that the launch before it built on the card:
// - vpt_shade runs over the step's list: the lanes alive at its start,
//   those owed the credit of the previous step's walk (a lane that died
//   with a credit pending stays listed until the credit is settled) and
//   the dead ones whose beta is not finite (the plain step adds beta x 0
//   to their li). It appends the next step's list and round 0's list
//   (the lanes that start a walk: WALKING or EMIT).
// - Each vpt_tr_round runs over its round's list and appends the lanes
//   still walking or folding a Tr to the next round's (two buffers).
// - A lane off a list is never read or written by that launch, so what
//   K1, track.cu and the next launch read of it is written once, when it
//   leaves: tmax 0 and med_sample -1 at its death, walk flags and tmax 0
//   when a credit ends with none new, track_med -1 and track_t 0 where
//   the last round folded (track_med >= 0 exactly where FOLD is set). The
//   walk's other fields (origin, direction, length, medium, Tr, call site,
//   the pending factors, as three 16-byte vectors) are written only where
//   a credit starts and read only while it is held; vpt_tr_round writes a
//   field only where it changes.
// - List order comes from the atomics and varies from run to run; no
//   result depends on it (each lane is bit-equal to its plain version,
//   the ray count is an integer sum).
// - vpt_shade: a block for every 256 rows of the list's capacity (those
//   past its length, read on the card, leave at once); each block appends
//   its rows, in thread order, with one atomicAdd a list. vpt_tr_round: a
//   persistent grid (the blocks that fit on the card, the occupancy API),
//   each warp a run of the list's 32-entry chunks, its appends staged in
//   shared memory and flushed with one atomicAdd, so an empty round costs
//   about 2 us and no host sync.
// What bounds them on an H100: not the bytes of the listed lanes (PERF.md
// section 6 counts them) but each lane's chain of dependent loads (the
// hit record, the tables, the light CDF) and its branches, at 16 warps an
// SM for vpt_shade (111 registers); an update that covers part of a
// 32-byte sector costs a sector read and write, so the lists' order and
// the fields a launch writes set its memory traffic.
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
  // the step's list of lane rows and its length on the device (list NULL:
  // rows 0 .. n - 1)
  const int32_t* list;
  const int32_t* count;
  // the lane state, read and written in place
  float* ro;
  float* rd;
  float* li;
  float* beta;
  float* prev_pdf;
  int32_t* depth;
  int32_t* med;
  int32_t* flags;
  float* tmax;          // the next closest hit's tmax
  int32_t* med_sample;  // the next sample walk's medium (kHet)
  // the walk: the previous step's read, this step's written, in place
  float* w_o;
  float* w_d;
  float* w_rem;
  int32_t* w_med;
  float* w_tr;
  int32_t* w_flags;
  int32_t* w_sites;
  float* w_pend;
  float* w_tmax;        // its first segment's hit tmax
  int32_t* track_med;   // the last round's track call, reset where it
  float* track_t;       // folded and no walk starts
  const float* w_out;   // the previous walk's last track result (NULL: none)
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
  // the lists it appends to: the next step's and round 0's
  int32_t* next_list;
  int32_t* next_count;
  int32_t* walk_list;
  int32_t* walk_count;
  unsigned long long* rays;  // += the listed lanes alive at the step's start
  int n, step, max_depth, n_lights, n_rows, all_kinds, env_w, env_h, aniso,
      has_media;
  uint32_t seed, iteration;
  float eps, env_tmax;
};

struct VptTrArgs {
  const float* t;   // the round's closest hit
  const int32_t* prim;
  const int32_t* list;   // the round's list and its length on the device
  const int32_t* count;  // (list NULL: rows 0 .. n - 1)
  float* o;   // the walk, read and written in place
  const float* d;
  float* rem;
  int32_t* med;
  float* tr;
  int32_t* flags;
  float* tmax;         // the next round's hit tmax
  int32_t* track_med;  // this round's track call: medium (-1: none),
  float* track_t;      // segment length
  float* track_o;      // and origin
  const float* out;    // the previous round's track call (NULL: none)
  const float* prim_attrs;
  const float* med_table;
  int32_t* next_list;  // the next round's list
  int32_t* next_count;
  unsigned long long* rays;  // += the listed lanes walking at its start
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

constexpr int kThreads = 128;        // vpt_tr_round, vpt_finish
constexpr int kShadeThreads = 256;   // vpt_shade
constexpr int kStage = 256;   // ids a warp stages for one list
// lane flags (integrators/vpt_shade.py)
constexpr int kSpecular = 1, kAlive = 2, kFromSurf = 4;
// walk flags: what the walk does next, and the credit that waits for it
constexpr int kWalking = 1, kEmit = 2, kFold = 4;
constexpr int kScatter = 8, kSurface = 16, kEmitter = 32;
constexpr int kCredit = kScatter | kSurface | kEmitter;
constexpr int kPend = 12;   // pending factors a lane: three float4
// the walk's call sites (core/rng.py TRACK_*)
constexpr int kSiteScatter = 1, kSiteSurface = 2, kSiteEmitter = 3;

// A warp's rows for one list, staged in shared memory and appended with
// one atomicAdd a flush: runs of up to kStage ids in the order the warp
// met them.
struct Staged {
  int32_t* buf;   // the warp's kStage slots
  int n;          // ids staged (the same on every lane of the warp)
};

// Stages row i where `pred` holds. Every thread of the warp calls it.
__device__ __forceinline__ void stage(Staged& s, bool pred, int i) {
  const unsigned m = __ballot_sync(0xFFFFFFFFu, pred);
  if (pred) s.buf[s.n + __popc(m & ((1u << (threadIdx.x & 31)) - 1u))] = i;
  s.n += __popc(m);
}

// Appends the staged ids to `list` (length *count) when `all` or when the
// next chunk might not fit. Every thread of the warp calls it.
__device__ __forceinline__ void flush(Staged& s, int32_t* list,
                                      int32_t* count, bool all) {
  if (s.n == 0 || (!all && s.n <= kStage - 32)) return;
  __syncwarp();
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(count, s.n);
  base = __shfl_sync(0xFFFFFFFFu, base, 0);
  for (int k = threadIdx.x & 31; k < s.n; k += 32) list[base + k] = s.buf[k];
  __syncwarp();
  s.n = 0;
}

// Appends row i where `pred` holds, the block's rows in thread order,
// with one atomicAdd a block. Every thread of the block calls it.
__device__ __forceinline__ void block_append(bool pred, int i, int32_t* list,
                                             int32_t* count) {
  __shared__ int warp_at[kShadeThreads / 32];
  __shared__ int base;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xFFFFFFFFu, pred);
  if (lane == 0) warp_at[w] = __popc(m);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kShadeThreads / 32; ++k) {
      const int c = warp_at[k];
      warp_at[k] = total;
      total += c;
    }
    base = total ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  if (pred) list[base + warp_at[w] + __popc(m & ((1u << lane) - 1u))] = i;
  __syncthreads();
}

// The credit that waited for the walk (vpt_shade.py::_settle): the last
// heterogeneous segment's Tr folded in where it is owed, then the credit
// in the order the plain step forms it. f: the walk's flags.
__device__ __forceinline__ V3 settle(const float* w_tr, int f,
                                     const float* w_pend, const float* w_out,
                                     int i, V3 li) {
  if (!(f & kCredit)) return li;
  V3 tr = load3(w_tr + 3 * i);
  if (f & kFold) tr = scl(tr, w_out[i]);
  // a [3], b [3], c [3], s, cos, denom
  const float4* p = reinterpret_cast<const float4*>(w_pend + (size_t)kPend * i);
  const float4 v0 = p[0], v1 = p[1], v2 = p[2];
  const V3 a = mk(v0.x, v0.y, v0.z), b = mk(v0.w, v1.x, v1.y);
  if (f & kScatter) {   // tr * beta * (ph / denom) * rad
    return add(li, mul(scl(mul(tr, a), v2.y), b));
  }
  if (f & kEmitter) return add(li, mul(mul(tr, a), b));   // tr * beta * le
  // beta * (weight * tr * fr * rad * |cos| / denom)
  const V3 x = divs(scl(mul(mul(scl(tr, v2.y), a), b), v2.z), v2.w);
  return add(li, mul(mk(v1.z, v1.w, v2.x), x));
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

// Shades row i. *traced: alive at the step's start; *next: on the next
// step's list; *walks: on round 0's.
template <bool kEnv, bool kTex, bool kAll, bool kHet>
__device__ __forceinline__ void shade_lane(const VptShadeArgs& p, int i,
                                           bool* traced, bool* next,
                                           bool* walks) {
  const V3 zero = mk(0.f, 0.f, 0.f), one = mk(1.f, 1.f, 1.f);
  const int f = p.flags[i];
  const int wf_prev = p.w_flags[i];
  bool alive = (f & kAlive) != 0;
  const bool alive0 = alive;
  bool specular = (f & kSpecular) != 0;
  bool from_surf = (f & kFromSurf) != 0;
  V3 ro = load3(p.ro + 3 * i), rd = load3(p.rd + 3 * i);
  V3 li = load3(p.li + 3 * i), beta = load3(p.beta + 3 * i);
  float prev_pdf = p.prev_pdf[i];
  int depth = p.depth[i], med = p.med[i];
  li = settle(p.w_tr, wf_prev, p.w_pend, p.w_out, i, li);
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

  // the lane's row: a lane dead at the step's start changes li alone
  store3(p.li + 3 * i, li);
  if (alive0) {
    store3(p.ro + 3 * i, ro);
    store3(p.rd + 3 * i, rd);
    store3(p.beta + 3 * i, beta);
    p.prev_pdf[i] = prev_pdf;
    p.depth[i] = depth;
    p.med[i] = med;
    p.flags[i] = (specular ? kSpecular : 0) | (alive ? kAlive : 0) |
                 (from_surf ? kFromSurf : 0);
    p.tmax[i] = alive ? INFINITY : 0.f;
    if (kHet) {
      p.med_sample[i] =
          alive && med >= 0 && heterogeneous(p.med_table, med) ? med : -1;
    }
  }
  // the walk's row where a credit starts, and flags and tmax where one
  // starts or ends; the last round's track call reset where it folded
  if (wf) {
    store3(p.w_o + 3 * i, w_org);
    store3(p.w_d + 3 * i, w_dir);
    p.w_rem[i] = wrem;
    p.w_med[i] = wmed;
    store3(p.w_tr + 3 * i, wtr);
    p.w_sites[i] = site;
    float4* po = reinterpret_cast<float4*>(p.w_pend + (size_t)kPend * i);
    po[0] = make_float4(pend[0], pend[1], pend[2], pend[3]);
    po[1] = make_float4(pend[4], pend[5], pend[6], pend[7]);
    po[2] = make_float4(pend[8], pend[9], pend[10], pend[11]);
  }
  if (wf || wf_prev) {
    p.w_flags[i] = wf;
    p.w_tmax[i] = (wf & kWalking) ? wrem : 0.f;
  }
  if (wf_prev & kFold) {
    p.track_med[i] = -1;
    p.track_t[i] = 0.f;
  }
  *walks = (wf & (kWalking | kEmit)) != 0;
  *next = alive || wf != 0 || !finite3(beta);
}

// Warp w of the grid's W takes the list's chunks of 32 entries [c, c1):
// the w-th of W runs of about equal length, on its own (no block-wide
// barrier, so a warp whose lanes take long holds up no other). Its
// appends keep the run's order.
__device__ __forceinline__ void warp_chunks(int n, int* c, int* c1) {
  const int w = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int n_warps = (int)((gridDim.x * blockDim.x) >> 5);
  const int chunks = (n + 31) >> 5;
  const int per = (chunks + n_warps - 1) / n_warps;
  *c = min(w * per, chunks);
  *c1 = min(*c + per, chunks);
}

// Adds the warp's count to *rays, one atomicAdd a warp.
__device__ __forceinline__ void add_rays(unsigned n, unsigned long long* rays) {
  n = __reduce_add_sync(0xFFFFFFFFu, n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(rays, (unsigned long long)n);
}

// A block for each kShadeThreads rows of the list's capacity; the blocks
// past its length, read on the card, leave at once.
template <bool kEnv, bool kTex, bool kAll, bool kHet>
__global__ void __launch_bounds__(kShadeThreads, 1)
    vpt_shade_kernel(VptShadeArgs p) {
  const int n = p.count ? *p.count : p.n;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if ((int)(blockIdx.x * blockDim.x) >= n) return;
  bool traced = false, next = false, walks = false;
  int i = 0;
  if (j < n) {
    i = p.list ? p.list[j] : j;
    shade_lane<kEnv, kTex, kAll, kHet>(p, i, &traced, &next, &walks);
  }
  block_append(next, i, p.next_list, p.next_count);
  block_append(walks, i, p.walk_list, p.walk_count);
  const int n_traced = __syncthreads_count(traced);
  if (threadIdx.x == 0 && n_traced)
    atomicAdd(p.rays, (unsigned long long)n_traced);
}

// One round of row i's walk. *traced: walking at the round's start;
// *next: on the next round's list. A field is read where the round needs
// it and written where it changes: Tr where a fold, a block or a
// homogeneous segment acts on it, flags where they change, tmax where the
// lane walked or walks, the track call where it walks a segment or walked
// one (track_med >= 0 exactly where FOLD is set), o, rem and med where the
// lane crosses.
template <bool kAll>
__device__ __forceinline__ void tr_lane(const VptTrArgs& p, int i,
                                        bool* traced, bool* next) {
  const int f = p.flags[i];
  const bool walking0 = (f & kWalking) != 0;
  bool walking = walking0;
  *traced = walking;
  bool tr_set = false;
  V3 tr;
  if (f & kFold) {
    tr = scl(load3(p.tr + 3 * i), p.out[i]);
    tr_set = true;
  }
  V3 o0;
  float rem = 0.f;
  int med = -1;
  if (walking || (f & kEmit)) {
    o0 = load3(p.o + 3 * i);
    rem = p.rem[i];
    med = p.med[i];
  }
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
      tr_set = true;
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
        if (!tr_set) tr = load3(p.tr + 3 * i);
        tr = mul(tr, beer(media::load_optics(row).sigma_t, seg_len));
        tr_set = true;
      }
    }
    walking = walking && valid;
    if (walking) {   // cross the interface: the medium by crossing side
      const V3 d = load3(p.d + 3 * i);
      const Hit h = hit_attributes<false, kAll>(p.prim_attrs, prim, o0, d, t);
      med = (int)__ldg(pa + (dot(d, h.nor) > 0.f ? 34 : 33));
      rem = rem - t;
      store3(p.o + 3 * i, h.pos);
      p.rem[i] = rem;
      p.med[i] = med;
    }
  }
  if (tr_set) store3(p.tr + 3 * i, tr);
  const int nf = (f & kCredit) | (walking ? kWalking : 0) | (fold ? kFold : 0);
  if (nf != f) p.flags[i] = nf;
  if (walking0) p.tmax[i] = walking ? rem : 0.f;
  if (fold || (f & kFold)) {
    p.track_med[i] = track_med;
    p.track_t[i] = track_t;
  }
  if (fold) store3(p.track_o + 3 * i, o0);
  *next = walking || fold;
}

// The persistent grid: each warp a run of the list's chunks, its appends
// staged in shared memory.
template <bool kAll>
__global__ void __launch_bounds__(kThreads) vpt_tr_round_kernel(VptTrArgs p) {
  __shared__ int32_t buf[kThreads / 32][kStage];
  Staged next_s = {buf[threadIdx.x >> 5], 0};
  const int n = p.count ? *p.count : p.n;
  int c = 0, c1 = 0;
  warp_chunks(n, &c, &c1);
  unsigned n_traced = 0;
  for (; c < c1; ++c) {
    const int j = 32 * c + (threadIdx.x & 31);
    bool traced = false, next = false;
    int i = 0;
    if (j < n) {
      i = p.list ? p.list[j] : j;
      tr_lane<kAll>(p, i, &traced, &next);
    }
    stage(next_s, next, i);
    flush(next_s, p.next_list, p.next_count, false);
    n_traced += traced;
  }
  flush(next_s, p.next_list, p.next_count, true);
  add_rays(n_traced, p.rays);
}

__global__ void __launch_bounds__(kThreads) vpt_finish_kernel(VptFinishArgs p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  V3 li = load3(p.li + 3 * i);
  if (p.w_flags) li = settle(p.w_tr, p.w_flags[i], p.w_pend, p.w_out, i, li);
  // NaN/Inf guard: poisoned lanes are zeroed
  store3(p.li_out + 3 * i, finite3(li) ? li : mk(0.f, 0.f, 0.f));
}

int blocks_of(int n) { return (n + kThreads - 1) / kThreads; }

// The persistent grid of a kernel over a list of at most n rows: the
// blocks of `threads` threads that fit on the card at once (the occupancy
// API; asked once a kernel, cached in *per_card), at most one per
// `threads` rows. 0 with the CUDA error in *rc on a failure.
template <typename Kernel>
int grid_of(Kernel kernel, int threads, int n, int* per_card, int* rc) {
  if (*per_card == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0) !=
            cudaSuccess) {
      *rc = (int)cudaGetLastError();
      return 0;
    }
    if (per_sm == 0) {
      *rc = (int)cudaErrorInvalidConfiguration;
      return 0;
    }
    *per_card = per_sm * sms;
  }
  const int needed = (n + threads - 1) / threads;
  return needed < *per_card ? needed : *per_card;
}

template <bool kEnv, bool kTex, bool kAll, bool kHet>
int launch_shade(const VptShadeArgs& a, cudaStream_t s) {
  const int blocks = (a.n + kShadeThreads - 1) / kShadeThreads;
  vpt_shade_kernel<kEnv, kTex, kAll, kHet><<<blocks, kShadeThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool kEnv, bool kTex>
int launch_kinds(const VptShadeArgs& a, bool het, cudaStream_t s) {
  if (a.all_kinds) {
    return het ? launch_shade<kEnv, kTex, true, true>(a, s)
               : launch_shade<kEnv, kTex, true, false>(a, s);
  }
  return het ? launch_shade<kEnv, kTex, false, true>(a, s)
             : launch_shade<kEnv, kTex, false, false>(a, s);
}

template <bool kAll>
int launch_round(const VptTrArgs& a, cudaStream_t s) {
  static int per_card = 0;
  int rc = 0;
  const int blocks =
      grid_of(vpt_tr_round_kernel<kAll>, kThreads, a.n, &per_card, &rc);
  if (blocks == 0) return rc;
  vpt_tr_round_kernel<kAll><<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// out[0..4]: threads a block, blocks an SM (the occupancy API), registers,
// local (stack frame) bytes and blocks a launch on the current card
template <typename Kernel>
int describe(Kernel kernel, int threads, int* out) {
  cudaFuncAttributes attr;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess)
    return (int)cudaGetLastError();
  out[0] = threads;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = per_sm * sms;
  return 0;
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched); n == 0 launches nothing.
//
// One step's shading over its list; env_data NULL: no sky, tex NULL: no
// textures, found_t NULL: no heterogeneous medium.
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

// One round of the step's transmittance walk over its list.
extern "C" int vpt_tr_round(const VptTrArgs* a, void* stream) {
  if (a->n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return a->all_kinds ? launch_round<true>(*a, s) : launch_round<false>(*a, s);
}

// The last step's credit and the NaN guard.
extern "C" int vpt_finish(const VptFinishArgs* a, void* stream) {
  if (a->n == 0) return 0;
  vpt_finish_kernel<<<blocks_of(a->n), kThreads, 0, (cudaStream_t)stream>>>(
      *a);
  return (int)cudaGetLastError();
}

// The launch shapes, five ints each (describe's): out[0..79] vpt_shade's
// 16 variants, variant k = 8 env + 4 tex + 2 all kinds + heterogeneous;
// out[80..89] vpt_tr_round's two (all kinds 0, 1). Returns a CUDA error
// code.
extern "C" int vpt_occupancy(int* out) {
  int rc = 0;
#define VPT_DESCRIBE(k, e, t, a, h)                                         \
  if (!rc) rc = describe(vpt_shade_kernel<e, t, a, h>, kShadeThreads,      \
                         out + 5 * (k));
  VPT_DESCRIBE(0, false, false, false, false)
  VPT_DESCRIBE(1, false, false, false, true)
  VPT_DESCRIBE(2, false, false, true, false)
  VPT_DESCRIBE(3, false, false, true, true)
  VPT_DESCRIBE(4, false, true, false, false)
  VPT_DESCRIBE(5, false, true, false, true)
  VPT_DESCRIBE(6, false, true, true, false)
  VPT_DESCRIBE(7, false, true, true, true)
  VPT_DESCRIBE(8, true, false, false, false)
  VPT_DESCRIBE(9, true, false, false, true)
  VPT_DESCRIBE(10, true, false, true, false)
  VPT_DESCRIBE(11, true, false, true, true)
  VPT_DESCRIBE(12, true, true, false, false)
  VPT_DESCRIBE(13, true, true, false, true)
  VPT_DESCRIBE(14, true, true, true, false)
  VPT_DESCRIBE(15, true, true, true, true)
#undef VPT_DESCRIBE
  if (!rc) rc = describe(vpt_tr_round_kernel<false>, kThreads, out + 80);
  if (!rc) rc = describe(vpt_tr_round_kernel<true>, kThreads, out + 85);
  return rc;
}
