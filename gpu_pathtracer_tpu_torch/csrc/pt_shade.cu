// The PT wavefront's shading of one bounce: one thread shades one lane.
//
// Replaces no Pallas kernel: the JAX package runs a bounce of its
// wavefront (gpu_pathtracer_tpu/integrators/pt.py:167, the body of a
// jitted lax.scan) as XLA fusions. The port's plain version is
// integrators/pt_shade.py::shade_wave_torch over shade_torch, hundreds of
// masked PyTorch launches over every lane and gathers of whole table rows.
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
// (common.py::_shadow_sort_key), both int32. The arithmetic is K2's
// (shade.cuh), so the two kernels shade alike.
//
// The lane state between bounces is one 64-byte record a lane, four
// float4s (pt_shade.py REC): li and prev_pdf; beta and the flags; the
// pending credit and the lane id; the caller's slot. The next ray stays
// in [N, 3] ro and rd, which the hit kernels take. A lane with nothing
// left to add (dead, no credit pending, not SSS) stores its radiance at
// its caller's slot of `out` once and is not read again.
//
// Sorted rows (`sorted`): position i of bounce b reads its record at
// order[i] of bounce b - 1's output (a gather through the sort's order
// instead of a repack) and writes it whole at position i of the other
// buffer. The first counts[b][0] positions hold the lanes alive after
// b - 1 (the sort puts dead keys last); the next counts[b][1] take the
// dead lanes still owed a visit (a pending credit, SSS) from list_in;
// blocks past both only clear their positions' shadow tmax and key and
// leave. The counts and list_out of bounce b + 1 are appended here: one
// atomicAdd a block for the live count, one a warp for the list. The
// keys of positions past the live lanes are not written: the caller
// passes the previous sort's sorted keys, which hold the dead key there.
// Unsorted rows: the records are updated in place (a finished lane's
// with flags 0, so that later bounces skip it after reading them).
// On the sorted rows a warp's records move through a 2 KB stage in
// shared memory wherever they are its own positions' (every write, the
// first bounce's reads), so that the card sees 512-byte rows of 16-byte
// vectors and not 16 bytes in every 64; in place a lane reads and writes
// its own record (the stage was slower there, PERF.md). A position's
// hit, ray and shadow verdict load with its record (on the sorted rows
// with the counts and the order too), so the record adds no round trip
// before them.
//
// What bounds it on an H100: the bytes a live lane moves (chip_smoke.py's
// shade_work counts them: a field where the lane reads it, a word where
// its value changes) and the table rows it reads, which are shared
// between lanes and mostly hit the cache. Every intermediate stays in
// registers, the tables are read through the read-only cache (__ldg), and
// the traced rays are counted with one atomic a block.
//
// Variants (template flags, as K2's): kEnv, the scene has a sky; kTex,
// textures; kAll, spheres or lines (else the hit record has no type
// branch).
#include "shade.cuh"

// The entry point's arguments (integrators/pt_shade.py::_ShadeArgs
// mirrors them field for field).
struct PtShadeArgs {
  const float* t;        // the bounce's closest hit at the positions
  const int32_t* prim;
  const float* psample;  // NULL: Philox
  const float4* rec;     // [N, 4] the records read
  float4* rec_out;       // sorted: the other buffer; unsorted: rec
  const int64_t* order;  // sorted after bounce 0; NULL: position = record
  const int32_t* list_in;   // sorted: records owed a visit
  int32_t* list_out;
  int32_t* counts;       // sorted: [D + 2, 2]
  const uint8_t* occ;    // NULL at bounce 0: the verdicts by record
  float* ray;            // [2, N, 3] ro then rd, updated in place
  float* tmax;           // unsorted: the next hit's, in place
  float* so;
  float* sd;
  float* st;             // the shadow ray's tmax, 0 where none
  int32_t* key;          // sorted: the next ray's key
  int32_t* skey;         // NULL: shadow rays not sorted
  float* out;            // [N, 3] radiance by caller slot
  unsigned long long* rays;  // [2] += closest rays, shadow rays
  const float* prim_attrs;
  const float* mats;
  const float* lights;
  const float* cdf;
  const float* env_data;  // NULL: no sky
  const float* env_u;
  const float* env_v;
  const float* env_w;
  const uint8_t* tex;     // NULL: no textures
  const int32_t* tex_offset;
  const int32_t* tex_w;
  const int32_t* tex_h;
  const float* center;    // the scene's bounding-sphere centre [3]
  int n, bounce, last, sorted, n_lights, env_cols, env_rows, all_kinds,
      aniso, bssrdf;
  uint32_t seed, iteration;
  float env_tmax, eps;
  float key_inv;     // 1 / (2 max(r, 1e-6)), as PyTorch divides on CUDA
  float shadow_inv;  // 1 / (2 r)
};

namespace {

constexpr int kShadeThreads = 128;
// lane flags (integrators/pt_shade.py)
constexpr int kSpecular = 1, kAlive = 2, kSss = 8, kPending = 16;
constexpr int kDeadKey = 1 << 20;      // pt.py::_sort_key
constexpr int kNoShadowKey = 1 << 24;  // common.py::_shadow_sort_key

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
// updated state (*moved: the next ray was set). (The sites come by value,
// so a bounce's draws stay in registers.)
__device__ __forceinline__ bool continue_path(const Mat& m, const Hit& h,
                                              V3 wi, float u1, float u2,
                                              float u3, float u_rr,
                                              int bounce, bool aniso,
                                              V3* beta, bool* specular,
                                              float* prev_pdf, V3* ro,
                                              V3* rd, bool* moved) {
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
  *moved = true;
  if (bounce > 3) {
    const float illumate = tclamp(1.f - luminance(*beta), 0.f, 1.f);
    if (u_rr < illumate) return false;
    *beta = scl(*beta, 1.f / tmax(1.f - illumate, 1e-30f));
  }
  return true;
}


// the cell of one coordinate: clamp(((x - c) * inv + 0.5) * scale, 0, hi)
// truncated to int, as PyTorch computes it on CUDA (a division by a
// Python float is a product with its float32 reciprocal there)
__device__ __forceinline__ int cell(float x, float c, float inv, float scale,
                                    float hi) {
  return (int)tclamp(((x - c) * inv + 0.5f) * scale, 0.f, hi);
}

// common.py::morton_bits of the three cells: bit b of axis a at 3 b + a
__device__ __forceinline__ int morton3(int qx, int qy, int qz, int bits) {
  int m = 0;
  for (int b = 0; b < bits; ++b) {
    m |= ((qx >> b) & 1) << (3 * b);
    m |= ((qy >> b) & 1) << (3 * b + 1);
    m |= ((qz >> b) & 1) << (3 * b + 2);
  }
  return m;
}

// What one position did, for its block's counts.
struct Did {
  bool traced = false, shadow = false, alive = false, listed = false;
};

// The closest hit and the ray at position i.
struct PosHit {
  int prim;
  float t;
  V3 ro, rd;
};

__device__ __forceinline__ PosHit load_pos(const PtShadeArgs& p, int i) {
  return {p.prim[i], p.t[i], load3(p.ray + 3 * (size_t)i),
          load3(p.ray + 3 * ((size_t)p.n + i))};
}

// Shade the lane whose record q (4 float4s) position i holds; `front`: it
// was alive at the start, `occluded`: its last shadow ray was blocked,
// and `ph` holds the position's hit and ray (at the epilogue loaded
// here). Writes the position's next ray, tmax,
// shadow ray and keys and, when the lane finishes, its radiance at its
// slot; returns whether its record is written back (out: the new
// record).
template <bool kEnv, bool kTex, bool kAll>
__device__ __forceinline__ bool shade_lane(const PtShadeArgs& p, int i,
                                           bool front, bool occluded,
                                           PosHit ph, const float4* q,
                                           float4* out, Did* did) {
  const V3 zero = mk(0.f, 0.f, 0.f);
  const int f = __float_as_int(q[1].w);
  bool alive = front;
  bool specular = (f & kSpecular) != 0;
  V3 li = mk(q[0].x, q[0].y, q[0].z), beta = mk(q[1].x, q[1].y, q[1].z);
  float prev_pdf = q[0].w;
  if ((f & kPending) && !occluded) {   // the previous bounce's NEE credit
    li = add(li, mk(q[2].x, q[2].y, q[2].z));
  }
  did->traced = alive;
  bool sss = false, cand = false, moved = false;
  V3 ro = zero, rd = zero, pend = zero, so = zero, sd = zero;
  float st = 0.f;
  if (alive) {
    if (p.last) ph = load_pos(p, i);
    ro = ph.ro;
    rd = ph.rd;
    const int prim = ph.prim;
    const bool full = specular || (p.bounce == 0 && !p.last);
    const int n_rows = p.n_lights > 1 ? p.n_lights : 1;
    const Env env = {p.env_data, p.env_cols, p.env_rows, p.env_u, p.env_v,
                     p.env_w};
    alive = false;
    if (prim < 0) {
      if (kEnv) {
        env_credit(env, p.cdf, p.n_lights, n_rows, rd, beta, full, prev_pdf,
                   &li);
      }
    } else {
      const Hit h = hit_attributes<kTex, kAll>(p.prim_attrs, prim, ro, rd,
                                               ph.t);
      const bool on = arrival_credit(p.lights, p.cdf, n_rows, h, ro, rd,
                                     beta, full, prev_pdf, &li);
      if (on && !p.last && p.bssrdf &&
          (int)__ldg(p.prim_attrs + (size_t)prim * kPrimAttrs + 32) >= 0) {
        sss = true;
      } else if (on && !p.last) {
        BounceDraws u;
        bounce_draws(&u, p.bounce, (uint32_t)__float_as_int(q[2].w), i, p.n,
                     p.seed, p.iteration, p.psample);
        const Mat m = hit_material<kTex>(p.mats, p.tex, p.tex_offset,
                                         p.tex_w, p.tex_h, h);
        const V3 wi = neg(rd);
        if (!is_delta(m.type)) {
          const int idx = pick_light(p.cdf, n_rows, u.u[0]);
          const float choice_pdf = light_choice_pdf(p.cdf, idx, n_rows);
          V3 rad, nd;
          float light_pdf, tl;
          sample_light<kEnv>(p.lights, p.n_lights, env, p.env_tmax, p.eps,
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
                              &prev_pdf, &ro, &rd, &moved);
      }
    }
  }
  did->alive = alive;
  did->shadow = cand;
  bool write = false;
  const bool done = p.last || !(alive || cand || sss);
  if (done) {   // nothing left to add: the radiance to its slot, once
    store3(p.out + 3 * (size_t)__float_as_int(q[3].x), li);
  }
  if (!p.last && (!done || !p.sorted)) {
    // the record (unsorted: also a finished lane's, flags 0, so later
    // bounces skip it)
    const int nf = done ? 0
                        : (specular ? kSpecular : 0) | (alive ? kAlive : 0) |
                              (sss ? kSss : 0) | (cand ? kPending : 0);
    out[0] = make_float4(li.x, li.y, li.z, prev_pdf);
    out[1] = make_float4(beta.x, beta.y, beta.z, __int_as_float(nf));
    out[2] = cand ? make_float4(pend.x, pend.y, pend.z, q[2].w) : q[2];
    out[3] = q[3];
    write = true;
    did->listed = p.sorted && !done && !alive;
  }
  if (p.last) return false;
  if (!front) {   // a dead lane's credit: it makes no shadow ray
    if (!p.sorted) {   // (a listed lane's words are set by the caller)
      p.st[i] = 0.f;
      if (p.skey) p.skey[i] = kNoShadowKey;
    }
    return write;
  }
  if (moved) {
    store3(p.ray + 3 * (size_t)i, ro);
    store3(p.ray + 3 * ((size_t)p.n + i), rd);
  }
  if (!p.sorted && !alive) p.tmax[i] = 0.f;
  p.st[i] = st;
  if (cand) {
    store3(p.so + 3 * (size_t)i, so);
    store3(p.sd + 3 * (size_t)i, sd);
  }
  if (p.sorted) {
    int key = kDeadKey;
    if (alive) {
      const float c0 = __ldg(p.center), c1 = __ldg(p.center + 1),
                  c2 = __ldg(p.center + 2);
      const float s = (float)15.999, hi = 15.f;
      const int octant =
          (rd.x > 0.f ? 1 : 0) | (rd.y > 0.f ? 2 : 0) | (rd.z > 0.f ? 4 : 0);
      key = (octant << 12) | morton3(cell(ro.x, c0, p.key_inv, s, hi),
                                     cell(ro.y, c1, p.key_inv, s, hi),
                                     cell(ro.z, c2, p.key_inv, s, hi), 4);
    }
    p.key[i] = key;
  }
  if (p.skey) {
    int key = kNoShadowKey;
    if (cand && st > 0.f) {
      const float c0 = __ldg(p.center), c1 = __ldg(p.center + 1),
                  c2 = __ldg(p.center + 2);
      const float s = (float)63.999, hi = 63.f;
      key = morton3(cell(so.x, c0, p.shadow_inv, s, hi),
                    cell(so.y, c1, p.shadow_inv, s, hi),
                    cell(so.z, c2, p.shadow_inv, s, hi), 6);
    }
    p.skey[i] = key;
  }
  return write;
}

// A block of 4 warps. Each warp's 32 positions read their records (when
// they are the positions' own: unsorted, or bounce 0) and write them (the
// positions are contiguous) through a 2 KB stage in shared memory, as
// 512-byte rows of 16-byte vectors, not as 64-byte strides a thread.
template <bool kEnv, bool kTex, bool kAll>
__global__ void __launch_bounds__(kShadeThreads)
    pt_shade_kernel(PtShadeArgs p) {
  __shared__ float4 stage[4 * kShadeThreads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float4* ws = stage + 4 * (threadIdx.x - lane);
  const size_t w0 = (size_t)(i - lane);   // the warp's first position
  // the position's hit and ray load with its record (and, on the sorted
  // rows, with the counts and the order), not after them; but at the
  // epilogue, where most positions hold no live lane
  int64_t o = i;
  PosHit ph{};
  if (p.sorted && p.order && i < p.n) o = p.order[i];
  if (!p.last && i < p.n) ph = load_pos(p, i);
  int n_live = p.n, n_visit = p.n;
  if (p.sorted) {
    n_live = p.counts[2 * p.bounce];
    n_visit = n_live + p.counts[2 * p.bounce + 1];
    if ((int)(blockIdx.x * blockDim.x) >= n_visit) {   // no lane to shade
      if (!p.last && i < p.n) {
        p.st[i] = 0.f;
        if (p.skey) p.skey[i] = kNoShadowKey;
      }
      return;
    }
  }
  // the record position i shades: its own, the order's or the list's
  int src = i;
  bool visit = i < p.n, front = visit;
  if (p.sorted && visit) {
    if (i >= n_live) {   // past the live lanes: no shadow ray here
      if (!p.last) {
        p.st[i] = 0.f;
        if (p.skey) p.skey[i] = kNoShadowKey;
      }
      visit = i < n_visit;
      if (visit) src = p.list_in[i - n_live];
      front = false;
    } else {
      src = (int)o;
    }
  }
  // the verdict loads with the record, not after the record's flags
  const bool occluded = p.occ && visit && p.occ[src];
  float4 q[4];
  if (p.sorted && !p.order) {   // the positions' own records: staged
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = lane + 32 * k;
      if (w0 + (j >> 2) < (size_t)p.n) ws[j] = p.rec[4 * w0 + j];
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = ws[4 * lane + k];
    __syncwarp();
  } else if (visit) {
    const float4* r = p.rec + 4 * (size_t)src;
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = r[k];
  }
  if (!p.sorted && visit) {
    const int f = __float_as_int(q[1].w);
    visit = (f & (kAlive | kPending | kSss)) != 0;   // else finished earlier
    front = (f & kAlive) != 0;
  }
  Did did;
  float4 out[4];
  const bool write =
      visit &&
      shade_lane<kEnv, kTex, kAll>(p, i, front, occluded, ph, q, out, &did);
  if (!p.last && !p.sorted) {   // in place
    if (write) {
#pragma unroll
      for (int k = 0; k < 4; ++k) p.rec_out[4 * (size_t)i + k] = out[k];
    }
  } else if (!p.last) {   // the records written back, staged
    if (write) {
#pragma unroll
      for (int k = 0; k < 4; ++k) ws[4 * lane + k] = out[k];
    }
    const unsigned m = __ballot_sync(0xffffffffu, write);
    __syncwarp();
    if (m) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = lane + 32 * k;
        if ((m >> (j >> 2)) & 1u) p.rec_out[4 * w0 + j] = ws[j];
      }
    }
  }
  const int n_traced = __syncthreads_count(did.traced);
  const int n_shadow = __syncthreads_count(did.shadow);
  if (p.sorted && !p.last) {
    const int n_alive = __syncthreads_count(did.alive);
    // the dead lanes owed a visit: one atomicAdd a warp
    const unsigned m = __ballot_sync(0xffffffffu, did.listed);
    if (m) {
      int base = 0;
      if (lane == 0) base = atomicAdd(p.counts + 2 * p.bounce + 3, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (did.listed) p.list_out[base + __popc(m & ((1u << lane) - 1u))] = i;
    }
    if (threadIdx.x == 0 && n_alive)
      atomicAdd(p.counts + 2 * p.bounce + 2, n_alive);
  }
  if (threadIdx.x == 0) {
    if (n_traced) atomicAdd(p.rays, (unsigned long long)n_traced);
    if (n_shadow) atomicAdd(p.rays + 1, (unsigned long long)n_shadow);
  }
}

template <bool kEnv, bool kTex, bool kAll>
int launch(const PtShadeArgs& p, cudaStream_t stream) {
  const int blocks = (p.n + kShadeThreads - 1) / kShadeThreads;
  pt_shade_kernel<kEnv, kTex, kAll><<<blocks, kShadeThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches bounce `a->bounce` on `stream`; returns cudaGetLastError() (0 =
// launched). n == 0 launches nothing.
extern "C" int pt_shade(const PtShadeArgs* a, void* stream) {
  if (a->n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool env = a->env_data != nullptr, tex = a->tex != nullptr;
  if (a->all_kinds) {
    if (env && tex) return launch<true, true, true>(*a, s);
    if (env) return launch<true, false, true>(*a, s);
    if (tex) return launch<false, true, true>(*a, s);
    return launch<false, false, true>(*a, s);
  }
  if (env && tex) return launch<true, true, false>(*a, s);
  if (env) return launch<true, false, false>(*a, s);
  if (tex) return launch<false, true, false>(*a, s);
  return launch<false, false, false>(*a, s);
}
