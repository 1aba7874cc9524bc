// Path-trace megakernel (K2): the whole PT estimator, one path a thread.
//
// Replaces the TPU kernel gpu_pathtracer_tpu/integrators/pt_fused.py::
// _kernel (pallas_call at pt_fused.py:1272), which keeps a 4096-path tile
// in VMEM and walks it through SEG-bounce segments, with its environment
// and textured variants.
//
// What bounds it on an H100: instruction issue in a long, divergent
// per-thread program. Per bounce a path tests up to 512 prims twice
// (closest hit, shadow ray), then runs one of six BSDF models; it reads
// 24 bytes of ray and writes 16 bytes of result per PATH, so device
// memory is idle and the prim loops' arithmetic dominates. Divergence
// comes from material models and from paths that end at different
// bounces.
//
// Design:
// - one thread carries one path through every bounce in registers (no
//   SEG segmenting, no state in device memory between bounces, no lane
//   padding);
// - for scenes of triangles only without a sky the grid is persistent
//   (as many blocks as fit on the card): a warp takes lanes 32 at a time
//   from a device counter and hands one to each thread whose path ended,
//   which starts it at once (path regeneration), so a warp does not wait
//   on its longest path; the other variants, whose warps lose coherence
//   when lanes at different bounces mix, run a thread a lane
//   (`regenerates`, by measurement). A path reads its ray, its psample
//   column and writes li_out and rays_out at its own lane index, so its
//   result does not depend on which thread ran it;
// - each block stages the dense prim table (<= 512 x 64 B = 32 KB) in
//   shared memory once, with each triangle's normal in the pad columns,
//   so the prim loops read broadcast rows and test a triangle with K1's
//   division-free test (intersect.cuh::tri_cross_n: the best hit is a
//   fraction, compared by cross products; the winning triangle's t is
//   then computed with the plain version's arithmetic, tri_hit); the
//   hit-attribute, material and light rows are read through the read-
//   only cache;
// - everything else is the plain PyTorch wavefront of integrators/pt.py
//   (its plain version) written per thread: the same operations in the
//   same order, the same random sites (philox.cuh, or rows of an
//   explicit primary-sample matrix) and the same table reads, in
//   shade.cuh, which the wavefront's shading kernel (pt_shade.cu) shares
//   with this one. The kernel
//   is held to that version within PERF.md section 2's radiance limits: a
//   ray through a shared edge may take the other triangle.
//
// Variants (template flags, one instantiation each): kEnv, the scene has
// an environment light; kTex, it has textures; kAll, it has spheres or
// lines (else the prim loops have no type branch). Neither carries over
// the TPU kernel's workarounds (an escape record the XLA side finishes, a
// mean-texel diffuse folded back per bounce). A thread fetches texels
// itself: on a miss it adds beta * Le(rd) of the sky with the
// wavefront's MIS weight, its NEE picks the sky's slot of the light CDF
// and samples it by uniform sphere, and a textured hit reads the four
// wrapped and clamped texels of the uint8 atlas (12 MB for a 2048^2
// texture: it stays in the 50 MB L2) and blends them as the Lambertian
// or substrate diffuse (shade/texture.py, shade/lights.py).
#include "shade.cuh"

namespace {

// ---------------------------------------------------------------------------
// the launch's parameters
// ---------------------------------------------------------------------------
struct Params {
  const float* ro;
  const float* rd;
  const int32_t* lanes;
  int n;
  uint32_t seed, iteration;
  const float* psample;
  const float* dense_prims;
  int n_prims;
  const float* prim_attrs;
  const float* mats;
  const float* lights;
  int n_lights;  // area lights; the environment's CDF slot is n_lights
  int n_rows;    // light_attrs rows: max(n_lights, 1)
  const float* cdf;
  Env env;
  float env_tmax;  // shadow ray length toward the sky: 2 r_world - eps
  const uint8_t* tex;
  const int32_t* tex_offset;
  const int32_t* tex_w;
  const int32_t* tex_h;
  int max_depth;
  float eps;
  bool aniso;
  int32_t* next;  // the lane counter of the persistent grid
  float* li_out;
  int32_t* rays_out;
};

// ---------------------------------------------------------------------------
// the prim loops: K1's (dense.cu) triangle test on the staged normals, no
// division; the plain version's rules: closest hit keeps the FIRST row
// among equal t (strictly nearer wins), any hit takes t in [tmin, tmax]
// ---------------------------------------------------------------------------
template <bool kAll>
__device__ __forceinline__ int closest_hit(const float4* prims, int n_prims,
                                           V3 o, V3 d, float t0, float t1,
                                           float* t) {
  float tb = t1, ab = 1.f;   // the best hit is tb / ab (t1 / 1 before any)
  float bt = t1;   // ... its t, for the sphere and line tests (kAll)
  int best = -1;
  for (int p = 0; p < n_prims; ++p) {
    const float4* row = prims + 4 * p;
    const float4 q0 = row[0], q1 = row[1], q2 = row[2];
    const V3 v0 = mk(q0.x, q0.y, q0.z);
    const V3 a = mk(q0.w, q1.x, q1.y);
    if (kAll && (q2.y == PRIM_SPHERE || q2.y == PRIM_LINE)) {
      float tp, s;
      const bool h = q2.y == PRIM_SPHERE
          ? sphere_hit(o, d, v0, q2.z, t0, bt, &tp)
          : line_hit(o, d, v0, a, q2.z, q2.w, t0, bt, &tp, &s);
      if (h && tp < bt) {
        best = p;
        tb = bt = tp;
        ab = 1.f;
      }
    } else {   // a triangle, or a pad row (normal 0: never crosses)
      const float4 q3 = row[3];
      float tn, ad;
      if (tri_cross_n(o, d, v0, a, mk(q1.z, q1.w, q2.x),
                      mk(q3.y, q3.z, q3.w), &tn, &ad) &&
          tn >= t0 * ad && tn * ab < tb * ad) {
        best = p;
        tb = tn;
        ab = ad;
        if (kAll) bt = tn / ad;   // one division per hit taken
      }
    }
  }
  *t = t1;
  if (best >= 0) {
    const float4* row = prims + 4 * best;
    const float4 q0 = row[0], q1 = row[1], q2 = row[2];
    *t = tb;   // a sphere's or a line's t as its test gave it
    if (q2.y == PRIM_TRIANGLE) {   // the plain version's t of this row
      tri_hit(o, d, mk(q0.x, q0.y, q0.z), mk(q0.w, q1.x, q1.y),
              mk(q1.z, q1.w, q2.x), -INFINITY, INFINITY, t);
    }
  }
  return best;
}

template <bool kAll>
__device__ __forceinline__ bool any_hit(const float4* prims, int n_prims,
                                        V3 o, V3 d, float t0, float t1) {
  for (int p = 0; p < n_prims; ++p) {
    const float4* row = prims + 4 * p;
    const float4 q0 = row[0], q1 = row[1], q2 = row[2];
    const V3 v0 = mk(q0.x, q0.y, q0.z);
    const V3 a = mk(q0.w, q1.x, q1.y);
    if (kAll && (q2.y == PRIM_SPHERE || q2.y == PRIM_LINE)) {
      float tp, s;
      if (q2.y == PRIM_SPHERE ? sphere_hit(o, d, v0, q2.z, t0, t1, &tp)
                              : line_hit(o, d, v0, a, q2.z, q2.w, t0, t1,
                                         &tp, &s)) {
        return true;
      }
    } else {
      const float4 q3 = row[3];
      float tn, ad;
      if (tri_cross_n(o, d, v0, a, mk(q1.z, q1.w, q2.x),
                      mk(q3.y, q3.z, q3.w), &tn, &ad) &&
          tn >= t0 * ad && tn <= t1 * ad) {
        return true;
      }
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// the persistent kernel
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;
// Blocks of kThreads a SM the launch bounds ask for: the most that ptxas
// fits without a spill (5: 96 registers; the sky's variants spill 4
// bytes at 5, so 4: 110-111 registers). At 6 and 7 blocks (80 and 73
// registers, 72-104 bytes of spill) most variants ran 2-10% faster on an
// H100 (PERF.md), but the kernel keeps no spill.
constexpr int min_blocks(bool env) { return env ? 4 : 5; }
constexpr unsigned kFull = 0xFFFFFFFFu;

// One path's state between bounces: lane index i (-1: the thread holds
// no path), bounce b (max_depth: the epilogue's closest hit is next).
struct Path {
  V3 ro, rd, li, beta;
  float prev_pdf;
  int i, b, rays;
  uint32_t lane;
  bool specular;
};

__device__ __forceinline__ void start_path(const Params& p, int i, Path& s) {
  s.i = i;
  s.lane = (uint32_t)p.lanes[i];
  s.ro = load3(p.ro + 3 * i);
  s.rd = load3(p.rd + 3 * i);
  s.li = mk(0.f, 0.f, 0.f);
  s.beta = mk(1.f, 1.f, 1.f);
  s.prev_pdf = 1.f;
  s.b = 0;
  s.rays = 0;
  s.specular = false;
}

__device__ __forceinline__ void finish_path(const Params& p, Path& s) {
  // NaN/Inf guard: a poisoned lane is zeroed
  if (!finite3(s.li)) s.li = mk(0.f, 0.f, 0.f);
  store3(p.li_out + 3 * s.i, s.li);
  p.rays_out[s.i] = s.rays;
  s.i = -1;
}

// One bounce of path s (closest hit + arrival credit, NEE, BSDF sample,
// Russian roulette), or at b = max_depth the epilogue: the last
// continuation ray's emitter credit. Ends the path where it ends.
// pt_shade.cu has the material, light sample, NEE estimate and
// continuation below as functions, line for line (shade.cuh says why):
// an edit here must reach them.
template <bool kEnv, bool kTex, bool kAll>
__device__ __forceinline__ void bounce(const Params& p, const float4* table,
                                       Path& s) {
  const bool last = s.b == p.max_depth;
  BounceDraws u;
  if (!last) {
    bounce_draws(&u, s.b, s.lane, s.i, p.n, p.seed, p.iteration, p.psample);
  }
  // closest hit + arrival credit (in full at bounce 0 and after a
  // specular bounce)
  ++s.rays;
  float t;
  const int prim = closest_hit<kAll>(table, p.n_prims, s.ro, s.rd, p.eps,
                                     __int_as_float(0x7f800000), &t);
  const bool full = s.specular || (s.b == 0 && !last);
  if (prim < 0) {
    if (kEnv)
      env_credit(p.env, p.cdf, p.n_lights, p.n_rows, s.rd, s.beta, full,
                 s.prev_pdf, &s.li);
    finish_path(p, s);
    return;
  }
  const Hit h = hit_attributes<kTex>(p.prim_attrs, prim, s.ro, s.rd, t);
  if (!arrival_credit(p.lights, p.cdf, p.n_rows, h, s.ro, s.rd, s.beta, full,
                      s.prev_pdf, &s.li) ||
      last) {
    finish_path(p, s);
    return;
  }

  Mat m = gather_material(p.mats, h.mat);
  if (kTex) {  // shade/bsdf.py::gather_materials: the texel as diffuse
    const int ti = (int)__ldg(p.mats + (size_t)(h.mat < 0 ? 0 : h.mat) *
                                           kMatAttrs + 17);
    if (ti >= 0)
      m.diffuse = texel(p.tex, p.tex_offset, p.tex_w, p.tex_h, ti, h.u, h.v);
  }
  const V3 wi = neg(s.rd);

  // NEE: light pick, area or sky sample, shadow ray, BSDF eval, MIS
  if (!is_delta(m.type)) {
    int cnt = 0;
    for (int l = 0; l < p.n_rows + 2; ++l) cnt += __ldg(p.cdf + l) <= u.u[0];
    int idx = cnt - 1;
    idx = idx < 0 ? 0 : (idx > p.n_rows ? p.n_rows : idx);
    const float choice_pdf = light_choice_pdf(p.cdf, idx, p.n_rows);
    V3 rad, nd;
    float light_pdf, st;
    if (kEnv && idx == p.n_lights) {  // the sky: a uniform-sphere direction
      nd = uniform_sphere(u.u[1], u.u[2]);
      rad = env_le(p.env, nd);
      light_pdf = kInvFourPi;
      st = p.env_tmax;
    } else if (p.n_lights == 0) {
      // the sky alone, of zero power (its texel [0, 0] black): the CDF
      // never picks its slot, and common.sample_light gives no sample
      rad = mk(0.f, 0.f, 0.f);
      nd = h.nor;
      light_pdf = st = 0.f;
    } else {
      const float* la =
          p.lights + (size_t)(idx < p.n_lights ? idx : p.n_lights - 1) *
                         kLightAttrs;
      const V3 v0 = ldg3(la), v1 = ldg3(la + 3), v2 = ldg3(la + 6);
      const float su1 = sqrtf(tmax(u.u[1], 0.f));
      const float bu = 1.f - su1;
      const float bv = u.u[2] * su1;
      const float bw = 1.f - bu - bv;
      const V3 lp = add(add(scl(v0, bu), scl(v1, bv)), scl(v2, bw));
      const V3 lnor = normalize(add(add(scl(ldg3(la + 9), bu),
                                        scl(ldg3(la + 12), bv)),
                                    scl(ldg3(la + 15), bw)));
      const V3 d = sub(lp, h.pos);
      const float dist2 = dot(d, d);
      nd = normalize(d);
      const float cos_l = fabsf(dot(lnor, nd));
      light_pdf = dist2 / tmax(tri_area(v0, v1, v2) * cos_l, 1e-30f);
      if (dot(lnor, d) >= 0.f) light_pdf = 0.f;
      rad = light_pdf != 0.f ? ldg3(la + 18) : mk(0.f, 0.f, 0.f);
      st = sqrtf(tmax(dist2 - p.eps, 0.f));
    }
    if (!is_black(rad) && light_pdf > 0.f) {
      ++s.rays;
      if (!any_hit<kAll>(table, p.n_prims, h.pos, nd, p.eps, st)) {
        V3 fr;
        float sample_pdf;
        eval_bsdf(m, wi, nd, h.nor, h.dpdu, &fr, &sample_pdf);
        const float denom = light_pdf * choice_pdf;
        const float weight = power_heuristic(denom, sample_pdf);
        const float cos_s = fabsf(dot(h.nor, nd));
        const float dm = tmax(denom, 1e-30f);
        const V3 ld = mk(weight * fr.x * rad.x * cos_s / dm,
                         weight * fr.y * rad.y * cos_s / dm,
                         weight * fr.z * rad.z * cos_s / dm);
        s.li = add(s.li, mul(s.beta, ld));
      }
    }
  }

  // BSDF sample: continuation ray + MIS pdf
  V3 wo, fr;
  float pdf;
  sample_bsdf(m, wi, h.nor, h.dpdu, u.u[3], u.u[4], u.u[5], p.aniso, &wo,
              &fr, &pdf);
  if (is_black(fr) || pdf <= 0.f) {
    finish_path(p, s);
    return;
  }
  const float cos_o = fabsf(dot(h.nor, wo));
  const float pm = tmax(pdf, 1e-30f);
  s.beta = mk(s.beta.x * fr.x * cos_o / pm, s.beta.y * fr.y * cos_o / pm,
              s.beta.z * fr.z * cos_o / pm);
  s.specular = is_delta(m.type);
  s.prev_pdf = pdf;
  s.ro = h.pos;
  s.rd = wo;

  // Russian roulette after bounce 3
  if (s.b > 3) {
    const float illumate = tclamp(1.f - luminance(s.beta), 0.f, 1.f);
    if (u.u[6] < illumate) {
      finish_path(p, s);
      return;
    }
    s.beta = scl(s.beta, 1.f / tmax(1.f - illumate, 1e-30f));
  }
  ++s.b;
}

// Path regeneration pays where a warp's lanes stay coherent from bounce
// to bounce (triangles only, Lambertian-like, no sky: cornell_port,
// textured.json, 12-14% faster on an H100) and loses where lanes that
// escape to the sky or meet several prim kinds mix with lanes at other
// bounces (env, mixed, materials.json: 3-18% slower; PERF.md).
__host__ __device__ constexpr bool regenerates(bool env, bool all) {
  return !env && !all;
}

// With regeneration the grid is persistent: each warp takes lanes 32 at
// a time from the device counter p.next and hands them to its threads as
// their paths end, so a thread whose path ended runs the next lane's
// path at once. Without, a thread carries lane blockIdx.x * kThreads +
// threadIdx.x to its end.
template <bool kEnv, bool kTex, bool kAll>
__global__ void __launch_bounds__(kThreads, min_blocks(kEnv))
    pt_fused_kernel(Params p) {
  extern __shared__ float4 table[];
  stage_rows(table, p.dense_prims, p.n_prims);   // ends with a barrier
  if (!regenerates(kEnv, kAll)) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n) return;
    Path s;
    start_path(p, i, s);
    while (s.i >= 0) bounce<kEnv, kTex, kAll>(p, table, s);
    return;
  }
  const unsigned me = threadIdx.x & 31u;
  int pool = 0, pool_n = 0;   // the warp's fetched lanes not handed out
  bool drained = false;       // the counter ran out (the same in the warp)
  Path s;
  s.i = -1;
  for (;;) {
    unsigned need = __ballot_sync(kFull, s.i < 0);
    while (need != 0u && !drained) {
      if (pool_n == 0) {
        int first = 0;
        if (me == 0) first = atomicAdd(p.next, 32);
        first = __shfl_sync(kFull, first, 0);
        if (first >= p.n) {
          drained = true;
          break;
        }
        pool = first;
        pool_n = min(32, p.n - first);
      }
      const int take = min(__popc(need), pool_n);
      const int rank = __popc(need & ((1u << me) - 1u));
      if (((need >> me) & 1u) && rank < take) start_path(p, pool + rank, s);
      pool += take;
      pool_n -= take;
      need = __ballot_sync(kFull, s.i < 0);
    }
    if (!__any_sync(kFull, s.i >= 0)) break;
    if (s.i >= 0) bounce<kEnv, kTex, kAll>(p, table, s);
  }
}

template <bool kEnv, bool kTex, bool kAll>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = pt_fused_kernel<kEnv, kTex, kAll>;
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const int need = (p.n + kThreads - 1) / kThreads;
  const int blocks =
      regenerates(kEnv, kAll) ? min(need, max(per_sm, 1) * sms) : need;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// env_data NULL: no environment light; tex_data NULL: no textures;
// all_kinds 0: the triangles-only variant (no sphere, no line). `next`
// is a device int the kernel uses as its lane counter (set to 0 here).
extern "C" int pt_fused(const float* ro, const float* rd,
                        const int32_t* lanes, int n, uint32_t seed,
                        uint32_t iteration, const float* psample,
                        const float* dense_prims,
                        int n_prims, const float* prim_attrs,
                        const float* mat_attrs, const float* light_attrs,
                        int n_lights, const float* light_cdf, int max_depth,
                        float eps, int aniso, const float* env_data, int env_w,
                        int env_h, const float* env_u, const float* env_v,
                        const float* env_w_axis, float env_tmax,
                        const uint8_t* tex_data, const int32_t* tex_offset,
                        const int32_t* tex_w, const int32_t* tex_h,
                        int all_kinds, int32_t* next, float* li_out,
                        int32_t* rays_out, void* stream) {
  Params p;
  p.ro = ro;
  p.rd = rd;
  p.lanes = lanes;
  p.n = n;
  p.seed = seed;
  p.iteration = iteration;
  p.psample = psample;
  p.dense_prims = dense_prims;
  p.n_prims = n_prims;
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
  p.max_depth = max_depth;
  p.eps = eps;
  p.aniso = aniso != 0;
  p.next = next;
  p.li_out = li_out;
  p.rays_out = rays_out;
  const size_t smem = sizeof(float4) * 4 * (size_t)n_prims;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(next, 0, sizeof(int32_t), s);
  if (rc != cudaSuccess) return (int)rc;
  const bool env = env_data != nullptr, tex = tex_data != nullptr;
  if (all_kinds) {
    if (env && tex) return launch<true, true, true>(p, smem, s);
    if (env) return launch<true, false, true>(p, smem, s);
    if (tex) return launch<false, true, true>(p, smem, s);
    return launch<false, false, true>(p, smem, s);
  }
  if (env && tex) return launch<true, true, false>(p, smem, s);
  if (env) return launch<true, false, false>(p, smem, s);
  if (tex) return launch<false, true, false>(p, smem, s);
  return launch<false, false, false>(p, smem, s);
}
