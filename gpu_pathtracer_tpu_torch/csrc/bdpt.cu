// BDPT's per-lane work: one thread starts one subpath row (bdpt_start) and
// steps it (bdpt_step), G threads run every connection round of one lane
// (bdpt_connect), and one thread credits four lanes' queued connections
// (bdpt_finish).
//
// Replaces no Pallas kernel: the JAX package runs BDPT
// (gpu_pathtracer_tpu/integrators/bdpt.py:465 render_lanes) as traced XLA
// programs: the subpath step (:182, under a scan), the MIS tables and
// weight (:383, :421) and the connection rounds (dense_round :547,
// round_block :832). The port's plain versions are
// integrators/bdpt_shade.py::start_torch, step_torch, connect_torch and
// finish_torch: some 1,700 masked launches a sample over every row and
// every (lane, column) item, and gathers of whole vertex records.
//
// A sample's launches (integrators/bdpt.py::render_lanes): bdpt_start,
// then per step the closest hit of the 2N subpath rays (K1, K3 or K4),
// the sample walk (track.cu, heterogeneous media) and bdpt_step; then
// bdpt_connect, the queue's shadow rays (one any-hit call over the whole
// queue, or with media one Tr walk over its live slots) and bdpt_finish.
//
// bdpt_start, per row: the camera's pixel jitter, primary ray and pdfW,
// or the light pick and the light's emitted point and direction (the
// draws of tag 0 or BDPT_LIGHT_TAG, sites 0-4), vertex 0 and the row's
// state. It writes vertex 0 alone: each step writes its new vertex
// whole (a reverse pdf of 0 until the next step sets it), so every slot
// below a row's count is written and no kernel reads one above it.
//
// bdpt_step, per row (rows 0 .. N - 1 the camera subpaths in radiance
// transport, N .. 2N - 1 the light subpaths in importance transport), in
// the plain version's order: the step's draws; the hit record; the
// distance sample's weight (the sample walk's first collision, or the
// homogeneous closed form); a scatter vertex with its phase sample and the
// previous vertex's reverse pdf; the interface crossing; a surface vertex
// with its material, BSDF sample, the previous vertex's reverse pdf and
// the next medium; the vertex count; the roulette after bounce 4; the next
// step's tmax and sample-walk medium. Each row writes its vertex into the
// tables in place. The tables are vertex-major: vertex m of row r is slot
// m * 2N + r (bdpt_shade.py keeps [2N, K] views of [K, 2N] storage), so
// a step's rows, which mostly add the same vertex, write side by side,
// and the connect kernel's threads read vertex m of neighbouring lanes
// side by side. A step runs over all 2N rows, a finished row leaving at
// its flag: launched over an order-kept list of the live rows (ascending,
// the next list built by a second, light launch), the step took 0.27-0.29
// ms at steps 1-4 on cornell_port's 1M lanes against 0.22-0.24 over all
// rows, though its rows fell to half (H100 80GB HBM3, 700 W; PERF.md
// section 6).
//
// bdpt_connect, per lane: in order the rounds s1, t0, t1 and general s =
// 2 .. K, each over the G = K - 1 columns: the case's contribution with
// its pdf overrides, the MIS weight, and (but t0) the roulette against
// the lane's mean over the round's valid items. t0's columns add to li at
// once, in column order. A connection that survives its roulette gets its
// queue slot (shadow ray, credit, medium, s1's raster pixel); the others
// get an empty slot (tmax 0, which the hit kernels skip). G threads of a
// warp run a lane, one a column (the design note above the kernel).
//
// bdpt_finish, per lane: L x tr of each live slot (tr 0 or 1 from the
// any-hit call, or the walk's transmittance); the s1 credits atomically
// into the film at their raster pixel; the other rounds' columns summed
// in column order and added round by round to li; the NaN guard. A
// thread runs four neighbouring lanes and loads a slot's words of them
// as vectors (the design note above the kernel).
//
// Draws (philox.cuh): a step's 7 sites at counter blocks 2 + 2 s and 3 +
// 2 s of the row's lane under tag 0 or BDPT_LIGHT_TAG; a connection round
// p's sites at block p of item 32 lane + column under BDPT_CONNECT_TAG
// (t1: words 0-2 the light sample, 3 the roulette; s1 and general: word
// 0 the roulette).
//
// What bounds them on an H100: the bytes a row or a lane moves, and for
// bdpt_connect its instructions as much. bdpt_step reads about
// 60 B of row state and a vertex (the previous) and writes one vertex
// (77 B) and the row state; bdpt_connect reads both subpaths' vertices
// below their counts (at most 2 K, about 0.7 KB a lane at K = 6) and
// writes the queue: a byte and a float a slot, 40 B more a live slot (35
// slots a lane at K = 6); bdpt_finish reads a slot's flag, and its credit
// and verdict where live. The connections' arithmetic (up to four BSDF or
// phase evaluations, four ConvertPdfs and a MIS weight an item, with
// IEEE divisions and square roots of about 10 instructions each:
// chip_smoke.py's CONNECT_OPS) takes about as long at the issue peak as
// the bytes do, and each item is a long chain of dependent loads,
// divisions and square roots. bdpt_connect's design
// therefore loads each vertex and looks up its material once, into shared
// memory, reuses a segment's length and cosines across the ConvertPdfs
// that share them, keeps no table indexed at run time (no local memory)
// and, with 91 registers and 41 KB of shared memory a block, keeps 20
// warps an SM in flight (12 for the earlier design of a thread a lane,
// at 153 registers and a 768-byte frame of MIS tables); 2.74 against 4.95
// ms on cornell_port's 1M lanes (H100 80GB HBM3, 700 W; PERF.md). Every
// intermediate stays out of device memory, the scene
// tables are read through __ldg, and the traced rays are counted with
// one atomic a block.
//
// Variants (template flags): bdpt_step kTex (textures), kAll (spheres or
// lines) and kHet (heterogeneous media: the sample walk's result);
// bdpt_connect kTex; bdpt_finish the lanes a thread (4, or 1 where the
// queue does not allow vectors) and kOcc (the any-hit verdicts, else
// Tr). bdpt_start has one.
#include "media.cuh"
#include "shade.cuh"

// The entry points' arguments (integrators/bdpt_shade.py's ctypes
// structures mirror them field for field).
struct BdptStartArgs {
  const int64_t* lanes;   // [N] lane ids
  const int32_t* px;      // [N] pixel x, y
  const int32_t* py;
  // the scene's tables and the camera (bdpt_shade.py::camera_record)
  const float* cam;
  const float* lights;
  const float* cdf;
  const int32_t* l_medium;   // each light's medium (NULL: no media)
  const float* med_table;
  // the rows' state and the vertex tables [2N, K], written whole
  float* ro;
  float* rd;
  float* beta;
  float* forward;
  int32_t* med;
  uint8_t* alive;
  float* tmax;
  int32_t* med_sample;  // NULL: no heterogeneous medium
  float* pos;
  float* nor;
  float* uv;
  float* dpdu;
  float* vbeta;
  float* fwd;
  float* rev;
  uint8_t* delta;
  int32_t* mat_idx;
  int32_t* light_idx;
  int32_t* medium;
  int32_t* count;
  int n, n_lights, n_rows, environment, camera_medium;
  uint32_t seed, iteration;
  float eps;
};

struct BdptStepArgs {
  // the step's closest hit of the 2N rows and their sample walk (found_t
  // NULL: no heterogeneous medium); the N lane ids
  const float* t;
  const int32_t* prim;
  const float* found_t;
  const int64_t* lanes;
  // the rows' state, read and written in place
  float* ro;
  float* rd;
  float* beta;
  float* forward;
  int32_t* med;
  uint8_t* alive;
  float* tmax;          // the next closest hit's
  int32_t* med_sample;  // the next sample walk's medium (kHet)
  // the vertex tables [2N, K], written in place
  float* pos;
  float* nor;
  float* uv;
  float* dpdu;
  float* vbeta;
  float* fwd;
  float* rev;
  uint8_t* delta;
  int32_t* mat_idx;
  int32_t* light_idx;
  int32_t* medium;
  int32_t* count;
  // the scene's tables
  const float* prim_attrs;
  const float* mats;
  const float* med_table;
  const uint8_t* tex;  // NULL: no textures
  const int32_t* tex_offset;
  const int32_t* tex_w;
  const int32_t* tex_h;
  unsigned long long* rays;  // += the rows alive at the step's start
  int n, k, step, all_kinds, aniso, has_media;
  uint32_t seed, iteration;
};

struct BdptConnectArgs {
  const int64_t* lanes;
  // the vertex tables [2N, K]
  const float* pos;
  const float* nor;
  const float* uv;
  const float* dpdu;
  const float* vbeta;
  const float* fwd;
  const float* rev;
  const uint8_t* delta;
  const int32_t* mat_idx;
  const int32_t* light_idx;
  const int32_t* medium;
  const int32_t* count;
  // the scene's tables and the camera (bdpt_shade.py::camera_record)
  const float* mats;
  const float* lights;
  const float* cdf;
  const float* med_table;
  const float* cam;
  const uint8_t* tex;  // NULL: no textures
  const int32_t* tex_offset;
  const int32_t* tex_w;
  const int32_t* tex_h;
  float* li_out;  // [N, 3] the t0 strategies
  // the queue, slot j of lane i at [j, i]
  uint8_t* live;
  float* q_o;
  float* q_d;
  float* q_tmax;
  float* q_L;
  int32_t* q_med;  // NULL: no media
  int32_t* q_pix;  // [G, N]
  unsigned long long* rays;  // += the live slots (without media)
  int n, k, n_lights, n_rows, width, has_media;
  uint32_t seed, iteration;
  float eps;
};

struct BdptFinishArgs {
  const float* li;
  const uint8_t* live;
  const float* q_L;
  const int32_t* q_pix;
  const uint8_t* occluded;  // the any-hit verdicts [S * N], or NULL
  const float* tr;          // and then the walk's transmittance [S * N, 3]
  float* li_out;
  float* film;
  int n, g;
};

namespace {

constexpr int kThreads = 128;
constexpr int kEmitDims = 8, kStepDims = 8;   // bdpt_shade.py EMIT/STEP_DIMS
constexpr uint32_t kLightTag = 2, kConnectTag = 3;   // core/rng.py
constexpr float kConnectRR = 1.f;   // bdpt_shade.py CONNECT_RR

__device__ __forceinline__ const float* med_row(const float* table, int k) {
  return table + (size_t)(k < 0 ? 0 : k) * media::kMedCols;
}

__device__ __forceinline__ bool heterogeneous(const float* table, int k) {
  return (int)__ldg(med_row(table, k)) == media::kHeterogeneous;
}

// i clamped into a K-column table
__device__ __forceinline__ int tclamp_i(int i, int k) {
  return i < 0 ? 0 : (i > k - 1 ? k - 1 : i);
}

// exp(sigma_t * -len) per channel (shade/media.py: Beer-Lambert)
__device__ __forceinline__ V3 beer(V3 sigma_t, float len) {
  return mk(expf(sigma_t.x * -len), expf(sigma_t.y * -len),
            expf(sigma_t.z * -len));
}

// ---------------------------------------------------------------------------
// bdpt_start
// ---------------------------------------------------------------------------
// Row r's vertex 0 and first ray: the camera's (rows below N: the pixel
// jitter at tag 0's sites 0-1, the primary ray, its pdfW) or the light's
// (the light pick, a point and a cosine direction at tag
// BDPT_LIGHT_TAG's sites 0-4).
__device__ __forceinline__ void start_row(const BdptStartArgs& p, int r) {
  const bool light = r >= p.n;
  const int i = light ? r - p.n : r;
  const uint32_t lane = (uint32_t)p.lanes[i];
  const Cam cam = load_camera(p.cam);
  V3 ro, rd, beta, vpos, vnor, vbeta;
  float forward, vfwd;
  int med, vlight = -1;
  if (!light) {
    const uint4 w = philox(lane, 0u, 0u, 0u, p.seed, p.iteration);
    const float x = (float)p.px[i] + (bits_to_uniform(w.x) - 0.5f);
    const float y = (float)p.py[i] + (bits_to_uniform(w.y) - 0.5f);
    primary_ray(cam, x, y, p.environment != 0, &ro, &rd);
    forward = pdf_camera_w(cam, rd);
    beta = vbeta = mk(1.f, 1.f, 1.f);
    vpos = cam.pos;
    vnor = neg(cam.w);
    vfwd = 1.f;
    med = p.camera_medium;
  } else {
    const uint4 wa = philox(lane, 0u, kLightTag, 0u, p.seed, p.iteration);
    const uint4 wb = philox(lane, 1u, kLightTag, 0u, p.seed, p.iteration);
    const int idx = pick_light(p.cdf, p.n_rows, bits_to_uniform(wa.x));
    const float choice = light_choice_pdf(p.cdf, idx, p.n_rows);
    const int last = p.n_lights - 1 > 0 ? p.n_lights - 1 : 0;
    vlight = idx < last ? idx : last;
    const float* la = light_row(p.lights, vlight, p.n_rows);
    float pdf_a;
    area_light_emission(la, bits_to_uniform(wa.y), bits_to_uniform(wa.z),
                        bits_to_uniform(wa.w), bits_to_uniform(wb.x), &ro, &rd,
                        &vnor, &pdf_a, &forward);
    vbeta = ldg3(la + 18);
    const float denom = tmax(pdf_a * forward * choice, 1e-30f);
    beta = scl(vbeta, fabsf(dot(rd, vnor)) / denom);
    vpos = ro;
    vfwd = pdf_a * choice;
    med = p.l_medium ? __ldg(p.l_medium + vlight) : -1;
  }
  // vertex 0, slot r, every field (the slots above it stay unwritten:
  // the steps write vertex `count` whole, and no kernel reads a slot at
  // or above a row's count)
  const size_t at = r;
  store3(p.pos + 3 * at, vpos);
  store3(p.nor + 3 * at, vnor);
  p.uv[2 * at] = 0.f;
  p.uv[2 * at + 1] = 0.f;
  store3(p.dpdu + 3 * at, mk(0.f, 0.f, 0.f));
  store3(p.vbeta + 3 * at, vbeta);
  p.fwd[at] = vfwd;
  p.rev[at] = 0.f;
  p.delta[at] = 0;
  p.mat_idx[at] = -1;
  p.light_idx[at] = vlight;
  p.medium[at] = med;
  p.count[r] = 1;
  store3(p.ro + 3 * r, ro);
  store3(p.rd + 3 * r, rd);
  store3(p.beta + 3 * r, beta);
  p.forward[r] = forward;
  p.med[r] = med;
  p.alive[r] = 1;
  p.tmax[r] = INFINITY;
  if (p.med_sample) {
    p.med_sample[r] =
        med >= 0 && heterogeneous(p.med_table, med) ? med : -1;
  }
}

__global__ void __launch_bounds__(kThreads) bdpt_start_kernel(
    BdptStartArgs p) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < 2 * p.n) start_row(p, r);
}

// ---------------------------------------------------------------------------
// bdpt_step
// ---------------------------------------------------------------------------
template <bool kTex, bool kAll, bool kHet>
__device__ __forceinline__ void step_row(const BdptStepArgs& p, int r,
                                         bool* traced) {
  *traced = p.alive[r] != 0;
  if (!*traced) return;   // a row that does not step keeps its state
  const int k = p.k;
  const bool light = r >= p.n;
  bool alive = true;
  V3 ro = load3(p.ro + 3 * r), rd = load3(p.rd + 3 * r);
  V3 beta = load3(p.beta + 3 * r);
  float forward = p.forward[r];
  int med = p.med[r];
  int cnt = p.count[r];
  const int prim = p.prim[r];
  if (prim >= 0) {
    const size_t rows = 2 * (size_t)p.n;
    const float t = p.t[r];
    const Hit h = hit_attributes<true, kAll>(p.prim_attrs, prim, ro, rd, t);
    // the step's sites: block 2 + 2 s words 0-2 the BSDF, 3 the roulette;
    // block 3 + 2 s words 0-1 the phase sample, 2 the distance sample
    const uint32_t lane = (uint32_t)p.lanes[light ? r - p.n : r];
    const uint32_t tag = light ? kLightTag : 0u;
    const uint32_t blk = (uint32_t)((kEmitDims + p.step * kStepDims) >> 2);
    const uint4 wa = philox(lane, blk, tag, 0u, p.seed, p.iteration);
    // vertex m of row r is slot m * 2N + r (the tables are vertex-major)
    const size_t prev = (size_t)tclamp_i(cnt - 1, k) * rows + r;
    const V3 prev_pos = load3(p.pos + 3 * prev);
    const V3 prev_nor = load3(p.nor + 3 * prev);
    const V3 zero = mk(0.f, 0.f, 0.f);
    const size_t at = (size_t)tclamp_i(cnt, k) * rows + r;   // the new one

    // ---- a medium scattering vertex --------------------------------
    bool in_scatter = false;
    if (p.has_media) {
      const uint4 wb = philox(lane, blk + 1u, tag, 0u, p.seed, p.iteration);
      bool sampled = false;
      float t_med = t;
      if (med >= 0) {
        const media::Optics o = media::load_optics(med_row(p.med_table, med));
        V3 weight;
        if (kHet && heterogeneous(p.med_table, med)) {
          const float ft = p.found_t[r];
          sampled = isfinite(ft);
          weight = sampled ? mk(o.sigma_s.x / tmax(o.sigma_t.x, 1e-30f),
                                o.sigma_s.y / tmax(o.sigma_t.y, 1e-30f),
                                o.sigma_s.z / tmax(o.sigma_t.z, 1e-30f))
                           : mk(1.f, 1.f, 1.f);
          t_med = sampled ? ft : t;
        } else {
          const float u0 = bits_to_uniform(wb.z);
          const float dist = -logf(tmax(1.f - u0, 1e-30f)) / o.sigma;
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
      in_scatter = alive && sampled;
      if (in_scatter) {
        const V3 sample_pos = add(ro, scl(rd, t_med));
        const float g = __ldg(med_row(p.med_table, med) + 1);
        const float pu1 = bits_to_uniform(wb.x), pu2 = bits_to_uniform(wb.y);
        const V3 wi = neg(rd);
        const V3 new_dir = media::sample_phase(g, wi, pu1, pu2);
        const float ph = media::hg_phase(media::hg_costheta(g, pu1), g);
        store3(p.pos + 3 * at, sample_pos);
        store3(p.nor + 3 * at, zero);
        p.uv[2 * at] = 0.f;
        p.uv[2 * at + 1] = 0.f;
        store3(p.dpdu + 3 * at, zero);
        store3(p.vbeta + 3 * at, beta);
        p.fwd[at] = convert_pdf(forward, prev_pos, sample_pos, zero);
        p.rev[at] = 0.f;
        p.delta[at] = 0;
        p.mat_idx[at] = -1;
        p.light_idx[at] = -1;
        p.medium[at] = med;
        p.rev[prev] = convert_pdf(ph, sample_pos, prev_pos, prev_nor);
        forward = ph;
        ro = sample_pos;
        rd = new_dir;
      }
    }

    // ---- the interface crossing: no bounce --------------------------
    const float* pa = p.prim_attrs + (size_t)prim * kPrimAttrs;
    bool on_surface = alive && !in_scatter;
    if (on_surface && h.mat == -1) {
      med = (int)__ldg(pa + (dot(rd, h.nor) > 0.f ? 34 : 33));
      ro = h.pos;
      on_surface = false;
    }

    // ---- a surface vertex and its BSDF sample -----------------------
    bool surf_go = false;
    if (on_surface) {
      const Mat m = hit_material<kTex>(p.mats, p.tex, p.tex_offset, p.tex_w,
                                       p.tex_h, h);
      const bool delta = is_delta(m.type);
      store3(p.pos + 3 * at, h.pos);
      store3(p.nor + 3 * at, h.nor);
      p.uv[2 * at] = h.u;
      p.uv[2 * at + 1] = h.v;
      store3(p.dpdu + 3 * at, h.dpdu);
      store3(p.vbeta + 3 * at, beta);
      p.fwd[at] = convert_pdf(forward, prev_pos, h.pos, h.nor);
      p.rev[at] = 0.f;
      p.delta[at] = delta ? 1 : 0;
      p.mat_idx[at] = h.mat;
      p.light_idx[at] = h.light;
      p.medium[at] = med;
      const V3 wi = neg(rd);
      const float u1 = bits_to_uniform(wa.x), u2 = bits_to_uniform(wa.y);
      const float u3 = bits_to_uniform(wa.z);
      V3 wo, fr;
      float pdf;
      if (light) {
        sample_bsdf_mode<true>(m, wi, h.nor, h.dpdu, u1, u2, u3, p.aniso != 0,
                               &wo, &fr, &pdf);
      } else {
        sample_bsdf_mode<false>(m, wi, h.nor, h.dpdu, u1, u2, u3,
                                p.aniso != 0, &wo, &fr, &pdf);
      }
      if (is_black(fr) || pdf <= 0.f) {
        alive = false;
      } else {
        surf_go = true;
        const float cos_o = fabsf(dot(wo, h.nor));
        const float pm = tmax(pdf, 1e-30f);
        beta = mk(beta.x * fr.x * cos_o / pm, beta.y * fr.y * cos_o / pm,
                  beta.z * fr.z * cos_o / pm);
        forward = delta ? 0.f : pdf;
        // the previous vertex's reverse pdf
        V3 fr_r;
        float pdf_r;
        eval_bsdf(m, wo, wi, h.nor, h.dpdu, &fr_r, &pdf_r);
        p.rev[prev] = convert_pdf(pdf_r, h.pos, prev_pos, prev_nor);
        // the next medium by crossing side; reflections keep the current
        const float cos_wo = dot(wo, h.nor);
        if (!(dot(wi, h.nor) * cos_wo > 0.f))
          med = (int)__ldg(pa + (cos_wo > 0.f ? 34 : 33));
        ro = h.pos;
        rd = wo;
      }
      ++cnt;
    }
    if (in_scatter) ++cnt;
    // Russian roulette; the bounces so far are the vertices after vertex 0
    if (alive && (in_scatter || surf_go) && cnt - 1 > 4) {
      const float rr_pdf = tclamp(1.f - luminance(beta), 0.f, 1.f);
      if (bits_to_uniform(wa.w) < rr_pdf) {
        alive = false;
      } else {
        beta = scl(beta, 1.f / tmax(1.f - rr_pdf, 1e-30f));
      }
    }
  } else {
    alive = false;   // the ray left the scene
  }
  store3(p.ro + 3 * r, ro);
  store3(p.rd + 3 * r, rd);
  store3(p.beta + 3 * r, beta);
  p.forward[r] = forward;
  p.med[r] = med;
  p.count[r] = cnt;
  alive = alive && cnt < k;   // room for the next step's vertex
  p.alive[r] = alive ? 1 : 0;
  p.tmax[r] = alive ? INFINITY : 0.f;
  if (kHet) {
    p.med_sample[r] =
        alive && med >= 0 && heterogeneous(p.med_table, med) ? med : -1;
  }
}

template <bool kTex, bool kAll, bool kHet>
__global__ void __launch_bounds__(kThreads) bdpt_step_kernel(BdptStepArgs p) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool traced = false;
  if (r < 2 * p.n) step_row<kTex, kAll, kHet>(p, r, &traced);
  const int n_traced = __syncthreads_count(traced);
  if (threadIdx.x == 0 && n_traced)
    atomicAdd(p.rays, (unsigned long long)n_traced);
}

// ---------------------------------------------------------------------------
// bdpt_connect
// ---------------------------------------------------------------------------
// G = K - 1 threads of one warp run one lane, thread g its column g of
// every round: 32 / G lanes a warp (6 lanes on 30 threads at K = 6; one
// lane from K = 18). Thread g first stages, in shared memory, the lane's
// light vertex g + 1 (s1's and the general rounds' l1 in column g) and
// camera vertex g + 1 (t0's and t1's c1 in column g, and every column's
// c1 in the general round s = g + 2), each looked up once: its record,
// material, direction toward the vertex before and that segment's
// squared length and cosine there (which ConvertPdf toward the vertex
// before reuses), and its subpath's MIS columns (fwd and ok here and one
// vertex back, A two back: a walk of the suffix table in registers, no
// table indexed at run time, so no local memory at any K). Each round
// then reads its vertices from shared memory, the fields its BSDF takes.
// A round's column sums (t0's radiance, the roulette's mean) read each
// column's term from its thread by shuffles, in column order; the
// roulette's verdict stays in the thread, which writes its slot's flag
// and tmax once, and its ray, credit, medium and pixel where kept.
// Blocks of 4 warps take at most 44 KB of shared memory (2 G records a
// lane, 32 / G lanes a warp); 5 fit an SM at K = 6 (2, 3 and 8 warps a
// block were slower: PERF.md).
constexpr int kConnectWarps = 4;
constexpr int kConnectThreads = 32 * kConnectWarps;
constexpr unsigned kWarp = 0xffffffffu;

__device__ __forceinline__ float remap(float x) { return x == 0.f ? 1.f : x; }

// lanes a warp of bdpt_connect_kernel runs at G columns (G <= 31)
__host__ __device__ __forceinline__ int connect_lanes(int g_n) {
  return 32 / g_n;
}

// A vertex of a lane's subpath as a round reads it, staged in shared
// memory: the table record, its material, `in` toward the vertex before
// (normalize(prev - pos)) with d2 = max(|prev - pos|^2, 1e-30) and cos2 =
// |dot(in, nor_prev)| (nz2: nor_prev nonzero), and the subpath's MIS
// columns at this vertex m: f1 / ok1 fwd and ok at m, f2 / ok2 at m - 1,
// a3 = A[m - 2] (bdpt_shade.py::_mis_tables: r = remap(rev) /
// remap(fwd), ok = not delta here and at the vertex before (0 at the
// camera's vertex 0), A[m] = r_m (ok_m + A[m - 1])).
struct VtxRec {
  V3 pos, nor, dpdu, beta;
  int mat, med, delta;
  Mat m;
  V3 in;
  float d2, cos2;
  int nz2;
  float f1, f2, ok1, ok2, a3;
};

// a warp's records: [lane][2][G] (camera, light), 4-byte words
__host__ __device__ __forceinline__ int connect_warp_words(int g_n) {
  return connect_lanes(g_n) * 2 * g_n * (int)(sizeof(VtxRec) / 4);
}

// ConvertPdf (bdpt_shade.py::_convert_pdf) of a solid-angle pdf toward a
// vertex `to` along a segment whose clamped squared length d2 and |cos|
// at `to` (c; nz: to's normal nonzero) are known: its operations in its
// order
__device__ __forceinline__ float convert_seg(float pdf, float d2, float c,
                                             bool nz) {
  const float ret = pdf / d2;
  return nz ? ret * c : ret;
}

// Vertex m of a subpath (table row `row`) into *r, with vertex m - 1 and
// the subpath's MIS columns walked from column 0 (m >= 1, m below the
// count)
template <bool kTex>
__device__ __forceinline__ void stage_vertex(const BdptConnectArgs& p,
                                             size_t row, int m, bool camera,
                                             VtxRec* r) {
  const size_t rows = 2 * (size_t)p.n;
  const size_t at = (size_t)m * rows + row, prev = at - rows;
  V3 pos = ldg3(p.pos + 3 * at);
  r->pos = pos;
  r->nor = ldg3(p.nor + 3 * at);
  r->dpdu = ldg3(p.dpdu + 3 * at);
  r->beta = ldg3(p.vbeta + 3 * at);
  Hit h;
  h.mat = __ldg(p.mat_idx + at);
  h.u = __ldg(p.uv + 2 * at);
  h.v = __ldg(p.uv + 2 * at + 1);
  r->mat = h.mat;
  r->med = __ldg(p.medium + at);
  r->delta = __ldg(p.delta + at) != 0;
  r->m = hit_material<kTex>(p.mats, p.tex, p.tex_offset, p.tex_w, p.tex_h, h);
  // normalize(prev - pos), its clamped squared length kept
  const V3 v = sub(ldg3(p.pos + 3 * prev), pos);
  const float d2 = tmax(dot(v, v), 1e-30f);
  const V3 in = divs(v, sqrtf(d2));
  const V3 nor2 = ldg3(p.nor + 3 * prev);
  r->in = in;
  r->d2 = d2;
  r->cos2 = fabsf(dot(in, nor2));
  r->nz2 = dot(nor2, nor2) > 0.f;
  // the MIS suffix table's walk over columns 0 .. m
  float f1 = 0.f, f2 = 0.f, ok1 = 0.f, ok2 = 0.f, a2 = 0.f, a3 = 0.f;
  float acc = 0.f;
  bool dprev = false;   // at column 0 the vertex before is the vertex
  for (int c = 0; c <= m; ++c) {
    const size_t ac = (size_t)c * rows + row;
    const bool dm = __ldg(p.delta + ac) != 0;
    const float f = __ldg(p.fwd + ac);
    const float rr = remap(__ldg(p.rev + ac)) / remap(f);
    const float okm = (camera && c == 0) || dm || dprev ? 0.f : 1.f;
    a3 = a2;
    a2 = acc;
    acc = rr * (okm + acc);
    f2 = f1;
    ok2 = ok1;
    f1 = f;
    ok1 = okm;
    dprev = dm;
  }
  r->f1 = f1;
  r->f2 = f2;
  r->ok1 = ok1;
  r->ok2 = ok2;
  r->a3 = a3;
}

// bdpt_shade.py::_mis_weight for one item of strategy (s, t) from the
// camera side's MIS columns at vertex s - 1 (cam) and the light side's at
// t - 1 (lit; in the t1 round lit_ok0, its ok[0]): c1 / c2 replace the
// camera side's rev at s - 1 / s - 2, l1 / l2 the light side's at t - 1 /
// t - 2, l0_fwd its fwd[0] in the t1 round (`t1`)
__device__ __forceinline__ float mis_weight(int s, int t, const VtxRec* cam,
                                            const VtxRec* lit, float lit_ok0,
                                            float c1_rev, float c2_rev,
                                            float l1_rev, float l2_rev,
                                            float l0_fwd, bool t1) {
  // the camera side: terms exist for i in [1, s - 1]
  const float r_e = s - 1 >= 1 ? remap(c1_rev) / remap(cam->f1) : 0.f;
  const float r_e1 = s - 2 >= 1 ? remap(c2_rev) / remap(cam->f2) : 0.f;
  const float pc1 = s - 1 >= 1 ? cam->ok1 : 0.f;
  const float pc2 = s - 2 >= 1 ? cam->ok2 : 0.f;
  const float pca = s - 3 >= 1 ? cam->a3 : 0.f;
  float sum_w = r_e * (pc1 + r_e1 * (pc2 + pca));
  // the light side: terms exist for i in [0, t - 1]
  const float r_le =
      t - 1 >= 0 ? remap(l1_rev) / remap(t1 ? l0_fwd : lit->f1) : 0.f;
  const float r_le1 = t - 2 >= 0 ? remap(l2_rev) / remap(lit->f2) : 0.f;
  const float pl1 = t - 1 >= 0 ? (t1 ? lit_ok0 : lit->ok1) : 0.f;
  const float pl2 = t - 2 >= 0 ? lit->ok2 : 0.f;
  const float pla = t - 3 >= 0 ? lit->a3 : 0.f;
  sum_w = sum_w + r_le * (pl1 + r_le1 * (pl2 + pla));
  const float w = 1.f / (1.f + sum_w);
  return s + t == 2 ? 1.f : w;
}

// fr and the forward pdf at a staged vertex: its BSDF, or the phase
// function at a medium vertex (bdpt_shade.py::_Round.surf_or_phase)
__device__ __forceinline__ void surf_or_phase(const BdptConnectArgs& p,
                                              const VtxRec* x, V3 w_in,
                                              V3 w_out, V3* fr, float* pdf) {
  if (p.has_media && x->mat == -1) {
    const float ph = media::hg_phase(dot(w_in, w_out),
                                     __ldg(med_row(p.med_table, x->med) + 1));
    *fr = mk(ph, ph, ph);
    *pdf = ph;
  } else {
    eval_bsdf(x->m, w_in, w_out, x->nor, x->dpdu, fr, pdf);
  }
}

// x of the warp's threads base .. base + G - 1 (a lane's columns) summed
// in column order; every thread of the warp calls it
__device__ __forceinline__ float cols_sum(float x, int base, int g_n) {
  float sum = 0.f;
  for (int c = 0; c < g_n; ++c) {
    const float y = __shfl_sync(kWarp, x, base + c);
    sum = c == 0 ? y : sum + y;
  }
  return sum;
}

// The roulette of a shadow round (bdpt_shade.py::_Round.run's tail) for
// column g's connection (ok, its credit *L, MIS weighted): the lane's mean
// is the sum of its ok columns' luminances in column order over their
// number; a connection below it is kept with probability q = lum / mean,
// weighted 1 / q. Its draw: word 3 of `w` in t1 (the light sample's
// block), else word 0 of the round's block p_round. Every thread of the
// warp calls it. Returns whether the connection is kept.
__device__ __forceinline__ bool roulette(const BdptConnectArgs& p,
                                         uint32_t item, int p_round, int base,
                                         int g_n, bool ok, V3* L, bool t1,
                                         uint4 w) {
  const float lum = ok ? luminance(*L) : 0.f;
  const float msum = cols_sum(lum, base, g_n);
  const uint32_t oks = __ballot_sync(kWarp, ok) >> base;
  if (!ok) return false;
  const int n_ok = __popc(oks & ((2u << (g_n - 1)) - 1u));
  const float mean = msum / (float)(n_ok > 1 ? n_ok : 1);
  const float q = tclamp(lum / tmax(kConnectRR * mean, 1e-30f), 0.f, 1.f);
  if (!t1)
    w = philox(item, (uint32_t)p_round, kConnectTag, 0u, p.seed, p.iteration);
  if (!(bits_to_uniform(t1 ? w.w : w.x) < q)) return false;
  *L = divs(*L, tmax(q, 1e-30f));
  return true;
}

// A slot's flag and tmax (0: empty), and where kept its shadow ray, credit
// and medium. Returns 1 where kept.
__device__ __forceinline__ int put_slot(const BdptConnectArgs& p, size_t slot,
                                        bool keep, V3 L, V3 o, V3 d, float st,
                                        int med) {
  p.live[slot] = keep ? 1 : 0;
  p.q_tmax[slot] = keep ? st : 0.f;
  if (keep) {
    store3(p.q_L + 3 * slot, L);
    store3(p.q_o + 3 * slot, o);
    store3(p.q_d + 3 * slot, d);
    if (p.q_med) p.q_med[slot] = med;
  }
  return keep ? 1 : 0;
}

// Column g of lane i (`on`: a lane's column; the warp's other threads
// run the rounds' shuffles only) in every round: s1, t0, t1, then the
// general rounds s = 2 .. K, each with its overrides, MIS weight and (but
// t0) roulette. base: the warp thread of the lane's column 0; cam / lit:
// the lane's staged camera and light vertices 1 .. G. Returns the slots
// it queued.
template <bool kTex>
__device__ __forceinline__ int connect_column(const BdptConnectArgs& p, int i,
                                              int g, int base, bool on,
                                              VtxRec* cam, VtxRec* lit) {
  const int k = p.k, g_n = k - 1, n = p.n;
  const size_t rows = 2 * (size_t)n;
  const size_t crow = on ? (size_t)i : 0, lrow = crow + n;
  const int cc = on ? __ldg(p.count + i) : 0;
  const int lc = on ? __ldg(p.count + n + i) : 0;
  const V3 zero = mk(0.f, 0.f, 0.f);
  const uint4 no_draw = make_uint4(0u, 0u, 0u, 0u);
  const float nanf_ = __int_as_float(0x7fc00000);
  const uint32_t item =
      on ? (uint32_t)((uint64_t)__ldg((const long long*)p.lanes + i) * 32u) +
               (uint32_t)g
         : 0u;
  const int t = g + 2;   // s1 and the general rounds: light vertices t - 1, t - 2
  const int s = g + 2;   // t0 and t1: camera vertices s - 1, s - 2
  const bool lit_on = t <= lc, cam_on = s <= cc;
  // this column's light and camera vertex g + 1, staged for the lane
  if (lit_on) stage_vertex<kTex>(p, lrow, g + 1, false, lit + g);
  if (cam_on) stage_vertex<kTex>(p, crow, g + 1, true, cam + g);
  __syncwarp();
  const VtxRec* l1 = lit + g;
  const VtxRec* c1 = cam + g;
  int live = 0;

  // ---- s1: light vertex t - 1 to the camera ---------------------------
  {
    V3 L = zero, sd = zero, o = zero;
    float st = 0.f;
    int pix = 0, med = 0;
    bool okg = false;
    if (lit_on) {
      const Cam camera = load_camera(p.cam);
      const bool l1_med = l1->mat == -1;
      o = l1->pos;
      med = l1->med;
      float we, cpdf;
      int rx, ry;
      sample_camera(camera, o, p.eps, &sd, &st, &we, &cpdf, &rx, &ry);
      V3 fr;
      float next_pdf, rev_pdf;
      surf_or_phase(p, l1, l1->in, sd, &fr, &next_pdf);
      const float cos2 = l1_med ? 1.f : fabsf(dot(sd, l1->nor));
      L = scl(mul(l1->beta, fr), we * cos2 / tmax(cpdf, 1e-30f));
      const float cam_pdfw = pdf_camera_w(camera, neg(sd));
      V3 unused;
      surf_or_phase(p, l1, sd, l1->in, &unused, &rev_pdf);
      const bool case_valid = cpdf != 0.f && !(!l1_med && l1->delta) &&
                              !is_black(L);
      const float l1_rev = convert_pdf(cam_pdfw, camera.pos, o, l1->nor);
      const float l2_rev = convert_seg(rev_pdf, l1->d2, l1->cos2, l1->nz2);
      L = scl(L, mis_weight(1, t, nullptr, l1, 0.f, nanf_, nanf_, l1_rev,
                            l2_rev, nanf_, false));
      okg = case_valid && finite3(L) && !is_black(L);
      pix = rx + ry * p.width;
    }
    const bool keep = roulette(p, item, 1, base, g_n, okg, &L, false,
                               no_draw);
    if (on) {
      const size_t slot = (size_t)g * n + i;
      live += put_slot(p, slot, keep, L, o, sd, st, med);
      if (keep) p.q_pix[slot] = pix;
    }
  }

  // ---- t0: camera vertex s - 1 on a light ------------------------------
  {
    V3 L = zero;
    if (cam_on) {
      const int lidx = __ldg(p.light_idx + (size_t)(g + 1) * rows + crow);
      const float* la = light_row(p.lights, lidx, p.n_rows);
      L = mul(c1->beta, area_light_le(la, c1->nor, c1->in));
      const float choice0 =
          light_choice_pdf(p.cdf, lidx < 0 ? 0 : lidx, p.n_rows);
      float pdf_a0, pdf_w0;
      area_light_pdf(la, c1->in, c1->nor, &pdf_a0, &pdf_w0);
      const bool case_valid = lidx >= 0 && !is_black(L);
      const float c1_rev = pdf_a0 * choice0;
      const float c2_rev = convert_seg(pdf_w0, c1->d2, c1->cos2, c1->nz2);
      L = scl(L, mis_weight(s, 0, c1, nullptr, 0.f, c1_rev, c2_rev, nanf_,
                            nanf_, nanf_, false));
      if (!(case_valid && finite3(L) && !is_black(L))) L = zero;
    }
    // the columns in column order, added to a zero li
    const V3 acc = mk(cols_sum(L.x, base, g_n), cols_sum(L.y, base, g_n),
                      cols_sum(L.z, base, g_n));
    if (on && g == 0) store3(p.li_out + 3 * i, add(zero, acc));
  }

  // ---- t1: camera vertex s - 1 to a light sample -----------------------
  {
    V3 L = zero, sd = zero, o = zero;
    float st = 0.f;
    int med = 0;
    bool okg = false;
    uint4 w = no_draw;
    if (cam_on && lc >= 1) {
      const bool c1_med = c1->mat == -1;
      o = c1->pos;
      med = c1->med;
      w = philox(item, 3u, kConnectTag, 0u, p.seed, p.iteration);
      const int idx = pick_light(p.cdf, p.n_rows, bits_to_uniform(w.x));
      const float choice = light_choice_pdf(p.cdf, idx, p.n_rows);
      const int last = p.n_lights - 1 > 0 ? p.n_lights - 1 : 0;
      const float* la = light_row(p.lights, idx < last ? idx : last,
                                  p.n_rows);
      V3 rad, lnor;
      float lpdf;
      sample_area_light(la, o, bits_to_uniform(w.y), bits_to_uniform(w.z),
                        p.eps, &rad, &sd, &st, &lnor, &lpdf);
      const V3 light_pos = add(o, scl(sd, st + p.eps));
      V3 fr;
      float next_pdf, rev_pdf;
      surf_or_phase(p, c1, c1->in, sd, &fr, &next_pdf);
      const float g1 = c1_med ? 1.f : fabsf(dot(c1->nor, sd));
      L = scl(mul(mul(c1->beta, fr), rad), g1 / tmax(lpdf * choice, 1e-30f));
      float pdf_a1, pdf_w1;
      area_light_pdf(la, sd, lnor, &pdf_a1, &pdf_w1);
      V3 unused;
      surf_or_phase(p, c1, sd, c1->in, &unused, &rev_pdf);
      const bool case_valid = !is_black(rad) && lpdf > 0.f &&
                              !(!c1_med && c1->delta) && !is_black(L);
      const float l0_fwd = pdf_a1 * choice;
      const float l1_rev = convert_pdf(next_pdf, o, light_pos, lnor);
      const float c1_rev = convert_pdf(pdf_w1, light_pos, o, c1->nor);
      const float c2_rev = convert_seg(rev_pdf, c1->d2, c1->cos2, c1->nz2);
      // the light side's ok[0]: not delta at its vertex 0
      const float ok0 = __ldg(p.delta + lrow) != 0 ? 0.f : 1.f;
      L = scl(L, mis_weight(s, 1, c1, nullptr, ok0, c1_rev, c2_rev, l1_rev,
                            nanf_, l0_fwd, true));
      okg = case_valid && finite3(L) && !is_black(L);
    }
    const bool keep = roulette(p, item, 3, base, g_n, okg, &L, true, w);
    if (on) {
      live += put_slot(p, (size_t)(g_n + g) * n + i, keep, L, o, sd, st,
                       med);
    }
  }

  // ---- the general rounds: camera vertex sg - 1, light vertex t - 1 ----
  for (int sg = 2; sg <= k; ++sg) {
    V3 L = zero, o = zero, d = zero;
    float st = 0.f;
    int med = 0;
    bool okg = false;
    if (sg <= cc && lit_on) {
      const VtxRec* gc1 = cam + (sg - 2);
      const bool c1_med = gc1->mat == -1, l1_med = l1->mat == -1;
      o = gc1->pos;
      med = gc1->med;
      const V3 lpos = l1->pos, lnor = l1->nor, cnor = gc1->nor;
      const V3 conn = sub(o, lpos);
      const float d2g = tmax(dot(conn, conn), 1e-30f);
      const V3 l1_to_c1 = divs(conn, sqrtf(d2g));
      const V3 c1_to_l1 = neg(l1_to_c1);
      V3 fr_c1, fr_l1, unused;
      float pdf_to_l1, pdf_to_c1, pdf_to_l2, pdf_to_c2;
      surf_or_phase(p, gc1, gc1->in, c1_to_l1, &fr_c1, &pdf_to_l1);
      surf_or_phase(p, l1, l1->in, l1_to_c1, &fr_l1, &pdf_to_c1);
      // |cos| at each end; ConvertPdf across the connection reuses them
      const float abs_l = fabsf(dot(l1_to_c1, lnor));
      const float abs_c = fabsf(dot(c1_to_l1, cnor));
      const float cos_l = l1_med ? 1.f : abs_l;
      const float cos_c = c1_med ? 1.f : abs_c;
      const float g3 = cos_l * cos_c / d2g;
      L = scl(mul(mul(mul(gc1->beta, fr_c1), fr_l1), l1->beta), g3);
      surf_or_phase(p, l1, l1_to_c1, l1->in, &unused, &pdf_to_l2);
      surf_or_phase(p, gc1, c1_to_l1, gc1->in, &unused, &pdf_to_c2);
      const bool case_valid = !(!c1_med && gc1->delta) &&
                              !(!l1_med && l1->delta) && !is_black(L);
      const float c1_rev =
          convert_seg(pdf_to_c1, d2g, abs_c, dot(cnor, cnor) > 0.f);
      const float l1_rev =
          convert_seg(pdf_to_l1, d2g, abs_l, dot(lnor, lnor) > 0.f);
      const float l2_rev = convert_seg(pdf_to_l2, l1->d2, l1->cos2, l1->nz2);
      const float c2_rev =
          convert_seg(pdf_to_c2, gc1->d2, gc1->cos2, gc1->nz2);
      L = scl(L, mis_weight(sg, t, gc1, l1, 0.f, c1_rev, c2_rev, l1_rev,
                            l2_rev, nanf_, false));
      okg = case_valid && finite3(L) && !is_black(L);
      d = c1_to_l1;
      st = sqrtf(d2g) - p.eps;
    }
    const bool keep = roulette(p, item, 4 + sg - 2, base, g_n, okg, &L, false,
                               no_draw);
    if (on) {
      live += put_slot(p, (size_t)(2 * g_n + (sg - 2) * g_n + g) * n + i,
                       keep, L, o, d, st, med);
    }
  }
  return live;
}

template <bool kTex>
__global__ void __launch_bounds__(kConnectThreads)
    bdpt_connect_kernel(BdptConnectArgs p) {
  extern __shared__ float smem[];
  // the warp's lanes: 32 / G groups of G threads (the rest idle)
  const int g_n = p.k - 1;
  const int per_warp = connect_lanes(g_n);
  const int wl = threadIdx.x & 31;
  const int sub = wl / g_n;
  const int g = wl - sub * g_n;
  const int i =
      (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * per_warp + sub;
  const bool on = sub < per_warp && i < p.n;
  VtxRec* cam = (VtxRec*)(smem + (size_t)(threadIdx.x >> 5) *
                                     connect_warp_words(g_n)) +
                (size_t)(on ? sub : 0) * 2 * g_n;
  const int queued =
      connect_column<kTex>(p, i, g, sub * g_n, on, cam, cam + g_n);
  if (p.has_media) return;   // the walk counts its own rays
  // the block's queued shadow rays, one atomic a block
  __shared__ int block_sum;
  if (threadIdx.x == 0) block_sum = 0;
  __syncthreads();
  if (queued) atomicAdd(&block_sum, queued);
  __syncthreads();
  if (threadIdx.x == 0 && block_sum)
    atomicAdd(p.rays, (unsigned long long)block_sum);
}

// bdpt_connect_kernel's blocks and shared memory over n lanes of k
// vertices
int connect_blocks(int n, int k) {
  const int lanes = kConnectWarps * connect_lanes(k - 1);
  return (n + lanes - 1) / lanes;
}
size_t connect_smem(int k) {
  return (size_t)kConnectWarps * connect_warp_words(k - 1) * sizeof(float);
}

// ---------------------------------------------------------------------------
// bdpt_finish
// ---------------------------------------------------------------------------
// A thread runs kFinishLanes neighbouring lanes through the queue's slots
// in order (s1's G, then each round's G columns), as one thread a lane
// did, and loads a slot's flags, credits, verdicts and pixels for its
// lanes as vectors: one 4-byte word of flags, three float4s of credits
// (each where one of its lanes is live), one word of verdicts or three
// float4s of Tr, one int4 of pixels. The next slot's flags are loaded
// before this slot's credits. It moves the same sectors as a thread a
// lane in a quarter of the requests. Designs that put more loads in
// flight at once instead (a thread a round of a lane with its columns'
// loads batched; a thread a lane with a round's flags, then its
// credits, batched) were slower than a thread a lane, 0.23-0.28 against
// 0.22 ms on cornell_port's 1M lanes (H100 80GB HBM3, 700 W; PERF.md
// section 6): the kernel is bound by how the card serves scattered
// sectors, not by the chain of loads. A queue whose lanes or arrays do
// not allow the vectors (N not a multiple of kFinishLanes, as a chunk of
// lanes can be) runs the same loop a lane a thread.
constexpr int kFinishLanes = 4;

template <int kN> struct FinishVec;
template <> struct FinishVec<1> { typedef uint8_t Flags; };
template <> struct FinishVec<4> { typedef uint32_t Flags; };

// kN floats x 3 of kN lanes at p (16-byte aligned where kN = 4), a float4
// loaded where one of the lanes it holds is live
template <int kN>
__device__ __forceinline__ void load_lanes3(const float* p, const bool* f,
                                            float* out) {
  if (kN == 1) {
    if (f[0]) {
      out[0] = __ldg(p);
      out[1] = __ldg(p + 1);
      out[2] = __ldg(p + 2);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 3 * kN / 4; ++k) {
    bool any = false;
#pragma unroll
    for (int l = (4 * k) / 3; l <= (4 * k + 3) / 3; ++l) any = any || f[l];
    if (any) {
      const float4 x = __ldg((const float4*)p + k);
      out[4 * k] = x.x;
      out[4 * k + 1] = x.y;
      out[4 * k + 2] = x.z;
      out[4 * k + 3] = x.w;
    }
  }
}

// The credits L x tr of slot `slot` for lanes i0 .. i0 + kN - 1 (flags
// fl), zero where not live; s1: their raster pixels too
template <int kN, bool kOcc>
__device__ __forceinline__ void slot_credits(
    const BdptFinishArgs& p, size_t slot,
    typename FinishVec<kN>::Flags fl, bool s1, V3* c, bool* f, int* pix) {
  typedef typename FinishVec<kN>::Flags Flags;
#pragma unroll
  for (int l = 0; l < kN; ++l) f[l] = ((fl >> (8 * l)) & 0xffu) != 0;
  float L[3 * kN], T[3 * kN];
#pragma unroll
  for (int k = 0; k < 3 * kN; ++k) L[k] = T[k] = 0.f;
  Flags occ = 0;
  if (fl) {
    load_lanes3<kN>(p.q_L + 3 * slot, f, L);
    if (kOcc) occ = __ldg((const Flags*)(p.occluded + slot));
    else load_lanes3<kN>(p.tr + 3 * slot, f, T);
    if (s1) {
      if (kN == 1) {
        pix[0] = __ldg(p.q_pix + slot);
      } else {
        const int4 q = __ldg((const int4*)(p.q_pix + slot));
        pix[0] = q.x;
        pix[1] = q.y;
        pix[2] = q.z;
        pix[3] = q.w;
      }
    }
  }
  // L x tr where live (the plain version's torch.where)
#pragma unroll
  for (int l = 0; l < kN; ++l) {
    const V3 Ll = mk(L[3 * l], L[3 * l + 1], L[3 * l + 2]);
    if (kOcc) {
      const float o = ((occ >> (8 * l)) & 0xffu) ? 0.f : 1.f;
      c[l] = f[l] ? mk(Ll.x * o, Ll.y * o, Ll.z * o) : mk(0.f, 0.f, 0.f);
    } else {
      c[l] = f[l] ? mul(Ll, mk(T[3 * l], T[3 * l + 1], T[3 * l + 2]))
                  : mk(0.f, 0.f, 0.f);
    }
  }
}

template <int kN, bool kOcc>
__global__ void __launch_bounds__(kThreads) bdpt_finish_kernel(
    BdptFinishArgs p) {
  typedef typename FinishVec<kN>::Flags Flags;
  const int i0 = (blockIdx.x * kThreads + threadIdx.x) * kN;
  if (i0 >= p.n) return;
  const size_t n = (size_t)p.n;
  const int g_n = p.g, s_n = g_n * (g_n + 2);
  V3 c[kN], acc[kN], li[kN];
  bool f[kN];
  int pix[kN];
  Flags next = __ldg((const Flags*)(p.live + i0));
  for (int j = 0; j < s_n; ++j) {
    const size_t slot = (size_t)j * n + i0;
    const Flags fl = next;
    if (j + 1 < s_n) next = __ldg((const Flags*)(p.live + slot + n));
    if (j == g_n) {
#pragma unroll
      for (int l = 0; l < kN; ++l) li[l] = ldg3(p.li + 3 * (i0 + l));
    }
    slot_credits<kN, kOcc>(p, slot, fl, j < g_n, c, f, pix);
    if (j < g_n) {   // s1: splat at the raster pixel
#pragma unroll
      for (int l = 0; l < kN; ++l) {
        if (!f[l]) continue;
        float* px = p.film + 3 * (size_t)pix[l];
        atomicAdd(px, c[l].x);
        atomicAdd(px + 1, c[l].y);
        atomicAdd(px + 2, c[l].z);
      }
      continue;
    }
    // t1, then the general rounds: a round's columns in column order,
    // then the round added to li
    const int col = (j - g_n) % g_n;
#pragma unroll
    for (int l = 0; l < kN; ++l) acc[l] = col == 0 ? c[l] : add(acc[l], c[l]);
    if (col == g_n - 1) {
#pragma unroll
      for (int l = 0; l < kN; ++l) li[l] = add(li[l], acc[l]);
    }
  }
  // NaN/Inf guard: poisoned lanes are zeroed
#pragma unroll
  for (int l = 0; l < kN; ++l)
    store3(p.li_out + 3 * (i0 + l),
           finite3(li[l]) ? li[l] : mk(0.f, 0.f, 0.f));
}

template <int kN>
int launch_finish(const BdptFinishArgs& a, cudaStream_t s) {
  const int blocks = (a.n / kN + kThreads - 1) / kThreads;
  if (a.occluded) {
    bdpt_finish_kernel<kN, true><<<blocks, kThreads, 0, s>>>(a);
  } else {
    bdpt_finish_kernel<kN, false><<<blocks, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// whether bdpt_finish's vectors fit the queue: N a multiple of
// kFinishLanes and every array aligned to its vector
bool finish_vectors(const BdptFinishArgs& a) {
  const auto off = [](const void* x, size_t to) {
    return x && (size_t)x % to != 0;
  };
  return a.n % kFinishLanes == 0 && !off(a.live, kFinishLanes) &&
         !off(a.occluded, kFinishLanes) && !off(a.q_L, 16) &&
         !off(a.tr, 16) && !off(a.q_pix, 16);
}

int blocks_of(int n) { return (n + kThreads - 1) / kThreads; }

template <bool kTex, bool kAll>
int launch_step(const BdptStepArgs& a, bool het, cudaStream_t s) {
  if (het) {
    bdpt_step_kernel<kTex, kAll, true><<<blocks_of(2 * a.n), kThreads, 0, s>>>(
        a);
  } else {
    bdpt_step_kernel<kTex, kAll, false>
        <<<blocks_of(2 * a.n), kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool kTex>
int launch_step_kinds(const BdptStepArgs& a, bool het, cudaStream_t s) {
  return a.all_kinds ? launch_step<kTex, true>(a, het, s)
                     : launch_step<kTex, false>(a, het, s);
}

template <bool kTex>
int launch_connect(const BdptConnectArgs& a, cudaStream_t s) {
  bdpt_connect_kernel<kTex>
      <<<connect_blocks(a.n, a.k), kConnectThreads, connect_smem(a.k), s>>>(
          a);
  return (int)cudaGetLastError();
}

template <bool kTex>
int connect_occupancy(int k, int* out) {
  out[0] = kConnectThreads;
  out[2] = (int)connect_smem(k);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], bdpt_connect_kernel<kTex>, kConnectThreads, connect_smem(k));
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched); n == 0 launches nothing.
//
// Vertex 0 and the first ray of the 2N subpath rows; l_medium NULL: no
// media, med_sample NULL: no heterogeneous medium.
extern "C" int bdpt_start(const BdptStartArgs* a, void* stream) {
  if (a->n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  bdpt_start_kernel<<<blocks_of(2 * a->n), kThreads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
//
// One step of the 2N subpath rows; tex NULL: no textures, found_t NULL:
// no heterogeneous medium.
extern "C" int bdpt_step(const BdptStepArgs* a, void* stream) {
  if (a->n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool het = a->found_t != nullptr;
  return a->tex ? launch_step_kinds<true>(*a, het, s)
                : launch_step_kinds<false>(*a, het, s);
}

// Every connection round of N lanes.
extern "C" int bdpt_connect(const BdptConnectArgs* a, void* stream) {
  if (a->n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return a->tex ? launch_connect<true>(*a, s) : launch_connect<false>(*a, s);
}

// bdpt_connect's launch shape for k vertices: out[0] threads a block,
// out[1] blocks an SM (the occupancy API), out[2] dynamic shared-memory
// bytes a block. Returns a CUDA error code.
extern "C" int bdpt_connect_occupancy(int k, int tex, int* out) {
  return tex ? connect_occupancy<true>(k, out)
             : connect_occupancy<false>(k, out);
}

// The queued credits after their shadow rays, and the NaN guard.
extern "C" int bdpt_finish(const BdptFinishArgs* a, void* stream) {
  if (a->n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return finish_vectors(*a) ? launch_finish<kFinishLanes>(*a, s)
                            : launch_finish<1>(*a, s);
}
