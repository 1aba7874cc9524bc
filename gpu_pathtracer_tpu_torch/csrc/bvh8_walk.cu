// BVH8 walk kernel (K4): closest or any hit of each ray over the unified
// 8-wide BVH table (geom/bvh8.py), flat or instanced (geom/tlas.py).
//
// Replaces the TPU kernel gpu_pathtracer_tpu/geom/packet_tpu.py::
// _walk_kernel (pallas_call at packet_tpu.py:996). On the TPU, packets of
// 256-512 rays share one stack in scalar memory, pop several node and
// leaf rows per step and keep the table resident in VMEM, or stream its
// leaf rows beside a bf16-packed copy of its nodes when it does not fit:
// devices for a vector machine without per-lane gathers. A GPU thread
// gathers on its own, so this is the per-thread stack walk those packets
// stood in for (the reference's pathtracer.cu:214-296), over the same
// table.
//
// What bounds it on an H100: latency and divergence, not bandwidth or
// flops. Each pop is a dependent 64-512 byte row read (the 100k-triangle
// table is 10.3 MB and the forest's 20k-row table the same: both sit in
// the 50 MB L2) followed by ~160 flops of slab tests or up to 8 prim
// tests, and the rays of a warp pop different rows, so the warp runs
// the union of their walks. The wavefront's ray sort (integrators/pt.py)
// keeps the rays of a warp close in origin and direction, which shrinks
// that union. The table is read through the read-only path (__ldg).
//
// Design: one thread per ray, 128-thread blocks; one stack of row
// entries per thread in local memory (meta > 0 node row, < 0 leaf row),
// sized at flatten time from the table's depth (bvh8.stack_bound); a
// push beyond it sets `overflow` and the wrapper raises. A node row's
// entered children are pushed far to near (sorted by entry distance,
// ties by slot), so the nearest pops first. A leaf row's valid slots are
// tested in order and a hit with t <= best t is taken, as the TPU kernel
// does. Instanced scenes walk instance-major, as the TPU kernel's
// default policy (packet_tpu.py:748-905): the instances' world boxes
// (aux cols 14:20) are slab-tested with the ray's tmax, visited in order
// of entry distance (ties by instance), skipped once that exceeds the
// best t; each visit maps the ray into the BLAS frame with aux cols 0:12
// without renormalising the direction (so t stays the world t), walks
// from the root row in col 12 and adds the slot base in col 13 to the
// hit's BLAS-local id. Every test uses the operations, in the order, of
// the plain version geom/packet.py::walk_torch, so the two agree bit for
// bit. Any-hit leaves at the first hit.
#include "intersect.cuh"

namespace {

constexpr int kMaxStack = 256;   // packet_cuda.MAX_STACK
constexpr int kMaxInst = 64;     // geom/tlas.py MAX_INSTANCES
constexpr float kBig = 3.0e38f;  // entry distance of a missed instance

__device__ __forceinline__ V3 inv3(V3 d) {
  return mk(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
}

// Walks the tree below node row `root` with the ray (o, d, inv), updating
// (best_t, best); hit ids are col 12 + base. Returns false when a push
// would pass stack_depth entries.
__device__ bool walk(const float* __restrict__ table, int root, int base,
                     V3 o, V3 d, V3 inv, float t0, int stack_depth,
                     int any_hit, float* best_t, int* best) {
  int stack[kMaxStack];
  int sp = 0;
  stack[sp++] = root;
  while (sp > 0) {
    const int e = stack[--sp];
    if (e >= 0) {
      // node row: 8 child slots of [min xyz, max xyz, meta, 0]
      const float4* row =
          reinterpret_cast<const float4*>(table + (size_t)e * 128);
      float key[8];
      int child[8];
      int nh = 0;
      for (int c = 0; c < 8; ++c) {
        const float4 a = __ldg(row + 2 * c);
        const float4 b = __ldg(row + 2 * c + 1);
        if (b.z == 0.f) continue;   // empty slot
        float tn;
        if (!slab_hit(mk(a.x, a.y, a.z), mk(a.w, b.x, b.y), o, inv, *best_t,
                      &tn)) {
          continue;
        }
        int k = nh++;   // insertion by (tn, slot): stable
        while (k > 0 && key[k - 1] > tn) {
          key[k] = key[k - 1];
          child[k] = child[k - 1];
          --k;
        }
        key[k] = tn;
        child[k] = (int)b.z;
      }
      if (sp + nh > stack_depth) return false;
      for (int r = nh - 1; r >= 0; --r) stack[sp++] = child[r];
    } else {
      // leaf row: 8 dense_prims records, valid ones first (col 13)
      const float4* rec =
          reinterpret_cast<const float4*>(table + (size_t)(-e) * 128);
      for (int j = 0; j < 8; ++j) {
        float4 r4[4];
        for (int k = 0; k < 4; ++k) r4[k] = __ldg(rec + 4 * j + k);
        if (!(r4[3].y > 0.f)) break;
        float tp;
        if (prim_hit(r4, o, d, t0, *best_t, &tp)) {
          *best_t = tp;
          *best = (int)r4[3].x + base;
          if (any_hit) return true;
        }
      }
    }
  }
  return true;
}

__global__ void bvh8_walk_kernel(const float* __restrict__ table,
                                 const float* __restrict__ aux, int n_inst,
                                 const float* __restrict__ ro,
                                 const float* __restrict__ rd,
                                 const float* __restrict__ tmin_,
                                 const float* __restrict__ tmax_,
                                 float* __restrict__ t_out,
                                 int32_t* __restrict__ prim_out,
                                 uint8_t* __restrict__ found_out,
                                 int32_t* __restrict__ overflow, int n,
                                 int stack_depth, int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 o = load3(ro + 3 * i);
  const V3 d = load3(rd + 3 * i);
  const V3 inv = inv3(d);
  const float t0 = tmin_[i];
  float best_t = tmax_[i];
  int best = -1;
  bool ok = true;
  if (n_inst == 0) {
    ok = walk(table, 0, 0, o, d, inv, t0, stack_depth, any_hit, &best_t,
              &best);
  } else {
    // entry distance of each instance's world box, with the ray's tmax
    float dist[kMaxInst];
    for (int k = 0; k < n_inst; ++k) {
      const float* a = aux + 20 * k;
      float tn;
      const bool h = slab_hit(mk(a[14], a[15], a[16]), mk(a[17], a[18], a[19]),
                              o, inv, best_t, &tn);
      dist[k] = h ? tmax(tn, 0.f) : kBig;
    }
    // visit in ascending (distance, instance) order
    float last_d = -INFINITY;
    int last_k = -1;
    for (int step = 0; step < n_inst && ok; ++step) {
      int kk = -1;
      float dk = 0.f;
      for (int k = 0; k < n_inst; ++k) {
        const float dd = dist[k];
        const bool after = dd > last_d || (dd == last_d && k > last_k);
        if (after && (kk < 0 || dd < dk)) {
          kk = k;
          dk = dd;
        }
      }
      if (!(dk < kBig) || dk > best_t || (any_hit && best >= 0)) break;
      const float* m = aux + 20 * kk;
      const V3 o2 = mk(m[0] * o.x + m[1] * o.y + m[2] * o.z + m[3],
                       m[4] * o.x + m[5] * o.y + m[6] * o.z + m[7],
                       m[8] * o.x + m[9] * o.y + m[10] * o.z + m[11]);
      const V3 d2 = mk(m[0] * d.x + m[1] * d.y + m[2] * d.z,
                       m[4] * d.x + m[5] * d.y + m[6] * d.z,
                       m[8] * d.x + m[9] * d.y + m[10] * d.z);
      ok = walk(table, (int)m[12], (int)m[13], o2, d2, inv3(d2), t0,
                stack_depth, any_hit, &best_t, &best);
      last_d = dk;
      last_k = kk;
    }
  }
  if (!ok) atomicOr(overflow, 1);
  if (any_hit) {
    found_out[i] = best >= 0;
  } else {
    t_out[i] = best_t;
    prim_out[i] = best;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched). Sets
// *overflow (device int) to 1 when a ray's stack would pass stack_depth.
extern "C" int bvh8_walk(const float* table, const float* aux, int n_inst,
                         const float* ro, const float* rd, const float* tmin_,
                         const float* tmax_, float* t_out, int32_t* prim_out,
                         uint8_t* found_out, int32_t* overflow, int n,
                         int stack_depth, int any_hit, void* stream) {
  if (stack_depth > kMaxStack || n_inst > kMaxInst) return -1;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh8_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, aux, n_inst, ro, rd, tmin_, tmax_, t_out, prim_out, found_out,
      overflow, n, stack_depth, any_hit);
  return (int)cudaGetLastError();
}
