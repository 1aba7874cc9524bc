// BVH8 walk kernel (K4): closest or any hit of each ray over the unified
// 8-wide BVH table (geom/bvh8.py), flat or instanced (geom/tlas.py).
//
// Replaces the TPU kernel gpu_pathtracer_tpu/geom/packet_tpu.py::
// _walk_kernel (pallas_call at packet_tpu.py:996). On the TPU, packets of
// 256-512 rays share one stack in scalar memory, pop several node and
// leaf rows per step and keep the table resident in VMEM, or stream its
// leaf rows beside a bf16-packed copy of its nodes when it does not fit:
// devices for a vector machine without per-lane gathers. A GPU thread
// gathers on its own, so this is a per-thread stack walk (the reference's
// pathtracer.cu:214-296) over the same table.
//
// What bounds it on an H100: the rows a warp reads. A ray's walk is short
// (on the 100k-triangle knot 2-4 rows a ray, close to the least any walk
// must open: chip_smoke.py's k4_work), but the lanes of a warp read
// different rows of the table (10.3 MB for the 100k knot, the forest's
// BLAS the same: both sit in the 50 MB L2), 256 bytes a node row and 64 a
// record, and a warp runs as long as its longest lane (on unsorted bounce
// rays ~16 rows against a mean of ~4). Measured on the card: versions
// that read more bytes a leaf, stage rows in shared memory (which takes
// L1's room) or add work a step are slower; neither the parent's local-
// memory stack nor its division per record was what held it back.
//
// Design:
// - the stack holds node groups, not children (Ylitie et al. 2017): an
//   entry is a node row and the slots of its entered children not yet
//   taken, nearest first, as 4-bit nibbles of one word. A ray holds at
//   most one group per level of the tree, so the stack is 16 entries, a
//   128-byte local frame (the parent's held 256 children, 1 KB); shared
//   memory stays L1's. The count of children pushed and not yet taken is
//   the plain version's stack size: passing stack_depth sets `overflow`
//   (so does a group stack that runs out of room: a tree deeper than 17
//   levels, or than `cap` + 1), and the wrapper raises;
// - a node's entered children are ordered by a sorting network on 32-bit
//   keys held in registers: the entry distance's bits, made to order like
//   the float, with the low 3 bits replaced by the slot. Children enter
//   nearest first, ties by slot, as in the plain version, except that
//   distances within 8 ulps are ordered by slot;
// - the walk is while-while (Aila and Laine 2009): a thread descends
//   nodes until its next child is a leaf, then the warp tests leaves; a
//   child's row is read from its group's node row when taken;
// - the leaf test does not divide (intersect.cuh::tri_cross): the best
//   hit is a fraction tnum / |det|, compared by cross products, and a
//   record is taken when its t <= the best t, in visit order: the plain
//   version's rule (among equal t the last visited wins). A record taken
//   gets its t from the plain version's arithmetic (tri_hit: one
//   division per take, not per test), and nodes, leaves and instances
//   are culled against that t, as the plain version culls: the two
//   enter the same rows wherever they take the same records, so an
//   exact tie across leaves resolves as in the plain version, and t
//   equals the plain version's wherever the two pick the same record;
// - two variants, chosen by the wrapper from the scene's prim kinds:
//   triangles only (no type branch) or all kinds;
// - a ray with an empty interval (intersect.cuh::empty_interval: PT's
//   finished lanes have tmax 0) is a miss at once;
// - instanced scenes walk instance-major (the kInst form of the kernel,
//   aux rows staged in shared memory), as the TPU kernel's default policy
//   (packet_tpu.py:748-905): one pass slab-tests the instances' world
//   boxes (aux cols 14:20) and keeps the 8 nearest entered in a sorted
//   register list of keys (entry distance clamped at 0, instance in the
//   low 6 bits), visited nearest first until one starts beyond the best
//   t; a second pass collects the rest when more than 8 were entered. A
//   visit maps the ray into the BLAS frame with aux cols 0:12 without
//   renormalising the direction (so t is the world t up to rounding),
//   walks from the root row in col 12 and adds the slot base in col 13 to
//   the hit's BLAS-local id. A closest hit on a triangle then takes its t
//   from its world record (`prims`, the scene's dense_prims) with the
//   plain version's arithmetic (tri_hit), as the flat walk does, so the
//   hit point does not carry the BLAS frame's rounding. Each thread tallies the (ray, instance) pairs whose world
//   box the first slab pass entered (`inst_entered`; the second pass
//   counts nothing twice) and the BLAS walks begun (`blas_walks`); given
//   `counts`, each warp adds its sums to counts[0] / counts[1] (int64)
//   with one warp reduction and one atomicAdd each. The flat form (kInst
//   false: every launch with n_inst 0) compiles none of this; it keeps
//   the body the kernel had before the instanced form, whose instanced
//   branch it never takes now, so that its registers and spill stay as
//   they were (without that branch ptxas gives it 48 / 55 registers and
//   no spill: a change to the flat walk, to be measured as one).
// Any hit leaves a ray at its first hit. The record choice is held to the
// plain version geom/packet.py::walk_torch within the hit limits (PERF.md
// section 2), not bit for bit.
#include "intersect.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxInst = 64;   // geom/tlas.py MAX_INSTANCES: a key's 6 bits
constexpr int kList = 8;       // entered instances kept per pass
constexpr int kMaxGroups = 16; // a thread's group stack: trees of 17 levels
constexpr unsigned kNone = 0xFFFFFFFFu;

// x's bits, flipped so that they order like the float
__device__ __forceinline__ unsigned order_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void cswap(unsigned& a, unsigned& b) {
  const unsigned lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// An optimal 19-comparator sorting network for 8 keys (Knuth, TAOCP
// 5.3.4), ascending.
__device__ __forceinline__ void sort8(unsigned (&k)[8]) {
  cswap(k[0], k[2]); cswap(k[1], k[3]); cswap(k[4], k[6]); cswap(k[5], k[7]);
  cswap(k[0], k[4]); cswap(k[1], k[5]); cswap(k[2], k[6]); cswap(k[3], k[7]);
  cswap(k[0], k[1]); cswap(k[2], k[3]); cswap(k[4], k[5]); cswap(k[6], k[7]);
  cswap(k[2], k[4]); cswap(k[3], k[5]);
  cswap(k[1], k[4]); cswap(k[3], k[6]);
  cswap(k[1], k[2]); cswap(k[3], k[4]); cswap(k[5], k[6]);
}

struct Ray {
  V3 o, d, inv;
};

// The best hit so far: the fraction tb / ab (tmax / 1 before any), its
// t by the plain version's arithmetic (`t`, the culling bound: tmax
// before any hit) and its prim id (-1 none).
struct Best {
  float tb, ab, t;
  int prim;
};

// The entered children of node row `row` as a list of nibbles (slot + 1,
// nearest in the low nibble); their count in *nh.
__device__ __forceinline__ unsigned node_children(const float* table,
                                                  int row, const Ray& r,
                                                  float cull, int* nh) {
  const float4* q = reinterpret_cast<const float4*>(table + (size_t)row * 128);
  unsigned k[8];
  int n = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 a = __ldg(q + 2 * c), b = __ldg(q + 2 * c + 1);
    float tn;
    const bool h = b.z != 0.f &&
                   slab_hit(mk(a.x, a.y, a.z), mk(a.w, b.x, b.y), r.o, r.inv,
                            cull, &tn);
    k[c] = h ? ((order_bits(tn) & ~7u) | (unsigned)c) : kNone;
    n += h;
  }
  sort8(k);
  unsigned list = 0;
#pragma unroll
  for (int c = 7; c >= 0; --c) {
    if (c < n) list = (list << 4) | ((k[c] & 7u) + 1u);
  }
  *nh = n;
  return list;
}

// Test the valid records of leaf row `leaf`. Closest hit: updates `b`.
// Any hit: returns true at the first record hit within [t0, t1].
template <bool kAll>
__device__ __forceinline__ bool leaf_test(const float* table, int leaf,
                                          const Ray& r, float t0, float t1,
                                          int base, int any_hit, Best& b) {
  const float4* rec =
      reinterpret_cast<const float4*>(table + (size_t)leaf * 128);
#pragma unroll 2
  for (int j = 0; j < 8; ++j) {
    const float4 q0 = __ldg(rec + 4 * j), q1 = __ldg(rec + 4 * j + 1);
    const float4 q2 = __ldg(rec + 4 * j + 2), q3 = __ldg(rec + 4 * j + 3);
    if (!(q3.y > 0.f)) break;   // valid records come first (col 13)
    const V3 v0 = mk(q0.x, q0.y, q0.z);
    const V3 a = mk(q0.w, q1.x, q1.y);
    float tn = 0.f, ad = 1.f;
    bool h;
    if (kAll && q2.y != PRIM_TRIANGLE) {
      // t in [t0, best t]: t1 itself for any hit
      float s;
      const float bt = any_hit ? t1 : b.t;
      h = q2.y == PRIM_SPHERE
          ? sphere_hit(r.o, r.d, v0, q2.z, t0, bt, &tn)
          : q2.y == PRIM_LINE &&
            line_hit(r.o, r.d, v0, a, q2.z, q2.w, t0, bt, &tn, &s);
    } else {
      h = tri_cross(r.o, r.d, v0, a, mk(q1.z, q1.w, q2.x), &tn, &ad) &&
          tn >= t0 * ad;
    }
    if (any_hit) {
      if (h && tn <= t1 * ad) {
        b.prim = 1;
        return true;
      }
      continue;
    }
    // t <= best t: the later record wins among equals, as in visit order
    if (h && tn * b.ab <= b.tb * ad) {
      b.tb = tn;
      b.ab = ad;
      b.prim = (int)q3.x + base;
      b.t = tn;   // a sphere's or a line's t as its test gave it
      if (!kAll || q2.y == PRIM_TRIANGLE) {   // the plain version's t
        tri_hit(r.o, r.d, v0, a, mk(q1.z, q1.w, q2.x), -INFINITY, INFINITY,
                &b.t);
      }
    }
  }
  return false;
}

// Walk the tree below node row `root` with ray r (in the table's frame).
// `srow` / `slist` are this thread's group stack (`cap`
// entries). Returns false when the walk would pass stack_depth pending
// children or `cap` groups.
template <bool kAll>
__device__ __forceinline__ bool walk(const float* __restrict__ table,
                                     int root, int base, const Ray& r,
                                     float t0,
                                     float t1, int stack_depth, int cap,
                                     int* srow, unsigned* slist, int any_hit,
                                     Best& b) {
  int nh;
  int row = root;
  unsigned list = node_children(table, row, r, b.t, &nh);
  if (nh > stack_depth) return false;
  int pending = nh;   // children pushed and not yet taken
  int sp = 0;         // groups on the stack
  for (;;) {
    int leaf = -1;
    while (leaf < 0) {   // descend to the next leaf
      if (list == 0) {
        if (sp == 0) break;
        --sp;
        row = srow[sp];
        list = slist[sp];
      }
      const int s = (int)(list & 15u) - 1;
      list >>= 4;
      --pending;
      const int meta = (int)__ldg(table + (size_t)row * 128 + s * 8 + 6);
      if (meta < 0) {
        leaf = -meta;
      } else {
        int n2;
        const unsigned l2 = node_children(table, meta, r, b.t, &n2);
        if (pending + n2 > stack_depth) return false;
        pending += n2;
        if (list != 0) {
          if (sp == cap) return false;
          srow[sp] = row;
          slist[sp] = list;
          ++sp;
        }
        row = meta;
        list = l2;
      }
    }
    if (leaf < 0) return true;
    if (leaf_test<kAll>(table, leaf, r, t0, t1, base, any_hit, b)) {
      return true;
    }
  }
}

// The ray mapped by aux row m (cols 0:12, 3x4 row-major), as the plain
// version's _xform.
__device__ __forceinline__ Ray to_frame(const float* m, V3 o, V3 d) {
  Ray r;
  r.o = mk(m[0] * o.x + m[1] * o.y + m[2] * o.z + m[3],
           m[4] * o.x + m[5] * o.y + m[6] * o.z + m[7],
           m[8] * o.x + m[9] * o.y + m[10] * o.z + m[11]);
  r.d = mk(m[0] * d.x + m[1] * d.y + m[2] * d.z,
           m[4] * d.x + m[5] * d.y + m[6] * d.z,
           m[8] * d.x + m[9] * d.y + m[10] * d.z);
  r.inv = mk(safe_inv(r.d.x), safe_inv(r.d.y), safe_inv(r.d.z));
  return r;
}

template <bool kAll, bool kInst>
__global__ void __launch_bounds__(kThreads)
    bvh8_walk_kernel(const float* __restrict__ table,
                     const float* __restrict__ aux, int n_inst,
                     const float* __restrict__ prims,
                     const float* __restrict__ ro,
                     const float* __restrict__ rd,
                     const float* __restrict__ tmin_,
                     const float* __restrict__ tmax_,
                     float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                     uint8_t* __restrict__ found_out,
                     int32_t* __restrict__ overflow,
                     unsigned long long* __restrict__ counts, int n,
                     int stack_depth, int cap, int any_hit) {
  extern __shared__ float inst[];   // the aux rows
  if (kInst || n_inst > 0) {
    for (int j = threadIdx.x; j < n_inst * 20; j += blockDim.x) {
      inst[j] = aux[j];
    }
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t0 = tmin_[i];
  const float t1 = tmax_[i];
  unsigned n_entered = 0, n_walks = 0;   // kInst's tallies
  Best b;
  b.tb = t1;
  b.ab = 1.f;
  b.t = t1;
  b.prim = -1;
  bool ok = true;
  if (!empty_interval<kAll>(t0, t1)) {
    Ray w;
    w.o = load3(ro + 3 * i);
    w.d = load3(rd + 3 * i);
    w.inv = mk(safe_inv(w.d.x), safe_inv(w.d.y), safe_inv(w.d.z));
    int srow[kMaxGroups];   // the group stack: 128 bytes of local memory
    unsigned slist[kMaxGroups];
    cap = min(cap, kMaxGroups);
    if (!kInst && n_inst == 0) {
      ok = walk<kAll>(table, 0, 0, w, t0, t1, stack_depth, cap, srow, slist,
                      any_hit, b);
    } else {
      unsigned floor_key = 0;   // keys below it were visited
      bool more = true, first = true;
      while (more && ok) {
        unsigned l[kList];
#pragma unroll
        for (int j = 0; j < kList; ++j) l[j] = kNone;
        int entered = 0;
        for (int k = 0; k < n_inst; ++k) {
          const float* a = inst + 20 * k;
          float tn;
          if (!slab_hit(mk(a[14], a[15], a[16]), mk(a[17], a[18], a[19]),
                        w.o, w.inv, b.t, &tn)) {
            continue;
          }
          const unsigned key =
              (__float_as_uint(fmaxf(tn, 0.f)) & ~(unsigned)(kMaxInst - 1)) |
              (unsigned)k;
          if (key < floor_key) continue;
          ++entered;
          if (key < l[kList - 1]) list_insert(l, key);
        }
        more = entered > kList;
        if (first) n_entered += entered;
        first = false;
        while (l[0] != kNone) {
          const unsigned key = l[0];
          // every instance left starts beyond the best hit
          if (__uint_as_float(key & ~(unsigned)(kMaxInst - 1)) > b.t) {
            more = false;
            break;
          }
          const int k = (int)(key & (kMaxInst - 1));
          const float* m = inst + 20 * k;
          ++n_walks;
          ok = walk<kAll>(table, (int)m[12], (int)m[13],
                          to_frame(m, w.o, w.d), t0, t1, stack_depth, cap,
                          srow, slist, any_hit, b);
          if (!ok || (any_hit && b.prim >= 0)) {
            more = false;
            break;
          }
          floor_key = key + 1;
#pragma unroll
          for (int j = 0; j + 1 < kList; ++j) l[j] = l[j + 1];
          l[kList - 1] = kNone;
        }
      }
      if (kInst && !any_hit && b.prim >= 0) {
        // the world t of the record taken (the flat walk's arithmetic)
        const float4* q =
            reinterpret_cast<const float4*>(prims + (size_t)b.prim * 16);
        const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2);
        if (!kAll || q2.y == PRIM_TRIANGLE) {
          tri_hit(w.o, w.d, mk(q0.x, q0.y, q0.z), mk(q0.w, q1.x, q1.y),
                  mk(q1.z, q1.w, q2.x), -INFINITY, INFINITY, &b.t);
        }
      }
    }
  }
  if (!ok) atomicOr(overflow, 1);
  if (any_hit) {
    found_out[i] = b.prim >= 0;
  } else {
    t_out[i] = b.t;   // tmax on a miss
    prim_out[i] = b.prim;
  }
  if (kInst && counts != nullptr) {
    // the warp's threads below n (the others returned at the top)
    const unsigned lane = threadIdx.x & 31u;
    const int live = n - (i - (int)lane);
    const unsigned mask = live >= 32 ? 0xFFFFFFFFu : (1u << live) - 1u;
    const unsigned e = __reduce_add_sync(mask, n_entered);
    const unsigned w = __reduce_add_sync(mask, n_walks);
    if (lane == 0) {
      atomicAdd(counts, (unsigned long long)e);
      atomicAdd(counts + 1, (unsigned long long)w);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or -1
// for arguments the kernel does not take. Sets *overflow (a device int
// the caller keeps across launches) to 1 when a ray's walk would pass
// stack_depth pending children or min(cap, 16) stacked groups (shared
// memory: the n_inst aux rows). all_kinds = 0 takes the triangles-only
// variant (the scene has no sphere and no line). n_inst > 0 takes the
// instanced form: `prims` (the scene's dense_prims [P, 16]) gives a
// closest hit on a triangle its world t, and `counts` (int64 [2] on the
// device, or null) gets the walk's inst_entered and blas_walks added; a
// flat walk (n_inst 0) reads neither.
extern "C" int bvh8_walk(const float* table, const float* aux, int n_inst,
                         const float* prims, const float* ro, const float* rd,
                         const float* tmin_, const float* tmax_, float* t_out,
                         int32_t* prim_out, uint8_t* found_out,
                         int32_t* overflow, int64_t* counts, int n,
                         int stack_depth, int cap, int any_hit, int all_kinds,
                         void* stream) {
  if (n_inst > kMaxInst || cap < 1 || (n_inst > 0 && !prims)) return -1;
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * 20 * (size_t)n_inst;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* c = reinterpret_cast<unsigned long long*>(counts);
#define BVH8_WALK_ARGS                                                      \
  table, aux, n_inst, prims, ro, rd, tmin_, tmax_, t_out, prim_out,         \
      found_out, overflow, c, n, stack_depth, cap, any_hit
  if (n_inst > 0) {
    if (all_kinds) {
      bvh8_walk_kernel<true, true><<<blocks, kThreads, smem, s>>>(
          BVH8_WALK_ARGS);
    } else {
      bvh8_walk_kernel<false, true><<<blocks, kThreads, smem, s>>>(
          BVH8_WALK_ARGS);
    }
  } else if (all_kinds) {
    bvh8_walk_kernel<true, false><<<blocks, kThreads, 0, s>>>(BVH8_WALK_ARGS);
  } else {
    bvh8_walk_kernel<false, false><<<blocks, kThreads, 0, s>>>(
        BVH8_WALK_ARGS);
  }
#undef BVH8_WALK_ARGS
  return (int)cudaGetLastError();
}
