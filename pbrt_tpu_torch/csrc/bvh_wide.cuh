// The BVH traversal of K1 (closest hit) and K1a (any hit), and of their
// two-level variants K1i and K1i-a, designed for Hopper. Counterpart of
// pbrt_tpu/accel/bvh.py:909 `_traverse` (its stepper :694, the two-level
// one :794, `_slab8` :592); it reads the same row table,
// bvh_rows, byte-identical to JAX's (accel/bvh.py: internal row i < n_int
// holds 8 child boxes [lo(3) hi(3)] and 8 child ids as floats; leaf row
// n_int + c holds the 8 triangles [p0 p1 p2] of chunk c). Every row is 288
// bytes, 18 float4, and 16-byte aligned when the table is.
//
// What it does about the costs of the loop it replaced (one thread a ray,
// a row read a float at a time, a local-memory stack of (node, child-mask)
// entries that revisit a node for each later sibling):
//  - Whole-row vector loads. An internal visit issues its 14 16-byte loads
//    (12 of boxes, 2 of child ids) through the read-only path before the
//    first slab test; a leaf issues them in two halves of 9, each holding 4
//    whole triangles, before the first of their watertight tests. (All 18
//    at once hold 72 registers: measured on the H100, the halves' lower
//    register count and the smaller stack entries below put 6 blocks on an
//    SM instead of 4, which won on staircase and terrain and lost on
//    cornell-mesh; PERF.md §6.)
//  - No revisits. The stack holds one entry per pending child: its row
//    (4 bytes) and the top 16 bits of its box's entry distance (2 bytes,
//    truncated, so never above the true distance: an entry is dropped only
//    when its box starts at or beyond t_best). A closest-hit visit sorts the
//    surviving children by entry distance (a 19-comparator network over the
//    8 slots, in registers), descends into the nearest and pushes the
//    others farthest first, so they pop nearest first; a popped entry whose
//    distance is no longer below t_best is dropped unread. An any-hit visit
//    descends into its first surviving child and pushes the others in slot
//    order. So a ray reads a row at most once. Cost: a visit pushes at most
//    WIDTH - 1 entries, and the stack holds only the pending children of the
//    current node's internal ancestors, so a tree whose longest chain of
//    internal rows is `depth` needs (WIDTH - 1) * depth entries
//    (`stack_entries`); the wrapper sizes the stack so at launch and raises
//    when it does not fit.
//  - No local-memory stack. The stack lives in dynamic shared memory, one
//    slice per thread, interleaved (entry k of thread j at k * BLOCK + j) so
//    that a warp's pushes and pops hit distinct banks.
//  - Warps not held by finished lanes. Persistent warps, as many blocks as
//    fit on the card at once, fetch rays from a global ticket (Aila and
//    Laine, HPG 2009, persistent threads with dynamic fetch). When at least
//    REFILL lanes of a warp are idle, one atomic hands them the next rays;
//    a lane that draws a ray with t_max <= 0 writes its miss and stays idle,
//    and the warp draws again. The ticket is a word of the launch's own,
//    zeroed before it by the wrapper (a memset that a CUDA graph replays
//    too), so launches on different streams never share one.
//  - Less leaf/internal divergence. The while-while form of the same paper
//    with speculative traversal: a warp visits internal rows until every
//    lane has parked a leaf or is done, then its lanes test their leaves
//    together.
// Every float op rounds as the plain version's (build with --fmad=false):
// the slab test is JAX's `_slab8`, the leaf test is csrc/watertight.cuh. A
// triangle replaces the best hit only when strictly nearer, so on an exact
// tie the winner may differ from the plain sweep's.
//
// The two-level variant (K1i / K1i-a, `inst_wide_kernel` below) runs the
// same loop over an instanced scene's table. Ray, make_ray, Counts and
// add_counts are bvh_ray.cuh's, shared with K11 (scene_shard.cu).
#pragma once

#include <cuda_runtime.h>

#include "bvh_ray.cuh"
#include "watertight.cuh"

namespace pbrt_wide {

using pbrt_bvh::Counts;
using pbrt_bvh::LEAF_K;
using pbrt_bvh::Ray;
using pbrt_bvh::WIDTH;

constexpr int BLOCK = 128;        // threads a block
constexpr int REFILL = 8;         // idle lanes that make a warp draw new rays
constexpr int DONE = -1;
constexpr int OVERFLOWED = -2;   // a lane past its stack or its iteration bound
constexpr int ROW4 = pbrt_bvh::ROW_W / 4;   // 18 float4 a row
constexpr unsigned FULL = 0xffffffffu;
constexpr float MISS = __builtin_huge_valf();  // +inf: the key of a slot the ray misses

// Stack entries a tree of the given depth (longest chain of internal rows)
// needs: a visit pushes at most WIDTH - 1.
__host__ __device__ constexpr int stack_entries(int depth) { return (WIDTH - 1) * depth; }

// The entries one thread may hold: the shared memory a block may use on the
// H100 (232,448 bytes) over BLOCK threads of 6-byte entries.
constexpr int MAX_STACK = 232448 / (BLOCK * 6);

// compare-exchange of two (key, id) slots: the smaller key first
__device__ __forceinline__ void cas(float& ka, int& ia, float& kb, int& ib) {
  const bool sw = kb < ka;
  const float k = sw ? kb : ka;
  const int i = sw ? ib : ia;
  kb = sw ? ka : kb;
  ib = sw ? ia : ib;
  ka = k;
  ia = i;
}

// ascending by key: the optimal 19-comparator network on 8 inputs
__device__ __forceinline__ void sort8(float* k, int* i) {
#define PBRT_CAS(a, b) cas(k[a], i[a], k[b], i[b])
  PBRT_CAS(0, 2); PBRT_CAS(1, 3); PBRT_CAS(4, 6); PBRT_CAS(5, 7);
  PBRT_CAS(0, 4); PBRT_CAS(1, 5); PBRT_CAS(2, 6); PBRT_CAS(3, 7);
  PBRT_CAS(0, 1); PBRT_CAS(2, 3); PBRT_CAS(4, 5); PBRT_CAS(6, 7);
  PBRT_CAS(2, 4); PBRT_CAS(3, 5);
  PBRT_CAS(1, 4); PBRT_CAS(3, 6);
  PBRT_CAS(1, 2); PBRT_CAS(3, 4); PBRT_CAS(5, 6);
#undef PBRT_CAS
}

// One thread's stack: entry k at ids[k * BLOCK] (its row) and tns[k * BLOCK]
// (the top 16 bits of its entry distance), in the block's dynamic shared
// memory: BLOCK * cap row ids, then BLOCK * cap distances.
struct Stack {
  int* ids;
  unsigned short* tns;
  int sp;
  int cap;
  __device__ __forceinline__ void push(int id, float tn) {
    ids[sp * BLOCK] = id;
    tns[sp * BLOCK] = (unsigned short)(__float_as_uint(tn) >> 16);
    ++sp;
  }
  __device__ __forceinline__ int id_at(int k) const { return ids[k * BLOCK]; }
  __device__ __forceinline__ float key_at(int k) const {
    return __uint_as_float((unsigned)tns[k * BLOCK] << 16);
  }
  __device__ __forceinline__ bool room(int n) const { return sp + n <= cap; }
  __device__ __forceinline__ bool refill() const { return false; }
};

// The stack of the two-level kernel: Stack's entries in shared memory, `cap`
// a thread, over a spill area in device memory, `far_cap` entries a thread
// (entry j of thread g of the grid at far[j * threads + g]: its row and the
// key's top 16 bits), which holds the entries below the shared ones. When a
// visit's pushes do not fit, the lower half of the shared entries moves to
// the spill area; when a pop finds the shared part empty, the top of the
// spill area comes back. A two-level table's bound, 7 entries a level of
// both trees, is several times what a ray uses (on the cornell-instanced
// frame 105 against at most 23, measured on the H100, PERF.md), and a
// shared stack sized to the bound left two blocks an SM: the shared part is
// sized for six, and only a rare deep ray touches the spill area. Its
// loops are not unrolled: unrolled, the code they add to every visit and
// pop cost K1i 6 % (the H100, PERF.md).
struct SplitStack {
  int* ids;
  unsigned short* tns;
  int sp;        // the shared entries
  int cap;
  int n_far;     // the entries in the spill area, below them
  int far_cap;
  int2* far;
  __device__ __forceinline__ int2& far_at(int j) const {
    return far[(long long)j * (gridDim.x * BLOCK) + blockIdx.x * BLOCK + threadIdx.x];
  }
  __device__ __forceinline__ void push(int id, float tn) {
    ids[sp * BLOCK] = id;
    tns[sp * BLOCK] = (unsigned short)(__float_as_uint(tn) >> 16);
    ++sp;
  }
  __device__ __forceinline__ int id_at(int k) const { return ids[k * BLOCK]; }
  __device__ __forceinline__ float key_at(int k) const {
    return __uint_as_float((unsigned)tns[k * BLOCK] << 16);
  }
  // room for n more pushes; false when the whole stack cannot take them
  __device__ __forceinline__ bool room(int n) {
    if (sp + n <= cap) return true;
    const int m = min(min(max(cap / 2, sp + n - cap), sp), far_cap - n_far);
    if (sp - m + n > cap) return false;
#pragma unroll 1
    for (int k = 0; k < m; ++k) far_at(n_far + k) = make_int2(ids[k * BLOCK], tns[k * BLOCK]);
#pragma unroll 1
    for (int k = m; k < sp; ++k) {
      ids[(k - m) * BLOCK] = ids[k * BLOCK];
      tns[(k - m) * BLOCK] = tns[k * BLOCK];
    }
    sp -= m;
    n_far += m;
    return true;
  }
  // the shared part empty: the top of the spill area back into it
  __device__ __forceinline__ bool refill() {
    if (n_far == 0) return false;
    const int m = min(n_far, max(cap / 2, 1));
#pragma unroll 1
    for (int k = 0; k < m; ++k) {
      const int2 e = far_at(n_far - m + k);
      ids[k * BLOCK] = e.x;
      tns[k * BLOCK] = (unsigned short)e.y;
    }
    n_far -= m;
    sp = m;
    return true;
  }
  __device__ __forceinline__ int level() const { return sp + n_far; }
  __device__ __forceinline__ void clear() { sp = n_far = 0; }
};

// The next pending row, dropping those whose box starts at or beyond t_best
// (never for any hit: its bound does not shrink before it ends); DONE when
// none is left.
template <bool ANY_HIT, class St>
__device__ __forceinline__ int pop(St& st, float t_best) {
  while (st.sp > 0 || st.refill()) {
    --st.sp;
    const int id = st.id_at(st.sp);
    if (ANY_HIT || st.key_at(st.sp) < t_best) return id;
  }
  return DONE;
}

// The global id of a child: a table's own rows are addressed by the ids its
// rows hold (K1); other tables map them (K11's parts and top level,
// scene_shard.cu).
struct SameTable {
  __device__ __forceinline__ int operator()(int child) const { return child; }
};

// Visit internal row `row`: slab-test its 8 child boxes against [0, t_best)
// and return the row to go to next (the nearest surviving child, else the
// next pending one), the other survivors pushed; OVERFLOWED when they do
// not fit on the stack. SORT (closest hit): descend into the nearest and
// push the others farthest first; else in slot order. `map` turns the ids
// the row holds into the ids pushed and returned.
template <bool ANY_HIT, bool SORT = !ANY_HIT, class Map = SameTable, class St = Stack>
__device__ __forceinline__ int visit_internal(const float4* __restrict__ row, const Ray& r,
                                              float t_best, St& st, Map map = Map()) {
  float4 q[14];
#pragma unroll
  for (int i = 0; i < 14; ++i) q[i] = __ldg(row + i);
  const float* b = reinterpret_cast<const float*>(q);
  float key[WIDTH];
  int id[WIDTH];
  int h = 0;
#pragma unroll
  for (int s = 0; s < WIDTH; ++s) {
    const float* bs = b + 6 * s;
    const int child = (int)b[6 * WIDTH + s];
    const float t0x = (bs[0] - r.ox) * r.ix, t1x = (bs[3] - r.ox) * r.ix;
    const float t0y = (bs[1] - r.oy) * r.iy, t1y = (bs[4] - r.oy) * r.iy;
    const float t0z = (bs[2] - r.oz) * r.iz, t1z = (bs[5] - r.oz) * r.iz;
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    tf = tf * pbrt_bvh::SLAB_WIDEN;
    tn = fmaxf(tn, 0.f);
    // an empty slot has id -1 and an inverted box
    const bool hit = child >= 0 && bs[0] <= bs[3] && tn <= tf && tf > 0.f && tn < t_best;
    key[s] = hit ? tn : MISS;
    id[s] = map(child);
    h += hit;
  }
  if (h == 0) return pop<ANY_HIT>(st, t_best);
  if (!st.room(h - 1)) return OVERFLOWED;
  int next = DONE;
  if (!SORT || h == 1) {
#pragma unroll
    for (int s = 0; s < WIDTH; ++s) {
      if (key[s] != MISS) {
        if (next == DONE) next = id[s];
        else st.push(id[s], key[s]);
      }
    }
  } else {
    sort8(key, id);
    next = id[0];
#pragma unroll
    for (int k = WIDTH - 1; k >= 1; --k)
      if (k < h) st.push(id[k], key[k]);
  }
  return next;
}

// Test the 8 triangles of leaf row `row` (chunk `chunk`) against [0, t_best);
// a strictly nearer hit replaces (t_best, prim), prim = chunk * 8 + k.
// Returns whether one did. LEX: a hit at t_best also replaces a best hit of
// a higher prim, so the least (t, prim) wins whatever the order of the
// tests (K11a's rule across parts). STATS: count the tests by exit stage
// into c.
template <bool ANY_HIT, bool STATS, bool LEX = false, class C = Counts>
__device__ __forceinline__ bool test_leaf(const float4* __restrict__ row, int chunk,
                                          const Ray& r, float& t_best, int& prim, C& c) {
  bool found = false;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float4 q[ROW4 / 2];
#pragma unroll
    for (int i = 0; i < ROW4 / 2; ++i) q[i] = __ldg(row + half * (ROW4 / 2) + i);
    const float* v = reinterpret_cast<const float*>(q);
#pragma unroll
    for (int k = 0; k < LEAF_K / 2; ++k) {
      float t;
      int stage;
      const bool hit = pbrt_wt::watertight(v + 9 * k, r.ox, r.oy, r.oz, r.sh, t_best, t,
                                           nullptr, STATS ? &stage : nullptr);
      if (STATS) {
        ++c.tris;
        c.edge += stage >= 1;
        c.range += stage >= 2;
      }
      const int cand = chunk * LEAF_K + half * (LEAF_K / 2) + k;
      if (hit && (t < t_best || (LEX && t == t_best && cand < prim))) {
        t_best = t;
        prim = cand;
        found = true;
        if (ANY_HIT) break;
      }
    }
    if (ANY_HIT && found) break;
  }
  return found;
}

// K1 / K1a over rays [0, n_rays): t_out = the nearest hit's t (t_max when
// none), prim_out = its leaf-order index chunk * 8 + k (-1 when none; any
// hit: the first hit found). `ticket`, the next ray to hand out, is one
// word of this launch's own, 0 when it starts.
// A lane that reads more than 4 * n_rows + 16 rows or would overflow its
// stack of stack_depth entries stops with what it has and adds one to
// `overflow` (a correct tree with stack_depth >= stack_entries(depth) never
// does). STATS (launched when `stats` is given): sum the work counts into
// stats[0..3]. Launch with blockDim.x == BLOCK and BLOCK * stack_depth * 6
// bytes of dynamic shared memory. At most 80 registers (6 blocks an SM).
//
// The while-while loop with speculative traversal (Aila and Laine): a lane
// that reaches a leaf parks it and goes on through internal rows with its
// next pending entry, until every lane of the warp has parked a leaf (or
// is done) or no lane has an internal row left; then the lanes test their
// parked leaves together. A row visited ahead of a parked leaf's test may
// turn out to lie beyond the hit that test finds: extra work, never a
// missed hit, since t_best only shrinks.
template <bool ANY_HIT, bool STATS>
__global__ void __launch_bounds__(BLOCK, 6)
wide_kernel(const float* __restrict__ rows, int n_rows, int n_int,
            const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_max, int n_rays, float* __restrict__ t_out,
            int* __restrict__ prim_out, int* __restrict__ overflow, int stack_depth,
            unsigned long long* __restrict__ stats, unsigned* __restrict__ ticket) {
  extern __shared__ int stack_mem[];
  Stack st{stack_mem + threadIdx.x,
           reinterpret_cast<unsigned short*>(stack_mem + BLOCK * stack_depth) + threadIdx.x, 0,
           stack_depth};
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int max_iters = 4 * n_rows + 16;   // n_rows < 2^23
  Counts c;
  Ray r{};
  int ray = -1, cur = DONE, leaf = -1, prim = -1, it = 0;
  float t_best = 0.f;
  bool exhausted = false;
  for (;;) {
    // ---- a finished lane writes its ray's result; idle lanes draw rays
    if (ray >= 0 && cur == DONE) {
      t_out[ray] = t_best;
      prim_out[ray] = prim;
      ray = -1;
    }
    unsigned idle = __ballot_sync(FULL, ray < 0);
    while (!exhausted && __popc(idle) >= REFILL) {
      const unsigned n = __popc(idle);
      unsigned base = 0;
      if (lane == 0) base = atomicAdd(ticket, n);
      base = __shfl_sync(FULL, base, 0);
      exhausted = base + n >= (unsigned)n_rays;
      const unsigned i = base + __popc(idle & below);
      if (ray < 0 && i < (unsigned)n_rays) {
        const float tm = t_max[i];
        if (tm > 0.f) {
          ray = (int)i;
          r = pbrt_bvh::make_ray(o + 3LL * i, d + 3LL * i);
          t_best = tm;
          prim = -1;
          cur = 0;
          st.sp = 0;
          it = 0;
        } else {        // masked lane: a miss, at once
          t_out[i] = tm;
          prim_out[i] = -1;
        }
      }
      idle = __ballot_sync(FULL, ray < 0);
    }
    if (idle == FULL) break;  // the loop above refills a fully idle warp until the rays run out

    // ---- internal rows, until every lane has parked a leaf or is done
    for (;;) {
      if (ray >= 0 && cur >= n_int && leaf < 0) {   // park a leaf, go on with the next entry
        leaf = cur;
        cur = pop<ANY_HIT>(st, t_best);
      }
      const bool inner = ray >= 0 && cur >= 0 && cur < n_int;
      if (!__any_sync(FULL, inner) || __all_sync(FULL, ray < 0 || leaf >= 0 || cur == DONE))
        break;
      if (inner) {
        if (STATS) ++c.nodes;
        const int next = it++ >= max_iters ? OVERFLOWED
            : visit_internal<ANY_HIT>(rows4 + (long long)cur * ROW4, r, t_best, st);
        if (next == OVERFLOWED) {
          atomicAdd(overflow, 1);
          cur = DONE;
          leaf = -1;
        } else {
          cur = next;
        }
      }
    }
    // ---- the parked leaves, all together
    if (leaf >= 0) {
      if (it++ >= max_iters) {
        atomicAdd(overflow, 1);
        cur = DONE;
      } else if (test_leaf<ANY_HIT, STATS>(rows4 + (long long)leaf * ROW4, leaf - n_int, r,
                                           t_best, prim, c) && ANY_HIT) {
        cur = DONE;
      }
      leaf = -1;
    }
  }
  if (STATS) pbrt_bvh::add_counts(stats, c);
}

// Enter the instance of instance row `row` (its w2o affine, row-major 3x4,
// in floats 0-11, its prototype's root at 12, its id at 13): r becomes the
// world ray (o, d) in the instance's object space, o' = M o + m and d' =
// M d (each dot product bvh_ray.cuh `dot_row`, as accel/bvh.py
// `object_rays` rounds it, so the refit meets the same winner), d' left
// unnormalised so that t keeps its world meaning; inst becomes its id.
// Returns the prototype's root row.
__device__ __forceinline__ int enter_instance(const float4* __restrict__ row,
                                              const float* __restrict__ o,
                                              const float* __restrict__ d, Ray& r, int& inst) {
  float4 q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __ldg(row + i);
  const float* m = reinterpret_cast<const float*>(q);
  const float ox = __ldg(o), oy = __ldg(o + 1), oz = __ldg(o + 2);
  const float dx = __ldg(d), dy = __ldg(d + 1), dz = __ldg(d + 2);
  float on[3], dn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    on[i] = pbrt_bvh::dot_row(m + 4 * i, ox, oy, oz) + m[4 * i + 3];
    dn[i] = pbrt_bvh::dot_row(m + 4 * i, dx, dy, dz);
  }
  r = pbrt_bvh::make_ray(on, dn);
  inst = (int)m[13];
  return (int)m[12];
}

// K1i / K1i-a: wide_kernel's loop over a two-level table (accel/bvh.py
// `build_two_level`): internal rows [0, n_int) (the top tree's, then each
// prototype's), instance rows [n_int, n_int + n_inst), then the leaf rows
// from leaf0 = n_int + n_inst (the top tree's, then each prototype's); leaf
// row leaf0 + c holds chunk c. inst_out receives the instance of each
// ray's winner (-1 for a top-level triangle or a miss); `stats` a fifth sum,
// the instance rows entered (BlockCounts);
// max_iters is the build's bound (a ray walks a prototype once for each
// instance it enters). The stack is a SplitStack of stack_depth entries,
// `near` of them in shared memory (launch with BLOCK * near * 6 bytes of
// it, and STATS 8 * COUNT_WORDS more before them; near >= WIDTH - 1 when it
// is less than stack_depth) and the rest
// in `far`, (stack_depth - near) int2 for each thread of the grid.
// Otherwise wide_kernel's contract and launch.
//
// An instance row is a third kind of row, visited in the internal phase:
// the lane moves its ray into the instance's object space
// (`enter_instance`), notes the stack level `base` and goes on at the
// prototype's root. pbrt forbids nested instances, so the entries below
// `base` are world rows and those at or above it the prototype's: a pop
// below `base` brings the world ray back, made again from o and d (no
// second Ray held in registers). Entry distances keep their meaning across
// spaces (d' unnormalised), so the stack's keys and pop's drop rule hold
// as they are. A leaf is tested with the ray of its own space: while a leaf
// is parked the lane visits internal rows of the same space only, and
// waits at an instance row or a row of the other space until the parked
// leaf has been tested; a hit there records the space's instance.
// The two-level kernel's work counts: the block's sums, 5 64-bit words at
// the start of its dynamic shared memory, each event an atomic add there,
// so that counting holds no register (five counts a lane pushed the
// counting instantiation past 80 registers); added to `stats` at the end.
extern __shared__ unsigned long long block_counts[];
constexpr int COUNT_WORDS = 5;

struct BlockCount {
  int i;
  __device__ __forceinline__ void operator++() const { atomicAdd(&block_counts[i], 1ull); }
  __device__ __forceinline__ void operator+=(bool b) const {
    if (b) atomicAdd(&block_counts[i], 1ull);
  }
};

struct BlockCounts {
  BlockCount nodes{0}, tris{1}, edge{2}, range{3}, inst{4};
};

template <bool ANY_HIT, bool STATS>
__global__ void __launch_bounds__(BLOCK, 6)
inst_wide_kernel(const float* __restrict__ rows, int n_int, int n_inst, int max_iters,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_max, int n_rays, float* __restrict__ t_out,
                 int* __restrict__ prim_out, int* __restrict__ inst_out,
                 int* __restrict__ overflow, int stack_depth, int near, int2* __restrict__ far,
                 unsigned long long* __restrict__ stats, unsigned* __restrict__ ticket) {
  extern __shared__ int stack_mem[];
  int* const stack0 = stack_mem + (STATS ? 2 * COUNT_WORDS : 0);
  SplitStack st{stack0 + threadIdx.x,
                reinterpret_cast<unsigned short*>(stack0 + BLOCK * near) + threadIdx.x, 0, near,
                0, stack_depth - near, far};
  if (STATS) {
    if (threadIdx.x < COUNT_WORDS) block_counts[threadIdx.x] = 0;
    __syncthreads();
  }
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  const int leaf0 = n_int + n_inst;
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  BlockCounts c;
  Ray r{};
  // inst: the instance whose object space r is in (-1: the world); base:
  // the stack level at its entry; hin: the instance of the best hit
  int ray = -1, cur = DONE, leaf = -1, prim = -1, hin = -1, inst = -1, base = 0, it = 0;
  float t_best = 0.f;
  bool exhausted = false;
  for (;;) {
    // ---- a finished lane writes its ray's result; idle lanes draw rays
    if (ray >= 0 && cur == DONE) {
      t_out[ray] = t_best;
      prim_out[ray] = prim;
      inst_out[ray] = hin;
      ray = -1;
    }
    unsigned idle = __ballot_sync(FULL, ray < 0);
    while (!exhausted && __popc(idle) >= REFILL) {
      const unsigned n = __popc(idle);
      unsigned first = 0;
      if (lane == 0) first = atomicAdd(ticket, n);
      first = __shfl_sync(FULL, first, 0);
      exhausted = first + n >= (unsigned)n_rays;
      const unsigned i = first + __popc(idle & below);
      if (ray < 0 && i < (unsigned)n_rays) {
        const float tm = t_max[i];
        if (tm > 0.f) {
          ray = (int)i;
          r = pbrt_bvh::make_ray(o + 3LL * i, d + 3LL * i);
          t_best = tm;
          prim = -1;
          hin = -1;
          inst = -1;
          cur = 0;
          st.clear();
          it = 0;
        } else {        // masked lane: a miss, at once
          t_out[i] = tm;
          prim_out[i] = -1;
          inst_out[i] = -1;
        }
      }
      idle = __ballot_sync(FULL, ray < 0);
    }
    if (idle == FULL) break;  // the loop above refills a fully idle warp until the rays run out

    // ---- internal and instance rows, until every lane has parked a leaf or
    // is done
    for (;;) {
      if (ray >= 0 && leaf < 0 && cur >= 0) {
        if (inst >= 0 && st.level() < base) {   // popped back to a world row
          if (cur < n_int || cur >= leaf0)   // (an instance row makes its own ray)
            r = pbrt_bvh::make_ray(o + 3LL * ray, d + 3LL * ray);
          inst = -1;
        }
        if (cur >= leaf0) {                // park the leaf, go on with the next entry
          leaf = cur;
          cur = pop<ANY_HIT>(st, t_best);
        }
      }
      // with a leaf parked, only the internal rows of the leaf's space
      const bool inner = ray >= 0 && cur >= 0 && cur < leaf0 &&
                         (leaf < 0 || (cur < n_int && (inst < 0 || st.level() >= base)));
      if (!__any_sync(FULL, inner) || __all_sync(FULL, ray < 0 || leaf >= 0 || cur == DONE))
        break;
      if (inner) {
        int next;
        if (it++ >= max_iters) {
          next = OVERFLOWED;
        } else if (cur >= n_int) {
          if (STATS) ++c.inst;
          next = enter_instance(rows4 + (long long)cur * ROW4, o + 3LL * ray, d + 3LL * ray, r,
                                inst);
          base = st.level();
        } else {
          if (STATS) ++c.nodes;
          next = visit_internal<ANY_HIT>(rows4 + (long long)cur * ROW4, r, t_best, st);
        }
        if (next == OVERFLOWED) {
          atomicAdd(overflow, 1);
          cur = DONE;
          leaf = -1;
        } else {
          cur = next;
        }
      }
    }
    // ---- the parked leaves, all together, each in its own space
    if (leaf >= 0) {
      if (it++ >= max_iters) {
        atomicAdd(overflow, 1);
        cur = DONE;
      } else if (test_leaf<ANY_HIT, STATS>(rows4 + (long long)leaf * ROW4, leaf - leaf0, r,
                                           t_best, prim, c)) {
        hin = inst;
        if (ANY_HIT) cur = DONE;
      }
      leaf = -1;
    }
  }
  if (STATS) {   // every warp of the block leaves the loop above
    __syncthreads();
    if (threadIdx.x < COUNT_WORDS) atomicAdd(stats + threadIdx.x, block_counts[threadIdx.x]);
  }
}

// Blocks of a persistent grid of `kernel` (BLOCK threads, a stack of
// stack_depth entries a thread): as many as fit on the card at once. The
// occupancy is read once per stack size into the caller's per_sm[MAX_STACK
// + 1] (one array per kernel), the SM count each launch.
inline int resident_blocks(const void* kernel, int* per_sm, int stack_depth) {
  if (per_sm[stack_depth] == 0) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         MAX_STACK * BLOCK * 6);
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, BLOCK,
                                                  (size_t)BLOCK * stack_depth * 6);
    per_sm[stack_depth] = n > 0 ? n : 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return per_sm[stack_depth] * sms;
}

}  // namespace pbrt_wide
