// The single-level BVH traversal of K1 (closest hit) and K1a (any hit),
// designed for Hopper. Counterpart of pbrt_tpu/accel/bvh.py:909 `_traverse`
// (`make_stepper` :694, `_slab8` :592); it reads the same row table,
// bvh_rows, byte-identical to JAX's (accel/bvh.py: internal row i < n_int
// holds 8 child boxes [lo(3) hi(3)] and 8 child ids as floats; leaf row
// n_int + c holds the 8 triangles [p0 p1 p2] of chunk c). Every row is 288
// bytes, 18 float4, and 16-byte aligned when the table is.
//
// What it does about the costs of the stepper loop (bvh_stepper.cuh):
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
// Every float op rounds as the stepper's (build with --fmad=false): the slab
// test is the stepper's, the leaf test is csrc/watertight.cuh. A triangle
// replaces the best hit only when strictly nearer, so on an exact tie the
// winner may differ from the stepper's or the plain sweep's.
//
// Ray, make_ray, Counts and add_counts are the stepper's (bvh_stepper.cuh),
// shared with K1i and K11 while those stay on it.
#pragma once

#include <cuda_runtime.h>

#include "bvh_stepper.cuh"
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
};

// The next pending row, dropping those whose box starts at or beyond t_best
// (never for any hit: its bound does not shrink before it ends); DONE when
// none is left.
template <bool ANY_HIT>
__device__ __forceinline__ int pop(Stack& st, float t_best) {
  while (st.sp > 0) {
    --st.sp;
    const int id = st.ids[st.sp * BLOCK];
    if (ANY_HIT || __uint_as_float((unsigned)st.tns[st.sp * BLOCK] << 16) < t_best) return id;
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
template <bool ANY_HIT, bool SORT = !ANY_HIT, class Map = SameTable>
__device__ __forceinline__ int visit_internal(const float4* __restrict__ row, const Ray& r,
                                              float t_best, Stack& st, Map map = Map()) {
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
  if (st.sp + h - 1 > st.cap) return OVERFLOWED;
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
template <bool ANY_HIT, bool STATS, bool LEX = false>
__device__ __forceinline__ bool test_leaf(const float4* __restrict__ row, int chunk,
                                          const Ray& r, float& t_best, int& prim, Counts& c) {
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
