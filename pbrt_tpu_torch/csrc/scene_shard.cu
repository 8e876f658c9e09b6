// Scene-sharded traversal for Hopper (sm_90a): the closest hit and the any
// hit over the parts of a morton-split triangle soup that one rank holds,
// each part with its own wide BVH, and the selection of the winner among the
// ranks' candidate packs after their all_gather.
//
// Replaces the TPU hot paths pbrt_tpu/parallel/scene_shard.py:226
// `closest_hit_local` (K11a: the per-device `bvh._traverse` of the local
// sub-BVH, then an all_gather of the (R, 1 + 27 + 9) candidate pack and an
// argmin over the device axis) and :256 `any_hit_local` (K11b: the any-hit
// traversal and a pmax over the device axis).
//
// Design. K11a `bvh_closest_parts` and K11b `bvh_any_parts` run K1's loop
// (bvh_wide.cuh: persistent warps fed from a ticket, whole-row 16-byte
// loads, a shared-memory stack of 6-byte entries, the while-while loop with
// speculative traversal) over one id space: part p's row i is p * n_rows + i,
// top row j is n_parts * n_rows + j. The parts are the leaves of a top
// level: rows of the same layout whose slots hold the part boxes (each the
// union of its root row's child boxes, so it bounds its tree) or, past 8
// parts, the boxes of groups of 8 (parallel/scene_shard.py `top_rows`). A
// ray starts at the top root, so a part whose box it misses, or which
// starts beyond the nearest hit so far, is never read: the old loop read
// every part's root. Both visit the parts nearest first, and within a part
// as K1 does (`visit_internal`, the row's child ids mapped to the global
// ids; a part row's children add its part's base).
// A leaf's triangles get the key (global leaf row) * 8 + slot, and K11a
// keeps the least (t, key) (`test_leaf` LEX): the first part wins an exact
// tie, as jnp.argmin over the parts does (the order of the visits differs
// from the plain version's, so a tie that the range test or a box decides
// may still go the other way: verified ties, K1's criterion). K11a's lane
// writes its winner's pack row of 37 floats, t (inf on a miss) and recv[part,
// prim] (the 27-float hit record, then p0, p1, p2; zeros on a miss); K11b
// one byte. `shard_select` takes the all-gathered packs (W, R, 37) and
// writes, per ray, the row of the first rank with the least t: ranks hold
// contiguous part ranges, so that is the global argmin order. One thread per
// output float: a scan over the short rank axis and a coalesced copy.
//
// What bounds it on the H100: as K1, latency and divergence rather than
// bytes or operations (the parts' trees stay in the 50 MB L2); a pack row is
// written once. The select kernel moves (W + 1) x 148 bytes a ray and is
// bound by bytes. Built with --fmad=false, as K1.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bvh_ray.cuh"
#include "bvh_wide.cuh"

namespace {

using pbrt_wide::BLOCK;
using pbrt_wide::DONE;
using pbrt_wide::FULL;
using pbrt_wide::OVERFLOWED;
using pbrt_wide::REFILL;
using pbrt_wide::ROW4;

constexpr int REC_W = 36;        // recv row: 27-float tri_rec row, p0, p1, p2
constexpr int PACK_W = 1 + REC_W;
constexpr int THREADS = 128;

// a top row's slot k: part k's root when k < n_parts, else top row
// k - n_parts
struct TopChild {
  int n_parts, n_rows, top0;
  __device__ __forceinline__ int operator()(int k) const {
    return k < n_parts ? k * n_rows : top0 + (k - n_parts);
  }
};

// a part row's child: the same part's row
struct PartChild {
  int base;
  __device__ __forceinline__ int operator()(int c) const { return base + c; }
};

// K11a / K11b over rays [0, n_rays): rows (n_parts, n_rows, 72), top
// (n_top, 72) with its root last. pack_out (closest hit): the winner's row
// of 37 floats, written by the warp together (consecutive lanes, consecutive
// floats: one thread a row wrote 37 scattered floats and took 1.195 ms for
// 0.867 at cornell-mesh-shard8's first launch on the H100, PERF.md); hit_out
// (any hit): one byte. `ticket`, `overflow`, `stats` and the dynamic shared
// memory as wide_kernel's (bvh_wide.cuh); a lane stops past 4 * (n_parts *
// n_rows + n_top) + 16 rows. A ray starts at the top root; the top level's slots are
// visited nearest first for both (for the any hit too: 2.5 % faster than
// slot order at cornell-mesh-shard8's first launch on the H100, within 3 %
// either way on terrain-shard4's).
template <bool ANY_HIT, bool STATS>
__global__ void __launch_bounds__(BLOCK, 6)
parts_wide_kernel(const float* __restrict__ rows, int n_parts, int n_rows, int n_int,
                  const float* __restrict__ top, int n_top, const float* __restrict__ recv,
                  int n_recv, const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max, int n_rays, float* __restrict__ pack_out,
                  uint8_t* __restrict__ hit_out, int* __restrict__ overflow, int stack_depth,
                  unsigned long long* __restrict__ stats, unsigned* __restrict__ ticket) {
  extern __shared__ int stack_mem[];
  pbrt_wide::Stack st{stack_mem + threadIdx.x,
                      reinterpret_cast<unsigned short*>(stack_mem + BLOCK * stack_depth) +
                          threadIdx.x,
                      0, stack_depth};
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  const float4* top4 = reinterpret_cast<const float4*>(top);
  const int top0 = n_parts * n_rows;   // the first top row's id; < 2^31 / 72
  const TopChild top_child{n_parts, n_rows, top0};
  const int root = top0 + n_top - 1;
  const int max_iters = 4 * (top0 + n_top) + 16;
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  pbrt_bvh::Counts c;
  pbrt_bvh::Ray r{};
  // cur: the row to visit (DONE when the ray is finished); base: the first
  // row of cur's part; prim: the best hit's key, global leaf row * 8 + slot
  int ray = -1, cur = DONE, base = 0, leaf = -1, prim = -1, it = 0;
  float t_best = 0.f;
  bool exhausted = false;

  // go on at row `next`, base that of its part
  auto go = [&](int next) {
    cur = next;
    if (cur >= 0 && cur < top0 && (unsigned)(cur - base) >= (unsigned)n_rows)
      base = cur / n_rows * n_rows;
  };

  for (;;) {
    // ---- finished lanes write their ray's result; idle lanes draw rays
    if (ANY_HIT) {
      if (ray >= 0 && cur == DONE) {
        hit_out[ray] = prim >= 0;
        ray = -1;
      }
    } else {
      // the warp writes each finished row with consecutive lanes
      unsigned fin = __ballot_sync(FULL, ray >= 0 && cur == DONE);
      while (fin) {
        const int src = __ffs(fin) - 1;
        fin &= fin - 1;
        const int rr = __shfl_sync(FULL, ray, src);
        const int key = __shfl_sync(FULL, prim, src);
        const float tt = __shfl_sync(FULL, t_best, src);
        const int g = (key < 0 ? 0 : key) >> 3;   // a miss (key -1) reads no record
        const int part = g / n_rows;
        const float* rec = recv + ((long long)part * n_recv +
                                   (long long)(g - part * n_rows - n_int) * pbrt_bvh::LEAF_K +
                                   (key & 7)) * REC_W;
        float* out = pack_out + (long long)rr * PACK_W;
        for (int j = lane; j < PACK_W; j += 32)
          out[j] = key < 0 ? (j == 0 ? __int_as_float(0x7f800000) : 0.f)
                           : (j == 0 ? tt : __ldg(rec + j - 1));
      }
      if (ray >= 0 && cur == DONE) ray = -1;
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
        // a masked lane (t_max <= 0) is finished at once: a miss
        const float tm = t_max[i];
        ray = (int)i;
        prim = -1;
        cur = DONE;
        if (tm > 0.f) {
          r = pbrt_bvh::make_ray(o + 3LL * i, d + 3LL * i);
          t_best = tm;
          st.sp = 0;
          it = 0;
          base = 0;
          go(root);
        }
      }
      idle = __ballot_sync(FULL, ray < 0);
    }
    if (idle == FULL) break;  // the loop above refills a fully idle warp until the rays run out

    // ---- internal rows (top and part), until every lane has parked a leaf
    // or is done
    for (;;) {
      if (ray >= 0 && leaf < 0 && cur >= 0 && cur < top0 && cur - base >= n_int) {
        leaf = cur;   // park the leaf, go on with the next entry
        go(pbrt_wide::pop<ANY_HIT>(st, t_best));
      }
      const bool inner = ray >= 0 && cur >= 0 && (cur >= top0 || cur - base < n_int);
      if (!__any_sync(FULL, inner) || __all_sync(FULL, ray < 0 || leaf >= 0 || cur == DONE))
        break;
      if (inner) {
        if (STATS) ++c.nodes;
        int next;
        if (it++ >= max_iters)
          next = OVERFLOWED;
        else if (cur >= top0)
          next = pbrt_wide::visit_internal<ANY_HIT, true>(
              top4 + (long long)(cur - top0) * ROW4, r, t_best, st, top_child);
        else
          next = pbrt_wide::visit_internal<ANY_HIT, !ANY_HIT>(
              rows4 + (long long)cur * ROW4, r, t_best, st, PartChild{base});
        if (next == OVERFLOWED) {
          atomicAdd(overflow, 1);
          cur = DONE;
          leaf = -1;
        } else {
          go(next);
        }
      }
    }
    // ---- the parked leaves, all together
    if (leaf >= 0) {
      if (it++ >= max_iters) {
        atomicAdd(overflow, 1);
        cur = DONE;
      } else if (pbrt_wide::test_leaf<ANY_HIT, STATS, true>(rows4 + (long long)leaf * ROW4,
                                                            leaf, r, t_best, prim, c) &&
                 ANY_HIT) {
        cur = DONE;
      }
      leaf = -1;
    }
  }
  if (STATS) pbrt_bvh::add_counts(stats, c);
}

// One thread per output float: the threads of a ray's row each scan its
// ranks' t (the same few cache lines) and copy one element, so loads and
// stores are coalesced.
__global__ void __launch_bounds__(THREADS)
select_kernel(const float* __restrict__ packs, int n_ranks, int n_rays,
              float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)n_rays * PACK_W;
  if (i >= stride) return;
  const long long r = i / PACK_W;
  const float* row = packs + r * PACK_W;
  int best = 0;
  float t_best = row[0];
  for (int w = 1; w < n_ranks; ++w) {
    const float t = row[w * stride];
    if (t < t_best) { t_best = t; best = w; }
  }
  out[i] = packs[best * stride + i];
}

inline int blocks_for(long long n) { return (int)((n + THREADS - 1) / THREADS); }

template <bool ANY_HIT, bool STATS>
int launch_parts(const float* rows, int n_parts, int n_rows, int n_int, const float* top,
                 int n_top, const float* recv, int n_recv, const float* o, const float* d,
                 const float* t_max, int n_rays, float* pack_out, uint8_t* hit_out,
                 int* overflow, int stack_depth, unsigned long long* stats, unsigned* ticket,
                 cudaStream_t s) {
  static int per_sm[pbrt_wide::MAX_STACK + 1] = {0};
  const int blocks = std::min(
      pbrt_wide::resident_blocks((const void*)parts_wide_kernel<ANY_HIT, STATS>, per_sm,
                                 stack_depth),
      (n_rays + BLOCK - 1) / BLOCK);
  parts_wide_kernel<ANY_HIT, STATS><<<blocks, BLOCK, (size_t)BLOCK * stack_depth * 6, s>>>(
      rows, n_parts, n_rows, n_int, top, n_top, recv, n_recv, o, d, t_max, n_rays, pack_out,
      hit_out, overflow, stack_depth, stats, ticket);
  return (int)cudaGetLastError();
}

// the arguments both entries check: 0 or a cudaError_t
int check_args(const float* rows, const float* top, const float* recv, int stack_depth) {
  if (stack_depth > pbrt_wide::MAX_STACK || stack_depth < 1) return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)rows | (uintptr_t)top | (uintptr_t)recv) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

// Each launcher runs on `stream` and returns the cudaError_t of the launch
// (0 on success). rows: (n_parts, n_rows, 72) float32, one tree per part
// with the common internal-row boundary n_int; top: (n_top, 72), the top
// level over the parts, its root last; recv: (n_parts, n_recv, 36) float32;
// rows, top and recv 16-byte aligned; o, d: (n_rays, 3); t_max: (n_rays,).
// `stack_depth` entries a thread (bvh_wide.cuh stack_entries of the top
// level's depth plus the parts', at most its MAX_STACK). `ticket`: one
// uint32 word of this launch's own, zero (its memset enqueued on `stream`
// before the launch). `stats`, when not null, receives K1's four work sums,
// the top level's visits counted as internal rows.
extern "C" int pbrt_bvh_closest_parts(const float* rows, int n_parts, int n_rows, int n_int,
                                      const float* top, int n_top, const float* recv,
                                      int n_recv, const float* o, const float* d,
                                      const float* t_max, int n_rays, float* pack_out,
                                      int* overflow, int stack_depth, void* stats, void* ticket,
                                      void* stream) {
  if (n_rays <= 0) return 0;
  if (int err = check_args(rows, top, recv, stack_depth)) return err;
  auto* st = (unsigned long long*)stats;
  auto* tk = (unsigned*)ticket;
  cudaStream_t s = (cudaStream_t)stream;
  return st ? launch_parts<false, true>(
                  rows, n_parts, n_rows, n_int, top, n_top, recv, n_recv, o, d, t_max, n_rays,
                  pack_out, nullptr, overflow, stack_depth, st, tk, s)
            : launch_parts<false, false>(
                  rows, n_parts, n_rows, n_int, top, n_top, recv, n_recv, o, d, t_max, n_rays,
                  pack_out, nullptr, overflow, stack_depth, st, tk, s);
}

extern "C" int pbrt_bvh_any_parts(const float* rows, int n_parts, int n_rows, int n_int,
                                  const float* top, int n_top, const float* o, const float* d,
                                  const float* t_max, int n_rays, uint8_t* hit_out,
                                  int* overflow, int stack_depth, void* stats, void* ticket,
                                  void* stream) {
  if (n_rays <= 0) return 0;
  if (int err = check_args(rows, top, rows, stack_depth)) return err;
  auto* st = (unsigned long long*)stats;
  auto* tk = (unsigned*)ticket;
  cudaStream_t s = (cudaStream_t)stream;
  return st ? launch_parts<true, true>(
                  rows, n_parts, n_rows, n_int, top, n_top, nullptr, 0, o, d, t_max, n_rays,
                  nullptr, hit_out, overflow, stack_depth, st, tk, s)
            : launch_parts<true, false>(
                  rows, n_parts, n_rows, n_int, top, n_top, nullptr, 0, o, d, t_max, n_rays,
                  nullptr, hit_out, overflow, stack_depth, st, tk, s);
}

// packs: (n_ranks, n_rays, 37) float32 -> out (n_rays, 37)
extern "C" int pbrt_shard_select(const float* packs, int n_ranks, int n_rays, float* out,
                                 void* stream) {
  if (n_rays <= 0) return 0;
  select_kernel<<<blocks_for((long long)n_rays * PACK_W), THREADS, 0, (cudaStream_t)stream>>>(
      packs, n_ranks, n_rays, out);
  return (int)cudaGetLastError();
}
