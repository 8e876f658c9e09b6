// BVH traversal with the watertight triangle test in the leaves, closest hit
// and any hit, for Hopper (sm_90a).
//
// Replaces the TPU hot path pbrt_tpu/accel/bvh.py:909 `_traverse` (with
// `make_stepper` :694, `_slab8` :592, `_stack_push/_pop` :623-636) and the
// leaf test pbrt_tpu/geometry/intersect.py:69 `_watertight_core` (via
// `leaf_block_presheared` :176 and `ray_shear` :155); and, as
// `pbrt_bvh_traverse_inst` (K1i), its two-level variant over instanced
// tables, `make_stepper_inst` :794 (with `_StI` :654 and `_traverse`
// :940-952, :1131-1158), which also returns the instance of each hit.
//
// Four entry points:
//  - `pbrt_bvh_traverse` (K1, K1a): the kernel of bvh_wide.cuh, designed for
//    the H100 (whole-row 16-byte loads, one stack entry per pending child in
//    shared memory, persistent warps fed from a ticket, the while-while
//    loop); see that file.
//  - `pbrt_bvh_traverse_inst` (K1i): the stepper loop of bvh_stepper.cuh with
//    the INSTANCED flag, one thread per ray.
//  - `pbrt_bvh_traverse_stepper`: the same stepper loop on a single-level
//    table, one thread per ray, as K1 ran before the redesign. It is a
//    yardstick for the new kernel, never on the render path; it goes when
//    K1i and K11 leave the stepper.
//  - `pbrt_bvh_refit`: the refit of a closest hit (pbrt_tpu/accel/
//    bvh.py:1193-1215): the winner's t and barycentrics recomputed by the
//    watertight test against its triangle, one thread per ray, so the hit
//    record's glue is one launch on the card instead of the plain
//    version's ~130 eager ones (accel/bvh.py `refit_plain`, bit for bit).
//    Bytes bound it: a ray's o, d, t_max and winner in, its t, winner and
//    barycentrics out, and its triangle's 36 bytes.
// A leaf triangle replaces the best hit only when strictly nearer, so the
// winner is the first nearest triangle met: prim = chunk * 8 + k in leaf
// order, the contract of the dense sweep of accel/bvh.py.
//
// Lanes with t_max <= 0 return a miss at once (masked shadow lanes). A lane
// that runs past 4 * n_rows + 16 rows (K1i: the bound the two-level build
// computes), or would overflow its stack, stops and adds one to `overflow`;
// a correct tree never does either.
//
// What bounds it on the H100: neither the bytes nor the operations of a
// single pass. The tree of the target scenes (1-6 MB of rows) stays in the
// 50 MB L2, so row reads are L2 (or L1) hits, and the operations per ray
// are a few thousand float ops; the cost is the latency of each row's loads
// and the divergence of a warp's lanes. The stepper loop reads a row one
// float at a time and re-reads a node for each later sibling, keeps its
// stack in local memory and holds a warp until its slowest ray ends; the
// wide kernel is the answer to those (PERF.md). K1i is the stepper loop
// with the INSTANCED flag: an instance entry adds two 3x4 transforms and a
// new shear to a ray's work, and the prototype's rows are shared by all its
// instances, so a two-level table stays in L2 where its flattened twin
// (4-5x the bytes) may not. Build with --fmad=false so every float op rounds
// as the plain torch version's does: the watertight edge functions rely on
// it (the object-space ray's fused multiply-adds are explicit, __fmaf_rn).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bvh_stepper.cuh"
#include "bvh_wide.cuh"

namespace {

using pbrt_bvh::MAX_STACK;

template <bool ANY_HIT>
__global__ void __launch_bounds__(128)
traverse_kernel(const float* __restrict__ rows, int n_rows, int n_int,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t_max, int n_rays,
                float* __restrict__ t_out, int* __restrict__ prim_out,
                int* __restrict__ overflow, int stack_depth,
                unsigned long long* __restrict__ stats) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  float t_best = t_max[r];
  int prim = -1;
  if (!(t_best > 0.f)) {
    t_out[r] = t_best;
    prim_out[r] = -1;
    return;
  }
  const pbrt_bvh::Ray ray = pbrt_bvh::make_ray(o + 3 * r, d + 3 * r);
  pbrt_bvh::Counts c;
  if (!pbrt_bvh::traverse<ANY_HIT>(rows, n_rows, n_int, ray, stack_depth, t_best, prim, c))
    atomicAdd(overflow, 1);
  pbrt_bvh::add_counts(stats, c);
  t_out[r] = t_best;
  prim_out[r] = prim;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(128)
traverse_inst_kernel(const float* __restrict__ rows, int n_rows, int n_int, int n_inst,
                     long long max_iters, const float* __restrict__ o,
                     const float* __restrict__ d, const float* __restrict__ t_max,
                     int n_rays, float* __restrict__ t_out, int* __restrict__ prim_out,
                     int* __restrict__ inst_out, int* __restrict__ overflow, int stack_depth,
                     unsigned long long* __restrict__ stats) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  float t_best = t_max[r];
  int prim = -1;
  pbrt_bvh::Inst in{n_inst, max_iters, d[3 * r], d[3 * r + 1], d[3 * r + 2], -1};
  if (t_best > 0.f) {
    const pbrt_bvh::Ray ray = pbrt_bvh::make_ray(o + 3 * r, d + 3 * r);
    pbrt_bvh::Counts c;
    if (!pbrt_bvh::traverse<ANY_HIT, true>(rows, n_rows, n_int, ray, stack_depth, t_best,
                                            prim, c, &in))
      atomicAdd(overflow, 1);
    pbrt_bvh::add_counts(stats, c);
    if (stats) atomicAdd(stats + 4, c.inst);
  }
  t_out[r] = t_best;
  prim_out[r] = prim;
  inst_out[r] = in.hin;
}

// the refit: prim -1, or a triangle the test misses, gives a miss (t
// INFINITY, prim -1, barycentrics 0)
__global__ void __launch_bounds__(128)
refit_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
             const float* __restrict__ p2, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ t_max,
             const long long* __restrict__ prim, int n_rays, float* __restrict__ t_out,
             long long* __restrict__ prim_out, float* __restrict__ b_out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const long long p = prim[r];
  float t = pbrt_wt::INF_T, b[3] = {0.f, 0.f, 0.f};
  bool ok = false;
  if (p >= 0) {
    const float v[9] = {p0[3 * p], p0[3 * p + 1], p0[3 * p + 2], p1[3 * p], p1[3 * p + 1],
                        p1[3 * p + 2], p2[3 * p], p2[3 * p + 1], p2[3 * p + 2]};
    const pbrt_wt::Shear sh = pbrt_wt::ray_shear(d[3 * r], d[3 * r + 1], d[3 * r + 2]);
    float t_hit, b_hit[3];
    ok = pbrt_wt::watertight(v, o[3 * r], o[3 * r + 1], o[3 * r + 2], sh, t_max[r], t_hit,
                             b_hit);
    if (ok) {
      t = t_hit;
      b[0] = b_hit[0];
      b[1] = b_hit[1];
      b[2] = b_hit[2];
    }
  }
  t_out[r] = t;
  prim_out[r] = ok ? p : -1;
  b_out[3 * r] = b[0];
  b_out[3 * r + 1] = b[1];
  b_out[3 * r + 2] = b[2];
}

}  // namespace

// the refit of n_rays closest hits on the current stream (accel/bvh.py refit_cuda)
extern "C" int pbrt_bvh_refit(const float* p0, const float* p1, const float* p2, const float* o,
                              const float* d, const float* t_max, const long long* prim,
                              int n_rays, float* t_out, long long* prim_out, float* b_out,
                              void* stream) {
  if (n_rays <= 0) return 0;
  refit_kernel<<<(n_rays + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      p0, p1, p2, o, d, t_max, prim, n_rays, t_out, prim_out, b_out);
  return (int)cudaGetLastError();
}

// the stepper's stack bound (K1i and the yardstick: depth + 2 entries)
extern "C" int pbrt_bvh_max_stack() { return MAX_STACK; }

// the wide kernel's: entries a tree of `depth` needs, and the most it takes
extern "C" int pbrt_bvh_wide_stack(int depth) { return pbrt_wide::stack_entries(depth); }
extern "C" int pbrt_bvh_wide_max_stack() { return pbrt_wide::MAX_STACK; }

namespace {

// blocks of the persistent grid (bvh_wide.cuh resident_blocks), the
// occupancy cached per kernel and stack size
template <bool ANY_HIT, bool STATS>
int wide_blocks(int stack_depth) {
  static int per_sm[pbrt_wide::MAX_STACK + 1] = {0};
  return pbrt_wide::resident_blocks((const void*)pbrt_wide::wide_kernel<ANY_HIT, STATS>,
                                    per_sm, stack_depth);
}

template <bool ANY_HIT, bool STATS>
void launch_wide(const float* rows, int n_rows, int n_int, const float* o, const float* d,
                 const float* t_max, int n_rays, float* t_out, int* prim_out, int* overflow,
                 int stack_depth, unsigned long long* stats, unsigned* ticket,
                 cudaStream_t s) {
  const size_t smem = (size_t)pbrt_wide::BLOCK * stack_depth * 6;
  const int blocks = std::min(wide_blocks<ANY_HIT, STATS>(stack_depth),
                              (n_rays + pbrt_wide::BLOCK - 1) / pbrt_wide::BLOCK);
  pbrt_wide::wide_kernel<ANY_HIT, STATS><<<blocks, pbrt_wide::BLOCK, smem, s>>>(
      rows, n_rows, n_int, o, d, t_max, n_rays, t_out, prim_out, overflow, stack_depth, stats,
      ticket);
}

}  // namespace

// K1 / K1a, the wide kernel (bvh_wide.cuh), on `stream`; returns the
// cudaError_t of the launch (0 on success). `stack_depth` entries a thread
// (pbrt_bvh_wide_stack of the tree's depth). `ticket`: one uint32 word of
// this launch's own, zero (enqueue its memset on `stream` before the
// launch; two launches in flight must not share it). `stats`, when not null,
// receives four sums over the rays (for the operation count): the internal
// rows read, the leaf triangles tested, and of those the ones past the
// edge-sign test and past the t-range test (a kernel that counts; without
// `stats` one that does not).
extern "C" int pbrt_bvh_traverse(const float* rows, int n_rows, int n_int, const float* o,
                                 const float* d, const float* t_max, int n_rays, float* t_out,
                                 int* prim_out, int* overflow, int any_hit, int stack_depth,
                                 void* stats, void* ticket, void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_depth > pbrt_wide::MAX_STACK || stack_depth < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)rows & 15) != 0) return (int)cudaErrorMisalignedAddress;
  auto* st = (unsigned long long*)stats;
  auto* tk = (unsigned*)ticket;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit && st)
    launch_wide<true, true>(rows, n_rows, n_int, o, d, t_max, n_rays, t_out, prim_out, overflow,
                            stack_depth, st, tk, s);
  else if (any_hit)
    launch_wide<true, false>(rows, n_rows, n_int, o, d, t_max, n_rays, t_out, prim_out,
                             overflow, stack_depth, st, tk, s);
  else if (st)
    launch_wide<false, true>(rows, n_rows, n_int, o, d, t_max, n_rays, t_out, prim_out,
                             overflow, stack_depth, st, tk, s);
  else
    launch_wide<false, false>(rows, n_rows, n_int, o, d, t_max, n_rays, t_out, prim_out,
                              overflow, stack_depth, st, tk, s);
  return (int)cudaGetLastError();
}

// The yardstick: the stepper loop on a single-level table, one thread per
// ray (K1 before the redesign), on `stream`; the same contract and `stats`
// as pbrt_bvh_traverse, with a stack of depth + 2 entries.
extern "C" int pbrt_bvh_traverse_stepper(const float* rows, int n_rows, int n_int,
                                         const float* o, const float* d, const float* t_max,
                                         int n_rays, float* t_out, int* prim_out, int* overflow,
                                         int any_hit, int stack_depth, void* stats,
                                         void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_depth > MAX_STACK || stack_depth < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    traverse_kernel<true><<<blocks, threads, 0, s>>>(
        rows, n_rows, n_int, o, d, t_max, n_rays, t_out, prim_out, overflow,
        stack_depth, (unsigned long long*)stats);
  } else {
    traverse_kernel<false><<<blocks, threads, 0, s>>>(
        rows, n_rows, n_int, o, d, t_max, n_rays, t_out, prim_out, overflow,
        stack_depth, (unsigned long long*)stats);
  }
  return (int)cudaGetLastError();
}

// K1i on a two-level table (instance rows n_int .. n_int + n_inst - 1),
// launched on `stream`; inst_out receives each hit's instance (-1 for a
// static triangle or a miss) and `stats`, when not null, a fifth sum: the
// instance rows entered.
extern "C" int pbrt_bvh_traverse_inst(const float* rows, int n_rows, int n_int, int n_inst,
                                      long long max_iters, const float* o, const float* d,
                                      const float* t_max, int n_rays, float* t_out,
                                      int* prim_out, int* inst_out, int* overflow,
                                      int any_hit, int stack_depth, void* stats,
                                      void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_depth > MAX_STACK || stack_depth < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    traverse_inst_kernel<true><<<blocks, threads, 0, s>>>(
        rows, n_rows, n_int, n_inst, max_iters, o, d, t_max, n_rays, t_out, prim_out,
        inst_out, overflow, stack_depth, (unsigned long long*)stats);
  } else {
    traverse_inst_kernel<false><<<blocks, threads, 0, s>>>(
        rows, n_rows, n_int, n_inst, max_iters, o, d, t_max, n_rays, t_out, prim_out,
        inst_out, overflow, stack_depth, (unsigned long long*)stats);
  }
  return (int)cudaGetLastError();
}
