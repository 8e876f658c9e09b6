// BVH traversal with the watertight triangle test in the leaves, closest hit
// and any hit, for Hopper (sm_90a).
//
// Replaces the TPU hot path pbrt_tpu/accel/bvh.py:909 `_traverse` (with its
// stepper :694, `_slab8` :592, `_stack_push/_pop` :623-636) and the leaf
// test pbrt_tpu/geometry/intersect.py:69 `_watertight_core` (via
// `leaf_block_presheared` :176 and `ray_shear` :155); and, as
// `pbrt_bvh_traverse_inst` (K1i), its two-level variant over instanced
// tables, the stepper of :794 (with `_StI` :654 and `_traverse` :940-952,
// :1131-1158), which also returns the instance of each hit.
//
// Three entry points:
//  - `pbrt_bvh_traverse` (K1, K1a): `wide_kernel` of bvh_wide.cuh, designed
//    for the H100 (whole-row 16-byte loads, one stack entry per pending
//    child in shared memory, persistent warps fed from a ticket, the
//    while-while loop); see that file.
//  - `pbrt_bvh_traverse_inst` (K1i, K1i-a): `inst_wide_kernel`, the same
//    loop over a two-level table, instance rows entered in the internal
//    phase (bvh_wide.cuh).
//  - `pbrt_bvh_refit`: the refit of a closest hit (pbrt_tpu/accel/
//    bvh.py:1170-1215): the winner's t and barycentrics recomputed by the
//    watertight test against its triangle, for an instanced winner with the
//    ray in its instance's object space (`_refit_ray`), one thread per ray,
//    so the hit record's glue is one launch on the card instead of the plain
//    version's eager ones (accel/bvh.py `refit_plain`, bit for bit). Bytes
//    bound it: a ray's o, d, t_max, winner and instance in, its t, winner
//    and barycentrics out, its triangle's 36 bytes and its instance's
//    affine.
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
// single pass. The tree of the target scenes (1-60 MB of rows) stays in the
// 50 MB L2 or nearly, so row reads are L2 (or L1) hits, and the operations
// per ray are a few thousand float ops; the cost is the latency of each
// row's loads and the divergence of a warp's lanes, which the wide loop
// answers (PERF.md). An instance entry adds two 3x4 transforms and a new
// shear to a ray's work, and a return to the world its shear again; the
// prototype's rows are shared by all its instances, so a two-level table
// stays in L2 where its flattened twin (4-5x the bytes) may not. Build with
// --fmad=false so every float op rounds as the plain torch version's does:
// the watertight edge functions rely on it (the object-space ray's fused
// multiply-adds are explicit, __fmaf_rn).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "bvh_ray.cuh"
#include "bvh_wide.cuh"

namespace {

// the refit: prim -1, or a triangle the test misses, gives a miss (t
// INFINITY, prim -1, barycentrics 0); inst (null on a single-level table):
// the winner's instance, whose object space the ray is moved into first, as
// inst_wide_kernel's `enter_instance` moves it (the same bits)
__global__ void __launch_bounds__(128)
refit_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
             const float* __restrict__ p2, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ t_max,
             const long long* __restrict__ prim, const long long* __restrict__ inst,
             const float* __restrict__ w2o, int n_rays, float* __restrict__ t_out,
             long long* __restrict__ prim_out, float* __restrict__ b_out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const long long p = prim[r];
  float t = pbrt_wt::INF_T, b[3] = {0.f, 0.f, 0.f};
  bool ok = false;
  if (p >= 0) {
    const float v[9] = {p0[3 * p], p0[3 * p + 1], p0[3 * p + 2], p1[3 * p], p1[3 * p + 1],
                        p1[3 * p + 2], p2[3 * p], p2[3 * p + 1], p2[3 * p + 2]};
    float ro[3] = {o[3 * r], o[3 * r + 1], o[3 * r + 2]};
    float rd[3] = {d[3 * r], d[3 * r + 1], d[3 * r + 2]};
    const long long k = inst ? inst[r] : -1;
    if (k >= 0) {
      const float* m = w2o + 12 * k;
      float on[3], dn[3];
      for (int i = 0; i < 3; ++i) {
        on[i] = pbrt_bvh::dot_row(m + 4 * i, ro[0], ro[1], ro[2]) + m[4 * i + 3];
        dn[i] = pbrt_bvh::dot_row(m + 4 * i, rd[0], rd[1], rd[2]);
      }
      for (int i = 0; i < 3; ++i) {
        ro[i] = on[i];
        rd[i] = dn[i];
      }
    }
    const pbrt_wt::Shear sh = pbrt_wt::ray_shear(rd[0], rd[1], rd[2]);
    float t_hit, b_hit[3];
    ok = pbrt_wt::watertight(v, ro[0], ro[1], ro[2], sh, t_max[r], t_hit, b_hit);
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

// the refit of n_rays closest hits on the current stream (accel/bvh.py
// refit_cuda); inst and w2o null on a single-level table
extern "C" int pbrt_bvh_refit(const float* p0, const float* p1, const float* p2, const float* o,
                              const float* d, const float* t_max, const long long* prim,
                              const long long* inst, const float* w2o, int n_rays,
                              float* t_out, long long* prim_out, float* b_out, void* stream) {
  if (n_rays <= 0) return 0;
  refit_kernel<<<(n_rays + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      p0, p1, p2, o, d, t_max, prim, inst, w2o, n_rays, t_out, prim_out, b_out);
  return (int)cudaGetLastError();
}

// the wide kernels' stack: entries a tree of `depth` needs, and the most
// they take
extern "C" int pbrt_bvh_wide_stack(int depth) { return pbrt_wide::stack_entries(depth); }
extern "C" int pbrt_bvh_wide_max_stack() { return pbrt_wide::MAX_STACK; }

namespace {

// K1i's stack entries a thread in shared memory (the rest in its scratch):
// six blocks of BLOCK threads an SM, the most its 80 registers allow
constexpr int NEAR_STACK = 42;

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

// blocks of K1i's persistent grid with `near` stack entries a thread in
// shared memory, the occupancy cached per kernel and stack size
template <bool ANY_HIT, bool STATS>
int inst_blocks(int near) {
  static int per_sm[pbrt_wide::MAX_STACK + 1] = {0};
  return pbrt_wide::resident_blocks((const void*)pbrt_wide::inst_wide_kernel<ANY_HIT, STATS>,
                                    per_sm, near);
}

template <bool ANY_HIT, bool STATS>
void launch_inst(const float* rows, int n_int, int n_inst, int max_iters, const float* o,
                 const float* d, const float* t_max, int n_rays, float* t_out, int* prim_out,
                 int* inst_out, int* overflow, int stack_depth, int2* far, long long far_ints,
                 unsigned long long* stats, unsigned* ticket, cudaStream_t s) {
  const int near = std::min(stack_depth, NEAR_STACK);
  int blocks = std::min(inst_blocks<ANY_HIT, STATS>(near),
                        (n_rays + pbrt_wide::BLOCK - 1) / pbrt_wide::BLOCK);
  if (stack_depth > near)
    blocks = (int)std::min<long long>(
        blocks, far_ints / (2LL * (stack_depth - near) * pbrt_wide::BLOCK));
  const size_t smem =
      (size_t)pbrt_wide::BLOCK * near * 6 + (STATS ? 8 * pbrt_wide::COUNT_WORDS : 0);
  pbrt_wide::inst_wide_kernel<ANY_HIT, STATS><<<blocks, pbrt_wide::BLOCK, smem, s>>>(
          rows, n_int, n_inst, max_iters, o, d, t_max, n_rays, t_out, prim_out, inst_out,
          overflow, stack_depth, near, far, stats, ticket);
}

// the arguments both entries check: 0 or a cudaError_t
int check_args(const float* rows, int stack_depth) {
  if (stack_depth > pbrt_wide::MAX_STACK || stack_depth < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)rows & 15) != 0) return (int)cudaErrorMisalignedAddress;
  return 0;
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
  if (int err = check_args(rows, stack_depth)) return err;
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

// the ints of K1i's spill scratch for a stack of stack_depth entries a
// thread: the entries past NEAR_STACK, an int2 each, for every thread of the
// largest grid its launches take on the current card (0 when none spill)
extern "C" long long pbrt_bvh_inst_far_ints(int stack_depth) {
  if (stack_depth <= NEAR_STACK) return 0;
  const int blocks = std::max(std::max(inst_blocks<false, false>(NEAR_STACK),
                                       inst_blocks<false, true>(NEAR_STACK)),
                              std::max(inst_blocks<true, false>(NEAR_STACK),
                                       inst_blocks<true, true>(NEAR_STACK)));
  return 2LL * (stack_depth - NEAR_STACK) * blocks * pbrt_wide::BLOCK;
}

// K1i / K1i-a on a two-level table (instance rows n_int .. n_int + n_inst -
// 1; bvh_wide.cuh inst_wide_kernel), on `stream`: pbrt_bvh_traverse's
// contract, stack and ticket, and inst_out receives each hit's instance (-1
// for a top-level triangle or a miss); `stats`, when not null, a fifth sum:
// the instance rows entered. A lane stops past max_iters rows (the build's
// bound, at most INT_MAX here). Of the stack's stack_depth entries a
// thread, the first NEAR_STACK lie in shared memory and the rest in `far`,
// far_ints ints of scratch (pbrt_bvh_inst_far_ints(stack_depth) of them;
// null when that is 0); the grid is cut to the threads it holds.
extern "C" int pbrt_bvh_traverse_inst(const float* rows, int n_int, int n_inst,
                                      long long max_iters, const float* o, const float* d,
                                      const float* t_max, int n_rays, float* t_out,
                                      int* prim_out, int* inst_out, int* overflow,
                                      int any_hit, int stack_depth, void* far,
                                      long long far_ints,
                                      void* stats, void* ticket, void* stream) {
  if (n_rays <= 0) return 0;
  if (int err = check_args(rows, stack_depth)) return err;
  if (stack_depth > NEAR_STACK &&
      (far == nullptr || far_ints < 2LL * (stack_depth - NEAR_STACK) * pbrt_wide::BLOCK))
    return (int)cudaErrorInvalidValue;
  auto* fa = (int2*)far;
  const int iters = (int)std::min<long long>(max_iters, INT_MAX);
  auto* st = (unsigned long long*)stats;
  auto* tk = (unsigned*)ticket;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit && st)
    launch_inst<true, true>(rows, n_int, n_inst, iters, o, d, t_max, n_rays, t_out, prim_out,
                            inst_out, overflow, stack_depth, fa, far_ints, st, tk, s);
  else if (any_hit)
    launch_inst<true, false>(rows, n_int, n_inst, iters, o, d, t_max, n_rays, t_out, prim_out,
                             inst_out, overflow, stack_depth, fa, far_ints, st, tk, s);
  else if (st)
    launch_inst<false, true>(rows, n_int, n_inst, iters, o, d, t_max, n_rays, t_out, prim_out,
                             inst_out, overflow, stack_depth, fa, far_ints, st, tk, s);
  else
    launch_inst<false, false>(rows, n_int, n_inst, iters, o, d, t_max, n_rays, t_out,
                              prim_out, inst_out, overflow, stack_depth, fa, far_ints, st, tk,
                              s);
  return (int)cudaGetLastError();
}
