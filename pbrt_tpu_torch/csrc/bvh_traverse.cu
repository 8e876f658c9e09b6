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
// Design: one thread per ray. The ray's shear constants (kz, sx, sy, sz) and
// 1/d are computed once, outside the loop; the loop itself is the stepper of
// bvh_stepper.cuh (the JAX stepper's node, child-mask and stack state),
// shared with the scene-sharded part traversal of scene_shard.cu. A leaf
// triangle replaces the best hit only when strictly nearer, so the winner is
// the first nearest triangle: prim = chunk * 8 + k in leaf order, the same
// contract as the dense sweep of accel/bvh.py.
//
// Lanes with t_max <= 0 return a miss at once (masked shadow lanes). A lane
// that runs past 4 * n_rows + 16 iterations (K1i: the bound the two-level
// build computes), or would overflow the stack, stops and adds one to
// `overflow`; a correct tree never does either.
//
// What bounds it on the H100: neither the bytes nor the operations of a
// single pass. The tree of the target scenes (~1 MB of rows) stays in the
// 50 MB L2, so row reads are L2 hits, and the operations per ray are a few
// thousand float ops; the cost is latency and divergence (a warp's lanes
// visit different nodes). This first version is plain and right; shared
// memory node caching, warp-cooperative traversal and ray sorting are later
// work. K1i is the same loop with the INSTANCED flag: an instance entry adds
// two 3x4 transforms and a new shear to a ray's work, and the prototype's
// rows are shared by all its instances, so a two-level table stays in L2
// where its flattened twin (4-5x the bytes) may not. Build with
// --fmad=false so every float op rounds as the plain torch version's does:
// the watertight edge functions rely on it (the object-space ray's fused
// multiply-adds are explicit, __fmaf_rn).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_stepper.cuh"

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

}  // namespace

extern "C" int pbrt_bvh_max_stack() { return MAX_STACK; }

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// `stats`, when not null, receives four sums over the rays (for the
// operation count): the internal rows visited, the leaf triangles tested,
// and of those the ones past the edge-sign test and past the t-range test.
extern "C" int pbrt_bvh_traverse(const float* rows, int n_rows, int n_int,
                                 const float* o, const float* d,
                                 const float* t_max, int n_rays, float* t_out,
                                 int* prim_out, int* overflow, int any_hit,
                                 int stack_depth, void* stats, void* stream) {
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
