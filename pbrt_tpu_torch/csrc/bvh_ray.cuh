// What the BVH traversal kernels share: the row layout's constants, a ray's
// constants for the slab and watertight tests, the work counts, and an
// instance's affine row (bvh_wide.cuh: K1/K1a and the two-level K1i/K1i-a;
// scene_shard.cu: K11a/K11b). Counterpart of the JAX traversal's
// per-ray set-up, pbrt_tpu/accel/bvh.py:585 `_safe_inv`, :592 `_slab8` and
// :654 `_StI` (the two-level state), and of
// pbrt_tpu/geometry/intersect.py:155 `ray_shear`.
// Build with --fmad=false so every float op rounds as the plain torch
// version's does: the watertight edge functions rely on it.
#pragma once

#include <cuda_runtime.h>

#include "watertight.cuh"

namespace pbrt_bvh {

using pbrt_wt::INF_T;
using pbrt_wt::Shear;

constexpr int LEAF_K = 8;    // triangles a leaf row
constexpr int WIDTH = 8;     // children an internal row
constexpr int ROW_W = 72;    // floats a row
// the slab test's widening of a box's far distance: 1 + 2 gamma(3)
constexpr float SLAB_WIDEN = (float)(1.0 + 2.0 * pbrt_wt::gamma_d(3));

__device__ __forceinline__ float safe_inv(float d) {
  float mag = fmaxf(fabsf(d), 1e-30f);
  return (d < 0.f ? -1.f : 1.f) / mag;
}

// A ray's constants, computed once per ray (and again in each space it
// enters): origin, 1/d for the slab tests and the shear of the watertight
// test.
struct Ray {
  float ox, oy, oz, ix, iy, iz;
  Shear sh;
};

__device__ __forceinline__ Ray make_ray(const float* o, const float* d) {
  Ray r;
  r.ox = o[0]; r.oy = o[1]; r.oz = o[2];
  r.sh = pbrt_wt::ray_shear(d[0], d[1], d[2]);
  r.ix = safe_inv(d[0]); r.iy = safe_inv(d[1]); r.iz = safe_inv(d[2]);
  return r;
}

// Work counts for the optional `stats` output: internal rows visited,
// triangle tests, the tests past the edge-sign and the t-range exits, and
// (two-level tables) the instance rows entered.
struct Counts {
  unsigned long long nodes = 0, tris = 0, edge = 0, range = 0, inst = 0;
};

// One row of M (3x4, row-major) times (x, y, z): a chain of fused
// multiply-adds, as XLA emits JAX's einsum and as accel/bvh.py
// `object_rays` rounds.
__device__ __forceinline__ float dot_row(const float* m, float x, float y, float z) {
  return __fmaf_rn(m[2], z, __fmaf_rn(m[1], y, m[0] * x));
}

// the first four sums (the fifth, instance entries, is the two-level
// kernel's own)
__device__ __forceinline__ void add_counts(unsigned long long* stats, const Counts& c) {
  if (!stats) return;
  atomicAdd(stats, c.nodes);
  atomicAdd(stats + 1, c.tris);
  atomicAdd(stats + 2, c.edge);
  atomicAdd(stats + 3, c.range);
}

}  // namespace pbrt_bvh
