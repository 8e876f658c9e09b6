// The traversal loop of one ray through one wide BVH, shared by the BVH
// kernel (bvh_traverse.cu, K1/K1a), its two-level variant (K1i, the
// INSTANCED flag) and the scene-sharded part traversal (scene_shard.cu,
// K11a/K11b). Counterpart of the JAX steppers, pbrt_tpu/accel/bvh.py:694
// `make_stepper` and :794 `make_stepper_inst` (`_slab8` :592,
// `_stack_push/_pop` :623-636, `_StI` :654).
//
// The per-ray state is the JAX stepper's: the current node, the bitmask of
// its children still to visit, and a stack of packed (node * 256 +
// child-mask) entries in local memory. A visit to an internal row slab-tests
// its 8 child boxes, descends into the nearest surviving child and pushes at
// most one entry: the single remaining sibling with a fresh mask, or (this
// node, remaining-mask) when two or more remain, which is re-culled against
// the shrunken t_best when popped. So the stack never holds more entries
// than the tree is deep. A leaf row holds 8 triangles; each goes through the
// watertight test against the current t_best and replaces the best hit only
// when strictly nearer, so the winner is the first nearest triangle met.
// Build with --fmad=false so every float op rounds as the plain torch
// version's does: the watertight edge functions rely on it.
//
// INSTANCED: the table is [internal < n_int | instance < L0 = n_int + n_inst
// | leaf] (accel/bvh.py `build_two_level`). An instance row holds its w2o
// affine (12 floats, row-major 3x4), its prototype's root at [12] and its
// instance id at [13]. Visiting it moves the ray into the instance's object
// space, pushes a RESTORE entry (that row with child-mask 0, a mask no
// ordinary push produces) and descends into the prototype's tree; popping
// the RESTORE entry brings back the world ray. pbrt forbids nested
// instances, so the stack never saves a ray. The object-space direction is
// not normalised, so t_best keeps its world meaning across spaces. A best
// hit records the instance it was found in (hin), set where prim is set:
// two instances of one prototype share its leaf rows, so prim alone cannot
// tell them apart.
#pragma once

#include <cuda_runtime.h>

#include "watertight.cuh"

namespace pbrt_bvh {

using pbrt_wt::INF_T;
using pbrt_wt::Shear;

constexpr int LEAF_K = 8;
constexpr int WIDTH = 8;
constexpr int ROW_W = 72;
constexpr int MAX_STACK = 64;
constexpr int DONE = -1;
constexpr int FRESH = (1 << WIDTH) - 1;
constexpr float SLAB_WIDEN = (float)(1.0 + 2.0 * pbrt_wt::gamma_d(3));

__device__ __forceinline__ float safe_inv(float d) {
  float mag = fmaxf(fabsf(d), 1e-30f);
  return (d < 0.f ? -1.f : 1.f) / mag;
}

// A ray's constants, computed once per ray: origin, 1/d for the slab tests
// and the shear of the watertight test.
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
// (INSTANCED) the instance rows entered.
struct Counts {
  unsigned long long nodes = 0, tris = 0, edge = 0, range = 0, inst = 0;
};

// The two-level state of an INSTANCED traversal beside the world Ray: the
// instance rows, the build's iteration bound (a ray walks a prototype's rows
// once per instance it enters, so 4 * n_rows + 16 does not bound it), the
// world direction, and the instance of the best hit.
struct Inst {
  int n_inst;
  long long max_iters;
  float dx, dy, dz;
  int hin;
};

// One row of M (3x4, row-major) times (x, y, z): a chain of fused
// multiply-adds, as XLA emits JAX's einsum and as accel/bvh.py
// `object_rays` rounds.
__device__ __forceinline__ float dot_row(const float* m, float x, float y, float z) {
  return __fmaf_rn(m[2], z, __fmaf_rn(m[1], y, m[0] * x));
}

__device__ __forceinline__ void add_counts(unsigned long long* stats, const Counts& c) {
  if (!stats) return;
  atomicAdd(stats, c.nodes);
  atomicAdd(stats + 1, c.tris);
  atomicAdd(stats + 2, c.edge);
  atomicAdd(stats + 3, c.range);
}

// Traverse the tree `rows` (n_rows rows of ROW_W floats; internal rows below
// n_int, leaf chunk c at row n_int + c, or at n_int + n_inst + c INSTANCED)
// from its root. t_best enters as the ray's upper bound and leaves as the
// nearest hit's t; prim is set to that hit's leaf-order index (chunk *
// LEAF_K + k) and left alone when nothing is nearer than t_best on entry.
// ANY_HIT stops at the first hit. Returns false when the ray ran past 4 *
// n_rows + 16 iterations (INSTANCED: in->max_iters) or would overflow the
// stack of stack_depth entries (a correct tree never does either).
template <bool ANY_HIT, bool INSTANCED = false>
__device__ __forceinline__ bool traverse(const float* __restrict__ rows, int n_rows,
                                         int n_int, const Ray& ray, int stack_depth,
                                         float& t_best, int& prim, Counts& c,
                                         Inst* in = nullptr) {
  int stack[MAX_STACK];
  int sp = 0;
  int cur = 0;
  int cmask = FRESH;
  const long long max_iters = INSTANCED ? in->max_iters : 4LL * n_rows + 16;
  const int leaf0 = INSTANCED ? n_int + in->n_inst : n_int;
  Ray cr = ray;                          // INSTANCED: the ray of the current space
  const Ray& r = INSTANCED ? cr : ray;
  int inst = -1;                         // INSTANCED: the current instance
  long long it = 0;
  while (cur != DONE) {
    if (it++ >= max_iters) return false;
    const float* row = rows + (long long)cur * ROW_W;
    bool descend = false;
    int next = DONE;
    if (INSTANCED && cmask == 0) {
      // ---- RESTORE: the instance's tree is done; back to the world ray
      cr = ray;
      inst = -1;
    } else if (cur >= leaf0) {
      // ---- leaf: 8 triangles
      const int chunk = cur - leaf0;
      bool found = false;
      for (int k = 0; k < LEAF_K; ++k) {
        float t;
        int stage;
        ++c.tris;
        const bool hit = pbrt_wt::watertight(row + 9 * k, r.ox, r.oy, r.oz, r.sh,
                                             t_best, t, nullptr, &stage);
        c.edge += stage >= 1;
        c.range += stage >= 2;
        if (hit && t < t_best) {
          t_best = t;
          prim = chunk * LEAF_K + k;
          if (INSTANCED) in->hin = inst;
          found = true;
          if (ANY_HIT) break;
        }
      }
      if (ANY_HIT && found) return true;
    } else if (INSTANCED && cur >= n_int) {
      // ---- instance row: enter its object space, RESTORE pushed
      ++c.inst;
      if (sp >= stack_depth) return false;
      stack[sp++] = cur * 256;
      float o[3], d[3];
      for (int i = 0; i < 3; ++i) {
        o[i] = dot_row(row + 4 * i, ray.ox, ray.oy, ray.oz) + row[4 * i + 3];
        d[i] = dot_row(row + 4 * i, in->dx, in->dy, in->dz);
      }
      cr = make_ray(o, d);
      inst = (int)row[13];
      descend = true;
      next = (int)row[12];
    } else {
      // ---- internal: slab test of the 8 child boxes
      ++c.nodes;
      int best_slot = -1;
      float best_tn = INF_T;
      int hit_mask = 0;
      for (int s = 0; s < WIDTH; ++s) {
        const int child = (int)row[6 * WIDTH + s];
        if (child < 0 || !((cmask >> s) & 1)) continue;
        const float* b = row + 6 * s;
        if (!(b[0] <= b[3])) continue;  // empty slot: inverted box
        float t0x = (b[0] - r.ox) * r.ix, t1x = (b[3] - r.ox) * r.ix;
        float t0y = (b[1] - r.oy) * r.iy, t1y = (b[4] - r.oy) * r.iy;
        float t0z = (b[2] - r.oz) * r.iz, t1z = (b[5] - r.oz) * r.iz;
        float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
        float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
        tf = tf * SLAB_WIDEN;
        tn = fmaxf(tn, 0.f);
        if (tn <= tf && tf > 0.f && tn < t_best) {
          hit_mask |= 1 << s;
          if (tn < best_tn) { best_tn = tn; best_slot = s; }
        }
      }
      if (best_slot >= 0) {
        descend = true;
        next = (int)row[6 * WIDTH + best_slot];
        const int rem = hit_mask & ~(1 << best_slot);
        if (rem) {
          int push;
          if ((rem & (rem - 1)) == 0) {  // one sibling left: push it fresh
            push = (int)row[6 * WIDTH + (__ffs(rem) - 1)] * 256 + FRESH;
          } else {                       // revisit this node later, re-culled
            push = cur * 256 + rem;
          }
          if (sp >= stack_depth) return false;
          stack[sp++] = push;
        }
      }
    }
    if (descend) {
      cur = next;
      cmask = FRESH;
    } else if (sp > 0) {
      const int e = stack[--sp];
      cur = e >> 8;
      cmask = e & 255;
    } else {
      cur = DONE;
    }
  }
  return true;
}

}  // namespace pbrt_bvh
