// BVH traversal with the watertight triangle test in the leaves, closest hit
// and any hit, for Hopper (sm_90a).
//
// Replaces the TPU hot path pbrt_tpu/accel/bvh.py:909 `_traverse` (with
// `make_stepper` :694, `_slab8` :592, `_stack_push/_pop` :623-636) and the
// leaf test pbrt_tpu/geometry/intersect.py:69 `_watertight_core` (via
// `leaf_block_presheared` :176 and `ray_shear` :155).
//
// Design: one thread per ray. The ray's shear constants (kz, sx, sy, sz) and
// 1/d are computed once, outside the loop. The per-ray state is the JAX
// stepper's: the current node, the bitmask of its children still to visit,
// and a stack of packed (node * 256 + child-mask) entries in local memory.
// A visit to an internal row slab-tests its 8 child boxes, descends into the
// nearest surviving child and pushes at most one entry: the single remaining
// sibling with a fresh mask, or (this node, remaining-mask) when two or more
// remain, which is re-culled against the shrunken t_best when popped. So the
// stack never holds more entries than the tree is deep (SceneMeta.bvh_depth).
// A leaf row holds 8 triangles; each goes through the watertight test against
// the current t_best and replaces the best hit only when strictly nearer, so
// the winner is the first nearest triangle: prim = chunk * 8 + k in leaf
// order, the same contract as the dense sweep of accel/bvh.py.
//
// Lanes with t_max <= 0 return a miss at once (masked shadow lanes). A lane
// that runs past 4 * n_rows + 16 iterations, or would overflow the stack,
// stops and adds one to `overflow`; a correct tree never does either.
//
// What bounds it on the H100: neither the bytes nor the operations of a
// single pass. The tree of the target scenes (~1 MB of rows) stays in the
// 50 MB L2, so row reads are L2 hits, and the operations per ray are a few
// thousand float ops; the cost is latency and divergence (a warp's lanes
// visit different nodes). This first version is plain and right; shared
// memory node caching, warp-cooperative traversal and ray sorting are later
// work. Build with --fmad=false so every float op rounds as the plain torch
// version's does: the watertight edge functions rely on it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "watertight.cuh"

namespace {

using pbrt_wt::INF_T;
using pbrt_wt::Shear;
using pbrt_wt::ray_shear;
using pbrt_wt::watertight;

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
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float tmax0 = t_max[r];
  float t_best = tmax0;
  int prim = -1;
  if (!(tmax0 > 0.f)) {
    t_out[r] = t_best;
    prim_out[r] = -1;
    return;
  }
  const Shear sh = ray_shear(dx, dy, dz);
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  int stack[MAX_STACK];
  int sp = 0;
  int cur = 0;
  int cmask = FRESH;
  const long long max_iters = 4LL * n_rows + 16;
  long long it = 0;
  bool bad = false;
  // work counts for `stats`: internal rows visited, triangle tests, and the
  // tests that passed the edge-sign test and the t-range test
  unsigned long long n_nodes = 0, n_tris = 0, n_edge = 0, n_range = 0;

  while (cur != DONE) {
    if (it++ >= max_iters) { bad = true; break; }
    const float* row = rows + (long long)cur * ROW_W;
    bool descend = false;
    int next = DONE;
    if (cur >= n_int) {
      // ---- leaf: 8 triangles
      const int chunk = cur - n_int;
      bool found = false;
      for (int k = 0; k < LEAF_K; ++k) {
        float t;
        int stage;
        ++n_tris;
        const bool hit = watertight(row + 9 * k, ox, oy, oz, sh, t_best, t, nullptr, &stage);
        n_edge += stage >= 1;
        n_range += stage >= 2;
        if (hit && t < t_best) {
          t_best = t;
          prim = chunk * LEAF_K + k;
          found = true;
          if (ANY_HIT) break;
        }
      }
      if (ANY_HIT && found) break;
    } else {
      // ---- internal: slab test of the 8 child boxes
      ++n_nodes;
      int best_slot = -1;
      float best_tn = INF_T;
      int hit_mask = 0;
      for (int s = 0; s < WIDTH; ++s) {
        const int child = (int)row[6 * WIDTH + s];
        if (child < 0 || !((cmask >> s) & 1)) continue;
        const float* b = row + 6 * s;
        if (!(b[0] <= b[3])) continue;  // empty slot: inverted box
        float t0x = (b[0] - ox) * ix, t1x = (b[3] - ox) * ix;
        float t0y = (b[1] - oy) * iy, t1y = (b[4] - oy) * iy;
        float t0z = (b[2] - oz) * iz, t1z = (b[5] - oz) * iz;
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
          if (sp >= stack_depth) { bad = true; break; }
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
  if (bad) atomicAdd(overflow, 1);
  if (stats) {
    atomicAdd(stats, n_nodes);
    atomicAdd(stats + 1, n_tris);
    atomicAdd(stats + 2, n_edge);
    atomicAdd(stats + 3, n_range);
  }
  t_out[r] = t_best;
  prim_out[r] = prim;
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
