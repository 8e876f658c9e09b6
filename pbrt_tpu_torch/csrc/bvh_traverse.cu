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

namespace {

constexpr int LEAF_K = 8;
constexpr int WIDTH = 8;
constexpr int ROW_W = 72;
constexpr int MAX_STACK = 64;
constexpr int DONE = -1;
constexpr int FRESH = (1 << WIDTH) - 1;

constexpr double MACHINE_EPSILON = 5.9604644775390625e-08;  // float eps / 2
constexpr double gamma_d(int n) {
  return (n * MACHINE_EPSILON) / (1 - n * MACHINE_EPSILON);
}
constexpr float G2 = (float)gamma_d(2);
constexpr float G3 = (float)gamma_d(3);
constexpr float G5 = (float)gamma_d(5);
constexpr float SLAB_WIDEN = (float)(1.0 + 2.0 * gamma_d(3));
constexpr float INF_T = 3.4028234663852886e+38f;

struct Shear {
  int kz;
  float sx, sy, sz;
};

// (v[kz+1], v[kz+2], v[kz])
__device__ __forceinline__ void permute(float x, float y, float z, int kz,
                                        float& px, float& py, float& pz) {
  px = kz == 0 ? y : (kz == 1 ? z : x);
  py = kz == 0 ? z : (kz == 1 ? x : y);
  pz = kz == 0 ? x : (kz == 1 ? y : z);
}

__device__ __forceinline__ float clamp_mag(float b, float eps) {
  float mag = fmaxf(fabsf(b), eps);
  return b < 0.f ? -mag : mag;
}

__device__ __forceinline__ Shear ray_shear(float dx, float dy, float dz) {
  Shear s;
  // argmax |d|, first index on ties
  s.kz = 0;
  float m = fabsf(dx);
  if (fabsf(dy) > m) { s.kz = 1; m = fabsf(dy); }
  if (fabsf(dz) > m) { s.kz = 2; }
  float px, py, pz;
  permute(dx, dy, dz, s.kz, px, py, pz);
  float dzs = clamp_mag(pz, 1e-12f);
  s.sx = -px / dzs;
  s.sy = -py / dzs;
  s.sz = 1.f / dzs;
  return s;
}

// Watertight test of one triangle (vertices at v[0..8]) against the ray;
// returns true and sets t when the ray hits it strictly inside (0, t_max).
__device__ __forceinline__ bool watertight(const float* __restrict__ v,
                                           float ox, float oy, float oz,
                                           const Shear& s, float t_max,
                                           float& t_out) {
  float a0, a1, a2, b0, b1, b2, c0, c1, c2;
  permute(v[0] - ox, v[1] - oy, v[2] - oz, s.kz, a0, a1, a2);
  permute(v[3] - ox, v[4] - oy, v[5] - oz, s.kz, b0, b1, b2);
  permute(v[6] - ox, v[7] - oy, v[8] - oz, s.kz, c0, c1, c2);
  float ax = a0 + s.sx * a2;
  float ay = a1 + s.sy * a2;
  float bx = b0 + s.sx * b2;
  float by = b1 + s.sy * b2;
  float cx = c0 + s.sx * c2;
  float cy = c1 + s.sy * c2;

  float e0 = cx * by - cy * bx;
  float e1 = ax * cy - ay * cx;
  float e2 = bx * ay - by * ax;
  if ((e0 < 0.f || e1 < 0.f || e2 < 0.f) && (e0 > 0.f || e1 > 0.f || e2 > 0.f))
    return false;
  float det = e0 + e1 + e2;
  if (det == 0.f) return false;

  float az = s.sz * a2;
  float bz = s.sz * b2;
  float cz = s.sz * c2;
  float t_scaled = e0 * az + e1 * bz + e2 * cz;
  if (det < 0.f) {
    if (!(t_scaled < 0.f && t_scaled > t_max * det)) return false;
  } else {
    if (!(t_scaled > 0.f && t_scaled < t_max * det)) return false;
  }
  float max_e = fmaxf(fmaxf(fabsf(e0), fabsf(e1)), fabsf(e2));
  float inv_det = 1.f / clamp_mag(det, 1e-8f * max_e + 1e-30f);
  float t = t_scaled * inv_det;

  float max_z = fmaxf(fmaxf(fabsf(az), fabsf(bz)), fabsf(cz));
  float max_x = fmaxf(fmaxf(fabsf(ax), fabsf(bx)), fabsf(cx));
  float max_y = fmaxf(fmaxf(fabsf(ay), fabsf(by)), fabsf(cy));
  float delta_z = G3 * max_z;
  float delta_x = G5 * (max_x + max_z);
  float delta_y = G5 * (max_y + max_z);
  float delta_e = 2.f * (G2 * max_x * max_y + delta_y * max_x + delta_x * max_y);
  float delta_t = 3.f * (G3 * max_e * max_z + delta_e * max_z + delta_z * max_e) *
                  fabsf(inv_det);
  if (!(t > delta_t)) return false;
  t_out = t;
  return true;
}

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
  unsigned long long n_nodes = 0, n_tris = 0;  // work counts for `stats`

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
        ++n_tris;
        if (watertight(row + 9 * k, ox, oy, oz, sh, t_best, t) && t < t_best) {
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
  }
  t_out[r] = t_best;
  prim_out[r] = prim;
}

}  // namespace

extern "C" int pbrt_bvh_max_stack() { return MAX_STACK; }

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// `stats`, when not null, receives the internal rows visited and the leaf
// triangles tested, summed over the rays (for the operation count).
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
