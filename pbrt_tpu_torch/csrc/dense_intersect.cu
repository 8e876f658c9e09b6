// Dense closest-hit and any-hit sweeps over every primitive of a small
// scene, for Hopper (sm_90a): triangles (K3) and spheres and disks (K4).
//
// Replaces the TPU hot paths pbrt_tpu/geometry/intersect.py:224
// `intersect_tris_dense`, :244 `occluded_tris_dense`, :267
// `intersect_spheres_dense` (with the partial-sphere clip, :295-316) and
// :358 `intersect_disks_dense` (with the partial-disk clip, :376-383). The
// JAX package evaluates a dense (rays x primitives) block and reduces it with
// an argmin; here one thread owns one ray and loops over the primitives.
//
// Design: the block stages the primitives in shared memory, TILE at a time
// (the dense route has under 64 triangles and a handful of quadrics, so one
// tile holds the whole scene: 2.3 KB of triangles), and every thread sweeps
// the tile with its own ray. A candidate replaces the best hit only when it
// is strictly nearer, so ties go to the lowest index, as argmin does. Lanes
// with t_max <= 0 (masked shadow rays) answer a miss without testing. The
// any-hit triangle sweep stops at the first hit.
//
// The arithmetic is the plain version's (pbrt_tpu_torch/geometry/
// intersect.py), operation for operation, with sums of three products taken
// as (x + y) + z. Built with --fmad=false, the triangle sweep's prim ids and
// barycentrics equal the plain version's bit for bit; atan2f in the quadric
// phi clip may differ from torch.atan2 by an ulp, so a hit or miss may flip
// only on lanes within ~1e-7 rad of a phimax edge.
//
// What bounds it on the H100: bytes and operations about equally. Each lane
// reads 28 bytes of ray and writes 20-32 (~50 MB at 2^20 lanes, ~0.015 ms).
// A triangle test leaves after 30 float ops unless the ray's line crosses
// the triangle (74 for a test that reaches the t error bound,
// watertight.cuh), and a ray's line crosses about one of the 12 cornell
// triangles, so the float work is ~0.5e9 ops, also ~0.015 ms. A sphere
// candidate is 35 ops and a disk candidate 36: with one or two quadrics the
// bytes bound the quadric sweeps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "watertight.cuh"

namespace {

using pbrt_wt::INF_T;
using pbrt_wt::Shear;
using pbrt_wt::ray_shear;
using pbrt_wt::watertight;

constexpr int THREADS = 128;
constexpr int TILE = 64;          // primitives staged per pass
constexpr float EPS_T = 1e-3f;    // quadric min-t epsilon (scene units)
constexpr float TWO_PI = 6.283185307179586f;
constexpr int SPH_W = 16;         // center 3, radius, rot 9, zmin, zmax, phimax
constexpr int DSK_W = 15;         // center 3, normal 3, radius, inner, x 3, y 3, phimax

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ float clamp_mag(float b, float eps) {
  float mag = fmaxf(fabsf(b), eps);
  return b < 0.f ? -mag : mag;
}

// phi in [0, 2 pi) of (x, y), as the plain version computes it
__device__ __forceinline__ float phi_of(float y, float x) {
  float phi = atan2f(y, x);
  return phi < 0.f ? phi + TWO_PI : phi;
}

// ---------------------------------------------------------------- K3
template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS)
dense_tri_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
                 const float* __restrict__ p2, int n_tris,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_max, int n_rays,
                 float* __restrict__ t_out, int* __restrict__ prim_out,
                 float* __restrict__ b_out) {
  __shared__ float tri[TILE * 9];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live_lane = r < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, tmax = 0.f;
  Shear sh{0, 0.f, 0.f, 0.f};
  if (live_lane) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    tmax = t_max[r];
    sh = ray_shear(d[3 * r], d[3 * r + 1], d[3 * r + 2]);
  }
  bool active = live_lane && tmax > 0.f;
  float t_best = INF_T;
  int prim = -1;
  for (int base = 0; base < n_tris; base += TILE) {
    const int n = min(TILE, n_tris - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * 9; i += blockDim.x) {
      const int k = i / 9, c = i % 9;
      const float* src = c < 3 ? p0 : (c < 6 ? p1 : p2);
      tri[i] = src[3 * (base + k) + c % 3];
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < n; ++k) {
      float t;
      if (watertight(tri + 9 * k, ox, oy, oz, sh, tmax, t) && t < t_best) {
        t_best = t;
        prim = base + k;
        if (ANY_HIT) break;
      }
    }
    if (ANY_HIT && prim >= 0) active = false;
  }
  if (!live_lane) return;
  if (ANY_HIT) {
    prim_out[r] = prim >= 0 ? 0 : -1;
    return;
  }
  float b[3] = {0.f, 0.f, 0.f};
  if (prim >= 0) {
    // the winner again, for its barycentrics: the same operations as the
    // sweep, so the same t
    float v[9];
    for (int c = 0; c < 3; ++c) {
      v[c] = p0[3 * prim + c];
      v[3 + c] = p1[3 * prim + c];
      v[6 + c] = p2[3 * prim + c];
    }
    float t;
    watertight(v, ox, oy, oz, sh, tmax, t, b);
  }
  t_out[r] = t_best;
  prim_out[r] = prim;
  b_out[3 * r] = b[0];
  b_out[3 * r + 1] = b[1];
  b_out[3 * r + 2] = b[2];
}

// ---------------------------------------------------------------- K4 spheres
// sph: (S, SPH_W) rows [cx cy cz radius rot00..rot22 zmin zmax phimax]
__device__ __forceinline__ bool sphere_passes(const float* s, float ox, float oy,
                                              float oz, float dx, float dy,
                                              float dz, float t) {
  const float relx = (ox + t * dx) - s[0];
  const float rely = (oy + t * dy) - s[1];
  const float relz = (oz + t * dz) - s[2];
  const float* R = s + 4;  // rot[j][i] at R[3 * j + i]; local_i = sum_j R[j][i] rel_j
  const float lx = R[0] * relx + R[3] * rely + R[6] * relz;
  const float ly = R[1] * relx + R[4] * rely + R[7] * relz;
  const float lz = R[2] * relx + R[5] * rely + R[8] * relz;
  const float zeps = 1e-4f * s[3];
  return lz >= s[13] - zeps && lz <= s[14] + zeps && phi_of(ly, lx) <= s[15];
}

template <bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
dense_sphere_kernel(const float* __restrict__ sph, int n_sph,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max, int n_rays,
                    float* __restrict__ t_out, int* __restrict__ idx_out,
                    float* __restrict__ p_out, float* __restrict__ n_out) {
  __shared__ float tile[TILE * SPH_W];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live_lane = r < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, tmax = 0.f;
  if (live_lane) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
    tmax = t_max[r];
  }
  const bool active = live_lane && tmax > 0.f;
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float a_safe = clamp_mag(a, 1e-12f);
  float t_best = INF_T;
  int best = -1;
  for (int base = 0; base < n_sph; base += TILE) {
    const int n = min(TILE, n_sph - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * SPH_W; i += blockDim.x)
      tile[i] = sph[base * SPH_W + i];
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < n; ++k) {
      const float* s = tile + SPH_W * k;
      const float ocx = ox - s[0], ocy = oy - s[1], ocz = oz - s[2];
      const float b = 2.f * dot3(ocx, ocy, ocz, dx, dy, dz);
      const float c = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - s[3] * s[3];
      const float disc = b * b - 4.f * a * c;
      if (!(disc >= 0.f)) continue;
      const float sq = sqrtf(fmaxf(disc, 0.f));
      const float q = -0.5f * (b + (b < 0.f ? -sq : sq));
      const float t0 = q / a_safe;
      const float t1 = c / clamp_mag(q, 1e-12f);
      const float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
      float t;
      if (PARTIAL) {
        const bool ok_n = tn > EPS_T && sphere_passes(s, ox, oy, oz, dx, dy, dz, tn);
        if (ok_n) {
          t = tn;
        } else {
          if (!(tf > EPS_T && sphere_passes(s, ox, oy, oz, dx, dy, dz, tf))) continue;
          t = tf;
        }
      } else {
        t = tn > EPS_T ? tn : tf;
      }
      if (!(t > EPS_T && t < tmax)) continue;
      if (t < t_best) {
        t_best = t;
        best = base + k;
      }
    }
  }
  if (!live_lane) return;
  float px = 0.f, py = 0.f, pz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  if (best >= 0) {
    // hit point reprojected onto the sphere (reference sphere.cu refinement)
    const float* s = sph + SPH_W * best;
    const float cx = s[0], cy = s[1], cz = s[2], rad = s[3];
    px = ox + t_best * dx; py = oy + t_best * dy; pz = oz + t_best * dz;
    const float rx = px - cx, ry = py - cy, rz = pz - cz;
    const float scale = rad / fmaxf(sqrtf(fmaxf(dot3(rx, ry, rz, rx, ry, rz), 0.f)), 1e-12f);
    px = cx + rx * scale; py = cy + ry * scale; pz = cz + rz * scale;
    const float ux = px - cx, uy = py - cy, uz = pz - cz;
    const float len = fmaxf(sqrtf(fmaxf(dot3(ux, uy, uz, ux, uy, uz), 0.f)), 1e-12f);
    nx = ux / len; ny = uy / len; nz = uz / len;
  }
  t_out[r] = t_best;
  idx_out[r] = best;
  p_out[3 * r] = px; p_out[3 * r + 1] = py; p_out[3 * r + 2] = pz;
  n_out[3 * r] = nx; n_out[3 * r + 1] = ny; n_out[3 * r + 2] = nz;
}

// ---------------------------------------------------------------- K4 disks
// dsk: (D, DSK_W) rows [cx cy cz nx ny nz radius inner xx xy xz yx yy yz phimax]
template <bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
dense_disk_kernel(const float* __restrict__ dsk, int n_dsk,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max, int n_rays,
                  float* __restrict__ t_out, int* __restrict__ idx_out,
                  float* __restrict__ p_out, float* __restrict__ n_out) {
  __shared__ float tile[TILE * DSK_W];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live_lane = r < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, tmax = 0.f;
  if (live_lane) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
    tmax = t_max[r];
  }
  const bool active = live_lane && tmax > 0.f;
  float t_best = INF_T;
  int best = -1;
  for (int base = 0; base < n_dsk; base += TILE) {
    const int n = min(TILE, n_dsk - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * DSK_W; i += blockDim.x)
      tile[i] = dsk[base * DSK_W + i];
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < n; ++k) {
      const float* s = tile + DSK_W * k;
      const float denom = dot3(dx, dy, dz, s[3], s[4], s[5]);
      const float dist = dot3(ox - s[0], oy - s[1], oz - s[2], s[3], s[4], s[5]);
      const float t = -dist / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
      const float relx = (ox + t * dx) - s[0];
      const float rely = (oy + t * dy) - s[1];
      const float relz = (oz + t * dz) - s[2];
      const float r2 = dot3(relx, rely, relz, relx, rely, relz);
      if (!(fabsf(denom) > 1e-9f && t > EPS_T && t < tmax && r2 <= s[6] * s[6] &&
            r2 >= s[7] * s[7]))
        continue;
      if (PARTIAL &&
          !(phi_of(dot3(relx, rely, relz, s[11], s[12], s[13]),
                   dot3(relx, rely, relz, s[8], s[9], s[10])) <= s[14]))
        continue;
      if (t < t_best) {
        t_best = t;
        best = base + k;
      }
    }
  }
  if (!live_lane) return;
  float px = 0.f, py = 0.f, pz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  if (best >= 0) {
    // one rounding, as the plain version's float64 o + t * d (an explicit
    // fma: --fmad=false forbids only the implicit contraction)
    px = __fmaf_rn(t_best, dx, ox); py = __fmaf_rn(t_best, dy, oy);
    pz = __fmaf_rn(t_best, dz, oz);
    nx = dsk[DSK_W * best + 3]; ny = dsk[DSK_W * best + 4]; nz = dsk[DSK_W * best + 5];
  }
  t_out[r] = t_best;
  idx_out[r] = best;
  p_out[3 * r] = px; p_out[3 * r + 1] = py; p_out[3 * r + 2] = pz;
  n_out[3 * r] = nx; n_out[3 * r + 1] = ny; n_out[3 * r + 2] = nz;
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// Each launcher runs on `stream` and returns the cudaError_t of the launch
// (0 on success). Pointers are device pointers of contiguous float32 / int32
// tensors; see pbrt_tpu_torch/geometry/intersect.py for the shapes.

extern "C" int pbrt_dense_tris(const float* p0, const float* p1, const float* p2,
                               int n_tris, const float* o, const float* d,
                               const float* t_max, int n_rays, float* t_out,
                               int* prim_out, float* b_out, int any_hit,
                               void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    dense_tri_kernel<true><<<blocks_for(n_rays), THREADS, 0, s>>>(
        p0, p1, p2, n_tris, o, d, t_max, n_rays, t_out, prim_out, b_out);
  } else {
    dense_tri_kernel<false><<<blocks_for(n_rays), THREADS, 0, s>>>(
        p0, p1, p2, n_tris, o, d, t_max, n_rays, t_out, prim_out, b_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int pbrt_dense_spheres(const float* sph, int n_sph, const float* o,
                                  const float* d, const float* t_max, int n_rays,
                                  float* t_out, int* idx_out, float* p_out,
                                  float* n_out, int partial, void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (partial) {
    dense_sphere_kernel<true><<<blocks_for(n_rays), THREADS, 0, s>>>(
        sph, n_sph, o, d, t_max, n_rays, t_out, idx_out, p_out, n_out);
  } else {
    dense_sphere_kernel<false><<<blocks_for(n_rays), THREADS, 0, s>>>(
        sph, n_sph, o, d, t_max, n_rays, t_out, idx_out, p_out, n_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int pbrt_dense_disks(const float* dsk, int n_dsk, const float* o,
                                const float* d, const float* t_max, int n_rays,
                                float* t_out, int* idx_out, float* p_out,
                                float* n_out, int partial, void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (partial) {
    dense_disk_kernel<true><<<blocks_for(n_rays), THREADS, 0, s>>>(
        dsk, n_dsk, o, d, t_max, n_rays, t_out, idx_out, p_out, n_out);
  } else {
    dense_disk_kernel<false><<<blocks_for(n_rays), THREADS, 0, s>>>(
        dsk, n_dsk, o, d, t_max, n_rays, t_out, idx_out, p_out, n_out);
  }
  return (int)cudaGetLastError();
}
