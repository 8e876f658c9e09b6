// Dense closest-hit and any-hit sweeps over every primitive of a small
// scene, for Hopper (sm_90a): triangles (K3) and spheres and disks (K4).
//
// Replaces the TPU hot paths pbrt_tpu/geometry/intersect.py:224
// `intersect_tris_dense`, :244 `occluded_tris_dense`, :267
// `intersect_spheres_dense` (with the partial-sphere clip, :295-316) and
// :358 `intersect_disks_dense` (with the partial-disk clip, :376-383), and
// the sphere test of pbrt_tpu/accel/dispatch.py:321 `occluded` (the closest
// hit's `idx >= 0`) with an any-hit sphere sweep. The JAX package evaluates
// a dense (rays x primitives) block and reduces it with an argmin; here the
// primitives are swept in order for each ray, and a candidate replaces the
// best hit only when it is strictly nearer, so ties go to the lowest index,
// as argmin does. Lanes with t_max <= 0 (masked shadow rays) answer a miss
// without testing. The any-hit sweeps stop at the first hit.
//
// The sweeps run at three wave sizes on the main path: 2^20 rays (a path or
// BDPT wave's closest hits), tens of millions (a BDPT wave's shadow rays,
// one a strategy and lane, most of them masked) and 8,192 (an MLT
// evaluation; its shadow batch 35 times that). So each sweep has two modes,
// chosen by the wrapper (`dense_wide`: 2^19 rays and up): WIDE, where each
// block stages the table once and sweeps many rays, and its lanes read a
// ray only when its t_max is > 0, and a small-wave mode, where a launch is
// one ray's chain of latencies and nothing stands before the first test:
// no barrier, the rows read through the read-only path.
// K3's closest-hit sweep gives a ray a group of G lanes (1 on a wide wave,
// up to 8 on a small one), which sweep strided triangles and reduce their
// bests by shuffles; the any-hit sweep (K3a) runs one lane a ray. The
// sphere (K4) and disk (K4a) sweeps run one thread a ray; the sphere sweep
// keeps its winner's center and radius in registers for the reprojection.
// Every kernel writes what its wrapper returns (int64 indices, bools), so
// the wrappers launch no conversion.
//
// The arithmetic is the plain version's (pbrt_tpu_torch/geometry/
// intersect.py), operation for operation, with sums of three products taken
// as (x + y) + z. Built with --fmad=false, the triangle sweep's prim ids and
// barycentrics equal the plain version's bit for bit; atan2f in the quadric
// phi clip may differ from torch.atan2 by an ulp, so a hit or miss may flip
// only on lanes within ~1e-7 rad of a phimax edge.
//
// What bounds it on the H100 (3.35 TB/s, 33.5 T float32 ops/s unfused):
// - a 2^20-ray closest-hit wave, the bytes: each lane reads 4 bytes of
//   t_max and a live lane 24 of ray, and writes 24 (K3: t, an int64 prim,
//   b) or 36 (K4 and K4a: t, an int64 index, p, n): ~50 MB, ~0.016 ms (K4,
//   K4a ~0.020). A triangle test leaves after 30 float ops unless the ray's
//   line crosses the triangle (74 for a test that reaches the t error bound,
//   watertight.cuh), and a camera ray's line crosses about one of cornell's
//   12 triangles: ~0.4e9 ops, ~0.012 ms. The kernel issues ~42 instructions
//   a test (two 16-byte shared loads and one 4-byte, the 30 float ops to the
//   edge test, its compares and branch), so K3 is held by its issue rate
//   near 0.04 ms there. A sphere test is ~35 float ops (two of them IEEE
//   divisions and a square root), ~0.002 ms at 2^20 x 2.
// - a shadow wave, the bytes of its t_max and outputs: a masked lane reads
//   4 bytes and writes 1 (K3a and the any-hit sphere sweep) or 36 (K4a,
//   whose contract returns p and n).
// - an 8,192-ray wave, the launch: the bound is ~0.0002 ms, an empty launch
//   in a graph ~0.0012 (NVIDIA H100 80GB HBM3 at 700 W), and the sweep adds
//   one ray's loads, shear and tests.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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
// K3's staged copies: the 48 KB a block may take without an opt-in
// attribute, less the wide kernel's 2 KB of ray queues
constexpr int SMEM_MAX = 46 * 1024;

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
// A group of G lanes a ray (G in {1, 2, 4, 8}, the wrapper's
// `dense_tri_group`; 1 for the any-hit sweep): lane j of the group tests triangles j, j + G, ...,
// keeps its own best (t, prim and barycentrics, taken when a candidate
// becomes the lane's best: the refit's operations, so its bits), and a
// shuffle reduction within the group takes the smallest t, ties to the
// lowest prim: the serial sweep's winner, since a lane replaces its best
// only on a strictly nearer t. Blocks stride over the rays, the grid
// capped at what the card holds resident.
//
// Two modes, the wrapper's `dense_wide`. WIDE (a wave of 2^19 rays or more,
// G = 1, dense_tri_wide_kernel): each block stages the table once, three
// copies pre-permuted for kz = 0, 1, 2: row k of copy kz holds (p0 p1 p2)
// each permuted as (v[kz+1], v[kz+2], v[kz]), 12 floats (three 16-byte
// loads, no selects), the copies `stride` floats apart with stride = 4
// (mod 32), so that lanes whose rays differ in kz read disjoint banks; a
// lane reads a ray only once its t_max says it is live, and a warp queues
// its live rays and sweeps them 32 at a time (a shadow wave is mostly
// masked lanes, its live ones scattered). Otherwise (a small wave, whose
// time is one ray's chain of latencies; dense_tri_kernel): no block
// barrier, the rows read through the read-only path and permuted as the
// BVH leaf test does, and the ray's loads issued with t_max's.
__device__ __forceinline__ void stage_tris(const float* __restrict__ p0,
                                           const float* __restrict__ p1,
                                           const float* __restrict__ p2, int n_tris,
                                           int stride, float* rows) {
  for (int k = threadIdx.x; k < n_tris; k += blockDim.x) {
    float v[9];
    for (int c = 0; c < 3; ++c) {
      v[c] = p0[3 * k + c];
      v[3 + c] = p1[3 * k + c];
      v[6 + c] = p2[3 * k + c];
    }
    for (int kz = 0; kz < 3; ++kz) {
      float* dst = rows + kz * stride + 12 * k;
      for (int j = 0; j < 3; ++j)
        pbrt_wt::permute(v[3 * j], v[3 * j + 1], v[3 * j + 2], kz, dst[3 * j],
                         dst[3 * j + 1], dst[3 * j + 2]);
      dst[9] = dst[10] = dst[11] = 0.f;
    }
  }
  __syncthreads();
}

// what K3 writes a lane: the closest hit's prim as int64 (-1 on a miss),
// the any-hit sweep's answer as a bool, so that the wrapper returns them as
// they are
template <bool ANY_HIT>
using Prim = typename std::conditional<ANY_HIT, bool, long long>::type;

// One ray r of t_max tmax through the group's sweep and reduction; lane 0
// of the group writes its answer.
template <bool ANY_HIT, int G, bool WIDE>
__device__ __forceinline__ void sweep_ray(
    int r, float tmax, int j, unsigned group_mask, const float* __restrict__ p0,
    const float* __restrict__ p1, const float* __restrict__ p2, int n_tris, int stride,
    const float4* tri_rows, const float* __restrict__ o, const float* __restrict__ d,
    float* __restrict__ t_out, Prim<ANY_HIT>* __restrict__ prim_out,
    float* __restrict__ b_out) {
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (!WIDE) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
  }
  float t_best = INF_T, b0 = 0.f, b1 = 0.f, b2 = 0.f;
  int prim = -1;
  if (tmax > 0.f) {
    if (WIDE) {
      ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
      dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
    }
    const Shear sh = ray_shear(dx, dy, dz);
    float pox, poy, poz;  // the origin permuted as the staged rows are
    pbrt_wt::permute(ox, oy, oz, sh.kz, pox, poy, poz);
    const float4* tab = tri_rows + sh.kz * (stride / 4);
    for (int k = j; k < n_tris; k += G) {
      float t, b[3];
      bool hit;
      if (WIDE) {
        const float4 q0 = tab[3 * k], q1 = tab[3 * k + 1], q2 = tab[3 * k + 2];
        hit = pbrt_wt::watertight_core(q0.x - pox, q0.y - poy, q0.z - poz, q0.w - pox,
                                       q1.x - poy, q1.y - poz, q1.z - pox, q1.w - poy,
                                       q2.x - poz, sh, tmax, t, ANY_HIT ? nullptr : b);
      } else {
        float v[9];
        for (int c = 0; c < 3; ++c) {
          v[c] = __ldg(p0 + 3 * k + c);
          v[3 + c] = __ldg(p1 + 3 * k + c);
          v[6 + c] = __ldg(p2 + 3 * k + c);
        }
        hit = watertight(v, ox, oy, oz, sh, tmax, t, ANY_HIT ? nullptr : b);
      }
      if (hit && t < t_best) {
        t_best = t;
        prim = k;
        if (ANY_HIT) break;
        b0 = b[0]; b1 = b[1]; b2 = b[2];
      }
    }
  }
  // the group's (t, prim) minimum; a miss is (INF_T, -1), and unsigned -1
  // loses every tie
  for (int off = G / 2; off > 0; off /= 2) {
    const float t_o = __shfl_xor_sync(group_mask, t_best, off, G);
    const int p_o = __shfl_xor_sync(group_mask, prim, off, G);
    float c0 = 0.f, c1 = 0.f, c2 = 0.f;
    if (!ANY_HIT) {
      c0 = __shfl_xor_sync(group_mask, b0, off, G);
      c1 = __shfl_xor_sync(group_mask, b1, off, G);
      c2 = __shfl_xor_sync(group_mask, b2, off, G);
    }
    if (t_o < t_best || (t_o == t_best && (unsigned)p_o < (unsigned)prim)) {
      t_best = t_o;
      prim = p_o;
      b0 = c0; b1 = c1; b2 = c2;
    }
  }
  if (j != 0) return;
  if (ANY_HIT) {
    prim_out[r] = prim >= 0;
    return;
  }
  t_out[r] = t_best;
  prim_out[r] = prim;
  b_out[3 * r] = b0;
  b_out[3 * r + 1] = b1;
  b_out[3 * r + 2] = b2;
}

// The small-wave mode: a group of G lanes a ray, the blocks striding over
// the ray groups.
template <bool ANY_HIT, int G>
__global__ void __launch_bounds__(THREADS)
dense_tri_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
                 const float* __restrict__ p2, int n_tris, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ t_max, int n_rays,
                 float* __restrict__ t_out, Prim<ANY_HIT>* __restrict__ prim_out,
                 float* __restrict__ b_out) {
  const int j = threadIdx.x % G;
  const unsigned group_mask = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const int groups = THREADS / G, step = gridDim.x * groups;
  for (int r = blockIdx.x * groups + threadIdx.x / G; r < n_rays; r += step)
    sweep_ray<ANY_HIT, G, false>(r, t_max[r], j, group_mask, p0, p1, p2, n_tris, 0, nullptr,
                                 o, d, t_out, prim_out, b_out);
}

// rays a lane takes at a time in the WIDE mode, their t_max loads issued
// together
constexpr int WIDE_RAYS = 4;

// The WIDE mode, G = 1: the table staged, and each warp queues its live
// rays (t_max > 0) in shared memory and sweeps them 32 at a time, so that
// the scattered live lanes of a shadow wave fill whole warps; a masked
// lane's miss is written at once, and a warp whose 32 rays are all live
// while its queue is empty sweeps them where they are.
template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS)
dense_tri_wide_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
                      const float* __restrict__ p2, int n_tris, int stride,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_max, int n_rays,
                      float* __restrict__ t_out, Prim<ANY_HIT>* __restrict__ prim_out,
                      float* __restrict__ b_out) {
  extern __shared__ float4 tri_rows[];
  __shared__ int queue_r[THREADS / 32][64];
  __shared__ float queue_t[THREADS / 32][64];
  stage_tris(p0, p1, p2, n_tris, stride, reinterpret_cast<float*>(tri_rows));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* qr = queue_r[warp];
  float* qt = queue_t[warp];
  int count = 0;  // the warp's queued rays
  const int step = gridDim.x * THREADS;
  for (int base = blockIdx.x * THREADS + warp * 32; base < n_rays; base += WIDE_RAYS * step) {
    float tm[WIDE_RAYS];
#pragma unroll
    for (int u = 0; u < WIDE_RAYS; ++u) {
      const int r = base + u * step + lane;
      tm[u] = r < n_rays ? t_max[r] : 0.f;
    }
#pragma unroll 1
    for (int u = 0; u < WIDE_RAYS; ++u) {
      const int r = base + u * step + lane;
      const float t_r = tm[0];
#pragma unroll
      for (int v = 0; v + 1 < WIDE_RAYS; ++v) tm[v] = tm[v + 1];
      const bool live = r < n_rays && t_r > 0.f;
      if (r < n_rays && !live) {
        if (ANY_HIT) {
          prim_out[r] = false;
        } else {
          t_out[r] = INF_T;
          prim_out[r] = -1;
          b_out[3 * r] = 0.f; b_out[3 * r + 1] = 0.f; b_out[3 * r + 2] = 0.f;
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, live);
      // a whole warp of live rays with an empty queue sweeps where it is
      int r_s = r;
      float t_s = t_r;
      bool go = true;
      if (m != 0xffffffffu || count != 0) {
        if (live) {
          const int at = count + __popc(m & ((1u << lane) - 1u));
          qr[at] = r;
          qt[at] = t_r;
        }
        count += __popc(m);
        go = count >= 32;
        if (go) {
          __syncwarp();
          r_s = qr[lane];
          t_s = qt[lane];
          count -= 32;
          const int r_next = lane < count ? qr[32 + lane] : 0;
          const float t_next = lane < count ? qt[32 + lane] : 0.f;
          __syncwarp();
          if (lane < count) {
            qr[lane] = r_next;
            qt[lane] = t_next;
          }
        }
      }
      if (go)
        sweep_ray<ANY_HIT, 1, true>(r_s, t_s, 0, 1u << lane, p0, p1, p2, n_tris, stride,
                                    tri_rows, o, d, t_out, prim_out, b_out);
    }
  }
  __syncwarp();
  if (lane < count)
    sweep_ray<ANY_HIT, 1, true>(qr[lane], qt[lane], 0, 1u << lane, p0, p1, p2, n_tris, stride,
                                tri_rows, o, d, t_out, prim_out, b_out);
}

// ---------------------------------------------------------------- K4 spheres
// sph: (S, SPH_W) rows [cx cy cz radius rot00..rot22 zmin zmax phimax], 64
// bytes: four float4, the first (center, radius) all a full sphere reads.
//
// The modes are K4a's (`dense_wide`). WIDE (dense_sphere_wide_kernel): the
// blocks stride over the rays WIDE_RAYS at a time, their t_max loads issued
// together, and a lane reads a ray only when its t_max is > 0; the rows
// staged in shared memory once a block (up to TILE spheres; a larger table
// is read through the read-only path, so no barrier stands in the loop).
// Small (dense_sphere_kernel): one thread a ray, no barrier, the ray's
// loads issued with t_max's and with the first row's. In both, each next
// row's load is issued before the test of the row before it. The winner's
// center and radius stay in registers from the sweep, so the reprojection
// reads no row again. ANY_HIT (the occluded dispatch's entry) writes one
// bool a lane and leaves at the first sphere whose root passes: the
// closest-hit sweep's `idx >= 0`, since a root passes there exactly when it
// would win against no hit.

// what K4 writes a lane: the closest hit's index as int64 (-1 on a miss),
// or the any-hit answer as a bool
template <bool ANY_HIT>
using Idx = typename std::conditional<ANY_HIT, bool, long long>::type;

// STAGED: rows in shared memory; else through the read-only path
template <bool STAGED>
__device__ __forceinline__ float4 sphere_row(const float4* __restrict__ rows, int k, int j) {
  return STAGED ? rows[4 * k + j] : __ldg(rows + 4 * k + j);
}

// the z and phi window of a partial sphere at t (rows 1-3: rot, zmin,
// zmax, phimax); c = (center, radius)
template <bool STAGED>
__device__ __forceinline__ bool sphere_passes(const float4* __restrict__ rows, int k, float4 c,
                                              float ox, float oy, float oz, float dx, float dy,
                                              float dz, float t) {
  const float4 q1 = sphere_row<STAGED>(rows, k, 1), q2 = sphere_row<STAGED>(rows, k, 2),
               q3 = sphere_row<STAGED>(rows, k, 3);
  // rot[j][i] at R[3 * j + i]; local_i = sum_j R[j][i] rel_j
  const float R[9] = {q1.x, q1.y, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, q3.x};
  const float relx = (ox + t * dx) - c.x;
  const float rely = (oy + t * dy) - c.y;
  const float relz = (oz + t * dz) - c.z;
  const float lx = R[0] * relx + R[3] * rely + R[6] * relz;
  const float ly = R[1] * relx + R[4] * rely + R[7] * relz;
  const float lz = R[2] * relx + R[5] * rely + R[8] * relz;
  const float zeps = 1e-4f * c.w;
  return lz >= q3.y - zeps && lz <= q3.z + zeps && phi_of(ly, lx) <= q3.w;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        int r) {
  return Ray{o[3 * r], o[3 * r + 1], o[3 * r + 2], d[3 * r], d[3 * r + 1], d[3 * r + 2]};
}

// The first row's (center, radius), loaded before the sweep that takes it.
template <bool STAGED>
__device__ __forceinline__ float4 first_sphere(const float4* __restrict__ rows, int n) {
  return n > 0 ? sphere_row<STAGED>(rows, 0, 0) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The n spheres of `rows` against one ray, in order (s_next: the first
// row's center and radius); a candidate replaces the best only when
// strictly nearer, so ties go to the lowest index (ANY_HIT: the first
// passing root ends the sweep). Each next center's load is issued before
// this sphere's test.
template <bool PARTIAL, bool ANY_HIT, bool STAGED>
__device__ __forceinline__ void sweep_spheres(const float4* __restrict__ rows, int n,
                                              float4 s_next, Ray ry, float tmax, float& t_best,
                                              int& best, float4& c_best) {
  const float ox = ry.ox, oy = ry.oy, oz = ry.oz, dx = ry.dx, dy = ry.dy, dz = ry.dz;
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float a_safe = clamp_mag(a, 1e-12f);
  for (int k = 0; k < n; ++k) {
    const float4 s = s_next;
    if (k + 1 < n) s_next = sphere_row<STAGED>(rows, k + 1, 0);
    const float ocx = ox - s.x, ocy = oy - s.y, ocz = oz - s.z;
    const float b = 2.f * dot3(ocx, ocy, ocz, dx, dy, dz);
    const float c = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - s.w * s.w;
    const float disc = b * b - 4.f * a * c;
    if (!(disc >= 0.f)) continue;
    const float sq = sqrtf(fmaxf(disc, 0.f));
    const float q = -0.5f * (b + (b < 0.f ? -sq : sq));
    const float t0 = q / a_safe;
    const float t1 = c / clamp_mag(q, 1e-12f);
    const float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
    float t;
    if (PARTIAL) {
      const bool ok_n =
          tn > EPS_T && sphere_passes<STAGED>(rows, k, s, ox, oy, oz, dx, dy, dz, tn);
      if (ok_n) {
        t = tn;
      } else {
        if (!(tf > EPS_T && sphere_passes<STAGED>(rows, k, s, ox, oy, oz, dx, dy, dz, tf)))
          continue;
        t = tf;
      }
    } else {
      t = tn > EPS_T ? tn : tf;
    }
    if (!(t > EPS_T && t < tmax)) continue;
    if (t < t_best) {
      t_best = t;
      best = k;
      c_best = s;
      if (ANY_HIT) return;
    }
  }
}

// Lane r's answer: the any-hit bool, or t, the int64 index and the hit
// point reprojected onto the winner (reference sphere.cu refinement) and
// its normal, 0 on a miss
template <bool ANY_HIT>
__device__ __forceinline__ void write_sphere_hit(int r, Ray ry, float t_best, int best, float4 c,
                                                 float* __restrict__ t_out,
                                                 Idx<ANY_HIT>* __restrict__ idx_out,
                                                 float* __restrict__ p_out,
                                                 float* __restrict__ n_out) {
  if constexpr (ANY_HIT) {
    idx_out[r] = best >= 0;
  } else {
    float px = 0.f, py = 0.f, pz = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
    if (best >= 0) {
      const float cx = c.x, cy = c.y, cz = c.z, rad = c.w;
      px = ry.ox + t_best * ry.dx; py = ry.oy + t_best * ry.dy; pz = ry.oz + t_best * ry.dz;
      const float rx = px - cx, ry_ = py - cy, rz = pz - cz;
      const float scale =
          rad / fmaxf(sqrtf(fmaxf(dot3(rx, ry_, rz, rx, ry_, rz), 0.f)), 1e-12f);
      px = cx + rx * scale; py = cy + ry_ * scale; pz = cz + rz * scale;
      const float ux = px - cx, uy = py - cy, uz = pz - cz;
      const float len = fmaxf(sqrtf(fmaxf(dot3(ux, uy, uz, ux, uy, uz), 0.f)), 1e-12f);
      nx = ux / len; ny = uy / len; nz = uz / len;
    }
    t_out[r] = t_best;
    idx_out[r] = best;
    p_out[3 * r] = px; p_out[3 * r + 1] = py; p_out[3 * r + 2] = pz;
    n_out[3 * r] = nx; n_out[3 * r + 1] = ny; n_out[3 * r + 2] = nz;
  }
}

// The small-wave mode: one thread a ray.
template <bool PARTIAL, bool ANY_HIT>
__global__ void __launch_bounds__(THREADS)
dense_sphere_kernel(const float4* __restrict__ sph, int n_sph, const float* __restrict__ o,
                    const float* __restrict__ d, const float* __restrict__ t_max, int n_rays,
                    float* __restrict__ t_out, Idx<ANY_HIT>* __restrict__ idx_out,
                    float* __restrict__ p_out, float* __restrict__ n_out) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= n_rays) return;
  const float tmax = t_max[r];
  const Ray ry = load_ray(o, d, r);
  const float4 s0 = first_sphere<false>(sph, n_sph);
  float t_best = INF_T;
  int best = -1;
  float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tmax > 0.f)
    sweep_spheres<PARTIAL, ANY_HIT, false>(sph, n_sph, s0, ry, tmax, t_best, best, c);
  write_sphere_hit<ANY_HIT>(r, ry, t_best, best, c, t_out, idx_out, p_out, n_out);
}

// The WIDE mode's rays of one block over `rows` (STAGED: the block's shared
// copy).
template <bool PARTIAL, bool ANY_HIT, bool STAGED>
__device__ __forceinline__ void sphere_wide_rays(const float4* __restrict__ rows, int n_sph,
                                                 const float* __restrict__ o,
                                                 const float* __restrict__ d,
                                                 const float* __restrict__ t_max, int n_rays,
                                                 float* __restrict__ t_out,
                                                 Idx<ANY_HIT>* __restrict__ idx_out,
                                                 float* __restrict__ p_out,
                                                 float* __restrict__ n_out) {
  const int step = gridDim.x * THREADS;
  for (int base = blockIdx.x * THREADS + threadIdx.x; base < n_rays;
       base += WIDE_RAYS * step) {
    float tm[WIDE_RAYS];
#pragma unroll
    for (int u = 0; u < WIDE_RAYS; ++u) {
      const int r = base + u * step;
      tm[u] = r < n_rays ? t_max[r] : 0.f;
    }
#pragma unroll 1
    for (int u = 0; u < WIDE_RAYS; ++u) {
      const int r = base + u * step;
      const float tmax = tm[0];
#pragma unroll
      for (int v = 0; v + 1 < WIDE_RAYS; ++v) tm[v] = tm[v + 1];
      if (r >= n_rays) break;
      Ray ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float t_best = INF_T;
      int best = -1;
      float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tmax > 0.f) {
        ray = load_ray(o, d, r);
        sweep_spheres<PARTIAL, ANY_HIT, STAGED>(rows, n_sph, first_sphere<STAGED>(rows, n_sph),
                                                ray, tmax, t_best, best, c);
      }
      write_sphere_hit<ANY_HIT>(r, ray, t_best, best, c, t_out, idx_out, p_out, n_out);
    }
  }
}

// The WIDE mode. (K3's warp queue of live rays, tried here, was 11 %
// faster at a BDPT wave's shadow rays, 7 % live, and 1.5x slower over the
// wave's walk launches on an NVIDIA H100 80GB HBM3 at 700 W.)
template <bool PARTIAL, bool ANY_HIT>
__global__ void __launch_bounds__(THREADS)
dense_sphere_wide_kernel(const float4* __restrict__ sph, int n_sph, const float* __restrict__ o,
                         const float* __restrict__ d, const float* __restrict__ t_max,
                         int n_rays, float* __restrict__ t_out,
                         Idx<ANY_HIT>* __restrict__ idx_out, float* __restrict__ p_out,
                         float* __restrict__ n_out) {
  __shared__ float4 tile[TILE * 4];
  if (n_sph <= TILE) {
    for (int i = threadIdx.x; i < 4 * n_sph; i += THREADS) tile[i] = sph[i];
    __syncthreads();
    sphere_wide_rays<PARTIAL, ANY_HIT, true>(tile, n_sph, o, d, t_max, n_rays, t_out, idx_out,
                                             p_out, n_out);
  } else {
    sphere_wide_rays<PARTIAL, ANY_HIT, false>(sph, n_sph, o, d, t_max, n_rays, t_out, idx_out,
                                              p_out, n_out);
  }
}

// ---------------------------------------------------------------- K4 disks
// dsk: (D, DSK_W) rows [cx cy cz nx ny nz radius inner xx xy xz yx yy yz phimax]
// One thread a ray, in blocks of THREADS (blocks of 32 and 64 threads were
// no faster at an 8,192-ray wave on an H100: its time is one ray's chain of
// latencies). The modes are K3's (`dense_wide`): WIDE stages the rows in
// shared memory, TILE at a time, and a lane reads its ray only when it is
// live; otherwise every lane reads the same row straight through the
// read-only path, and no barrier stands before the first test, the ray's
// loads issued with t_max's.
template <bool PARTIAL, bool WIDE>
__global__ void __launch_bounds__(THREADS)
dense_disk_kernel(const float* __restrict__ dsk, int n_dsk,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max, int n_rays,
                  float* __restrict__ t_out, long long* __restrict__ idx_out,
                  float* __restrict__ p_out, float* __restrict__ n_out) {
  __shared__ float tile[WIDE ? TILE * DSK_W : 1];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live_lane = r < n_rays;
  if (!WIDE && !live_lane) return;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  const float tmax = live_lane ? t_max[r] : 0.f;
  if (live_lane && (!WIDE || tmax > 0.f)) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
  }
  const bool active = live_lane && tmax > 0.f;
  float t_best = INF_T;
  int best = -1;
  for (int base = 0; base < n_dsk; base += WIDE ? TILE : n_dsk) {
    const int n = WIDE ? min(TILE, n_dsk - base) : n_dsk;
    if (WIDE) {
      __syncthreads();
      for (int i = threadIdx.x; i < n * DSK_W; i += blockDim.x)
        tile[i] = dsk[base * DSK_W + i];
      __syncthreads();
    }
    if (!active) continue;
    for (int k = 0; k < n; ++k) {
      const float* s = WIDE ? tile + DSK_W * k : dsk + DSK_W * k;
      auto ld = [s](int i) { return WIDE ? s[i] : __ldg(s + i); };
      const float s0 = ld(0), s1 = ld(1), s2 = ld(2), s3 = ld(3), s4 = ld(4), s5 = ld(5);
      const float denom = dot3(dx, dy, dz, s3, s4, s5);
      const float dist = dot3(ox - s0, oy - s1, oz - s2, s3, s4, s5);
      const float t = -dist / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
      const float relx = (ox + t * dx) - s0;
      const float rely = (oy + t * dy) - s1;
      const float relz = (oz + t * dz) - s2;
      const float r2 = dot3(relx, rely, relz, relx, rely, relz);
      const float rad = ld(6), inner = ld(7);
      if (!(fabsf(denom) > 1e-9f && t > EPS_T && t < tmax && r2 <= rad * rad &&
            r2 >= inner * inner))
        continue;
      if (PARTIAL &&
          !(phi_of(dot3(relx, rely, relz, ld(11), ld(12), ld(13)),
                   dot3(relx, rely, relz, ld(8), ld(9), ld(10))) <= ld(14)))
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
    nx = __ldg(dsk + DSK_W * best + 3); ny = __ldg(dsk + DSK_W * best + 4);
    nz = __ldg(dsk + DSK_W * best + 5);
  }
  t_out[r] = t_best;
  idx_out[r] = best;
  p_out[3 * r] = px; p_out[3 * r + 1] = py; p_out[3 * r + 2] = pz;
  n_out[3 * r] = nx; n_out[3 * r + 1] = ny; n_out[3 * r + 2] = nz;
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

// Launch `kernel` (THREADS threads a block, `smem` dynamic bytes) over
// `lanes` lanes, its blocks striding over them: the grid capped at the
// blocks the card holds resident, counted once for each smem size (the
// caller's static cache).
template <typename Kernel, typename... Args>
int launch_strided(Kernel kernel, int& cached_smem, int& resident, int smem, long long lanes,
                   cudaStream_t s, Args... args) {
  if (smem != cached_smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    cached_smem = smem;
  }
  const int grid = (int)std::min<long long>((lanes + THREADS - 1) / THREADS, resident);
  kernel<<<grid, THREADS, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <bool ANY_HIT, int G>
int launch_small(const float* p0, const float* p1, const float* p2, int n_tris,
                 const float* o, const float* d, const float* t_max, int n_rays,
                 float* t_out, void* prim_out, float* b_out, cudaStream_t s) {
  static int cached_smem = -1, resident = 0;
  return launch_strided(dense_tri_kernel<ANY_HIT, G>, cached_smem, resident, 0,
                        (long long)n_rays * G, s, p0, p1, p2, n_tris, o, d, t_max, n_rays,
                        t_out, static_cast<Prim<ANY_HIT>*>(prim_out), b_out);
}

// The any-hit sweep runs one lane a ray (G = 1), with its early exit.
template <bool ANY_HIT>
int launch_tris(int group, int wide, const float* p0, const float* p1, const float* p2,
                int n_tris, int stride, const float* o, const float* d, const float* t_max,
                int n_rays, float* t_out, void* prim_out, float* b_out, cudaStream_t s) {
  if (wide) {
    if (group != 1 || stride % 4 != 0 || stride < 12 * n_tris ||
        3 * stride * (int)sizeof(float) > SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    static int cached_smem = -1, resident = 0;
    return launch_strided(dense_tri_wide_kernel<ANY_HIT>, cached_smem, resident,
                          3 * stride * (int)sizeof(float), n_rays, s, p0, p1, p2, n_tris,
                          stride, o, d, t_max, n_rays, t_out,
                          static_cast<Prim<ANY_HIT>*>(prim_out), b_out);
  }
  if constexpr (ANY_HIT) {
    if (group != 1) return (int)cudaErrorInvalidValue;
    return launch_small<true, 1>(p0, p1, p2, n_tris, o, d, t_max, n_rays, t_out, prim_out,
                                 b_out, s);
  } else {
    switch (group) {
      case 1: return launch_small<false, 1>(p0, p1, p2, n_tris, o, d, t_max, n_rays, t_out,
                                            prim_out, b_out, s);
      case 2: return launch_small<false, 2>(p0, p1, p2, n_tris, o, d, t_max, n_rays, t_out,
                                            prim_out, b_out, s);
      case 4: return launch_small<false, 4>(p0, p1, p2, n_tris, o, d, t_max, n_rays, t_out,
                                            prim_out, b_out, s);
      case 8: return launch_small<false, 8>(p0, p1, p2, n_tris, o, d, t_max, n_rays, t_out,
                                            prim_out, b_out, s);
    }
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each launcher runs on `stream` and returns the cudaError_t of the launch
// (0 on success). Pointers are device pointers of contiguous float32 / int32
// tensors; see pbrt_tpu_torch/geometry/intersect.py for the shapes and for
// the launch shapes (`dense_tri_group`, `dense_tri_stride`, `dense_wide`),
// which the wrappers compute.

extern "C" int pbrt_dense_tris(const float* p0, const float* p1, const float* p2,
                               int n_tris, const float* o, const float* d,
                               const float* t_max, int n_rays, float* t_out,
                               void* prim_out, float* b_out, int any_hit, int group,
                               int stride, int wide, void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return any_hit ? launch_tris<true>(group, wide, p0, p1, p2, n_tris, stride, o, d, t_max,
                                     n_rays, t_out, prim_out, b_out, s)
                 : launch_tris<false>(group, wide, p0, p1, p2, n_tris, stride, o, d, t_max,
                                      n_rays, t_out, prim_out, b_out, s);
}

// idx_out: int64 indices, or bools when any_hit (t_out, p_out and n_out
// are then not written)
extern "C" int pbrt_dense_spheres(const float* sph, int n_sph, const float* o,
                                  const float* d, const float* t_max, int n_rays,
                                  float* t_out, void* idx_out, float* p_out,
                                  float* n_out, int partial, int wide, int any_hit,
                                  void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float4* rows = reinterpret_cast<const float4*>(sph);
  auto go = [&](auto partial_c, auto any_c) {
    constexpr bool P = decltype(partial_c)::value, A = decltype(any_c)::value;
    Idx<A>* idx = static_cast<Idx<A>*>(idx_out);
    if (wide) {
      static int cached_smem = -1, resident = 0;
      return launch_strided(dense_sphere_wide_kernel<P, A>, cached_smem, resident, 0, n_rays,
                            s, rows, n_sph, o, d, t_max, n_rays, t_out, idx, p_out, n_out);
    }
    dense_sphere_kernel<P, A><<<blocks_for(n_rays), THREADS, 0, s>>>(
        rows, n_sph, o, d, t_max, n_rays, t_out, idx, p_out, n_out);
    return (int)cudaGetLastError();
  };
  using T = std::true_type;
  using F = std::false_type;
  if (partial) return any_hit ? go(T{}, T{}) : go(T{}, F{});
  return any_hit ? go(F{}, T{}) : go(F{}, F{});
}

extern "C" int pbrt_dense_disks(const float* dsk, int n_dsk, const float* o,
                                const float* d, const float* t_max, int n_rays,
                                float* t_out, long long* idx_out, float* p_out,
                                float* n_out, int partial, int wide, void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto kernel = partial ? (wide ? dense_disk_kernel<true, true> : dense_disk_kernel<true, false>)
                        : (wide ? dense_disk_kernel<false, true>
                                : dense_disk_kernel<false, false>);
  kernel<<<blocks_for(n_rays), THREADS, 0, s>>>(dsk, n_dsk, o, d, t_max, n_rays, t_out, idx_out,
                                                p_out, n_out);
  return (int)cudaGetLastError();
}

