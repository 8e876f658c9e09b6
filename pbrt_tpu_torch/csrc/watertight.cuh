// The watertight ray-triangle test of the port's CUDA kernels (reference
// shapes/triangle.cu:213-323; plain version pbrt_tpu_torch/geometry/
// intersect.py `watertight_core`), shared by the BVH traversal
// (bvh_traverse.cu, K1/K2) and the dense sweep (dense_intersect.cu, K3).
// Build with --fmad=false: every product and sum rounds on its own, as in
// the plain torch version, so prim ids agree bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace pbrt_wt {

constexpr double MACHINE_EPSILON = 5.9604644775390625e-08;  // float eps / 2
constexpr double gamma_d(int n) {
  return (n * MACHINE_EPSILON) / (1 - n * MACHINE_EPSILON);
}
constexpr float G2 = (float)gamma_d(2);
constexpr float G3 = (float)gamma_d(3);
constexpr float G5 = (float)gamma_d(5);
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

// Watertight test of one triangle whose vertices are already translated to
// the ray's origin and permuted by its kz: a = (v0 - o) permuted, b and c
// likewise. Returns true and sets t when the ray hits it strictly inside (0,
// t_max). With `b` given, also writes the barycentrics (e0, e1, e2) / det.
// With `stage` given, also writes how far the test went, for operation
// counts: 0 out at the edge-sign test (30 float ops: 9 subtractions, 12
// shear, 9 edge functions), 1 out at the det or t-range test (11 more), 2
// past it to the t error bound (33 more; abs is a free operand modifier,
// compares are not counted).
__device__ __forceinline__ bool watertight_core(float a0, float a1, float a2, float b0,
                                                float b1, float b2, float c0, float c1,
                                                float c2, const Shear& s, float t_max,
                                                float& t_out, float* b = nullptr,
                                                int* stage = nullptr) {
  if (stage) *stage = 0;
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
  if (stage) *stage = 1;
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
  if (stage) *stage = 2;
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
  if (b) {
    b[0] = e0 * inv_det;
    b[1] = e1 * inv_det;
    b[2] = e2 * inv_det;
  }
  return true;
}

// The same test of one triangle (vertices at v[0..8]) against the ray: the
// vertices translated and permuted here, then watertight_core.
__device__ __forceinline__ bool watertight(const float* __restrict__ v,
                                           float ox, float oy, float oz,
                                           const Shear& s, float t_max,
                                           float& t_out, float* b = nullptr,
                                           int* stage = nullptr) {
  float a0, a1, a2, b0, b1, b2, c0, c1, c2;
  permute(v[0] - ox, v[1] - oy, v[2] - oz, s.kz, a0, a1, a2);
  permute(v[3] - ox, v[4] - oy, v[5] - oz, s.kz, b0, b1, b2);
  permute(v[6] - ox, v[7] - oy, v[8] - oz, s.kz, c0, c1, c2);
  return watertight_core(a0, a1, a2, b0, b1, b2, c0, c1, c2, s, t_max, t_out, b, stage);
}

}  // namespace pbrt_wt
