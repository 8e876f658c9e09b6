// K6t: one interface hop of a segment's transmittance, for Hopper (sm_90a).
//
// Replaces the body of the TPU hot path pbrt_tpu/integrators/path.py:98
// `compute_transmittance` (:109-123), which the JAX package runs as a
// fori_loop of 8 closest-hit queries over every NEE shadow segment of a
// volumetric bounce (path.py:158-169) and every BDPT connection segment on a
// scene with media (bdpt.py:696-716). Plain version: pbrt_tpu_torch/
// integrators/path.py `transmit_hop_plain`; the loop around it (MAX_HOPS
// rounds of dispatch.intersect and this kernel, a fixed count with no host
// sync) is path.py `transmittance`.
//
// Over the closest hits of the rays o + t d, t < t_max, a lane that is not
// done multiplies its transmittance (R, 4) by exp(-sigma_t seg), sigma_t of
// the medium it travels in at its four wavelengths (a (n_media, 471) table
// lookup, K10) and seg the hit's t or, on a miss, the distance to the
// segment's end p1; a real surface (material >= 0) sets it to 0; a miss or
// a block ends the lane; at a material-less interface the next origin is
// offset past the hit along d (geometry/ray.py offset_ray_origin) and the
// medium becomes the one beyond it (path.py medium_after). Every lane then
// writes its next hop's t_max: 0 once done (its next query ends at once),
// else 0.1 % short of p1. o, medium, trans and done are updated in place.
//
// One thread a lane, the arithmetic of the plain version in its order
// (3-term dot products (x + y) + z, --fmad=false), the sigma rows read
// through __ldg; a lane that is done reads only its flag. What bounds it on
// the H100: bytes, 5 a done lane and 86 to 170 a live one (the hit record
// as far as the lane needs it, its state in and out), by the count of
// chip_smoke.py; a few tens of operations a live lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bxdf.cuh"

using namespace pbrt_bxdf;

// mirrored by pbrt_tpu_torch/integrators/path.py `_HopArgs`: every field 8
// bytes. (R,) and (R, k) lane arrays contiguous, (R, 4) rows 16-byte aligned.
struct HopArgs {
  // the closest hits
  const uint8_t* hit_valid;
  const float *hit_t, *hit_p, *hit_ng;
  const long long *hit_mat, *hit_med_in, *hit_med_out;
  // the segments: direction, end, wavelengths
  const float *d, *p1, *lam;
  // updated in place
  float *o, *trans;
  long long* medium;
  uint8_t* done;
  // written
  float* t_max;
  // scene rows: sigma_a, sigma_s (n_media, 471), the ray offset scale (1,)
  const float *sigma_a, *sigma_s, *offset;
  long long n;
};

namespace {

constexpr int THREADS = 128;
constexpr int LAMBDA_MIN = 360, LAMBDA_RANGE = 471;
constexpr float SHADOW_SHORTEN = (float)(1.0 - 1e-3);

__device__ __forceinline__ V3 ld3(const float* p, long long i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ int lam_bin(float lam) {
  return min(max(__float2int_rn(lam) - LAMBDA_MIN, 0), LAMBDA_RANGE - 1);
}

__device__ __forceinline__ float distance(V3 a, V3 b) {
  const V3 v = {a.x - b.x, a.y - b.y, a.z - b.z};
  return safe_sqrt(dot(v, v));
}

__device__ __forceinline__ void hop_lane(const HopArgs& a, long long i) {
  // a lane done before this hop reads its flag and writes its t_max, no more
  if (a.done[i] != 0) {
    a.t_max[i] = 0.f;
    return;
  }
  V3 o = ld3(a.o, i);
  const V3 p1 = ld3(a.p1, i);
  long long medium = a.medium[i];
  const bool valid = a.hit_valid[i] != 0;
  const float seg = valid ? a.hit_t[i] : distance(o, p1);
  const float4 lam = reinterpret_cast<const float4*>(a.lam)[i];
  float4 tr = reinterpret_cast<const float4*>(a.trans)[i];
  const float s = fminf(seg, 1e20f);
  if (medium >= 0) {
    const float* sa = a.sigma_a + medium * LAMBDA_RANGE;
    const float* ss = a.sigma_s + medium * LAMBDA_RANGE;
    const int b0 = lam_bin(lam.x), b1 = lam_bin(lam.y), b2 = lam_bin(lam.z),
              b3 = lam_bin(lam.w);
    tr.x = tr.x * expf(-(__ldg(sa + b0) + __ldg(ss + b0)) * s);
    tr.y = tr.y * expf(-(__ldg(sa + b1) + __ldg(ss + b1)) * s);
    tr.z = tr.z * expf(-(__ldg(sa + b2) + __ldg(ss + b2)) * s);
    tr.w = tr.w * expf(-(__ldg(sa + b3) + __ldg(ss + b3)) * s);
  }  // in vacuum sigma_t = 0: exp(-0 s) = 1 keeps the transmittance's bits
  const long long mat = valid ? a.hit_mat[i] : -1;
  if (valid && mat >= 0) tr = make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<float4*>(a.trans)[i] = tr;
  if (valid && mat < 0) {
    // a material-less interface: on along d past the hit, into the medium
    // beyond it
    const V3 p = ld3(a.hit_p, i), ng = ld3(a.hit_ng, i), d = ld3(a.d, i);
    const float mag = fmaxf(fmaxf(fabsf(p.x), fabsf(p.y)), fabsf(p.z));
    const float eps = __ldg(a.offset) * fmaxf(mag, 1.f);
    const V3 nf = dot(ng, d) < 0.f ? neg(ng) : ng;
    o = {p.x + nf.x * eps, p.y + nf.y * eps, p.z + nf.z * eps};
    a.o[3 * i] = o.x;
    a.o[3 * i + 1] = o.y;
    a.o[3 * i + 2] = o.z;
    const long long m_in = a.hit_med_in[i], m_out = a.hit_med_out[i];
    if (m_in != m_out) medium = dot(d, ng) > 0.f ? m_out : m_in;
    a.medium[i] = medium;
    a.t_max[i] = distance(o, p1) * SHADOW_SHORTEN;
  } else {
    a.done[i] = 1;
    a.t_max[i] = 0.f;
  }
}

__global__ void __launch_bounds__(THREADS) transmit_hop_kernel(const HopArgs a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) hop_lane(a, i);
}

}  // namespace

extern "C" int pbrt_transmit_args_bytes() { return (int)sizeof(HopArgs); }

extern "C" int pbrt_transmit_hop(const HopArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  const long long blocks = (a->n + THREADS - 1) / THREADS;
  transmit_hop_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
