// K12m: the Markov-chain steps of Metropolis light transport, one thread a
// chain.
//
// Replaces the two jitted XLA functions of the TPU's MLT hot path:
//   pbrt_mlt_mutate        pbrt_tpu/integrators/mlt.py:53 `mutate` (K12m-a):
//                          a large step (fresh uniforms) with probability
//                          P_LARGE, else x + SIGMA sqrt(2) erfinv(2u - 1)
//                          wrapped into [0, 1); clipped to [0, 1 - 1e-7];
//   pbrt_mlt_accept_splat  mlt.py:106 `_accept_and_splat` (C = 1) and :168
//                          `_accept_and_splat_multi` (C > 1) (K12m-b): the
//                          acceptance a, the expected-value splats of every
//                          contribution of both states (atomic adds, zero
//                          terms skipped) and the heatmap of contribution 0,
//                          then the accept draw and, on accept, the
//                          proposal's row copied into the chain state.
// The draws come from the chain's own PCG32 stream, seeded from
// MurmurHash64A of (seed, purpose, pass, chain) as in the plain version
// (integrators/mlt.py `chain_streams`), so no uniform tensor is read and the
// bits are the plain version's. The arithmetic is the plain version's, in
// its order, built with --fmad=false, with logf and sqrtf as torch calls
// them on the card; on the CPU torch.log may round an ulp apart, which the
// cancellation in erfinv near 0 amplifies to a few ulps of the result.
//
// What bounds it on the H100: bytes. Each chain reads and writes its D
// floats (mutate) or reads both states and writes the accepted row (accept);
// ~10-20 MB at 8192 chains and D = 160, a few microseconds at 3.35 TB/s.
// A thread walks its chain's row, so a warp's loads are strided by D floats
// and each cache line is reused from L1 over the next iterations; as a first
// kernel it keeps that simple layout.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bxdf.cuh"

using namespace pbrt_bxdf;

namespace {

constexpr float P_LARGE = 0.3f;
constexpr float SIGMA_SQRT2 = 0x1.cf68d4p-7f;   // float32(0.01) * float32(sqrt 2)
constexpr float ONE_MINUS = 0x1.fffffcp-1f;     // float32(1 - 1e-7)
constexpr float TWO_OVER_PI_A = 0x1.152af4p+2f;  // float32(2 / (pi * 0.147))
constexpr float INV_A = 0x1.b35fc8p+2f;         // float32(1 / float32(0.147))
constexpr uint32_t MUTATE = 3, ACCEPT = 4;       // stream purposes (mlt.py)

// SplitMix64 finalizer (reference rng.h:15-22)
__device__ __forceinline__ uint64_t mix_bits(uint64_t v) {
  v ^= v >> 31;
  v *= 0x7FB5D329728EA185ULL;
  v ^= v >> 27;
  v *= 0x81DADEF4BC2DD44DULL;
  return v ^ (v >> 33);
}

// MurmurHash64A of four 4-byte words, seed 0 (reference util/hash.h)
__device__ __forceinline__ uint64_t murmur64a_4(uint32_t w0, uint32_t w1, uint32_t w2,
                                                uint32_t w3) {
  const uint64_t m = 0xC6A4A7935BD1E995ULL;
  uint64_t h = 16ULL * m;
  uint64_t k = ((uint64_t)w1 << 32) | w0;
  k *= m;
  k ^= k >> 47;
  k *= m;
  h = (h ^ k) * m;
  k = ((uint64_t)w3 << 32) | w2;
  k *= m;
  k ^= k >> 47;
  k *= m;
  h = (h ^ k) * m;
  h ^= h >> 47;
  h *= m;
  return h ^ (h >> 47);
}

// the stream of (seed, purpose, pass, chain): from_seed(hash) (rng.h:44-46)
__device__ __forceinline__ Pcg32 chain_stream(uint32_t seed, uint32_t purpose, uint32_t pass,
                                              uint32_t chain) {
  const uint64_t seq = murmur64a_4(seed, purpose, pass, chain);
  return pcg32_set_sequence(seq, mix_bits(seq));
}

// Winitzki's erfinv, clipped as in mlt.py `_erfinv`
__device__ __forceinline__ float erfinv_w(float x) {
  x = fminf(fmaxf(x, -0.99999f), 0.99999f);
  const float ln1mx2 = logf(fmaxf((1.f - x) * (1.f + x), 1e-30f));
  const float term = TWO_OVER_PI_A + ln1mx2 / 2.f;
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sgn * sqrtf(sqrtf(fmaxf(term * term - ln1mx2 * INV_A, 0.f)) - term);
}

__global__ void mutate_kernel(const float* __restrict__ x, float* __restrict__ out,
                              float* __restrict__ draws, int R, int D, uint32_t seed,
                              uint32_t pass) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= R) return;
  Pcg32 r = chain_stream(seed, MUTATE, pass, (uint32_t)c);
  const float u_large = pcg32_uniform(r);
  const bool large = u_large < P_LARGE;
  const size_t row = (size_t)c * D;
  float* dr = draws ? draws + (size_t)c * (1 + 2 * D) : nullptr;
  if (dr) dr[0] = u_large;
  for (int d = 0; d < D; ++d) {
    const float fresh = pcg32_uniform(r);
    const float u = pcg32_uniform(r);
    if (dr) {
      dr[1 + 2 * d] = fresh;
      dr[2 + 2 * d] = u;
    }
    float v = x[row + d] + SIGMA_SQRT2 * erfinv_w(2.f * u - 1.f);
    v = v - floorf(v);
    out[row + d] = fminf(fmaxf(large ? fresh : v, 0.f), ONE_MINUS);
  }
}

// adds rgb * w of one contribution at pixel p, skipping zero terms
__device__ __forceinline__ void splat_add(float* splat, int n_pix, int p, const float* rgb,
                                          float w) {
  const float r = rgb[0] * w, g = rgb[1] * w, b = rgb[2] * w;
  if ((r == 0.f && g == 0.f && b == 0.f) || p < 0 || p >= n_pix) return;
  atomicAdd(splat + 3 * (size_t)p, r);
  atomicAdd(splat + 3 * (size_t)p + 1, g);
  atomicAdd(splat + 3 * (size_t)p + 2, b);
}

__global__ void accept_splat_kernel(float* __restrict__ splat, float* __restrict__ heat,
                                    float* __restrict__ x_cur, int* __restrict__ pix_cur,
                                    float* __restrict__ rgb_cur, float* __restrict__ y_cur,
                                    const float* __restrict__ x_prop,
                                    const int* __restrict__ pix_prop,
                                    const float* __restrict__ rgb_prop,
                                    const float* __restrict__ y_prop, float* __restrict__ a_out,
                                    int R, int D, int C, int n_pix, uint32_t seed,
                                    uint32_t pass) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= R) return;
  const float yc = y_cur[c], yp = y_prop[c];
  const float a = yc > 0.f ? fminf(yp / fmaxf(yc, 1e-12f), 1.f) : 1.f;
  const float w_prop = yp > 0.f ? a / fmaxf(yp, 1e-12f) : 0.f;
  const float w_cur = yc > 0.f ? (1.f - a) / fmaxf(yc, 1e-12f) : 0.f;
  for (int k = 0; k < C; ++k) {
    const size_t i = (size_t)k * R + c;
    splat_add(splat, n_pix, pix_prop[i], rgb_prop + 3 * i, w_prop);
    splat_add(splat, n_pix, pix_cur[i], rgb_cur + 3 * i, w_cur);
  }
  if (yp > 0.f && pix_prop[c] >= 0 && pix_prop[c] < n_pix) atomicAdd(heat + pix_prop[c], a);
  if (yc > 0.f && pix_cur[c] >= 0 && pix_cur[c] < n_pix) atomicAdd(heat + pix_cur[c], 1.f - a);
  a_out[c] = a;
  Pcg32 r = chain_stream(seed, ACCEPT, pass, (uint32_t)c);
  if (!(pcg32_uniform(r) < a)) return;
  const size_t row = (size_t)c * D;
  for (int d = 0; d < D; ++d) x_cur[row + d] = x_prop[row + d];
  for (int k = 0; k < C; ++k) {
    const size_t i = (size_t)k * R + c;
    pix_cur[i] = pix_prop[i];
#pragma unroll
    for (int q = 0; q < 3; ++q) rgb_cur[3 * i + q] = rgb_prop[3 * i + q];
  }
  y_cur[c] = yp;
}

}  // namespace

extern "C" int pbrt_mlt_mutate(const float* x, float* out, float* draws, int R, int D,
                               unsigned seed, unsigned pass, cudaStream_t stream) {
  mutate_kernel<<<(R + 127) / 128, 128, 0, stream>>>(x, out, draws, R, D, seed, pass);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_mlt_accept_splat(float* splat, float* heat, float* x_cur, int* pix_cur,
                                     float* rgb_cur, float* y_cur, const float* x_prop,
                                     const int* pix_prop, const float* rgb_prop,
                                     const float* y_prop, float* a_out, int R, int D, int C,
                                     int n_pix, unsigned seed, unsigned pass,
                                     cudaStream_t stream) {
  accept_splat_kernel<<<(R + 127) / 128, 128, 0, stream>>>(splat, heat, x_cur, pix_cur,
                                                           rgb_cur, y_cur, x_prop, pix_prop,
                                                           rgb_prop, y_prop, a_out, R, D, C,
                                                           n_pix, seed, pass);
  return (int)cudaGetLastError();
}
