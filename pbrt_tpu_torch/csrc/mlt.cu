// K12m: the Markov-chain steps of Metropolis light transport, a group of
// lanes a chain.
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
// What bounds it on the H100: bytes (~10 MB a pass at 8192 chains and D =
// 160, ~3 us at 3.35 TB/s) and, for K12m-a, the issue of each dimension's
// erfinv (a logf and two IEEE square roots) and u64 stream arithmetic, which
// takes it to ~2.5x its byte bound (PERF.md). One thread a chain would give
// 8192 chains 64 blocks of 128 for 132 SMs, a serial walk of 1 + 2 D
// dependent PCG32 steps, and loads strided by D floats across a warp. So
// each chain has a group of G lanes, lane l on dimensions l, l + G, ...: the
// group's loads and stores are consecutive words, and the chains fill the
// card.
// Each lane starts on its own point of the chain's stream by a jump ahead
// (k PCG32 steps from state s are A_k s + inc S_k mod 2^64, with A_k =
// MULT^k and S_k = sum_{i<k} MULT^i the same for every chain): lane l at
// draw 1 + 2 l, then 2 G draws on at each step, so the draws keep their bits
// (integrators/mlt.py `strided_chain_uniforms` spells the same order).
// Every lane of a group seeds the chain's stream and computes its
// acceptance itself: a warp issues an instruction once for all its lanes,
// so the lanes get the same bits for the price of one, with no shuffle.
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

// lanes a chain (integrators/mlt.py MUTATE_LANES, ACCEPT_LANES; the fastest
// over both MLT frames' shapes of those tools/mlt_designs.py times) and
// threads a block: 8192 chains are 1024 blocks at 32 lanes, 512 at 16
constexpr int MUTATE_LANES = 32, ACCEPT_LANES = 16;
constexpr int BLOCK = 256;

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

// k PCG32 steps as one affine map: state -> a state + inc s (sampling/rng.py
// `jump`)
struct Jump {
  uint64_t a, s;
};

__host__ __device__ constexpr Jump jump(int k) {
  Jump j{1ULL, 0ULL};
  for (int i = 0; i < k; ++i) j = Jump{j.a * PCG32_MULT, j.s * PCG32_MULT + 1ULL};
  return j;
}

// lane l's first draw, 1 + 2 l (integrators/mlt.py `lane_jumps`)
#define MLT_JUMPS4(l) jump(2 * (l) + 1), jump(2 * (l) + 3), jump(2 * (l) + 5), jump(2 * (l) + 7)
__device__ const Jump LANE_JUMP[32] = {MLT_JUMPS4(0),  MLT_JUMPS4(4),  MLT_JUMPS4(8),
                                       MLT_JUMPS4(12), MLT_JUMPS4(16), MLT_JUMPS4(20),
                                       MLT_JUMPS4(24), MLT_JUMPS4(28)};
#undef MLT_JUMPS4

// Winitzki's erfinv, clipped as in mlt.py `_erfinv`
__device__ __forceinline__ float erfinv_w(float x) {
  x = fminf(fmaxf(x, -0.99999f), 0.99999f);
  const float ln1mx2 = logf(fmaxf((1.f - x) * (1.f + x), 1e-30f));
  const float term = TWO_OVER_PI_A + ln1mx2 / 2.f;
  const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sgn * sqrtf(sqrtf(fmaxf(term * term - ln1mx2 * INV_A, 0.f)) - term);
}

// the uniform PCG32 draws from state s
__device__ __forceinline__ float uniform_at(uint64_t s) {
  Pcg32 r{s, 0ULL};
  return pcg32_uniform(r);
}

template <int G>
__global__ void __launch_bounds__(BLOCK)
    mutate_kernel(const float* __restrict__ x, float* __restrict__ out,
                  float* __restrict__ draws, int R, int D, uint32_t seed, uint32_t pass) {
  static_assert(G <= 32 && 32 % G == 0, "a chain's lanes lie in one warp");
  const int c = blockIdx.x * (BLOCK / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  if (c >= R) return;
  const Pcg32 r0 = chain_stream(seed, MUTATE, pass, (uint32_t)c);
  const float u_large = uniform_at(r0.state);   // draw 0
  const bool large = u_large < P_LARGE;
  const Jump first = LANE_JUMP[lane];
  constexpr Jump step = jump(2 * G);
  const uint64_t step_inc = r0.inc * step.s;
  uint64_t s = first.a * r0.state + r0.inc * first.s;   // draw 1 + 2 lane
  const size_t row = (size_t)c * D;
  float* dr = draws ? draws + (size_t)c * (1 + 2 * D) : nullptr;
  if (dr && lane == 0) dr[0] = u_large;
  // a large step takes the fresh uniforms and reads no x: a loop for each
  // kind of step, which a chain's lanes share, unrolled twice
  if (large) {
#pragma unroll 2
    for (int d = lane; d < D; d += G) {
      if (dr) {
        dr[1 + 2 * d] = uniform_at(s);
        dr[2 + 2 * d] = uniform_at(s * PCG32_MULT + r0.inc);
      }
      out[row + d] = fminf(fmaxf(uniform_at(s), 0.f), ONE_MINUS);
      s = step.a * s + step_inc;
    }
    return;
  }
#pragma unroll 2
  for (int d = lane; d < D; d += G) {
    const uint64_t s_u = s * PCG32_MULT + r0.inc;      // draw 2 + 2 d
    if (dr) {
      dr[1 + 2 * d] = uniform_at(s);
      dr[2 + 2 * d] = uniform_at(s_u);
    }
    float v = x[row + d] + SIGMA_SQRT2 * erfinv_w(2.f * uniform_at(s_u) - 1.f);
    v = v - floorf(v);
    out[row + d] = fminf(fmaxf(v, 0.f), ONE_MINUS);
    s = step.a * s + step_inc;                          // draw 1 + 2 (d + G)
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

// one contribution of both states: pixels and RGB
struct Terms {
  int pp, pc;
  float rp[3], rc[3];
};

__device__ __forceinline__ Terms load_terms(const int* pix_prop, const int* pix_cur,
                                            const float* rgb_prop, const float* rgb_cur,
                                            size_t i) {
  Terms t;
  t.pp = pix_prop[i];
  t.pc = pix_cur[i];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    t.rp[q] = rgb_prop[3 * i + q];
    t.rc[q] = rgb_cur[3 * i + q];
  }
  return t;
}

// Lane k of a chain's group takes contribution k of both states (k, k + G,
// ... for C > G): their splats, the heat of contribution 0 on lane 0, and
// on accept the proposal's pixel and RGB, which it holds, written into the
// state. The D floats of the row are copied by the group, consecutive lanes
// on consecutive words. No lane reads what another writes but y_cur, which
// lane 0 writes after the group's __syncwarp; a lane's first contribution
// is loaded beside y, before it.
template <int G>
__global__ void __launch_bounds__(BLOCK)
    accept_splat_kernel(float* __restrict__ splat, float* __restrict__ heat,
                        float* __restrict__ x_cur, int* __restrict__ pix_cur,
                        float* __restrict__ rgb_cur, float* __restrict__ y_cur,
                        const float* __restrict__ x_prop, const int* __restrict__ pix_prop,
                        const float* __restrict__ rgb_prop, const float* __restrict__ y_prop,
                        float* __restrict__ a_out, int R, int D, int C, int n_pix,
                        uint32_t seed, uint32_t pass) {
  static_assert(G <= 32 && 32 % G == 0, "a chain's lanes lie in one warp");
  const int c = blockIdx.x * (BLOCK / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  if (c >= R) return;                   // the whole group: its mask below is its own
  const unsigned group = G == 32 ? 0xffffffffu
                                 : ((1u << G) - 1u) << ((threadIdx.x % 32) / G * G);
  const float yc = y_cur[c], yp = y_prop[c];
  Terms t{};
  if (lane < C) t = load_terms(pix_prop, pix_cur, rgb_prop, rgb_cur, (size_t)lane * R + c);
  const float a = yc > 0.f ? fminf(yp / fmaxf(yc, 1e-12f), 1.f) : 1.f;
  const float w_prop = yp > 0.f ? a / fmaxf(yp, 1e-12f) : 0.f;
  const float w_cur = yc > 0.f ? (1.f - a) / fmaxf(yc, 1e-12f) : 0.f;
  Pcg32 r = chain_stream(seed, ACCEPT, pass, (uint32_t)c);
  const bool acc = pcg32_uniform(r) < a;
  if (lane == 0) a_out[c] = a;
  __syncwarp(group);                    // every lane has read y_cur[c]
  for (int k = lane; k < C; k += G) {
    const size_t i = (size_t)k * R + c;
    if (k != lane) t = load_terms(pix_prop, pix_cur, rgb_prop, rgb_cur, i);
    splat_add(splat, n_pix, t.pp, t.rp, w_prop);
    splat_add(splat, n_pix, t.pc, t.rc, w_cur);
    if (k == 0) {
      if (yp > 0.f && t.pp >= 0 && t.pp < n_pix) atomicAdd(heat + t.pp, a);
      if (yc > 0.f && t.pc >= 0 && t.pc < n_pix) atomicAdd(heat + t.pc, 1.f - a);
    }
    if (acc) {
      pix_cur[i] = t.pp;
#pragma unroll
      for (int q = 0; q < 3; ++q) rgb_cur[3 * i + q] = t.rp[q];
    }
  }
  if (!acc) return;
  const size_t row = (size_t)c * D;
  for (int d = lane; d < D; d += G) x_cur[row + d] = x_prop[row + d];
  if (lane == 0) y_cur[c] = yp;
}

template <int G>
inline int blocks_for(int R) {
  return (int)(((long long)R * G + BLOCK - 1) / BLOCK);
}

}  // namespace

extern "C" int pbrt_mlt_mutate(const float* x, float* out, float* draws, int R, int D,
                               unsigned seed, unsigned pass, cudaStream_t stream) {
  constexpr int G = MUTATE_LANES;
  mutate_kernel<G><<<blocks_for<G>(R), BLOCK, 0, stream>>>(x, out, draws, R, D, seed, pass);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_mlt_accept_splat(float* splat, float* heat, float* x_cur, int* pix_cur,
                                     float* rgb_cur, float* y_cur, const float* x_prop,
                                     const int* pix_prop, const float* rgb_prop,
                                     const float* y_prop, float* a_out, int R, int D, int C,
                                     int n_pix, unsigned seed, unsigned pass,
                                     cudaStream_t stream) {
  constexpr int G = ACCEPT_LANES;
  accept_splat_kernel<G><<<blocks_for<G>(R), BLOCK, 0, stream>>>(
      splat, heat, x_cur, pix_cur, rgb_cur, y_cur, x_prop, pix_prop, rgb_prop, y_prop, a_out, R,
      D, C, n_pix, seed, pass);
  return (int)cudaGetLastError();
}
