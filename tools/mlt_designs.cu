// K12m-a and K12m-b (csrc/mlt.cu): designs measured against the kernels the
// port runs and not kept. csrc/mlt.cu is included whole, so its kernels are
// here at either lane count; beside them, K12m-a as one thread a (chain,
// dimension). Built and timed by tools/mlt_designs.py.
#include "../pbrt_tpu_torch/csrc/mlt.cu"

namespace {

// 2^b PCG32 steps: the map of 2^(b-1) steps applied twice
__host__ __device__ constexpr Jump doubled(int b) {
  Jump j{PCG32_MULT, 1ULL};
  for (int i = 0; i < b; ++i) j = Jump{j.a * j.a, j.a * j.s + j.s};
  return j;
}

#define MLT_POW4(b) doubled(b), doubled(b + 1), doubled(b + 2), doubled(b + 3)
__device__ const Jump POW2_JUMP[16] = {MLT_POW4(0), MLT_POW4(4), MLT_POW4(8), MLT_POW4(12)};
#undef MLT_POW4

// one thread a (chain, dimension), dimensions fastest: each thread seeds its
// chain's stream and jumps to draw 1 + 2 d through the powers of two
__global__ void __launch_bounds__(BLOCK)
    mutate_dim_kernel(const float* __restrict__ x, float* __restrict__ out,
                      float* __restrict__ draws, int R, int D, uint32_t seed, uint32_t pass) {
  const long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (t >= (long long)R * D) return;
  const int c = (int)(t / D), d = (int)(t % D);
  const Pcg32 r0 = chain_stream(seed, MUTATE, pass, (uint32_t)c);
  const float u_large = uniform_at(r0.state);
  uint64_t s = r0.state;
  const unsigned k = 1u + 2u * (unsigned)d;
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (k >> b & 1u) s = POW2_JUMP[b].a * s + r0.inc * POW2_JUMP[b].s;
  const uint64_t s_u = s * PCG32_MULT + r0.inc;
  if (draws) {
    float* dr = draws + (size_t)c * (1 + 2 * D);
    if (d == 0) dr[0] = u_large;
    dr[1 + 2 * d] = uniform_at(s);
    dr[2 + 2 * d] = uniform_at(s_u);
  }
  float v;
  if (u_large < P_LARGE) {
    v = uniform_at(s);
  } else {
    v = x[t] + SIGMA_SQRT2 * erfinv_w(2.f * uniform_at(s_u) - 1.f);
    v = v - floorf(v);
  }
  out[t] = fminf(fmaxf(v, 0.f), ONE_MINUS);
}

// the port's lane groups with one loop, the kind of step a branch in it
template <int G>
__global__ void __launch_bounds__(BLOCK)
    mutate_branch_kernel(const float* __restrict__ x, float* __restrict__ out,
                         float* __restrict__ draws, int R, int D, uint32_t seed,
                         uint32_t pass) {
  const int c = blockIdx.x * (BLOCK / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  if (c >= R) return;
  const Pcg32 r0 = chain_stream(seed, MUTATE, pass, (uint32_t)c);
  const float u_large = uniform_at(r0.state);
  const bool large = u_large < P_LARGE;
  const Jump first = LANE_JUMP[lane];
  constexpr Jump step = jump(2 * G);
  const uint64_t step_inc = r0.inc * step.s;
  uint64_t s = first.a * r0.state + r0.inc * first.s;
  const size_t row = (size_t)c * D;
  float* dr = draws ? draws + (size_t)c * (1 + 2 * D) : nullptr;
  if (dr && lane == 0) dr[0] = u_large;
  for (int d = lane; d < D; d += G) {
    const uint64_t s_u = s * PCG32_MULT + r0.inc;
    if (dr) {
      dr[1 + 2 * d] = uniform_at(s);
      dr[2 + 2 * d] = uniform_at(s_u);
    }
    float v;
    if (large) {
      v = uniform_at(s);
    } else {
      v = x[row + d] + SIGMA_SQRT2 * erfinv_w(2.f * uniform_at(s_u) - 1.f);
      v = v - floorf(v);
    }
    out[row + d] = fminf(fmaxf(v, 0.f), ONE_MINUS);
    s = step.a * s + step_inc;
  }
}

__global__ void empty_kernel() {}

template <int G>
void mutate_branch(const float* x, float* out, float* draws, int R, int D, unsigned seed,
                   unsigned pass, cudaStream_t stream) {
  mutate_branch_kernel<G><<<blocks_for<G>(R), BLOCK, 0, stream>>>(x, out, draws, R, D, seed,
                                                                   pass);
}

template <int G>
void mutate_groups(const float* x, float* out, float* draws, int R, int D, unsigned seed,
                   unsigned pass, cudaStream_t stream) {
  mutate_kernel<G><<<blocks_for<G>(R), BLOCK, 0, stream>>>(x, out, draws, R, D, seed, pass);
}

template <int G>
void accept_groups(float* splat, float* heat, float* x_cur, int* pix_cur, float* rgb_cur,
                   float* y_cur, const float* x_prop, const int* pix_prop,
                   const float* rgb_prop, const float* y_prop, float* a_out, int R, int D,
                   int C, int n_pix, unsigned seed, unsigned pass, cudaStream_t stream) {
  accept_splat_kernel<G><<<blocks_for<G>(R), BLOCK, 0, stream>>>(
      splat, heat, x_cur, pix_cur, rgb_cur, y_cur, x_prop, pix_prop, rgb_prop, y_prop, a_out, R,
      D, C, n_pix, seed, pass);
}

}  // namespace

// design 0: 32 lanes a chain; 1: 16 lanes; 2: a thread a (chain, dimension);
// 3: 8 lanes; 4, 5: 32, 16 lanes with one loop, the kind of step a branch
extern "C" int pbrt_mlt_design_mutate(int design, const float* x, float* out, float* draws,
                                      int R, int D, unsigned seed, unsigned pass,
                                      cudaStream_t stream) {
  if (design >= 4) {
    auto run = design == 4 ? mutate_branch<32> : mutate_branch<16>;
    run(x, out, draws, R, D, seed, pass, stream);
  } else if (design == 0) {
    mutate_groups<32>(x, out, draws, R, D, seed, pass, stream);
  } else if (design == 1) {
    mutate_groups<16>(x, out, draws, R, D, seed, pass, stream);
  } else if (design == 3) {
    mutate_groups<8>(x, out, draws, R, D, seed, pass, stream);
  } else {
    if (D >= 1 << 15) return -1;
    mutate_dim_kernel<<<(int)(((long long)R * D + BLOCK - 1) / BLOCK), BLOCK, 0, stream>>>(
        x, out, draws, R, D, seed, pass);
  }
  return (int)cudaGetLastError();
}

// design 0: 32 lanes a chain; 1: 16 lanes; 2: 8 lanes
extern "C" int pbrt_mlt_design_accept(int design, float* splat, float* heat, float* x_cur,
                                      int* pix_cur, float* rgb_cur, float* y_cur,
                                      const float* x_prop, const int* pix_prop,
                                      const float* rgb_prop, const float* y_prop, float* a_out,
                                      int R, int D, int C, int n_pix, unsigned seed,
                                      unsigned pass, cudaStream_t stream) {
  auto run = design == 0 ? accept_groups<32> : design == 1 ? accept_groups<16>
                                                            : accept_groups<8>;
  run(splat, heat, x_cur, pix_cur, rgb_cur, y_cur, x_prop, pix_prop, rgb_prop, y_prop, a_out, R,
      D, C, n_pix, seed, pass, stream);
  return (int)cudaGetLastError();
}

// not a design: one empty block, the least a launch in a graph costs
extern "C" int pbrt_mlt_design_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
