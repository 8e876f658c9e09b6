// K5 and K5s: film sample and splat accumulation for Hopper (sm_90a), three
// entry points.
//
// Replaces the TPU hot paths pbrt_tpu/film/film.py:44 `add_samples`, :54
// `add_samples_tiled` (K5) and :70 `add_splats` (K5s), with colorspace.py:50
// `to_sensor_rgb`. Per lane:
// look up the CIE X, Y, Z curves at the 4 wavelengths (nearest 1 nm bin,
// round half to even), s = L / pdf (0 where pdf == 0, and +0, or NaN for a
// NaN pdf, where L == 0, without dividing), x = ((X0 s0 + X1 s1)
// + X2 s2) + X3 s3, then x / 4, non-finite components zeroed; the lane's
// value is (w x, w y, w z, w). Built with --fmad=false, so every operation
// rounds as the plain version's (film/film_kernel.py `lane_values`).
//
//   pbrt_film_add_tiled    a wave of k replicates of n distinct pixel ids,
//                          lane j n + p (the batched loop, BDPT's L, the
//                          pixel-parallel render). G lanes of a warp share a
//                          pixel: lane g sums replicates g, g + G, g + 2G, ...
//                          in order from +0; a shuffle tree adds the G
//                          partial sums as ((a0 + a1) + (a2 + a3)) + ...;
//                          one plain read-add-write of the pixel follows.
//                          No atomics: the sums are the same bits on every
//                          run, and the plain version's (`add_samples_tiled_
//                          plain`) bit for bit.
//   pbrt_film_add_scatter  any pixel ids (the wavefront loop): one thread a
//                          lane, four relaxed atomic adds whose result is
//                          unused (RED), none for a lane of weight 0 (adding
//                          +-0 to a film that starts at +0 changes nothing).
//                          The order of the adds is free, so the sums agree
//                          with the plain version to float rounding.
//   pbrt_film_add_splats   BDPT's light-tracing (t = 1) splats, weight 1, into
//                          the splat film (K5s): a wave's splats are its n_lam
//                          lanes' strategies stacked, splat m n_lam + j read
//                          against lane j's wavelengths. A thread takes a wave
//                          lane j and goes through its splats j, j + n_lam,
//                          ... in order, so a warp's loads of L are
//                          coalesced; it reads j's lam and pdf rows once, at
//                          its first splat whose L row is not all zero. Most
//                          splats are zero (strategies that did not connect):
//                          a row of four zeros gives s = 0 (or NaN, zeroed),
//                          so such a splat reads nothing more and takes no
//                          atomic, nor does one whose XYZ is zero. The adds
//                          are relaxed atomics whose result is unused (RED),
//                          so the sums agree with the plain version
//                          (`add_splats_plain`) to float rounding.
//
// What bounds it on the H100: bytes. A lane is 52 bytes (L, lambda and pdf
// as three 16-byte rows, and its weight), read once with 16-byte vector
// loads that are marked evict-first (`__ldcs`: the lanes are read once, so
// they should not displace what the next kernels read from the L2); the CIE
// table is staged in shared memory once a block as one (X, Y, Z, 0) float4
// a 1 nm bin, so a wavelength takes one 16-byte shared load; a few dozen
// float ops a lane are nothing against the bytes. The tiled entry writes
// each pixel once (16 bytes read, 16 written), so at cornell-mesh's 2^20
// lanes over 65,536 pixels it moves ~57 MB. G is chosen by the wrapper
// (`tile_group`): 2 where k allows (8 lanes a thread at k = 16, their loads
// independent of each other), more only for waves of few pixels. The splat
// entry must read every splat's 16-byte L row, a live splat's pixel id and
// its pixel (read and written), and its lanes' lam and pdf rows once; a
// thread issues SPLAT_UNROLL of its L rows at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // a grid-stride loop past 8 blocks an SM
constexpr float FLT_MAX_ = 3.402823466e+38f;

// the block's copy of the (3, range) CIE X, Y, Z table, a float4 a bin
__device__ __forceinline__ void stage_cie(const float* __restrict__ cie, int range,
                                          float4* s_cie) {
  for (int i = threadIdx.x; i < range; i += blockDim.x)
    s_cie[i] = make_float4(cie[i], cie[range + i], cie[2 * range + i], 0.0f);
  __syncthreads();
}

__device__ __forceinline__ int lam_bin(float lam, int lambda_min, int range) {
  const int b = (int)rintf(lam) - lambda_min;  // rintf: round half to even
  return min(max(b, 0), range - 1);
}

__device__ __forceinline__ float finite_or_zero(float v) {
  return fabsf(v) <= FLT_MAX_ ? v : 0.0f;  // false for NaN and +-inf
}

// (w x, w y, w z, w) of one lane
__device__ __forceinline__ float4 lane_value(float4 L, float4 lam, float4 pdf, float w,
                                             const float4* s_cie, int lambda_min, int range) {
  const float Ls[4] = {L.x, L.y, L.z, L.w};
  const float ls[4] = {lam.x, lam.y, lam.z, lam.w};
  const float ps[4] = {pdf.x, pdf.y, pdf.z, pdf.w};
  float x = 0.0f, y = 0.0f, z = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // 0 / pdf is not divided: the film cannot tell its sign of zero, and a
    // zero radiance sent the division to its slow path on the card
    const float s = ps[j] == 0.0f ? 0.0f
                    : Ls[j] == 0.0f ? (isnan(ps[j]) ? ps[j] : 0.0f)
                                    : Ls[j] / ps[j];
    const float4 c = s_cie[lam_bin(ls[j], lambda_min, range)];
    x = j == 0 ? c.x * s : x + c.x * s;
    y = j == 0 ? c.y * s : y + c.y * s;
    z = j == 0 ? c.z * s : z + c.z * s;
  }
  return make_float4(w * finite_or_zero(x * 0.25f), w * finite_or_zero(y * 0.25f),
                     w * finite_or_zero(z * 0.25f), w);
}

__global__ void __launch_bounds__(THREADS)
film_add_tiled_kernel(const long long* __restrict__ pix, const float4* __restrict__ L,
                      const float4* __restrict__ lam, const float4* __restrict__ pdf,
                      const float* __restrict__ w, int n, int k, int G,
                      const float* __restrict__ cie, int lambda_min, int range,
                      float* __restrict__ rgb_sum, float* __restrict__ weight_sum) {
  extern __shared__ float4 s_cie[];
  stage_cie(cie, range, s_cie);
  // a warp holds P = 32 / G pixels; lane t takes pixel t % P and replicate
  // class g = t / P, so for each g the warp reads P consecutive rows
  const int P = 32 / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / P;
  const int per_block = (THREADS / 32) * P;
  // the loop bound is the same for every thread of the block, so every lane
  // reaches the shuffles
  for (long long base = (long long)blockIdx.x * per_block; base < n;
       base += (long long)gridDim.x * per_block) {
    const long long p = base + warp * P + lane % P;
    const bool in = p < n;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (in) {
#pragma unroll 4
      for (int j = g; j < k; j += G) {
        const long long i = (long long)j * n + p;
        const float4 v = lane_value(__ldcs(L + i), __ldcs(lam + i), __ldcs(pdf + i),
                                    __ldcs(w + i), s_cie, lambda_min, range);
        acc.x = acc.x + v.x;
        acc.y = acc.y + v.y;
        acc.z = acc.z + v.z;
        acc.w = acc.w + v.w;
      }
    }
    // partner t ^ off holds replicate class g ^ (off / P): level by level
    // (a0 + a1), then (a0 + a1) + (a2 + a3), ...; a + b == b + a bit for bit
    for (int off = P; off < 32; off <<= 1) {
      acc.x = acc.x + __shfl_xor_sync(0xffffffffu, acc.x, off);
      acc.y = acc.y + __shfl_xor_sync(0xffffffffu, acc.y, off);
      acc.z = acc.z + __shfl_xor_sync(0xffffffffu, acc.z, off);
      acc.w = acc.w + __shfl_xor_sync(0xffffffffu, acc.w, off);
    }
    if (in && g == 0) {
      const long long q = pix[p];
      rgb_sum[3 * q] = rgb_sum[3 * q] + acc.x;
      rgb_sum[3 * q + 1] = rgb_sum[3 * q + 1] + acc.y;
      rgb_sum[3 * q + 2] = rgb_sum[3 * q + 2] + acc.z;
      weight_sum[q] = weight_sum[q] + acc.w;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
film_add_scatter_kernel(const long long* __restrict__ pix, const float4* __restrict__ L,
                        const float4* __restrict__ lam, const float4* __restrict__ pdf,
                        const float* __restrict__ w, int n, const float* __restrict__ cie,
                        int lambda_min, int range, float* __restrict__ rgb_sum,
                        float* __restrict__ weight_sum) {
  extern __shared__ float4 s_cie[];
  stage_cie(cie, range, s_cie);
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) {
    const float wi = __ldcs(w + i);
    if (wi == 0.0f) continue;
    const float4 v = lane_value(__ldcs(L + i), __ldcs(lam + i), __ldcs(pdf + i), wi, s_cie,
                                lambda_min, range);
    const long long q = pix[i];
    // relaxed, result unused: compiles to RED.E.ADD.F32
    atomicAdd(rgb_sum + 3 * q, v.x);
    atomicAdd(rgb_sum + 3 * q + 1, v.y);
    atomicAdd(rgb_sum + 3 * q + 2, v.z);
    atomicAdd(weight_sum + q, v.w);
  }
}

// splats a thread has in flight
constexpr int SPLAT_UNROLL = 4;

__global__ void __launch_bounds__(THREADS)
film_add_splats_kernel(const long long* __restrict__ pix, const float4* __restrict__ L,
                       const float4* __restrict__ lam, const float4* __restrict__ pdf,
                       int n_lam, int reps, const float* __restrict__ cie, int lambda_min,
                       int range, float* __restrict__ splat) {
  extern __shared__ float4 s_cie[];
  stage_cie(cie, range, s_cie);
  for (int j = blockIdx.x * THREADS + threadIdx.x; j < n_lam; j += gridDim.x * THREADS) {
    float4 lam_j = make_float4(0.0f, 0.0f, 0.0f, 0.0f), pdf_j = lam_j;
    bool have = false;
    for (int m0 = 0; m0 < reps; m0 += SPLAT_UNROLL) {
      float4 Ls[SPLAT_UNROLL];
#pragma unroll
      for (int u = 0; u < SPLAT_UNROLL; ++u)
        Ls[u] = m0 + u < reps ? __ldcs(L + (long long)(m0 + u) * n_lam + j)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int u = 0; u < SPLAT_UNROLL; ++u) {
        const float4 l = Ls[u];
        if (l.x == 0.0f && l.y == 0.0f && l.z == 0.0f && l.w == 0.0f) continue;
        if (!have) {
          lam_j = __ldg(lam + j);
          pdf_j = __ldg(pdf + j);
          have = true;
        }
        const float4 v = lane_value(l, lam_j, pdf_j, 1.0f, s_cie, lambda_min, range);
        if (v.x == 0.0f && v.y == 0.0f && v.z == 0.0f) continue;
        const long long q = __ldcs(pix + (long long)(m0 + u) * n_lam + j);
        // relaxed, result unused: compiles to RED.E.ADD.F32
        atomicAdd(splat + 3 * q, v.x);
        atomicAdd(splat + 3 * q + 1, v.y);
        atomicAdd(splat + 3 * q + 2, v.z);
      }
    }
  }
}

int grid_for(long long items, int per_block) {
  const long long b = (items + per_block - 1) / per_block;
  return (int)(b < MAX_BLOCKS ? (b > 0 ? b : 1) : MAX_BLOCKS);
}

}  // namespace

// pix (n,) int64 distinct ids; L, lam, pdf (k n, 4) float32 rows, 16-byte
// aligned; w (k n,); G in {1, 2, 4, 8, 16, 32}; cie (3, range) float32;
// rgb_sum (P, 3) and weight_sum (P,) updated in place. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int pbrt_film_add_tiled(const long long* pix, const float* L, const float* lam,
                                   const float* pdf, const float* w, int n, int k, int G,
                                   const float* cie, int lambda_min, int range,
                                   float* rgb_sum, float* weight_sum, cudaStream_t stream) {
  if (n <= 0 || k <= 0) return 0;
  const int blocks = grid_for(n, (THREADS / 32) * (32 / G));
  film_add_tiled_kernel<<<blocks, THREADS, range * sizeof(float4), stream>>>(
      pix, (const float4*)L, (const float4*)lam, (const float4*)pdf, w, n, k, G, cie,
      lambda_min, range, rgb_sum, weight_sum);
  return (int)cudaGetLastError();
}

// pix (n,) int64 any ids; the rest as pbrt_film_add_tiled with k = 1.
extern "C" int pbrt_film_add_scatter(const long long* pix, const float* L, const float* lam,
                                     const float* pdf, const float* w, int n,
                                     const float* cie, int lambda_min, int range,
                                     float* rgb_sum, float* weight_sum, cudaStream_t stream) {
  if (n <= 0) return 0;
  film_add_scatter_kernel<<<grid_for(n, THREADS), THREADS, range * sizeof(float4), stream>>>(
      pix, (const float4*)L, (const float4*)lam, (const float4*)pdf, w, n, cie, lambda_min,
      range, rgb_sum, weight_sum);
  return (int)cudaGetLastError();
}

// pix (reps n_lam,) int64 any ids; L (reps n_lam, 4) float32 rows, lam and
// pdf (n_lam, 4), all 16-byte aligned; splat (P, 3) updated in place.
extern "C" int pbrt_film_add_splats(const long long* pix, const float* L, const float* lam,
                                    const float* pdf, int n_lam, int reps, const float* cie,
                                    int lambda_min, int range, float* splat,
                                    cudaStream_t stream) {
  if (n_lam <= 0 || reps <= 0) return 0;
  film_add_splats_kernel<<<grid_for(n_lam, THREADS), THREADS, range * sizeof(float4),
                           stream>>>(pix, (const float4*)L, (const float4*)lam,
                                     (const float4*)pdf, n_lam, reps, cie, lambda_min, range,
                                     splat);
  return (int)cudaGetLastError();
}
