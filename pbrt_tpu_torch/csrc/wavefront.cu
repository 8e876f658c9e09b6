// Lane recycling of the wavefront render loop, for Hopper (sm_90a): rank the
// lanes of the pool that finished their path this step and hand each the
// next (pixel, sample) work item.
//
// Replaces the TPU hot path pbrt_tpu/integrators/render.py:228
// `_wavefront_loop` (its recycle step :316-332: `rank = cumsum(finished) - 1`,
// `work = next_work + rank`, `recycle = finished & (work < total)`,
// `in_flight = (in_flight & ~finished) | recycle`, `next_work += sum(recycle)`).
//
// Design: an exclusive scan of the finished mask in two launches.
//  1. Each block of 1024 lanes counts its finished lanes and its lanes that
//     stay in flight; block 0 also copies next_work into a scratch slot, so
//     the second launch reads a value no block is about to overwrite.
//  2. Each block sums the counts of the blocks before it, scans its own
//     lanes (warp shuffles, then the warp totals), and writes rank, work,
//     recycle and in_flight. Block 0 sums all counts and advances the device
//     scalars next_work and n_in_flight, so the host never needs the rank
//     and reads one integer (n_in_flight) per loop iteration.
// Integer sums in a fixed order: the rank equals torch.cumsum's bit for bit.
//
// What bounds it on the H100: bytes. It reads 2 bytes a lane and writes 14
// (rank i32, work i64, two masks), so a pool of 2^19 lanes moves 8 MB,
// ~2.5 us at 3.35 TB/s; two launches of 512 blocks cost more than that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ int block_sum(int v, int* warp_buf) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) warp_buf[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) total += warp_buf[w];
  return total;  // valid in thread 0
}

__global__ void __launch_bounds__(THREADS)
recycle_count_kernel(const uint8_t* __restrict__ finished,
                     const uint8_t* __restrict__ in_flight, int n,
                     int* __restrict__ counts, const long long* __restrict__ next_work,
                     long long* __restrict__ base) {
  __shared__ int warp_buf[WARPS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int f = i < n && finished[i];
  const int stay = i < n && in_flight[i] && !finished[i];
  const int nf = block_sum(f, warp_buf);
  const int ns = block_sum(stay, warp_buf);
  if (threadIdx.x == 0) {
    counts[2 * blockIdx.x] = nf;
    counts[2 * blockIdx.x + 1] = ns;
    if (blockIdx.x == 0) *base = *next_work;
  }
}

__global__ void __launch_bounds__(THREADS)
recycle_scan_kernel(const uint8_t* __restrict__ finished,
                    const uint8_t* __restrict__ in_flight, int n, long long total,
                    const int* __restrict__ counts, int n_blocks,
                    const long long* __restrict__ base, int* __restrict__ rank,
                    long long* __restrict__ work, uint8_t* __restrict__ recycle,
                    uint8_t* __restrict__ in_flight_out,
                    long long* __restrict__ next_work,
                    long long* __restrict__ n_in_flight) {
  __shared__ int warp_buf[WARPS];
  __shared__ int warp_pre[WARPS];
  __shared__ int block_pre;
  // prefix of the finished counts of the blocks before this one
  int acc = 0;
  for (int b = threadIdx.x; b < blockIdx.x; b += THREADS) acc += counts[2 * b];
  const int pre = block_sum(acc, warp_buf);
  if (threadIdx.x == 0) block_pre = pre;

  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int f = i < n && finished[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = f;  // inclusive scan within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  __syncthreads();
  if (lane == 31) warp_pre[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_pre[w];
      warp_pre[w] = run;
      run += c;
    }
  }
  __syncthreads();
  const long long b0 = *base;
  if (i < n) {
    const int excl = block_pre + warp_pre[warp] + incl - f;
    const long long w = b0 + excl;
    const bool rec = f && w < total;
    rank[i] = excl;
    work[i] = w;
    recycle[i] = rec;
    in_flight_out[i] = (in_flight[i] && !f) || rec;
  }
  if (blockIdx.x == 0) {
    int nf = 0, ns = 0;
    for (int b = threadIdx.x; b < n_blocks; b += THREADS) {
      nf += counts[2 * b];
      ns += counts[2 * b + 1];
    }
    const int all_f = block_sum(nf, warp_buf);
    const int all_s = block_sum(ns, warp_buf);
    if (threadIdx.x == 0) {
      long long left = total - b0;
      long long n_rec = left < 0 ? 0 : (all_f < left ? all_f : left);
      *next_work = b0 + n_rec;
      *n_in_flight = all_s + n_rec;
    }
  }
}

}  // namespace

extern "C" int pbrt_wavefront_blocks(int n) { return (n + THREADS - 1) / THREADS; }

// finished, in_flight: (n,) bool as bytes. counts: (2 * blocks,) int32
// scratch; base: one int64 scratch slot. Outputs: rank (n,) int32 exclusive
// rank among finished lanes, work (n,) int64 = next_work + rank, recycle and
// in_flight_out (n,) bool. next_work and n_in_flight are int64 device
// scalars; next_work is advanced in place. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int pbrt_wavefront_recycle(const uint8_t* finished, const uint8_t* in_flight,
                                      int n, long long total, int* counts,
                                      long long* base, int* rank, long long* work,
                                      uint8_t* recycle, uint8_t* in_flight_out,
                                      long long* next_work, long long* n_in_flight,
                                      void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = pbrt_wavefront_blocks(n);
  recycle_count_kernel<<<blocks, THREADS, 0, s>>>(finished, in_flight, n, counts,
                                                  next_work, base);
  int err = (int)cudaGetLastError();
  if (err) return err;
  recycle_scan_kernel<<<blocks, THREADS, 0, s>>>(finished, in_flight, n, total, counts,
                                                 blocks, base, rank, work, recycle,
                                                 in_flight_out, next_work, n_in_flight);
  return (int)cudaGetLastError();
}
