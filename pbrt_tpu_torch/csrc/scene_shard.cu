// Scene-sharded traversal for Hopper (sm_90a): the closest hit and the any
// hit over the parts of a morton-split triangle soup that one rank holds,
// each part with its own wide BVH, and the selection of the winner among the
// ranks' candidate packs after their all_gather.
//
// Replaces the TPU hot paths pbrt_tpu/parallel/scene_shard.py:226
// `closest_hit_local` (K11a: the per-device `bvh._traverse` of the local
// sub-BVH, then an all_gather of the (R, 1 + 27 + 9) candidate pack and an
// argmin over the device axis) and :256 `any_hit_local` (K11b: the any-hit
// traversal and a pmax over the device axis).
//
// Design. K11a `bvh_closest_parts`: one thread per ray loops over the rank's
// parts; part p's traversal is the stepper of bvh_stepper.cuh over rows[p]
// (the K1 loop, unchanged). t_best is carried from part to part and a hit is
// taken only when strictly nearer, so the first part wins an exact tie, as
// jnp.argmin does over P independent traversals; the argmin over parts is
// done in registers, with no (P, R) intermediate. The thread then writes its
// winner's pack row of 37 floats: t (inf on a miss) and recv[part, prim]
// (the 27-float hit record, then p0, p1, p2), zeros on a miss. K11b
// `bvh_any_parts` is the ANY_HIT instance: it stops at the first part that
// reports a hit and writes one byte a ray. `shard_select` takes the
// all-gathered packs (W, R, 37) and writes, per ray, the row of the first
// rank with the least t: ranks hold contiguous part ranges, so that is the
// global argmin order. One thread per output float: a scan over the short
// rank axis and a coalesced copy.
//
// What bounds it on the H100: as K1, latency and divergence rather than
// bytes or operations: each ray walks every part's tree (P roots instead of
// one), the trees stay in the 50 MB L2, and a pack row is written once. The
// select kernel moves (W + 1) x 148 bytes a ray and is bound by bytes. This
// first version is plain and right; sorting rays or walking the parts
// nearest first are later work. Built with --fmad=false, as K1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_stepper.cuh"

namespace {

constexpr int REC_W = 36;        // recv row: 27-float tri_rec row, p0, p1, p2
constexpr int PACK_W = 1 + REC_W;
constexpr int THREADS = 128;

template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS)
parts_kernel(const float* __restrict__ rows, int n_parts, int n_rows, int n_int,
             const float* __restrict__ recv, int n_recv,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_max, int n_rays,
             float* __restrict__ pack_out, uint8_t* __restrict__ hit_out,
             int* __restrict__ overflow, int stack_depth,
             unsigned long long* __restrict__ stats) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  float t_best = t_max[r];
  int win_part = -1, win_prim = -1;
  if (t_best > 0.f) {
    const pbrt_bvh::Ray ray = pbrt_bvh::make_ray(o + 3 * r, d + 3 * r);
    pbrt_bvh::Counts c;
    bool ok = true;
    for (int p = 0; p < n_parts; ++p) {
      int prim = -1;
      ok &= pbrt_bvh::traverse<ANY_HIT>(rows + (long long)p * n_rows * pbrt_bvh::ROW_W,
                                        n_rows, n_int, ray, stack_depth, t_best, prim, c);
      if (prim >= 0) {
        win_part = p;
        win_prim = prim;
        if (ANY_HIT) break;
      }
    }
    if (!ok) atomicAdd(overflow, 1);
    pbrt_bvh::add_counts(stats, c);
  }
  if (ANY_HIT) {
    hit_out[r] = win_part >= 0;
    return;
  }
  float* out = pack_out + (long long)r * PACK_W;
  if (win_part < 0) {
    out[0] = __int_as_float(0x7f800000);  // +inf
    for (int j = 0; j < REC_W; ++j) out[1 + j] = 0.f;
    return;
  }
  const float* src = recv + ((long long)win_part * n_recv + win_prim) * REC_W;
  out[0] = t_best;
  for (int j = 0; j < REC_W; ++j) out[1 + j] = src[j];
}

// One thread per output float: the threads of a ray's row each scan its
// ranks' t (the same few cache lines) and copy one element, so loads and
// stores are coalesced.
__global__ void __launch_bounds__(THREADS)
select_kernel(const float* __restrict__ packs, int n_ranks, int n_rays,
              float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)n_rays * PACK_W;
  if (i >= stride) return;
  const long long r = i / PACK_W;
  const float* row = packs + r * PACK_W;
  int best = 0;
  float t_best = row[0];
  for (int w = 1; w < n_ranks; ++w) {
    const float t = row[w * stride];
    if (t < t_best) { t_best = t; best = w; }
  }
  out[i] = packs[best * stride + i];
}

inline int blocks_for(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int pbrt_parts_max_stack() { return pbrt_bvh::MAX_STACK; }

// Each launcher runs on `stream` and returns the cudaError_t of the launch
// (0 on success). rows: (n_parts, n_rows, 72) float32, one tree per part
// with the common internal-row boundary n_int; recv: (n_parts, n_recv, 36)
// float32; o, d: (n_rays, 3); t_max: (n_rays,). `stats`, when not null,
// receives K1's four work sums over every part's traversal.
extern "C" int pbrt_bvh_closest_parts(const float* rows, int n_parts, int n_rows, int n_int,
                                      const float* recv, int n_recv, const float* o,
                                      const float* d, const float* t_max, int n_rays,
                                      float* pack_out, int* overflow, int stack_depth,
                                      void* stats, void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_depth > pbrt_bvh::MAX_STACK || stack_depth < 1) return (int)cudaErrorInvalidValue;
  parts_kernel<false><<<blocks_for(n_rays), THREADS, 0, (cudaStream_t)stream>>>(
      rows, n_parts, n_rows, n_int, recv, n_recv, o, d, t_max, n_rays, pack_out, nullptr,
      overflow, stack_depth, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_bvh_any_parts(const float* rows, int n_parts, int n_rows, int n_int,
                                  const float* o, const float* d, const float* t_max,
                                  int n_rays, uint8_t* hit_out, int* overflow,
                                  int stack_depth, void* stats, void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_depth > pbrt_bvh::MAX_STACK || stack_depth < 1) return (int)cudaErrorInvalidValue;
  parts_kernel<true><<<blocks_for(n_rays), THREADS, 0, (cudaStream_t)stream>>>(
      rows, n_parts, n_rows, n_int, nullptr, 0, o, d, t_max, n_rays, nullptr, hit_out,
      overflow, stack_depth, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

// packs: (n_ranks, n_rays, 37) float32 -> out (n_rays, 37)
extern "C" int pbrt_shard_select(const float* packs, int n_ranks, int n_rays, float* out,
                                 void* stream) {
  if (n_rays <= 0) return 0;
  select_kernel<<<blocks_for((long long)n_rays * PACK_W), THREADS, 0, (cudaStream_t)stream>>>(
      packs, n_ranks, n_rays, out);
  return (int)cudaGetLastError();
}
