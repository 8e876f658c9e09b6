// K6's path_shade: designs measured against the kernels the port runs
// (pbrt_tpu_torch/csrc/path_step.cu path_shade and path_bsdf) and their
// yardstick (path_shade_lane, shading as first written in one kernel).
// Built and driven by tools/k6_designs.py only; no render reaches this file.
//
// It includes csrc/path_step.cu whole, so every design runs the same lane
// code (shade_lane, or light_lane and bsdf_lane) as the port: the same
// operations on each lane, so the same bits; only the register budget and
// the lane-to-thread map differ.
//  - whole<B>: shade_lane, one kernel, capped by __launch_bounds__ to B
//    blocks of 128 an SM (B = 5: 96 registers, 6: 80): what occupancy alone
//    buys.
//  - split light<B1> + bsdf<B2>: the port's two kernels at other caps.
//  - fused<B>: light_lane then bsdf_lane in one thread, one kernel (the
//    split's two bodies, its register budget, one read of what both need
//    from the L1 where it still holds it).
//  - listed: the lanes listed by material kind (bucket_kernel: one list a
//    kind, and one of the lanes that do not shade), then light_lane and
//    bsdf_lane over the lists, 32 listed lanes a warp from a ticket a list,
//    so that a warp carries one kind.
#include "../pbrt_tpu_torch/csrc/path_step.cu"

namespace {

constexpr unsigned ALL = 0xffffffffu;
// bucket 0: the lanes that do not shade; 1 + the material type (0 .. 5)
constexpr int BUCKETS = 7;

template <int B>
__global__ void __launch_bounds__(THREADS, B) whole_kernel(const StepArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) shade_lane(a, i);
}

template <int B>
__global__ void __launch_bounds__(THREADS, B) light_kernel(const StepArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) light_lane(a, i);
}

template <int B>
__global__ void __launch_bounds__(THREADS, B) bsdf_kernel(const StepArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) bsdf_lane(a, i);
}

template <int B>
__global__ void __launch_bounds__(THREADS, B) fused_kernel(const StepArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) {
    light_lane(a, i);
    bsdf_lane(a, i);
  }
}

__device__ __forceinline__ int bucket_of(const StepArgs& a, int i) {
  if (a.active[i] == 0 || a.hit_valid[i] == 0) return 0;
  const long long mat = a.hit_mat[i];
  return mat < 0 ? 0 : 1 + (int)a.mat[MAT_F * mat + M_TYPE];
}

// lists[b * n ..] the lanes of bucket b, counts[b] their number (zero
// before the launch)
__global__ void __launch_bounds__(THREADS) bucket_kernel(const StepArgs a, int* counts,
                                                         int* lists) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const int b = bucket_of(a, i);
  const unsigned peers = __match_any_sync(__activemask(), b);
  const unsigned lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int at = 0;
  if ((int)lane == leader) at = atomicAdd(counts + b, __popc(peers));
  at = __shfl_sync(peers, at, leader);
  lists[(long long)b * a.n + at + __popc(peers & ((1u << lane) - 1))] = i;
}

// light_lane (PART 0) or bsdf_lane (PART 1) over the lists, bucket by
// bucket, 32 listed lanes a warp from the bucket's ticket (zero before the
// launch); persistent blocks
template <int PART, int B>
__global__ void __launch_bounds__(THREADS, B)
    listed_kernel(const StepArgs a, const int* counts, const int* lists, int* tickets) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < BUCKETS; ++b) {
    const int n = __ldcg(counts + b);
    for (;;) {
      int at = 0;
      if (lane == 0) at = atomicAdd(tickets + b, 32);
      at = __shfl_sync(ALL, at, 0);
      if (at >= n) break;
      if (at + lane < n) {
        const int i = __ldcg(lists + (long long)b * a.n + at + lane);
        if (PART == 0) {
          light_lane(a, i);
        } else {
          bsdf_lane(a, i);
        }
      }
    }
  }
}

template <class Kernel>
int resident(Kernel kernel) {
  int b = 0, dev = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, THREADS, 0);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (b > 0 ? b : 1) * (sms > 0 ? sms : 1);
}

}  // namespace

extern "C" int pbrt_k6_buckets() { return BUCKETS; }

// Design `design` on the lanes of *a, on `stream`:
//   0, 1: whole<5>, whole<6>
//   2, 3, 4, 5: light<4> + bsdf<6>, light<5> + bsdf<6>, light<6> + bsdf<6>,
//               light<5> + bsdf<8>
//   6: listed (bucket_kernel, listed light<5>, listed bsdf<6>): `scratch`
//      holds 3 x BUCKETS zeroed int32 (counts, two tickets) then BUCKETS x n
//      int32 of lists
//   7, 8: fused<4>, fused<6>
extern "C" int pbrt_k6_design(const StepArgs* a, int design, int* scratch, void* stream) {
  if (a->n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int g = blocks(a->n);
  switch (design) {
    case 0: whole_kernel<5><<<g, THREADS, 0, s>>>(*a); break;
    case 1: whole_kernel<6><<<g, THREADS, 0, s>>>(*a); break;
    case 2:
      light_kernel<4><<<g, THREADS, 0, s>>>(*a);
      bsdf_kernel<6><<<g, THREADS, 0, s>>>(*a);
      break;
    case 3:
      light_kernel<5><<<g, THREADS, 0, s>>>(*a);
      bsdf_kernel<6><<<g, THREADS, 0, s>>>(*a);
      break;
    case 4:
      light_kernel<6><<<g, THREADS, 0, s>>>(*a);
      bsdf_kernel<6><<<g, THREADS, 0, s>>>(*a);
      break;
    case 5:
      light_kernel<5><<<g, THREADS, 0, s>>>(*a);
      bsdf_kernel<8><<<g, THREADS, 0, s>>>(*a);
      break;
    case 6: {
      static int res_light = 0, res_bsdf = 0;
      if (res_light == 0) {
        res_light = resident(listed_kernel<0, 5>);
        res_bsdf = resident(listed_kernel<1, 6>);
      }
      int* counts = scratch;
      int* lists = scratch + 3 * BUCKETS;
      bucket_kernel<<<g, THREADS, 0, s>>>(*a, counts, lists);
      listed_kernel<0, 5><<<res_light < g ? res_light : g, THREADS, 0, s>>>(
          *a, counts, lists, counts + BUCKETS);
      listed_kernel<1, 6><<<res_bsdf < g ? res_bsdf : g, THREADS, 0, s>>>(
          *a, counts, lists, counts + 2 * BUCKETS);
      break;
    }
    case 7: fused_kernel<4><<<g, THREADS, 0, s>>>(*a); break;
    case 8: fused_kernel<6><<<g, THREADS, 0, s>>>(*a); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
