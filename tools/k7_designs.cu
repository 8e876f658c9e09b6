// K7's layered_f and layered_pdf: designs measured against the kernels the
// port runs (pbrt_tpu_torch/csrc/layered.cu) and not kept, and the walks
// read one thread per lane as the kernels as first written run them. Built
// and driven by tools/k7_designs.py only; no render reaches this file.
//
// It includes csrc/layered.cu whole, so every design runs the same lane
// code (f_enter, f_step, pdf_lane, load_needed) as the committed kernels:
// the same operations on each lane, so the same bits and step counts as
// the yardstick (csrc/layered_lane.cu); only the schedule differs.
//  - ticket_f_kernel<REFILL>: persistent warps fed the coated lanes 32 lane
//    ids at a time from a ticket of the launch's own (CoatedFetch: the
//    uncoated lanes' zeros written at once, the coated lanes queued in
//    shared memory), each slot's walk a step loop over the slot's state,
//    its interfaces staged in shared memory, and the slots of ended walks
//    refilled once at least REFILL of the warp's 32 are idle (32: a warp's
//    walks run to the end before it fetches again).
//  - ticket_pdf_kernel: layered_pdf over the coated lanes only, by the
//    same fetch.
//  - walk_steps_kernel: layered_f one thread per lane over all lanes (the
//    first-written kernels' lane-to-warp map), writing each lane's steps.

#include "../pbrt_tpu_torch/csrc/layered.cu"

namespace {

using namespace pbrt_bxdf;

constexpr int QUEUE = 64;  // a warp's queued coated lanes: fewer than 32 + 32

// A warp's coated lanes, drawn 32 lane ids at a time from *ticket.
struct CoatedFetch {
  int* q;                  // the warp's QUEUE queued lane ids, in shared memory
  int head = 0;            // the first queued lane
  int count = 0;           // lanes queued
  bool exhausted = false;  // the ticket has passed the last lane

  // A lane id for each slot set in `idle` while any are left, else -1
  // (also on the busy slots). zero(i) is called on each uncoated lane drawn.
  template <class Zero>
  __device__ __forceinline__ int take(unsigned idle, const LayeredArgs& a, unsigned* ticket,
                                      Zero zero) {
    const unsigned lane = threadIdx.x & 31, below = (1u << lane) - 1;
    const int want = __popc(idle);
    while (count < want && !exhausted) {
      unsigned base = 0;
      if (lane == 0) base = atomicAdd(ticket, 32u);
      base = __shfl_sync(FULL, base, 0);
      exhausted = base + 32 >= (unsigned)a.n;
      const unsigned i = base + lane;
      const bool live = i < (unsigned)a.n;
      const bool coated = live && (a.mask == nullptr || a.mask[i]);
      if (live && !coated) zero((int)i);
      const unsigned c = __ballot_sync(FULL, coated);
      if (coated) q[(head + count + __popc(c & below)) & (QUEUE - 1)] = (int)i;
      count += __popc(c);
      __syncwarp();
    }
    const int got = min(count, want);
    const int k = __popc(idle & below);
    const int out = ((idle >> lane) & 1u) && k < got ? q[(head + k) & (QUEUE - 1)] : -1;
    head = (head + got) & (QUEUE - 1);
    count -= got;
    __syncwarp();
    return out;
  }
};

template <int REFILL>
__global__ void __launch_bounds__(THREADS, F_BLOCKS)
ticket_f_kernel(LayeredArgs a, const float* __restrict__ wo, const float* __restrict__ wi,
                float* __restrict__ f, unsigned* __restrict__ ticket) {
  __shared__ StagedBxdf staged[2][THREADS];
  __shared__ int queue[THREADS / 32][QUEUE];
  Bxdf& top = staged[0][threadIdx.x].b;
  Bxdf& bot = staged[1][threadIdx.x].b;
  CoatedFetch fetch{queue[threadIdx.x >> 5]};
  const auto zero = [&](int i) { store_f(f, i, s4(0.f)); };
  FWalk s;
  int lane = -1;  // the slot's lane; -1: idle
  bool walking = false;
  unsigned long long steps = 0;
  for (;;) {
    if (lane >= 0 && !walking) {  // the slot's walk is over
      store_f(f, lane, s.f);
      steps += s.steps;
      lane = -1;
    }
    const unsigned idle = __ballot_sync(FULL, lane < 0);
    if (__popc(idle) >= REFILL) {
      const int i = fetch.take(idle, a, ticket, zero);
      if (i >= 0) {
        lane = i;
        walking = f_enter(a, i, wo, wi, top, bot, s);
      }
      if (__all_sync(FULL, lane < 0)) break;
    }
    if (walking) walking = f_step(a, s.exit_bottom ? bot : top, s.exit_bottom ? top : bot, s);
  }
  add_steps(a.steps, steps);
}

__global__ void __launch_bounds__(THREADS)
ticket_pdf_kernel(LayeredArgs a, const float* __restrict__ wo, const float* __restrict__ wi,
                  float* __restrict__ pdf, unsigned* __restrict__ ticket) {
  __shared__ int queue[THREADS / 32][QUEUE];
  CoatedFetch fetch{queue[threadIdx.x >> 5]};
  const auto zero = [&](int i) { pdf[i] = 0.f; };
  unsigned long long bases = 0;
  for (;;) {
    const int i = fetch.take(FULL, a, ticket, zero);
    if (__all_sync(FULL, i < 0)) break;
    if (i >= 0) {
      float p;
      bases += pdf_lane(a, i, load3(wo, i), load3(wi, i), p);
      pdf[i] = p;
    }
  }
  add_steps(a.steps, bases);
}

__global__ void __launch_bounds__(THREADS)
walk_steps_kernel(LayeredArgs a, const float* __restrict__ wo, const float* __restrict__ wi,
                  float* __restrict__ f, int* __restrict__ lane_steps) {
  __shared__ StagedBxdf staged[2][THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  Bxdf& top = staged[0][threadIdx.x].b;
  Bxdf& bot = staged[1][threadIdx.x].b;
  FWalk s;
  s.f = s4(0.f);
  s.steps = 0;
  if (a.mask == nullptr || a.mask[i]) {
    bool walking = f_enter(a, i, wo, wi, top, bot, s);
    while (walking) walking = f_step(a, s.exit_bottom ? bot : top, s.exit_bottom ? top : bot, s);
  }
  store_f(f, i, s.f);
  lane_steps[i] = s.steps;
}

template <int REFILL>
int launch_ticket_f(const LayeredArgs* a, const float* wo, const float* wi, float* f,
                    unsigned* ticket, cudaStream_t s) {
  static int resident = 0;
  ticket_f_kernel<REFILL><<<persistent_blocks(ticket_f_kernel<REFILL>, &resident, a->n),
                            THREADS, 0, s>>>(*a, wo, wi, f, ticket);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns the launch's cudaError_t;
// the arguments are csrc/layered.cu's. `ticket`: one uint32 of the
// launch's own, zero.

// f (n,4), slots refilled at `refill` idle (8, 16 or 32)
extern "C" int pbrt_k7_ticket_f(const LayeredArgs* a, const float* wo, const float* wi, float* f,
                                int refill, unsigned* ticket, void* stream) {
  if (a->n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (refill == 8) return launch_ticket_f<8>(a, wo, wi, f, ticket, s);
  if (refill == 16) return launch_ticket_f<16>(a, wo, wi, f, ticket, s);
  if (refill == 32) return launch_ticket_f<32>(a, wo, wi, f, ticket, s);
  return (int)cudaErrorInvalidValue;
}

// pdf (n,)
extern "C" int pbrt_k7_ticket_pdf(const LayeredArgs* a, const float* wo, const float* wi,
                                  float* pdf, unsigned* ticket, void* stream) {
  if (a->n <= 0) return 0;
  static int resident = 0;
  ticket_pdf_kernel<<<persistent_blocks(ticket_pdf_kernel, &resident, a->n), THREADS, 0,
                      (cudaStream_t)stream>>>(*a, wo, wi, pdf, ticket);
  return (int)cudaGetLastError();
}

// f (n,4) and each lane's steps, lane_steps (n,) int32 (0 outside the mask)
extern "C" int pbrt_k7_walk_steps(const LayeredArgs* a, const float* wo, const float* wi,
                                  float* f, int* lane_steps, void* stream) {
  if (a->n <= 0) return 0;
  walk_steps_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a, wo, wi, f,
                                                                       lane_steps);
  return (int)cudaGetLastError();
}
