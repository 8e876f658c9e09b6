// Lane recycling of the wavefront render loop, for Hopper (sm_90a): rank the
// lanes of the pool that finished their path this step and hand each the
// next (pixel, sample) work item.
//
// Replaces the TPU hot path pbrt_tpu/integrators/render.py:228
// `_wavefront_loop` (its recycle step :316-332: `rank = cumsum(finished) - 1`,
// `work = next_work + rank`, `recycle = finished & (work < total)`,
// `in_flight = (in_flight & ~finished) | recycle`, `next_work += sum(recycle)`).
//
// Design: one launch, a single-pass exclusive scan with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA, 2016).
//  - A tile is 256 threads x 16 lanes; each thread reads its 16 lanes of
//    each mask with one 16-byte load (a partial last chunk byte by byte).
//  - Tile ids come from an atomic ticket, so a tile's predecessors were
//    scheduled before it and the look-back never waits on a block that has
//    not started. The masks of tile blockIdx.x are loaded while the ticket
//    is drawn and loaded again only when the ticket differs.
//  - The ticket word holds the call's epoch in its high 32 bits; the tile
//    that draws the last ticket sets it to the next epoch's ticket 0. The
//    epoch's parity picks one of two status arrays; each tile clears its
//    slots of the other one, which the previous call used and the next will,
//    so no memset or second launch is needed between calls, also when a
//    call is replayed from a CUDA graph.
//  - Each tile scans its lanes (warp shuffles, then the 8 warp totals) with
//    the finished count in the low 16 bits of a word and the count of lanes
//    that stay in flight in the high 16, and publishes one 64-bit status
//    word: a 2-bit flag (aggregate, then inclusive prefix) and the two
//    counts in 31 bits each. Its 256 threads read 256 predecessors' words
//    at a time and sum them back to the nearest inclusive prefix (128 tiles
//    at 2^19 lanes: one round).
//  - The last tile's inclusive prefix is the call's totals: it advances the
//    device scalars next_work and n_in_flight (every tile read next_work
//    before it published), and the host reads one integer (n_in_flight) a
//    loop iteration.
//  - The masks are stored as each thread holds them (16 contiguous bytes); the
//    ranks go through shared memory so that rank and work are stored
//    striped, each warp store 512 contiguous bytes.
//  - The rank output is optional: a null pointer skips it.
// Integer sums: the rank equals torch.cumsum's bit for bit.
//
// What bounds it on the H100: bytes. It reads 2 bytes a lane and writes 14
// (rank i32, work i64, two masks) or 10 without the rank, so a pool of 2^19
// lanes moves 8.4 or 6.3 MB, 2.5 or 1.9 us at 3.35 TB/s. The ticket, the
// loads, the look-back and the stores are a chain of dependent round trips
// to memory, so at 128 tiles their latency, not the bytes, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long FLAG_AGG = 1ULL << 62, FLAG_PRE = 2ULL << 62;
constexpr unsigned long long MASK31 = (1ULL << 31) - 1;

// flag | stay count (31 bits) | finished count (31 bits)
__device__ __forceinline__ unsigned long long status_word(unsigned long long flag,
                                                          unsigned long long f,
                                                          unsigned long long s) {
  return flag | (s << 31) | f;
}

// the shared-memory slot of a tile's lane e: a pad word after every 32, so
// that the 32 threads of a warp, each writing lane i of its 16, hit 32 banks
__device__ __forceinline__ int padded(int e) { return e + (e >> 5); }

// this thread's 16 lanes of one mask (bytes 0 or 1)
__device__ __forceinline__ void load_lanes(const uint8_t* __restrict__ m, long long start,
                                           int n, uint8_t* out) {
  if (start + ITEMS <= n) {
    *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(m + start);
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) out[i] = start + i < n ? m[start + i] : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
recycle_kernel(const uint8_t* __restrict__ finished, const uint8_t* __restrict__ in_flight,
               int n, int n_tiles, long long total, unsigned long long* ticket,
               unsigned long long* status, int cap, int* __restrict__ rank,
               long long* __restrict__ work, uint8_t* __restrict__ recycle,
               uint8_t* __restrict__ in_flight_out, long long* next_work,
               long long* n_in_flight) {
  __shared__ unsigned long long s_ticket;
  __shared__ long long s_b0;
  __shared__ unsigned s_warp[WARPS];
  __shared__ unsigned s_agg;
  __shared__ ulonglong2 s_look[WARPS];
  __shared__ int s_rank[TILE + TILE / 32];  // the tile's exclusive ranks, padded
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // tile blockIdx.x's masks, in flight while the ticket is drawn
  alignas(16) uint8_t f[ITEMS];
  alignas(16) uint8_t inf[ITEMS];
  long long start = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  load_lanes(finished, start, n, f);
  load_lanes(in_flight, start, n, inf);
  if (threadIdx.x == 0) {
    // next_work is read before this tile publishes, so before the last tile
    // advances it (its value is stored below, so the load has completed)
    const long long b0 = *next_work;
    const unsigned long long t = atomicAdd(ticket, 1ULL);
    // the last ticket of this call: the next call's epoch, from ticket 0
    if ((t & 0xffffffffULL) == (unsigned long long)(n_tiles - 1))
      atomicExch(ticket, ((t >> 32) + 1) << 32);
    s_ticket = t;
    s_b0 = b0;
  }
  __syncthreads();
  const int tile = (int)(s_ticket & 0xffffffffULL);
  const int parity = (int)((s_ticket >> 32) & 1);
  const long long b0 = s_b0;
  volatile unsigned long long* vstatus = status + (long long)parity * cap;
  volatile unsigned long long* vother = status + (long long)(parity ^ 1) * cap;
  if (tile != (int)blockIdx.x) {
    start = (long long)tile * TILE + (long long)threadIdx.x * ITEMS;
    load_lanes(finished, start, n, f);
    load_lanes(in_flight, start, n, inf);
  }
  // this tile's slots of the other parity (the previous call's), for the next
  for (long long i = tile + (long long)threadIdx.x * n_tiles; i < cap;
       i += (long long)THREADS * n_tiles)
    vother[i] = 0;

  unsigned nf = 0, ns = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    nf += f[i] != 0;
    ns += inf[i] != 0 && f[i] == 0;
  }

  // block scan of (finished | stay << 16): each count is at most TILE, so
  // the low half never carries into the high one
  const unsigned v = nf | (ns << 16);
  unsigned incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned u = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned t = lane < WARPS ? s_warp[lane] : 0;
    unsigned w_incl = t;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const unsigned u = __shfl_up_sync(FULL, w_incl, off);
      if (lane >= off) w_incl += u;
    }
    const unsigned agg = __shfl_sync(FULL, w_incl, WARPS - 1);
    if (lane == 0) {
      vstatus[tile] = status_word(tile == 0 ? FLAG_PRE : FLAG_AGG, agg & 0xffffu, agg >> 16);
      s_agg = agg;
    }
    if (lane < WARPS) s_warp[lane] = w_incl - t;  // exclusive warp prefixes
  }
  __syncthreads();
  // look-back by the whole block: in each round warp w's lane i reads tile
  // - 1 - 32 w - i (256 predecessors at once), waits for its word, and the
  // warp sums the words back to its nearest inclusive prefix; the warps'
  // sums are added in order up to the first warp that met a prefix
  unsigned long long ex_f = 0, ex_s = 0;
  for (int j = tile - 1; j >= 0; j -= THREADS) {
    const int idx = j - (int)threadIdx.x;
    unsigned long long st = FLAG_PRE;  // before tile 0: a prefix of 0
    if (idx >= 0) {
      do {
        st = vstatus[idx];
      } while ((st >> 62) == 0);
    }
    const unsigned pre = __ballot_sync(FULL, (st >> 62) == 2);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    unsigned long long sf = lane <= stop ? (st & MASK31) : 0;
    unsigned long long ss = lane <= stop ? ((st >> 31) & MASK31) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sf += __shfl_xor_sync(FULL, sf, off);
      ss += __shfl_xor_sync(FULL, ss, off);
    }
    if (lane == 0) s_look[warp] = make_ulonglong2(pre ? sf | FLAG_PRE : sf, ss);
    __syncthreads();
    bool found = false;
#pragma unroll
    for (int w = 0; w < WARPS && !found; ++w) {
      const ulonglong2 l = s_look[w];
      ex_f += l.x & ~FLAG_PRE;
      ex_s += l.y;
      found = (l.x & FLAG_PRE) != 0;
    }
    __syncthreads();
    if (found) break;
  }
  if (threadIdx.x == 0) {
    const unsigned long long agg_f = s_agg & 0xffffu, agg_s = s_agg >> 16;
    if (tile > 0) vstatus[tile] = status_word(FLAG_PRE, ex_f + agg_f, ex_s + agg_s);
    // the last tile: the call's totals and the device scalars
    if (tile == n_tiles - 1) {
      const long long all_f = (long long)(ex_f + agg_f), all_s = (long long)(ex_s + agg_s);
      const long long left = total - b0;
      const long long n_rec = left < 0 ? 0 : (all_f < left ? all_f : left);
      *next_work = b0 + n_rec;
      *n_in_flight = all_s + n_rec;
    }
  }

  // the masks of this thread's lanes, stored as they lie (16 bytes a
  // thread: a warp writes 512 contiguous bytes); the ranks go through shared
  // memory, so that rank and work are stored striped, a warp's 16-byte
  // stores contiguous, and not 64 or 128 bytes apart
  unsigned long long excl = ex_f + ((s_warp[warp] + incl - v) & 0xffffu);
  alignas(16) uint8_t rec[ITEMS];
  alignas(16) uint8_t out[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    s_rank[padded(threadIdx.x * ITEMS + i)] = (int)excl;
    rec[i] = f[i] && b0 + (long long)excl < total;
    out[i] = (inf[i] && !f[i]) || rec[i];
    excl += f[i] != 0;
  }
  const long long tile0 = (long long)tile * TILE;
  if (start + ITEMS <= n) {
    *reinterpret_cast<uint4*>(recycle + start) = *reinterpret_cast<const uint4*>(rec);
    *reinterpret_cast<uint4*>(in_flight_out + start) = *reinterpret_cast<const uint4*>(out);
  } else {
    for (int i = 0; i < ITEMS && start + i < n; ++i) {
      recycle[start + i] = rec[i];
      in_flight_out[start + i] = out[i];
    }
  }
  __syncthreads();
  if (tile0 + TILE <= n) {
#pragma unroll
    for (int e = 2 * threadIdx.x; e < TILE; e += 2 * THREADS)
      *reinterpret_cast<longlong2*>(work + tile0 + e) =
          make_longlong2(b0 + s_rank[padded(e)], b0 + s_rank[padded(e) + 1]);
    if (rank) {
#pragma unroll
      for (int e = 4 * threadIdx.x; e < TILE; e += 4 * THREADS) {
        const int a = padded(e);  // e .. e + 3 lie in one row of 32
        *reinterpret_cast<int4*>(rank + tile0 + e) =
            make_int4(s_rank[a], s_rank[a + 1], s_rank[a + 2], s_rank[a + 3]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < TILE && tile0 + e < n; e += THREADS) {
      work[tile0 + e] = b0 + s_rank[padded(e)];
      if (rank) rank[tile0 + e] = s_rank[padded(e)];
    }
  }
}

}  // namespace

extern "C" int pbrt_wavefront_tiles(int n) { return (n + TILE - 1) / TILE; }

// finished, in_flight: (n,) bool as bytes, 16-byte aligned. scratch: uint64
// words, the ticket, then two status arrays of cap >= pbrt_wavefront_tiles(n)
// words each; zero before the first call and kept between calls (calls must
// not overlap: one stream). Outputs: rank (n,) int32 exclusive rank among
// finished lanes (null: not written), work (n,) int64 = next_work + rank,
// recycle and in_flight_out (n,) bool, each 16-byte aligned. next_work and
// n_in_flight are int64 device scalars; next_work is advanced in place.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pbrt_wavefront_recycle(const uint8_t* finished, const uint8_t* in_flight,
                                      int n, long long total, unsigned long long* scratch,
                                      int cap, int* rank, long long* work, uint8_t* recycle,
                                      uint8_t* in_flight_out, long long* next_work,
                                      long long* n_in_flight, void* stream) {
  if (n <= 0) return 0;
  const int tiles = pbrt_wavefront_tiles(n);
  if (tiles > cap) return (int)cudaErrorInvalidValue;
  recycle_kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
      finished, in_flight, n, tiles, total, scratch, scratch + 1, cap, rank, work, recycle,
      in_flight_out, next_work, n_in_flight);
  return (int)cudaGetLastError();
}
