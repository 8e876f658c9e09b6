// The layered BxDF (coated diffuse, coated conductor) for Hopper (sm_90a):
// K7, three entry points over lanes in the local shading frame.
//
// Replaces the TPU hot path pbrt_tpu/materials/layered.py:82 `layered_f`,
// :334 `layered_sample` and :475 `layered_pdf` (reference
// bxdfs/layered_bxdf.h): a stochastic random walk between a dielectric coat
// and a diffuse or conductor base, with an optional Henyey-Greenstein medium
// between them; up to max_depth steps, each with russian roulette, a medium
// segment and interface samples; its own PCG32 stream, seeded by
// MurmurHash64A of the float bits of wo and wi (or of uc and u2). Plain
// version: pbrt_tpu_torch/materials/layered.py `layered_*_plain`.
//
// The walk. The JAX package runs every lane through all max_depth steps and
// masks the dead ones; here a walk ends when it dies. That is exact for
// n_samples = 1 (the wrapper refuses other values): a dead lane of layered_f
// adds nothing more to f, and a lane of layered_sample that stopped walking
// is never at a boundary again, so the draws it skips change no output. Each
// step draws the same numbers in the same order as the plain version and
// evaluates only the branch its lane takes (scatter or boundary, exit or
// non-exit interface, and in csrc/bxdf.cuh only the lane's own BxDF kind).
// An optional mask names the lanes whose material is coated; the others get
// zeros (pdf 0, valid false, eta 1). Built with --fmad=false and IEEE sqrt
// and division; only the transcendental functions and the complex square
// root may round differently from torch's, so a comparison in the walk can
// flip on a rare lane and the kernel agrees with the plain version lane by
// lane on almost every lane, not on all.
//
// What bounds it on the H100: operations, when the walks are long. A lane
// of layered_f or layered_sample reads its two interfaces (up to 2 x 80
// bytes), thickness, g, albedo and its directions (or uc and u2) and writes
// 16 to 41 bytes; a lane of layered_pdf reads the coat and its directions,
// and the base only where its estimate reaches it. A walk step costs a few
// hundred float operations (two to four BxDF evaluations and samples, each
// with Trowbridge-Reitz terms and Fresnel), and a lane takes a few steps.
//
// All three redesigned for Hopper. Read on the kernels as first written
// (PERF.md §6): (1) on a
// render's wave the coated lanes are a third of all and cluster, so half
// the warps carry none and the others ~24 of 32; (2) half of layered_f's
// coated lanes never start a walk (wo and wi on opposite sides of a
// reflecting base), yet a warp lasted as long as its longest walk; (3) the
// walk's two BxDFs, picked by reference (layered_sample's by value), and
// the library's sinf/cosf kept a local-memory stack frame; (4) every
// interface field was read, whatever the kind. Here:
//  - layered_f in two passes: every coated walk set up, one thread per lane
//    (f_enter_kernel), the walks that start listed; then only those, 32 a
//    warp, set up again and stepped together to the end (f_walk_kernel):
//    no warp carries a lane that does not walk, and the 32 walks of a warp
//    take the same branch step by step.
//  - layered_sample in two passes too: every coated lane's top interface
//    sampled, one thread per lane (sample_enter_kernel), a lane whose
//    sample reflects there (or fails) written at once, the others listed
//    with their walk's start (a 64-byte hand-off at their place in the
//    list); then only those, 32 a warp, stepped together to the end
//    (sample_walk_kernel), which neither samples the top again nor reads
//    wo, uc and u2.
//  - Each slot's two interfaces staged in shared memory (a 21-word stride:
//    a warp's slots hit 32 banks), picked as exit or non-exit interface by
//    address; the samplers' sines and cosines without the library's
//    reduction for huge angles (csrc/bxdf.cuh sin_angle, cos_angle). No
//    stack frame, no spills, no local loads or stores (chip_smoke.py checks
//    the ptxas report and the SASS).
//  - An interface reads only the fields its kind needs (load_needed).
//  - layered_pdf one thread per lane, as first written but for the last two
//    points: compacting its coated lanes was measured slower (see below).
// A lane runs the same operations in the same order whatever warp and slot
// it runs in, so the outputs and the steps counted are the bits of the
// kernels as first written, kept as the yardstick csrc/layered_lane.cu.
// An optional device counter accumulates the steps taken (layered_pdf: the
// lanes whose estimate reached the base), for the bound.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "bxdf.cuh"

struct BxdfPtrs {
  const int* kind;
  const float* refl;
  const float* trans;
  const float* eta_re;
  const float* eta_im;
  const float* eta;
  const float* ax;
  const float* ay;
};

// mirrored by pbrt_tpu_torch/materials/layered.py `_LayeredArgs`
struct LayeredArgs {
  BxdfPtrs top, bottom;
  const float* thickness;
  const float* g;
  const float* albedo;
  const uint8_t* mask;           // optional (n,) bool: lanes to evaluate
  unsigned long long* steps;     // optional walk-step counter
  int n;
  int max_depth;
};

namespace {

using namespace pbrt_bxdf;

constexpr int THREADS = 128;

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

// the walk's uniform draw: the stream's float clamped to 1 - 1e-7 (`_r1`)
__device__ __forceinline__ float r1(Pcg32& r) {
  return fminf(pcg32_uniform(r), (float)(1.0 - 1e-7));
}

// transmittance exp(-|dz / w.z|), sigma_t = 1 (`_tr`)
__device__ __forceinline__ float tr(float dz, V3 w) {
  const float tau = fabsf(dz) / fmaxf(fabsf(w.z), 1e-9f);
  return expf(-fminf(tau, 80.f));
}

__device__ __forceinline__ bool ok(const BSample& s) {
  return s.valid && any_pos(s.f) && s.pdf > 0.f && s.wi.z != 0.f;
}

__device__ __forceinline__ bool lane_live(const LayeredArgs& a, int i) {
  return i < a.n && (a.mask == nullptr || a.mask[i]);
}

int blocks(int n) { return (n + THREADS - 1) / THREADS; }

// ------------------------------------------- layered_f and layered_pdf
//
// layered_f runs in two passes. The first (f_enter_kernel, one thread per
// lane) sets up every coated lane's walk: a lane whose walk does not start
// (about half of the coated lanes on a render's wave: wo and wi on opposite
// sides of a reflecting base) writes its f at once, the others are listed
// (list_lane: one atomic a block). The second (f_walk_kernel) takes the
// listed lanes 32 at a time (over_listed: persistent warps, a ticket of the
// launch's own), sets each up again (the same operations: the same bits)
// and steps its 32 walks together until the last one ends. So a warp of the
// walk pass carries only lanes that walk, their walks start together and,
// on the coated scenes' interfaces, take the same branch at each step (the
// exit and the non-exit interface in turn). layered_sample's passes use the
// same fetch (below).
//
// Measured against this (PERF.md §6; tools/k7_designs.cu keeps the ticket
// designs and tools/k7_designs.py times them), on the H100: compacting the
// coated lanes into full warps for the set-up pass or for layered_pdf, by a
// ticket (its ~n / 32 atomics on one word queue up in the L2) or by warps
// that each own a run of lanes (a warp's runs end in a partial batch, and
// its long serial chain of loads is not hidden), ran slower than one thread
// per lane over all lanes, whose idle lanes cost little; refilling the
// slots of ended walks with new lanes ran slower than stepping a warp's 32
// walks to the end: walks at different steps take different branches.

constexpr int F_BLOCKS = 4;      // f_walk_kernel blocks an SM (at most 128 registers)
constexpr unsigned FULL = 0xffffffffu;

// Append lane i to list[] where `listed`, in any order, with one atomic on
// *count a block -> its place in the list (-1 where not listed). Every
// thread of the block calls it.
__device__ __forceinline__ int list_lane(bool listed, int i, int* count, int* list) {
  __shared__ int warp_n[THREADS / 32];
  __shared__ int block_at;
  const unsigned lane = threadIdx.x & 31, below = (1u << lane) - 1;
  const unsigned w = __ballot_sync(FULL, listed);
  if (lane == 0) warp_n[threadIdx.x >> 5] = __popc(w);
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int k = 0; k < THREADS / 32; ++k) t += warp_n[k];
    block_at = t ? atomicAdd(count, t) : 0;
  }
  __syncthreads();
  int at = block_at;
  for (int k = 0; k < (int)(threadIdx.x >> 5); ++k) at += warp_n[k];
  at += __popc(w & below);
  if (listed) list[at] = i;
  return listed ? at : -1;
}

// The listed lanes, list[0 .. work[0]), taken 32 at a time from the ticket
// work[1]: body(i, k) for each, lane i at place k of the list, called by
// the whole warp with i = -1 on the slots past the list's end.
template <class Body>
__device__ __forceinline__ void over_listed(int* work, const int* list, Body body) {
  const unsigned lane = threadIdx.x & 31;
  const int n = __ldcg(work);
  for (;;) {
    int at = 0;
    if (lane == 0) at = atomicAdd(work + 1, 32);
    at = __shfl_sync(FULL, at, 0);
    if (at >= n) break;
    const int k = at + (int)lane;
    body(k < n ? __ldcg(list + k) : -1, k);
  }
}

__device__ __forceinline__ S4 ldg4(const float* p, int i) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
  return {{v.x, v.y, v.z, v.w}};
}

// The fields of interface i that its kind reads, into b (csrc/bxdf.cuh: a
// dielectric its eta, a conductor its complex IOR, a diffuse reflector its
// reflectance, a diffuse transmitter also its transmittance; every kind its
// roughness, which the walk's specular tests read). The other fields of b
// are left as they are: nothing reads them.
__device__ __forceinline__ void load_needed(const BxdfPtrs& p, int i, Bxdf& b) {
  const int kind = __ldg(p.kind + i);
  b.kind = kind;
  b.ax = __ldg(p.ax + i);
  b.ay = __ldg(p.ay + i);
  if (kind == K_DIELECTRIC) {
    b.eta = __ldg(p.eta + i);
  } else if (kind == K_CONDUCTOR) {
    b.eta_re = ldg4(p.eta_re, i);
    b.eta_im = ldg4(p.eta_im, i);
  } else {
    b.refl = ldg4(p.refl, i);
    if (kind != K_DIFFUSE) b.trans = ldg4(p.trans, i);
  }
}

// add each thread's count to the device counter, a warp at a time
__device__ __forceinline__ void add_steps(unsigned long long* counter, unsigned long long n) {
  if (counter == nullptr) return;
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(FULL, n, o);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(counter, n);
}

// A slot's interface in shared memory, padded to 21 words so that the 32
// slots of a warp read a field from 32 banks.
struct StagedBxdf {
  Bxdf b;
  float pad;
};

// A slot's walk of layered_f between two steps (in registers; its
// interfaces are staged in shared memory).
struct FWalk {
  S4 f, beta;         // the estimate so far; the path throughput
  V3 w, wi;           // the walk's direction; the lane's wi, flipped with wo
  float z;            // the walk's height in the layer
  int steps;          // steps taken
  Pcg32 r;
  S4 albedo, wis_f;   // the medium's albedo; the virtual light sample's f, wi, pdf
  V3 wis_wi;
  float wis_pdf, inv_wis, thick, g, exit_z;
  bool exit_bottom, exit_spec, nonexit_spec, has_albedo;
};

// Lane i's walk set up in a slot: its interfaces staged into top and bot
// (the slot's, in shared memory), then layered_f's code before its loop as
// first written (layered_bxdf.h:53-245) -> whether the walk starts.
__device__ __forceinline__ bool f_enter(const LayeredArgs& a, int i, const float* wo_p,
                                        const float* wi_p, Bxdf& top, Bxdf& bot, FWalk& s) {
  load_needed(a.top, i, top);
  load_needed(a.bottom, i, bot);
  s.thick = __ldg(a.thickness + i);
  s.g = __ldg(a.g + i);
  s.albedo = ldg4(a.albedo, i);
  V3 wo = load3(wo_p, i), wi = load3(wi_p, i);
  // twoSided: flip both into the upper hemisphere
  if (wo.z < 0.f) {
    wo = neg(wo);
    wi = neg(wi);
  }
  const bool same = wo.z * wi.z > 0.f;
  s.exit_bottom = !same;
  s.exit_z = s.exit_bottom ? 0.f : s.thick;
  const bool top_spec = effectively_smooth(top.ax, top.ay);
  const bool bot_spec = bot.kind == K_CONDUCTOR && effectively_smooth(bot.ax, bot.ay);
  s.exit_spec = s.exit_bottom ? bot_spec : top_spec;
  s.nonexit_spec = s.exit_bottom ? top_spec : bot_spec;
  s.f = same ? bxdf_f(top, wo, wi) : s4(0.f);
  s.wi = wi;
  s.steps = 0;
  Pcg32 r = pcg32_set_sequence(hash_v3(wo), hash_v3(wi));
  // entrance transmission sample, then the virtual light sample from wi
  // through the exit interface (importance transport: no 1/eta^2)
  float uc = r1(r), u0 = r1(r), u1 = r1(r);
  const BSample wos = bxdf_sample(top, wo, uc, u0, u1, false, true, true);
  uc = r1(r);
  u0 = r1(r);
  u1 = r1(r);
  const BSample wis = bxdf_sample(s.exit_bottom ? bot : top, wi, uc, u0, u1, false, true, false);
  s.r = r;
  if (!(ok(wos) && ok(wis))) return false;
  s.beta = (wos.f * fabsf(wos.wi.z)) / fmaxf(wos.pdf, 1e-12f);
  s.z = s.thick;
  s.w = wos.wi;
  s.has_albedo = any_pos(s.albedo);
  s.inv_wis = fmaxf(wis.pdf, 1e-12f);
  s.wis_f = wis.f;
  s.wis_wi = wis.wi;
  s.wis_pdf = wis.pdf;
  return true;
}

// One step of the walk: the body of layered_f's loop as first written, its
// `break` a return of false -> whether the walk goes on. The pdf of leaving
// through the exit interface (`exit_pdf_trans`) takes both lobes at the
// bottom and transmission only at the top: allow_refl = exit_bottom.
__device__ __forceinline__ bool f_step(const LayeredArgs& a, const Bxdf& exit_b,
                                       const Bxdf& nonexit_b, FWalk& s) {
  const int depth = s.steps++;
  const float thick = s.thick;
  const float bmax = max4(s.beta);
  const float u_rr = r1(s.r);
  if (depth > 3 && bmax < 0.25f) {
    const float q = fmaxf(0.f, 1.f - bmax);
    if (u_rr < q) return false;
    s.beta = s.beta / fmaxf(1.f - q, 1e-9f);
  }
  // medium segment
  const float u_d = r1(s.r);
  const float dz = -log1pf(-u_d) * fabsf(s.w.z);
  const float zp = s.w.z > 0.f ? s.z + dz : s.z - dz;
  const bool scatter = s.has_albedo && zp > 0.f && zp < thick;
  if (!s.has_albedo) s.beta = s.beta * tr(thick, s.w);
  const float z_b = s.has_albedo ? clampf(zp, 0.f, thick) : (s.z == thick ? 0.f : thick);
  const float uph0 = r1(s.r), uph1 = r1(s.r);
  const float uce = r1(s.r), ue0 = r1(s.r), ue1 = r1(s.r);
  const float ucn = r1(s.r), un0 = r1(s.r), un1 = r1(s.r);

  if (scatter) {
    // NEE through the exit interface along wis, then a phase resample
    const float ph_exit = henyey_greenstein(dot(neg(s.w), neg(s.wis_wi)), s.g);
    const float wt = s.exit_spec ? 1.f : power_heuristic(s.wis_pdf, ph_exit);
    s.f = s.f + (((((s.beta * s.albedo) * ph_exit) * wt) * tr(zp - s.exit_z, s.wis_wi)) *
                 s.wis_f) / s.inv_wis;
    V3 wi_ph;
    const float pdf_ph = sample_henyey_greenstein(neg(s.w), s.g, uph0, uph1, wi_ph);
    if (!(pdf_ph > 0.f && wi_ph.z != 0.f)) return false;
    const S4 beta_sc = s.beta * s.albedo;
    if ((zp < s.exit_z && wi_ph.z > 0.f) || (zp > s.exit_z && wi_ph.z < 0.f)) {
      const V3 mw = neg(wi_ph);
      const float wt2 = power_heuristic(pdf_ph, bxdf_pdf(exit_b, mw, s.wi, s.exit_bottom, true));
      s.f = s.f + ((beta_sc * tr(zp - s.exit_z, wi_ph)) * bxdf_f(exit_b, mw, s.wi)) * wt2;
    }
    s.beta = beta_sc;
    s.w = wi_ph;
    s.z = zp;
    return s.steps < a.max_depth;
  }
  if (z_b == s.exit_z) {
    // exit interface: reflection resample, the walk goes on
    const BSample bs = bxdf_sample(exit_b, neg(s.w), uce, ue0, ue1, true, false, true);
    if (!ok(bs)) return false;
    s.beta = ((s.beta * bs.f) * fabsf(bs.wi.z)) / fmaxf(bs.pdf, 1e-12f);
    s.w = bs.wi;
    s.z = z_b;
    return s.steps < a.max_depth;
  }
  // non-exit interface: NEE along wis, then a reflection resample and NEE
  // through the exit interface along it
  const V3 mw = neg(s.w), mwis = neg(s.wis_wi);
  const float wt_ne = s.exit_spec ? 1.f
                                  : power_heuristic(s.wis_pdf,
                                                    bxdf_pdf(nonexit_b, mw, mwis, true, true));
  s.f = s.f + (((((s.beta * bxdf_f(nonexit_b, mw, mwis)) * fabsf(s.wis_wi.z)) * wt_ne) *
                tr(thick, s.wis_wi)) * s.wis_f) / s.inv_wis;
  const BSample bs = bxdf_sample(nonexit_b, mw, ucn, un0, un1, true, false, true);
  if (!ok(bs)) return false;
  const S4 beta_ne = ((s.beta * bs.f) * fabsf(bs.wi.z)) / fmaxf(bs.pdf, 1e-12f);
  const V3 mb = neg(bs.wi);
  const float wt3 = s.nonexit_spec ? 1.f
                                   : power_heuristic(bs.pdf, bxdf_pdf(exit_b, mb, s.wi,
                                                                      s.exit_bottom, true));
  s.f = s.f + ((beta_ne * tr(thick, bs.wi)) * bxdf_f(exit_b, mb, s.wi)) * wt3;
  s.beta = beta_ne;
  s.w = bs.wi;
  s.z = z_b;
  return s.steps < a.max_depth;
}

__device__ __forceinline__ void store_f(float* f, int i, const S4& v) {
  reinterpret_cast<float4*>(f)[i] = make_float4(v.v[0], v.v[1], v.v[2], v.v[3]);
}

// layered_f, pass 1: every coated lane's walk set up; a lane whose walk
// does not start writes its f (and 0 steps), the others are listed in
// walkers[] (work[0] counts them).
__global__ void __launch_bounds__(THREADS)
f_enter_kernel(LayeredArgs a, const float* __restrict__ wo, const float* __restrict__ wi,
               float* __restrict__ f, int* __restrict__ work, int* __restrict__ walkers) {
  __shared__ StagedBxdf staged[2][THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  bool starts = false;
  if (i < a.n) {
    if (a.mask == nullptr || a.mask[i]) {
      FWalk s;
      starts = f_enter(a, i, wo, wi, staged[0][threadIdx.x].b, staged[1][threadIdx.x].b, s);
      if (!starts) store_f(f, i, s.f);
    } else {
      store_f(f, i, s4(0.f));
    }
  }
  list_lane(starts, i, work, walkers);
}

// layered_f, pass 2: the listed lanes, 32 a warp: each set up again, then
// stepped together until the last walk has ended; each writes its f.
__global__ void __launch_bounds__(THREADS, F_BLOCKS)
f_walk_kernel(LayeredArgs a, const float* __restrict__ wo, const float* __restrict__ wi,
              float* __restrict__ f, int* __restrict__ work, const int* __restrict__ walkers) {
  __shared__ StagedBxdf staged[2][THREADS];
  Bxdf& top = staged[0][threadIdx.x].b;
  Bxdf& bot = staged[1][threadIdx.x].b;
  unsigned long long steps = 0;
  over_listed(work, walkers, [&](int i, int) {
    FWalk s;
    bool walking = i >= 0 && f_enter(a, i, wo, wi, top, bot, s);
    while (__any_sync(FULL, walking)) {
      if (walking) walking = f_step(a, s.exit_bottom ? bot : top, s.exit_bottom ? top : bot, s);
    }
    if (i >= 0) {
      store_f(f, i, s.f);
      steps += s.steps;
    }
  });
  add_steps(a.steps, steps);
}

// ------------------------------------------------------- layered_sample
//
// layered_sample in two passes, as layered_f. The first (sample_enter_kernel,
// one thread per lane) samples every coated lane's top interface at its
// draws: a lane whose sample reflects there (or fails) writes its output at
// once, the others, whose sample enters the layer, are listed, each with
// its walk's start (Handoff) at its place in the list. The second
// (sample_walk_kernel) takes the listed lanes 32 a warp, loads each walk's
// start and stages both interfaces in shared memory, and steps the 32 walks
// together until the last one ends, each step's interface picked by
// address (the first-written kernel picked a whole Bxdf by value: a stack
// frame). A lane's walk, its draws and its steps are those of the kernel as
// first written (csrc/layered_lane.cu layered_sample_lane, the yardstick),
// so its outputs are the same bits. On a render's wave ~92 % of the coated
// lanes' samples enter the layer (the smooth-ish coat transmits most), so
// the list saves few walks: the gain is the warps of the walk pass, which
// carry only walking lanes (PERF.md §6).

// A listed lane's walk between two steps (its interfaces staged in shared
// memory): the throughput and pdf so far, the direction, height and step
// count, the stream, the medium, the path's specular flag; where the walk
// leaves the layer (done), f and pdf hold the sample's and exit_wi,
// exit_spec its direction and flag.
struct SWalk {
  S4 f, albedo;
  V3 w, exit_wi;
  float pdf, z, thick, g, wo_z;
  int steps;
  Pcg32 r;
  bool spec, exit_spec, done, has_albedo, flip;
};

// What the set-up pass hands a walk over (at the lane's place in the list,
// 64 bytes): f, then w and pdf, then the stream, then wo.z and the flags
// (specular, flipped), so that the walk pass neither samples the top again
// nor reads wo, uc and u2
struct Handoff {
  float4 f, w_pdf;
  ulonglong2 r;
  float4 z_flags;
};

// Lane i's top sample (layered_bxdf.h:247-262) -> whether it enters the
// layer (the walk starts: s set up but for the layer's thickness, g and
// albedo); else its output in out
__device__ __forceinline__ bool sample_enter(const LayeredArgs& a, int i, const float* wo_p,
                                             const float* uc_p, const float* u2_p, Bxdf& top,
                                             SWalk& s, BSample& out) {
  load_needed(a.top, i, top);
  const V3 wo = load3(wo_p, i);
  const float uc = __ldg(uc_p + i), u0 = __ldg(u2_p + 2 * i), u1 = __ldg(u2_p + 2 * i + 1);
  s.flip = wo.z < 0.f;
  const V3 wof = s.flip ? neg(wo) : wo;
  const BSample bs0 = bxdf_sample(top, wof, uc, u0, u1, true, true, true);
  const bool ok0 = ok(bs0);
  out.eta = 1.f;
  if (ok0 && (bs0.flags & F_TRANSMISSION) == 0) {  // immediate reflection exits at once
    out.f = bs0.f;
    out.wi = s.flip ? neg(bs0.wi) : bs0.wi;
    out.pdf = bs0.pdf;
    out.flags = bs0.flags;
    out.valid = true;
    return false;
  }
  s.spec = (bs0.flags & F_SPECULAR) != 0;
  if (!ok0) {  // no sample: no walk
    out.f = s4(0.f);
    out.wi = s.flip ? neg(bs0.wi) : bs0.wi;
    out.pdf = 1.f;
    out.flags = (wof.z * bs0.wi.z > 0.f ? F_REFLECTION : F_TRANSMISSION) |
                (s.spec ? F_SPECULAR : F_GLOSSY);
    out.valid = false;
    return false;
  }
  // transmitted into the layer: the random walk
  s.f = bs0.f * fabsf(bs0.wi.z);
  s.pdf = bs0.pdf;
  s.w = bs0.wi;
  s.wo_z = wof.z;
  s.r = pcg32_set_sequence(hash_v3(wof), murmur64a_3(__float_as_uint(uc), __float_as_uint(u0),
                                                     __float_as_uint(u1)));
  return true;
}

__device__ __forceinline__ void store_handoff(Handoff* h, int k, const SWalk& s) {
  Handoff v;
  v.f = make_float4(s.f.v[0], s.f.v[1], s.f.v[2], s.f.v[3]);
  v.w_pdf = make_float4(s.w.x, s.w.y, s.w.z, s.pdf);
  v.r = make_ulonglong2(s.r.state, s.r.inc);
  v.z_flags = make_float4(s.wo_z, __int_as_float((s.spec ? 1 : 0) | (s.flip ? 2 : 0)), 0.f, 0.f);
  h[k] = v;
}

// The walk of lane i from its hand-off at place k: its layer loaded, the
// walk's start as the set-up pass left it
__device__ __forceinline__ void load_walk(const LayeredArgs& a, int i, const Handoff* h, int k,
                                          Bxdf& top, Bxdf& bot, SWalk& s) {
  const float4 f = __ldcg(&h[k].f), w_pdf = __ldcg(&h[k].w_pdf), zf = __ldcg(&h[k].z_flags);
  const ulonglong2 r = __ldcg(&h[k].r);
  load_needed(a.top, i, top);
  load_needed(a.bottom, i, bot);
  s.f = {{f.x, f.y, f.z, f.w}};
  s.w = {w_pdf.x, w_pdf.y, w_pdf.z};
  s.pdf = w_pdf.w;
  s.r = {r.x, r.y};
  s.wo_z = zf.x;
  const int flags = __float_as_int(zf.y);
  s.spec = (flags & 1) != 0;
  s.flip = (flags & 2) != 0;
  s.exit_wi = s.w;
  s.exit_spec = s.spec;
  s.steps = 0;
  s.done = false;
  s.thick = __ldg(a.thickness + i);
  s.g = __ldg(a.g + i);
  s.albedo = ldg4(a.albedo, i);
  s.has_albedo = any_pos(s.albedo);
  s.z = s.thick;
}

// One step of the walk: the body of layered_sample_lane's loop, its
// `break` a return of false -> whether the walk goes on
__device__ __forceinline__ bool sample_step(const LayeredArgs& a, const Bxdf& top,
                                            const Bxdf& bot, SWalk& s) {
  const int depth = s.steps++;
  const float rr_beta = max4(s.f) / fmaxf(s.pdf, 1e-12f);
  const float u_rr = r1(s.r);
  if (depth > 3 && rr_beta < 0.25f) {
    const float q = fmaxf(0.f, 1.f - rr_beta);
    if (u_rr < q) return false;
    s.pdf = s.pdf * (1.f - q);
  }
  if (s.w.z == 0.f) return false;
  // medium
  const float u_d = r1(s.r);
  const float dz = -log1pf(-u_d) * fabsf(s.w.z);
  const float zp = s.w.z > 0.f ? s.z + dz : s.z - dz;
  const bool scatter = s.has_albedo && zp > 0.f && zp < s.thick;
  const float uph0 = r1(s.r), uph1 = r1(s.r);
  const float uci = r1(s.r), ui0 = r1(s.r), ui1 = r1(s.r);
  if (scatter) {
    V3 wi_ph;
    const float pdf_ph = sample_henyey_greenstein(neg(s.w), s.g, uph0, uph1, wi_ph);
    if (!(pdf_ph > 0.f && wi_ph.z != 0.f)) return false;
    s.f = (s.f * s.albedo) * pdf_ph;
    s.pdf = s.pdf * pdf_ph;
    s.spec = false;
    s.w = wi_ph;
    s.z = zp;
    return s.steps < a.max_depth;
  }
  // boundary advance and the interface sample there
  const S4 f_bnd = s.has_albedo ? s.f : s.f * tr(s.thick, s.w);
  const float z_bnd =
      s.has_albedo ? clampf(zp, 0.f, s.thick) : (s.z == s.thick ? 0.f : s.thick);
  const BSample bs =
      bxdf_sample(z_bnd == 0.f ? bot : top, neg(s.w), uci, ui0, ui1, true, true, true);
  if (!ok(bs)) return false;
  const S4 f_if = f_bnd * bs.f;
  const float pdf_if = s.pdf * bs.pdf;
  const bool spec_if = s.spec && (bs.flags & F_SPECULAR) != 0;
  if (bs.flags & F_TRANSMISSION) {  // leaves the layer: the sample
    s.done = true;
    s.f = f_if;
    s.pdf = pdf_if;
    s.exit_wi = bs.wi;
    s.exit_spec = spec_if;
    return false;
  }
  s.f = f_if * fabsf(bs.wi.z);
  s.pdf = pdf_if;
  s.spec = spec_if;
  s.w = bs.wi;
  s.z = z_bnd;
  return s.steps < a.max_depth;
}

__device__ __forceinline__ void store_sample(int i, const BSample& s, float* f, float* wi,
                                             float* pdf, float* eta, int* flags,
                                             uint8_t* valid) {
  store_f(f, i, s.f);
  wi[3 * i] = s.wi.x;
  wi[3 * i + 1] = s.wi.y;
  wi[3 * i + 2] = s.wi.z;
  pdf[i] = s.pdf;
  eta[i] = s.eta;
  flags[i] = s.flags;
  valid[i] = s.valid;
}

// the outputs of layered_sample (f, wi, pdf, eta, flags, valid)
struct SampleOut {
  float *f, *wi, *pdf, *eta;
  int* flags;
  uint8_t* valid;
};

// layered_sample, pass 1: every coated lane's top sampled; a lane whose
// sample does not enter the layer writes its output (the others outside the
// mask zeros), the others are listed in walkers[] (work[0] counts them) and
// hand their walk's start over at their place in the list.
__global__ void __launch_bounds__(THREADS)
sample_enter_kernel(LayeredArgs a, const float* __restrict__ wo, const float* __restrict__ uc,
                    const float* __restrict__ u2, SampleOut o, int* __restrict__ work,
                    int* __restrict__ walkers, Handoff* __restrict__ handoff) {
  __shared__ StagedBxdf staged[THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  bool walks = false;
  SWalk s;
  if (i < a.n) {
    BSample out = {s4(0.f), {0.f, 0.f, 0.f}, 0.f, 1.f, 0, false};
    if (lane_live(a, i)) walks = sample_enter(a, i, wo, uc, u2, staged[threadIdx.x].b, s, out);
    if (!walks) store_sample(i, out, o.f, o.wi, o.pdf, o.eta, o.flags, o.valid);
  }
  const int k = list_lane(walks, i, work, walkers);
  if (walks) store_handoff(handoff, k, s);
}

// layered_sample, pass 2: the listed lanes, 32 a warp: each walk's start
// and layer loaded (the layer staged), the walks stepped together until the
// last has ended; each writes its output.
__global__ void __launch_bounds__(THREADS, F_BLOCKS)
sample_walk_kernel(LayeredArgs a, SampleOut o, int* __restrict__ work,
                   const int* __restrict__ walkers, const Handoff* __restrict__ handoff) {
  __shared__ StagedBxdf staged[2][THREADS];
  Bxdf& top = staged[0][threadIdx.x].b;
  Bxdf& bot = staged[1][threadIdx.x].b;
  unsigned long long steps = 0;
  over_listed(work, walkers, [&](int i, int k) {
    SWalk s;
    bool walking = i >= 0;
    if (walking) load_walk(a, i, handoff, k, top, bot, s);
    while (__any_sync(FULL, walking)) {
      if (walking) walking = sample_step(a, top, bot, s);
    }
    if (i >= 0) {
      const BSample out = {s.done ? s.f : s4(0.f), s.flip ? neg(s.exit_wi) : s.exit_wi,
                           s.done ? s.pdf : 1.f, 1.f,
                           (s.wo_z * s.exit_wi.z > 0.f ? F_REFLECTION : F_TRANSMISSION) |
                               (s.exit_spec ? F_SPECULAR : F_GLOSSY),
                           s.done};
      store_sample(i, out, o.f, o.wi, o.pdf, o.eta, o.flags, o.valid);
      steps += s.steps;
    }
  });
  add_steps(a.steps, steps);
}

// one lane of layered_pdf (layered.py:475-508), as first written but for
// reading only the fields each interface's kind needs: the entrance
// reflection pdf plus one transmission-reflection-transmission estimate,
// blended with the uniform sphere pdf; -> 1 when the estimate reached the
// base (read its parameters and evaluated its pdf), else 0
__device__ __forceinline__ int pdf_lane(const LayeredArgs& a, int i, V3 wo, V3 wi, float& pdf) {
  Bxdf top{};
  load_needed(a.top, i, top);
  if (wo.z < 0.f) {
    wo = neg(wo);
    wi = neg(wi);
  }
  float s = 0.f;
  int base = 0;
  if (wo.z * wi.z > 0.f) {
    s = bxdf_pdf(top, wo, wi, true, false);
    Pcg32 r = pcg32_set_sequence(hash_v3(wi), hash_v3(wo));
    float uc = r1(r), u0 = r1(r), u1 = r1(r);
    const BSample wos = bxdf_sample(top, wo, uc, u0, u1, false, true, true);
    uc = r1(r);
    u0 = r1(r);
    u1 = r1(r);
    const BSample wis = bxdf_sample(top, wi, uc, u0, u1, false, true, true);
    if (wos.valid && wos.pdf > 0.f && any_pos(wos.f) && wis.valid && wis.pdf > 0.f &&
        any_pos(wis.f)) {
      Bxdf bot{};
      load_needed(a.bottom, i, bot);
      s = s + bxdf_pdf(bot, neg(wos.wi), neg(wis.wi), true, true);
      base = 1;
    }
  }
  pdf = (0.9f * s) / 1.f + (float)(0.1 / (4.0 * 3.141592653589793));
  return base;
}

// layered_pdf, one thread per lane
__global__ void __launch_bounds__(THREADS)
layered_pdf_kernel(LayeredArgs a, const float* __restrict__ wo, const float* __restrict__ wi,
                   float* __restrict__ pdf) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int base = 0;
  if (i < a.n) {
    if (a.mask == nullptr || a.mask[i]) {
      float p;
      base = pdf_lane(a, i, load3(wo, i), load3(wi, i), p);
      pdf[i] = p;
    } else {
      pdf[i] = 0.f;
    }
  }
  add_steps(a.steps, base);
}

// mismatches of sin_angle and cos_angle (csrc/bxdf.cuh) against the
// library's sinf and cosf over every float of magnitude at or below the one
// with bits `top` (results equal bit for bit, or both NaN), for the tests
__global__ void trig_check_kernel(unsigned top, unsigned long long* __restrict__ count) {
  unsigned long long bad = 0;
  const unsigned long long end = 2ull * top + 2;
  for (unsigned long long k = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x; k < end;
       k += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned bits = k <= top ? (unsigned)k : 0x80000000u | (unsigned)(k - top - 1);
    const float x = __uint_as_float(bits);
    const float s0 = sin_angle(x), s1 = sinf(x), c0 = cos_angle(x), c1 = cosf(x);
    bad += !(__float_as_uint(s0) == __float_as_uint(s1) || (s0 != s0 && s1 != s1));
    bad += !(__float_as_uint(c0) == __float_as_uint(c1) || (c0 != c0 && c1 != c1));
  }
  for (int o = 16; o > 0; o >>= 1) bad += __shfl_down_sync(FULL, bad, o);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(count, bad);
}

// blocks of a persistent grid: as many as fit on the card at once (read
// once into *resident), and no more than n lanes fill
template <class Kernel>
int persistent_blocks(Kernel kernel, int* resident, int n) {
  if (*resident == 0) {
    int b = 0, dev = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, THREADS, 0);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *resident = (b > 0 ? b : 1) * (sms > 0 ? sms : 1);
  }
  return *resident < blocks(n) ? *resident : blocks(n);
}

}  // namespace

// Each entry point launches on `stream` and returns the cudaError_t of the
// launch (0 on success). `a` (host memory) holds the device pointers of the
// lanes' layer: top and bottom BxDF parameters (kind (n,) int32; refl,
// trans, eta_re, eta_im (n,4) float32, 16-byte aligned; eta, ax, ay (n,)
// float32), thickness and g (n,), albedo (n,4), an optional mask (n,) bool
// and an optional uint64 step counter. Directions are (n,3) float32, uc
// (n,), u2 (n,2).

// f (n,4). `work`: two int32 words of this launch's own, zero (enqueue their
// memset on `stream` before the launch; two launches in flight must not
// share them); `walkers`: (n,) int32 scratch.
extern "C" int pbrt_layered_f(const LayeredArgs* a, const float* wo, const float* wi, float* f,
                              int* work, int* walkers, void* stream) {
  if (a->n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  static int walk_resident = 0;
  f_enter_kernel<<<blocks(a->n), THREADS, 0, s>>>(*a, wo, wi, f, work, walkers);
  f_walk_kernel<<<persistent_blocks(f_walk_kernel, &walk_resident, a->n), THREADS, 0, s>>>(
      *a, wo, wi, f, work, walkers);
  return (int)cudaGetLastError();
}

// pdf (n,)
extern "C" int pbrt_layered_pdf(const LayeredArgs* a, const float* wo, const float* wi,
                                float* pdf, void* stream) {
  if (a->n <= 0) return 0;
  layered_pdf_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a, wo, wi, pdf);
  return (int)cudaGetLastError();
}

// The number of floats x with |x| at most the float `limit` at which
// sin_angle or cos_angle differ from sinf or cosf, added to *count (uint64).
extern "C" int pbrt_bxdf_trig_mismatches(float limit, unsigned long long* count, void* stream) {
  unsigned top;
  memcpy(&top, &limit, 4);
  trig_check_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(top, count);
  return (int)cudaGetLastError();
}

// f (n,4), wi (n,3), pdf (n,), eta (n,), flags (n,) int32, valid (n,) bool;
// `work` and `walkers` as layered_f's; `handoff`: n x 64 bytes of scratch,
// 16-byte aligned
extern "C" int pbrt_layered_sample(const LayeredArgs* a, const float* wo, const float* uc,
                                   const float* u2, float* f, float* wi, float* pdf, float* eta,
                                   int* flags, uint8_t* valid, int* work, int* walkers,
                                   void* handoff, void* stream) {
  if (a->n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  static int walk_resident = 0;
  const SampleOut o = {f, wi, pdf, eta, flags, valid};
  Handoff* h = (Handoff*)handoff;
  sample_enter_kernel<<<blocks(a->n), THREADS, 0, s>>>(*a, wo, uc, u2, o, work, walkers, h);
  sample_walk_kernel<<<persistent_blocks(sample_walk_kernel, &walk_resident, a->n), THREADS, 0,
                       s>>>(*a, o, work, walkers, h);
  return (int)cudaGetLastError();
}
