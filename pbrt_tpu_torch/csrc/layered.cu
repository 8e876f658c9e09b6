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
// Design: one thread per lane, and the walk is a real loop. The JAX package
// runs every lane through all max_depth steps and masks the dead ones; here
// a lane `break`s when its walk dies. That is exact for n_samples = 1 (the
// wrapper refuses other values): a dead lane of layered_f adds nothing more
// to f, and a lane of layered_sample that stopped walking is never at a
// boundary again, so the draws it skips change no output. Each step draws
// the same numbers in the same order as the plain version and evaluates only
// the branch its lane takes (scatter or boundary, exit or non-exit
// interface, and in csrc/bxdf.cuh only the lane's own BxDF kind). An
// optional mask skips lanes whose material is not coated; their outputs are
// zeros (pdf 0, valid false, eta 1). Built with --fmad=false and IEEE sqrt
// and division; only the transcendental functions and the complex square
// root may round differently from torch's, so a comparison in the walk can
// flip on a rare lane and the kernel agrees with the plain version lane by
// lane on almost every lane, not on all.
//
// What bounds it on the H100: operations, when the walks are long. A lane
// of layered_f or layered_sample reads its two interfaces (2 x 80 bytes),
// thickness, g, albedo and its directions (or uc and u2) and writes 16 to
// 41 bytes, ~0.25 KB; a lane of layered_pdf reads the coat and its
// directions, and the base only where its estimate reaches it. A walk step
// costs a few hundred float operations (two to four BxDF evaluations and
// samples, each with Trowbridge-Reitz terms and Fresnel), and a lane takes a
// few steps. Divergence between lanes that die at different steps, and
// register pressure from the walk's state (two BxDFs, beta, f, the RNG) are
// what keep it from either bound; -Xptxas -v reports registers and spills.
// An optional device counter accumulates the steps taken (layered_pdf: the
// lanes whose estimate reached the base), for the bound.

#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ S4 load4(const float* p, int i) {
  const float4 v = reinterpret_cast<const float4*>(p)[i];
  return {{v.x, v.y, v.z, v.w}};
}

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ Bxdf load_bxdf(const BxdfPtrs& p, int i) {
  Bxdf b;
  b.kind = p.kind[i];
  b.refl = load4(p.refl, i);
  b.trans = load4(p.trans, i);
  b.eta_re = load4(p.eta_re, i);
  b.eta_im = load4(p.eta_im, i);
  b.eta = p.eta[i];
  b.ax = p.ax[i];
  b.ay = p.ay[i];
  return b;
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

// pdf of leaving through the exit interface (`exit_pdf_trans`): the bottom
// with both lobes, the top with transmission only
__device__ __forceinline__ float exit_pdf(const Bxdf& top, const Bxdf& bot, bool exit_bottom,
                                          V3 w_neg, V3 wi) {
  return exit_bottom ? bxdf_pdf(bot, w_neg, wi, true, true)
                     : bxdf_pdf(top, w_neg, wi, false, true);
}

// one lane of layered_f (layered_bxdf.h:53-245); -> walk steps taken
__device__ int layered_f_lane(const LayeredArgs& a, int i, V3 wo, V3 wi, S4& f_acc) {
  const Bxdf top = load_bxdf(a.top, i), bot = load_bxdf(a.bottom, i);
  const float thick = a.thickness[i], g = a.g[i];
  const S4 albedo = load4(a.albedo, i);
  // twoSided: flip both into the upper hemisphere
  if (wo.z < 0.f) {
    wo = neg(wo);
    wi = neg(wi);
  }
  const bool same = wo.z * wi.z > 0.f;
  const bool exit_bottom = !same;
  const float exit_z = exit_bottom ? 0.f : thick;
  const bool top_spec = effectively_smooth(top.ax, top.ay);
  const bool bot_spec = bot.kind == K_CONDUCTOR && effectively_smooth(bot.ax, bot.ay);
  const bool exit_spec = exit_bottom ? bot_spec : top_spec;
  const bool nonexit_spec = exit_bottom ? top_spec : bot_spec;
  const Bxdf& exit_b = exit_bottom ? bot : top;
  const Bxdf& nonexit_b = exit_bottom ? top : bot;

  f_acc = same ? bxdf_f(top, wo, wi) : s4(0.f);
  Pcg32 r = pcg32_set_sequence(hash_v3(wo), hash_v3(wi));
  // entrance transmission sample, then the virtual light sample from wi
  // through the exit interface (importance transport: no 1/eta^2)
  float uc = r1(r), u0 = r1(r), u1 = r1(r);
  const BSample wos = bxdf_sample(top, wo, uc, u0, u1, false, true, true);
  uc = r1(r);
  u0 = r1(r);
  u1 = r1(r);
  const BSample wis = bxdf_sample(exit_b, wi, uc, u0, u1, false, true, false);
  if (!(ok(wos) && ok(wis))) return 0;
  S4 beta = (wos.f * fabsf(wos.wi.z)) / fmaxf(wos.pdf, 1e-12f);
  float z = thick;
  V3 w = wos.wi;
  const bool has_albedo = any_pos(albedo);
  const float inv_wis = fmaxf(wis.pdf, 1e-12f);

  int steps = 0;
  for (int depth = 0; depth < a.max_depth; ++depth) {
    ++steps;
    const float bmax = max4(beta);
    const float u_rr = r1(r);
    if (depth > 3 && bmax < 0.25f) {
      const float q = fmaxf(0.f, 1.f - bmax);
      if (u_rr < q) break;
      beta = beta / fmaxf(1.f - q, 1e-9f);
    }
    // medium segment
    const float u_d = r1(r);
    const float dz = -log1pf(-u_d) * fabsf(w.z);
    const float zp = w.z > 0.f ? z + dz : z - dz;
    const bool scatter = has_albedo && zp > 0.f && zp < thick;
    if (!has_albedo) beta = beta * tr(thick, w);
    const float z_b = has_albedo ? clampf(zp, 0.f, thick) : (z == thick ? 0.f : thick);
    const float uph0 = r1(r), uph1 = r1(r);
    const float uce = r1(r), ue0 = r1(r), ue1 = r1(r);
    const float ucn = r1(r), un0 = r1(r), un1 = r1(r);

    if (scatter) {
      // NEE through the exit interface along wis, then a phase resample
      const float ph_exit = henyey_greenstein(dot(neg(w), neg(wis.wi)), g);
      const float wt = exit_spec ? 1.f : power_heuristic(wis.pdf, ph_exit);
      f_acc = f_acc + (((((beta * albedo) * ph_exit) * wt) * tr(zp - exit_z, wis.wi)) *
                       wis.f) / inv_wis;
      V3 wi_ph;
      const float pdf_ph = sample_henyey_greenstein(neg(w), g, uph0, uph1, wi_ph);
      if (!(pdf_ph > 0.f && wi_ph.z != 0.f)) break;
      const S4 beta_sc = beta * albedo;
      if ((zp < exit_z && wi_ph.z > 0.f) || (zp > exit_z && wi_ph.z < 0.f)) {
        const V3 mw = neg(wi_ph);
        const float wt2 = power_heuristic(pdf_ph, exit_pdf(top, bot, exit_bottom, mw, wi));
        f_acc = f_acc + ((beta_sc * tr(zp - exit_z, wi_ph)) * bxdf_f(exit_b, mw, wi)) * wt2;
      }
      beta = beta_sc;
      w = wi_ph;
      z = zp;
      continue;
    }
    if (z_b == exit_z) {
      // exit interface: reflection resample, the walk goes on
      const BSample bs = bxdf_sample(exit_b, neg(w), uce, ue0, ue1, true, false, true);
      if (!ok(bs)) break;
      beta = ((beta * bs.f) * fabsf(bs.wi.z)) / fmaxf(bs.pdf, 1e-12f);
      w = bs.wi;
      z = z_b;
      continue;
    }
    // non-exit interface: NEE along wis, then a reflection resample and
    // NEE through the exit interface along it
    const V3 mw = neg(w), mwis = neg(wis.wi);
    const float wt_ne = exit_spec ? 1.f
                                  : power_heuristic(wis.pdf,
                                                    bxdf_pdf(nonexit_b, mw, mwis, true, true));
    f_acc = f_acc + (((((beta * bxdf_f(nonexit_b, mw, mwis)) * fabsf(wis.wi.z)) * wt_ne) *
                      tr(thick, wis.wi)) * wis.f) / inv_wis;
    const BSample bs = bxdf_sample(nonexit_b, mw, ucn, un0, un1, true, false, true);
    if (!ok(bs)) break;
    const S4 beta_ne = ((beta * bs.f) * fabsf(bs.wi.z)) / fmaxf(bs.pdf, 1e-12f);
    const V3 mb = neg(bs.wi);
    const float wt3 = nonexit_spec ? 1.f
                                   : power_heuristic(bs.pdf,
                                                     exit_pdf(top, bot, exit_bottom, mb, wi));
    f_acc = f_acc + ((beta_ne * tr(thick, bs.wi)) * bxdf_f(exit_b, mb, wi)) * wt3;
    beta = beta_ne;
    w = bs.wi;
    z = z_b;
  }
  return steps;
}

// one lane of layered_sample (layered_bxdf.h:247-372); -> walk steps taken
__device__ int layered_sample_lane(const LayeredArgs& a, int i, V3 wo, float uc, float u0,
                                   float u1, BSample& out) {
  const Bxdf top = load_bxdf(a.top, i), bot = load_bxdf(a.bottom, i);
  const float thick = a.thickness[i], g = a.g[i];
  const S4 albedo = load4(a.albedo, i);
  const bool flip = wo.z < 0.f;
  const V3 wof = flip ? neg(wo) : wo;

  const BSample bs0 = bxdf_sample(top, wof, uc, u0, u1, true, true, true);
  const bool ok0 = ok(bs0);
  const bool refl0 = (bs0.flags & F_TRANSMISSION) == 0;
  out.eta = 1.f;
  if (ok0 && refl0) {  // immediate reflection exits at once
    out.f = bs0.f;
    out.wi = flip ? neg(bs0.wi) : bs0.wi;
    out.pdf = bs0.pdf;
    out.flags = bs0.flags;
    out.valid = true;
    return 0;
  }
  // transmitted into the layer: random walk
  S4 f_cur = bs0.f * fabsf(bs0.wi.z);
  float pdf_cur = bs0.pdf;
  bool spec_path = (bs0.flags & F_SPECULAR) != 0;
  V3 w = bs0.wi;
  float z = thick;
  const bool has_albedo = any_pos(albedo);
  bool done = false;
  S4 exit_f = s4(0.f);
  V3 exit_wi = w;
  float exit_pdf = 1.f;
  bool exit_spec = spec_path;

  int steps = 0;
  if (ok0) {
    Pcg32 r = pcg32_set_sequence(
        hash_v3(wof), murmur64a_3(__float_as_uint(uc), __float_as_uint(u0), __float_as_uint(u1)));
    for (int depth = 0; depth < a.max_depth; ++depth) {
      ++steps;
      const float rr_beta = max4(f_cur) / fmaxf(pdf_cur, 1e-12f);
      const float u_rr = r1(r);
      if (depth > 3 && rr_beta < 0.25f) {
        const float q = fmaxf(0.f, 1.f - rr_beta);
        if (u_rr < q) break;
        pdf_cur = pdf_cur * (1.f - q);
      }
      if (w.z == 0.f) break;
      // medium
      const float u_d = r1(r);
      const float dz = -log1pf(-u_d) * fabsf(w.z);
      const float zp = w.z > 0.f ? z + dz : z - dz;
      const bool scatter = has_albedo && zp > 0.f && zp < thick;
      const float uph0 = r1(r), uph1 = r1(r);
      const float uci = r1(r), ui0 = r1(r), ui1 = r1(r);
      if (scatter) {
        V3 wi_ph;
        const float pdf_ph = sample_henyey_greenstein(neg(w), g, uph0, uph1, wi_ph);
        if (!(pdf_ph > 0.f && wi_ph.z != 0.f)) break;
        f_cur = (f_cur * albedo) * pdf_ph;
        pdf_cur = pdf_cur * pdf_ph;
        spec_path = false;
        w = wi_ph;
        z = zp;
        continue;
      }
      // boundary advance and the interface sample there
      const S4 f_bnd = has_albedo ? f_cur : f_cur * tr(thick, w);
      const float z_bnd = has_albedo ? clampf(zp, 0.f, thick) : (z == thick ? 0.f : thick);
      const BSample bs = bxdf_sample(z_bnd == 0.f ? bot : top, neg(w), uci, ui0, ui1, true,
                                     true, true);
      if (!ok(bs)) break;
      const S4 f_if = f_bnd * bs.f;
      const float pdf_if = pdf_cur * bs.pdf;
      const bool spec_if = spec_path && (bs.flags & F_SPECULAR) != 0;
      if (bs.flags & F_TRANSMISSION) {  // leaves the layer: the sample
        done = true;
        exit_f = f_if;
        exit_wi = bs.wi;
        exit_pdf = pdf_if;
        exit_spec = spec_if;
        break;
      }
      f_cur = f_if * fabsf(bs.wi.z);
      pdf_cur = pdf_if;
      spec_path = spec_if;
      w = bs.wi;
      z = z_bnd;
    }
  }
  out.f = exit_f;
  out.wi = flip ? neg(exit_wi) : exit_wi;
  out.pdf = exit_pdf;
  out.flags = (wof.z * exit_wi.z > 0.f ? F_REFLECTION : F_TRANSMISSION) |
              (exit_spec ? F_SPECULAR : F_GLOSSY);
  out.valid = done;
  return steps;
}

// one lane of layered_pdf (layered.py:475-508): the entrance reflection pdf
// plus one transmission-reflection-transmission estimate, blended with the
// uniform sphere pdf; -> 1 when the estimate reached the base (read its
// parameters and evaluated its pdf), else 0
__device__ int layered_pdf_lane(const LayeredArgs& a, int i, V3 wo, V3 wi, float& pdf) {
  const Bxdf top = load_bxdf(a.top, i);
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
      const Bxdf bot = load_bxdf(a.bottom, i);
      s = s + bxdf_pdf(bot, neg(wos.wi), neg(wis.wi), true, true);
      base = 1;
    }
  }
  pdf = (0.9f * s) / 1.f + (float)(0.1 / (4.0 * 3.141592653589793));
  return base;
}

__device__ __forceinline__ bool lane_live(const LayeredArgs& a, int i) {
  return i < a.n && (a.mask == nullptr || a.mask[i]);
}

// add the block's steps to the device counter
__device__ __forceinline__ void count_steps(const LayeredArgs& a, int steps) {
  if (a.steps == nullptr) return;
  __shared__ unsigned long long block_steps;
  if (threadIdx.x == 0) block_steps = 0;
  __syncthreads();
  if (steps) atomicAdd(&block_steps, (unsigned long long)steps);
  __syncthreads();
  if (threadIdx.x == 0 && block_steps) atomicAdd(a.steps, block_steps);
}

__global__ void __launch_bounds__(THREADS)
layered_f_kernel(LayeredArgs a, const float* __restrict__ wo, const float* __restrict__ wi,
                 float* __restrict__ f) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int steps = 0;
  if (lane_live(a, i)) {
    S4 out;
    steps = layered_f_lane(a, i, load3(wo, i), load3(wi, i), out);
    reinterpret_cast<float4*>(f)[i] = make_float4(out.v[0], out.v[1], out.v[2], out.v[3]);
  } else if (i < a.n) {
    reinterpret_cast<float4*>(f)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  count_steps(a, steps);
}

__global__ void __launch_bounds__(THREADS)
layered_sample_kernel(LayeredArgs a, const float* __restrict__ wo, const float* __restrict__ uc,
                      const float* __restrict__ u2, float* __restrict__ f,
                      float* __restrict__ wi, float* __restrict__ pdf,
                      float* __restrict__ eta, int* __restrict__ flags,
                      uint8_t* __restrict__ valid) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int steps = 0;
  if (i < a.n) {
    BSample s = {s4(0.f), {0.f, 0.f, 0.f}, 0.f, 1.f, 0, false};
    if (lane_live(a, i))
      steps = layered_sample_lane(a, i, load3(wo, i), uc[i], u2[2 * i], u2[2 * i + 1], s);
    reinterpret_cast<float4*>(f)[i] = make_float4(s.f.v[0], s.f.v[1], s.f.v[2], s.f.v[3]);
    wi[3 * i] = s.wi.x;
    wi[3 * i + 1] = s.wi.y;
    wi[3 * i + 2] = s.wi.z;
    pdf[i] = s.pdf;
    eta[i] = s.eta;
    flags[i] = s.flags;
    valid[i] = s.valid;
  }
  count_steps(a, steps);
}

__global__ void __launch_bounds__(THREADS)
layered_pdf_kernel(LayeredArgs a, const float* __restrict__ wo, const float* __restrict__ wi,
                   float* __restrict__ pdf) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int steps = 0;
  if (lane_live(a, i)) {
    float p;
    steps = layered_pdf_lane(a, i, load3(wo, i), load3(wi, i), p);
    pdf[i] = p;
  } else if (i < a.n) {
    pdf[i] = 0.f;
  }
  count_steps(a, steps);
}

int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// Each entry point launches on `stream` and returns the cudaError_t of the
// launch (0 on success). `a` (host memory) holds the device pointers of the
// lanes' layer: top and bottom BxDF parameters (kind (n,) int32; refl,
// trans, eta_re, eta_im (n,4) float32; eta, ax, ay (n,) float32), thickness
// and g (n,), albedo (n,4), an optional mask (n,) bool and an optional
// uint64 step counter. Directions are (n,3) float32, uc (n,), u2 (n,2).

// f (n,4)
extern "C" int pbrt_layered_f(const LayeredArgs* a, const float* wo, const float* wi, float* f,
                              void* stream) {
  if (a->n <= 0) return 0;
  layered_f_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a, wo, wi, f);
  return (int)cudaGetLastError();
}

// pdf (n,)
extern "C" int pbrt_layered_pdf(const LayeredArgs* a, const float* wo, const float* wi,
                                float* pdf, void* stream) {
  if (a->n <= 0) return 0;
  layered_pdf_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a, wo, wi, pdf);
  return (int)cudaGetLastError();
}

// f (n,4), wi (n,3), pdf (n,), eta (n,), flags (n,) int32, valid (n,) bool
extern "C" int pbrt_layered_sample(const LayeredArgs* a, const float* wo, const float* uc,
                                   const float* u2, float* f, float* wi, float* pdf, float* eta,
                                   int* flags, uint8_t* valid, void* stream) {
  if (a->n <= 0) return 0;
  layered_sample_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(
      *a, wo, uc, u2, f, wi, pdf, eta, flags, valid);
  return (int)cudaGetLastError();
}
