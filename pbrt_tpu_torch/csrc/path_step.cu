// K6: the path integrator's bounce step for Hopper (sm_90a), five kernels
// around the two visibility dispatches of a bounce and, on a scene with
// coated materials, around K7's launches.
//
// Replaces the TPU hot path pbrt_tpu/integrators/path.py:193 `bounce_step`
// (the per-bounce body of :470 `li`), with K9 (sampling/rng.py PCG32 and
// MurmurHash64A, samplers.py get_1d / get_2d: the independent, stratified
// and MLT kinds) and K10 (spectral/spectra.py table lookups and the sigmoid
// polynomial) inside it. Plain version: pbrt_tpu_torch/integrators/path.py
// `rr_plain`, `shade_plain` (`shade_light_plain`, `shade_bsdf_plain`),
// `coat_plain`, `resolve_plain`, which the chain
//   path_rr      the loop head: the lanes that trace (depth < max depth),
//                the russian-roulette draw where due, the kill, the scaled
//                beta, the next RR depth, each lane's t_max, and the count
//                of tracing lanes added to n_closest;
//   (dispatch.intersect: K1 / K1i / K11 or K3 / K4 and the record glue)
//   path_shade   escaped rays' uniform infinite light and area-light
//                emission, both MIS-weighted; the BSDF of the four uncoated
//                kinds (a dispersive dielectric terminates the secondary
//                wavelengths); the NEE draws, the light pick (alias table)
//                and the light sample of every kind (triangle with the
//                spherical-triangle and bilinear warps or by area, sphere,
//                disk, spot, distant, uniform infinite), the BSDF's f and
//                pdf there and the power-heuristic weight, written as the
//                shadow ray (t_max 0 without NEE) and the pending term;
//   path_bsdf    the BSDF draws (past the NEE draws) and sample, the new
//                beta, the offset origin and the rest of the next state.
//                A coated lane (coateddiffuse, coatedconductor) gets
//                everything of the two that does not depend on its layered
//                walk, and its walk's inputs: the layer (make_bsdf's coated
//                branch, K7's LayeredArgs), the local wo and light
//                direction, the light sample (path_shade), the BSDF draws
//                (path_bsdf); its ray, throughput and pending term stay;
//   (K7 on the coated lanes: layered_f and layered_pdf at the light's
//    direction, layered_sample; csrc/layered.cu)
//   path_coat    the coated lanes finished from K7's answers: the NEE term
//                with its MIS weight, the new beta, ray and flags, and the
//                direction of the MIS pdf (updating path_shade's and
//                path_bsdf's outputs in place);
//   (K7 layered_pdf at that direction; dispatch.occluded)
//   path_resolve L += beta * ld on the NEE lanes whose shadow ray is
//                unblocked, the count of NEE lanes added to n_shadow, and
//                on the coated lanes that go on, the MIS pdf
// follows on the card for every render of the path integrator (and MLT's
// path evaluations); path.step_route sends only CPU tensors to the plain
// step.
// On a volumetric scene (homogeneous media, material-less interfaces:
// bounce_step's volumetric branches, JAX path.py:236-425) three VOLUMETRIC
// variants take the place of path_shade, path_bsdf and path_resolve
// (path_shade_vol, path_bsdf_vol, path_resolve_vol: kernels of their own,
// with a second argument record VolArgs, so that a scene without media
// launches exactly the kernels it did before); plain versions
// shade_light_vol_plain, shade_bsdf_vol_plain, resolve_vol_plain:
//   path_shade_vol  a lane in a medium draws its exponential distance first
//                   and scatters where it falls short of the hit (beta *=
//                   sigma_s / sigma_t) or multiplies its transmittance pdf
//                   by the segment's transmittance; the MIS pdfs of
//                   emission are weighted by that pdf; NEE from a surface or
//                   from a scatter point (there f and pdf are those of a
//                   fresh HG sample, drawn after the light draws, as the JAX
//                   package does); the shadow segment with its end and start
//                   medium, and the pending term with its MIS pdfs;
//                   interfaces cost 0.3 depth;
//   (K6t, csrc/transmit.cu, MAX_HOPS rounds with dispatch.intersect: the
//    shadow segments' transmittance)
//   path_bsdf_vol   the draws of path_shade_vol stepped past, the HG
//                   continuation of a scatter, the straight pass through an
//                   interface, the BSDF sample, and the medium the next ray
//                   travels in;
//   path_resolve_vol L += beta * the NEE term times the transmittance, its
//                   power heuristic against pdf_bsdf times the
//                   transmittance's mean, where some transmittance is left.
// Coated materials in a volumetric scene are not covered (the wrapper
// raises).
//
// One thread a lane. A lane evaluates only the branches it takes (its
// material's kind, its light's type and shape, the sampling branch of a
// triangle light), with the arithmetic of the plain version in the same
// order (3-term dot products as (x + y) + z; the file is built with
// --fmad=false). The draws are the plain version's bits: PCG32 state and
// dimension as u64 in the int64 tensors, masked lanes not advancing, the
// stratified kind's stratum hash, the MLT kind's primary-sample vector
// while the dimension is below its length (the stream advancing on every
// draw). The float results agree with the plain
// version lane by lane on almost every lane, not on all: asinf, atan2f,
// sinf, cosf and the complex square root round apart from torch's on some
// inputs, and the spherical-triangle sample and its inverse are
// ill-conditioned in float32, so a branch can flip on a rare lane. A coated
// lane's walk seeds on the bits of its local directions, which torch sums
// in another order, so coated lanes agree with the plain step in
// distribution, not lane by lane.
// The two ray counts are exact int64 sums: a warp ballot, one shared add a
// warp, one global add a block into a scratch word, and the last block to
// finish adds the sum to the incoming count and zeroes the scratch. L has
// no atomics, so a frame's film is the same bits on every run.
//
// What bounds it on the H100: bytes, a few hundred a lane (the path state
// in and out, the hit record, the shadow ray and the pending term; on a
// coated lane its layer, ~184, and the walk's inputs), by the count of
// chip_smoke.py; the operations are a few thousand a lane where it shades.
// Shading, the bulk of the step, was measured against variants that hold
// more warps on an SM (tools/k6_designs.py, see light_lane below): at a
// frame's first bounce they run as fast as one kernel of 127 registers,
// not faster, so what holds it there is its instructions (the light
// sample's IEEE divisions, square roots and inverse trigonometry, with no
// contraction into fused multiply-adds), not the latency of its loads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bxdf.cuh"

// mirrored by pbrt_tpu_torch/integrators/path.py `_StepArgs` (_ARG_FIELDS,
// then _INT_FIELDS): every field 8 bytes. (R,) and (R, k) lane arrays are
// contiguous; bool arrays are one byte a lane; (R, 4) rows 16-byte aligned.
struct StepArgs {
  // the path state in
  const float *o, *d, *L, *beta, *lam, *lam_pdf;
  const long long *smp_state, *smp_inc, *smp_pixel, *smp_sample, *smp_dim;
  const float* mlt_x;  // the MLT kind's primary-sample vectors (R, mlt_d), else null
  const uint8_t *active, *specular;
  const float *depth, *rr_next, *prev_pdf, *prev_p, *prev_ns;
  const long long* count_in;  // n_closest (path_rr) or n_shadow (path_resolve)
  // closest hits (path_shade, path_coat); the pending term and the shadow
  // answers (path_resolve)
  const uint8_t* hit_valid;
  const float *hit_p, *hit_ng, *hit_ns;
  const long long *hit_mat, *hit_light;
  // a textured scene's K13 answer (csrc/texture.cu; hit_mat then holds its
  // resolved material): per lane the textured reflectance and transmittance
  // (R, 4), u and v roughness, and the mask of the slots it wrote (bits 1,
  // 2, 4, 8); tex_mask is null on a scene without textures
  const float *tex_refl, *tex_trans, *tex_urough, *tex_vrough;
  const uint8_t* tex_mask;
  const uint8_t* nee;
  const float* ld;
  const uint8_t* occluded;
  // outputs (path_coat updates those of path_shade in place)
  float *o_out, *d_out, *L_out, *beta_out, *lam_pdf_out;
  long long *smp_state_out, *smp_dim_out;
  uint8_t *active_out, *specular_out;
  float *depth_out, *rr_next_out, *prev_pdf_out, *prev_p_out, *prev_ns_out, *t_max_out;
  long long* count_out;
  float *sh_o, *sh_d, *sh_t;
  uint8_t* nee_out;
  float* ld_out;
  unsigned long long* scratch;  // [sum, ticket], zero between launches
  // the coated lanes (path_shade writes them, K7 and path_coat read them):
  // the coated shading lanes and those with NEE (every lane); on coated
  // lanes the layer as K7's LayeredArgs (csrc/layered.cu), the local wo,
  // the local light direction, the BSDF draws, the light sample
  uint8_t *coat, *coat_nee;
  int* top_kind;
  float *top_refl, *top_trans, *top_eta_re, *top_eta_im, *top_eta, *top_ax, *top_ay;
  int* bot_kind;
  float *bot_refl, *bot_trans, *bot_eta_re, *bot_eta_im, *bot_eta, *bot_ax, *bot_ay;
  float *thickness, *g, *albedo, *wo_l, *wi_l, *uc, *u2, *light_L, *light_pdf;
  uint8_t *light_ok, *light_delta;
  // K7's answers (path_coat): layered_f and layered_pdf at the light's
  // direction, layered_sample; the direction of the MIS pdf (path_coat
  // writes it on the lanes of mis_mask, every lane) and that pdf
  // (path_resolve)
  const float *lay_f, *lay_pdf, *s_f, *s_wi, *s_pdf;
  const int* s_flags;
  const uint8_t* s_valid;
  float* mis_wi;
  uint8_t* mis_mask;
  const float* mis_pdf;
  // scene rows (integrators/path.py step_tables)
  const float *mat, *spec, *lt, *emission, *uinf, *scal, *tri_p0, *tri_p1, *tri_p2, *sph_center,
      *sph_radius, *dsk_center, *dsk_normal, *dsk_radius, *dsk_inner;
  long long n, n_lights, n_tris, max_depth, stratified, spp, sqrt_spp, open_scene, mlt_d;
};

// the VOLUMETRIC variants' second record, mirrored by integrators/path.py
// `_VolArgs`: every field 8 bytes
struct VolArgs {
  // in: the closest hits' t and media, the lanes' medium and transmittance
  // pdf (R, 4)
  const float* hit_t;
  const long long *hit_med_in, *hit_med_out, *medium;
  const float* trans_pdf;
  // out (path_bsdf_vol): the next medium and transmittance pdf
  long long* medium_out;
  float* trans_pdf_out;
  // out (path_shade_vol): the shadow segments' ends and start media, the
  // pending term's throughput (R, 4) and MIS pdfs (R, 2) [pdf_light,
  // pdf_bsdf or -1 for a delta light]; in (path_resolve_vol): those and the
  // segments' transmittance (R, 4)
  float* sh_p;
  long long* sh_med;
  float *nee_beta, *nee_mis;
  const float* trans;
  // media rows: sigma_a, sigma_s (n_media, 471), the HG asymmetry (n_media,)
  const float *sigma_a, *sigma_s, *med_g;
  long long n_media;
};

namespace {

using namespace pbrt_bxdf;

constexpr int THREADS = 128;
// path_shade's and path_bsdf's blocks an SM: at most 80 registers a thread;
// path_shade_vol's: at most 128 (at 80 it spilled 264 bytes a thread)
constexpr int SHADE_BLOCKS = 6, SHADE_VOL_BLOCKS = 4;
constexpr int LAMBDA_MIN = 360, LAMBDA_RANGE = 471;
// material rows (path.MAT_F columns)
constexpr int MAT_F = 22;
constexpr int M_TYPE = 0, M_REMAP = 1, M_UROUGH = 2, M_VROUGH = 3, M_ETA = 4, M_ETA_SPEC = 5,
              M_K_SPEC = 6, M_REFL_MODE = 7, M_REFL_C = 8, M_TRANS_C = 11, M_IETA = 14,
              M_CROUGH_U = 15, M_CROUGH_V = 16, M_THICKNESS = 17, M_LAY_G = 18, M_ALBEDO_C = 19;
constexpr int MAT_DIFFUSE = 0, MAT_CONDUCTOR = 1, MAT_DIELECTRIC = 2, MAT_COATED_DIFFUSE = 4,
              MAT_COATED_CONDUCTOR = 5;
// the coated kinds (materials/bxdfs.py), whose lanes run K7's walk
constexpr int K_COATED_DIFFUSE = 4, K_COATED_CONDUCTOR = 5;
// light rows (path.LT_F columns) and scalars (path.SCAL_F)
constexpr int LT_F = 18;
constexpr int L_TYPE = 0, L_PMF = 1, L_TWO = 2, L_SCALE = 3, L_TRI = 4, L_SPH = 5, L_DSK = 6,
              L_DIR = 7, L_POS = 10, L_COS_START = 13, L_COS_END = 14, L_Q = 15, L_ALIAS = 16,
              L_ALIAS_PMF = 17;
constexpr int S_OFFSET = 0, S_TWO_R = 1, S_INF_DENSITY = 2;
constexpr int LIGHT_AREA = 0, LIGHT_DISTANT = 1, LIGHT_SPOT = 4;
// Python constants folded in double precision, then rounded once
constexpr float INF_T = 3.4028234663852886e38f;  // utils.math.INFINITY
constexpr float RR_CLAMP = 0.95f;
constexpr float SHADOW_SHORTEN = (float)(1.0 - 1e-3);
constexpr float UNIFORM_SPHERE_PDF = (float)(1.0 / (4.0 * 3.141592653589793));
constexpr float FOUR_PI_F = (float)(4.0 * 3.141592653589793);
constexpr float MIN_SPHERICAL_AREA = 3e-4f, MAX_SPHERICAL_AREA = 6.22f;
constexpr float SMALL_CONE = 0.00068523f;
constexpr float ONE_THIRD = (float)(1.0 / 3.0);
constexpr float INTERFACE_COST = 0.3f;               // path.INTERFACE_BOUNCE_COST
constexpr float U_DIST_MAX = (float)(1.0 - 1e-7);    // the distance draw's clamp

// ------------------------------------------------------------- vectors

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, float k) { return {a.x * k, a.y * k, a.z * k}; }
__device__ __forceinline__ V3 divv(V3 a, float k) { return {a.x / k, a.y / k, a.z / k}; }
__device__ __forceinline__ float len(V3 v) { return safe_sqrt(dot(v, v)); }
// a x + b y (per component, the two products rounded first)
__device__ __forceinline__ V3 comb2(float a, V3 x, float b, V3 y) {
  return {a * x.x + b * y.x, a * x.y + b * y.y, a * x.z + b * y.z};
}
// (a x + b y) + c z
__device__ __forceinline__ V3 comb3(float a, V3 x, float b, V3 y, float c, V3 z) {
  return {(a * x.x + b * y.x) + c * z.x, (a * x.y + b * y.y) + c * z.y,
          (a * x.z + b * y.z) + c * z.z};
}
// v - (v . w) w (vecmath.gram_schmidt)
__device__ __forceinline__ V3 gram_schmidt(V3 v, V3 w) { return sub(v, mul(w, dot(v, w))); }

__device__ __forceinline__ V3 ld3(const float* p, long long i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void st3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ S4 ld4(const float* p, long long i) {
  const float4 v = reinterpret_cast<const float4*>(p)[i];
  return {{v.x, v.y, v.z, v.w}};
}
__device__ __forceinline__ void st4(float* p, long long i, const S4& v) {
  reinterpret_cast<float4*>(p)[i] = make_float4(v.v[0], v.v[1], v.v[2], v.v[3]);
}

__device__ __forceinline__ float safe_asin(float x) { return asinf(clampf(x, -1.f, 1.f)); }

// ---------------------------------------------- samplers (K9: rng.py, samplers.py)

struct Smp {
  Pcg32 r;
  uint32_t pixel, sample;
  long long dim;
  int lane;
};

__device__ __forceinline__ Smp load_smp(const StepArgs& a, int i) {
  Smp s;
  s.lane = i;
  s.r = {(uint64_t)a.smp_state[i], (uint64_t)a.smp_inc[i]};
  s.pixel = (uint32_t)a.smp_pixel[i];
  s.sample = (uint32_t)a.smp_sample[i];
  s.dim = a.smp_dim[i];
  return s;
}

__device__ __forceinline__ void store_smp(const StepArgs& a, int i, const Smp& s) {
  a.smp_state_out[i] = (long long)s.r.state;
  a.smp_dim_out[i] = s.dim;
}

// pbrt::hash(int, int): MurmurHash64A of two 4-byte words, seed 0
__device__ __forceinline__ uint64_t murmur64a_2(uint32_t w0, uint32_t w1) {
  const uint64_t m = 0xC6A4A7935BD1E995ULL;
  uint64_t h = 8ULL * m;
  uint64_t k = ((uint64_t)w1 << 32) | w0;
  k *= m;
  k ^= k >> 47;
  k *= m;
  h = (h ^ k) * m;
  h ^= h >> 47;
  h *= m;
  return h ^ (h >> 47);
}

// correlated-shuffle permutation (samplers.permutation_element: the
// rejection loop of 16 rounds; the rounds after the first accepted one
// change nothing)
__device__ __forceinline__ uint32_t permutation_element(uint32_t i, uint32_t l, uint32_t p) {
  uint32_t w = l - 1;
  w |= w >> 1;
  w |= w >> 2;
  w |= w >> 4;
  w |= w >> 8;
  w |= w >> 16;
  uint32_t out = i;
  for (int round = 0; round < 16; ++round) {
    i ^= p;
    i *= 0xE170893Du;
    i ^= p >> 16;
    i ^= (i & w) >> 4;
    i ^= p >> 8;
    i *= 0x0929EB3Fu;
    i ^= p >> 23;
    i ^= (i & w) >> 1;
    i *= 1u | (p >> 27);
    i *= 0x6935FA69u;
    i ^= (i & w) >> 11;
    i *= 0x74DCB303u;
    i ^= (i & w) >> 2;
    i *= 0x9E501CC3u;
    i ^= (i & w) >> 2;
    i *= 0xC860A3DFu;
    i &= w;
    i ^= i >> 5;
    if (i < l) {
      out = i;
      break;
    }
  }
  return (out + p) % l;
}

__device__ __forceinline__ uint32_t stratum(const StepArgs& a, const Smp& s) {
  const uint32_t h = (uint32_t)murmur64a_2(s.pixel, (uint32_t)s.dim);
  return permutation_element(s.sample, (uint32_t)a.spp, h);
}

// samplers.get_1d: the lane advances only where `mask`. The MLT kind
// serves dimension dim of the lane's primary-sample vector while dim < D;
// its stream advances on every draw all the same.
__device__ __forceinline__ float get_1d(const StepArgs& a, Smp& s, bool mask) {
  Pcg32 r = s.r;
  float u = pcg32_uniform(r);
  if (a.stratified) {
    u = ((float)stratum(a, s) + u) / (float)a.spp;
  } else if (a.mlt_x != nullptr && s.dim < a.mlt_d) {
    u = a.mlt_x[(long long)s.lane * a.mlt_d + s.dim];
  }
  if (mask) {
    s.r = r;
    s.dim += 1;
  }
  return u;
}

// samplers.get_2d (the stratified kind: one stratum for both axes; the
// MLT kind: two get_1d, so a masked lane draws the same number twice)
__device__ __forceinline__ void get_2d(const StepArgs& a, Smp& s, bool mask, float& u0,
                                       float& u1) {
  if (a.mlt_x != nullptr) {
    u0 = get_1d(a, s, mask);
    u1 = get_1d(a, s, mask);
    return;
  }
  Pcg32 r = s.r;
  u0 = pcg32_uniform(r);
  u1 = pcg32_uniform(r);
  if (a.stratified) {
    const uint32_t st = stratum(a, s), q = (uint32_t)a.sqrt_spp;
    u0 = ((float)(st % q) + u0) / (float)q;
    u1 = ((float)(st / q) + u1) / (float)q;
  }
  if (mask) {
    s.r = r;
    s.dim += 2;
  }
}

// ------------------------------------------------ spectra (K10: spectra.py)

__device__ __forceinline__ int lam_bin(float lam) {
  return min(max(__float2int_rn(lam) - LAMBDA_MIN, 0), LAMBDA_RANGE - 1);
}

// row `row` of a (n, 471) table at the four wavelengths
__device__ __forceinline__ S4 table4(const float* table, long long row, const S4& lam) {
  S4 out;
#pragma unroll
  for (int k = 0; k < 4; ++k) out.v[k] = table[row * LAMBDA_RANGE + lam_bin(lam.v[k])];
  return out;
}

// sigmoid(c0 lam^2 + c1 lam + c2), clamped to [0, 1] as make_bsdf does
__device__ __forceinline__ float sigmoid_poly01(const float* c, float lam) {
  const float x = (c[0] * lam + c[1]) * lam + c[2];
  float s;
  if (x >= 1e15f) {
    s = 1.f;
  } else if (x <= -1e15f) {
    s = 0.f;
  } else {
    s = (0.5f * x) / sqrtf(1.f + x * x) + 0.5f;
  }
  return clampf(s, 0.f, 1.f);
}

__device__ __forceinline__ S4 sigmoid4(const float* c, const S4& lam) {
  S4 out;
#pragma unroll
  for (int k = 0; k < 4; ++k) out.v[k] = sigmoid_poly01(c, lam.v[k]);
  return out;
}

// ---------------------------------------------- materials (materials.py)

// a roughness as the BxDF's alpha: remapped (roughness_to_alpha) or not,
// at least 1e-4
__device__ __forceinline__ float alpha_of(bool remap, float r) {
  return fmaxf(remap ? sqrtf(fmaxf(r, 1e-8f)) : r, 1e-4f);
}

// a conductor's k in reflectance mode: 2 sqrt(r) / sqrt(1 - r), r clamped
__device__ __forceinline__ float k_from_reflectance(float refl) {
  const float r = clampf(refl, 0.f, 0.9999f);
  return (2.f * sqrtf(fmaxf(r, 1e-12f))) / sqrtf(clampf(1.f - r, 1e-7f, 1.f));
}

// the slots of lane i that K13 wrote (0 on a scene without textures)
__device__ __forceinline__ int tex_slots(const StepArgs& a, int i) {
  return a.tex_mask != nullptr ? a.tex_mask[i] : 0;
}

// the reflectance (slot 1) or transmittance (slot 2) of lane i: K13's where
// it wrote it, else the material's sigmoid spectrum from column `col`
__device__ __forceinline__ S4 slot_spectrum(const StepArgs& a, int i, int slots, int bit,
                                            const float* row, int col, const S4& lam) {
  if (slots & bit) return ld4(bit == 1 ? a.tex_refl : a.tex_trans, i);
  return sigmoid4(row + col, lam);
}

// make_bsdf: lane i's BxDF parameters (the fields its kind reads; a coated
// kind only its kind and the coat's roughness, its layer is store_layer's),
// with a textured scene's overrides; `dispersive`: a dielectric with a
// spectral eta
__device__ __forceinline__ Bxdf make_bsdf(const StepArgs& a, int i, long long mat, const S4& lam,
                                          bool& dispersive) {
  const float* row = a.mat + MAT_F * (mat < 0 ? 0 : mat);
  const int slots = tex_slots(a, i);
  const int mtype = (int)row[M_TYPE];
  Bxdf b;
  b.kind = mtype == MAT_DIFFUSE            ? K_DIFFUSE
           : mtype == MAT_CONDUCTOR        ? K_CONDUCTOR
           : mtype == MAT_DIELECTRIC       ? K_DIELECTRIC
           : mtype == MAT_COATED_DIFFUSE   ? K_COATED_DIFFUSE
           : mtype == MAT_COATED_CONDUCTOR ? K_COATED_CONDUCTOR
                                           : K_DIFF_TRANS;
  const bool remap = row[M_REMAP] != 0.f;
  b.ax = alpha_of(remap, (slots & 4) ? a.tex_urough[i] : row[M_UROUGH]);
  b.ay = alpha_of(remap, (slots & 8) ? a.tex_vrough[i] : row[M_VROUGH]);
  const long long eta_spec = (long long)row[M_ETA_SPEC];
  b.refl = s4(0.f);
  b.trans = s4(0.f);
  b.eta_re = s4(1.f);
  b.eta_im = s4(0.f);
  b.eta = 1.f;
  dispersive = false;
  if (b.kind == K_DIFFUSE || b.kind == K_DIFF_TRANS) {
    b.refl = slot_spectrum(a, i, slots, 1, row, M_REFL_C, lam);
    if (b.kind == K_DIFF_TRANS) b.trans = slot_spectrum(a, i, slots, 2, row, M_TRANS_C, lam);
  } else if (b.kind == K_CONDUCTOR) {
    if (row[M_REFL_MODE] != 0.f) {
      // reflectance mode: eta = 1, k = 2 sqrt(r) / sqrt(1 - r)
      const S4 refl = slot_spectrum(a, i, slots, 1, row, M_REFL_C, lam);
#pragma unroll
      for (int k = 0; k < 4; ++k) b.eta_im.v[k] = k_from_reflectance(refl.v[k]);
    } else {
      const long long k_spec = (long long)row[M_K_SPEC];
      b.eta_re = table4(a.spec, eta_spec < 0 ? 0 : eta_spec, lam);
      b.eta_im = table4(a.spec, k_spec < 0 ? 0 : k_spec, lam);
    }
  } else if (b.kind == K_DIELECTRIC) {
    // dielectric eta: float, or the hero wavelength's spectral value
    float eta = eta_spec >= 0 ? a.spec[eta_spec * LAMBDA_RANGE + lam_bin(lam.v[0])]
                              : row[M_ETA];
    b.eta = eta == 0.f ? 1.f : eta;
    dispersive = eta_spec >= 0;
  }
  return b;
}

// make_bsdf's coated branch (materials.make_bsdf with layered_scene): the
// layer of coated lane i, written as K7's LayeredArgs arrays. The top is a
// dielectric with the coat's eta and the material's roughness (ax, ay), the
// bottom diffuse (coateddiffuse) or a conductor of the spectrum rows eta
// and k and the conductor roughness (coatedconductor); both carry the
// reflectance, transmittance and complex IOR make_bsdf gives every lane,
// and the base the dielectric eta, as the plain version does (a textured
// reflectance or transmittance in both). Each field is stored as soon as it
// is formed.
__device__ __forceinline__ void store_layer(const StepArgs& a, int i, long long mat, int kind,
                                            const S4& lam, float ax, float ay) {
  const float* row = a.mat + MAT_F * mat;
  const int slots = tex_slots(a, i);
  const S4 refl = slot_spectrum(a, i, slots, 1, row, M_REFL_C, lam);
  st4(a.top_refl, i, refl);
  st4(a.bot_refl, i, refl);
  const S4 trans = slot_spectrum(a, i, slots, 2, row, M_TRANS_C, lam);
  st4(a.top_trans, i, trans);
  st4(a.bot_trans, i, trans);
  const long long eta_spec = (long long)row[M_ETA_SPEC], k_spec = (long long)row[M_K_SPEC];
  const S4 eta_rows = table4(a.spec, eta_spec < 0 ? 0 : eta_spec, lam);
  st4(a.bot_eta_re, i, eta_rows);
  const S4 k_rows = table4(a.spec, k_spec < 0 ? 0 : k_spec, lam);
  st4(a.bot_eta_im, i, k_rows);
  if (row[M_REFL_MODE] != 0.f) {
    S4 k;
#pragma unroll
    for (int j = 0; j < 4; ++j) k.v[j] = k_from_reflectance(refl.v[j]);
    st4(a.top_eta_re, i, s4(1.f));
    st4(a.top_eta_im, i, k);
  } else {
    st4(a.top_eta_re, i, eta_rows);
    st4(a.top_eta_im, i, k_rows);
  }
  const float eta_d = eta_spec >= 0 ? eta_rows.v[0] : row[M_ETA];
  const bool remap = row[M_REMAP] != 0.f;
  a.top_kind[i] = K_DIELECTRIC;
  a.top_eta[i] = row[M_IETA];
  a.top_ax[i] = ax;
  a.top_ay[i] = ay;
  a.bot_kind[i] = kind == K_COATED_CONDUCTOR ? K_CONDUCTOR : K_DIFFUSE;
  a.bot_eta[i] = eta_d == 0.f ? 1.f : eta_d;
  a.bot_ax[i] = alpha_of(remap, row[M_CROUGH_U]);
  a.bot_ay[i] = alpha_of(remap, row[M_CROUGH_V]);
  a.thickness[i] = row[M_THICKNESS];
  a.g[i] = row[M_LAY_G];
  st4(a.albedo, i, sigmoid4(row + M_ALBEDO_C, lam));
}

__device__ __forceinline__ V3 to_local(V3 fx, V3 fy, V3 fz, V3 v) {
  return {dot(v, fx), dot(v, fy), dot(v, fz)};
}

// ------------------------------------------------------- warps (warps.py)

// Shirley-Chiu concentric disk warp
__device__ __forceinline__ void sample_disk_concentric(float u0, float u1, float& x,
                                                       float& y) {
  const float ux = 2.f * u0 - 1.f, uy = 2.f * u1 - 1.f;
  x = 0.f;
  y = 0.f;
  if (ux == 0.f && uy == 0.f) return;
  const bool cond = fabsf(ux) > fabsf(uy);
  const float r = cond ? ux : uy;
  const float theta = cond ? PI_OVER_4_F * (uy / ux) : PI_OVER_2_F - PI_OVER_4_F * (ux / uy);
  x = r * cos_angle(theta);
  y = r * sin_angle(theta);
}

__device__ __forceinline__ V3 sample_uniform_sphere(float u0, float u1) {
  const float z = 1.f - 2.f * u0;
  const float r = safe_sqrt(1.f - z * z);
  const float phi = TWO_PI_F * u1;
  return {r * cos_angle(phi), r * sin_angle(phi), z};
}

// numerically stable angle between unit vectors (vecmath.angle_between)
__device__ __forceinline__ float angle_between(V3 a, V3 b) {
  if (dot(a, b) < 0.f) return PI_F - 2.f * safe_asin(len(add(a, b)) / 2.f);
  return 2.f * safe_asin(len(sub(b, a)) / 2.f);
}

__device__ __forceinline__ float spherical_triangle_area(V3 a, V3 b, V3 c) {
  return fabsf(2.f * atan2f(dot(a, cross(b, c)), ((1.f + dot(a, b)) + dot(a, c)) + dot(b, c)));
}

// the triangle's three inner angles seen from p, and its unit corners
struct SphTri {
  V3 a, b, c, n_ab, n_bc, n_ca;
  float alpha, beta, gamma;
  bool degenerate;
};

__device__ __forceinline__ SphTri spherical_triangle(V3 v0, V3 v1, V3 v2, V3 p) {
  SphTri t;
  t.a = normalize(sub(v0, p));
  t.b = normalize(sub(v1, p));
  t.c = normalize(sub(v2, p));
  const V3 ab = cross(t.a, t.b), bc = cross(t.b, t.c), ca = cross(t.c, t.a);
  t.degenerate = dot(ab, ab) < 1e-18f || dot(bc, bc) < 1e-18f || dot(ca, ca) < 1e-18f;
  t.n_ab = normalize(ab);
  t.n_bc = normalize(bc);
  t.n_ca = normalize(ca);
  t.alpha = angle_between(t.n_ab, neg(t.n_ca));
  t.beta = angle_between(t.n_bc, neg(t.n_ab));
  t.gamma = angle_between(t.n_ca, neg(t.n_bc));
  return t;
}

// Arvo's spherical-triangle sample (warps.sample_spherical_triangle) ->
// barycentrics, the pdf 1 / solid angle (0 when degenerate)
__device__ __forceinline__ float sample_spherical_triangle(V3 v0, V3 v1, V3 v2, V3 p, float u0,
                                                          float u1, float bary[3]) {
  const SphTri t = spherical_triangle(v0, v1, v2, p);
  const float A_pi = (t.alpha + t.beta) + t.gamma;
  const float Ap_pi = (1.f - u0) * PI_F + u0 * A_pi;
  const float A = A_pi - PI_F;
  float pdf = A <= 0.f ? 0.f : 1.f / fmaxf(A, 1e-12f);
  const float cos_alpha = cos_angle(t.alpha), sin_alpha = sin_angle(t.alpha);
  const float sin_app = sin_angle(Ap_pi), cos_app = cos_angle(Ap_pi);
  const float sin_phi = sin_app * cos_alpha - cos_app * sin_alpha;
  const float cos_phi = cos_app * cos_alpha + sin_app * sin_alpha;
  const float k1 = cos_phi + cos_alpha;
  const float k2 = sin_phi - sin_alpha * dot(t.a, t.b);
  const float denom = (k2 * sin_phi + k1 * cos_phi) * sin_alpha;
  float cos_bp = (k2 + (k2 * cos_phi - k1 * sin_phi) * cos_alpha) /
                 (fabsf(denom) < 1e-20f ? 1.f : denom);
  cos_bp = clampf(cos_bp, -1.f, 1.f);
  const float sin_bp = safe_sqrt(1.f - cos_bp * cos_bp);
  const V3 cp = comb2(cos_bp, t.a, sin_bp, normalize(gram_schmidt(t.c, t.a)));
  const float cos_theta = 1.f - u1 * (1.f - dot(cp, t.b));
  const float sin_theta = safe_sqrt(1.f - cos_theta * cos_theta);
  const V3 w = comb2(cos_theta, t.b, sin_theta, normalize(gram_schmidt(cp, t.b)));
  const V3 e1 = sub(v1, v0), e2 = sub(v2, v0);
  const V3 s1 = cross(w, e2);
  const float div = dot(s1, e1);
  const float div_safe = fabsf(div) < 1e-12f ? 1.f : div;
  const V3 s = sub(p, v0);
  float b1 = clampf(dot(s, s1) / div_safe, 0.f, 1.f);
  float b2 = clampf(dot(w, cross(s, e1)) / div_safe, 0.f, 1.f);
  if (b1 + b2 > 1.f) {
    const float norm = b1 + b2;
    b1 = b1 / norm;
    b2 = b2 / norm;
  }
  if (t.degenerate || fabsf(div) < 1e-12f) {
    bary[0] = bary[1] = bary[2] = ONE_THIRD;
    return 0.f;
  }
  bary[0] = (1.f - b1) - b2;
  bary[1] = b1;
  bary[2] = b2;
  return pdf;
}

// the (u0, u1) that Arvo's sample maps to direction w
// (warps.invert_spherical_triangle_sample)
__device__ __forceinline__ void invert_spherical_triangle_sample(V3 v0, V3 v1, V3 v2, V3 p, V3 w,
                                                                 float& u0, float& u1) {
  const SphTri t = spherical_triangle(v0, v1, v2, p);
  V3 cp = cross(cross(t.b, w), cross(t.c, t.a));
  cp = normalize(dot(cp, cp) < 1e-18f ? t.a : cp);
  if (dot(cp, add(t.a, t.c)) < 0.f) cp = neg(cp);
  const V3 n_cpb = cross(cp, t.b), n_acp = cross(t.a, cp);
  const bool degen2 = dot(n_cpb, n_cpb) < 1e-18f || dot(n_acp, n_acp) < 1e-18f;
  if (t.degenerate || degen2) {
    u0 = u1 = 0.5f;
    return;
  }
  const V3 n_cpb_n = normalize(n_cpb), n_acp_n = normalize(n_acp);
  const float Ap = ((t.alpha + angle_between(t.n_ab, n_cpb_n)) +
                    angle_between(n_acp_n, neg(n_cpb_n))) - PI_F;
  const float A = ((t.alpha + t.beta) + t.gamma) - PI_F;
  u0 = dot(t.a, cp) > 0.99999847691f ? 0.f : clampf(Ap / fmaxf(A, 1e-12f), 0.f, 1.f);
  u1 = clampf((1.f - dot(w, t.b)) / fmaxf(1.f - dot(cp, t.b), 1e-12f), 0.f, 1.f);
}

// x in [0, 1] with density proportional to lerp(x, a, b)
__device__ __forceinline__ float sample_linear(float u, float a, float b) {
  const float denom = a + sqrtf(fmaxf(((1.f - u) * a) * a + (u * b) * b, 1e-24f));
  const float x = denom > 0.f ? (u * (a + b)) / fmaxf(denom, 1e-12f) : u;
  return fminf(x, 0.99999994f);
}

// corner weights (w00, w10, w01, w11)
__device__ __forceinline__ void sample_bilinear(float u0, float u1, const float w[4], float& x,
                                                float& y) {
  y = sample_linear(u1, w[0] + w[1], w[2] + w[3]);
  x = sample_linear(u0, (1.f - y) * w[0] + y * w[2], (1.f - y) * w[1] + y * w[3]);
}

__device__ __forceinline__ float bilinear_pdf(float x, float y, const float w[4]) {
  if (!(x >= 0.f && x <= 1.f && y >= 0.f && y <= 1.f)) return 0.f;
  const float s = ((w[0] + w[1]) + w[2]) + w[3];
  if (s == 0.f) return 1.f;
  const float interp = ((((1.f - x) * (1.f - y)) * w[0] + (x * (1.f - y)) * w[1]) +
                        ((1.f - x) * y) * w[2]) + (x * y) * w[3];
  return (4.f * interp) / fmaxf(s, 1e-12f);
}

// the bilinear cosine warp's weights at the receiver (lights._corner_weights)
__device__ __forceinline__ void corner_weights(V3 ns, V3 p0, V3 p1, V3 p2, V3 p, float w[4]) {
  const V3 wi0 = normalize(sub(p0, p)), wi1 = normalize(sub(p1, p)),
           wi2 = normalize(sub(p2, p));
  w[0] = w[1] = fmaxf(fabsf(dot(ns, wi1)), 0.01f);
  w[2] = fmaxf(fabsf(dot(ns, wi0)), 0.01f);
  w[3] = fmaxf(fabsf(dot(ns, wi2)), 0.01f);
}

// ------------------------------------------------------ lights (lights.py)

__device__ __forceinline__ const float* light_row(const StepArgs& a, long long li) {
  return a.lt + LT_F * li;
}

__device__ __forceinline__ S4 emission(const StepArgs& a, long long li, const S4& lam) {
  return table4(a.emission, li, lam) * light_row(a, li)[L_SCALE];
}

struct Tri {
  V3 p0, p1, p2, n;
  float area, solid_angle;
};

__device__ __forceinline__ Tri emitter_triangle(const StepArgs& a, int t, V3 p_ref) {
  Tri r;
  r.p0 = ld3(a.tri_p0, t);
  r.p1 = ld3(a.tri_p1, t);
  r.p2 = ld3(a.tri_p2, t);
  const V3 cr = cross(sub(r.p1, r.p0), sub(r.p2, r.p0));
  r.area = 0.5f * len(cr);
  r.n = divv(cr, fmaxf(2.f * r.area, 1e-12f));
  r.solid_angle = spherical_triangle_area(normalize(sub(r.p0, p_ref)),
                                          normalize(sub(r.p1, p_ref)),
                                          normalize(sub(r.p2, p_ref)));
  return r;
}

__device__ __forceinline__ bool by_area(float sa) {
  return sa < MIN_SPHERICAL_AREA || sa > MAX_SPHERICAL_AREA;
}

// a point on the emitter triangle seen from p_ref (lights.sample_area_light_li)
__device__ __forceinline__ void sample_triangle_light(const StepArgs& a, int t, V3 p_ref,
                                                      V3 ns_ref, float u0, float u1, V3& p_l,
                                                      V3& n_l, float& pdf, bool& valid) {
  const Tri tr = emitter_triangle(a, t, p_ref);
  n_l = tr.n;
  if (by_area(tr.solid_angle)) {
    // uniform-area sampling, pdf converted to solid angle
    const bool flip = u0 < u1;
    const float b0 = flip ? u0 / 2.f : u0 - u1 / 2.f;
    const float b1 = flip ? u1 - b0 : u1 / 2.f;
    const float b2 = (1.f - b0) - b1;
    p_l = comb3(b0, tr.p0, b1, tr.p1, b2, tr.p2);
    const V3 wi = sub(p_l, p_ref);
    const float dist2 = dot(wi, wi);
    const V3 wi_n = divv(wi, sqrtf(fmaxf(dist2, 1e-24f)));
    const float cos_l = fabsf(dot(tr.n, neg(wi_n)));
    pdf = ((1.f / fmaxf(tr.area, 1e-12f)) * dist2) / fmaxf(cos_l, 1e-9f);
    valid = dist2 > 0.f && cos_l > 1e-7f && isfinite(pdf);
    return;
  }
  // spherical triangle with the bilinear cosine warp at the receiver
  float w0 = u0, w1 = u1, pdf_warp = 1.f;
  if (dot(ns_ref, ns_ref) > 0.f) {
    float w[4];
    corner_weights(ns_ref, tr.p0, tr.p1, tr.p2, p_ref, w);
    sample_bilinear(u0, u1, w, w0, w1);
    pdf_warp = bilinear_pdf(w0, w1, w);
  }
  float b[3];
  const float pdf_tri = sample_spherical_triangle(tr.p0, tr.p1, tr.p2, p_ref, w0, w1, b);
  p_l = comb3(b[0], tr.p0, b[1], tr.p1, b[2], tr.p2);
  pdf = pdf_tri * pdf_warp;
  valid = pdf_tri > 0.f;
}

// 1 - cos of the cone's half angle, through sin^2 for small cones -> pdf
__device__ __forceinline__ float cone_pdf(float sin2_max, float& cos_max) {
  cos_max = sqrtf(fmaxf(1.f - sin2_max, 0.f));
  const float one_minus = sin2_max < SMALL_CONE ? sin2_max / 2.f : 1.f - cos_max;
  return 1.f / fmaxf(TWO_PI_F * one_minus, 1e-12f);
}

__device__ __forceinline__ float area_pdf(float d2, float area, float cos_l) {
  return d2 / fmaxf(area * fmaxf(cos_l, 1e-9f), 1e-12f);
}

// cone sampling from outside, area sampling from inside
// (lights.sample_sphere_light_li)
__device__ __forceinline__ void sample_sphere_light(const StepArgs& a, int sph, V3 p_ref,
                                                    float u0, float u1, V3& p_l, V3& n_l,
                                                    float& pdf, bool& valid) {
  const V3 c = ld3(a.sph_center, sph);
  const float rad = a.sph_radius[sph];
  const V3 cp = sub(c, p_ref);
  const float dist2 = dot(cp, cp);
  if (dist2 <= rad * rad) {
    n_l = sample_uniform_sphere(u0, u1);
    p_l = add(c, mul(n_l, rad));
    const V3 to = sub(p_l, p_ref);
    const V3 wi = normalize(to);
    const float cos_l = fabsf(dot(n_l, neg(wi)));
    pdf = area_pdf(dot(to, to), (FOUR_PI_F * rad) * rad, cos_l);
  } else {
    const float sin2_max = (rad * rad) / fmaxf(dist2, 1e-24f);
    float cos_max;
    pdf = cone_pdf(sin2_max, cos_max);
    float cos_t = (cos_max - 1.f) * u0 + 1.f;
    float sin2_t = 1.f - cos_t * cos_t;
    if (sin2_max < SMALL_CONE) {
      sin2_t = sin2_max * u0;
      cos_t = sqrtf(fmaxf(1.f - sin2_t, 0.f));
    }
    const float sin_max = sqrtf(fmaxf(sin2_max, 1e-24f));
    const float cos_alpha =
        sin2_t / sin_max + cos_t * sqrtf(fmaxf(1.f - sin2_t / fmaxf(sin2_max, 1e-24f), 0.f));
    const float sin_alpha = sqrtf(fmaxf(1.f - cos_alpha * cos_alpha, 0.f));
    const float phi = TWO_PI_F * u1;
    V3 fx, fy, fz;
    frame_from_z(normalize(sub(p_ref, c)), fx, fy, fz);
    const float st = clampf(sin_alpha, -1.f, 1.f);
    n_l = comb3(st * cos_angle(phi), fx, st * sin_angle(phi), fy, clampf(cos_alpha, -1.f, 1.f),
                fz);
    p_l = add(c, mul(n_l, rad));
  }
  valid = isfinite(pdf) && pdf > 0.f;
}

__device__ __forceinline__ float disk_area(const StepArgs& a, int dk) {
  const float rad = a.dsk_radius[dk], inner = a.dsk_inner[dk];
  return PI_F * (rad * rad - inner * inner);
}

// uniform-area disk sample converted to solid angle (lights.sample_disk_light_li)
__device__ __forceinline__ void sample_disk_light(const StepArgs& a, int dk, V3 p_ref, float u0,
                                                  float u1, V3& p_l, V3& n_l, float& pdf,
                                                  bool& valid) {
  const V3 c = ld3(a.dsk_center, dk);
  n_l = ld3(a.dsk_normal, dk);
  const float rad = a.dsk_radius[dk];
  float x, y;
  sample_disk_concentric(u0, u1, x, y);
  V3 fx, fy, fz;
  frame_from_z(n_l, fx, fy, fz);
  p_l = add(add(c, mul(fx, x * rad)), mul(fy, y * rad));
  const V3 to = sub(p_l, p_ref);
  const V3 wi = normalize(to);
  const float d2 = dot(to, to);
  pdf = area_pdf(d2, disk_area(a, dk), fabsf(dot(n_l, neg(wi))));
  valid = isfinite(pdf) && pdf > 0.f && d2 > 0.f;
}

struct LiSample {
  S4 L;
  V3 wi, p;
  float pdf;
  bool valid, delta;
};

// Li sample of light li seen from p_ref (lights.sample_li); the light
// index is always valid here
__device__ __forceinline__ LiSample sample_li(const StepArgs& a, long long li, V3 p_ref,
                                              V3 ns_ref, float u0, float u1, const S4& lam) {
  const float* row = light_row(a, li);
  const int type = (int)row[L_TYPE];
  const S4 em = emission(a, li, lam);
  const float two_r = a.scal[S_TWO_R];
  LiSample s;
  s.delta = type == LIGHT_DISTANT || type == LIGHT_SPOT;
  s.valid = true;
  s.pdf = 1.f;
  s.L = em;
  if (type == LIGHT_AREA) {
    // the emitter shape: a disk, else a sphere, else a triangle
    const int tri = (int)row[L_TRI], sph = (int)row[L_SPH], dk = (int)row[L_DSK];
    V3 n_l;
    if (dk >= 0) {
      sample_disk_light(a, dk, p_ref, u0, u1, s.p, n_l, s.pdf, s.valid);
    } else if (sph >= 0) {
      sample_sphere_light(a, sph, p_ref, u0, u1, s.p, n_l, s.pdf, s.valid);
    } else if (a.n_tris > 0) {
      sample_triangle_light(a, tri < 0 ? 0 : tri, p_ref, ns_ref, u0, u1, s.p, n_l, s.pdf,
                            s.valid);
    } else {
      s.p = p_ref;
      n_l = {0.f, 0.f, 1.f};
      s.pdf = 0.f;
      s.valid = false;
    }
    s.wi = normalize(sub(s.p, p_ref));
    if (!(dot(n_l, neg(s.wi)) > 0.f || row[L_TWO] != 0.f)) s.L = s4(0.f);
  } else if (type == LIGHT_DISTANT) {
    // a direction, seen from a pseudo-position two scene radii away
    s.wi = {row[L_DIR], row[L_DIR + 1], row[L_DIR + 2]};
    s.p = add(p_ref, mul(s.wi, two_r));
  } else if (type == LIGHT_SPOT) {
    // a delta position, smoothstep cone falloff
    s.p = {row[L_POS], row[L_POS + 1], row[L_POS + 2]};
    const V3 to = sub(s.p, p_ref);
    const float d2 = dot(to, to);
    s.wi = divv(to, sqrtf(fmaxf(d2, 1e-24f)));
    const float x = dot(neg(s.wi), {row[L_DIR], row[L_DIR + 1], row[L_DIR + 2]});
    const float lo = row[L_COS_END], span = row[L_COS_START] - lo;
    const float t = clampf(span != 0.f ? (x - lo) / span : 0.f, 0.f, 1.f);
    const float falloff = (t * t) * (3.f - 2.f * t);
    s.L = em * (falloff / fmaxf(d2, 1e-12f));
  } else {
    // uniform infinite: a uniform sphere direction
    s.wi = sample_uniform_sphere(u0, u1);
    s.pdf = UNIFORM_SPHERE_PDF;
    s.p = add(p_ref, mul(s.wi, two_r));
  }
  s.valid = s.valid && s.pdf > 0.f;
  return s;
}

// solid-angle pdf that sample_li draws wi towards the known point hit_p
// (normal hit_n) of area light li (lights.area_light_pdf_li)
__device__ __forceinline__ float area_light_pdf_li(const StepArgs& a, long long li, V3 p_ref,
                                                   V3 ns_ref, V3 wi, V3 hit_p, V3 hit_n) {
  const float* row = light_row(a, li);
  const int tri = (int)row[L_TRI], sph = (int)row[L_SPH], dk = (int)row[L_DSK];
  const V3 to = sub(hit_p, p_ref);
  const float d2 = dot(to, to);
  const float cos_l = fabsf(dot(hit_n, neg(wi)));
  if (tri >= 0) {
    const Tri tr = emitter_triangle(a, tri, p_ref);
    if (by_area(tr.solid_angle)) {
      const float pdf = d2 / fmaxf(tr.area * fmaxf(cos_l, 1e-9f), 1e-12f);
      return isfinite(pdf) ? pdf : 0.f;
    }
    float warp = 1.f;
    if (dot(ns_ref, ns_ref) > 0.f) {
      float u0, u1, w[4];
      invert_spherical_triangle_sample(tr.p0, tr.p1, tr.p2, p_ref, wi, u0, u1);
      corner_weights(ns_ref, tr.p0, tr.p1, tr.p2, p_ref, w);
      warp = bilinear_pdf(u0, u1, w);
    }
    return (1.f / fmaxf(tr.solid_angle, 1e-12f)) * warp;
  }
  if (dk >= 0) {
    const float pdf = area_pdf(d2, disk_area(a, dk), cos_l);
    return isfinite(pdf) ? pdf : 0.f;
  }
  if (sph >= 0) {
    const V3 c = ld3(a.sph_center, sph);
    const float rad = a.sph_radius[sph];
    const V3 cp = sub(c, p_ref);
    const float dist2 = dot(cp, cp);
    if (dist2 <= rad * rad) return area_pdf(d2, (FOUR_PI_F * rad) * rad, cos_l);
    float cos_max;
    return cone_pdf((rad * rad) / fmaxf(dist2, 1e-24f), cos_max);
  }
  return 0.f;
}

// the light index of u by the alias table (path._pick_light) -> its pmf
__device__ __forceinline__ long long pick_light(const StepArgs& a, float u, float& pmf) {
  const long long n = a.n_lights;
  const float x = u * (float)n;
  long long i = (long long)floorf(x);
  i = i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
  const float frac = x - (float)i;
  const float* row = light_row(a, i);
  if (frac < row[L_Q]) {
    pmf = row[L_ALIAS_PMF];
    return i;
  }
  const long long j = (long long)row[L_ALIAS];
  pmf = light_row(a, j)[L_ALIAS_PMF];
  return j;
}

// -------------------------------------------------- the path step (path.py)

// offset p along +-n, on the side w leaves from (geometry/ray.py)
__device__ __forceinline__ V3 offset_ray_origin(V3 p, V3 n, V3 w, float scale) {
  const float mag = fmaxf(fmaxf(fabsf(p.x), fabsf(p.y)), fabsf(p.z));
  const float eps = scale * fmaxf(mag, 1.f);
  const V3 nf = dot(n, w) < 0.f ? neg(n) : n;
  return add(p, mul(nf, eps));
}

// path_rr's lane: rr_plain -> whether the lane traces this bounce
__device__ __forceinline__ bool rr_lane(const StepArgs& a, int i) {
  const float depth = a.depth[i], rr_next = a.rr_next[i];
  bool active = a.active[i] != 0 && depth < (float)a.max_depth;
  const bool rr_due = active && depth >= rr_next;
  S4 beta = ld4(a.beta, i);
  Smp s = load_smp(a, i);
  if (rr_due) {
    const float u = get_1d(a, s, true);
    const float survive = fminf(max4(beta), RR_CLAMP);
    if (u > survive) {
      active = false;
    } else {
      beta = beta / fmaxf(survive, 1e-9f);
    }
  }
  st4(a.beta_out, i, beta);
  a.active_out[i] = active;
  a.rr_next_out[i] = rr_due ? rr_next + 1.f : rr_next;
  a.t_max_out[i] = active ? INF_T : 0.f;
  store_smp(a, i, s);
  return active;
}

// path_shade's lane: shade_plain (a coated lane up to K7's inputs). Each
// output is stored as soon as it is final (L, prev_p, prev_ns and depth
// after the emission, the wavelengths' pdf after make_bsdf), so that fewer
// values stay live through the light and BSDF samples.
__device__ __forceinline__ void shade_lane(const StepArgs& a, int i) {
  V3 o = ld3(a.o, i), d = ld3(a.d, i);
  S4 L = ld4(a.L, i), beta = ld4(a.beta, i);
  const S4 lam = ld4(a.lam, i);
  Smp s = load_smp(a, i);
  bool active = a.active[i] != 0, specular = a.specular[i] != 0;
  const float depth = a.depth[i];
  float prev_pdf = a.prev_pdf[i];
  const bool first_or_spec = depth == 0.f || specular;
  const bool hit = a.hit_valid[i] != 0;

  // escaped rays collect the uniform infinite lights (MIS)
  if (a.open_scene && active && !hit) {
    const float w = first_or_spec ? 1.f : power_heuristic(prev_pdf, a.scal[S_INF_DENSITY]);
    L = L + (beta * w) * table4(a.uinf, 0, lam);
  }
  active = active && hit;

  V3 hp = {0.f, 0.f, 0.f}, hng = hp, hns = hp;
  long long mat = -1;
  {
    V3 prev_p = ld3(a.prev_p, i), prev_ns = ld3(a.prev_ns, i);
    if (active) {
      hp = ld3(a.hit_p, i);
      hng = ld3(a.hit_ng, i);
      hns = ld3(a.hit_ns, i);
      // emissive surface hit (MIS)
      const long long light = a.hit_light[i];
      if (light >= 0) {
        const float* row = light_row(a, light);
        if (dot(hng, neg(d)) > 0.f || row[L_TWO] != 0.f) {
          const float pdf_li = area_light_pdf_li(a, light, prev_p, prev_ns, d, hp, hng);
          const float w =
              first_or_spec ? 1.f : power_heuristic(prev_pdf, row[L_PMF] * pdf_li);
          L = L + (beta * w) * emission(a, light, lam);
        }
      }
      mat = a.hit_mat[i];
      if (mat >= 0) {
        prev_p = hp;
        prev_ns = hns;
      }
    }
    st3(a.prev_p_out, i, prev_p);
    st3(a.prev_ns_out, i, prev_ns);
  }
  st4(a.L_out, i, L);
  a.depth_out[i] = mat >= 0 ? depth + 1.f : depth;

  bool nee = false, cont = false, coated = false;
  V3 sh_o = o, sh_d = {0.f, 0.f, 1.f};
  float sh_t = 0.f;
  S4 ld = s4(0.f);
  if (mat >= 0) {
    // the BSDF around the shading normal
    bool dispersive;
    const Bxdf b = make_bsdf(a, i, mat, lam, dispersive);
    coated = b.kind == K_COATED_DIFFUSE || b.kind == K_COATED_CONDUCTOR;
    S4 pdf_lam = ld4(a.lam_pdf, i);
    if (dispersive) {
      // terminate the secondary wavelengths (sampled.terminate_secondary)
      const bool already = pdf_lam.v[1] == 0.f && pdf_lam.v[2] == 0.f && pdf_lam.v[3] == 0.f;
      pdf_lam = {{already ? pdf_lam.v[0] : pdf_lam.v[0] / 4.f, 0.f, 0.f, 0.f}};
    }
    st4(a.lam_pdf_out, i, pdf_lam);
    V3 fx, fy, fz;
    frame_from_z(hns, fx, fy, fz);
    const V3 wo_l = to_local(fx, fy, fz, neg(d));
    if (coated) {
      store_layer(a, i, mat, b.kind, lam, b.ax, b.ay);
      st3(a.wo_l, i, wo_l);
    }

    // NEE, skipped for specular-only lobes (coated kinds always run it)
    const bool spec_only =
        (b.kind == K_CONDUCTOR || b.kind == K_DIELECTRIC) && effectively_smooth(b.ax, b.ay);
    nee = !spec_only && a.n_lights > 0;
    if (nee) {
      const float u_l = get_1d(a, s, true);
      float u0, u1;
      get_2d(a, s, true, u0, u1);
      float pmf;
      const long long li = pick_light(a, u_l, pmf);
      const LiSample ls = sample_li(a, li, hp, hns, u0, u1, lam);
      const V3 wi_l = to_local(fx, fy, fz, ls.wi);
      const float pdf_light = pmf * ls.pdf;
      sh_o = offset_ray_origin(hp, hng, ls.wi, a.scal[S_OFFSET]);
      sh_d = ls.wi;
      sh_t = len(sub(sh_o, ls.p)) * SHADOW_SHORTEN;
      if (coated) {
        // the light sample, for K7's f and pdf and path_coat
        st3(a.wi_l, i, wi_l);
        st4(a.light_L, i, ls.L);
        a.light_pdf[i] = pdf_light;
        a.light_ok[i] = ls.valid && pdf_light > 0.f;
        a.light_delta[i] = ls.delta;
      } else {
        const S4 f = bxdf_f(b, wo_l, wi_l) * fabsf(dot(ls.wi, hns));
        if (ls.valid && any_pos(f) && pdf_light > 0.f) {
          const float pdf_bsdf = bxdf_pdf(b, wo_l, wi_l, true, true);
          const S4 contrib = (f * ls.L) / fmaxf(pdf_light, 1e-20f);
          const float w = ls.delta ? 1.f : power_heuristic(pdf_light, pdf_bsdf);
          ld = contrib * w;
        }
      }
    }

    // BSDF sampling and the new ray (a coated lane's: path_coat, from
    // layered_sample at these draws)
    const float uc = get_1d(a, s, true);
    float u0, u1;
    get_2d(a, s, true, u0, u1);
    if (coated) {
      a.uc[i] = uc;
      a.u2[2 * i] = u0;
      a.u2[2 * i + 1] = u1;
    } else {
      const BSample bs = bxdf_sample(b, wo_l, uc, u0, u1, true, true, true);
      const V3 wi = comb3(bs.wi.x, fx, bs.wi.y, fy, bs.wi.z, fz);
      const float cos_term = fabsf(dot(wi, hns));
      const S4 beta_new = (beta * bs.f) * (cos_term / fmaxf(bs.pdf, 1e-20f));
      cont = bs.valid && any_pos(beta_new);
      if (cont) {
        o = offset_ray_origin(hp, hng, wi, a.scal[S_OFFSET]);
        d = wi;
        beta = beta_new;
        specular = (bs.flags & F_SPECULAR) != 0;
        prev_pdf = bs.pdf;
      }
    }
  } else {
    st4(a.lam_pdf_out, i, ld4(a.lam_pdf, i));
  }
  st3(a.o_out, i, o);
  st3(a.d_out, i, d);
  st4(a.beta_out, i, beta);
  store_smp(a, i, s);
  a.active_out[i] = cont;
  a.specular_out[i] = specular;
  a.prev_pdf_out[i] = prev_pdf;
  st3(a.sh_o, i, sh_o);
  st3(a.sh_d, i, sh_d);
  a.sh_t[i] = nee ? sh_t : 0.f;
  a.nee_out[i] = nee;
  st4(a.ld_out, i, ld);
  if (a.coat != nullptr) {
    a.coat[i] = coated;
    a.coat_nee[i] = coated && nee;
  }
}

// The redesign of path_shade for the H100. shade_lane above runs one
// thread a lane at 127 registers (4 blocks of 128 an SM, a quarter of its
// warps), every branch its warp's lanes take in one body. It is split at
// the NEE / BSDF-sample boundary into two kernels (SHADE_BLOCKS blocks an
// SM: path_shade 80 registers, path_bsdf 66, neither a stack frame nor
// spills):
//   light_lane (path_shade): the emission, the BSDF's wavelength
//     termination, the NEE draws, the light pick and sample, f, pdf and the
//     MIS weight, the shadow ray and the pending term; on a coated lane its
//     layer, wo and light sample. The BSDF's spectra and the frame are
//     formed after the light sample, and the hit's geometric normal and the
//     ray direction read again there, so that fewer values stay live
//     through it;
//   bsdf_lane (path_bsdf): the BSDF draws, past the NEE draws, and sample,
//     the new beta, ray, flags and MIS pdf, the sampler state; on a coated
//     lane its BSDF draws.
// Each rebuilds what it needs from the lane's input state and hit record
// (the BSDF, the frame) with shade_lane's arithmetic, so the two give
// shade_lane's bits; neither reads an output of the other or of itself, so
// they run in either order, and each again on the same inputs (graph
// replays). bsdf_lane steps its stream past the NEE draws as get_1d and
// get_2d do (their values unused). shade_lane stays as their yardstick
// (pbrt_path_shade_lane), which no render launches. Measured on the H100
// (PERF.md §6; tools/k6_designs.py): the split gains where a warp's
// lanes take different branches (2x on cornell-mesh's third bounce) and
// little on a frame's first bounce; one kernel capped at 96 or 80
// registers spills and runs slower, and lanes listed by material kind
// (a warp of one kind) run slower still.

// path_shade's lane: shade_plain's light part (path.shade_light_plain)
__device__ __forceinline__ void light_lane(const StepArgs& a, int i) {
  const V3 d = ld3(a.d, i);
  S4 L = ld4(a.L, i);
  const S4 lam = ld4(a.lam, i);
  const bool hit = a.hit_valid[i] != 0;
  bool active = a.active[i] != 0;
  const float depth = a.depth[i];

  // escaped rays collect the uniform infinite lights (MIS)
  if (a.open_scene && active && !hit) {
    const bool first_or_spec = depth == 0.f || a.specular[i] != 0;
    const float w =
        first_or_spec ? 1.f : power_heuristic(a.prev_pdf[i], a.scal[S_INF_DENSITY]);
    L = L + (ld4(a.beta, i) * w) * table4(a.uinf, 0, lam);
  }
  active = active && hit;

  V3 hp = {0.f, 0.f, 0.f}, hng = hp, hns = hp;
  long long mat = -1;
  {
    V3 prev_p = ld3(a.prev_p, i), prev_ns = ld3(a.prev_ns, i);
    if (active) {
      hp = ld3(a.hit_p, i);
      hng = ld3(a.hit_ng, i);
      hns = ld3(a.hit_ns, i);
      // emissive surface hit (MIS)
      const long long light = a.hit_light[i];
      if (light >= 0) {
        const float* row = light_row(a, light);
        if (dot(hng, neg(d)) > 0.f || row[L_TWO] != 0.f) {
          const bool first_or_spec = depth == 0.f || a.specular[i] != 0;
          const float pdf_li = area_light_pdf_li(a, light, prev_p, prev_ns, d, hp, hng);
          const float w =
              first_or_spec ? 1.f : power_heuristic(a.prev_pdf[i], row[L_PMF] * pdf_li);
          L = L + (ld4(a.beta, i) * w) * emission(a, light, lam);
        }
      }
      mat = a.hit_mat[i];
      if (mat >= 0) {
        prev_p = hp;
        prev_ns = hns;
      }
    }
    st3(a.prev_p_out, i, prev_p);
    st3(a.prev_ns_out, i, prev_ns);
  }
  st4(a.L_out, i, L);
  a.depth_out[i] = mat >= 0 ? depth + 1.f : depth;

  bool nee = false, coated = false;
  V3 sh_d = {0.f, 0.f, 1.f};
  float sh_t = 0.f;
  S4 ld = s4(0.f);
  if (mat >= 0) {
    // the BSDF's kind and roughness: its spectra are formed again where f
    // and pdf read them, after the light sample, and the frame too, so
    // that fewer values stay live through the sample
    bool dispersive;
    const Bxdf bk = make_bsdf(a, i, mat, lam, dispersive);
    coated = bk.kind == K_COATED_DIFFUSE || bk.kind == K_COATED_CONDUCTOR;
    S4 pdf_lam = ld4(a.lam_pdf, i);
    if (dispersive) {
      // terminate the secondary wavelengths (sampled.terminate_secondary)
      const bool already = pdf_lam.v[1] == 0.f && pdf_lam.v[2] == 0.f && pdf_lam.v[3] == 0.f;
      pdf_lam = {{already ? pdf_lam.v[0] : pdf_lam.v[0] / 4.f, 0.f, 0.f, 0.f}};
    }
    st4(a.lam_pdf_out, i, pdf_lam);
    // NEE, skipped for specular-only lobes (coated kinds always run it)
    const bool spec_only =
        (bk.kind == K_CONDUCTOR || bk.kind == K_DIELECTRIC) && effectively_smooth(bk.ax, bk.ay);
    nee = !spec_only && a.n_lights > 0;
    if (nee) {
      Smp s = load_smp(a, i);
      const float u_l = get_1d(a, s, true);
      float u0, u1;
      get_2d(a, s, true, u0, u1);
      float pmf;
      const long long li = pick_light(a, u_l, pmf);
      const LiSample ls = sample_li(a, li, hp, hns, u0, u1, lam);
      const float pdf_light = pmf * ls.pdf;
      // the geometric normal and the ray direction read again here, not
      // held through the sample
      const V3 sh_o = offset_ray_origin(hp, ld3(a.hit_ng, i), ls.wi, a.scal[S_OFFSET]);
      st3(a.sh_o, i, sh_o);
      sh_d = ls.wi;
      sh_t = len(sub(sh_o, ls.p)) * SHADOW_SHORTEN;
      V3 fx, fy, fz;
      frame_from_z(hns, fx, fy, fz);
      const V3 wi_l = to_local(fx, fy, fz, ls.wi);
      if (coated) {
        // the light sample, for K7's f and pdf and path_coat
        st3(a.wi_l, i, wi_l);
        st4(a.light_L, i, ls.L);
        a.light_pdf[i] = pdf_light;
        a.light_ok[i] = ls.valid && pdf_light > 0.f;
        a.light_delta[i] = ls.delta;
      } else {
        const Bxdf b = make_bsdf(a, i, mat, lam, dispersive);
        const V3 wo_l = to_local(fx, fy, fz, neg(ld3(a.d, i)));
        const S4 f = bxdf_f(b, wo_l, wi_l) * fabsf(dot(ls.wi, hns));
        if (ls.valid && any_pos(f) && pdf_light > 0.f) {
          const float pdf_bsdf = bxdf_pdf(b, wo_l, wi_l, true, true);
          const S4 contrib = (f * ls.L) / fmaxf(pdf_light, 1e-20f);
          const float w = ls.delta ? 1.f : power_heuristic(pdf_light, pdf_bsdf);
          ld = contrib * w;
        }
      }
    }
    if (coated) {
      V3 fx, fy, fz;
      frame_from_z(hns, fx, fy, fz);
      store_layer(a, i, mat, bk.kind, lam, bk.ax, bk.ay);
      st3(a.wo_l, i, to_local(fx, fy, fz, neg(ld3(a.d, i))));
    }
  } else {
    st4(a.lam_pdf_out, i, ld4(a.lam_pdf, i));
  }
  if (!nee) st3(a.sh_o, i, ld3(a.o, i));
  st3(a.sh_d, i, sh_d);
  a.sh_t[i] = sh_t;
  a.nee_out[i] = nee;
  st4(a.ld_out, i, ld);
  if (a.coat != nullptr) {
    a.coat[i] = coated;
    a.coat_nee[i] = coated && nee;
  }
}

// path_bsdf's lane: shade_plain's BSDF-sample part (path.shade_bsdf_plain)
__device__ __forceinline__ void bsdf_lane(const StepArgs& a, int i) {
  V3 o = ld3(a.o, i), d = ld3(a.d, i);
  S4 beta = ld4(a.beta, i);
  Smp s = load_smp(a, i);
  bool specular = a.specular[i] != 0, cont = false;
  float prev_pdf = a.prev_pdf[i];
  const long long mat = a.active[i] != 0 && a.hit_valid[i] != 0 ? a.hit_mat[i] : -1;
  if (mat >= 0) {
    bool dispersive;
    const Bxdf b = make_bsdf(a, i, mat, ld4(a.lam, i), dispersive);
    const bool coated = b.kind == K_COATED_DIFFUSE || b.kind == K_COATED_CONDUCTOR;
    const bool spec_only =
        (b.kind == K_CONDUCTOR || b.kind == K_DIELECTRIC) && effectively_smooth(b.ax, b.ay);
    if (!spec_only && a.n_lights > 0) {
      // the NEE draws (path_shade's): the stream stepped past them
      float u0, u1;
      get_1d(a, s, true);
      get_2d(a, s, true, u0, u1);
    }
    // BSDF sampling and the new ray (a coated lane's: path_coat, from
    // layered_sample at these draws)
    const float uc = get_1d(a, s, true);
    float u0, u1;
    get_2d(a, s, true, u0, u1);
    if (coated) {
      a.uc[i] = uc;
      a.u2[2 * i] = u0;
      a.u2[2 * i + 1] = u1;
    } else {
      const V3 hns = ld3(a.hit_ns, i);
      V3 fx, fy, fz;
      frame_from_z(hns, fx, fy, fz);
      const BSample bs = bxdf_sample(b, to_local(fx, fy, fz, neg(d)), uc, u0, u1, true, true, true);
      const V3 wi = comb3(bs.wi.x, fx, bs.wi.y, fy, bs.wi.z, fz);
      const float cos_term = fabsf(dot(wi, hns));
      const S4 beta_new = (beta * bs.f) * (cos_term / fmaxf(bs.pdf, 1e-20f));
      cont = bs.valid && any_pos(beta_new);
      if (cont) {
        o = offset_ray_origin(ld3(a.hit_p, i), ld3(a.hit_ng, i), wi, a.scal[S_OFFSET]);
        d = wi;
        beta = beta_new;
        specular = (bs.flags & F_SPECULAR) != 0;
        prev_pdf = bs.pdf;
      }
    }
  }
  st3(a.o_out, i, o);
  st3(a.d_out, i, d);
  st4(a.beta_out, i, beta);
  store_smp(a, i, s);
  a.active_out[i] = cont;
  a.specular_out[i] = specular;
  a.prev_pdf_out[i] = prev_pdf;
}

// path_coat's lane: coat_plain. A coated lane finished from K7's answers,
// path_shade's outputs updated in place: the NEE term (f |cos| from
// layered_f, the power heuristic against layered_pdf), and where the
// layered sample goes on, the new beta, ray, flags and the local direction
// at which the MIS pdf is evaluated (the world direction taken back to the
// frame, as the plain version does). Every lane writes its mis_mask.
__device__ __forceinline__ void coat_lane(const StepArgs& a, int i) {
  bool mis = false;
  if (a.coat[i] != 0) {
    const V3 hns = ld3(a.hit_ns, i);
    V3 fx, fy, fz;
    frame_from_z(hns, fx, fy, fz);
    const S4 beta = ld4(a.beta, i);
    if (a.coat_nee[i] != 0) {
      const S4 f = ld4(a.lay_f, i) * fabsf(dot(ld3(a.sh_d, i), hns));
      const float pdf_light = a.light_pdf[i];
      S4 ld = s4(0.f);
      if (a.light_ok[i] != 0 && any_pos(f)) {
        const S4 contrib = (f * ld4(a.light_L, i)) / fmaxf(pdf_light, 1e-20f);
        const float w = a.light_delta[i] != 0 ? 1.f : power_heuristic(pdf_light, a.lay_pdf[i]);
        ld = contrib * w;
      }
      st4(a.ld_out, i, ld);
    }
    const V3 wl = ld3(a.s_wi, i);
    const V3 wi = comb3(wl.x, fx, wl.y, fy, wl.z, fz);
    const float cos_term = fabsf(dot(wi, hns));
    const S4 beta_new = (beta * ld4(a.s_f, i)) * (cos_term / fmaxf(a.s_pdf[i], 1e-20f));
    if (a.s_valid[i] != 0 && any_pos(beta_new)) {
      st3(a.o_out, i, offset_ray_origin(ld3(a.hit_p, i), ld3(a.hit_ng, i), wi, a.scal[S_OFFSET]));
      st3(a.d_out, i, wi);
      st4(a.beta_out, i, beta_new);
      a.active_out[i] = 1;
      a.specular_out[i] = (a.s_flags[i] & F_SPECULAR) != 0;
      st3(a.mis_wi, i, to_local(fx, fy, fz, wi));
      mis = true;
    }
  }
  a.mis_mask[i] = mis;
}

// path_resolve's lane: resolve_plain -> whether the lane traced a shadow
// ray (no pending term: none; no coated lanes: prev_pdf not written)
__device__ __forceinline__ bool resolve_lane(const StepArgs& a, int i) {
  S4 L = ld4(a.L, i);
  const bool nee = a.nee != nullptr && a.nee[i] != 0;
  if (nee) L = L + ld4(a.beta, i) * (a.occluded[i] != 0 ? s4(0.f) : ld4(a.ld, i));
  st4(a.L_out, i, L);
  if (a.mis_mask != nullptr) a.prev_pdf_out[i] = a.mis_mask[i] != 0 ? a.mis_pdf[i] : a.prev_pdf[i];
  return nee;
}


// ------------------------------------------------- the VOLUMETRIC variants

__device__ __forceinline__ float mean4(const S4& x) {
  return (((x.v[0] + x.v[1]) + x.v[2]) + x.v[3]) / 4.f;
}

// a volumetric bounce's distance sample (path._medium_event): on a lane in a
// medium, the exponential draw against the average sigma_t, the scatter
// decision against the hit's t, beta *= sigma_s / sigma_t at a scatter,
// the transmittance pdf times the segment's transmittance otherwise
struct Event {
  bool scatter;
  V3 p;
};

__device__ __forceinline__ Event medium_event(const StepArgs& a, const VolArgs& v, int i,
                                              Smp& s, bool active, bool hit, long long medium,
                                              const S4& lam, S4& beta, S4& trans_pdf) {
  Event ev;
  ev.scatter = false;
  ev.p = ld3(a.o, i);
  if (v.n_media == 0 || !active || medium < 0) return ev;
  const S4 sig_s = table4(v.sigma_s, medium, lam);
  const S4 sig_t = table4(v.sigma_a, medium, lam) + sig_s;
  const float u = get_1d(a, s, true);
  const float t_samp = -log1pf(-clampf(u, 0.f, U_DIST_MAX)) / fmaxf(mean4(sig_t), 1e-12f);
  const float t_hit = hit ? v.hit_t[i] : INF_T;
  ev.scatter = t_samp < t_hit;
  if (ev.scatter) {
#pragma unroll
    for (int k = 0; k < 4; ++k) beta.v[k] = (beta.v[k] * sig_s.v[k]) / fmaxf(sig_t.v[k], 1e-12f);
    ev.p = add(ev.p, mul(ld3(a.d, i), t_samp));
  } else {
    const float seg = fminf(t_hit, 1e20f);
#pragma unroll
    for (int k = 0; k < 4; ++k) trans_pdf.v[k] = trans_pdf.v[k] * expf(-sig_t.v[k] * seg);
  }
  return ev;
}

// the medium beyond a hit going on along w (path.medium_after), on a hit
__device__ __forceinline__ long long medium_after(const VolArgs& v, int i, V3 ng, V3 w,
                                                  long long current) {
  const long long m_in = v.hit_med_in[i], m_out = v.hit_med_out[i];
  if (m_in == m_out) return current;
  return dot(w, ng) > 0.f ? m_out : m_in;
}

// path_shade_vol's lane: shade_light_vol_plain
__device__ __forceinline__ void light_vol_lane(const StepArgs& a, const VolArgs& v, int i) {
  const V3 d = ld3(a.d, i);
  S4 L = ld4(a.L, i), beta = ld4(a.beta, i);
  const S4 lam = ld4(a.lam, i);
  const bool hit = a.hit_valid[i] != 0;
  bool active = a.active[i] != 0;
  const float depth = a.depth[i];
  const long long medium = v.medium[i];
  Smp s = load_smp(a, i);
  S4 trans_pdf = ld4(v.trans_pdf, i);
  const Event ev = medium_event(a, v, i, s, active, hit, medium, lam, beta, trans_pdf);
  const bool ms = ev.scatter;
  const bool first_or_spec = depth == 0.f || a.specular[i] != 0;
  const float dir_pdf_prev = a.prev_pdf[i] * mean4(trans_pdf);

  // escaped rays collect the uniform infinite lights (MIS)
  if (a.open_scene && active && !hit && !ms) {
    const float w = first_or_spec ? 1.f : power_heuristic(dir_pdf_prev, a.scal[S_INF_DENSITY]);
    L = L + (beta * w) * table4(a.uinf, 0, lam);
  }
  active = active && (hit || ms);
  V3 hp = {0.f, 0.f, 0.f}, hng = hp, hns = hp;
  long long mat = -1;
  bool iface = false;
  {
    V3 prev_p = ld3(a.prev_p, i), prev_ns = ld3(a.prev_ns, i);
    if (active && !ms) {
      hp = ld3(a.hit_p, i);
      hng = ld3(a.hit_ng, i);
      hns = ld3(a.hit_ns, i);
      // emissive surface hit (MIS)
      const long long light = a.hit_light[i];
      if (light >= 0) {
        const float* row = light_row(a, light);
        if (dot(hng, neg(d)) > 0.f || row[L_TWO] != 0.f) {
          const float pdf_li =
              area_light_pdf_li(a, light, prev_p, prev_ns, d, hp, hng);
          const float w =
              first_or_spec ? 1.f : power_heuristic(dir_pdf_prev, row[L_PMF] * pdf_li);
          L = L + (beta * w) * emission(a, light, lam);
        }
      }
      mat = a.hit_mat[i];
      iface = mat < 0;
      if (mat >= 0) {
        prev_p = hp;
        prev_ns = hns;
      }
    } else if (ms) {
      prev_p = ev.p;
      prev_ns = {0.f, 0.f, 0.f};
    }
    st3(a.prev_p_out, i, prev_p);
    st3(a.prev_ns_out, i, prev_ns);
  }
  st4(a.L_out, i, L);
  a.depth_out[i] = depth + (mat >= 0 || ms ? 1.f : (iface ? INTERFACE_COST : 0.f));

  bool nee = false;
  Bxdf b;
  if (mat >= 0) {
    bool dispersive;
    b = make_bsdf(a, i, mat, lam, dispersive);
    S4 pdf_lam = ld4(a.lam_pdf, i);
    if (dispersive) {
      const bool already = pdf_lam.v[1] == 0.f && pdf_lam.v[2] == 0.f && pdf_lam.v[3] == 0.f;
      pdf_lam = {{already ? pdf_lam.v[0] : pdf_lam.v[0] / 4.f, 0.f, 0.f, 0.f}};
    }
    st4(a.lam_pdf_out, i, pdf_lam);
    const bool spec_only =
        (b.kind == K_CONDUCTOR || b.kind == K_DIELECTRIC) && effectively_smooth(b.ax, b.ay);
    nee = !spec_only && a.n_lights > 0;
  } else {
    st4(a.lam_pdf_out, i, ld4(a.lam_pdf, i));
  }
  const bool nee_any = nee || ms;
  V3 sh_o = ld3(a.o, i), sh_d = {0.f, 0.f, 1.f}, sh_p = sh_o;
  float sh_t = 0.f, pdf_light = 0.f, pdf_bsdf = 0.f;
  long long sh_med = medium;
  S4 ld = s4(0.f);
  float u_l = 0.f, u0 = 0.f, u1 = 0.f, ph0 = 0.f, ph1 = 0.f;
  if (nee_any) {
    // the NEE draws, taken in a scene without lights too (a scatter point's
    // lane), as the plain part's masked draws are
    u_l = get_1d(a, s, true);
    get_2d(a, s, true, u0, u1);
    if (v.n_media > 0 && ms) get_2d(a, s, true, ph0, ph1);
  }
  if (nee_any && a.n_lights > 0) {
    const V3 p = ms ? ev.p : hp, ns = ms ? V3{0.f, 0.f, 0.f} : hns;
    float pmf;
    const long long li = pick_light(a, u_l, pmf);
    const LiSample ls = sample_li(a, li, p, ns, u0, u1, lam);
    pdf_light = pmf * ls.pdf;
    S4 f;
    if (ms) {
      // a fresh HG sample's pdf, not HG at the light's direction (JAX
      // path.py:147-153)
      V3 wi_ph;
      const float pdf_ph = sample_henyey_greenstein(neg(d), v.med_g[medium], ph0, ph1, wi_ph);
      f = s4(pdf_ph);
      pdf_bsdf = pdf_ph;
    } else {
      V3 fx, fy, fz;
      frame_from_z(hns, fx, fy, fz);
      const V3 wo_l = to_local(fx, fy, fz, neg(d)), wi_l = to_local(fx, fy, fz, ls.wi);
      f = bxdf_f(b, wo_l, wi_l) * fabsf(dot(ls.wi, ns));
      pdf_bsdf = bxdf_pdf(b, wo_l, wi_l, true, true);
      sh_med = medium_after(v, i, hng, ls.wi, medium);
    }
    const bool ok = ls.valid && any_pos(f) && pdf_light > 0.f;
    if (ok) ld = f * ls.L;
    if (!ok) pdf_light = 0.f;
    if (ls.delta) pdf_bsdf = -1.f;
    sh_o = offset_ray_origin(p, ms ? V3{0.f, 0.f, 0.f} : hng, ls.wi, a.scal[S_OFFSET]);
    sh_d = ls.wi;
    sh_p = ls.p;
    sh_t = len(sub(sh_o, ls.p)) * SHADOW_SHORTEN;
  }
  st3(a.sh_o, i, sh_o);
  st3(a.sh_d, i, sh_d);
  a.sh_t[i] = sh_t;
  st3(v.sh_p, i, sh_p);
  v.sh_med[i] = sh_med;
  a.nee_out[i] = nee_any;
  st4(a.ld_out, i, ld);
  st4(v.nee_beta, i, beta);
  v.nee_mis[2 * i] = pdf_light;
  v.nee_mis[2 * i + 1] = pdf_bsdf;
}

// path_bsdf_vol's lane: shade_bsdf_vol_plain
__device__ __forceinline__ void bsdf_vol_lane(const StepArgs& a, const VolArgs& v, int i) {
  V3 o = ld3(a.o, i), d = ld3(a.d, i);
  S4 beta = ld4(a.beta, i);
  const S4 lam = ld4(a.lam, i);
  Smp s = load_smp(a, i);
  const bool active = a.active[i] != 0, hit = a.hit_valid[i] != 0;
  bool specular = a.specular[i] != 0, cont = false;
  float prev_pdf = a.prev_pdf[i];
  long long medium = v.medium[i];
  S4 trans_pdf = ld4(v.trans_pdf, i);
  const Event ev = medium_event(a, v, i, s, active, hit, medium, lam, beta, trans_pdf);
  const bool ms = ev.scatter;
  const long long mat = active && hit && !ms ? a.hit_mat[i] : -1;
  const bool iface = active && hit && !ms && mat < 0;
  bool nee_any = ms;
  Bxdf b;
  if (mat >= 0) {
    bool dispersive;
    b = make_bsdf(a, i, mat, lam, dispersive);
    const bool spec_only =
        (b.kind == K_CONDUCTOR || b.kind == K_DIELECTRIC) && effectively_smooth(b.ax, b.ay);
    nee_any = !spec_only && a.n_lights > 0;
  }
  if (nee_any) {
    // the NEE draws (path_shade_vol's): the stream stepped past them
    float u0, u1;
    get_1d(a, s, true);
    get_2d(a, s, true, u0, u1);
  }
  if (ms) {
    // the phase draw of NEE, stepped past; the HG continuation
    float u0, u1;
    get_2d(a, s, true, u0, u1);
    get_2d(a, s, true, u0, u1);
    V3 wi;
    prev_pdf = sample_henyey_greenstein(neg(d), v.med_g[medium], u0, u1, wi);
    o = ev.p;
    d = wi;
    specular = false;
  } else if (iface) {
    // straight on through a material-less interface, into the medium beyond
    const V3 hng = ld3(a.hit_ng, i);
    o = offset_ray_origin(ld3(a.hit_p, i), hng, d, a.scal[S_OFFSET]);
    medium = medium_after(v, i, hng, d, medium);
  } else if (mat >= 0) {
    const float uc = get_1d(a, s, true);
    float u0, u1;
    get_2d(a, s, true, u0, u1);
    const V3 hns = ld3(a.hit_ns, i);
    V3 fx, fy, fz;
    frame_from_z(hns, fx, fy, fz);
    const BSample bs = bxdf_sample(b, to_local(fx, fy, fz, neg(d)), uc, u0, u1, true, true, true);
    const V3 wi = comb3(bs.wi.x, fx, bs.wi.y, fy, bs.wi.z, fz);
    const float cos_term = fabsf(dot(wi, hns));
    const S4 beta_new = (beta * bs.f) * (cos_term / fmaxf(bs.pdf, 1e-20f));
    cont = bs.valid && any_pos(beta_new);
    if (cont) {
      const V3 hng = ld3(a.hit_ng, i);
      o = offset_ray_origin(ld3(a.hit_p, i), hng, wi, a.scal[S_OFFSET]);
      d = wi;
      beta = beta_new;
      specular = (bs.flags & F_SPECULAR) != 0;
      prev_pdf = bs.pdf;
      medium = medium_after(v, i, hng, wi, medium);
    }
  }
  if (cont || ms) trans_pdf = s4(1.f);
  st3(a.o_out, i, o);
  st3(a.d_out, i, d);
  st4(a.beta_out, i, beta);
  store_smp(a, i, s);
  a.active_out[i] = cont || ms || iface;
  a.specular_out[i] = specular;
  a.prev_pdf_out[i] = prev_pdf;
  v.medium_out[i] = medium;
  st4(v.trans_pdf_out, i, trans_pdf);
}

// path_resolve_vol's lane: resolve_vol_plain -> whether the lane traced a
// shadow segment
__device__ __forceinline__ bool resolve_vol_lane(const StepArgs& a, const VolArgs& v, int i) {
  S4 L = ld4(a.L, i);
  const bool nee = a.nee[i] != 0;
  if (nee) {
    const S4 tr = ld4(v.trans, i);
    const float pdf_light = v.nee_mis[2 * i], pdf_bsdf = v.nee_mis[2 * i + 1];
    const S4 contrib = (ld4(a.ld, i) * tr) / fmaxf(pdf_light, 1e-20f);
    const float w = pdf_bsdf < 0.f ? 1.f : power_heuristic(pdf_light, pdf_bsdf * mean4(tr));
    const bool ok = pdf_light > 0.f && any_pos(tr);
    L = L + ld4(v.nee_beta, i) * (ok ? contrib * w : s4(0.f));
  }
  st4(a.L_out, i, L);
  return nee;
}

// *count_out = *count_in + the lanes of the launch that pass `flag`. Every
// thread of every block calls it once.
__device__ __forceinline__ void count_lanes(const StepArgs& a, bool flag) {
  __shared__ unsigned int block_n;
  if (threadIdx.x == 0) block_n = 0;
  __syncthreads();
  const unsigned int b = __ballot_sync(0xffffffffu, flag);
  if ((threadIdx.x & 31) == 0 && b != 0) atomicAdd(&block_n, (unsigned int)__popc(b));
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long* sum = a.scratch;
    unsigned long long* ticket = a.scratch + 1;
    if (block_n != 0) atomicAdd(sum, (unsigned long long)block_n);
    __threadfence();
    if (atomicAdd(ticket, 1ULL) == gridDim.x - 1) {
      const unsigned long long total = atomicAdd(sum, 0ULL);
      *a.count_out = *a.count_in + (long long)total;
      atomicExch(sum, 0ULL);
      atomicExch(ticket, 0ULL);
    }
  }
}

__global__ void __launch_bounds__(THREADS) path_rr_kernel(const StepArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool traced = i < a.n && rr_lane(a, i);
  count_lanes(a, traced);
}

__global__ void __launch_bounds__(THREADS, SHADE_BLOCKS) path_shade_kernel(const StepArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) light_lane(a, i);
}

__global__ void __launch_bounds__(THREADS, SHADE_BLOCKS) path_bsdf_kernel(const StepArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) bsdf_lane(a, i);
}

// the yardstick: path_shade as first written, one kernel
__global__ void __launch_bounds__(THREADS) path_shade_lane_kernel(const StepArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) shade_lane(a, i);
}

__global__ void __launch_bounds__(THREADS) path_coat_kernel(const StepArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) coat_lane(a, i);
}

__global__ void __launch_bounds__(THREADS) path_resolve_kernel(const StepArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool shadow = i < a.n && resolve_lane(a, i);
  count_lanes(a, shadow);
}

__global__ void __launch_bounds__(THREADS, SHADE_VOL_BLOCKS)
    path_shade_vol_kernel(const StepArgs a, const VolArgs v) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) light_vol_lane(a, v, i);
}

__global__ void __launch_bounds__(THREADS, SHADE_BLOCKS)
    path_bsdf_vol_kernel(const StepArgs a, const VolArgs v) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) bsdf_vol_lane(a, v, i);
}

__global__ void __launch_bounds__(THREADS) path_resolve_vol_kernel(const StepArgs a,
                                                                   const VolArgs v) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool shadow = i < a.n && resolve_vol_lane(a, v, i);
  count_lanes(a, shadow);
}

int blocks(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int pbrt_path_args_bytes() { return (int)sizeof(StepArgs); }

extern "C" int pbrt_path_rr(const StepArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  path_rr_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_path_shade(const StepArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  path_shade_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_path_bsdf(const StepArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  path_bsdf_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_path_shade_lane(const StepArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  path_shade_lane_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_path_coat(const StepArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  path_coat_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_path_resolve(const StepArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  path_resolve_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_path_vol_args_bytes() { return (int)sizeof(VolArgs); }

extern "C" int pbrt_path_shade_vol(const StepArgs* a, const VolArgs* v, void* stream) {
  if (a->n <= 0) return 0;
  path_shade_vol_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a, *v);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_path_bsdf_vol(const StepArgs* a, const VolArgs* v, void* stream) {
  if (a->n <= 0) return 0;
  path_bsdf_vol_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a, *v);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_path_resolve_vol(const StepArgs* a, const VolArgs* v, void* stream) {
  if (a->n <= 0) return 0;
  path_resolve_vol_kernel<<<blocks(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a, *v);
  return (int)cudaGetLastError();
}
