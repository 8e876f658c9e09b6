// K13: a bounce's texture evaluation for Hopper (sm_90a), one launch a
// bounce on a textured scene, before the shading kernels.
//
// Replaces the TPU hot paths pbrt_tpu/materials/materials.py:30
// `resolve_mix` and the texture slots of :50 `make_bsdf` (:79-92), which
// evaluate pbrt_tpu/textures/textures.py:370 `eval_spectrum` and :415
// `eval_float` (over :258 `image_bilerp`, :248 `_wrap_coord` and :287
// `_mapped_uv`) per lane inside the JAX package's path vertex. Plain
// version: pbrt_tpu_torch/textures/textures.py `eval_lanes_plain`.
//
// For each lane: its material, a mix resolved to one of its two materials
// by the Murmur64A hash of the bits of the hit point and wo (u, 2^-32 of
// the hash's low word, against the mix's amount); every lane writes it.
// Then on the lanes asked for (those that shade), each of the chosen
// material's four slots (reflectance, transmittance, u and v roughness)
// whose node is >= 0: the two-level walk of the node table (constant,
// imagemap, scale, mix, checkerboard, directionmix), each leaf's (s, t) by
// its mapping (uv; spherical and cylindrical by acosf and atan2f; planar),
// an image leaf's bilinear fetch over the atlas under its wrap mode (with
// footprints, the average of four fetches over the footprint), its rgb to
// sigmoid coefficients through the rgb2spec table, the sigmoid polynomial
// at the lane's four wavelengths, and make_bsdf's clamps. It writes the
// slot values and a mask of the slots it wrote (bits 1 reflectance, 2
// transmittance, 4 u roughness, 8 v roughness), which path_shade,
// path_bsdf and their VOLUMETRIC variants read in place of the material's
// constants. Lanes not asked for write their material and a mask of 0.
//
// One thread a lane, the plain version's arithmetic in its order (3-term
// dot products (x + y) + z, --fmad=false); only the branches a node's type
// and mapping take are evaluated. Node rows, texels and the rgb2spec table
// are read through __ldg. What bounds it on the H100: bytes, the lane's
// hit (p, wo, uv, ns, wavelengths, material, ~68 bytes in) and outputs (45
// bytes), and 12 bytes a texel tap (4 a bilinear fetch, 16 with
// footprints), by the count of chip_smoke.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bxdf.cuh"

using namespace pbrt_bxdf;

// mirrored by pbrt_tpu_torch/textures/textures.py `_TexArgs`: every field 8
// bytes. (R,) and (R, k) lane arrays contiguous, (R, 4) rows 16-byte
// aligned.
struct TexArgs {
  // the lanes in: those to evaluate, the hit's material, point, wo, uv,
  // shading normal, wavelengths, and the footprints (R, 4) or null
  const uint8_t* lanes;
  const long long* mat;
  const float *p, *wo, *uv, *ns, *lam, *duv;
  // out
  long long* mat_out;
  float *refl, *trans, *urough, *vrough;
  uint8_t* mask;
  // tables (textures.py tex_tables): node rows (NT, NODE_F), material rows
  // (M, MATT_F), image rows (NI, 4) int64, the atlas (TOTAL, 3), the
  // rgb2spec z nodes (64,) and coefficients (3, 64, 64, 64, 3)
  const float *node, *mat_rows;
  const long long* image;
  const float *texels, *z_nodes, *coeffs;
  long long n, n_mat, n_node;
};

namespace {

constexpr int THREADS = 128;
constexpr int NODE_F = 40, MATT_F = 8;
// node row columns
constexpr int N_TYPE = 0, N_IMG = 1, N_IMG_SCALE = 2, N_INVERT = 3, N_CHILD = 4, N_AMOUNT = 6,
              N_AMOUNT_TEX = 7, N_UVMAP = 8, N_MAPKIND = 12, N_COEFFS = 13, N_CSCALE = 16,
              N_XF = 17, N_DIR = 29, N_V1 = 32, N_V2 = 35;
constexpr int TEX_CONST = 0, TEX_IMAGE = 1, TEX_SCALE = 2, TEX_MIX = 3, TEX_CHECKER = 4,
              TEX_DIRMIX = 5;
constexpr int WRAP_REPEAT = 0, WRAP_BLACK = 2;
constexpr int MAP_UV = 0, MAP_SPHERICAL = 1, MAP_CYLINDRICAL = 2, MAP_PLANAR = 3;
constexpr int MAT_MIX = 6;
constexpr int RES = 64;
// Python constants as torch rounds them to float32
constexpr float PI32 = (float)3.141592653589793, TWO_PI32 = (float)(2.0 * 3.141592653589793);
constexpr float TWO_M32 = 2.3283064365386963e-10f;  // 2^-32

struct V2 {
  float x, y;
};

__device__ __forceinline__ V3 ld3(const float* p, long long i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ float nd(const TexArgs& a, int node, int col) {
  return __ldg(a.node + (long long)node * NODE_F + col);
}
__device__ __forceinline__ V3 nd3(const TexArgs& a, int node, int col) {
  return {nd(a, node, col), nd(a, node, col + 1), nd(a, node, col + 2)};
}

// MurmurHash64A of the 24 bytes of p and wo (sampling/rng.py
// murmur64a_u32_words), seed 0
__device__ __forceinline__ uint64_t murmur6(const uint32_t w[6]) {
  const uint64_t m = 0xC6A4A7935BD1E995ULL;
  uint64_t h = 24ULL * m;
#pragma unroll
  for (int i = 0; i < 6; i += 2) {
    uint64_t k = ((uint64_t)w[i + 1] << 32) | w[i];
    k *= m;
    k ^= k >> 47;
    k *= m;
    h = (h ^ k) * m;
  }
  h ^= h >> 47;
  h *= m;
  return h ^ (h >> 47);
}

// the lane's hit context
struct Ctx {
  V2 uv;
  V3 p, ns;
  S4 lam;
  float duv[4];
  bool footprints;
};

// row r of the node's tex_from_render applied to p: ((m0 p0 + m1 p1) + m2 p2) + m3
__device__ __forceinline__ float xf_row(const TexArgs& a, int node, int r, V3 p) {
  const int col = N_XF + 4 * r;
  return ((nd(a, node, col) * p.x + nd(a, node, col + 1) * p.y) + nd(a, node, col + 2) * p.z) +
         nd(a, node, col + 3);
}

// (s, t) of `node`'s mapping (textures.py _mapped_uv)
__device__ __forceinline__ V2 mapped_uv(const TexArgs& a, int node, const Ctx& c) {
  const float su = nd(a, node, N_UVMAP), sv = nd(a, node, N_UVMAP + 1),
              du = nd(a, node, N_UVMAP + 2), dv = nd(a, node, N_UVMAP + 3);
  const int mk = (int)nd(a, node, N_MAPKIND);
  if (mk == MAP_UV) return {c.uv.x * su + du, c.uv.y * sv + dv};
  const V3 pt = {xf_row(a, node, 0, c.p), xf_row(a, node, 1, c.p), xf_row(a, node, 2, c.p)};
  if (mk == MAP_PLANAR) {
    return {dot(pt, nd3(a, node, N_V1)) + du, dot(pt, nd3(a, node, N_V2)) + dv};
  }
  float phi = atan2f(pt.y, pt.x);
  if (phi < 0.f) phi = phi + TWO_PI32;
  if (mk == MAP_CYLINDRICAL) return {phi / TWO_PI32, pt.z};
  const float r_len = sqrtf(fmaxf(dot(pt, pt), 1e-20f));
  const float theta = acosf(clampf(pt.z / r_len, -1.f, 1.f));
  return {theta / PI32, phi / TWO_PI32};
}

// an integer texel coordinate under the wrap mode (textures.py _wrap_coord)
__device__ __forceinline__ long long wrap_coord(long long c, long long n, int wrap, bool& black) {
  black = black || (wrap == WRAP_BLACK && (c < 0 || c >= n));
  if (wrap == WRAP_REPEAT) {
    const long long nn = n > 1 ? n : 1;
    const long long r = c % nn;
    return r < 0 ? r + nn : r;
  }
  return c < 0 ? 0 : (c > n - 1 ? n - 1 : c);
}

// the texel at (cx, cy) under the wrap mode (0 outside a black image), times wt
__device__ __forceinline__ V3 tap(const TexArgs& a, long long cx, long long cy, long long off,
                                  long long w, long long h, int wrap, float wt) {
  bool black = false;
  const long long px = wrap_coord(cx, w, wrap, black);
  const long long py = wrap_coord(cy, h, wrap, black);
  V3 v = {0.f, 0.f, 0.f};
  if (!black) {
    const float* t = a.texels + 3 * (off + py * w + px);
    v = {__ldg(t), __ldg(t + 1), __ldg(t + 2)};
  }
  return {wt * v.x, wt * v.y, wt * v.z};
}

// image `img` at (s, t), bilinear (textures.py image_bilerp)
__device__ __forceinline__ V3 bilerp(const TexArgs& a, int img, V2 st) {
  const long long* row = a.image + 4 * (long long)(img < 0 ? 0 : img);
  const long long off = __ldg(row), w = __ldg(row + 1), h = __ldg(row + 2);
  const int wrap = (int)__ldg(row + 3);
  const float x = st.x * (float)w - 0.5f, y = st.y * (float)h - 0.5f;
  const float xf = floorf(x), yf = floorf(y);
  const long long xi = (long long)xf, yi = (long long)yf;
  const float dx = x - xf, dy = y - yf;
  // the four taps' weighted texels, summed in the plain version's order
  const V3 v00 = tap(a, xi, yi, off, w, h, wrap, (1.f - dx) * (1.f - dy));
  const V3 v10 = tap(a, xi + 1, yi, off, w, h, wrap, dx * (1.f - dy));
  const V3 v01 = tap(a, xi, yi + 1, off, w, h, wrap, (1.f - dx) * dy);
  const V3 v11 = tap(a, xi + 1, yi + 1, off, w, h, wrap, dx * dy);
  return {((v00.x + v10.x) + v01.x) + v11.x, ((v00.y + v10.y) + v01.y) + v11.y,
          ((v00.z + v10.z) + v01.z) + v11.z};
}

// an image leaf's rgb at (s, t): scaled, inverted, clamped at 0
__device__ __forceinline__ V3 img_at(const TexArgs& a, int node, V2 st) {
  const float sc = nd(a, node, N_IMG_SCALE);
  V3 v = bilerp(a, (int)nd(a, node, N_IMG), st);
  v = {sc * v.x, sc * v.y, sc * v.z};
  if (nd(a, node, N_INVERT) != 0.f) v = {1.f - v.x, 1.f - v.y, 1.f - v.z};
  return {fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f)};
}

// an image leaf's rgb (textures.py _leaf_rgb_or_value): v flipped; with
// footprints the average of four fetches over the uv-mapped footprint
__device__ __forceinline__ V3 leaf_rgb(const TexArgs& a, int node, const Ctx& c, bool fp) {
  V2 st = mapped_uv(a, node, c);
  st.y = 1.f - st.y;
  if (!fp) return img_at(a, node, st);
  const float su = nd(a, node, N_UVMAP), sv = nd(a, node, N_UVMAP + 1);
  const float is_uv = (int)nd(a, node, N_MAPKIND) == MAP_UV ? 1.f : 0.f;
  const V2 gx = {(c.duv[0] * su) * is_uv, (c.duv[1] * sv) * is_uv};
  const V2 gy = {(c.duv[2] * su) * is_uv, (c.duv[3] * sv) * is_uv};
  const V2 qx = {0.25f * gx.x, 0.25f * gx.y}, qy = {0.25f * gy.x, 0.25f * gy.y};
  const V2 sp = {st.x + qx.x, st.y + qx.y}, sm = {st.x - qx.x, st.y - qx.y};
  const V3 t0 = img_at(a, node, {sp.x + qy.x, sp.y + qy.y});
  const V3 t1 = img_at(a, node, {sp.x - qy.x, sp.y - qy.y});
  const V3 t2 = img_at(a, node, {sm.x + qy.x, sm.y + qy.y});
  const V3 t3 = img_at(a, node, {sm.x - qy.x, sm.y - qy.y});
  return {0.25f * (((t0.x + t1.x) + t2.x) + t3.x), 0.25f * (((t0.y + t1.y) + t2.y) + t3.y),
          0.25f * (((t0.z + t1.z) + t2.z) + t3.z)};
}

__device__ __forceinline__ float lerp(float t, float x, float y) {
  return (1.f - t) * x + t * y;
}

// rgb in [0, 1] -> sigmoid coefficients (spectral/rgb2spec.py
// rgb_to_coefficients: the table's trilinear lookup)
__device__ __forceinline__ V3 rgb_to_coefficients(const TexArgs& a, V3 rgb) {
  const float r = rgb.x, g = rgb.y, b = rgb.z;
  if (r == g && g == b) {
    float c2;
    if (r <= 0.f) {
      c2 = -1e30f;
    } else if (r >= 1.f) {
      c2 = 1e30f;
    } else {
      c2 = (r - 0.5f) / sqrtf(fmaxf(r * (1.f - r), 1e-12f));
    }
    return {0.f, 0.f, c2};
  }
  // the largest component z and the two after it in cyclic order
  const int maxc = r > g ? (r > b ? 0 : 2) : (g > b ? 1 : 2);
  const float z = maxc == 0 ? r : (maxc == 1 ? g : b);
  const float c1 = maxc == 0 ? g : (maxc == 1 ? b : r);
  const float c2 = maxc == 0 ? b : (maxc == 1 ? r : g);
  const float zsafe = fmaxf(z, 1e-12f);
  const float x = c1 * (float)(RES - 1) / zsafe;
  const float y = c2 * (float)(RES - 1) / zsafe;
  const long long xi = min((long long)x, (long long)(RES - 2));
  const long long yi = min((long long)y, (long long)(RES - 2));
  // searchsorted (left) over the z nodes, minus one, clamped
  int lo = 0, hi = RES;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a.z_nodes + mid) < z) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int zi = min(max(lo - 1, 0), RES - 2);
  const float dx = x - (float)xi, dy = y - (float)yi;
  const float z0 = __ldg(a.z_nodes + zi), z1 = __ldg(a.z_nodes + zi + 1);
  const float dz = (z - z0) / fmaxf(z1 - z0, 1e-12f);
  // the cell's corner (ddx, ddy, ddz)'s coefficient k
  const float* base = a.coeffs + ((((long long)maxc * RES + zi) * RES + yi) * RES + xi) * 3;
  const long long sx = 3, sy = 3 * RES, sz = 3 * RES * RES;
  V3 out;
  float* o = &out.x;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* c = base + k;
    o[k] = lerp(dz, lerp(dy, lerp(dx, __ldg(c), __ldg(c + sx)),
                         lerp(dx, __ldg(c + sy), __ldg(c + sy + sx))),
                lerp(dy, lerp(dx, __ldg(c + sz), __ldg(c + sz + sx)),
                     lerp(dx, __ldg(c + sz + sy), __ldg(c + sz + sy + sx))));
  }
  return out;
}

// spectra.sigmoid_polynomial at the four wavelengths
__device__ __forceinline__ S4 sigmoid4(V3 c, const S4& lam) {
  S4 out;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = (c.x * lam.v[k] + c.y) * lam.v[k] + c.z;
    if (x >= 1e15f) {
      out.v[k] = 1.f;
    } else if (x <= -1e15f) {
      out.v[k] = 0.f;
    } else {
      out.v[k] = (0.5f * x) / sqrtf(1.f + x * x) + 0.5f;
    }
  }
  return out;
}

// a leaf's spectrum (textures.py _leaf_spectrum); 0 where node < 0
__device__ __forceinline__ S4 leaf_spectrum(const TexArgs& a, int node, const Ctx& c) {
  if (node < 0) return s4(0.f);
  if ((int)nd(a, node, N_TYPE) == TEX_IMAGE) {
    V3 rgb = leaf_rgb(a, node, c, c.footprints);
    rgb = {clampf(rgb.x, 0.f, 1.f), clampf(rgb.y, 0.f, 1.f), clampf(rgb.z, 0.f, 1.f)};
    return sigmoid4(rgb_to_coefficients(a, rgb), c.lam) * 1.f;
  }
  return sigmoid4(nd3(a, node, N_COEFFS), c.lam) * nd(a, node, N_CSCALE);
}

// a leaf's float (textures.py _leaf_float); 0 where node < 0
__device__ __forceinline__ float leaf_float(const TexArgs& a, int node, const Ctx& c, bool fp) {
  if (node < 0) return 0.f;
  if ((int)nd(a, node, N_TYPE) == TEX_IMAGE) return leaf_rgb(a, node, c, fp).x;
  return nd(a, node, N_CSCALE);
}

// a combinator's amount: its float texture, point-sampled, or its constant
__device__ __forceinline__ float amount(const TexArgs& a, int node, const Ctx& c) {
  const int at = (int)nd(a, node, N_AMOUNT_TEX);
  return at >= 0 ? leaf_float(a, at, c, false) : nd(a, node, N_AMOUNT);
}

// textures.py eval_spectrum at node >= 0
__device__ __forceinline__ S4 eval_spectrum(const TexArgs& a, int node, const Ctx& c) {
  const int t = (int)nd(a, node, N_TYPE);
  if (t == TEX_CONST || t == TEX_IMAGE) return leaf_spectrum(a, node, c);
  const int c1 = (int)nd(a, node, N_CHILD), c2 = (int)nd(a, node, N_CHILD + 1);
  if (t == TEX_CHECKER) {
    const V2 st = mapped_uv(a, node, c);
    const int parity = (int)(floorf(st.x) + floorf(st.y)) & 1;
    return leaf_spectrum(a, parity == 0 ? c1 : c2, c);
  }
  const S4 v1 = leaf_spectrum(a, c1, c);
  if (t == TEX_SCALE) return v1 * amount(a, node, c);
  const S4 v2 = leaf_spectrum(a, c2, c);
  const float amt =
      t == TEX_MIX ? amount(a, node, c) : fabsf(dot(c.ns, nd3(a, node, N_DIR)));
  // mix: (1 - amount) tex1 + amount tex2; directionmix: amount tex1 + (1 -
  // amount) tex2
  const float w1 = t == TEX_MIX ? 1.f - amt : amt, w2 = t == TEX_MIX ? amt : 1.f - amt;
  S4 out;
#pragma unroll
  for (int k = 0; k < 4; ++k) out.v[k] = w1 * v1.v[k] + w2 * v2.v[k];
  return out;
}

// textures.py eval_float at node >= 0
__device__ __forceinline__ float eval_float(const TexArgs& a, int node, const Ctx& c) {
  if ((int)nd(a, node, N_TYPE) == TEX_SCALE) {
    return leaf_float(a, (int)nd(a, node, N_CHILD), c, c.footprints) * amount(a, node, c);
  }
  return leaf_float(a, node, c, c.footprints);
}

__device__ __forceinline__ void st4(float* p, long long i, S4 v) {
  reinterpret_cast<float4*>(p)[i] = make_float4(v.v[0], v.v[1], v.v[2], v.v[3]);
}

__device__ __forceinline__ S4 clamp01(S4 v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v.v[k] = clampf(v.v[k], 0.f, 1.f);
  return v;
}

__device__ __forceinline__ void tex_lane(const TexArgs& a, long long i) {
  long long m = a.mat[i];
  const V3 p = ld3(a.p, i);
  if (m >= 0) {
    const float* row = a.mat_rows + MATT_F * m;
    if ((int)__ldg(row) == MAT_MIX) {
      const V3 wo = ld3(a.wo, i);
      const uint32_t w[6] = {__float_as_uint(p.x),  __float_as_uint(p.y),
                             __float_as_uint(p.z),  __float_as_uint(wo.x),
                             __float_as_uint(wo.y), __float_as_uint(wo.z)};
      const float u = __uint2float_rn((uint32_t)murmur6(w)) * TWO_M32;
      m = u < __ldg(row + 3) ? (long long)__ldg(row + 1) : (long long)__ldg(row + 2);
    }
  }
  a.mat_out[i] = m;
  if (a.lanes[i] == 0 || m < 0) {
    a.mask[i] = 0;
    return;
  }
  const float* row = a.mat_rows + MATT_F * m;
  const int rt = (int)__ldg(row + 4), tt = (int)__ldg(row + 5), ut = (int)__ldg(row + 6),
            vt = (int)__ldg(row + 7);
  Ctx c;
  c.p = p;
  c.uv = {a.uv[2 * i], a.uv[2 * i + 1]};
  c.ns = ld3(a.ns, i);
  const float4 lam = reinterpret_cast<const float4*>(a.lam)[i];
  c.lam = {{lam.x, lam.y, lam.z, lam.w}};
  c.footprints = a.duv != nullptr;
  if (c.footprints) {
    const float4 d = reinterpret_cast<const float4*>(a.duv)[i];
    c.duv[0] = d.x;
    c.duv[1] = d.y;
    c.duv[2] = d.z;
    c.duv[3] = d.w;
  }
  uint8_t mask = 0;
  if (rt >= 0) {
    st4(a.refl, i, clamp01(eval_spectrum(a, rt, c)));
    mask |= 1;
  }
  if (tt >= 0) {
    st4(a.trans, i, clamp01(eval_spectrum(a, tt, c)));
    mask |= 2;
  }
  if (ut >= 0) {
    a.urough[i] = eval_float(a, ut, c);
    mask |= 4;
  }
  if (vt >= 0) {
    a.vrough[i] = eval_float(a, vt, c);
    mask |= 8;
  }
  a.mask[i] = mask;
}

__global__ void __launch_bounds__(THREADS) tex_eval_kernel(const TexArgs a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) tex_lane(a, i);
}

}  // namespace

extern "C" int pbrt_tex_args_bytes() { return (int)sizeof(TexArgs); }

extern "C" int pbrt_tex_eval(const TexArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  const long long blocks = (a->n + THREADS - 1) / THREADS;
  tex_eval_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
