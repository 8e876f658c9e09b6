// K12: BDPT's connection-and-MIS stage.
//
// Replaces the TPU hot path pbrt_tpu/integrators/bdpt.py:608 `_mis_weight`
// and :731 `connect` (the strategy loop of :888 `li_bdpt`). Two entry
// points around one visibility dispatch:
//   pbrt_bdpt_connect_rays    every strategy with s >= 1: the two vertex
//                             factors, `attempt`, and the shadow ray from the
//                             sending vertex (t_max 0 without an attempt);
//                             counts the attempts; one thread per lane;
//   (dispatch.occluded over all strategies' rays, in torch)
//   pbrt_bdpt_connect_weight  every strategy: L from the visibility bit, the
//                             four junction pdf_revs and the pdf-ratio walks
//                             of the MIS weight; sums the t > 1 strategies
//                             in table order and writes the t = 1 splats
//                             and their pixel ids for one K5s launch.
// What depends on the sampler (the s = 1 light sample and the t = 1 lens
// sample) comes in as per-strategy endpoint records.
//
// Inputs: the walks' own tensors, read through a per-wave table of field
// pointers in device memory (`Fields`): for each vertex slot (camera slots
// first) the 21 field groups of integrators/bdpt.py VERTEX_GROUPS, each
// (R,) or (R, w) contiguous with its fixed dtype (float32, int32 vtype, bool
// delta, int64 light and kind); then for each endpoint row the groups of
// CAMERA_SAMPLE_GROUPS or LIGHT_SAMPLE_GROUPS. No packed copy is made, and
// a wave may hold any number of slots and rows (any max depth).
//
// bdpt_connect_weight on the H100. Read one thread per lane (csrc/
// bdpt_lane.cu), a strategy loads up to six vertex records from device
// memory and a lane's 43 strategies re-read its ~3.5 KB of vertices some 15
// times. Here a block owns a tile of 32 lanes and copies their records into
// shared memory once (cp.async, 16 bytes a copy, 6560 bytes a slot); every
// strategy reads them from there. The block's warps share out the wave's
// strategies (a host-built table balanced by cost, bdpt.warp_assignment), one
// strategy per warp at a time, so the (s, t) branch is uniform across a warp
// and a tile's strategies run side by side: 16 warps, one block an SM (the
// kernel needs 126 registers, so 16 warps is also all an SM holds). The
// blocks are persistent and stage their next tile into a second buffer
// while they compute this one (two 17-slot tiles fill 223 KB). A tile of
// more than 35 slots (max depth 17 and up) does not fit the block's shared
// memory; there the same kernel reads the vertices in place from the walks'
// tensors, as bdpt_connect_rays does. Each strategy writes its L to the
// per-strategy output; after a barrier one warp sums the tile's t > 1 ones
// in table order.
// Endpoint records, read by one strategy each, come from global memory
// through the L2 (__ldcg). What bounds it is not memory: the shared-memory
// reads did not shorten it much (PERF.md); it is the dependent float
// arithmetic of the MIS weight (IEEE divisions and square roots in the
// direction and pdf chains, the ratio walks) at 16 warps an SM. A strategy
// forms each direction between its junction vertices once (Junction) where
// bdpt.py forms it at every use; every value is computed by the same
// operations in the same order as bdpt_lane.cu's, so the results are the
// same bits.
//
// The arithmetic is that of the plain torch version (integrators/bdpt.py,
// cameras/perspective.py we/pdf_we, lights/lights.py pdf_le), evaluated only
// for the branch a lane selects; 3-term dot products are (x + y) + z and the
// file is built with --fmad=false.
//
// The two entry points as first written (one thread per lane over a packed
// copy of the walks) are the yardsticks in csrc/bdpt_lane.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bxdf.cuh"

using namespace pbrt_bxdf;

namespace {

constexpr int LT_F = 10, LAMBDA_MIN = 360, LAMBDA_RANGE = 471;
// vertex field groups (integrators/bdpt.py VERTEX_GROUPS), in this order
constexpr int NG = 21;
constexpr int G_VTYPE = 0, G_P = 1, G_NG = 2, G_NS = 3, G_BETA = 4, G_PDF_FWD = 5,
              G_PDF_REV = 6, G_DELTA = 7, G_LIGHT = 8, G_WO = 9, G_KIND = 10, G_REFL = 11,
              G_TRANS = 12, G_ETA_RE = 13, G_ETA_IM = 14, G_ETA = 15, G_AX = 16, G_AY = 17,
              G_FX = 18, G_FY = 19, G_FZ = 20;
// float32 components of a group, and its bytes a lane (int32 vtype 4, bool
// delta 1, int64 light and kind 8)
__host__ __device__ constexpr int g_width(int g) {
  return (g == G_P || g == G_NG || g == G_NS || g == G_WO || g >= G_FX) ? 3
         : (g == G_BETA || (g >= G_REFL && g <= G_ETA_IM))             ? 4
                                                                        : 1;
}
__host__ __device__ constexpr int g_bytes(int g) {
  return g == G_DELTA ? 1 : (g == G_LIGHT || g == G_KIND) ? 8 : 4 * g_width(g);
}
__host__ __device__ constexpr int g_offset(int g) {  // bytes a lane before group g
  int o = 0;
  for (int i = 0; i < g; ++i) o += g_bytes(i);
  return o;
}
// a tile: 32 lanes; the warps of a block; a slot's staged records; endpoint
// groups; the most slots a block stages (past them it reads in place)
constexpr int TILE = 32, WARPS = 16;
constexpr int SLOT_BYTES = TILE * g_offset(NG);
static_assert(SLOT_BYTES == 6560 && SLOT_BYTES % 16 == 0, "slot bytes");
constexpr int NEG = 8;
constexpr int MAX_SMEM = 232448;  // a block's shared memory on the H100
constexpr int STAGED_SLOTS = MAX_SMEM / SLOT_BYTES;  // 35: max depth 16
// endpoint groups: a t = 1 camera sample (CAMERA_SAMPLE_GROUPS) ...
constexpr int C_WI = 0, C_WE = 1, C_PDF = 2, C_RASTER = 3, C_P_LENS = 4, C_VALID = 5;
__host__ __device__ constexpr int c_width(int g) {
  return g == C_WI || g == C_P_LENS ? 3 : g == C_RASTER ? 2 : 1;
}
// ... and an s = 1 light sample (LIGHT_SAMPLE_GROUPS; int64 light, bool valid)
constexpr int L_LIGHT = 0, L_PMF = 1, L_P = 2, L_N = 3, L_WI = 4, L_LE = 5, L_PDF = 6,
              L_VALID = 7;
__host__ __device__ constexpr int l_width(int g) {
  return g == L_P || g == L_N || g == L_WI ? 3 : g == L_LE ? 4 : 1;
}
// scene constants (bdpt.kernel_tables)
constexpr int S_CFR = 0, S_RFC = 16, S_Z = 32, S_COS_TOTAL = 35, S_A = 36, S_RES = 37,
              S_LENS_AREA = 39, S_LENS_R = 40, S_FOCAL = 41, S_DISK_PDF = 42, S_OFFSET = 43,
              S_INF_DENSITY = 44;
// light table columns
constexpr int L_TYPE = 0, L_PMF_COL = 1, L_TWO = 2, L_AREA = 3, L_SHAPE = 4, L_DIR = 5,
              L_COS_END = 8, L_SCALE = 9;
constexpr int VT_NONE = 0, VT_CAMERA = 1, VT_LIGHT = 2, VT_SURFACE = 3, VT_LIGHT_INF = 4;
constexpr int LIGHT_AREA = 0, LIGHT_DISTANT = 1, LIGHT_UNIFORM_INFINITE = 2, LIGHT_SPOT = 4;
constexpr int K_COATED_DIFFUSE = 4, K_COATED_CONDUCTOR = 5;
// Python constants folded in double precision, then rounded once
constexpr float SHADOW_SHORTEN = (float)(1.0 - 1e-3);
constexpr float UNIFORM_SPHERE_PDF = (float)(1.0 / (4.0 * 3.141592653589793));

// the walks' tensors of one wave: group pointers by vertex slot (n_slots x
// NG) and by endpoint row (n_end x NEG), two parts of one int64 table in
// device memory
struct Fields {
  const unsigned long long* v;
  const unsigned long long* e;
};

// entry i of a pointer table (read-only for the kernel's life)
__device__ __forceinline__ const void* table_ptr(const unsigned long long* t, int i) {
  return reinterpret_cast<const void*>(__ldg(t + i));
}

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float k) { return {a.x * k, a.y * k, a.z * k}; }

// What every context shares. `lane` is the lane's index in the wave, `gl`
// the lane that global per-lane inputs are read at (a tile's lanes past R
// read lane R - 1 and write nothing).
struct CtxBase {
  const float* sc;  // scene constants
  const float* lt;  // (L, LT_F)
  int n_cam, R, lane, gl;
  __device__ float light(int li, int f) const { return lt[(size_t)li * LT_F + f]; }
};

// Endpoint rows read from the walks' tensors, at lane gl, through the table
// `et` of their pointers (Fields::e, or the block's copy of it in shared
// memory). Each is read by one strategy, so through the L2 only (__ldcg),
// keeping the small L1 that the tile leaves for data read again.
struct FieldEnds : CtxBase {
  Fields F;
  const unsigned long long* et;
  __device__ const void* ep(int e, int g) const {
    return reinterpret_cast<const void*>(et[e * NEG + g]);
  }
  __device__ float cf(int e, int g, int k = 0) const {
    return __ldcg(static_cast<const float*>(ep(e, g)) + (size_t)gl * c_width(g) + k);
  }
  __device__ V3 cf3(int e, int g) const { return {cf(e, g, 0), cf(e, g, 1), cf(e, g, 2)}; }
  __device__ bool cb(int e, int g) const {
    return __ldcg(static_cast<const unsigned char*>(ep(e, g)) + gl) != 0;
  }
  __device__ float lf(int e, int g, int k = 0) const {
    return __ldcg(static_cast<const float*>(ep(e, g)) + (size_t)gl * l_width(g) + k);
  }
  __device__ V3 lf3(int e, int g) const { return {lf(e, g, 0), lf(e, g, 1), lf(e, g, 2)}; }
  __device__ bool lb(int e, int g) const {
    return __ldcg(static_cast<const unsigned char*>(ep(e, g)) + gl) != 0;
  }
  __device__ int li64(int e, int g) const {  // the low word of an int64 id
    return __ldcg(static_cast<const int*>(ep(e, g)) + 2 * (size_t)gl);
  }
};

// Vertices straight from the walks' tensors, at lane gl (bdpt_connect_rays,
// and bdpt_connect_weight past STAGED_SLOTS). The pointers come from memory,
// so the loads name the global space (__ldca) where a plain one would be
// generic.
struct FieldCtx : FieldEnds {
  __device__ const void* vp(int slot, int g) const { return table_ptr(F.v, slot * NG + g); }
  __device__ float vf(int slot, int g, int k = 0) const {
    return __ldca(static_cast<const float*>(vp(slot, g)) + (size_t)gl * g_width(g) + k);
  }
  __device__ V3 vf3(int slot, int g) const {
    return {vf(slot, g, 0), vf(slot, g, 1), vf(slot, g, 2)};
  }
  __device__ S4 vf4(int slot, int g) const {
    const float4 x = __ldca(static_cast<const float4*>(vp(slot, g)) + gl);
    return {{x.x, x.y, x.z, x.w}};
  }
  __device__ int vi(int slot, int g) const {  // int32 vtype; the low word of int64 ids
    return __ldca(static_cast<const int*>(vp(slot, g)) + (g_bytes(g) == 8 ? 2 : 1) * (size_t)gl);
  }
  __device__ bool vb(int slot, int g) const {
    return __ldca(static_cast<const unsigned char*>(vp(slot, g)) + gl) != 0;
  }
};

// Vertices from the block's staged tile (bdpt_connect_weight): slot s, group
// g of tile lane t at tile + s SLOT_BYTES + TILE g_offset(g) + t g_bytes(g).
struct TileCtx : FieldEnds {
  const unsigned char* tile;
  int t;  // lane in the tile
  __device__ const unsigned char* vp(int slot, int g) const {
    return tile + slot * SLOT_BYTES + TILE * g_offset(g);
  }
  __device__ float vf(int slot, int g, int k = 0) const {
    return reinterpret_cast<const float*>(vp(slot, g))[t * g_width(g) + k];
  }
  __device__ V3 vf3(int slot, int g) const {
    return {vf(slot, g, 0), vf(slot, g, 1), vf(slot, g, 2)};
  }
  __device__ S4 vf4(int slot, int g) const {
    const float4 x = reinterpret_cast<const float4*>(vp(slot, g))[t];
    return {{x.x, x.y, x.z, x.w}};
  }
  __device__ int vi(int slot, int g) const {
    return reinterpret_cast<const int*>(vp(slot, g))[(g_bytes(g) == 8 ? 2 : 1) * t];
  }
  __device__ bool vb(int slot, int g) const { return vp(slot, g)[t] != 0; }
};

// what the connections read of a vertex (its BSDF is read from the record
// where needed); slot -1: a sampled endpoint, whose BSDF is the empty one
struct Vtx {
  int vtype, light, slot;
  V3 p, ng, ns, wo;
  S4 beta;
  float pdf_fwd;
  bool delta;
};

__device__ __forceinline__ Vtx empty_vtx() {
  Vtx v;
  v.vtype = VT_NONE;
  v.light = -1;
  v.slot = -1;
  v.p = {0.f, 0.f, 0.f};
  v.ng = v.ns = {0.f, 0.f, 1.f};
  v.wo = {0.f, 0.f, 0.f};
  v.beta = s4(0.f);
  v.pdf_fwd = 0.f;
  v.delta = false;
  return v;
}

template <class C>
__device__ __forceinline__ Vtx load_vtx(const C& c, int slot) {
  Vtx v;
  v.slot = slot;
  v.vtype = c.vi(slot, G_VTYPE);
  v.light = c.vi(slot, G_LIGHT);
  v.p = c.vf3(slot, G_P);
  v.ng = c.vf3(slot, G_NG);
  v.ns = c.vf3(slot, G_NS);
  v.wo = c.vf3(slot, G_WO);
  v.beta = c.vf4(slot, G_BETA);
  v.pdf_fwd = c.vf(slot, G_PDF_FWD);
  v.delta = c.vb(slot, G_DELTA);
  return v;
}

__device__ __forceinline__ bool exists(const Vtx& v) { return v.vtype != VT_NONE; }
__device__ __forceinline__ bool connectible(const Vtx& v) { return exists(v) && !v.delta; }

__device__ __forceinline__ V3 dir_to(V3 a, V3 b, float& dist2) {
  const V3 d = sub(b, a);
  dist2 = dot(d, d);
  const float l = sqrtf(fmaxf(dist2, 1e-24f));
  return {d.x / l, d.y / l, d.z / l};
}

// |cos| at the receiving vertex; endpoints without geometry take 1
__device__ __forceinline__ float receiver_cos(const Vtx& to, V3 w) {
  const float c = fabsf(dot(to.ng, w));
  return to.vtype == VT_SURFACE ? c : fmaxf(c, 1.f);
}

__device__ __forceinline__ float convert_density(float pdf_dir, V3 from, const Vtx& to) {
  float d2;
  const V3 w = dir_to(from, to.p, d2);
  return (pdf_dir * receiver_cos(to, w)) / fmaxf(d2, 1e-24f);
}

// the vertex's BSDF (coated kinds as diffuse) and shading frame
template <class C>
__device__ __forceinline__ void load_bsdf(const C& c, int slot, Bxdf& b, V3& fx, V3& fy, V3& fz) {
  if (slot < 0) {
    b.kind = K_DIFFUSE;
    b.refl = b.trans = b.eta_im = s4(0.f);
    b.eta_re = s4(1.f);
    b.eta = 1.f;
    b.ax = b.ay = 1e-4f;
    fx = {1.f, 0.f, 0.f};
    fy = {0.f, 1.f, 0.f};
    fz = {0.f, 0.f, 1.f};
    return;
  }
  int kind = c.vi(slot, G_KIND);
  if (kind == K_COATED_DIFFUSE || kind == K_COATED_CONDUCTOR) kind = K_DIFFUSE;
  b.kind = kind;
  b.refl = c.vf4(slot, G_REFL);
  b.trans = c.vf4(slot, G_TRANS);
  b.eta_re = c.vf4(slot, G_ETA_RE);
  b.eta_im = c.vf4(slot, G_ETA_IM);
  b.eta = c.vf(slot, G_ETA);
  b.ax = c.vf(slot, G_AX);
  b.ay = c.vf(slot, G_AY);
  fx = c.vf3(slot, G_FX);
  fy = c.vf3(slot, G_FY);
  fz = c.vf3(slot, G_FZ);
}

__device__ __forceinline__ V3 to_local(V3 fx, V3 fy, V3 fz, V3 w) {
  return {dot(w, fx), dot(w, fy), dot(w, fz)};
}

// BSDF value at v towards the direction wi (bdpt.py _vertex_f, wi =
// dir_to(v.p, p)); zero for non-surfaces
template <class C>
__device__ __forceinline__ S4 vertex_f(const C& c, const Vtx& v, V3 wi) {
  if (v.vtype != VT_SURFACE) return s4(0.f);
  Bxdf b;
  V3 fx, fy, fz;
  load_bsdf(c, v.slot, b, fx, fy, fz);
  return bxdf_f(b, to_local(fx, fy, fz, v.wo), to_local(fx, fy, fz, wi));
}

__device__ __forceinline__ V3 xform_point(const float* m, V3 p) {
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = ((m[4 * i] * p.x + m[4 * i + 1] * p.y) + m[4 * i + 2] * p.z) + m[4 * i + 3];
  return {r[0] / r[3], r[1] / r[3], r[2] / r[3]};
}

// the camera's directional density of emitting d from p (perspective.py
// pdf_we with its we() validity test)
__device__ __forceinline__ float pdf_we_dir(const CtxBase& c, V3 p, V3 d) {
  const V3 z = {c.sc[S_Z], c.sc[S_Z + 1], c.sc[S_Z + 2]};
  const float cos_t = dot(d, z);
  const bool fwd = cos_t > c.sc[S_COS_TOTAL];
  const float cos_safe = fmaxf(cos_t, 1e-6f);
  const float focus_t = c.sc[S_LENS_R] > 0.f ? c.sc[S_FOCAL] : 1.f;
  const V3 p_focus = add(p, scale(d, focus_t / cos_safe));
  const V3 pr = xform_point(c.sc + S_RFC, xform_point(c.sc + S_CFR, p_focus));
  const bool inb = pr.x >= 0.f && pr.x < c.sc[S_RES] && pr.y >= 0.f && pr.y < c.sc[S_RES + 1];
  if (!(fwd && inb)) return 0.f;
  return 1.f / (c.sc[S_A] * ((cos_safe * cos_safe) * cos_safe));
}

// lights.py pdf_le -> pdf_pos, pdf_dir of light li emitting w from normal ng
__device__ __forceinline__ void pdf_le(const CtxBase& c, int light, V3 ng, V3 w, float& pos,
                                       float& dir) {
  const int li = max(light, 0);
  const int type = (int)c.light(li, L_TYPE);
  if (type == LIGHT_AREA) {
    pos = 1.f / fmaxf(c.light(li, L_AREA), 1e-12f);
    const float cosw = dot(ng, w);
    dir = c.light(li, L_TWO) != 0.f ? (fabsf(cosw) * INV_PI_F) / 2.f : fmaxf(cosw, 0.f) * INV_PI_F;
  } else if (type == LIGHT_SPOT) {
    pos = 0.f;
    const float cos_end = c.light(li, L_COS_END);
    const V3 axis = {c.light(li, L_DIR), c.light(li, L_DIR + 1), c.light(li, L_DIR + 2)};
    dir = dot(axis, w) >= cos_end ? 1.f / (TWO_PI_F * fmaxf(1.f - cos_end, 1e-9f)) : 0.f;
  } else {
    pos = c.sc[S_DISK_PDF];
    dir = type == LIGHT_DISTANT ? 0.f : UNIFORM_SPHERE_PDF;
  }
}

__device__ __forceinline__ bool is_inf_vertex(const CtxBase& c, const Vtx& v) {
  if (v.vtype == VT_LIGHT_INF) return true;
  return v.vtype == VT_LIGHT && v.light >= 0 &&
         (int)c.light(v.light, L_TYPE) == LIGHT_UNIFORM_INFINITE;
}

__device__ __forceinline__ bool is_delta_light(const CtxBase& c, int vtype, int light) {
  if (vtype != VT_LIGHT || light < 0) return false;
  const int type = (int)c.light(light, L_TYPE);
  return type == LIGHT_DISTANT || type == LIGHT_SPOT;
}

// The pdfs of bdpt.py take their directions as arguments here: a strategy
// computes each direction between its junction vertices once (see
// Junction), where bdpt.py and csrc/bdpt_lane.cu form it again at each use;
// the same operations on the same values, so the same bits.

// directional pdf at v from wp (bdpt.py: towards the previous vertex, or
// v.wo without one) towards wn = dir_to(v.p, nxt.p) (d2n its squared
// length), as an area density at nxt
template <class C>
__device__ __forceinline__ float vertex_pdf(const C& c, const Vtx& v, V3 wp, V3 wn, float d2n,
                                            const Vtx& nxt) {
  float pdf_dir;
  if (v.vtype == VT_CAMERA) {
    pdf_dir = pdf_we_dir(c, v.p, wn);
  } else if (v.vtype == VT_LIGHT) {
    float pos;
    pdf_le(c, v.light, v.ng, wn, pos, pdf_dir);
  } else {
    Bxdf b;
    V3 fx, fy, fz;
    load_bsdf(c, v.slot, b, fx, fy, fz);
    pdf_dir = bxdf_pdf(b, to_local(fx, fy, fz, wp), to_local(fx, fy, fz, wn), true, true);
  }
  return (pdf_dir * receiver_cos(nxt, wn)) / fmaxf(d2n, 1e-24f);
}

// light vertex v emitting along w = dir_to(v.p, nxt.p), area density at nxt
__device__ __forceinline__ float vertex_pdf_light(const CtxBase& c, const Vtx& v, V3 w, float d2,
                                                  const Vtx& nxt) {
  float pos, dir;
  pdf_le(c, v.light, v.ng, w, pos, dir);
  const float pdf = is_inf_vertex(c, v) ? c.sc[S_DISK_PDF] : dir / fmaxf(d2, 1e-24f);
  return pdf * receiver_cos(nxt, w);
}

// pmf(light) times the positional density of v, w = dir_to(v.p, prev.p)
__device__ __forceinline__ float vertex_pdf_light_origin(const CtxBase& c, const Vtx& v, V3 w) {
  if (is_inf_vertex(c, v)) return c.sc[S_INF_DENSITY];
  const int li = max(v.light, 0);
  const bool is_area = (int)c.light(li, L_TYPE) == LIGHT_AREA;
  float pos, dir;
  pdf_le(c, v.light, v.ng, w, pos, dir);
  const float pdf_pos = is_area ? 1.f / fmaxf(c.light(li, L_AREA), 1e-12f) : pos;
  const bool ok = c.light(li, L_SHAPE) != 0.f || !is_area;
  return v.light >= 0 && ok ? c.light(li, L_PMF_COL) * pdf_pos : 0.f;
}

__device__ __forceinline__ float remap0(float f) { return f != 0.f ? f : 1.f; }

struct Ratio {  // what the ratio walks read of a vertex
  float pdf_fwd, pdf_rev;
  bool delta, exists;
};

template <class C>
__device__ __forceinline__ Ratio load_ratio(const C& c, int slot) {
  return {c.vf(slot, G_PDF_FWD), c.vf(slot, G_PDF_REV), c.vb(slot, G_DELTA),
          c.vi(slot, G_VTYPE) != VT_NONE};
}

// The junction of strategy (s, t) at a lane: the light-side end qs and the
// camera-side end pt (the sampled endpoint of an s = 1 or t = 1 strategy as
// a vertex), and the directions between them that the connection and the
// MIS weight both read, each formed once: u = qs -> pt and un = pt -> qs,
// with their squared lengths (where s > 0; the connection alone reads un
// only where t > 1 and u only where s > 1). MIS loads the ends'
// predecessors qsm and ptm itself and forms a = qs -> qsm and b = pt -> ptm
// once each, so that they are not held through the connection.
struct Junction {
  Vtx qs, pt;
  V3 u, un;
  float d2u, d2un;
};

template <bool MIS, class C>
__device__ __forceinline__ Junction junction(const C& c, int s, int t, int e) {
  Junction j;
  j.qs = empty_vtx();
  j.u = j.un = {0.f, 0.f, 0.f};
  j.d2u = j.d2un = 0.f;
  if (t == 1) {  // the lens point (bdpt.py _sampled_vertex)
    j.pt = empty_vtx();
    j.pt.vtype = VT_CAMERA;
    j.pt.p = c.cf3(e, C_P_LENS);
    j.pt.beta = s4(c.cf(e, C_WE) / fmaxf(c.cf(e, C_PDF), 1e-12f));
    j.pt.pdf_fwd = 1.f;
  } else {
    j.pt = load_vtx(c, t - 1);
  }
  if (s == 1) {  // the light point; its pdf_fwd below, once u is known
    j.qs.vtype = VT_LIGHT;
    j.qs.light = c.li64(e, L_LIGHT);
    j.qs.p = c.lf3(e, L_P);
    j.qs.ng = j.qs.ns = c.lf3(e, L_N);
  } else if (s > 1) {
    j.qs = load_vtx(c, c.n_cam + s - 1);
  }
  if (s > 0 && (MIS || s > 1)) j.u = dir_to(j.qs.p, j.pt.p, j.d2u);
  if (s > 0 && (MIS || t > 1)) j.un = dir_to(j.pt.p, j.qs.p, j.d2un);
  if (MIS && s == 1) j.qs.pdf_fwd = vertex_pdf_light_origin(c, j.qs, j.u);
  return j;
}

// bdpt.py _mis_weight over a junction
template <class C>
__device__ __forceinline__ float mis_weight(const C& c, int s, int t, const Junction& j) {
  if (s + t == 2) return 1.f;
  const int L0 = c.n_cam;  // slot of light vertex 0
  const Vtx qsm = s > 1 ? load_vtx(c, L0 + s - 2) : empty_vtx();
  const Vtx ptm = t > 1 ? load_vtx(c, t - 2) : empty_vtx();
  float d2a = 0.f, d2b = 0.f;
  const V3 a = s > 1 ? dir_to(j.qs.p, qsm.p, d2a) : V3{0.f, 0.f, 0.f};
  const V3 b = t > 1 ? dir_to(j.pt.p, ptm.p, d2b) : V3{0.f, 0.f, 0.f};
  float pt_rev, ptm_rev = 0.f, qs_rev = 0.f, qsm_rev = 0.f;
  if (s > 0) {
    pt_rev = j.qs.vtype == VT_LIGHT ? vertex_pdf_light(c, j.qs, j.u, j.d2u, j.pt)
                                    : vertex_pdf(c, j.qs, s > 1 ? a : j.qs.wo, j.u, j.d2u, j.pt);
  } else {
    pt_rev = vertex_pdf_light_origin(c, j.pt, b);
  }
  if (t > 1)
    ptm_rev = s > 0 ? vertex_pdf(c, j.pt, j.un, b, d2b, ptm)
                    : vertex_pdf_light(c, j.pt, b, d2b, ptm);
  if (s > 0) {
    qs_rev = vertex_pdf(c, j.pt, t > 1 ? b : j.pt.wo, j.un, j.d2un, j.qs);
    if (s > 1) qsm_rev = vertex_pdf(c, j.qs, j.u, a, d2a, qsm);
  }
  // the ratio walks read the four records with these pdf_revs
  const Ratio r_pt = {j.pt.pdf_fwd, pt_rev, j.pt.delta, exists(j.pt)},
              r_ptm = {ptm.pdf_fwd, ptm_rev, ptm.delta, exists(ptm)},
              r_qs = {j.qs.pdf_fwd, qs_rev, j.qs.delta, exists(j.qs)},
              r_qsm = {qsm.pdf_fwd, qsm_rev, qsm.delta, exists(qsm)};

  float sum_ri = 0.f, ri = 1.f;
  // camera walk i = t-1 .. 1
  for (int i = t - 1; i >= 1; --i) {
    const Ratio r = i == t - 1 ? r_pt : (i == t - 2 ? r_ptm : load_ratio(c, i));
    ri = (ri * remap0(r.pdf_rev)) / remap0(r.pdf_fwd);
    bool prev_delta = false;
    if (i - 1 > 0) prev_delta = i - 1 == t - 2 ? ptm.delta : c.vb(i - 1, G_DELTA);
    if (!r.delta && !prev_delta && r.exists) sum_ri = sum_ri + ri;
  }
  // light walk i = s-1 .. 0; i == 0 takes the endpoint's delta-light flag
  ri = 1.f;
  for (int i = s - 1; i >= 0; --i) {
    const Ratio r = i == s - 1 ? r_qs : (i == s - 2 ? r_qsm : load_ratio(c, L0 + i));
    ri = (ri * remap0(r.pdf_rev)) / remap0(r.pdf_fwd);
    bool prev_delta;
    if (i - 1 >= 0) {
      prev_delta = i - 1 == s - 2 ? qsm.delta : c.vb(L0 + i - 1, G_DELTA);
    } else {  // light vertex 0: qs, qsm or the record
      prev_delta = s == 1   ? is_delta_light(c, j.qs.vtype, j.qs.light)
                   : s == 2 ? is_delta_light(c, qsm.vtype, qsm.light)
                            : is_delta_light(c, c.vi(L0, G_VTYPE), c.vi(L0, G_LIGHT));
    }
    if (!r.delta && !prev_delta && r.exists) sum_ri = sum_ri + ri;
  }
  return 1.f / (1.f + sum_ri);
}

// a strategy with s >= 1 before its visibility test (bdpt.py _connection)
struct Conn {
  bool attempt, has_g;
  S4 L;
  float g;
  V3 o, d;
  float t_max;
};

template <class C>
__device__ __forceinline__ Conn connection(const C& c, int s, int t, int e, const Junction& j) {
  Conn out;
  out.has_g = false;
  out.g = 1.f;
  if (t == 1) {
    const V3 wi = c.cf3(e, C_WI);
    const float we = c.cf(e, C_WE), pdf = c.cf(e, C_PDF);
    const S4 f = vertex_f(c, j.qs, j.u);
    const float ns_cos = j.qs.vtype == VT_SURFACE ? fabsf(dot(j.qs.ns, wi)) : 1.f;
    out.L = ((j.qs.beta * f) * (we / fmaxf(pdf, 1e-12f))) * ns_cos;
    out.attempt = connectible(j.qs) && c.cb(e, C_VALID) && any_pos(f);
  } else if (s == 1) {
    const float pmf = c.lf(e, L_PMF);
    const V3 wi = c.lf3(e, L_WI);
    S4 Lls;
#pragma unroll
    for (int k = 0; k < 4; ++k) Lls.v[k] = c.lf(e, L_LE, k);
    const float pdf = c.lf(e, L_PDF);
    const S4 f = vertex_f(c, j.pt, j.un);
    const float cos_pt = j.pt.vtype == VT_SURFACE ? fabsf(dot(j.pt.ns, wi)) : 1.f;
    out.L = (((j.pt.beta * f) * cos_pt) * Lls) / fmaxf(pmf * pdf, 1e-20f);
    out.attempt = connectible(j.pt) && c.lb(e, L_VALID) && pdf > 0.f && any_pos(f);
  } else {
    const S4 fa = vertex_f(c, j.qs, j.u), fb = vertex_f(c, j.pt, j.un);
    out.attempt = connectible(j.qs) && connectible(j.pt) && any_pos(fa) && any_pos(fb);
    const float cos_a = j.qs.vtype == VT_SURFACE ? fabsf(dot(j.qs.ns, j.u)) : 1.f;
    const float cos_b = j.pt.vtype == VT_SURFACE ? fabsf(dot(j.pt.ns, j.u)) : 1.f;
    out.g = (cos_a * cos_b) / fmaxf(j.d2u, 1e-24f);
    out.has_g = true;
    out.L = ((j.qs.beta * fa) * fb) * j.pt.beta;
  }
  // the shadow ray leaves the sending vertex, qs or (s = 1) pt, along w
  // (geometry/ray.py offset_ray_origin); picked by value, not by reference
  const V3 w = s == 1 ? j.un : j.u, ap = s == 1 ? j.pt.p : j.qs.p,
           ang = s == 1 ? j.pt.ng : j.qs.ng;
  const float d2 = s == 1 ? j.d2un : j.d2u;
  const float mag = fmaxf(fmaxf(fabsf(ap.x), fabsf(ap.y)), fabsf(ap.z));
  const float eps = c.sc[S_OFFSET] * fmaxf(mag, 1.f);
  const V3 n_off = dot(ang, w) < 0.f ? neg(ang) : ang;
  out.o = add(ap, scale(n_off, eps));
  out.d = w;
  out.t_max = out.attempt ? sqrtf(fmaxf(d2, 1e-24f)) * SHADOW_SHORTEN : 0.f;
  return out;
}

__device__ __forceinline__ int lam_bin(float lam) {
  return min(max(__float2int_rn(lam) - LAMBDA_MIN, 0), LAMBDA_RANGE - 1);
}

// L of strategy (0, t) before its weight (bdpt.py _emitted)
template <class C>
__device__ __forceinline__ S4 emitted(const C& c, const Junction& j, const float* lam,
                                      const float* emission, const float* uinf) {
  const Vtx& pt = j.pt;
  float d2;
  const V3 w_out = dir_to(pt.p, c.vf3(j.pt.slot - 1, G_P), d2);
  S4 Le = s4(0.f);
  const int li = max(pt.light, 0);
  if (pt.vtype == VT_LIGHT_INF) {
#pragma unroll
    for (int k = 0; k < 4; ++k) Le.v[k] = uinf[lam_bin(__ldcg(lam + 4 * c.gl + k))];
  } else if (pt.light >= 0 && (dot(pt.ng, w_out) > 0.f || c.light(li, L_TWO) != 0.f)) {
    const float sc = c.light(li, L_SCALE);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      Le.v[k] = emission[(size_t)li * LAMBDA_RANGE + lam_bin(__ldcg(lam + 4 * c.gl + k))] *
                sc;
  }
  const bool ok = exists(pt) && (pt.light >= 0 || pt.vtype == VT_LIGHT_INF);
  return ok ? pt.beta * Le : s4(0.f);
}

// L * MIS weight of strategy (s, t) at the lane, given the occluded bits of
// its ray row r. The weight is formed first: holding it (one float) through
// the connection, and not the connection's L through the weight, keeps the
// kernel within 128 registers, without spills.
template <class C>
__device__ __forceinline__ S4 strategy_L(const C& c, int s, int t, int e, int r,
                                         const float* lam, const float* emission,
                                         const float* uinf, const bool* occluded) {
  const Junction j = junction<true>(c, s, t, e);
  const float w = mis_weight(c, s, t, j);
  if (s == 0) return emitted(c, j, lam, emission, uinf) * w;
  const Conn cn = connection(c, s, t, e, j);
  const float vis =
      __ldcg(reinterpret_cast<const unsigned char*>(occluded) + (size_t)r * c.R + c.gl) ? 0.f
                                                                                     : 1.f;
  S4 Lst = cn.has_g ? cn.L * (cn.g * vis) : cn.L * vis;
  if (!cn.attempt) Lst = s4(0.f);
  return Lst * w;
}

// raster -> pixel: truncation toward zero, then clamped
template <class C>
__device__ __forceinline__ long long splat_pixel(const C& c, int e, int res_x, int res_y) {
  const int px = min(max((int)c.cf(e, C_RASTER, 0), 0), res_x - 1);
  const int py = min(max((int)c.cf(e, C_RASTER, 1), 0), res_y - 1);
  return (long long)py * res_x + px;
}

// bdpt_connect_rays: one thread per lane over the walks' tensors, each row
// of blocks (blockIdx.y) taking every gridDim.y-th strategy, so that a wave
// of few lanes (an MLT pass's 8192) still fills the card
__global__ void __launch_bounds__(128)
connect_rays_kernel(Fields F, CtxBase base, const int* table, int n_strat, float* ray_o,
                    float* ray_d, float* ray_t, unsigned long long* count) {
  FieldCtx c;
  static_cast<CtxBase&>(c) = base;
  c.F = F;
  c.et = F.e;
  c.lane = c.gl = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned int n = 0;
  for (int k = blockIdx.y; k < n_strat && c.lane < c.R; k += gridDim.y) {
    const int s = table[5 * k], t = table[5 * k + 1], e = table[5 * k + 2],
              r = table[5 * k + 3];
    if (s == 0) continue;
    const Conn cn = connection(c, s, t, e, junction<false>(c, s, t, e));
    const size_t i = (size_t)r * c.R + c.lane;
    ray_o[3 * i] = cn.o.x;
    ray_o[3 * i + 1] = cn.o.y;
    ray_o[3 * i + 2] = cn.o.z;
    ray_d[3 * i] = cn.d.x;
    ray_d[3 * i + 1] = cn.d.y;
    ray_d[3 * i + 2] = cn.d.z;
    ray_t[i] = cn.t_max;
    n += cn.attempt ? 1u : 0u;
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(count, (unsigned long long)n);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

// Stage a tile's vertex records as one cp.async group: warp w copies (slot,
// group) pairs w, w + WARPS, ...; lane i copies the pair's i-th 16 bytes (a
// group's 32 lanes are 32 to 512 bytes); bytes past lane R - 1 are zeros.
__device__ void stage_tile(const Fields& F, unsigned char* buf, int n_slots, int lane0, int R) {
  const int warp = threadIdx.x >> 5, i = threadIdx.x & 31;
  for (int pr = warp; pr < n_slots * NG; pr += WARPS) {
    const int slot = pr / NG, g = pr - slot * NG, gb = g_bytes(g);
    if (i < 2 * gb) {
      const long long left = (long long)(R - lane0) * gb - 16 * i;
      const int n = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
      const char* base = static_cast<const char*>(table_ptr(F.v, pr));
      cp_async16(buf + slot * SLOT_BYTES + TILE * g_offset(g) + 16 * i,
                 n ? base + (size_t)lane0 * gb + 16 * i : base, n);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// bdpt_connect_weight: persistent blocks of WARPS warps, each taking 32-lane
// tiles blockIdx.x, + gridDim.x, ... STAGED (where a tile and the endpoint
// rows' pointers fit the block's shared memory: up to 35 slots, max depth
// 16): a tile's vertices are staged in shared memory, and with two buffers
// (n_bufs 2, where two tiles fit) the next tile is staged while this one is
// computed; the endpoint pointer table is copied after the buffers once.
// Otherwise both are read in place. `order` holds the warps' strategy lists:
// order[w] .. order[w + 1] - 1 index order[WARPS + 1 ..], which holds table
// rows. per_strategy (n_strat, R, 4) receives every strategy's L; after a
// barrier one warp sums the tile's t > 1 rows in table order.
template <bool STAGED>
__global__ void __launch_bounds__(WARPS * 32, 1)
connect_weight_tile_kernel(Fields F, CtxBase base, int n_slots, int n_end, int n_bufs,
                           const int* table, const int* order, int n_strat, const float* lam,
                           const float* emission, const float* uinf, const bool* occluded,
                           int res_x, int res_y, float* L_out, float* splat_L,
                           long long* splat_pix, float* per_strategy) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, n_tiles = (base.R + TILE - 1) / TILE;
  const int buf_bytes = n_slots * SLOT_BYTES;
  typename std::conditional<STAGED, TileCtx, FieldCtx>::type c;
  static_cast<CtxBase&>(c) = base;
  c.F = F;
  c.et = F.e;
  const int lane_t = threadIdx.x & 31;  // the thread's lane in a tile
  int b = 0;
  if constexpr (STAGED) {
    c.t = lane_t;
    if (n_bufs == 2 && (int)blockIdx.x < n_tiles)
      stage_tile(F, smem, n_slots, blockIdx.x * TILE, base.R);
    unsigned long long* et = reinterpret_cast<unsigned long long*>(smem + n_bufs * buf_bytes);
    for (int i = threadIdx.x; i < n_end * NEG; i += WARPS * 32) et[i] = __ldg(F.e + i);
    c.et = et;  // read after the first tile's barrier
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    if constexpr (STAGED) {
      const int next = tile + gridDim.x;
      if (n_bufs == 2) {
        if (next < n_tiles) stage_tile(F, smem + (b ^ 1) * buf_bytes, n_slots, next * TILE, c.R);
        else asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        stage_tile(F, smem, n_slots, tile * TILE, c.R);
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      c.tile = smem + b * buf_bytes;
    }
    c.lane = tile * TILE + lane_t;
    c.gl = min(c.lane, c.R - 1);
    const bool live = c.lane < c.R;
    for (int j = order[warp]; j < order[warp + 1]; ++j) {
      const int k = order[WARPS + 1 + j];
      const int s = table[5 * k], t = table[5 * k + 1], e = table[5 * k + 2],
                r = table[5 * k + 3], sp = table[5 * k + 4];
      const S4 Lst = strategy_L(c, s, t, e, r, lam, emission, uinf, occluded);
      if (!live) continue;
      reinterpret_cast<float4*>(per_strategy)[(size_t)k * c.R + c.lane] =
          make_float4(Lst.v[0], Lst.v[1], Lst.v[2], Lst.v[3]);
      if (t == 1) {
        const size_t i = (size_t)sp * c.R + c.lane;
        reinterpret_cast<float4*>(splat_L)[i] =
            make_float4(Lst.v[0], Lst.v[1], Lst.v[2], Lst.v[3]);
        splat_pix[i] = splat_pixel(c, e, res_x, res_y);
      }
    }
    __syncthreads();
    if (warp == 0 && live) {
      S4 L = s4(0.f);
      for (int k = 0; k < n_strat; ++k) {
        if (table[5 * k + 1] == 1) continue;
        const float4 x = reinterpret_cast<const float4*>(per_strategy)[(size_t)k * c.R + c.lane];
        L = L + S4{{x.x, x.y, x.z, x.w}};
      }
      reinterpret_cast<float4*>(L_out)[c.lane] = make_float4(L.v[0], L.v[1], L.v[2], L.v[3]);
    }
    if constexpr (STAGED) b ^= n_bufs - 1;
  }
}

// the staged kernel's launch attributes, set once: shared memory past 48 KB
// and the largest shared-memory carveout
int prepare_staged() {
  static bool ready = false;
  if (ready) return 0;
  cudaError_t err = cudaFuncSetAttribute(connect_weight_tile_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MAX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(connect_weight_tile_kernel<true>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  ready = err == cudaSuccess;
  return (int)err;
}

// tile buffers that fit a block's shared memory beside the endpoint rows'
// pointers: 2, 1 or 0 (read in place)
constexpr int tile_buffers(int n_slots, int n_end) {
  return 2 * n_slots * SLOT_BYTES + n_end * NEG * 8 <= MAX_SMEM ? 2
         : n_slots * SLOT_BYTES + n_end * NEG * 8 <= MAX_SMEM   ? 1
                                                                : 0;
}

// the current device's SMs, read once a device
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!sms[dev] &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 132;
  return sms[dev];
}

}  // namespace

// sizes the Python side checks against its own (integrators/bdpt.py)
extern "C" int pbrt_bdpt_layout(int what) {
  switch (what) {
    case 0: return NG;
    case 1: return NEG;
    case 2: return SLOT_BYTES;
    case 3: return WARPS;
    case 4: return STAGED_SLOTS;
    default: return -1;
  }
}

// `fields`: the wave's pointer table on the device, n_slots x NG vertex group
// pointers then the endpoint rows' NEG each
extern "C" int pbrt_bdpt_connect_rays(const unsigned long long* fields, int n_slots,
                                      const float* sc, const float* lt, const int* table,
                                      int n_strat, int n_cam, int R, float* ray_o, float* ray_d,
                                      float* ray_t, unsigned long long* count,
                                      cudaStream_t stream) {
  if (n_slots < 1) return (int)cudaErrorInvalidValue;
  const CtxBase base{sc, lt, n_cam, R, 0, 0};
  const Fields F{fields, fields + (size_t)n_slots * NG};
  // rows of strategies: about 1024 threads an SM in all
  const int rows = min(max((sm_count() * 1024 + R - 1) / R, 1), max(n_strat, 1));
  connect_rays_kernel<<<dim3((R + 127) / 128, rows), 128, 0, stream>>>(
      F, base, table, n_strat, ray_o, ray_d, ray_t, count);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_bdpt_connect_weight(const unsigned long long* fields, int n_slots,
                                        int n_end, const float* sc, const float* lt,
                                        const int* table,
                                        const int* order, int n_strat, int n_cam, int R,
                                        const float* lam, const float* emission,
                                        const float* uinf, const bool* occluded, int res_x,
                                        int res_y, float* L_out, float* splat_L,
                                        long long* splat_pix, float* per_strategy,
                                        cudaStream_t stream) {
  if (n_slots < 1 || n_end < 0) return (int)cudaErrorInvalidValue;
  const CtxBase base{sc, lt, n_cam, R, 0, 0};
  const Fields F{fields, fields + (size_t)n_slots * NG};
  // persistent: one block an SM (126 registers a thread fill its register
  // file), at most one a tile
  const int grid = min((R + TILE - 1) / TILE, sm_count());
  const int bufs = tile_buffers(n_slots, n_end);
  if (bufs) {
    const int err = prepare_staged();
    if (err) return err;
    connect_weight_tile_kernel<true>
        <<<grid, WARPS * 32, bufs * n_slots * SLOT_BYTES + n_end * NEG * 8, stream>>>(
            F, base, n_slots, n_end, bufs, table, order, n_strat, lam, emission, uinf, occluded,
            res_x, res_y, L_out, splat_L, splat_pix, per_strategy);
  } else {
    connect_weight_tile_kernel<false><<<grid, WARPS * 32, 0, stream>>>(
        F, base, n_slots, n_end, 0, table, order, n_strat, lam, emission, uinf, occluded, res_x,
        res_y, L_out, splat_L, splat_pix, per_strategy);
  }
  return (int)cudaGetLastError();
}
