// The yardstick of K12 (csrc/bdpt.cu): its two entry points as first
// written, one thread per lane over a packed (slot, field, lane) float32 copy
// of the walks' vertices and endpoints (integrators/bdpt.py pack_vertices,
// pack_endpoints), every strategy in table order, each vertex field read
// from global memory by every strategy that needs it. Kept unchanged but for
// its names so that chip_smoke.py can hold csrc/bdpt.cu's kernels to its
// bits and time them in turns with it; no render path reaches it.
//   pbrt_bdpt_connect_rays_lane    (bdpt.connect_rays_lane_cuda)
//   pbrt_bdpt_connect_weight_lane  (bdpt.connect_weight_lane_cuda)
#include <cuda_runtime.h>
#include <stdint.h>

#include "bxdf.cuh"

using namespace pbrt_bxdf;

namespace {

// vertex record fields (integrators/bdpt.py _vertex_columns)
constexpr int NF = 50, NSF = 17, LT_F = 10, LAMBDA_MIN = 360, LAMBDA_RANGE = 471;
constexpr int F_VTYPE = 0, F_P = 1, F_NG = 4, F_NS = 7, F_BETA = 10, F_PDF_FWD = 14,
              F_PDF_REV = 15, F_DELTA = 16, F_LIGHT = 17, F_WO = 18, F_KIND = 21, F_REFL = 22,
              F_TRANS = 26, F_ETA_RE = 30, F_ETA_IM = 34, F_ETA = 38, F_AX = 39, F_AY = 40,
              F_FX = 41, F_FY = 44, F_FZ = 47;
// scene constants (bdpt.kernel_tables)
constexpr int S_CFR = 0, S_RFC = 16, S_Z = 32, S_COS_TOTAL = 35, S_A = 36, S_RES = 37,
              S_LENS_AREA = 39, S_LENS_R = 40, S_FOCAL = 41, S_DISK_PDF = 42, S_OFFSET = 43,
              S_INF_DENSITY = 44;
// light table columns
constexpr int L_TYPE = 0, L_PMF = 1, L_TWO = 2, L_AREA = 3, L_SHAPE = 4, L_DIR = 5,
              L_COS_END = 8, L_SCALE = 9;
constexpr int VT_NONE = 0, VT_CAMERA = 1, VT_LIGHT = 2, VT_SURFACE = 3, VT_LIGHT_INF = 4;
constexpr int LIGHT_AREA = 0, LIGHT_DISTANT = 1, LIGHT_UNIFORM_INFINITE = 2, LIGHT_SPOT = 4;
constexpr int K_COATED_DIFFUSE = 4, K_COATED_CONDUCTOR = 5;
// Python constants folded in double precision, then rounded once
constexpr float SHADOW_SHORTEN = (float)(1.0 - 1e-3);
constexpr float UNIFORM_SPHERE_PDF = (float)(1.0 / (4.0 * 3.141592653589793));

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float k) { return {a.x * k, a.y * k, a.z * k}; }

struct Ctx {
  const float* verts;  // (n_cam + n_light, NF, R)
  const float* ends;   // (n_end, NSF, R)
  const float* sc;     // scene constants
  const float* lt;     // (L, LT_F)
  int n_cam, R, lane;
  __device__ float vf(int slot, int f) const {
    return verts[((size_t)slot * NF + f) * R + lane];
  }
  __device__ V3 vf3(int slot, int f) const { return {vf(slot, f), vf(slot, f + 1), vf(slot, f + 2)}; }
  __device__ float ef(int row, int f) const { return ends[((size_t)row * NSF + f) * R + lane]; }
  __device__ V3 ef3(int row, int f) const { return {ef(row, f), ef(row, f + 1), ef(row, f + 2)}; }
  __device__ float light(int li, int f) const { return lt[(size_t)li * LT_F + f]; }
};

// what the connections read of a vertex (its BSDF is read from the record
// where needed); slot -1: a sampled endpoint, whose BSDF is the empty one
struct Vtx {
  int vtype, light, slot;
  V3 p, ng, ns, wo;
  S4 beta;
  float pdf_fwd, pdf_rev;
  bool delta;
};

__device__ Vtx empty_vtx() {
  Vtx v;
  v.vtype = VT_NONE;
  v.light = -1;
  v.slot = -1;
  v.p = {0.f, 0.f, 0.f};
  v.ng = v.ns = {0.f, 0.f, 1.f};
  v.wo = {0.f, 0.f, 0.f};
  v.beta = s4(0.f);
  v.pdf_fwd = v.pdf_rev = 0.f;
  v.delta = false;
  return v;
}

__device__ Vtx load_vtx(const Ctx& c, int slot) {
  Vtx v;
  v.slot = slot;
  v.vtype = (int)c.vf(slot, F_VTYPE);
  v.light = (int)c.vf(slot, F_LIGHT);
  v.p = c.vf3(slot, F_P);
  v.ng = c.vf3(slot, F_NG);
  v.ns = c.vf3(slot, F_NS);
  v.wo = c.vf3(slot, F_WO);
#pragma unroll
  for (int k = 0; k < 4; ++k) v.beta.v[k] = c.vf(slot, F_BETA + k);
  v.pdf_fwd = c.vf(slot, F_PDF_FWD);
  v.pdf_rev = c.vf(slot, F_PDF_REV);
  v.delta = c.vf(slot, F_DELTA) != 0.f;
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
__device__ void load_bsdf(const Ctx& c, int slot, Bxdf& b, V3& fx, V3& fy, V3& fz) {
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
  int kind = (int)c.vf(slot, F_KIND);
  if (kind == K_COATED_DIFFUSE || kind == K_COATED_CONDUCTOR) kind = K_DIFFUSE;
  b.kind = kind;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.refl.v[k] = c.vf(slot, F_REFL + k);
    b.trans.v[k] = c.vf(slot, F_TRANS + k);
    b.eta_re.v[k] = c.vf(slot, F_ETA_RE + k);
    b.eta_im.v[k] = c.vf(slot, F_ETA_IM + k);
  }
  b.eta = c.vf(slot, F_ETA);
  b.ax = c.vf(slot, F_AX);
  b.ay = c.vf(slot, F_AY);
  fx = c.vf3(slot, F_FX);
  fy = c.vf3(slot, F_FY);
  fz = c.vf3(slot, F_FZ);
}

__device__ __forceinline__ V3 to_local(V3 fx, V3 fy, V3 fz, V3 w) {
  return {dot(w, fx), dot(w, fy), dot(w, fz)};
}

// BSDF value at v towards p (bdpt.py _vertex_f); zero for non-surfaces
__device__ S4 vertex_f(const Ctx& c, const Vtx& v, V3 p) {
  float d2;
  const V3 wi = dir_to(v.p, p, d2);
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
__device__ float pdf_we_dir(const Ctx& c, V3 p, V3 d) {
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
__device__ void pdf_le(const Ctx& c, int light, V3 ng, V3 w, float& pos, float& dir) {
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

__device__ __forceinline__ bool is_inf_vertex(const Ctx& c, const Vtx& v) {
  if (v.vtype == VT_LIGHT_INF) return true;
  return v.vtype == VT_LIGHT && v.light >= 0 &&
         (int)c.light(v.light, L_TYPE) == LIGHT_UNIFORM_INFINITE;
}

__device__ __forceinline__ bool is_delta_light(const Ctx& c, const Vtx& v) {
  if (v.vtype != VT_LIGHT || v.light < 0) return false;
  const int type = (int)c.light(v.light, L_TYPE);
  return type == LIGHT_DISTANT || type == LIGHT_SPOT;
}

// directional pdf at v from prev towards nxt, area density at nxt
__device__ float vertex_pdf(const Ctx& c, const Vtx& v, const Vtx& prev, const Vtx& nxt,
                            bool prev_valid) {
  float d2;
  const V3 wn = dir_to(v.p, nxt.p, d2);
  float pdf_dir;
  if (v.vtype == VT_CAMERA) {
    pdf_dir = pdf_we_dir(c, v.p, wn);
  } else if (v.vtype == VT_LIGHT) {
    float pos;
    pdf_le(c, v.light, v.ng, wn, pos, pdf_dir);
  } else {
    const V3 wp = prev_valid ? dir_to(v.p, prev.p, d2) : v.wo;
    Bxdf b;
    V3 fx, fy, fz;
    load_bsdf(c, v.slot, b, fx, fy, fz);
    pdf_dir = bxdf_pdf(b, to_local(fx, fy, fz, wp), to_local(fx, fy, fz, wn), true, true);
  }
  return convert_density(pdf_dir, v.p, nxt);
}

__device__ float vertex_pdf_light(const Ctx& c, const Vtx& v, const Vtx& nxt) {
  float d2;
  const V3 w = dir_to(v.p, nxt.p, d2);
  float pos, dir;
  pdf_le(c, v.light, v.ng, w, pos, dir);
  const float pdf = is_inf_vertex(c, v) ? c.sc[S_DISK_PDF] : dir / fmaxf(d2, 1e-24f);
  return pdf * receiver_cos(nxt, w);
}

__device__ float vertex_pdf_light_origin(const Ctx& c, const Vtx& v, const Vtx& prev) {
  if (is_inf_vertex(c, v)) return c.sc[S_INF_DENSITY];
  const int li = max(v.light, 0);
  const bool is_area = (int)c.light(li, L_TYPE) == LIGHT_AREA;
  float d2;
  const V3 w = dir_to(v.p, prev.p, d2);
  float pos, dir;
  pdf_le(c, v.light, v.ng, w, pos, dir);
  const float pdf_pos = is_area ? 1.f / fmaxf(c.light(li, L_AREA), 1e-12f) : pos;
  const bool ok = c.light(li, L_SHAPE) != 0.f || !is_area;
  return v.light >= 0 && ok ? c.light(li, L_PMF) * pdf_pos : 0.f;
}

__device__ __forceinline__ float remap0(float f) { return f != 0.f ? f : 1.f; }

struct Ratio {  // what the ratio walks read of a vertex
  float pdf_fwd, pdf_rev;
  bool delta, exists;
};

__device__ __forceinline__ Ratio ratio_of(const Vtx& v) {
  return {v.pdf_fwd, v.pdf_rev, v.delta, exists(v)};
}

__device__ __forceinline__ Ratio load_ratio(const Ctx& c, int slot) {
  return {c.vf(slot, F_PDF_FWD), c.vf(slot, F_PDF_REV), c.vf(slot, F_DELTA) != 0.f,
          (int)c.vf(slot, F_VTYPE) != VT_NONE};
}

// bdpt.py _mis_weight; `sampled` is the t = 1 camera or s = 1 light endpoint
__device__ float mis_weight(const Ctx& c, int s, int t, const Vtx* sampled) {
  if (s + t == 2) return 1.f;
  const int L0 = c.n_cam;  // slot of light vertex 0
  Vtx qs = empty_vtx(), qsm = empty_vtx(), ptm = empty_vtx();
  if (s == 1 && sampled) qs = *sampled;
  else if (s > 0) qs = load_vtx(c, L0 + s - 1);
  Vtx pt = (t == 1 && sampled) ? *sampled : load_vtx(c, t - 1);
  if (s > 1) qsm = load_vtx(c, L0 + s - 2);
  if (t > 1) ptm = load_vtx(c, t - 2);

  float pt_rev, ptm_rev = 0.f, qs_rev = 0.f, qsm_rev = 0.f;
  if (s > 0) {
    pt_rev = qs.vtype == VT_LIGHT ? vertex_pdf_light(c, qs, pt)
                                  : vertex_pdf(c, qs, s > 1 ? qsm : qs, pt, s > 1);
  } else {
    pt_rev = vertex_pdf_light_origin(c, pt, ptm);
  }
  if (t > 1) ptm_rev = s > 0 ? vertex_pdf(c, pt, qs, ptm, true) : vertex_pdf_light(c, pt, ptm);
  if (s > 0) {
    qs_rev = vertex_pdf(c, pt, t > 1 ? ptm : pt, qs, t > 1);
    if (s > 1) qsm_rev = vertex_pdf(c, qs, pt, qsm, true);
  }
  pt.pdf_rev = pt_rev;
  ptm.pdf_rev = ptm_rev;
  qs.pdf_rev = qs_rev;
  qsm.pdf_rev = qsm_rev;

  float sum_ri = 0.f, ri = 1.f;
  // camera walk i = t-1 .. 1
  for (int i = t - 1; i >= 1; --i) {
    const Ratio r = i == t - 1 ? ratio_of(pt) : (i == t - 2 ? ratio_of(ptm) : load_ratio(c, i));
    ri = (ri * remap0(r.pdf_rev)) / remap0(r.pdf_fwd);
    bool prev_delta = false;
    if (i - 1 > 0) prev_delta = i - 1 == t - 2 ? ptm.delta : c.vf(i - 1, F_DELTA) != 0.f;
    if (!r.delta && !prev_delta && r.exists) sum_ri = sum_ri + ri;
  }
  // light walk i = s-1 .. 0; i == 0 takes the endpoint's delta-light flag
  ri = 1.f;
  for (int i = s - 1; i >= 0; --i) {
    const Ratio r =
        i == s - 1 ? ratio_of(qs) : (i == s - 2 ? ratio_of(qsm) : load_ratio(c, L0 + i));
    ri = (ri * remap0(r.pdf_rev)) / remap0(r.pdf_fwd);
    bool prev_delta;
    if (i - 1 >= 0) {
      prev_delta = i - 1 == s - 2 ? qsm.delta : c.vf(L0 + i - 1, F_DELTA) != 0.f;
    } else {
      const Vtx v0 = s == 1 ? qs : (s == 2 ? qsm : load_vtx(c, L0));
      prev_delta = is_delta_light(c, v0);
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

__device__ Conn connection(const Ctx& c, int s, int t, int e) {
  Conn out;
  out.has_g = false;
  out.g = 1.f;
  Vtx a;
  V3 p_to;
  if (t == 1) {
    a = load_vtx(c, c.n_cam + s - 1);
    const V3 wi = c.ef3(e, 0);
    const float we = c.ef(e, 3), pdf = c.ef(e, 4);
    p_to = c.ef3(e, 7);
    const S4 f = vertex_f(c, a, p_to);
    const float ns_cos = a.vtype == VT_SURFACE ? fabsf(dot(a.ns, wi)) : 1.f;
    out.L = ((a.beta * f) * (we / fmaxf(pdf, 1e-12f))) * ns_cos;
    out.attempt = connectible(a) && c.ef(e, 10) != 0.f && any_pos(f);
  } else if (s == 1) {
    a = load_vtx(c, t - 1);
    const float pmf = c.ef(e, 1);
    p_to = c.ef3(e, 2);
    const V3 wi = c.ef3(e, 8);
    S4 Lls;
#pragma unroll
    for (int k = 0; k < 4; ++k) Lls.v[k] = c.ef(e, 11 + k);
    const float pdf = c.ef(e, 15);
    const S4 f = vertex_f(c, a, p_to);
    const float cos_pt = a.vtype == VT_SURFACE ? fabsf(dot(a.ns, wi)) : 1.f;
    out.L = (((a.beta * f) * cos_pt) * Lls) / fmaxf(pmf * pdf, 1e-20f);
    out.attempt = connectible(a) && c.ef(e, 16) != 0.f && pdf > 0.f && any_pos(f);
  } else {
    a = load_vtx(c, c.n_cam + s - 1);
    const Vtx b = load_vtx(c, t - 1);
    p_to = b.p;
    const S4 fa = vertex_f(c, a, b.p), fb = vertex_f(c, b, a.p);
    out.attempt = connectible(a) && connectible(b) && any_pos(fa) && any_pos(fb);
    float d2;
    const V3 w = dir_to(a.p, b.p, d2);
    const float cos_a = a.vtype == VT_SURFACE ? fabsf(dot(a.ns, w)) : 1.f;
    const float cos_b = b.vtype == VT_SURFACE ? fabsf(dot(b.ns, w)) : 1.f;
    out.g = (cos_a * cos_b) / fmaxf(d2, 1e-24f);
    out.has_g = true;
    out.L = ((a.beta * fa) * fb) * b.beta;
  }
  // the shadow ray leaves the sending vertex (geometry/ray.py offset_ray_origin)
  float d2;
  const V3 w = dir_to(a.p, p_to, d2);
  const float mag = fmaxf(fmaxf(fabsf(a.p.x), fabsf(a.p.y)), fabsf(a.p.z));
  const float eps = c.sc[S_OFFSET] * fmaxf(mag, 1.f);
  const V3 n_off = dot(a.ng, w) < 0.f ? neg(a.ng) : a.ng;
  out.o = add(a.p, scale(n_off, eps));
  out.d = w;
  out.t_max = out.attempt ? sqrtf(fmaxf(d2, 1e-24f)) * SHADOW_SHORTEN : 0.f;
  return out;
}

__device__ __forceinline__ int lam_bin(float lam) {
  return min(max(__float2int_rn(lam) - LAMBDA_MIN, 0), LAMBDA_RANGE - 1);
}

// L of strategy (0, t) before its weight (bdpt.py _emitted)
__device__ S4 emitted(const Ctx& c, int t, const float* lam, const float* emission,
                      const float* uinf) {
  const Vtx pt = load_vtx(c, t - 1);
  const Vtx prev = load_vtx(c, t - 2);
  float d2;
  const V3 w_out = dir_to(pt.p, prev.p, d2);
  S4 Le = s4(0.f);
  const int li = max(pt.light, 0);
  if (pt.vtype == VT_LIGHT_INF) {
#pragma unroll
    for (int k = 0; k < 4; ++k) Le.v[k] = uinf[lam_bin(lam[4 * c.lane + k])];
  } else if (pt.light >= 0 && (dot(pt.ng, w_out) > 0.f || c.light(li, L_TWO) != 0.f)) {
    const float sc = c.light(li, L_SCALE);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      Le.v[k] = emission[(size_t)li * LAMBDA_RANGE + lam_bin(lam[4 * c.lane + k])] * sc;
  }
  const bool ok = exists(pt) && (pt.light >= 0 || pt.vtype == VT_LIGHT_INF);
  return ok ? pt.beta * Le : s4(0.f);
}

// the sampled endpoint of a t = 1 (camera) or s = 1 (light) strategy
__device__ Vtx sampled_vertex(const Ctx& c, int s, int t, int e) {
  Vtx v = empty_vtx();
  if (t == 1) {
    v.vtype = VT_CAMERA;
    v.p = c.ef3(e, 7);
    v.beta = s4(c.ef(e, 3) / fmaxf(c.ef(e, 4), 1e-12f));
    v.pdf_fwd = 1.f;
  } else {
    v.vtype = VT_LIGHT;
    v.light = (int)c.ef(e, 0);
    v.p = c.ef3(e, 2);
    v.ng = v.ns = c.ef3(e, 5);
    const Vtx pt = load_vtx(c, t - 1);
    v.pdf_fwd = vertex_pdf_light_origin(c, v, pt);
  }
  return v;
}

__global__ void __launch_bounds__(128)
connect_rays_lane_kernel(Ctx c, const int* table, int n_strat, float* ray_o, float* ray_d,
                         float* ray_t, unsigned long long* count) {
  c.lane = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned int n = 0;
  if (c.lane < c.R) {
    for (int k = 0; k < n_strat; ++k) {
      const int s = table[5 * k], t = table[5 * k + 1], e = table[5 * k + 2],
                r = table[5 * k + 3];
      if (s == 0) continue;
      const Conn cn = connection(c, s, t, e);
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
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(count, (unsigned long long)n);
}

__global__ void __launch_bounds__(128)
connect_weight_lane_kernel(Ctx c, const int* table, int n_strat, const float* lam,
                           const float* emission, const float* uinf, const bool* occluded,
                           int res_x, int res_y, float* L_out, float* splat_L,
                           long long* splat_pix, float* per_strategy) {
  c.lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (c.lane >= c.R) return;
  S4 L = s4(0.f);
  for (int k = 0; k < n_strat; ++k) {
    const int s = table[5 * k], t = table[5 * k + 1], e = table[5 * k + 2],
              r = table[5 * k + 3], sp = table[5 * k + 4];
    S4 Lst;
    if (s == 0) {
      Lst = emitted(c, t, lam, emission, uinf) * mis_weight(c, s, t, nullptr);
    } else {
      const Conn cn = connection(c, s, t, e);
      const float vis = occluded[(size_t)r * c.R + c.lane] ? 0.f : 1.f;
      Lst = cn.has_g ? cn.L * (cn.g * vis) : cn.L * vis;
      if (!cn.attempt) Lst = s4(0.f);
      float w;
      if (s == 1 || t == 1) {
        const Vtx v = sampled_vertex(c, s, t, e);
        w = mis_weight(c, s, t, &v);
      } else {
        w = mis_weight(c, s, t, nullptr);
      }
      Lst = Lst * w;
    }
    if (per_strategy) {
      const size_t i = ((size_t)k * c.R + c.lane) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) per_strategy[i + q] = Lst.v[q];
    }
    if (t == 1) {
      const size_t i = (size_t)sp * c.R + c.lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) splat_L[4 * i + q] = Lst.v[q];
      // raster -> pixel: truncation toward zero, then clamped
      const int px = min(max((int)c.ef(e, 5), 0), res_x - 1);
      const int py = min(max((int)c.ef(e, 6), 0), res_y - 1);
      splat_pix[i] = (long long)py * res_x + px;
    } else {
      L = L + Lst;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) L_out[4 * c.lane + q] = L.v[q];
}

}  // namespace

extern "C" int pbrt_bdpt_connect_rays_lane(const float* verts, const float* ends,
                                           const float* sc, const float* lt, const int* table,
                                           int n_strat, int n_cam, int n_light, int R,
                                           float* ray_o, float* ray_d, float* ray_t,
                                           unsigned long long* count, cudaStream_t stream) {
  (void)n_light;
  Ctx c{verts, ends, sc, lt, n_cam, R, 0};
  connect_rays_lane_kernel<<<(R + 127) / 128, 128, 0, stream>>>(c, table, n_strat, ray_o,
                                                                ray_d, ray_t, count);
  return (int)cudaGetLastError();
}

extern "C" int pbrt_bdpt_connect_weight_lane(const float* verts, const float* ends,
                                             const float* sc, const float* lt, const int* table,
                                             int n_strat, int n_cam, int n_light, int R,
                                             const float* lam, const float* emission,
                                             const float* uinf, const bool* occluded, int res_x,
                                             int res_y, float* L_out, float* splat_L,
                                             long long* splat_pix, float* per_strategy,
                                             cudaStream_t stream) {
  (void)n_light;
  Ctx c{verts, ends, sc, lt, n_cam, R, 0};
  connect_weight_lane_kernel<<<(R + 127) / 128, 128, 0, stream>>>(
      c, table, n_strat, lam, emission, uinf, occluded, res_x, res_y, L_out, splat_L, splat_pix,
      per_strategy);
  return (int)cudaGetLastError();
}
