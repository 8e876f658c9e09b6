"""Bidirectional path tracing (counterpart of pbrt_tpu/integrators/bdpt.py;
reference integrators/bdpt.cu, pbrt-v4's BDPT).

Camera and light subpaths are random walks over dense lane batches, one
Python step per bounce around `dispatch.intersect` (K1 or K3/K4), with
vertices kept as SoA records, one `V` per slot. The (s, t) strategies then
connect them. On CPU tensors each strategy runs in plain torch: `connect`
and `_mis_weight`, which recompute the four junction pdf_revs per strategy
as the JAX package does. On CUDA tensors the whole strategy table of a wave
runs in the hand-written kernel csrc/bdpt.cu (K12), which reads the walks'
own tensors through a table of their addresses (FieldTable): one entry
point forms every strategy's shadow ray, one `dispatch.occluded` call
traces them all, and a second entry point forms L and the MIS weights. The
sampler draws of the s = 1 (light pick, sample_li) and t = 1 (lens sample)
strategies come first, in plain torch, in the loop order of JAX's
`li_bdpt`, so the streams stay bit-exact with the JAX package's.

Strategies (connect_bdpt, bdpt.cu:612-721): s = 0 the camera path hits an
emitter or escapes (escaped rays become VT_LIGHT_INF vertices at 4 scene
radii); t = 1 a light vertex seen by a sampled lens point, splatted to the
film; s = 1 a camera vertex connected to a sampled light point; s, t > 1 a
vertex-to-vertex connection with G and visibility. Coated (layered) vertices
are walked with their full layered BSDF but connected through their bottom
diffuse lobe, as in the JAX package.

Media (bdpt.cu:431-472, as the JAX package has them): on a scene with
homogeneous media each walk segment crosses up to 4 material-less
interfaces (without attenuation) and, in a medium, draws an exponential
distance against the average sigma_t at every leg; a scatter makes a
VT_MEDIUM vertex (no normal, beta *= sigma_s / sigma_t, the HG phase
function as its f and pdf, no cosine in its density conversions) and the
walk goes on by an HG sample. Camera subpaths start in the camera's medium,
light subpaths in their light's. A connection's segment carries its
transmittance (path.transmittance, K6t's hop loop) from the sending
vertex's medium on the segment's side (`_conn_medium`) in place of the
visibility bit.

Textures (JAX bdpt.py:370-371): a walk vertex's BSDF takes its mix choice
and textured slots from textures.eval_lanes, a launch of K13 (csrc/
texture.cu) a walk step on the card; the vertex caches the BSDF (`bx`), so
K12 reads the textured values as it reads every other.
"""
import ctypes
from typing import NamedTuple

import torch

from pbrt_tpu_torch.accel import dispatch
from pbrt_tpu_torch.cameras import perspective
from pbrt_tpu_torch.geometry.ray import offset_ray_origin
from pbrt_tpu_torch.integrators import path as path_integrator
from pbrt_tpu_torch.integrators.path import _pick_light
from pbrt_tpu_torch.lights import lights
from pbrt_tpu_torch.materials import bxdfs, materials
from pbrt_tpu_torch.sampling import samplers, warps
from pbrt_tpu_torch.scene import builder as bd
from pbrt_tpu_torch.spectral import spectra
from pbrt_tpu_torch.textures import textures as texlib
from pbrt_tpu_torch.utils.math import INFINITY

VT_NONE = 0
VT_CAMERA = 1
VT_LIGHT = 2
VT_SURFACE = 3
VT_LIGHT_INF = 4   # escaped camera ray captured as an infinite-light vertex
VT_MEDIUM = 5      # a scatter in a medium (f and pdf the HG phase function)
# the material-less interfaces a walk segment crosses (JAX bdpt.py _walk)
WALK_HOPS = 4

# launches of the two K12 entry points and of their yardsticks, which only
# chip_smoke.py reaches (plain ints, added to where they launch)
launches = {"bdpt_connect_rays": 0, "bdpt_connect_weight": 0, "bdpt_connect_rays_lane": 0,
            "bdpt_connect_weight_lane": 0}


class V(NamedTuple):
    """One vertex slot, SoA over lanes (bdpt.h Vertex)."""

    vtype: torch.Tensor    # (R,) i32
    p: torch.Tensor        # (R,3)
    ng: torch.Tensor       # (R,3)
    ns: torch.Tensor       # (R,3)
    beta: torch.Tensor     # (R,4)
    pdf_fwd: torch.Tensor  # (R,) area density from the previous vertex
    pdf_rev: torch.Tensor  # (R,) area density from the next vertex
    delta: torch.Tensor    # (R,) bool: specular scattering
    light: torch.Tensor    # (R,) i64 light of an emitter or endpoint, -1 none
    mat: torch.Tensor      # (R,) i64 material of a surface vertex, -1 none
    wo: torch.Tensor       # (R,3) towards the previous vertex
    bx: bxdfs.BxdfParams   # the BSDF built by the walk (connections reuse it)
    fx: torch.Tensor       # (R,3) shading frame
    fy: torch.Tensor
    fz: torch.Tensor
    med: torch.Tensor      # (R,) i64 medium of the arriving segment (-1 none)
    med_in: torch.Tensor   # (R,) i64 the surface's inside and outside media
    med_out: torch.Tensor


def _axis(R, dev, i):
    v = torch.zeros((R, 3), device=dev)
    v[:, i] = 1.0
    return v


def _empty_vertex(R, dev):
    zero_bx = bxdfs.BxdfParams(
        kind=torch.zeros((R,), dtype=torch.int64, device=dev),
        refl=torch.zeros((R, 4), device=dev), trans=torch.zeros((R, 4), device=dev),
        eta_re=torch.ones((R, 4), device=dev), eta_im=torch.zeros((R, 4), device=dev),
        eta=torch.ones((R,), device=dev), ax=torch.full((R,), 1e-4, device=dev),
        ay=torch.full((R,), 1e-4, device=dev))
    return V(vtype=torch.zeros((R,), dtype=torch.int32, device=dev),
             p=torch.zeros((R, 3), device=dev), ng=_axis(R, dev, 2), ns=_axis(R, dev, 2),
             beta=torch.zeros((R, 4), device=dev),
             pdf_fwd=torch.zeros((R,), device=dev), pdf_rev=torch.zeros((R,), device=dev),
             delta=torch.zeros((R,), dtype=torch.bool, device=dev),
             light=torch.full((R,), -1, dtype=torch.int64, device=dev),
             mat=torch.full((R,), -1, dtype=torch.int64, device=dev),
             wo=torch.zeros((R, 3), device=dev), bx=zero_bx,
             fx=_axis(R, dev, 0), fy=_axis(R, dev, 1), fz=_axis(R, dev, 2),
             med=torch.full((R,), -1, dtype=torch.int64, device=dev),
             med_in=torch.full((R,), -1, dtype=torch.int64, device=dev),
             med_out=torch.full((R,), -1, dtype=torch.int64, device=dev))


# ------------------------------------------------------- vertex helpers
# 3-term dot products are spelled (x + y) + z, the order of csrc/bdpt.cu


_dot = path_integrator.dot3


def _absdot(a, b):
    return torch.abs(_dot(a, b))


def _exists(v: V):
    return v.vtype != VT_NONE


def _is_connectible(v: V):
    return _exists(v) & ~v.delta


def _dir_to(a_p, b_p):
    d = b_p - a_p
    dist2 = _dot(d, d)
    return d / torch.sqrt(torch.clamp(dist2, min=1e-24))[..., None], dist2


def _receiver_cos(to: V, w):
    """|cos| at the receiving vertex; endpoints without geometry take 1."""
    cos = _absdot(to.ng, w)
    return torch.where(to.vtype == VT_SURFACE, cos, torch.clamp(cos, min=1.0))


def _convert_density(pdf_dir, from_p, to: V):
    """Solid-angle pdf at from_p towards `to` -> area density at `to`
    (bdpt.h convert_density)."""
    w, dist2 = _dir_to(from_p, to.p)
    return pdf_dir * _receiver_cos(to, w) / torch.clamp(dist2, min=1e-24)


def _to_local(v: V, w):
    return torch.stack([_dot(w, v.fx), _dot(w, v.fy), _dot(w, v.fz)], dim=-1)


def _cheap_params(bx: bxdfs.BxdfParams):
    """Coated kinds read as their bottom diffuse lobe in connections (the
    layered walk is too heavy to retrace per strategy)."""
    return bx._replace(kind=torch.where(materials.is_coated(bx.kind), bxdfs.K_DIFFUSE, bx.kind))


def _hg(scene, v: V, cos):
    """The HG phase function of v's medium at cos."""
    return warps.henyey_greenstein(cos, scene.med_g[torch.clamp(v.med, min=0)])


def _vertex_f(scene, v: V, to_p):
    """BSDF value at v towards the point to_p (bdpt.h Vertex::f), the HG
    phase function at a medium vertex; zero for endpoints."""
    wi, _ = _dir_to(v.p, to_p)
    f = bxdfs.f(_cheap_params(v.bx), _to_local(v, v.wo), _to_local(v, wi))
    if scene.med_g.shape[0] > 0:
        f = torch.where((v.vtype == VT_MEDIUM)[..., None], _hg(scene, v, _dot(v.wo, wi))[..., None],
                        f)
        return torch.where(((v.vtype == VT_SURFACE) | (v.vtype == VT_MEDIUM))[..., None], f, 0.0)
    return torch.where((v.vtype == VT_SURFACE)[..., None], f, 0.0)


def _light_type(scene, v: V):
    return scene.lt_type[torch.clamp(v.light, min=0)]


def _is_inf_vertex(scene, v: V):
    """Escaped-ray vertices and light endpoints of infinite lights."""
    lt = _light_type(scene, v)
    return (v.vtype == VT_LIGHT_INF) | (
        (v.vtype == VT_LIGHT) & (v.light >= 0) & (lt == bd.LIGHT_UNIFORM_INFINITE))


def _is_delta_light_v(scene, v: V):
    """Light endpoints of delta lights (distant direction, spot position)."""
    lt = _light_type(scene, v)
    return (v.vtype == VT_LIGHT) & (v.light >= 0) & (
        (lt == bd.LIGHT_DISTANT) | (lt == bd.LIGHT_SPOT))


def _vertex_pdf(scene, v: V, prev: V, nxt: V, prev_valid: bool):
    """Directional pdf at v from prev towards nxt, as an area density at nxt
    (bdpt.h Vertex::pdf): the camera's pdf_we, a light's pdf_le, or the
    vertex's BSDF."""
    wn, _ = _dir_to(v.p, nxt.p)
    wp_eff = _dir_to(v.p, prev.p)[0] if prev_valid else v.wo
    pdf_surf = bxdfs.pdf(_cheap_params(v.bx), _to_local(v, wp_eff), _to_local(v, wn))
    if scene.med_g.shape[0] > 0:
        pdf_surf = torch.where(v.vtype == VT_MEDIUM, _hg(scene, v, _dot(wp_eff, wn)), pdf_surf)
    _, pdf_cam = perspective.pdf_we(scene, v.p, wn)
    _, pdf_light = lights.pdf_le(scene, v.light, v.ng, wn)
    pdf_dir = torch.where(v.vtype == VT_CAMERA, pdf_cam,
                          torch.where(v.vtype == VT_LIGHT, pdf_light, pdf_surf))
    return _convert_density(pdf_dir, v.p, nxt)


def _vertex_pdf_light(scene, v: V, nxt: V):
    """Density of light vertex v emitting towards nxt, area measure at nxt
    (bdpt.cu:79-122); infinite lights use the bounding-disk density."""
    w, dist2 = _dir_to(v.p, nxt.p)
    _, pdf_dir = lights.pdf_le(scene, v.light, v.ng, w)
    pdf = torch.where(_is_inf_vertex(scene, v), lights._disk_pdf(scene),
                      pdf_dir / torch.clamp(dist2, min=1e-24))
    return pdf * _receiver_cos(nxt, w)


def _vertex_pdf_light_origin(scene, v: V, prev: V):
    """pmf(light) times the positional density of v; infinite vertices use
    the escape-direction density (bdpt.cu:212-240)."""
    li = torch.clamp(v.light, min=0)
    is_area = scene.lt_type[li] == bd.LIGHT_AREA
    _, _, area, ok = lights._area_shape_sample(
        scene, v.light, torch.full(v.p.shape[:-1] + (2,), 0.5, device=v.p.device))
    w, _ = _dir_to(v.p, prev.p)
    pdf_pos_other, _ = lights.pdf_le(scene, v.light, v.ng, w)
    pdf_pos = torch.where(is_area, 1.0 / torch.clamp(area, min=1e-12), pdf_pos_other)
    base = torch.where((v.light >= 0) & (ok | ~is_area), scene.lt_pmf[li] * pdf_pos, 0.0)
    return torch.where(_is_inf_vertex(scene, v), lights.infinite_light_density(scene, -w), base)


def _remap0(f):
    return torch.where(f != 0.0, f, 1.0)


# ---------------------------------------------------------------- walks


def _select_hit(keep, a: dispatch.SceneHit, b: dispatch.SceneHit):
    """a where `keep`, else b, field by field."""
    return dispatch.SceneHit(*(torch.where(keep.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
                               for x, y in zip(a, b)))


def _walk_hops(scene, meta, cur_o, cur_d, active, medium, beta, wl, smp, skind, spp):
    """A walk segment on a scene with media (JAX bdpt.py:316-364): up to
    WALK_HOPS legs, each a closest hit; in a medium a leg draws an
    exponential distance against the average sigma_t and scatters where it
    falls short of the hit (beta *= sigma_s / sigma_t); a material-less
    interface is crossed without attenuation into the medium beyond. ->
    (the segment's last hit, scattered (R,) bool, the scatter point, its
    medium, beta, sampler)."""
    scat = torch.zeros_like(active)
    p_scat, o_h, med_h, done, hit = cur_o, cur_o, medium, ~active, None
    for _ in range(WALK_HOPS):
        h = dispatch.intersect(scene, meta, o_h, cur_d, torch.where(done, 0.0, INFINITY))
        seg = torch.where(h.valid, h.t, INFINITY)
        in_med = ~done & (med_h >= 0)
        smp, u = samplers.get_1d(smp, in_med, skind, spp)
        m = torch.clamp(med_h, min=0)
        sig_s = spectra.sample_table(scene.med_sigma_s, m, wl.lam)
        sig_t = spectra.sample_table(scene.med_sigma_a, m, wl.lam) + sig_s
        t_samp = path_integrator.distance_draw(u, sig_t)
        now = in_med & (t_samp < seg)
        beta = torch.where(now[..., None], beta * sig_s / torch.clamp(sig_t, min=1e-12), beta)
        p_scat = torch.where(now[..., None], o_h + t_samp[..., None] * cur_d, p_scat)
        scat = scat | now
        hit = h if hit is None else _select_hit(done, hit, h)
        iface = h.valid & (h.mat < 0) & ~done & ~now
        o_h = torch.where(iface[..., None],
                          offset_ray_origin(h.p, h.ng, cur_d, scene.ray_offset_scale), o_h)
        med_h = torch.where(iface, path_integrator.medium_after(h, cur_d, med_h), med_h)
        done = done | ~iface | now
    return hit, scat, p_scat, med_h, beta, smp


def _walk(scene, meta, o, d, beta0, pdf_dir0, wl, smp, skind, spp, n_steps, mode_radiance,
          medium0=None):
    """Random walk of n_steps bounces (bdpt.cu:394-520 random_walk) ->
    (vertices [V] * n_steps, the first step's reverse directional pdf,
    sampler, closest-hit rays traced (0-dim int64): a segment counts once,
    whatever interfaces it crosses, as in the JAX package). Both walks
    sample the BSDF in radiance mode, as the JAX package does. medium0 (R,)
    int64: the media the walk starts in (None: vacuum)."""
    R, dev = o.shape[0], o.device
    media = path_integrator.has_media(scene)
    beta, pdf_fwd_dir = beta0, pdf_dir0
    active = torch.any(beta0 > 0, dim=-1) & (pdf_dir0 > 0)
    prev_p, cur_o, cur_d = o, o, d
    none = torch.full((R,), -1, dtype=torch.int64, device=dev)
    medium = none if medium0 is None else medium0
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    verts, rev_dirs = [], []
    for _ in range(n_steps):
        n_rays = n_rays + active.sum()
        if media:
            hit, scat, p_scat, medium, beta, smp = _walk_hops(
                scene, meta, cur_o, cur_d, active, medium, beta, wl, smp, skind, spp)
        else:
            hit = dispatch.intersect(scene, meta, cur_o, cur_d,
                                     torch.where(active, INFINITY, 0.0))
            scat = torch.zeros_like(active)
        found = active & ~scat & hit.valid & (hit.mat >= 0)
        esc_v = active & ~scat & ~hit.valid & mode_radiance
        # a textured scene's mix choice and textured slots (JAX
        # bdpt.py:370-371): K13 on the card, once a walk step
        tex = (texlib.eval_lanes(scene, found, hit.mat, hit.p, hit.wo, hit.uv, hit.ns, wl.lam)
               if meta.textured else None)
        b_full, _ = materials.make_bsdf(scene, hit.mat if tex is None else tex.mat, hit.ns, wl,
                                        meta.layered, tex=tex)
        s3 = scat[..., None]
        v_p = torch.where(s3, p_scat, hit.p) if media else hit.p
        w_in, dist2 = _dir_to(prev_p, v_p)
        cos = _absdot(hit.ng, w_in)
        if media:
            cos = torch.where(scat, 1.0, cos)
        pdf_fwd = torch.where(found | scat, pdf_fwd_dir * cos / torch.clamp(dist2, min=1e-24), 0.0)
        smp, uc = samplers.get_1d(smp, found, skind, spp)
        smp, u2 = samplers.get_2d(smp, found, skind, spp)
        bs = materials.bsdf_sample(b_full, hit.wo, uc, u2)
        pdf_dir_mis = materials.mis_direction_pdf(b_full, hit.wo, bs)
        spec = bxdfs.is_specular(bs.flags)
        if media:
            # the HG continuation (bdpt.cu:456-466): beta unchanged, the
            # reverse density the forward one
            smp, u_ph = samplers.get_2d(smp, scat, skind, spp)
            wi_med, pdf_med = warps.sample_henyey_greenstein(
                -cur_d, scene.med_g[torch.clamp(medium, min=0)], u_ph)
        beta_next = beta * bs.f * (_absdot(bs.wi, hit.ns)
                                   / torch.clamp(bs.pdf, min=1e-20))[..., None]
        cont = found & bs.valid & torch.any(beta_next > 0, dim=-1)
        # reverse directional pdf towards the previous vertex (diffuse lobe
        # for coated lanes)
        b_cheap = materials.Bsdf(_cheap_params(b_full.params), b_full.fx, b_full.fy, b_full.fz)
        rev_dir = torch.where(spec, 0.0, materials.bsdf_pdf(b_cheap, bs.wi, hit.wo))
        rev_dirs.append(torch.where(scat, pdf_med, rev_dir) if media else rev_dir)

        e3 = esc_v[..., None]
        ng = torch.where(e3, -cur_d, hit.ng)
        ns = torch.where(e3, -cur_d, hit.ns)
        if media:
            ng, ns = torch.where(s3, 0.0, ng), torch.where(s3, 0.0, ns)
        verts.append(V(
            vtype=torch.where(found, VT_SURFACE, torch.where(
                scat, VT_MEDIUM, torch.where(esc_v, VT_LIGHT_INF, VT_NONE))).to(torch.int32),
            p=torch.where(e3, cur_o + cur_d * (4.0 * scene.scene_radius), v_p), ng=ng, ns=ns,
            beta=torch.where((found | esc_v | scat)[..., None], beta, 0.0),
            pdf_fwd=torch.where(esc_v, pdf_fwd_dir, pdf_fwd),
            pdf_rev=torch.zeros((R,), device=dev), delta=found & spec,
            light=torch.where(found, hit.light, -1), mat=torch.where(found, hit.mat, -1),
            wo=torch.where((esc_v | scat)[..., None], -cur_d, hit.wo), bx=b_full.params,
            fx=b_full.fx, fy=b_full.fy, fz=b_full.fz,
            med=torch.where(found | scat, medium, -1), med_in=torch.where(found, hit.med_in, -1),
            med_out=torch.where(found, hit.med_out, -1)))

        beta = torch.where(cont[..., None], beta_next, beta)
        pdf_fwd_dir = torch.where(spec, 0.0, pdf_dir_mis)
        new_o = offset_ray_origin(hit.p, hit.ng, bs.wi, scene.ray_offset_scale)
        if media:
            pdf_fwd_dir = torch.where(scat, pdf_med, pdf_fwd_dir)
            medium = torch.where(cont, path_integrator.medium_after(hit, bs.wi, medium), medium)
            cont = cont | (scat & (pdf_med > 0.0))
            new_o = torch.where(s3, p_scat, new_o)
            cur_d = torch.where(s3, wi_med, bs.wi)
        else:
            cur_d = bs.wi
        active = cont
        prev_p = v_p
        cur_o = new_o

    # slot i's pdf_rev: slot i+1's reverse directional pdf as an area density
    for i in range(n_steps - 1):
        cur, nxt = verts[i], verts[i + 1]
        w = cur.p - nxt.p
        dist2 = _dot(w, w)
        w = w / torch.sqrt(torch.clamp(dist2, min=1e-24))[..., None]
        cos = torch.where(cur.vtype == VT_SURFACE, _absdot(cur.ng, w), 1.0)
        verts[i] = cur._replace(pdf_rev=torch.where(
            (nxt.vtype == VT_SURFACE) | (nxt.vtype == VT_MEDIUM),
            rev_dirs[i + 1] * cos / torch.clamp(dist2, min=1e-24), 0.0))
    ep_rev = rev_dirs[0] if n_steps else torch.zeros((R,), device=dev)
    return verts, ep_rev, smp, n_rays


def camera_path(scene, meta, p_film, smp, wl, skind, spp):
    """Camera subpath: the camera vertex and max_depth + 1 walk slots (no
    lens draw: the camera vertex is the lens center) -> (vertices, sampler,
    rays traced)."""
    R, dev = p_film.shape[0], p_film.device
    rays = perspective.generate_rays(scene, p_film, torch.zeros((R, 2), device=dev))
    med0 = scene.camera_medium.long().expand(R).contiguous()
    cam_v = _empty_vertex(R, dev)._replace(
        vtype=torch.full((R,), VT_CAMERA, dtype=torch.int32, device=dev), p=rays.o,
        beta=torch.ones((R, 4), device=dev), pdf_fwd=torch.ones((R,), device=dev), med=med0)
    _, pdf_dir = perspective.pdf_we(scene, rays.o, rays.d)
    surf, ep_rev, smp, n_rays = _walk(scene, meta, rays.o, rays.d, torch.ones((R, 4), device=dev),
                                      pdf_dir, wl, smp, skind, spp, meta.max_depth + 1, True,
                                      med0)
    _, dist2 = _dir_to(surf[0].p, cam_v.p)
    cam_v = cam_v._replace(pdf_rev=torch.where(
        _exists(surf[0]), ep_rev / torch.clamp(dist2, min=1e-24), 0.0))
    return [cam_v] + surf, smp, n_rays


def light_path(scene, meta, smp, wl, skind, spp):
    """Light subpath: the light vertex (any light type, through sample_le)
    and max_depth walk slots (bdpt.cu:531-610) -> (vertices, sampler, rays
    traced)."""
    smp, u_pick = samplers.get_1d(smp, None, skind, spp)
    li, pmf = _pick_light(scene, u_pick)
    smp, u_pos = samplers.get_2d(smp, None, skind, spp)
    smp, u_dir = samplers.get_2d(smp, None, skind, spp)
    Le, p, ng, w, pdf_pos, pdf_dir, ok = lights.sample_le(scene, li, u_pos, u_dir, wl.lam)
    R, dev = p.shape[0], p.device
    is_inf = scene.lt_type[li] == bd.LIGHT_UNIFORM_INFINITE
    # infinite starts: v0's density is the escape-direction density
    pdf_fwd0 = torch.where(is_inf, lights.infinite_light_density(scene, -w), pmf * pdf_pos)
    light_v = _empty_vertex(R, dev)._replace(
        vtype=torch.where(ok, VT_LIGHT, VT_NONE).to(torch.int32), p=p, ng=ng, ns=ng,
        beta=torch.where(ok[..., None], Le / torch.clamp(pmf * pdf_pos, min=1e-20)[..., None], 0.0),
        pdf_fwd=torch.where(ok, pdf_fwd0, 0.0), light=torch.where(ok, li, -1))
    beta0 = Le * _absdot(ng, w)[..., None] / torch.clamp(pmf * pdf_pos * pdf_dir,
                                                          min=1e-20)[..., None]
    beta0 = torch.where(ok[..., None], beta0, 0.0)
    o = offset_ray_origin(p, ng, w, scene.ray_offset_scale)
    surf, ep_rev, smp, n_rays = _walk(scene, meta, o, w, beta0, torch.where(ok, pdf_dir, 0.0),
                                      wl, smp, skind, spp, meta.max_depth, False,
                                      scene.lt_medium[li].long())
    if surf:
        first = surf[0]
        w_b, dist2 = _dir_to(first.p, light_v.p)
        light_v = light_v._replace(pdf_rev=torch.where(
            _exists(first), ep_rev * _absdot(light_v.ng, w_b) / torch.clamp(dist2, min=1e-24),
            0.0))
        # infinite starts: v1's density is planar, pdf_pos |cos|
        surf[0] = first._replace(pdf_fwd=torch.where(
            is_inf & _exists(first), pdf_pos * _absdot(w, first.ng), first.pdf_fwd))
    return [light_v] + surf, smp, n_rays


# ------------------------------------------------- strategies and endpoints


def strategies(n_cam, n_light, max_depth):
    """The (s, t) strategies of li_bdpt, in its loop order (t outer, s
    inner): depth s + t - 2 in [0, max_depth], without (1, 1) and without
    t = 1, s < 2."""
    out = []
    for t in range(1, n_cam + 1):
        for s in range(0, n_light + 1):
            depth = s + t - 2
            if (s == 1 and t == 1) or depth < 0 or depth > max_depth or (t == 1 and s < 2):
                continue
            out.append((s, t))
    return out


class CameraSample(NamedTuple):
    """A lens point sampled from a light vertex (t = 1)."""

    wi: torch.Tensor      # (R,3) towards the lens
    we: torch.Tensor      # (R,)
    pdf: torch.Tensor     # (R,)
    raster: torch.Tensor  # (R,2)
    p_lens: torch.Tensor  # (R,3)
    valid: torch.Tensor   # (R,)


class LightSample(NamedTuple):
    """A light point sampled from a camera vertex (s = 1)."""

    light: torch.Tensor   # (R,) i64
    pmf: torch.Tensor     # (R,)
    ls: lights.LightLiSample


def sample_endpoints(scene, light_vs, cam_vs, table, smp, wl, skind, spp):
    """The sampler draws of the t = 1 (lens) and s = 1 (light pick, then
    sample_li) strategies, in the table's order -> ({(s, t): CameraSample or
    LightSample}, sampler)."""
    out = {}
    for s, t in table:
        if t == 1:
            smp, u_lens = samplers.get_2d(smp, None, skind, spp)
            out[(s, t)] = CameraSample(*perspective.sample_wi(scene, light_vs[s - 1].p, u_lens))
        elif s == 1:
            pt = cam_vs[t - 1]
            smp, u_pick = samplers.get_1d(smp, None, skind, spp)
            li, pmf = _pick_light(scene, u_pick)
            smp, u2 = samplers.get_2d(smp, None, skind, spp)
            out[(s, t)] = LightSample(li, pmf, lights.sample_li(scene, li, pt.p, pt.ns, u2, wl.lam))
    return out, smp


def _sampled_vertex(scene, s, t, sample, cam_vs):
    """The sampled endpoint of a t = 1 or s = 1 strategy as a vertex."""
    R, dev = sample.pmf.shape[0] if s == 1 else sample.we.shape[0], cam_vs[0].p.device
    if t == 1:
        return _empty_vertex(R, dev)._replace(
            vtype=torch.full((R,), VT_CAMERA, dtype=torch.int32, device=dev), p=sample.p_lens,
            beta=(sample.we / torch.clamp(sample.pdf, min=1e-12))[..., None]
            * torch.ones((R, 4), device=dev),
            pdf_fwd=torch.ones((R,), device=dev))
    ls = sample.ls
    v = _empty_vertex(R, dev)._replace(
        vtype=torch.full((R,), VT_LIGHT, dtype=torch.int32, device=dev), p=ls.p_light,
        ng=ls.n_light, ns=ls.n_light,
        beta=ls.L / torch.clamp(sample.pmf * ls.pdf, min=1e-20)[..., None], light=sample.light)
    return v._replace(pdf_fwd=_vertex_pdf_light_origin(scene, v, cam_vs[t - 1]))


# ---------------------------------------------------------------- MIS


def _mis_weight(scene, light_vs, cam_vs, s, t, sampled_v=None):
    """MIS weight of strategy (s, t) (bdpt.cu:288-380): the junction
    pdf_revs recomputed, then the pdf-ratio walks of both subpaths."""
    R, dev = cam_vs[0].p.shape[0], cam_vs[0].p.device
    if s + t == 2:
        return torch.ones((R,), device=dev)
    qs = sampled_v if s == 1 and sampled_v is not None else (light_vs[s - 1] if s > 0 else None)
    pt = sampled_v if t == 1 and sampled_v is not None else cam_vs[t - 1]
    qs_minus = light_vs[s - 2] if s > 1 else None
    pt_minus = cam_vs[t - 2] if t > 1 else None

    if s > 0:
        pt_rev = _vertex_pdf(scene, qs, qs_minus if qs_minus is not None else qs, pt,
                             qs_minus is not None)
        pt_rev = torch.where(qs.vtype == VT_LIGHT, _vertex_pdf_light(scene, qs, pt), pt_rev)
    else:
        pt_rev = _vertex_pdf_light_origin(scene, pt, pt_minus)
    if pt_minus is not None:
        ptm_rev = (_vertex_pdf(scene, pt, qs, pt_minus, True) if s > 0
                   else _vertex_pdf_light(scene, pt, pt_minus))
    if s > 0:
        qs_rev = _vertex_pdf(scene, pt, pt_minus if pt_minus is not None else pt, qs,
                             pt_minus is not None)
        if qs_minus is not None:
            qsm_rev = _vertex_pdf(scene, qs, pt, qs_minus, True)

    cam_eff = list(cam_vs[:t])
    cam_eff[t - 1] = pt._replace(pdf_rev=pt_rev)
    if t > 1:
        cam_eff[t - 2] = pt_minus._replace(pdf_rev=ptm_rev)
    light_eff = list(light_vs[:s])
    if s > 0:
        light_eff[s - 1] = qs._replace(pdf_rev=qs_rev)
    if s > 1:
        light_eff[s - 2] = qs_minus._replace(pdf_rev=qsm_rev)

    sum_ri = torch.zeros((R,), device=dev)
    no_delta = torch.zeros((R,), dtype=torch.bool, device=dev)
    ri = torch.ones((R,), device=dev)
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(cam_eff[i].pdf_rev) / _remap0(cam_eff[i].pdf_fwd)
        prev_delta = cam_eff[i - 1].delta if i - 1 > 0 else no_delta
        usable = ~cam_eff[i].delta & ~prev_delta & _exists(cam_eff[i])
        sum_ri = sum_ri + torch.where(usable, ri, 0.0)
    # i == 0 takes the endpoint's delta-light flag: distant and spot starts
    # admit no hypothetical hit (bdpt.cu:367-373)
    ri = torch.ones((R,), device=dev)
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(light_eff[i].pdf_rev) / _remap0(light_eff[i].pdf_fwd)
        prev_delta = (light_eff[i - 1].delta if i - 1 >= 0
                      else _is_delta_light_v(scene, light_eff[0]))
        usable = ~light_eff[i].delta & ~prev_delta & _exists(light_eff[i])
        sum_ri = sum_ri + torch.where(usable, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


# ---------------------------------------------------- connection (plain)


class Connection(NamedTuple):
    """What a strategy with s >= 1 needs before its visibility test."""

    attempt: torch.Tensor  # (R,) bool: traces a shadow ray
    L: torch.Tensor        # (R,4) contribution before visibility and MIS
    g: torch.Tensor        # (R,) geometry term (s, t > 1), else None
    o: torch.Tensor        # (R,3) shadow ray
    d: torch.Tensor        # (R,3)
    t_max: torch.Tensor    # (R,) 0 without an attempt
    p: torch.Tensor = None       # (R,3) media: the segment's end
    medium: torch.Tensor = None  # (R,) int64 media: the medium it starts in


def _conn_medium(a: V, w):
    """The medium on the w side of vertex a (JAX bdpt.py `_conn_medium`)."""
    chosen = torch.where(_dot(w, a.ng) > 0.0, a.med_out, a.med_in)
    return torch.where(a.med_in != a.med_out, chosen, a.med)


def _connection(scene, light_vs, cam_vs, s, t, sample):
    """Vertex factors, attempt and shadow ray of strategy (s, t), s >= 1
    (connect_bdpt and compute_G). The shadow ray leaves the sending vertex
    (the light-side one, or the camera vertex of s = 1) by offset_ray_origin
    and stops 0.1 % short of the target; on a scene with media it is the
    transmittance segment's first hop (its length from the offset origin)
    with the segment's end and start medium."""
    g = None
    if t == 1:
        a = light_vs[s - 1]
        p_to = sample.p_lens
        f = _vertex_f(scene, a, p_to)
        ns_cos = torch.where(a.vtype == VT_SURFACE, _absdot(a.ns, sample.wi), 1.0)
        L = a.beta * f * (sample.we / torch.clamp(sample.pdf, min=1e-12))[..., None] \
            * ns_cos[..., None]
        attempt = _is_connectible(a) & sample.valid & torch.any(f > 0, dim=-1)
    elif s == 1:
        a, ls = cam_vs[t - 1], sample.ls
        p_to = ls.p_light
        f = _vertex_f(scene, a, p_to)
        cos_pt = torch.where(a.vtype == VT_SURFACE, _absdot(a.ns, ls.wi), 1.0)
        L = a.beta * f * cos_pt[..., None] * ls.L / torch.clamp(
            sample.pmf * ls.pdf, min=1e-20)[..., None]
        attempt = _is_connectible(a) & ls.valid & (ls.pdf > 0) & torch.any(f > 0, dim=-1)
    else:
        a, b = light_vs[s - 1], cam_vs[t - 1]
        p_to = b.p
        f_a, f_b = _vertex_f(scene, a, b.p), _vertex_f(scene, b, a.p)
        attempt = (_is_connectible(a) & _is_connectible(b)
                   & torch.any(f_a > 0, dim=-1) & torch.any(f_b > 0, dim=-1))
        w, dist2 = _dir_to(a.p, b.p)
        cos_a = torch.where(a.vtype == VT_SURFACE, _absdot(a.ns, w), 1.0)
        cos_b = torch.where(b.vtype == VT_SURFACE, _absdot(b.ns, w), 1.0)
        g = cos_a * cos_b / torch.clamp(dist2, min=1e-24)
        L = a.beta * f_a * f_b * b.beta
    w, dist2 = _dir_to(a.p, p_to)
    o = offset_ray_origin(a.p, a.ng, w, scene.ray_offset_scale)
    if path_integrator.has_media(scene):
        # JAX's compute_transmittance runs on every lane; a lane without an
        # attempt, whose answer is not used, traces t_max 0
        t_max = torch.where(attempt, path_integrator.distance(o, p_to) * (1.0 - 1e-3), 0.0)
        return Connection(attempt, L, g, o, w, t_max, p_to, _conn_medium(a, w))
    t_max = torch.where(attempt, torch.sqrt(torch.clamp(dist2, min=1e-24)) * (1.0 - 1e-3), 0.0)
    return Connection(attempt, L, g, o, w, t_max)


def _emitted(scene, light_vs, cam_vs, t, lam):
    """L of strategy (0, t): the camera vertex is an emitter or escaped."""
    pt, prev = cam_vs[t - 1], cam_vs[t - 2]
    w_out, _ = _dir_to(pt.p, prev.p)
    Le = lights.area_light_le(scene, pt.light, pt.ng, w_out, lam)
    if scene.lt_type.shape[0] > 0:
        Le = torch.where((pt.vtype == VT_LIGHT_INF)[..., None],
                         lights.infinite_le(scene, -w_out, lam), Le)
    ok = _exists(pt) & ((pt.light >= 0) | (pt.vtype == VT_LIGHT_INF))
    return torch.where(ok[..., None], pt.beta * Le, 0.0)


def _finish(scene, light_vs, cam_vs, s, t, lam, sample, conn, occ):
    """L * MIS weight of strategy (s, t) given its visibility `occ`, (R,)
    bool occluded bits or on a scene with media the (R,4) transmittance
    (unused for s = 0)."""
    if s == 0:
        return _emitted(scene, light_vs, cam_vs, t, lam) * _mis_weight(
            scene, light_vs, cam_vs, s, t)[..., None]
    vis = torch.where(occ[..., None], 0.0, 1.0) if occ.dtype == torch.bool else occ
    L = conn.L * (vis if conn.g is None else conn.g[..., None] * vis)
    L = torch.where(conn.attempt[..., None], L, 0.0)
    sampled_v = _sampled_vertex(scene, s, t, sample, cam_vs) if s == 1 or t == 1 else None
    return L * _mis_weight(scene, light_vs, cam_vs, s, t, sampled_v)[..., None]


def splat_pixels(raster, res):
    """Raster positions (R,2) -> pixel ids (R,) int64 (truncated toward 0,
    then clamped)."""
    px = torch.clamp(raster[..., 0].to(torch.int32), 0, res[0] - 1)
    py = torch.clamp(raster[..., 1].to(torch.int32), 0, res[1] - 1)
    return py.long() * res[0] + px.long()


def connect(scene, meta, light_vs, cam_vs, s, t, lam, sample=None):
    """One (s, t) strategy in plain torch (bdpt.cu connect_bdpt:612-721)
    -> (L (R,4), splat raster (R,2) or None, shadow rays traced (0-dim))."""
    if s == 0:
        return (_finish(scene, light_vs, cam_vs, s, t, lam, None, None, None), None,
                torch.zeros((), dtype=torch.int64, device=lam.device))
    c = _connection(scene, light_vs, cam_vs, s, t, sample)
    L = _finish(scene, light_vs, cam_vs, s, t, lam, sample, c, _visibility(scene, meta, c, lam))
    return L, (sample.raster if t == 1 else None), c.attempt.sum()


def _visibility(scene, meta, c, lam):
    """The occluded bits of connection rays c, or on a scene with media
    their segments' transmittance (path.transmittance) at lam."""
    if c.p is None:
        return dispatch.occluded(scene, meta, c.o, c.d, c.t_max)
    return path_integrator.transmittance(scene, meta, c.o, c.d, c.p, c.medium, lam, c.t_max)


def connect_rays_plain(scene, light_vs, cam_vs, table, samples):
    """Plain version of K12's first entry point: the connection of every
    s >= 1 strategy of `table` -> ({(s, t): Connection}, shadow rays o
    (n_ray R, 3), d, t_max (n_ray R,), attempts (0-dim int64))."""
    conns = {st: _connection(scene, light_vs, cam_vs, *st, samples.get(st))
             for st in table if st[0] >= 1}
    dev = cam_vs[0].p.device
    if not conns:
        z = torch.zeros((0, 3), device=dev)
        return conns, z, z, z[:, 0], torch.zeros((), dtype=torch.int64, device=dev)
    return (conns, torch.cat([c.o for c in conns.values()]),
            torch.cat([c.d for c in conns.values()]),
            torch.cat([c.t_max for c in conns.values()]),
            sum(c.attempt.sum() for c in conns.values()))


def connect_segments_plain(scene, light_vs, cam_vs, table, samples):
    """connect_rays_plain on a scene with media: also each ray's segment end
    p (n_ray R, 3) and start medium (n_ray R,) int64 -> (conns, o, d,
    t_max, attempts, p, medium)."""
    conns, o, d, t_max, n = connect_rays_plain(scene, light_vs, cam_vs, table, samples)
    if not conns:
        return conns, o, d, t_max, n, o, torch.zeros((0,), dtype=torch.int64, device=o.device)
    return (conns, o, d, t_max, n, torch.cat([c.p for c in conns.values()]),
            torch.cat([c.medium for c in conns.values()]))


def connect_weight_plain(scene, meta, light_vs, cam_vs, lam, table, samples, conns, occluded,
                         per_strategy=None):
    """Plain version of K12's second entry point: L * MIS weight of every
    strategy given the occluded bits (n_ray R,) of connect_rays_plain's
    rays, or on a scene with media their transmittance (n_ray R, 4) ->
    (L (R,4) summed over t > 1, splat L (n_t1 R, 4), splat pixel ids (n_t1
    R,) int64). per_strategy, a list, receives each strategy's L."""
    R, dev = lam.shape[0], lam.device
    occ = (dict(zip(conns, occluded.reshape((len(conns), R) + tuple(occluded.shape[1:]))))
           if conns else {})
    L = torch.zeros((R, 4), device=dev)
    splat_L, splat_pix = [], []
    for st in table:
        s, t = st
        Lst = _finish(scene, light_vs, cam_vs, s, t, lam, samples.get(st), conns.get(st),
                      occ.get(st))
        if per_strategy is not None:
            per_strategy.append(Lst)
        if t == 1:
            splat_L.append(Lst)
            splat_pix.append(splat_pixels(samples[st].raster, meta.resolution))
        else:
            L = L + Lst
    return (L, torch.cat(splat_L) if splat_L else torch.zeros((0, 4), device=dev),
            torch.cat(splat_pix) if splat_pix else torch.zeros((0,), dtype=torch.int64, device=dev))


def connect_all_plain(scene, meta, light_vs, cam_vs, lam, table, samples, per_strategy=None):
    """K12's plain version: every strategy of `table`, with one occluded
    call for all their shadow rays -> (L (R,4) summed over t > 1, splat L
    (n_t1 R, 4), splat pixel ids (n_t1 R,) int64, shadow rays traced
    (0-dim int64)). per_strategy, a list, receives each strategy's L."""
    if path_integrator.has_media(scene):
        conns, o, d, t_max, n, p, medium = connect_segments_plain(scene, light_vs, cam_vs, table,
                                                                  samples)
        occ = (path_integrator.transmittance(scene, meta, o, d, p, medium,
                                             lam.repeat(len(conns), 1), t_max)
               if conns else None)
    else:
        conns, o, d, t_max, n = connect_rays_plain(scene, light_vs, cam_vs, table, samples)
        occ = dispatch.occluded(scene, meta, o, d, t_max) if conns else None
    L, splat_L, splat_pix = connect_weight_plain(scene, meta, light_vs, cam_vs, lam, table,
                                                 samples, conns, occ, per_strategy)
    return L, splat_L, splat_pix, n


# ----------------------------------------------------------- K12 (CUDA)
# What csrc/bdpt.cu reads. Its kernels read the walks' own tensors through a
# per-wave table of pointers in device memory (FieldTable): per vertex slot
# (camera slots first) the VERTEX_GROUPS of its V, then per endpoint row (the
# table's t = 1 and s = 1 strategies, in table order) the CAMERA_SAMPLE_GROUPS
# or LIGHT_SAMPLE_GROUPS of its sample; each field (R,) or (R, width),
# contiguous, 16-byte aligned and of the group's dtype. The strategy table is
# n_strat rows of [s, t, endpoint row, ray row, splat row] (-1 where none).
# The yardstick entries read a packed float32 copy instead (pack_vertices,
# pack_endpoints): a vertex NF floats, (slot, field, lane); an endpoint NSF.
F32 = torch.float32
VERTEX_GROUPS = (
    ("vtype", torch.int32, 1), ("p", F32, 3), ("ng", F32, 3), ("ns", F32, 3), ("beta", F32, 4),
    ("pdf_fwd", F32, 1), ("pdf_rev", F32, 1), ("delta", torch.bool, 1),
    ("light", torch.int64, 1), ("wo", F32, 3), ("kind", torch.int64, 1), ("refl", F32, 4),
    ("trans", F32, 4), ("eta_re", F32, 4), ("eta_im", F32, 4), ("eta", F32, 1),
    ("ax", F32, 1), ("ay", F32, 1), ("fx", F32, 3), ("fy", F32, 3), ("fz", F32, 3),
    ("med", torch.int64, 1), ("med_in", torch.int64, 1), ("med_out", torch.int64, 1))
# the groups bdpt_connect_weight stages (and the yardsticks pack); the medium
# ids after them are read in place, by the MEDIA instantiations only
STAGED_GROUPS = 21
CAMERA_SAMPLE_GROUPS = (("wi", F32, 3), ("we", F32, 1), ("pdf", F32, 1), ("raster", F32, 2),
                        ("p_lens", F32, 3), ("valid", torch.bool, 1))
LIGHT_SAMPLE_GROUPS = (("light", torch.int64, 1), ("pmf", F32, 1), ("p_light", F32, 3),
                       ("n_light", F32, 3), ("wi", F32, 3), ("L", F32, 4), ("pdf", F32, 1),
                       ("valid", torch.bool, 1))
NF = sum(w for _, _, w in VERTEX_GROUPS[:STAGED_GROUPS])   # 50
NSF = sum(w for _, _, w in LIGHT_SAMPLE_GROUPS)     # 17
# csrc/bdpt.cu's sizes: the pointers of an endpoint row; a tile's lanes and
# its bytes a vertex slot; the most slots bdpt_connect_weight stages in
# shared memory (a 32-lane tile of 35 slots fills a block's 227 KB; max depth
# 16); past them it reads the vertices in place
NEG = 8
TILE = 32
SLOT_BYTES = TILE * sum(w * torch.tensor([], dtype=dt).element_size()
                        for _, dt, w in VERTEX_GROUPS[:STAGED_GROUPS])   # 6560
STAGED_SLOTS = 35
N_SCENE_F = 45
LT_F = 10
# warps of a bdpt_connect_weight block (csrc/bdpt.cu WARPS)
CONNECT_WARPS = 16


def _vertex_fields(v: V):
    b = v.bx
    return (v.vtype, v.p, v.ng, v.ns, v.beta, v.pdf_fwd, v.pdf_rev, v.delta, v.light, v.wo,
            b.kind, b.refl, b.trans, b.eta_re, b.eta_im, b.eta, b.ax, b.ay, v.fx, v.fy, v.fz,
            v.med, v.med_in, v.med_out)


def _sample_fields(x):
    """The fields of a sampled endpoint in CAMERA_SAMPLE_GROUPS or
    LIGHT_SAMPLE_GROUPS order -> (groups, fields)."""
    if isinstance(x, CameraSample):
        return CAMERA_SAMPLE_GROUPS, (x.wi, x.we, x.pdf, x.raster, x.p_lens, x.valid)
    ls = x.ls
    return LIGHT_SAMPLE_GROUPS, (x.light, x.pmf, ls.p_light, ls.n_light, ls.wi, ls.L, ls.pdf,
                                 ls.valid)


def pack_vertices(cam_vs, light_vs):
    """(n_cam + n_light, NF, R) float32 vertex records, written field by
    field into one buffer (the yardstick entries' layout)."""
    vs = cam_vs + light_vs
    R = vs[0].p.shape[0]
    out = torch.empty((len(vs), NF, R), device=vs[0].p.device)
    for i, v in enumerate(vs):
        f = 0
        for x in _vertex_fields(v)[:STAGED_GROUPS]:
            x = x.reshape(R, -1)
            out[i, f:f + x.shape[1]] = x.T
            f += x.shape[1]
    return out


def pack_endpoints(table, samples, R, dev):
    """(n_endpoints, NSF, R) float32, in table order: per t = 1 strategy
    [wi, we, pdf, raster, p_lens, valid], per s = 1 strategy [light, pmf,
    p_light, n_light, wi, L, pdf, valid] (the yardstick entries' layout)."""
    rows = [samples[st] for st in table if st in samples]
    out = torch.zeros((len(rows), NSF, R), device=dev)
    for i, x in enumerate(rows):
        f = 0
        for y in _sample_fields(x)[1]:
            y = y.reshape(R, -1)
            out[i, f:f + y.shape[1]] = y.T
            f += y.shape[1]
    return out


class FieldTable(NamedTuple):
    """The walks' tensors of one wave as K12 reads them: `ptrs`, an int64
    tensor on the wave's device of n_slots x NG vertex field pointers then
    n_end x NEG endpoint field pointers (0 where a row has fewer groups); the
    fields themselves, kept alive with it, per slot (VERTEX_GROUPS order)
    and per endpoint row (with their groups)."""

    ptrs: torch.Tensor
    vertex: tuple
    ends: tuple        # ((groups, fields), ...)
    n_cam: int
    R: int
    device: torch.device


def _check_field(what, x, dtype, width, R, dev):
    shape = (R,) if width == 1 else (R, width)
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != dev \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"bdpt kernel: {what} must be a contiguous, 16-byte aligned {dtype} "
                         f"{shape} tensor on {dev}, got {x.dtype} {tuple(x.shape)} with strides "
                         f"{x.stride()} at {x.data_ptr() % 16} past 16 bytes on {x.device}")


def field_table(cam_vs, light_vs, table, samples):
    """FieldTable of a wave: its camera and light vertices and the sampled
    endpoints of the (s, t) list `table`, any number of each. Raises
    ValueError on a field the kernels cannot read in place (another dtype,
    shape or device, a strided view, an address off 16 bytes)."""
    R, dev = cam_vs[0].p.shape[0], cam_vs[0].p.device
    vs = cam_vs + light_vs
    rows = [samples[st] for st in table if st in samples]
    ptrs = [0] * (len(vs) * len(VERTEX_GROUPS) + len(rows) * NEG)
    vertex, ends = [], []
    for i, v in enumerate(vs):
        fields = _vertex_fields(v)
        for j, (x, (name, dtype, w)) in enumerate(zip(fields, VERTEX_GROUPS)):
            _check_field(f"vertex slot {i} {name}", x, dtype, w, R, dev)
            ptrs[i * len(VERTEX_GROUPS) + j] = x.data_ptr()
        vertex.append(fields)
    base = len(vs) * len(VERTEX_GROUPS)
    for i, x in enumerate(rows):
        groups, fields = _sample_fields(x)
        for j, (y, (name, dtype, w)) in enumerate(zip(fields, groups)):
            _check_field(f"endpoint row {i} {name}", y, dtype, w, R, dev)
            ptrs[base + i * NEG + j] = y.data_ptr()
        ends.append((groups, fields))
    ptrs = torch.tensor(ptrs, dtype=torch.int64)
    if dev.type == "cuda":
        # one small copy on the stream, from pinned memory so that the host
        # does not wait for the device
        ptrs = ptrs.pin_memory().to(dev, non_blocking=True)
    return FieldTable(ptrs, tuple(vertex), tuple(ends), len(cam_vs), R, dev)


def strategy_cost(s, t):
    """Relative cost of strategy (s, t) in bdpt_connect_weight: 10 a BSDF
    evaluation (vertex_f and the junction pdfs at surface vertices: none
    for s = 0, three for t = 1 or s = 1, six otherwise), 2 a step of its
    ratio walks (s + t), 10 for the rest."""
    n_bsdf = 0 if s == 0 else (3 if s == 1 or t == 1 else 6)
    return 10 * n_bsdf + 2 * (s + t) + 10


def warp_assignment(rows, n_warps):
    """The strategies of table rows [s, t, ...] shared out over n_warps
    warps -> [[table row, ...] per warp]: the costliest first, each onto the
    least loaded warp (ties: the lower warp); each warp's list in table
    order. Every row is in exactly one list."""
    load, out = [0] * n_warps, [[] for _ in range(n_warps)]
    for k in sorted(range(len(rows)), key=lambda k: (-strategy_cost(*rows[k][:2]), k)):
        w = min(range(n_warps), key=lambda w: (load[w], w))
        out[w].append(k)
        load[w] += strategy_cost(*rows[k][:2])
    return [sorted(x) for x in out]


class StrategyTable(NamedTuple):
    """The strategy table of a wave as K12 reads it: host rows [s, t,
    endpoint row, ray row, splat row] (-1 where none), their int32 copy on
    the device, the counts of shadow rays and splats per lane, and the
    warps' strategy lists of bdpt_connect_weight: `warps` on the host,
    `order` on the device (n_warps + 1 offsets, then the lists' rows)."""

    rows: list
    tab: torch.Tensor   # (n_strat, 5) int32
    n_ray: int
    n_t1: int
    warps: list
    order: torch.Tensor


_TABLES = {}


def strategy_table(table, dev):
    """StrategyTable of the (s, t) list `table` on device dev (built once
    per table and device)."""
    key = (tuple(table), str(dev))
    if key in _TABLES:
        return _TABLES[key]
    rows, n_end, n_ray, n_splat = [], 0, 0, 0
    for s, t in table:
        end = ray = splat = -1
        if t == 1 or s == 1:
            end, n_end = n_end, n_end + 1
        if s >= 1:
            ray, n_ray = n_ray, n_ray + 1
        if t == 1:
            splat, n_splat = n_splat, n_splat + 1
        rows.append([s, t, end, ray, splat])
    tab = torch.tensor(rows, dtype=torch.int32, device=dev).reshape(-1, 5)
    warps = warp_assignment(rows, CONNECT_WARPS)
    off = [0]
    for x in warps:
        off.append(off[-1] + len(x))
    order = torch.tensor(off + [k for x in warps for k in x], dtype=torch.int32, device=dev)
    _TABLES[key] = StrategyTable(rows, tab, n_ray, n_splat, warps, order)
    return _TABLES[key]


def kernel_tables(scene):
    """Per-scene constants of K12, computed in torch as the plain version
    computes them (cached on the scene): scene_f (N_SCENE_F,) [camera_from_
    render 16, raster_from_camera 16, camera z 3, cos_total, A, res x, res
    y, lens area, lens radius, focal distance, bounding-disk pdf, ray offset
    scale, infinite-light density], the light table (L, LT_F) [type,
    pmf, two-sided, area (pdf_le's), has a shape, direction 3, cos_end,
    scale], the emission table (L, 471) and the uniform infinite lights'
    summed emission (471,)."""
    cached = scene.__dict__.get("_bdpt_tables")
    if cached is not None:
        return cached
    dev = scene.lt_pmf.device
    cam_from_render, raster_from_cam = scene.camera_inverse
    res = scene.camera_res.to(torch.float32)
    n = scene.lt_type.shape[0]
    w_any = torch.zeros((1, 3), device=dev)
    scal = torch.stack([
        scene.camera_cos_total, scene.camera_A, res[0], res[1],
        perspective.lens_area(scene), scene.camera_lens_radius, scene.camera_focal_distance,
        lights._disk_pdf(scene), scene.ray_offset_scale,
        lights.infinite_light_density(scene, w_any)[0]]).to(torch.float32)
    scene_f = torch.cat([cam_from_render.reshape(-1), raster_from_cam.reshape(-1),
                         perspective.camera_z(scene), scal])
    idx = torch.arange(n, device=dev)
    _, _, area, has_shape = lights._area_shape_sample(scene, idx, torch.full((n, 2), 0.5,
                                                                             device=dev))
    lt = torch.cat([x.to(torch.float32).reshape(n, -1) for x in (
        scene.lt_type, scene.lt_pmf, scene.lt_twosided, area, has_shape, scene.lt_direction,
        scene.lt_cos_end, scene.lt_scale)], dim=1).contiguous()
    if scene_f.shape[0] != N_SCENE_F or lt.shape[1] != LT_F:
        raise RuntimeError("bdpt kernel tables do not match csrc/bdpt.cu's layout")
    uinf = torch.where((scene.lt_type == bd.LIGHT_UNIFORM_INFINITE)[:, None],
                       scene.lt_emission * scene.lt_scale[:, None], 0.0).sum(dim=0)
    cached = (scene_f, lt, scene.lt_emission.contiguous(), uinf.contiguous())
    scene.__dict__["_bdpt_tables"] = cached
    return cached


def _lib():
    from pbrt_tpu_torch import kernels

    lib = kernels.load("bdpt")
    if not hasattr(lib, "declared"):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pbrt_bdpt_layout.argtypes = [I]
        lib.pbrt_bdpt_layout.restype = I
        want = (len(VERTEX_GROUPS), NEG, SLOT_BYTES, CONNECT_WARPS, STAGED_SLOTS, STAGED_GROUPS)
        got = tuple(lib.pbrt_bdpt_layout(i) for i in range(len(want)))
        if got != want:
            raise RuntimeError(f"csrc/bdpt.cu's layout {got} is not integrators/bdpt.py's {want}")
        lib.pbrt_bdpt_connect_rays.argtypes = [P, I] + [P] * 3 + [I] * 3 + [P] * 4 + [P] * 3 + [P]
        lib.pbrt_bdpt_connect_rays.restype = I
        lib.pbrt_bdpt_connect_weight.argtypes = ([P, I, I] + [P] * 4 + [I] * 3 + [P] * 4
                                                 + [I] * 2 + [P] * 4 + [P] + [P])
        lib.pbrt_bdpt_connect_weight.restype = I
        lib.declared = True
    return lib


def _lane_lib():
    """The yardsticks' library (csrc/bdpt_lane.cu)."""
    from pbrt_tpu_torch import kernels

    lib = kernels.load("bdpt_lane")
    if not hasattr(lib, "declared"):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pbrt_bdpt_connect_rays_lane.argtypes = [P] * 5 + [I] * 4 + [P] * 4 + [P]
        lib.pbrt_bdpt_connect_rays_lane.restype = I
        lib.pbrt_bdpt_connect_weight_lane.argtypes = ([P] * 5 + [I] * 4 + [P] * 4 + [I] * 2
                                                      + [P] * 4 + [P])
        lib.pbrt_bdpt_connect_weight_lane.restype = I
        lib.declared = True
    return lib


def _check(what, x, dtype, shape, dev):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != dev \
            or not x.is_contiguous():
        raise ValueError(f"bdpt kernel: {what} must be a contiguous {dtype} {tuple(shape)} "
                         f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_wave(scene, dev, R, st, n_end):
    """Checks shared by K12's entry points -> scene tables."""
    if dev.type != "cuda" or not 0 < R < 1 << 30:
        raise ValueError(f"bdpt kernel: needs 0 < R < 2^30 lanes on a CUDA device, got {R} "
                         f"on {dev}")
    tables = kernel_tables(scene)
    if tables[1].shape[0] == 0:
        raise ValueError("bdpt kernel: the scene has no light")
    if n_end != sum(1 for r in st.rows if r[2] >= 0):
        raise ValueError(f"bdpt kernel: {n_end} endpoint rows for the strategy table's "
                         f"{sum(1 for r in st.rows if r[2] >= 0)}")
    _check("strategy table", st.tab, torch.int32, (len(st.rows), 5), dev)
    return tables


def _check_fields(scene, ft, st):
    """_check_wave for the entries over FieldTable ft, whose pointer table
    must be on the wave's device -> scene tables."""
    tables = _check_wave(scene, ft.device, ft.R, st, len(ft.ends))
    _check("field table", ft.ptrs, torch.int64,
           (len(ft.vertex) * len(VERTEX_GROUPS) + len(ft.ends) * NEG,), ft.device)
    return tables


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _connect_rays(scene, ft, st, media):
    from pbrt_tpu_torch import kernels

    dev, R = ft.device, ft.R
    scene_f, lt, _, _ = _check_fields(scene, ft, st)
    o = torch.empty((st.n_ray * R, 3), device=dev)
    d = torch.empty((st.n_ray * R, 3), device=dev)
    t_max = torch.empty((st.n_ray * R,), device=dev)
    count = torch.zeros((1,), dtype=torch.int64, device=dev)
    p = medium = None
    ptrs = (0, 0, 0)
    if media:
        p = torch.empty((st.n_ray * R, 3), device=dev)
        medium = torch.empty((st.n_ray * R,), dtype=torch.int64, device=dev)
        ptrs = (_media_g(scene).data_ptr(), p.data_ptr(), medium.data_ptr())
    err = _lib().pbrt_bdpt_connect_rays(
        ft.ptrs.data_ptr(), len(ft.vertex), scene_f.data_ptr(), lt.data_ptr(), st.tab.data_ptr(),
        len(st.rows), ft.n_cam, R, o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
        count.data_ptr(), *ptrs, _stream(dev))
    kernels.check(err, "bdpt_connect_rays")
    launches["bdpt_connect_rays"] += 1
    return o, d, t_max, count, p, medium


def _media_g(scene):
    if not path_integrator.has_media(scene):
        raise ValueError("bdpt kernel: the MEDIA instantiations need a scene with media")
    g = scene.med_g.contiguous()
    if g.dtype != torch.float32 or g.device != scene.device:
        raise ValueError("bdpt kernel: med_g must be float32 on the scene's device")
    return g


def connect_rays_cuda(scene, ft, st):
    """K12's first entry point, over the walks' tensors of FieldTable ft:
    the shadow rays of every s >= 1 strategy of StrategyTable st -> (o
    (n_ray R, 3), d (n_ray R, 3), t_max (n_ray R,), attempts (1,) int64)."""
    return _connect_rays(scene, ft, st, False)[:4]


def connect_segments_cuda(scene, ft, st):
    """connect_segments_plain's contract: K12's first entry point in its
    MEDIA instantiation -> (o, d, t_max (the transmittance loop's first
    hop), attempts (1,) int64, segment ends p (n_ray R, 3), start media
    (n_ray R,) int64)."""
    return _connect_rays(scene, ft, st, True)


def connect_weight_cuda(scene, ft, st, lam, occluded, res, per_strategy=None):
    """K12's second entry point, over the walks' tensors of FieldTable ft
    (staged a 32-lane tile at a time in shared memory, the next tile while
    this one is computed, up to STAGED_SLOTS vertex slots, read in place
    past them; st's warp lists share out the strategies): L and
    MIS weight of every strategy, given the occluded bits of
    connect_rays_cuda's rays -> (L (R,4) summed over t > 1 in table order,
    splat L (n_t1 R, 4), splat pixel ids (n_t1 R,) int64). Every strategy's
    L goes to per_strategy, an (n_strat, R, 4) float32 tensor (allocated
    here when not given), which the t > 1 sum reads. On a scene with media
    `occluded` is the segments' transmittance (n_ray R, 4) float32 and the
    MEDIA instantiation runs."""
    from pbrt_tpu_torch import kernels

    dev, R = ft.device, ft.R
    scene_f, lt, emission, uinf = _check_fields(scene, ft, st)
    _check("lam", lam, torch.float32, (R, 4), dev)
    med_g = 0
    if occluded.dtype == torch.float32:
        _check("transmittance", occluded, torch.float32, (st.n_ray * R, 4), dev)
        if occluded.data_ptr() % 16:
            raise ValueError("bdpt kernel: the transmittance rows must be 16-byte aligned")
        med_g = _media_g(scene).data_ptr()
    else:
        _check("occluded", occluded, torch.bool, (st.n_ray * R,), dev)
    _check("warp lists", st.order, torch.int32, (CONNECT_WARPS + 1 + len(st.rows),), dev)
    if per_strategy is None:
        per_strategy = torch.empty((len(st.rows), R, 4), device=dev)
    _check("per_strategy", per_strategy, torch.float32, (len(st.rows), R, 4), dev)
    L = torch.empty((R, 4), device=dev)
    splat_L = torch.empty((st.n_t1 * R, 4), device=dev)
    splat_pix = torch.empty((st.n_t1 * R,), dtype=torch.int64, device=dev)
    err = _lib().pbrt_bdpt_connect_weight(
        ft.ptrs.data_ptr(), len(ft.vertex), len(ft.ends), scene_f.data_ptr(), lt.data_ptr(),
        st.tab.data_ptr(), st.order.data_ptr(), len(st.rows), ft.n_cam, R,
        lam.data_ptr(), emission.data_ptr(), uinf.data_ptr(), occluded.data_ptr(),
        int(res[0]), int(res[1]), L.data_ptr(), splat_L.data_ptr(), splat_pix.data_ptr(),
        per_strategy.data_ptr(), med_g, _stream(dev))
    kernels.check(err, "bdpt_connect_weight")
    launches["bdpt_connect_weight"] += 1
    return L, splat_L, splat_pix


def _check_packed(verts, ends, n_cam, n_light, scene=None):
    if scene is not None and path_integrator.has_media(scene):
        raise ValueError("bdpt kernel: the yardsticks do not cover scenes with media")
    dev, R = verts.device, verts.shape[-1]
    _check("verts", verts, torch.float32, (n_cam + n_light, NF, R), dev)
    _check("endpoints", ends, torch.float32, (ends.shape[0], NSF, R), dev)
    return dev, R


def connect_rays_lane_cuda(scene, verts, ends, st, n_cam, n_light):
    """The yardstick of connect_rays_cuda, K12's first entry point as first
    written (csrc/bdpt_lane.cu), over the packed copy (pack_vertices,
    pack_endpoints); for chip_smoke.py only."""
    from pbrt_tpu_torch import kernels

    dev, R = _check_packed(verts, ends, n_cam, n_light, scene)
    scene_f, lt, _, _ = _check_wave(scene, dev, R, st, ends.shape[0])
    o = torch.empty((st.n_ray * R, 3), device=dev)
    d = torch.empty((st.n_ray * R, 3), device=dev)
    t_max = torch.empty((st.n_ray * R,), device=dev)
    count = torch.zeros((1,), dtype=torch.int64, device=dev)
    err = _lane_lib().pbrt_bdpt_connect_rays_lane(
        verts.data_ptr(), ends.data_ptr(), scene_f.data_ptr(), lt.data_ptr(),
        st.tab.data_ptr(), len(st.rows), n_cam, n_light, R, o.data_ptr(), d.data_ptr(),
        t_max.data_ptr(), count.data_ptr(), _stream(dev))
    kernels.check(err, "bdpt_connect_rays_lane")
    launches["bdpt_connect_rays_lane"] += 1
    return o, d, t_max, count


def connect_weight_lane_cuda(scene, verts, ends, st, n_cam, n_light, lam, occluded, res,
                             per_strategy=None):
    """The yardstick of connect_weight_cuda, K12's second entry point as
    first written (csrc/bdpt_lane.cu): one thread per lane over the packed
    copy, every strategy in table order; for chip_smoke.py only."""
    from pbrt_tpu_torch import kernels

    dev, R = _check_packed(verts, ends, n_cam, n_light, scene)
    scene_f, lt, emission, uinf = _check_wave(scene, dev, R, st, ends.shape[0])
    _check("lam", lam, torch.float32, (R, 4), dev)
    _check("occluded", occluded, torch.bool, (st.n_ray * R,), dev)
    if per_strategy is not None:
        _check("per_strategy", per_strategy, torch.float32, (len(st.rows), R, 4), dev)
    L = torch.empty((R, 4), device=dev)
    splat_L = torch.empty((st.n_t1 * R, 4), device=dev)
    splat_pix = torch.empty((st.n_t1 * R,), dtype=torch.int64, device=dev)
    err = _lane_lib().pbrt_bdpt_connect_weight_lane(
        verts.data_ptr(), ends.data_ptr(), scene_f.data_ptr(), lt.data_ptr(),
        st.tab.data_ptr(), len(st.rows), n_cam, n_light, R, lam.data_ptr(), emission.data_ptr(),
        uinf.data_ptr(), occluded.data_ptr(), int(res[0]), int(res[1]), L.data_ptr(),
        splat_L.data_ptr(), splat_pix.data_ptr(),
        0 if per_strategy is None else per_strategy.data_ptr(), _stream(dev))
    kernels.check(err, "bdpt_connect_weight_lane")
    launches["bdpt_connect_weight_lane"] += 1
    return L, splat_L, splat_pix


def contiguous_samples(samples):
    """The sampled endpoints with every field in place for the kernels:
    sample_wi's raster is a column slice of its (R, 3) raster point, the one
    strided field of a wave, and is made contiguous here."""
    return {st: x._replace(raster=x.raster.contiguous()) if isinstance(x, CameraSample) else x
            for st, x in samples.items()}


def connect_all_cuda(scene, meta, light_vs, cam_vs, lam, table, samples, per_strategy=None):
    """K12: connect_all_plain's contract on the card. Two kernel launches
    over the walks' own tensors and one occluded dispatch for all
    strategies' shadow rays."""
    st = strategy_table(table, lam.device)
    ft = field_table(cam_vs, light_vs, table, contiguous_samples(samples))
    if path_integrator.has_media(scene):
        o, d, t_max, count, p, medium = connect_segments_cuda(scene, ft, st)
        occ = path_integrator.transmittance(scene, meta, o, d, p, medium,
                                            lam.repeat(st.n_ray, 1), t_max)
    else:
        o, d, t_max, count = connect_rays_cuda(scene, ft, st)
        occ = dispatch.occluded(scene, meta, o, d, t_max).contiguous()
    L, splat_L, splat_pix = connect_weight_cuda(scene, ft, st, lam.contiguous(), occ,
                                                meta.resolution, per_strategy)
    return L, splat_L, splat_pix, count[0]


# ------------------------------------------------------------ estimator


def li_bdpt(scene, meta, p_film, smp, wl, skind, spp):
    """BDPT estimate of film positions p_film (R,2) -> (L (R,4), (splat
    pixel ids (n_t1 R,), splat L (n_t1 R, 4)), {"closest": walk rays,
    "shadow": connection rays} as 0-dim int64). The connections run in K12
    on CUDA tensors and in plain torch on CPU tensors."""
    if meta.volumetric:
        path_integrator.check_volumetric(scene, meta)
    cam_vs, smp, n_cam = camera_path(scene, meta, p_film, smp, wl, skind, spp)
    light_vs, smp, n_light = light_path(scene, meta, smp, wl, skind, spp)
    table = strategies(len(cam_vs), len(light_vs), meta.max_depth)
    samples, smp = sample_endpoints(scene, light_vs, cam_vs, table, smp, wl, skind, spp)
    connect_all = connect_all_cuda if p_film.is_cuda else connect_all_plain
    L, splat_L, splat_pix, n_conn = connect_all(scene, meta, light_vs, cam_vs, wl.lam, table,
                                                samples)
    return L, (splat_pix, splat_L), {"closest": n_cam + n_light, "shadow": n_conn}
