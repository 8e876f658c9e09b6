"""Spectral path tracer with NEE, MIS and russian roulette (counterpart of
pbrt_tpu/integrators/path.py with volumetric=False; reference
integrators/megakernel_path.cu:13-264).

One bounce is a masked dense step over all lanes: every lane carries its
full path state and inactive lanes ride along as no-ops, so each lane
draws exactly the sample dimensions the reference draws, in the same order.
Semantics:
  - RR from depth 8, survive = min(max beta, 0.95), counter increments per
    check (util/russian_roulette.h:5-29)
  - NEE skipped for specular-only BSDFs; MIS power heuristic both ways
  - area-light MIS pdf = light-sampler pmf * the emitter's pdf_li(ctx, wi)
    (triangle, sphere or disk)
  - delta lights (distant, spot) get weight 1 in NEE; their shadow rays,
    like those of infinite lights, end just short of the pseudo-position
    two scene radii away
  - an escaped ray collects the uniform infinite lights, MIS-weighted
    against their sampling density (open scenes only)
  - emission at depth 0 or after a specular bounce is unweighted
  - coated materials (layered BxDF, K7) carry the stochastic pdf estimate,
    not their sample's proportional pdf, into the next MIS weight
Media and image infinite lights are later slices; the scene builder
refuses them.
"""
from typing import NamedTuple

import torch

from pbrt_tpu_torch.utils.math import INFINITY, power_heuristic
from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.geometry.ray import offset_ray_origin
from pbrt_tpu_torch.accel import dispatch
from pbrt_tpu_torch.materials import materials, bxdfs, scattering as sc
from pbrt_tpu_torch.lights import lights
from pbrt_tpu_torch.sampling import samplers
from pbrt_tpu_torch.spectral import sampled

RR_START_DEPTH = 8.0
RR_CLAMP = 0.95


class PathState(NamedTuple):
    o: torch.Tensor          # (R,3)
    d: torch.Tensor          # (R,3)
    L: torch.Tensor          # (R,4)
    beta: torch.Tensor       # (R,4)
    lam: torch.Tensor        # (R,4)
    lam_pdf: torch.Tensor    # (R,4)
    smp: samplers.Sampler
    active: torch.Tensor     # (R,)
    specular: torch.Tensor   # (R,)
    depth: torch.Tensor      # (R,) float
    rr_next: torch.Tensor    # (R,) next RR depth
    prev_pdf: torch.Tensor   # (R,)
    prev_p: torch.Tensor     # (R,3)
    prev_ns: torch.Tensor    # (R,3)
    n_closest: torch.Tensor  # () closest-hit rays actually traced (live lanes)
    n_shadow: torch.Tensor   # () shadow rays actually traced


def _pick_light(scene, u):
    """Light index proportional to lt_pmf via the packed alias table
    (PowerLightSampler). Returns (idx, pmf)."""
    rows = scene.lt_alias_rows                       # (L,3) [q, alias, pmf]
    n = rows.shape[0]
    x = u * n
    i = torch.clamp(torch.floor(x).long(), 0, n - 1)
    frac = x - i.to(torch.float32)
    row = rows[i]
    accept = frac < row[:, 0]
    idx = torch.where(accept, i, row[:, 1].long())
    pmf = torch.where(accept, row[:, 2], rows[idx][:, 2])
    return idx, pmf


def sample_ld(scene, meta, hit: dispatch.SceneHit, bsdf, wl, u_light, u2, mask):
    """Direct lighting with MIS (reference sample_Ld, megakernel_path.cu:
    186-264), surface lanes. Lanes outside `mask` trace their shadow ray
    with t_max = 0, which the traversal answers at once. -> (R,4)."""
    light_idx, pmf = _pick_light(scene, u_light)
    ls = lights.sample_li(scene, light_idx, hit.p, hit.ns, u2, wl.lam)
    f = materials.bsdf_f(bsdf, hit.wo, ls.wi) * vm.absdot(ls.wi, hit.ns)[..., None]
    pdf_bsdf = materials.bsdf_pdf(bsdf, hit.wo, ls.wi)
    f_pos = torch.any(f > 0.0, dim=-1)

    pdf_light = pmf * ls.pdf
    o_sh = offset_ray_origin(hit.p, hit.ng, ls.wi, scene.ray_offset_scale)
    t_sh = vm.distance(o_sh, ls.p_light) * (1.0 - 1e-3)
    t_sh = torch.where(mask, t_sh, 0.0)
    visible = ~dispatch.occluded(scene, meta, o_sh, ls.wi, t_sh)
    contrib = f * ls.L / torch.clamp(pdf_light, min=1e-20)[..., None]
    w = torch.where(ls.is_delta, 1.0, power_heuristic(1.0, pdf_light, 1.0, pdf_bsdf))
    ok = ls.valid & f_pos & visible & (pdf_light > 0.0)
    return torch.where(ok[..., None], w[..., None] * contrib, 0.0)


def bounce_step(scene, meta, state: PathState, skind="independent", spp=0):
    """One bounce for all lanes -> the updated PathState."""
    r = state.smp
    active = state.active & (state.depth < meta.max_depth)

    # --- russian roulette (before intersection, reference loop head)
    rr_due = active & (state.depth >= state.rr_next)
    r, u_rr = samplers.get_1d(r, rr_due, skind, spp)
    survive = torch.clamp(torch.amax(state.beta, dim=-1), max=RR_CLAMP)
    killed = rr_due & (u_rr > survive)
    beta = torch.where((rr_due & ~killed)[..., None],
                       state.beta / torch.clamp(survive, min=1e-9)[..., None], state.beta)
    active = active & ~killed
    rr_next = torch.where(rr_due, state.rr_next + 1.0, state.rr_next)

    # --- intersect; dead lanes get t_max = 0 and finish at once
    n_closest = state.n_closest + active.sum()
    hit = dispatch.intersect(scene, meta, state.o, state.d,
                             torch.where(active, INFINITY, 0.0))

    wl = sampled.Wavelengths(lam=state.lam, pdf=state.lam_pdf)
    L = state.L
    first_or_spec = (state.depth == 0.0) | state.specular

    # --- escaped rays collect the uniform infinite lights (MIS)
    if meta.open_scene:
        escaped = active & ~hit.valid
        pdf_inf = lights.infinite_light_density(scene, state.d)
        w_inf = torch.where(first_or_spec, 1.0,
                            power_heuristic(1.0, state.prev_pdf, 1.0, pdf_inf))
        L = torch.where(escaped[..., None],
                        L + beta * w_inf[..., None] * lights.infinite_le(scene, state.d, wl.lam),
                        L)
    active = active & hit.valid

    # --- emissive surface hit (MIS)
    hit_light = active & (hit.light >= 0)
    Le = lights.area_light_le(scene, hit.light, hit.ng, hit.wo, wl.lam)
    pdf_li = lights.area_light_pdf_li(
        scene, hit.light, state.prev_p, state.prev_ns, state.d, hit.p, hit.ng)
    pmf_l = scene.lt_pmf[torch.clamp(hit.light, min=0)]
    w_area = torch.where(first_or_spec, 1.0,
                         power_heuristic(1.0, state.prev_pdf, 1.0, pmf_l * pdf_li))
    L = torch.where(hit_light[..., None], L + beta * w_area[..., None] * Le, L)

    shade = active & (hit.mat >= 0)
    bsdf, wl2 = materials.make_bsdf(scene, hit.mat, hit.ns, wl, meta.layered)
    wl = sampled.Wavelengths(lam=wl.lam, pdf=torch.where(shade[..., None], wl2.pdf, wl.pdf))

    # --- NEE (skipped for specular-only lobes; coated kinds always run it);
    # its draws are masked like the reference's, which consumes them only
    # when sample_Ld runs
    kind = bsdf.params.kind
    spec_only = (((kind == bxdfs.K_CONDUCTOR) | (kind == bxdfs.K_DIELECTRIC))
                 & sc.effectively_smooth(bsdf.params.ax, bsdf.params.ay))
    nee = shade & ~spec_only & (scene.lt_pmf.shape[0] > 0)
    r, u_l = samplers.get_1d(r, nee, skind, spp)
    r, u_l2 = samplers.get_2d(r, nee, skind, spp)
    n_shadow = state.n_shadow
    if scene.lt_pmf.shape[0] > 0:
        ld = sample_ld(scene, meta, hit, bsdf, wl, u_l, u_l2, nee)
        L = torch.where(nee[..., None], L + beta * ld, L)
        n_shadow = n_shadow + nee.sum()

    # --- BSDF sampling
    r, uc = samplers.get_1d(r, shade, skind, spp)
    r, u2 = samplers.get_2d(r, shade, skind, spp)
    bs = materials.bsdf_sample(bsdf, hit.wo, uc, u2)
    # coated lanes: the MIS pdf is re-estimated, not the proportional walk
    # pdf (megakernel_path.cu:162; see materials.mis_direction_pdf)
    pdf_mis = materials.mis_direction_pdf(bsdf, hit.wo, bs)
    cos_term = vm.absdot(bs.wi, hit.ns)
    beta_new = beta * bs.f * (cos_term / torch.clamp(bs.pdf, min=1e-20))[..., None]

    cont = shade & bs.valid & torch.any(beta_new > 0.0, dim=-1)
    new_o = offset_ray_origin(hit.p, hit.ng, bs.wi, scene.ray_offset_scale)
    c3 = cont[..., None]
    return PathState(
        o=torch.where(c3, new_o, state.o),
        d=torch.where(c3, bs.wi, state.d),
        L=L,
        beta=torch.where(c3, beta_new, beta),
        lam=wl.lam,
        lam_pdf=wl.pdf,
        smp=r,
        active=cont,
        specular=torch.where(cont, bxdfs.is_specular(bs.flags), state.specular),
        depth=state.depth + torch.where(shade, 1.0, 0.0),
        rr_next=rr_next,
        prev_pdf=torch.where(cont, pdf_mis, state.prev_pdf),
        prev_p=torch.where(shade[..., None], hit.p, state.prev_p),
        prev_ns=torch.where(shade[..., None], hit.ns, state.prev_ns),
        n_closest=n_closest,
        n_shadow=n_shadow,
    )


def initial_state(rays, wl: sampled.Wavelengths, r) -> PathState:
    """The path state of fresh camera rays, ray counters at 0."""
    R = rays.o.shape[0]
    dev = rays.o.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return PathState(
        o=rays.o, d=rays.d,
        L=torch.zeros((R, 4), device=dev), beta=torch.ones((R, 4), device=dev),
        lam=wl.lam, lam_pdf=wl.pdf, smp=r,
        active=torch.ones((R,), dtype=torch.bool, device=dev),
        specular=torch.zeros((R,), dtype=torch.bool, device=dev),
        depth=torch.zeros((R,), device=dev),
        rr_next=torch.full((R,), RR_START_DEPTH, device=dev),
        prev_pdf=torch.ones((R,), device=dev),
        prev_p=rays.o,
        prev_ns=torch.zeros((R, 3), device=dev),
        n_closest=zero, n_shadow=zero,
    )


def li(scene, meta, rays, wl: sampled.Wavelengths, r, skind="independent", spp=0):
    """Radiance of a batch of camera rays -> (L (R,4), final wavelengths,
    {"closest", "shadow"} counts of rays actually traced, as 0-dim tensors)."""
    state = initial_state(rays, wl, r)
    for _ in range(meta.max_depth):
        state = bounce_step(scene, meta, state, skind, spp)
    return (state.L, sampled.Wavelengths(state.lam, state.lam_pdf),
            {"closest": state.n_closest, "shadow": state.n_shadow})
