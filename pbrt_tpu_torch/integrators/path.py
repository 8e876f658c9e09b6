"""Spectral path tracer with NEE, MIS and russian roulette (counterpart of
pbrt_tpu/integrators/path.py; reference integrators/megakernel_path.cu:
13-264).

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
  - on a volumetric scene (SceneMeta.volumetric: homogeneous media or
    material-less interfaces; evaluate_Li_volume, megakernel_path.cu:
    13-176) a lane in a medium draws an exponential distance against the
    average sigma_t first and scatters there when it falls short of the
    hit (beta *= sigma_s / sigma_t, NEE from the scatter point with the HG
    phase function, an HG continuation); an interface hit passes through
    at a cost of 0.3 depth; shadow rays carry the transmittance of the
    media they cross (`transmittance`, K6t hop by hop through interfaces),
    and the MIS pdfs are weighted by the transmittance since the last real
    scatter. A medium lane's NEE f and pdf are the pdf of a fresh HG
    sample, not HG at the light direction, as the JAX package does
    (megakernel_path.cu:248-263). Coated materials in a volumetric scene
    are not covered and raise.
  - on a textured scene (SceneMeta.textured: texture slots or mix
    materials) each shading lane's material is resolved from a mix by a
    hash of the hit point's and wo's bits, and its textured reflectance,
    transmittance and roughness are evaluated at the hit (uv, p, and with
    `footprints` the uv footprint of the camera differentials) before its
    BSDF is built: K13 (textures.eval_lanes, csrc/texture.cu) on the card,
    launched by shade_cuda before the shading kernels, which read its
    overrides; textures.eval_lanes_plain in the plain parts.
Image infinite lights are a later slice; the scene builder refuses them.

A bounce (bounce_step) is the parts around the two visibility dispatches:
the loop head with russian roulette (rr), dispatch.intersect, shading with
the NEE light sample and the BSDF sample (shade), on a scene with coated
materials K7's walks on the coated lanes and their finish (coat, then K7's
layered_pdf for their MIS pdf), dispatch.occluded on the shadow rays, and
the direct light they let through (resolve). On the card the parts are the
kernels of csrc/path_step.cu (K6, `rr_cuda`, `shade_cuda` (two kernels,
`path_shade` and `path_bsdf`), `coat_cuda`, `resolve_cuda`) for every scene
and sampler kind (independent, stratified, MLT), with their VOLUMETRIC
instantiations and the transmittance hop K6t (`transmit_hop_cuda`,
csrc/transmit.cu) on a volumetric scene; on CPU tensors their plain
versions `rr_plain`, `shade_plain` (`shade_light_plain` and
`shade_bsdf_plain`, or `shade_light_vol_plain` and `shade_bsdf_vol_plain`),
`coat_plain`, `resolve_plain`, `transmit_hop_plain`. `step_route` decides
from the device.
"""
import ctypes
import math
from typing import NamedTuple

import torch

from pbrt_tpu_torch.utils.math import INFINITY, power_heuristic
from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.geometry.ray import offset_ray_origin
from pbrt_tpu_torch.accel import dispatch
from pbrt_tpu_torch.cameras import differentials
from pbrt_tpu_torch.materials import materials, bxdfs, layered, scattering as sc
from pbrt_tpu_torch.lights import lights
from pbrt_tpu_torch.sampling import samplers, warps
from pbrt_tpu_torch.spectral import sampled, spectra
from pbrt_tpu_torch.textures import textures as texlib

RR_START_DEPTH = 8.0
RR_CLAMP = 0.95
INTERFACE_BOUNCE_COST = 0.3  # a material-less interface's depth (integrator_base.h:20)
# the interface crossings a shadow ray's transmittance follows (the
# reference's MAX_VOLUME_BOUNCES fail-safe)
MAX_HOPS = 8


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
    # volumetric scenes only (None elsewhere): the medium the ray travels in
    # (-1 vacuum) and the transmittance pdf accumulated since the last real
    # scatter (megakernel_path.cu multi_transmittance_pdf)
    medium: torch.Tensor = None      # (R,) int64
    trans_pdf: torch.Tensor = None   # (R,4)


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


class ShadowRays(NamedTuple):
    """The NEE shadow rays of a bounce; t_max = 0 on lanes without NEE."""
    o: torch.Tensor          # (R,3)
    d: torch.Tensor          # (R,3)
    t_max: torch.Tensor      # (R,)


class NeePending(NamedTuple):
    """A bounce's direct-lighting term, waiting for its shadow ray. On a
    volumetric scene its MIS weight waits for the shadow ray's
    transmittance: ld is f L (0 where invalid) and mis holds the light's
    pdf (0 where invalid) and the BSDF's or phase function's (-1 for a delta
    light)."""
    mask: torch.Tensor       # (R,) lanes that ran NEE
    beta: torch.Tensor       # (R,4) the throughput it is weighed by
    ld: torch.Tensor         # (R,4) MIS-weighted light sample, 0 where invalid
    mis: torch.Tensor = None  # (R,2) volumetric: [pdf_light, pdf_bsdf]


class VolShadow(NamedTuple):
    """The NEE segments of a volumetric bounce: shadow rays (t_max 0 on
    lanes without NEE) with their end points and start media."""
    o: torch.Tensor          # (R,3)
    d: torch.Tensor          # (R,3)
    t_max: torch.Tensor      # (R,)
    p: torch.Tensor          # (R,3) the light sample's point
    medium: torch.Tensor     # (R,) int64


def rr_plain(meta, state: PathState, skind="independent", spp=0):
    """The loop head (reference megakernel_path.cu: the while guard and
    russian roulette): the lanes that trace this bounce, their RR draw where
    due, the scaled beta and the next RR depth. -> (state with beta, smp,
    active, rr_next and n_closest updated, t_max (R,): INFINITY on the
    tracing lanes, 0 elsewhere)."""
    r = state.smp
    active = state.active & (state.depth < meta.max_depth)
    rr_due = active & (state.depth >= state.rr_next)
    r, u_rr = samplers.get_1d(r, rr_due, skind, spp)
    survive = torch.clamp(torch.amax(state.beta, dim=-1), max=RR_CLAMP)
    killed = rr_due & (u_rr > survive)
    beta = torch.where((rr_due & ~killed)[..., None],
                       state.beta / torch.clamp(survive, min=1e-9)[..., None], state.beta)
    active = active & ~killed
    rr_next = torch.where(rr_due, state.rr_next + 1.0, state.rr_next)
    n_closest = state.n_closest + active.sum()
    return (state._replace(beta=beta, smp=r, active=active, rr_next=rr_next,
                           n_closest=n_closest),
            torch.where(active, INFINITY, 0.0))


class CoatLanes(NamedTuple):
    """The coated lanes of a bounce (coateddiffuse, coatedconductor: K7's
    layered walk) between shading and `coat`: what shading formed for them
    that does not depend on the walk, K7's inputs among it. Every field has
    the bounce's R lanes; the kernels write the per-lane ones on `mask`
    lanes only. The light fields are None in a scene without lights."""
    mask: torch.Tensor       # (R,) bool: the coated shading lanes
    nee: torch.Tensor        # (R,) bool: those that run NEE
    lay: object              # layered.LayeredParams: their layers
    wo: torch.Tensor         # (R,3) wo in the shading frame
    wi: object               # (R,3) the light sample's direction in the frame
    uc: torch.Tensor         # (R,) the BSDF draws
    u2: torch.Tensor         # (R,2)
    p: torch.Tensor          # (R,3) the hit: point, geometric and shading normal
    ng: torch.Tensor
    ns: torch.Tensor
    beta: torch.Tensor       # (R,4) the throughput before the bounce
    light_wi: object         # (R,3) the light sample's world direction
    light_L: object          # (R,4) its radiance
    light_pdf: object        # (R,) its light-sampler pmf times its pdf
    light_ok: object         # (R,) bool: valid with pdf > 0
    light_delta: object      # (R,) bool: a delta light


class _Surface(NamedTuple):
    """What both parts of shading form first from the lanes' input state
    and hit record: the lanes that shade, their BSDF (make_bsdf) and
    wavelengths, wo in the shading frame, the lanes that run NEE, and the
    coated lanes (None in a scene without coated materials)."""
    shade: torch.Tensor
    bsdf: object
    wl: sampled.Wavelengths
    wo: torch.Tensor
    nee: torch.Tensor
    coat: object


def tex_lanes(state: PathState, hit: dispatch.SceneHit):
    """The lanes whose textures a bounce evaluates: those that trace and
    hit a material (on a volumetric scene also those that scatter before
    the hit, whose answer is not read)."""
    return state.active & hit.valid & (hit.mat >= 0)


def closest_hits(scene, meta, state: PathState, t_max, spp, footprints):
    """dispatch.intersect of the lanes' rays -> (SceneHit, the hits' uv
    footprints (R, 4) (dudx, dvdx, dudy, dvdy) from the camera
    differentials where `footprints` on a textured scene (JAX
    path.py:322-334), else None)."""
    if not (footprints and meta.textured):
        return dispatch.intersect(scene, meta, state.o, state.d, t_max), None
    hit, dpdu, dpdv = dispatch.intersect(scene, meta, state.o, state.d, t_max, derivatives=True)
    deltas = tuple(scene.cam_ray_deltas[i] for i in range(4))
    dpdx, dpdy = differentials.approximate_dp_dxy(hit.p, hit.ns, state.o, state.d, deltas,
                                                  max(spp, 1))
    return hit, torch.stack(differentials.duv_dxy(dpdx, dpdy, dpdu, dpdv), dim=-1)


def _surface(scene, meta, state: PathState, hit: dispatch.SceneHit, duv=None):
    """On a textured scene each lane's material and textured slots come from
    the plain version of K13 (with footprints `duv` or None)."""
    shade = state.active & hit.valid & (hit.mat >= 0)
    wl = sampled.Wavelengths(lam=state.lam, pdf=state.lam_pdf)
    tex = None
    if meta.textured:
        tex = texlib.eval_lanes_plain(scene, tex_lanes(state, hit), hit.mat, hit.p, hit.wo,
                                      hit.uv, hit.ns, state.lam, duv)
    bsdf, wl2 = materials.make_bsdf(scene, hit.mat if tex is None else tex.mat, hit.ns, wl,
                                    meta.layered, tex=tex)
    kind = bsdf.params.kind
    # NEE is skipped for specular-only lobes (coated kinds always run it)
    spec_only = (((kind == bxdfs.K_CONDUCTOR) | (kind == bxdfs.K_DIELECTRIC))
                 & sc.effectively_smooth(bsdf.params.ax, bsdf.params.ay))
    return _Surface(shade=shade, bsdf=bsdf, wl=wl2,
                    wo=vm.to_local(bsdf.fx, bsdf.fy, bsdf.fz, hit.wo),
                    nee=shade & ~spec_only & (scene.lt_pmf.shape[0] > 0),
                    coat=shade & materials.is_coated(kind) if meta.layered else None)


def shade_light_plain(scene, meta, state: PathState, hit: dispatch.SceneHit,
                      skind="independent", spp=0, surf=None, duv=None):
    """shade_plain's first part, the plain version of csrc/path_step.cu
    `path_shade`: escaped rays collect the uniform infinite lights and
    area-light hits their emission (MIS-weighted), the BSDF's wavelengths,
    the NEE draws and light sample with its MIS weight (reference sample_Ld,
    megakernel_path.cu:186-264). -> (the state with L, lam_pdf, depth,
    prev_p and prev_ns of the next state, its other fields as they came; the
    shadow rays; the pending direct-light term; the coated lanes without
    their BSDF draws (uc, u2 None), or None in a scene without coated
    materials). `surf`: _surface's answer, where the caller has it; else
    _surface's with a textured scene's footprints `duv` or None."""
    surf = _surface(scene, meta, state, hit, duv) if surf is None else surf
    r = state.smp
    active = state.active
    beta = state.beta
    L = state.L
    first_or_spec = (state.depth == 0.0) | state.specular
    lam = state.lam

    # --- escaped rays collect the uniform infinite lights (MIS)
    if meta.open_scene:
        escaped = active & ~hit.valid
        pdf_inf = lights.infinite_light_density(scene, state.d)
        w_inf = torch.where(first_or_spec, 1.0,
                            power_heuristic(1.0, state.prev_pdf, 1.0, pdf_inf))
        L = torch.where(escaped[..., None],
                        L + beta * w_inf[..., None] * lights.infinite_le(scene, state.d, lam),
                        L)
    active = active & hit.valid

    # --- emissive surface hit (MIS)
    hit_light = active & (hit.light >= 0)
    Le = lights.area_light_le(scene, hit.light, hit.ng, hit.wo, lam)
    pdf_li = lights.area_light_pdf_li(
        scene, hit.light, state.prev_p, state.prev_ns, state.d, hit.p, hit.ng)
    pmf_l = scene.lt_pmf[torch.clamp(hit.light, min=0)]
    w_area = torch.where(first_or_spec, 1.0,
                         power_heuristic(1.0, state.prev_pdf, 1.0, pmf_l * pdf_li))
    L = torch.where(hit_light[..., None], L + beta * w_area[..., None] * Le, L)

    shade, bsdf, wo, nee, coat = surf.shade, surf.bsdf, surf.wo, surf.nee, surf.coat
    wl = sampled.Wavelengths(lam=lam, pdf=torch.where(shade[..., None], surf.wl.pdf,
                                                      state.lam_pdf))

    # --- NEE; its draws are masked like the reference's, which consumes
    # them only when sample_Ld runs. Lanes without NEE trace their shadow
    # ray with t_max = 0, which the traversal answers at once.
    r, u_l = samplers.get_1d(r, nee, skind, spp)
    r, u_l2 = samplers.get_2d(r, nee, skind, spp)
    shadow = pending = ls = wi = pdf_light = light_ok = None
    if scene.lt_pmf.shape[0] > 0:
        light_idx, pmf = _pick_light(scene, u_l)
        ls = lights.sample_li(scene, light_idx, hit.p, hit.ns, u_l2, wl.lam)
        wi = vm.to_local(bsdf.fx, bsdf.fy, bsdf.fz, ls.wi)
        f = bxdfs.f(bsdf.params, wo, wi) * vm.absdot(ls.wi, hit.ns)[..., None]
        pdf_bsdf = bxdfs.pdf(bsdf.params, wo, wi)
        f_pos = torch.any(f > 0.0, dim=-1)
        pdf_light = pmf * ls.pdf
        o_sh = offset_ray_origin(hit.p, hit.ng, ls.wi, scene.ray_offset_scale)
        t_sh = vm.distance(o_sh, ls.p_light) * (1.0 - 1e-3)
        shadow = ShadowRays(o_sh, ls.wi, torch.where(nee, t_sh, 0.0))
        contrib = f * ls.L / torch.clamp(pdf_light, min=1e-20)[..., None]
        w = torch.where(ls.is_delta, 1.0, power_heuristic(1.0, pdf_light, 1.0, pdf_bsdf))
        light_ok = ls.valid & (pdf_light > 0.0)
        ok = light_ok & f_pos if coat is None else light_ok & f_pos & ~coat
        pending = NeePending(nee, beta, torch.where(ok[..., None], w[..., None] * contrib, 0.0))

    out = state._replace(
        L=L,
        lam_pdf=wl.pdf,
        depth=state.depth + torch.where(shade, 1.0, 0.0),
        prev_p=torch.where(shade[..., None], hit.p, state.prev_p),
        prev_ns=torch.where(shade[..., None], hit.ns, state.prev_ns),
    )
    lanes = None
    if coat is not None:
        lanes = CoatLanes(
            mask=coat, nee=coat & nee, lay=bsdf.lay, wo=wo, wi=wi, uc=None, u2=None, p=hit.p,
            ng=hit.ng, ns=hit.ns, beta=beta, light_wi=None if ls is None else ls.wi,
            light_L=None if ls is None else ls.L, light_pdf=pdf_light, light_ok=light_ok,
            light_delta=None if ls is None else ls.is_delta)
    return out, shadow, pending, lanes


# the fields of the next state that shade_bsdf_plain (path_bsdf) forms
BSDF_FIELDS = ("o", "d", "beta", "smp", "active", "specular", "prev_pdf")


def shade_bsdf_plain(scene, meta, state: PathState, hit: dispatch.SceneHit,
                     skind="independent", spp=0, surf=None, duv=None):
    """shade_plain's second part, the plain version of csrc/path_step.cu
    `path_bsdf`: the BSDF draws, after the NEE draws (drawn and left
    unused: shade_light_plain takes them), the BSDF sample and the new
    ray. -> (the state with BSDF_FIELDS of the next state, its other fields
    as they came; the coated lanes (R,) bool and their draws uc (R,), u2
    (R, 2), or None in a scene without coated materials). Coated lanes keep their ray,
    throughput, specular flag and MIS pdf and are not active until K7 and
    `coat` finish them."""
    surf = _surface(scene, meta, state, hit, duv) if surf is None else surf
    shade, bsdf, coat = surf.shade, surf.bsdf, surf.coat
    r, _ = samplers.get_1d(state.smp, surf.nee, skind, spp)
    r, _ = samplers.get_2d(r, surf.nee, skind, spp)
    r, uc = samplers.get_1d(r, shade, skind, spp)
    r, u2 = samplers.get_2d(r, shade, skind, spp)
    bs = bxdfs.sample(bsdf.params, surf.wo, uc, u2)
    bs = bs._replace(wi=vm.from_local(bsdf.fx, bsdf.fy, bsdf.fz, bs.wi))
    cos_term = vm.absdot(bs.wi, hit.ns)
    beta_new = state.beta * bs.f * (cos_term / torch.clamp(bs.pdf, min=1e-20))[..., None]

    cont = shade & bs.valid & torch.any(beta_new > 0.0, dim=-1)
    if coat is not None:
        cont = cont & ~coat
    new_o = offset_ray_origin(hit.p, hit.ng, bs.wi, scene.ray_offset_scale)
    c3 = cont[..., None]
    out = state._replace(
        o=torch.where(c3, new_o, state.o),
        d=torch.where(c3, bs.wi, state.d),
        beta=torch.where(c3, beta_new, state.beta),
        smp=r,
        active=cont,
        specular=torch.where(cont, bxdfs.is_specular(bs.flags), state.specular),
        prev_pdf=torch.where(cont, bs.pdf, state.prev_pdf),
    )
    return out, None if coat is None else (coat, uc, u2)


def shade_plain(scene, meta, state: PathState, hit: dispatch.SceneHit, skind="independent",
                spp=0, duv=None):
    """Everything of a bounce from the escaped-ray branch to the new ray,
    on the state rr_plain returned and its closest hits: shade_light_plain
    (emission, NEE) and shade_bsdf_plain (the BSDF sample, the new ray) on
    one make_bsdf. -> (the next state, its L without this bounce's direct
    light; the shadow rays; the pending direct-light term; the coated
    lanes, or None in a scene without coated materials). Coated lanes get
    all of this that does not depend on their layered walk; their ray,
    throughput, specular flag and MIS pdf stay as they came, they are not
    active, and their pending term is 0, until K7 and `coat` finish them
    (bounce_step). On a textured scene the plain version of K13 (with
    footprints `duv` or None) chooses each lane's material and its textured
    slots."""
    surf = _surface(scene, meta, state, hit, duv)
    return merge_shade(shade_light_plain(scene, meta, state, hit, skind, spp, surf),
                       shade_bsdf_plain(scene, meta, state, hit, skind, spp, surf))


def merge_shade(light, bsdf, fields=None):
    """shade's answer from its two parts' (shade_light_plain's, and
    shade_bsdf_plain's BSDF_FIELDS, or `fields`, and coated lanes' draws)."""
    (out, shadow, pending, lanes), (nxt, draws) = light, bsdf
    out = out._replace(**{k: getattr(nxt, k) for k in fields or BSDF_FIELDS})
    if lanes is not None:
        lanes = lanes._replace(uc=draws[1], u2=draws[2])
    return out, shadow, pending, lanes


# ------------------------------------------------------------------ media


def dot3(a, b):
    """3-term dot products as (x + y) + z, the kernels' order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def distance(a, b):
    """|a - b| with its squared sum as (x + y) + z, the kernels' order (torch's
    sum over a dimension of 3 takes another order on CUDA tensors)."""
    v = a - b
    return torch.sqrt(torch.clamp(dot3(v, v), min=0.0))


def mean4(x):
    """The mean of (..., 4) rows as ((x0 + x1) + x2) + x3, over 4."""
    return (((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]) / 4.0


def sigma_t(scene, medium, lam):
    """sigma_a + sigma_s of media (R,) at lam (R,4) (-1: 0) (JAX path.py
    `_sigma_t`)."""
    if not has_media(scene):
        return torch.zeros_like(lam)
    m = torch.clamp(medium, min=0)
    sig = (spectra.sample_table(scene.med_sigma_a, m, lam)
           + spectra.sample_table(scene.med_sigma_s, m, lam))
    return torch.where((medium >= 0)[..., None], sig, 0.0)


def medium_after(hit: dispatch.SceneHit, d, current):
    """The medium on the far side of a hit when going on along d: the
    shape's outside one where d leaves through its geometric normal's side,
    its inside one otherwise, on a hit between two media; `current` elsewhere
    (JAX path.py `_medium_after`)."""
    chosen = torch.where(dot3(d, hit.ng) > 0.0, hit.med_out, hit.med_in)
    return torch.where(hit.valid & (hit.med_in != hit.med_out), chosen, current)


def has_media(scene):
    return scene.med_sigma_a.shape[0] > 0


class _MediumEvent(NamedTuple):
    """A volumetric bounce's distance sample (evaluate_Li_volume, JAX path.py
    :236-262), formed by both shading parts from the input state and hit."""
    r: samplers.Sampler      # the sampler past the distance draw
    scatter: torch.Tensor    # (R,) the lanes that scatter in their medium
    beta: torch.Tensor       # (R,4) beta * sigma_s / sigma_t on them
    p: torch.Tensor          # (R,3) the scatter point
    trans_pdf: torch.Tensor  # (R,4) times the pass-through transmittance


def distance_draw(u, sig_t):
    """A distance in a medium of sigma_t (R, 4), exponential in its mean
    over the four wavelengths: -log(1 - u) / mean, in the log1p form of the
    JAX package's integrators (path.py:249, bdpt.py:336), which differs
    from sampling/warps.py sample_exponential's rounding."""
    return -torch.log1p(-torch.clamp(u, 0.0, 1.0 - 1e-7)) / torch.clamp(mean4(sig_t), min=1e-12)


def _medium_event(scene, state: PathState, hit, skind, spp):
    r, beta, trans_pdf = state.smp, state.beta, state.trans_pdf
    if not has_media(scene):
        return _MediumEvent(r, torch.zeros_like(state.active), beta, state.o, trans_pdf)
    in_medium = state.active & (state.medium >= 0)
    m = torch.clamp(state.medium, min=0)
    sig_s = spectra.sample_table(scene.med_sigma_s, m, state.lam)
    sig_t = spectra.sample_table(scene.med_sigma_a, m, state.lam) + sig_s
    r, u = samplers.get_1d(r, in_medium, skind, spp)
    t_samp = distance_draw(u, sig_t)
    t_hit = torch.where(hit.valid, hit.t, INFINITY)
    scatter = in_medium & (t_samp < t_hit)
    att = torch.exp(-sig_t * torch.clamp(t_hit, max=1e20)[..., None])
    trans_pdf = torch.where((in_medium & ~scatter)[..., None], trans_pdf * att, trans_pdf)
    beta = torch.where(scatter[..., None], beta * sig_s / torch.clamp(sig_t, min=1e-12), beta)
    return _MediumEvent(r, scatter, beta, state.o + t_samp[..., None] * state.d, trans_pdf)


def _hg_g(scene, medium):
    return scene.med_g[torch.clamp(medium, min=0)]


def shade_light_vol_plain(scene, meta, state: PathState, hit: dispatch.SceneHit,
                          skind="independent", spp=0, surf=None, duv=None):
    """shade_light_plain on a volumetric scene, the plain version of
    csrc/path_step.cu `path_shade<VOLUMETRIC>`: the distance draw first
    (lanes in a medium), then the escaped rays and emission with the MIS pdf
    weighted by the transmittance pdf, NEE from surfaces and from scatter
    points (the phase draw after the light draws), the shadow segments with
    their start media (VolShadow) and the pending term whose MIS weight
    waits for their transmittance. -> (state with L, lam_pdf, depth, prev_p
    and prev_ns of the next state; VolShadow; NeePending; None)."""
    surf = _surface(scene, meta, state, hit, duv) if surf is None else surf
    ev = _medium_event(scene, state, hit, skind, spp)
    r, ms, beta = ev.r, ev.scatter, ev.beta
    active = state.active
    L = state.L
    first_or_spec = (state.depth == 0.0) | state.specular
    lam = state.lam
    dir_pdf_prev = state.prev_pdf * mean4(ev.trans_pdf)
    if meta.open_scene:
        escaped = active & ~hit.valid & ~ms
        pdf_inf = lights.infinite_light_density(scene, state.d)
        w_inf = torch.where(first_or_spec, 1.0, power_heuristic(1.0, dir_pdf_prev, 1.0, pdf_inf))
        L = torch.where(escaped[..., None],
                        L + beta * w_inf[..., None] * lights.infinite_le(scene, state.d, lam), L)
    active = active & (hit.valid | ms)
    if scene.lt_pmf.shape[0] > 0:
        hit_light = active & ~ms & (hit.light >= 0)
        Le = lights.area_light_le(scene, hit.light, hit.ng, hit.wo, lam)
        pdf_li = lights.area_light_pdf_li(
            scene, hit.light, state.prev_p, state.prev_ns, state.d, hit.p, hit.ng)
        pmf_l = scene.lt_pmf[torch.clamp(hit.light, min=0)]
        w_area = torch.where(first_or_spec, 1.0,
                             power_heuristic(1.0, dir_pdf_prev, 1.0, pmf_l * pdf_li))
        L = torch.where(hit_light[..., None], L + beta * w_area[..., None] * Le, L)
    iface = active & ~ms & hit.valid & (hit.mat < 0)
    shade, bsdf, wo = surf.shade & ~ms, surf.bsdf, surf.wo
    nee_any = (surf.nee & ~ms) | ms
    wl = sampled.Wavelengths(lam=lam, pdf=torch.where(shade[..., None], surf.wl.pdf,
                                                      state.lam_pdf))
    r, u_l = samplers.get_1d(r, nee_any, skind, spp)
    r, u_l2 = samplers.get_2d(r, nee_any, skind, spp)
    u_phase = None
    if has_media(scene):
        r, u_phase = samplers.get_2d(r, ms, skind, spp)
    shadow = pending = None
    m3 = ms[..., None]
    p = torch.where(m3, ev.p, hit.p)
    ns = torch.where(m3, 0.0, hit.ns)
    ng = torch.where(m3, 0.0, hit.ng)
    if scene.lt_pmf.shape[0] > 0:
        light_idx, pmf = _pick_light(scene, u_l)
        ls = lights.sample_li(scene, light_idx, p, ns, u_l2, wl.lam)
        wi = vm.to_local(bsdf.fx, bsdf.fy, bsdf.fz, ls.wi)
        f = bxdfs.f(bsdf.params, wo, wi) * vm.absdot(ls.wi, ns)[..., None]
        pdf_bsdf = bxdfs.pdf(bsdf.params, wo, wi)
        if u_phase is not None:
            # a fresh phase sample's pdf, not HG at the light direction
            # (JAX path.py:147-153)
            _, pdf_ph = warps.sample_henyey_greenstein(hit.wo, _hg_g(scene, state.medium),
                                                       u_phase)
            f = torch.where(m3, pdf_ph[..., None].expand_as(f), f)
            pdf_bsdf = torch.where(ms, pdf_ph, pdf_bsdf)
        pdf_light = pmf * ls.pdf
        ok = ls.valid & torch.any(f > 0.0, dim=-1) & (pdf_light > 0.0)
        med_sh = torch.where(ms, state.medium, medium_after(hit, ls.wi, state.medium))
        o_sh = offset_ray_origin(p, ng, ls.wi, scene.ray_offset_scale)
        t_sh = torch.where(nee_any, distance(o_sh, ls.p_light) * (1.0 - 1e-3), 0.0)
        shadow = VolShadow(o_sh, ls.wi, t_sh, ls.p_light, med_sh)
        pending = NeePending(nee_any, beta, torch.where(ok[..., None], f * ls.L, 0.0),
                             torch.stack([torch.where(ok, pdf_light, 0.0),
                                          torch.where(ls.is_delta, -1.0, pdf_bsdf)], dim=-1))
    cost = torch.where(shade | ms, 1.0, torch.where(iface, INTERFACE_BOUNCE_COST, 0.0))
    out = state._replace(
        L=L, lam_pdf=wl.pdf, depth=state.depth + cost,
        prev_p=torch.where(shade[..., None], hit.p, torch.where(m3, ev.p, state.prev_p)),
        prev_ns=torch.where(shade[..., None], hit.ns, torch.where(m3, 0.0, state.prev_ns)))
    return out, shadow, pending, None


# the fields of the next state that shade_bsdf_vol_plain (path_bsdf<VOLUMETRIC>) forms
BSDF_VOL_FIELDS = BSDF_FIELDS + ("medium", "trans_pdf")


def shade_bsdf_vol_plain(scene, meta, state: PathState, hit: dispatch.SceneHit,
                         skind="independent", spp=0, surf=None, duv=None):
    """shade_bsdf_plain on a volumetric scene, the plain version of
    csrc/path_step.cu `path_bsdf<VOLUMETRIC>`: the draws of
    shade_light_vol_plain stepped past, the HG continuation draw, the BSDF
    draws; the next ray of a scatter (HG), an interface (straight on, its
    origin offset past the hit) or a surface (the BSDF sample), the medium
    it travels in, beta, the flags, the MIS pdf and the transmittance pdf
    (1 after a real scatter). -> (state with BSDF_VOL_FIELDS of the next
    state, None)."""
    surf = _surface(scene, meta, state, hit, duv) if surf is None else surf
    ev = _medium_event(scene, state, hit, skind, spp)
    r, ms = ev.r, ev.scatter
    shade, bsdf = surf.shade & ~ms, surf.bsdf
    nee_any = (surf.nee & ~ms) | ms
    r, _ = samplers.get_1d(r, nee_any, skind, spp)
    r, _ = samplers.get_2d(r, nee_any, skind, spp)
    medium = state.medium
    wi_med, pdf_med = state.d, state.prev_pdf
    if has_media(scene):
        r, _ = samplers.get_2d(r, ms, skind, spp)
        r, u_ph2 = samplers.get_2d(r, ms, skind, spp)
        wi_med, pdf_med = warps.sample_henyey_greenstein(-state.d, _hg_g(scene, medium), u_ph2)
    r, uc = samplers.get_1d(r, shade, skind, spp)
    r, u2 = samplers.get_2d(r, shade, skind, spp)
    bs = bxdfs.sample(bsdf.params, surf.wo, uc, u2)
    bs = bs._replace(wi=vm.from_local(bsdf.fx, bsdf.fy, bsdf.fz, bs.wi))
    beta_new = ev.beta * bs.f * (vm.absdot(bs.wi, hit.ns)
                                 / torch.clamp(bs.pdf, min=1e-20))[..., None]
    cont = shade & bs.valid & torch.any(beta_new > 0.0, dim=-1)
    iface = state.active & ~ms & hit.valid & (hit.mat < 0)
    goes = cont | ms | iface
    eps = scene.ray_offset_scale
    m3, i3 = ms[..., None], iface[..., None]
    new_o = torch.where(m3, ev.p, torch.where(i3, offset_ray_origin(hit.p, hit.ng, state.d, eps),
                                              offset_ray_origin(hit.p, hit.ng, bs.wi, eps)))
    new_d = torch.where(m3, wi_med, torch.where(i3, state.d, bs.wi))
    g3 = goes[..., None]
    out = state._replace(
        o=torch.where(g3, new_o, state.o), d=torch.where(g3, new_d, state.d),
        beta=torch.where(cont[..., None], beta_new, ev.beta), smp=r, active=goes,
        specular=torch.where(cont, bxdfs.is_specular(bs.flags), state.specular & ~ms),
        prev_pdf=torch.where(cont, bs.pdf, torch.where(ms, pdf_med, state.prev_pdf)),
        medium=torch.where(cont, medium_after(hit, bs.wi, medium),
                           torch.where(iface, medium_after(hit, state.d, medium), medium)),
        trans_pdf=torch.where((cont | ms)[..., None], 1.0, ev.trans_pdf))
    return out, None


def shade_vol_plain(scene, meta, state: PathState, hit: dispatch.SceneHit,
                    skind="independent", spp=0, duv=None):
    """shade_plain on a volumetric scene: shade_light_vol_plain and
    shade_bsdf_vol_plain on one make_bsdf."""
    surf = _surface(scene, meta, state, hit, duv)
    return merge_shade(shade_light_vol_plain(scene, meta, state, hit, skind, spp, surf),
                       shade_bsdf_vol_plain(scene, meta, state, hit, skind, spp, surf),
                       BSDF_VOL_FIELDS)


def transmit_hop_plain(scene, hit: dispatch.SceneHit, o, d, p1, medium, lam, trans, done):
    """One hop of a segment's transmittance (JAX path.py compute_transmittance's
    body, :109-123), the plain version of K6t (csrc/transmit.cu) over the
    closest hits of rays o + t d, t < t_max: the attenuation exp(-sigma_t
    seg) of the medium crossed, 0 where a real surface blocks, done on a miss
    or a block, and past an interface the next origin and medium. -> (o,
    medium, trans, done, the next hop's t_max: 0 once done, else 0.1 %
    short of p1)."""
    dist = distance(o, p1)
    seg = torch.where(hit.valid, hit.t, dist)
    att = torch.exp(-sigma_t(scene, medium, lam) * torch.clamp(seg, max=1e20)[..., None])
    trans = torch.where(done[..., None], trans, trans * att)
    blocked = hit.valid & (hit.mat >= 0)
    trans = torch.where((blocked & ~done)[..., None], 0.0, trans)
    step = hit.valid & (hit.mat < 0) & ~done
    done = done | ~hit.valid | blocked
    o = torch.where(step[..., None], offset_ray_origin(hit.p, hit.ng, d, scene.ray_offset_scale),
                    o)
    medium = torch.where(step, medium_after(hit, d, medium), medium)
    t_max = torch.where(done, 0.0, distance(o, p1) * (1.0 - 1e-3))
    return o, medium, trans, done, t_max


def transmittance(scene, meta, o, d, p1, medium, lam, t_max, max_hops=MAX_HOPS):
    """(R,4) transmittance of the segments from o along d to p1 through
    material-less interfaces and homogeneous media (JAX path.py
    compute_transmittance), 0 where a real surface blocks: max_hops rounds
    of dispatch.intersect and K6t (transmit_hop_cuda on CUDA tensors,
    transmit_hop_plain on CPU tensors), a fixed count with no host sync.
    t_max: the first hop's, 0.1 % short of p1; lanes with t_max 0 are done
    from the start and trace t_max 0."""
    hop = transmit_hop_cuda if o.is_cuda else transmit_hop_plain
    o, medium, t_max = o.clone(), medium.clone(), t_max.clone()
    trans = torch.ones_like(lam)
    done = t_max <= 0.0
    for _ in range(max_hops):
        hit = dispatch.intersect(scene, meta, o, d, t_max)
        o, medium, trans, done, t_max = hop(scene, hit, o, d, p1, medium, lam, trans, done)
    return trans


def resolve_vol_plain(state: PathState, pending, trans):
    """resolve_plain on a volumetric scene, given the shadow segments'
    transmittance trans (R,4): the NEE lanes' f L trans / pdf_light weighed
    by the power heuristic against pdf_bsdf times the transmittance's mean
    (1 for a delta light), where some transmittance is left."""
    if pending is None:
        return state
    pdf_light, pdf_bsdf = pending.mis[:, 0], pending.mis[:, 1]
    contrib = pending.ld * trans / torch.clamp(pdf_light, min=1e-20)[..., None]
    w = torch.where(pdf_bsdf < 0.0, 1.0,
                    power_heuristic(1.0, pdf_light, 1.0, pdf_bsdf * mean4(trans)))
    ok = (pdf_light > 0.0) & torch.any(trans > 0.0, dim=-1)
    ld = torch.where(ok[..., None], w[..., None] * contrib, 0.0)
    L = torch.where(pending.mask[..., None], state.L + pending.beta * ld, state.L)
    return state._replace(L=L, n_shadow=state.n_shadow + pending.mask.sum())


def layered_answers(c: CoatLanes, pending):
    """K7 on a bounce's coated lanes, as the step launches it: layered_f and
    layered_pdf at the light sample's direction (where there is a pending
    term), layered_sample at the BSDF draws -> (f (R,4) or None, pdf (R,) or
    None, the layered BSDFSample, its wi in the shading frame). The kernels
    on CUDA tensors, their plain versions on CPU tensors."""
    f = pdf = None
    if pending is not None:
        f = layered.layered_f(c.lay, c.wo, c.wi, mask=c.nee)
        pdf = layered.layered_pdf(c.lay, c.wo, c.wi, mask=c.nee)
    return f, pdf, layered.layered_sample(c.lay, c.wo, c.uc, c.u2, mask=c.mask)


def coat_plain(scene, state: PathState, pending, c: CoatLanes, f, pdf, s):
    """The coated lanes of a bounce finished from K7's answers (f, pdf and
    the sample s of layered_answers), on shade's state and pending term: the
    NEE term f |cos| weighed against the light by the power heuristic, and
    where the layered sample goes on (valid, some beta > 0) the new beta,
    ray and specular flag. The MIS pdf of the next bounce is the stochastic
    layered pdf, not the sample's proportional one (megakernel_path.cu:162;
    materials.mis_direction_pdf): it is evaluated at the sampled direction
    taken to world space and back. -> (state, pending, the lanes that go on
    (R,) bool, that direction (R,3) local)."""
    if pending is not None:
        f = f * vm.absdot(c.light_wi, c.ns)[..., None]
        contrib = f * c.light_L / torch.clamp(c.light_pdf, min=1e-20)[..., None]
        w = torch.where(c.light_delta, 1.0, power_heuristic(1.0, c.light_pdf, 1.0, pdf))
        ok = c.light_ok & torch.any(f > 0.0, dim=-1)
        ld = torch.where(ok[..., None], w[..., None] * contrib, 0.0)
        pending = pending._replace(ld=torch.where(c.nee[..., None], ld, pending.ld))
    fx, fy, fz = vm.frame_from_z(c.ns)
    wi = vm.from_local(fx, fy, fz, s.wi)
    cos_term = vm.absdot(wi, c.ns)
    beta_new = c.beta * s.f * (cos_term / torch.clamp(s.pdf, min=1e-20))[..., None]
    cont = c.mask & s.valid & torch.any(beta_new > 0.0, dim=-1)
    new_o = offset_ray_origin(c.p, c.ng, wi, scene.ray_offset_scale)
    c3 = cont[..., None]
    state = state._replace(
        o=torch.where(c3, new_o, state.o),
        d=torch.where(c3, wi, state.d),
        beta=torch.where(c3, beta_new, state.beta),
        active=state.active | cont,
        specular=torch.where(cont, bxdfs.is_specular(s.flags), state.specular))
    return state, pending, cont, vm.to_local(fx, fy, fz, wi)


def resolve_plain(state: PathState, pending, occluded, mis=None):
    """The direct light of the NEE lanes whose shadow ray is unblocked
    (`occluded`: dispatch.occluded's answer for the shadow rays), added to
    L, and their shadow rays counted; with `mis` (the coated lanes that go
    on, their layered pdf (R,)) the MIS pdf of those lanes. pending and
    occluded may be None (no lights) where mis is given. -> the state."""
    if pending is not None:
        ld = torch.where(occluded[..., None], 0.0, pending.ld)
        L = torch.where(pending.mask[..., None], state.L + pending.beta * ld, state.L)
        state = state._replace(L=L, n_shadow=state.n_shadow + pending.mask.sum())
    if mis is not None:
        state = state._replace(prev_pdf=torch.where(mis[0], mis[1], state.prev_pdf))
    return state


def initial_state(rays, wl: sampled.Wavelengths, r, medium=None) -> PathState:
    """The path state of fresh camera rays, ray counters at 0; with `medium`
    (a volumetric scene's camera_medium) the lanes start in it."""
    R = rays.o.shape[0]
    dev = rays.o.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    vol = {}
    if medium is not None:
        vol = dict(medium=torch.as_tensor(medium, device=dev).long().expand(R).contiguous(),
                   trans_pdf=torch.ones((R, 4), device=dev))
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
        n_closest=zero, n_shadow=zero, **vol,
    )


def camera_medium(scene, meta):
    """The medium camera rays start in on a volumetric scene (a 0-dim
    tensor), else None."""
    return scene.camera_medium if meta.volumetric else None


def iterations(meta):
    """The bounce steps of li: max_depth, or on a volumetric scene 2
    max_depth + 4 for the interface crossings' fractional depths (the
    depth guard of rr stops a path at max_depth)."""
    return 2 * meta.max_depth + 4 if meta.volumetric else meta.max_depth


def li(scene, meta, rays, wl: sampled.Wavelengths, r, skind="independent", spp=0,
       footprints=False):
    """Radiance of a batch of camera rays -> (L (R,4), final wavelengths,
    {"closest", "shadow"} counts of rays actually traced, as 0-dim tensors).
    `footprints`: image textures average over the camera differentials'
    uv footprint (off by default, as in the JAX package)."""
    state = initial_state(rays, wl, r, camera_medium(scene, meta))
    for _ in range(iterations(meta)):
        state = bounce_step(scene, meta, state, skind, spp, footprints)
    return (state.L, sampled.Wavelengths(state.lam, state.lam_pdf),
            {"closest": state.n_closest, "shadow": state.n_shadow})


# ------------------------------------------------------ K6 on the card
#
# csrc/path_step.cu: the parts of a bounce around the two dispatches and,
# on coated lanes, around K7's launches, one kernel each (shading two), one
# thread a lane.
# Every path-integrator render on the card takes them: uncoated and coated
# scenes, the independent, stratified and MLT sampler kinds.

# launches of the path-step kernels and of K6t (plain ints, added to where
# each launches)
launches = {"path_rr": 0, "path_shade": 0, "path_bsdf": 0, "path_coat": 0, "path_resolve": 0,
            "path_shade_lane": 0, "transmit_hop": 0, "path_shade_vol": 0, "path_bsdf_vol": 0,
            "path_resolve_vol": 0}
# shade_cuda's kernels: shade_plain's two parts (the step's), or the
# yardstick, shading as first written in one kernel
SHADE_KERNELS = ("path_shade", "path_bsdf")
SHADE_YARDSTICK = ("path_shade_lane",)
STEP_SAMPLERS = ("independent", "stratified", "mlt")
MAT_F, LT_F, SCAL_F = 22, 18, 3


def step_route(device, meta=None, skind=None):
    """"cuda" where a bounce runs csrc/path_step.cu (a CUDA device), else
    "plain" (CPU tensors). The kernels cover every scene (uncoated and
    coated materials) and sampler kind (STEP_SAMPLERS) of the path
    integrator, so neither `meta` nor `skind` changes the answer."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def step_tables(scene):
    """Per-scene rows of the path-step kernels, cached on the scene: the
    material table (M, MAT_F) [type, remap, urough, vrough, eta, eta spectrum
    row, k spectrum row, reflectance mode, reflectance coefficients 3,
    transmittance coefficients 3, and the coated kinds' interface eta,
    conductor roughness u and v, thickness, medium g, medium albedo
    coefficients 3], the light table (L, LT_F) [type,
    pmf, two-sided, scale, emitter triangle, sphere, disk, direction 3,
    position 3, cos_start, cos_end, alias q, alias, alias pmf] and the
    scalars (SCAL_F,) [ray offset scale, 2 scene radii, the uniform infinite
    lights' density], in float32, and the uniform infinite lights' summed
    emission (471,), each computed as the plain step computes it."""
    cached = scene.__dict__.get("_path_tables")
    if cached is not None:
        return cached
    dev = scene.lt_pmf.device

    def rows(*xs):
        # the widths spelled out: a table of 0 rows (a scene without lights)
        # leaves reshape's -1 ambiguous
        n = xs[0].shape[0]
        return torch.cat([x.to(torch.float32).reshape(n, math.prod(x.shape[1:])) for x in xs],
                         dim=1)

    mat = rows(scene.mat_type, scene.mat_remap, scene.mat_urough, scene.mat_vrough,
               scene.mat_eta, scene.mat_eta_spec, scene.mat_k_spec, scene.mat_refl_mode,
               scene.mat_refl_c, scene.mat_trans_c, scene.mat_ieta, scene.mat_crough_u,
               scene.mat_crough_v, scene.mat_thickness, scene.mat_lay_g,
               scene.mat_albedo_c).contiguous()
    lt = rows(scene.lt_type, scene.lt_pmf, scene.lt_twosided, scene.lt_scale, scene.lt_tri,
              scene.lt_sph, scene.lt_dsk, scene.lt_direction, scene.lt_position,
              scene.lt_cos_start, scene.lt_cos_end, scene.lt_alias_rows).contiguous()
    scal = torch.stack([scene.ray_offset_scale, 2.0 * scene.scene_radius,
                        lights.infinite_light_density(scene, torch.zeros((1, 3), device=dev))[0]
                        ]).to(torch.float32)
    if mat.shape[1] != MAT_F or lt.shape[1] != LT_F or scal.shape[0] != SCAL_F:
        raise RuntimeError("path step tables do not match csrc/path_step.cu's layout")
    cached = dict(mat=mat, lt=lt, scal=scal,
                  uinf=lights.uniform_infinite_emission(scene).contiguous(),
                  spec=scene.spec_table.contiguous(), emission=scene.lt_emission.contiguous(),
                  **{k: getattr(scene, k).contiguous() for k in (
                      "tri_p0", "tri_p1", "tri_p2", "sph_center", "sph_radius", "dsk_center",
                      "dsk_normal", "dsk_radius", "dsk_inner")})
    scene.__dict__["_path_tables"] = cached
    return cached


# csrc/path_step.cu `StepArgs`: every field 8 bytes (pointers and int64)
_ARG_FIELDS = (
    # path state in
    "o", "d", "L", "beta", "lam", "lam_pdf", "smp_state", "smp_inc", "smp_pixel",
    "smp_sample", "smp_dim", "mlt_x", "active", "specular", "depth", "rr_next", "prev_pdf",
    "prev_p", "prev_ns", "count_in",
    # closest hits (path_shade, path_coat); the pending term and shadow answers (path_resolve)
    "hit_valid", "hit_p", "hit_ng", "hit_ns", "hit_mat", "hit_light",
    # a textured scene's K13 overrides (hit_mat then K13's resolved material)
    "tex_refl", "tex_trans", "tex_urough", "tex_vrough", "tex_mask",
    "nee", "ld", "occluded",
    # outputs
    "o_out", "d_out", "L_out", "beta_out", "lam_pdf_out", "smp_state_out", "smp_dim_out",
    "active_out", "specular_out", "depth_out", "rr_next_out", "prev_pdf_out", "prev_p_out",
    "prev_ns_out", "t_max_out", "count_out", "sh_o", "sh_d", "sh_t", "nee_out", "ld_out",
    "scratch",
    # the coated lanes (CoatLanes)
    "coat", "coat_nee", "top_kind", "top_refl", "top_trans", "top_eta_re", "top_eta_im",
    "top_eta", "top_ax", "top_ay", "bot_kind", "bot_refl", "bot_trans", "bot_eta_re",
    "bot_eta_im", "bot_eta", "bot_ax", "bot_ay", "thickness", "g", "albedo", "wo_l", "wi_l",
    "uc", "u2", "light_L", "light_pdf", "light_ok", "light_delta",
    # K7's answers; the MIS pdf's direction and value
    "lay_f", "lay_pdf", "s_f", "s_wi", "s_pdf", "s_flags", "s_valid", "mis_wi", "mis_mask",
    "mis_pdf",
    # scene rows
    "mat", "spec", "lt", "emission", "uinf", "scal", "tri_p0", "tri_p1", "tri_p2",
    "sph_center", "sph_radius", "dsk_center", "dsk_normal", "dsk_radius", "dsk_inner",
)
_INT_FIELDS = ("n", "n_lights", "n_tris", "max_depth", "stratified", "spp", "sqrt_spp",
               "open_scene", "mlt_d")
# a layer's interface fields (bxdfs.BxdfParams), in _ARG_FIELDS as top_* and bot_*
_IFACE = (("kind", None, torch.int32), ("refl", 4, torch.float32),
          ("trans", 4, torch.float32), ("eta_re", 4, torch.float32),
          ("eta_im", 4, torch.float32), ("eta", None, torch.float32),
          ("ax", None, torch.float32), ("ay", None, torch.float32))


class _StepArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _ARG_FIELDS]
                + [(k, ctypes.c_longlong) for k in _INT_FIELDS])


# csrc/path_step.cu `VolArgs`, the VOLUMETRIC variants' second record
_VOL_FIELDS = ("hit_t", "hit_med_in", "hit_med_out", "medium", "trans_pdf", "medium_out",
               "trans_pdf_out", "sh_p", "sh_med", "nee_beta", "nee_mis", "trans", "sigma_a",
               "sigma_s", "med_g")


class _VolArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in _VOL_FIELDS] + [("n_media", ctypes.c_longlong)]


def _lib():
    from pbrt_tpu_torch import kernels

    lib = kernels.load("path_step")
    if not hasattr(lib, "declared"):
        lib.pbrt_path_args_bytes.restype = ctypes.c_int
        if lib.pbrt_path_args_bytes() != ctypes.sizeof(_StepArgs):
            raise RuntimeError("csrc/path_step.cu's StepArgs is not integrators/path.py's")
        for fn in (lib.pbrt_path_rr, lib.pbrt_path_shade, lib.pbrt_path_bsdf,
                   lib.pbrt_path_shade_lane, lib.pbrt_path_coat, lib.pbrt_path_resolve):
            fn.argtypes = [ctypes.POINTER(_StepArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.pbrt_path_vol_args_bytes.restype = ctypes.c_int
        if lib.pbrt_path_vol_args_bytes() != ctypes.sizeof(_VolArgs):
            raise RuntimeError("csrc/path_step.cu's VolArgs is not integrators/path.py's")
        for fn in (lib.pbrt_path_shade_vol, lib.pbrt_path_bsdf_vol, lib.pbrt_path_resolve_vol):
            fn.argtypes = [ctypes.POINTER(_StepArgs), ctypes.POINTER(_VolArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.declared = True
    return lib


# each device's scratch of the kernels' ray counts: a sum and a ticket,
# left at zero by the last block of every launch, so zeroed once
_SCRATCH = {}


def _scratch(dev):
    s = _SCRATCH.get(dev)
    if s is None:
        s = _SCRATCH[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    return s


class _Args:
    """A StepArgs being filled, with the tensors it points into kept alive.
    With `meta`, the sampler kind is checked as covered and the scene's
    settings set."""

    def __init__(self, R, dev, meta=None, skind=None, spp=0):
        if dev.type != "cuda":
            raise ValueError(f"path step kernel: needs CUDA tensors, got them on {dev}")
        if not 0 < R < 1 << 31:
            raise ValueError(f"path step kernel: needs 0 < R < 2^31 lanes, got {R}")
        self.c, self.keep, self.R, self.dev, self.skind = _StepArgs(), [], R, dev, skind
        self.v = _VolArgs()
        self.c.n = R
        if meta is None:
            return
        if skind not in STEP_SAMPLERS:
            raise ValueError(f"path step kernel: sampler kind {skind!r}")
        for k, v in (("max_depth", meta.max_depth), ("stratified", skind == "stratified"),
                     ("spp", spp), ("sqrt_spp", int(round(spp ** 0.5))),
                     ("open_scene", meta.open_scene)):
            setattr(self.c, k, int(v))

    def put(self, name, x, width=None, dtype=torch.float32, rows=None):
        """Point field `name` at x, checked: (R,) or (R, width) of dtype
        (rows: another leading size) on the device, made contiguous; a (.., 4)
        row is read as a float4, so 16-byte aligned."""
        n = self.R if rows is None else rows
        shape = (n,) if width is None else (n, width)
        if (not torch.is_tensor(x) or x.device != self.dev or x.dtype != dtype
                or tuple(x.shape) != shape):
            raise ValueError(f"path step kernel: {name} must be a {dtype} {shape} tensor on "
                             f"{self.dev}, got {getattr(x, 'dtype', type(x))} "
                             f"{tuple(getattr(x, 'shape', ()))} on {getattr(x, 'device', None)}")
        x = x.contiguous()
        if width == 4 and x.data_ptr() % 16:
            raise ValueError(f"path step kernel: {name} rows are read as float4: its data "
                             f"must be 16-byte aligned")
        self.keep.append(x)
        setattr(self.v if name in _VOL_FIELDS else self.c, name, x.data_ptr())
        return x

    def inplace(self, name, x, width=None, dtype=torch.float32):
        """Point field `name` at x, which the launch updates in place: put's
        checks, and x must be contiguous already."""
        if torch.is_tensor(x) and not x.is_contiguous():
            raise ValueError(f"path step kernel: {name} is updated in place: it must be "
                             f"contiguous")
        return self.put(name, x, width, dtype)

    def counter(self, x):
        """The ray count x (a one-element int64 tensor) in -> the count out,
        which the launch sets to x plus the lanes it counts."""
        if not torch.is_tensor(x) or x.dtype != torch.int64 or x.numel() != 1 \
                or x.device != self.dev:
            raise ValueError(f"path step kernel: a ray count must be a one-element int64 "
                             f"tensor on {self.dev}")
        self.keep.append(x)
        self.c.count_in = x.data_ptr()
        n = torch.empty((), dtype=torch.int64, device=self.dev)
        self.c.count_out = n.data_ptr()
        return n

    def out(self, name, width=None, dtype=torch.float32):
        x = torch.empty((self.R,) if width is None else (self.R, width), dtype=dtype,
                        device=self.dev)
        setattr(self.v if name in _VOL_FIELDS else self.c, name, x.data_ptr())
        return x

    def state(self, s: PathState, fields):
        for name in fields:
            x = getattr(s, name) if not name.startswith("smp_") else getattr(s.smp, name[4:])
            width = {"o": 3, "d": 3, "prev_p": 3, "prev_ns": 3, "L": 4, "beta": 4, "lam": 4,
                     "lam_pdf": 4}.get(name)
            dtype = (torch.int64 if name.startswith("smp_") else torch.bool
                     if name in ("active", "specular") else torch.float32)
            self.put(name, x, width, dtype)
        if self.skind == "mlt" and "smp_state" in fields:
            # the MLT kind's primary-sample vectors
            x = s.smp.mlt_x
            if not torch.is_tensor(x) or x.dim() != 2 or x.shape[1] < 1:
                raise ValueError("path step kernel: the \"mlt\" kind needs the sampler's "
                                 "primary-sample vectors (R, D)")
            self.put("mlt_x", x, x.shape[1])
            self.c.mlt_d = x.shape[1]

    def media(self, scene):
        """Point the VolArgs's media rows at the scene's."""
        nm = scene.med_sigma_a.shape[0]
        self.v.n_media = nm
        for k, x in (("sigma_a", scene.med_sigma_a), ("sigma_s", scene.med_sigma_s)):
            self.put(k, x, x.shape[1], rows=nm)
        self.put("med_g", scene.med_g, rows=nm)

    def launch(self, name):
        from pbrt_tpu_torch import kernels

        self.c.scratch = _scratch(self.dev).data_ptr()
        stream = torch.cuda.current_stream(self.dev).cuda_stream
        if name.endswith("_vol"):
            err = getattr(_lib(), f"pbrt_{name}")(ctypes.byref(self.c), ctypes.byref(self.v),
                                                  stream)
        else:
            err = getattr(_lib(), f"pbrt_{name}")(ctypes.byref(self.c), stream)
        kernels.check(err, name)
        launches[name] += 1


# csrc/transmit.cu `HopArgs`: every field 8 bytes
_HOP_FIELDS = ("hit_valid", "hit_t", "hit_p", "hit_ng", "hit_mat", "hit_med_in", "hit_med_out",
               "d", "p1", "lam", "o", "trans", "medium", "done", "t_max", "sigma_a", "sigma_s",
               "offset")


class _HopArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in _HOP_FIELDS] + [("n", ctypes.c_longlong)]


def _hop_lib():
    from pbrt_tpu_torch import kernels

    lib = kernels.load("transmit")
    if not hasattr(lib, "declared"):
        lib.pbrt_transmit_args_bytes.restype = ctypes.c_int
        if lib.pbrt_transmit_args_bytes() != ctypes.sizeof(_HopArgs):
            raise RuntimeError("csrc/transmit.cu's HopArgs is not integrators/path.py's")
        lib.pbrt_transmit_hop.argtypes = [ctypes.POINTER(_HopArgs), ctypes.c_void_p]
        lib.pbrt_transmit_hop.restype = ctypes.c_int
        lib.declared = True
    return lib


def transmit_hop_cuda(scene, hit: dispatch.SceneHit, o, d, p1, medium, lam, trans, done):
    """transmit_hop_plain's contract in one launch of K6t (csrc/transmit.cu
    `pbrt_transmit_hop`), which updates o, medium, trans and done in place
    (each must be contiguous) and writes the next t_max -> (o, medium,
    trans, done, t_max)."""
    from pbrt_tpu_torch import kernels

    R, dev = o.shape[0], o.device
    if dev.type != "cuda" or not 0 < R < 1 << 40:
        raise ValueError(f"transmit hop kernel: needs 0 < R lanes of CUDA tensors, got {R} on "
                         f"{dev}")
    a, keep = _HopArgs(), []

    def put(name, x, width=None, dtype=torch.float32, inplace=False, rows=None):
        shape = ((R if rows is None else rows),) + (() if width is None else (width,))
        if (not torch.is_tensor(x) or x.device != dev or x.dtype != dtype
                or tuple(x.shape) != shape or (inplace and not x.is_contiguous())):
            raise ValueError(f"transmit hop kernel: {name} must be a{' contiguous' * inplace} "
                             f"{dtype} {shape} tensor on {dev}, got {getattr(x, 'dtype', x)} "
                             f"{tuple(getattr(x, 'shape', ()))}")
        x = x.contiguous()
        if width == 4 and x.data_ptr() % 16:
            raise ValueError(f"transmit hop kernel: {name} rows are read as float4: its data "
                             f"must be 16-byte aligned")
        keep.append(x)
        setattr(a, name, x.data_ptr())

    put("hit_valid", hit.valid, dtype=torch.bool)
    put("hit_t", hit.t)
    for k in ("p", "ng"):
        put(f"hit_{k}", getattr(hit, k), 3)
    for k in ("mat", "med_in", "med_out"):
        put(f"hit_{k}", getattr(hit, k), dtype=torch.int64)
    put("d", d, 3)
    put("p1", p1, 3)
    put("lam", lam, 4)
    put("o", o, 3, inplace=True)
    put("trans", trans, 4, inplace=True)
    put("medium", medium, dtype=torch.int64, inplace=True)
    put("done", done, dtype=torch.bool, inplace=True)
    nm = scene.med_sigma_a.shape[0]
    put("sigma_a", scene.med_sigma_a, scene.med_sigma_a.shape[1], rows=nm)
    put("sigma_s", scene.med_sigma_s, scene.med_sigma_s.shape[1], rows=nm)
    put("offset", scene.ray_offset_scale.reshape(1), rows=1)
    t_max = torch.empty((R,), device=dev)
    a.t_max, a.n = t_max.data_ptr(), R
    err = _hop_lib().pbrt_transmit_hop(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "transmit_hop")
    launches["transmit_hop"] += 1
    return o, medium, trans, done, t_max


def rr_cuda(meta, state: PathState, skind="independent", spp=0):
    """rr_plain's contract in one launch of csrc/path_step.cu `path_rr`."""
    a = _Args(state.o.shape[0], state.o.device, meta, skind, spp)
    a.state(state, ("beta", "active", "depth", "rr_next", "smp_state", "smp_inc", "smp_pixel",
                    "smp_sample", "smp_dim"))
    n = a.counter(state.n_closest)
    beta, active, rr_next = a.out("beta_out", 4), a.out("active_out", dtype=torch.bool), \
        a.out("rr_next_out")
    st, dim = a.out("smp_state_out", dtype=torch.int64), a.out("smp_dim_out", dtype=torch.int64)
    t_max = a.out("t_max_out")
    a.launch("path_rr")
    return (state._replace(beta=beta, smp=state.smp._replace(state=st, dim=dim), active=active,
                           rr_next=rr_next, n_closest=n), t_max)


def _coat_outputs(a: _Args, beta, hit, light_wi):
    """The CoatLanes that path_shade fills: its output arrays, pointed at
    (light_wi: the shadow rays' directions, None without lights)."""
    def iface(tag):
        return bxdfs.BxdfParams(*(a.out(f"{tag}_{k}", w, dt) for k, w, dt in _IFACE))

    lay = layered.LayeredParams(top=iface("top"), bottom=iface("bot"),
                                thickness=a.out("thickness"), g=a.out("g"),
                                albedo=a.out("albedo", 4), max_depth=10, n_samples=1)
    light = (a.out("wi_l", 3), a.out("light_L", 4), a.out("light_pdf"),
             a.out("light_ok", dtype=torch.bool), a.out("light_delta", dtype=torch.bool)
             ) if light_wi is not None else (None,) * 5
    return CoatLanes(
        mask=a.out("coat", dtype=torch.bool), nee=a.out("coat_nee", dtype=torch.bool), lay=lay,
        wo=a.out("wo_l", 3), wi=light[0], uc=a.out("uc"), u2=a.out("u2", 2), p=hit.p,
        ng=hit.ng, ns=hit.ns, beta=beta, light_wi=light_wi, light_L=light[1],
        light_pdf=light[2], light_ok=light[3], light_delta=light[4])


def _put_hit(a: _Args, scene, meta, state, hit, duv):
    """Point the shading kernels' hit fields at the record; on a textured
    scene hit_mat at the resolved material and the override fields at the
    answer of a K13 launch made here (with footprints duv or None)."""
    a.put("hit_valid", hit.valid, dtype=torch.bool)
    for k in ("p", "ng", "ns"):
        a.put(f"hit_{k}", getattr(hit, k), 3)
    a.put("hit_light", hit.light, dtype=torch.int64)
    tex = None
    if meta.textured:
        tex = texlib.eval_lanes_cuda(scene, tex_lanes(state, hit), hit.mat, hit.p, hit.wo,
                                     hit.uv, hit.ns, state.lam, duv)
    a.put("hit_mat", hit.mat if tex is None else tex.mat, dtype=torch.int64)
    if tex is not None:
        a.put("tex_refl", tex.refl, 4)
        a.put("tex_trans", tex.trans, 4)
        a.put("tex_urough", tex.urough)
        a.put("tex_vrough", tex.vrough)
        a.put("tex_mask", tex.mask, dtype=torch.uint8)


def shade_cuda(scene, meta, state: PathState, hit: dispatch.SceneHit, skind="independent",
               spp=0, kernels=SHADE_KERNELS, duv=None):
    """shade_plain's contract in launches of csrc/path_step.cu `path_shade`
    and `path_bsdf` (its two parts, shade_light_plain and shade_bsdf_plain;
    either alone writes only its part's outputs) or, with kernels=
    SHADE_YARDSTICK, of their yardstick `path_shade_lane`; a scene without
    lights gives (state, None, None, lanes) as the plain version does. On a
    textured scene a launch of K13 (textures.eval_lanes_cuda, with
    footprints `duv` or None) comes first and the kernels read its
    answer."""
    if not set(kernels) <= set(SHADE_KERNELS + SHADE_YARDSTICK):
        raise ValueError(f"path step kernel: {kernels} are not shading kernels")
    if meta.volumetric:
        raise ValueError("path step kernel: a volumetric scene takes shade_vol_cuda")
    a = _Args(state.o.shape[0], state.o.device, meta, skind, spp)
    a.state(state, ("o", "d", "L", "beta", "lam", "lam_pdf", "smp_state", "smp_inc",
                    "smp_pixel", "smp_sample", "smp_dim", "active", "specular", "depth",
                    "prev_pdf", "prev_p", "prev_ns"))
    _put_hit(a, scene, meta, state, hit, duv)
    tab = step_tables(scene)
    n_l, n_t = scene.lt_type.shape[0], scene.tri_p0.shape[0]
    a.c.n_lights, a.c.n_tris = n_l, n_t
    a.put("mat", tab["mat"], MAT_F, rows=tab["mat"].shape[0])
    a.put("spec", tab["spec"], tab["spec"].shape[1], rows=tab["spec"].shape[0])
    a.put("lt", tab["lt"], LT_F, rows=n_l)
    a.put("emission", tab["emission"], tab["emission"].shape[1], rows=n_l)
    a.put("uinf", tab["uinf"], rows=tab["uinf"].shape[0])
    a.put("scal", tab["scal"], rows=SCAL_F)
    for k in ("tri_p0", "tri_p1", "tri_p2", "sph_center", "dsk_center", "dsk_normal"):
        a.put(k, tab[k], 3, rows=tab[k].shape[0])
    for k in ("sph_radius", "dsk_radius", "dsk_inner"):
        a.put(k, tab[k], rows=tab[k].shape[0])
    out = dict(o=a.out("o_out", 3), d=a.out("d_out", 3), L=a.out("L_out", 4),
               beta=a.out("beta_out", 4), lam_pdf=a.out("lam_pdf_out", 4),
               active=a.out("active_out", dtype=torch.bool),
               specular=a.out("specular_out", dtype=torch.bool), depth=a.out("depth_out"),
               prev_pdf=a.out("prev_pdf_out"), prev_p=a.out("prev_p_out", 3),
               prev_ns=a.out("prev_ns_out", 3))
    st, dim = a.out("smp_state_out", dtype=torch.int64), a.out("smp_dim_out", dtype=torch.int64)
    shadow = ShadowRays(a.out("sh_o", 3), a.out("sh_d", 3), a.out("sh_t"))
    nee, ld = a.out("nee_out", dtype=torch.bool), a.out("ld_out", 4)
    lanes = (_coat_outputs(a, state.beta, hit, shadow.d if n_l else None) if meta.layered
             else None)
    for name in kernels:
        a.launch(name)
    out = state._replace(smp=state.smp._replace(state=st, dim=dim), **out)
    if n_l == 0:
        return out, None, None, lanes
    return out, shadow, NeePending(nee, state.beta, ld), lanes


VOL_SHADE_KERNELS = ("path_shade_vol", "path_bsdf_vol")


def shade_vol_cuda(scene, meta, state: PathState, hit: dispatch.SceneHit, skind="independent",
                   spp=0, kernels=VOL_SHADE_KERNELS, duv=None):
    """shade_vol_plain's contract in launches of csrc/path_step.cu
    `path_shade_vol` and `path_bsdf_vol` (either alone writes only its
    part's outputs) -> (state, VolShadow, NeePending with its MIS pdfs,
    None); (state, None, None, None) in a scene without lights. A textured
    scene's overrides as in shade_cuda."""
    if not set(kernels) <= set(VOL_SHADE_KERNELS):
        raise ValueError(f"path step kernel: {kernels} are not the volumetric shading kernels")
    if meta.layered:
        raise ValueError("path step kernel: coated materials in a volumetric scene are not "
                         "covered")
    a = _Args(state.o.shape[0], state.o.device, meta, skind, spp)
    a.state(state, ("o", "d", "L", "beta", "lam", "lam_pdf", "smp_state", "smp_inc",
                    "smp_pixel", "smp_sample", "smp_dim", "active", "specular", "depth",
                    "prev_pdf", "prev_p", "prev_ns"))
    a.put("medium", state.medium, dtype=torch.int64)
    a.put("trans_pdf", state.trans_pdf, 4)
    a.put("hit_t", hit.t)
    for k in ("med_in", "med_out"):
        a.put(f"hit_{k}", getattr(hit, k), dtype=torch.int64)
    _put_hit(a, scene, meta, state, hit, duv)
    tab = step_tables(scene)
    n_l, n_t = scene.lt_type.shape[0], scene.tri_p0.shape[0]
    a.c.n_lights, a.c.n_tris = n_l, n_t
    a.put("mat", tab["mat"], MAT_F, rows=tab["mat"].shape[0])
    a.put("spec", tab["spec"], tab["spec"].shape[1], rows=tab["spec"].shape[0])
    a.put("lt", tab["lt"], LT_F, rows=n_l)
    a.put("emission", tab["emission"], tab["emission"].shape[1], rows=n_l)
    a.put("uinf", tab["uinf"], rows=tab["uinf"].shape[0])
    a.put("scal", tab["scal"], rows=SCAL_F)
    for k in ("tri_p0", "tri_p1", "tri_p2", "sph_center", "dsk_center", "dsk_normal"):
        a.put(k, tab[k], 3, rows=tab[k].shape[0])
    for k in ("sph_radius", "dsk_radius", "dsk_inner"):
        a.put(k, tab[k], rows=tab[k].shape[0])
    a.media(scene)
    out = dict(o=a.out("o_out", 3), d=a.out("d_out", 3), L=a.out("L_out", 4),
               beta=a.out("beta_out", 4), lam_pdf=a.out("lam_pdf_out", 4),
               active=a.out("active_out", dtype=torch.bool),
               specular=a.out("specular_out", dtype=torch.bool), depth=a.out("depth_out"),
               prev_pdf=a.out("prev_pdf_out"), prev_p=a.out("prev_p_out", 3),
               prev_ns=a.out("prev_ns_out", 3), medium=a.out("medium_out", dtype=torch.int64),
               trans_pdf=a.out("trans_pdf_out", 4))
    st, dim = a.out("smp_state_out", dtype=torch.int64), a.out("smp_dim_out", dtype=torch.int64)
    shadow = VolShadow(a.out("sh_o", 3), a.out("sh_d", 3), a.out("sh_t"), a.out("sh_p", 3),
                       a.out("sh_med", dtype=torch.int64))
    pending = NeePending(a.out("nee_out", dtype=torch.bool), a.out("nee_beta", 4),
                         a.out("ld_out", 4), a.out("nee_mis", 2))
    for name in kernels:
        a.launch(name)
    out = state._replace(smp=state.smp._replace(state=st, dim=dim), **out)
    if n_l == 0:
        return out, None, None, None
    return out, shadow, pending, None


def resolve_vol_cuda(state: PathState, pending, trans):
    """resolve_vol_plain's contract in one launch of csrc/path_step.cu
    `path_resolve_vol`."""
    if pending is None:
        return state
    a = _Args(state.L.shape[0], state.L.device)
    a.put("L", state.L, 4)
    a.put("nee", pending.mask, dtype=torch.bool)
    a.put("ld", pending.ld, 4)
    a.put("nee_beta", pending.beta, 4)
    a.put("nee_mis", pending.mis, 2)
    a.put("trans", trans, 4)
    n = a.counter(state.n_shadow)
    L = a.out("L_out", 4)
    a.launch("path_resolve_vol")
    return state._replace(L=L, n_shadow=n)


def shade_lane_cuda(scene, meta, state: PathState, hit: dispatch.SceneHit,
                    skind="independent", spp=0):
    """The yardstick of shade_cuda: shading as first written, one kernel a
    lane (`path_shade_lane`); the same contract and bits. No render path
    calls it."""
    return shade_cuda(scene, meta, state, hit, skind, spp, SHADE_YARDSTICK)


def coat_cuda(scene, state: PathState, pending, c: CoatLanes, f, pdf, s):
    """coat_plain's contract in one launch of csrc/path_step.cu `path_coat`,
    which finishes the coated lanes in the tensors of `state` and `pending`
    that shade_cuda returned (o, d, beta, active, specular; ld), in place,
    and returns them with the new mask and direction."""
    a = _Args(state.o.shape[0], state.o.device)
    a.put("coat", c.mask, dtype=torch.bool)
    a.put("coat_nee", c.nee, dtype=torch.bool)
    for k, x in (("hit_p", c.p), ("hit_ng", c.ng), ("hit_ns", c.ns), ("s_wi", s.wi)):
        a.put(k, x, 3)
    a.put("beta", c.beta, 4)
    a.put("s_f", s.f, 4)
    a.put("s_pdf", s.pdf)
    a.put("s_flags", s.flags, dtype=torch.int32)
    a.put("s_valid", s.valid, dtype=torch.bool)
    for k, x in (("o_out", state.o), ("d_out", state.d)):
        a.inplace(k, x, 3)
    a.inplace("beta_out", state.beta, 4)
    for k, x in (("active_out", state.active), ("specular_out", state.specular)):
        a.inplace(k, x, dtype=torch.bool)
    if pending is not None:
        a.inplace("ld_out", pending.ld, 4)
        a.put("sh_d", c.light_wi, 3)
        a.put("light_L", c.light_L, 4)
        a.put("light_pdf", c.light_pdf)
        a.put("light_ok", c.light_ok, dtype=torch.bool)
        a.put("light_delta", c.light_delta, dtype=torch.bool)
        a.put("lay_f", f, 4)
        a.put("lay_pdf", pdf)
    a.put("scal", step_tables(scene)["scal"], rows=SCAL_F)
    mis_mask, mis_wi = a.out("mis_mask", dtype=torch.bool), a.out("mis_wi", 3)
    a.launch("path_coat")
    return state, pending, mis_mask, mis_wi


def resolve_cuda(state: PathState, pending, occluded, mis=None):
    """resolve_plain's contract in one launch of csrc/path_step.cu
    `path_resolve`."""
    a = _Args(state.L.shape[0], state.L.device)
    a.put("L", state.L, 4)
    if pending is not None:
        a.put("beta", pending.beta, 4)
        a.put("ld", pending.ld, 4)
        a.put("nee", pending.mask, dtype=torch.bool)
        a.put("occluded", occluded, dtype=torch.bool)
    n = a.counter(state.n_shadow)
    L = a.out("L_out", 4)
    prev_pdf = state.prev_pdf
    if mis is not None:
        a.put("mis_mask", mis[0], dtype=torch.bool)
        a.put("mis_pdf", mis[1])
        a.put("prev_pdf", state.prev_pdf)
        prev_pdf = a.out("prev_pdf_out")
    a.launch("path_resolve")
    return state._replace(L=L, n_shadow=n, prev_pdf=prev_pdf)


def check_volumetric(scene, meta):
    """Raise ValueError for a volumetric scene with what the medium branches
    do not cover: coated materials (K7 inside a medium), a two-level
    (instanced) BVH, a scene-sharded render."""
    if meta.layered:
        raise ValueError("volumetric scene with coated materials: the path step's medium "
                         "branches do not cover the layered BxDF")
    if meta.bvh_ninst:
        raise ValueError("volumetric scene with a two-level (instanced) BVH is not supported")
    if scene.shard is not None:
        raise ValueError("volumetric scene rendered scene-sharded is not supported")


def bounce_step(scene, meta, state: PathState, skind="independent", spp=0, footprints=False):
    """One bounce for all lanes -> the updated PathState: the loop head (RR),
    the closest hits, on a textured scene each shading lane's material and
    textured slots (K13, launched by shade_cuda; with `footprints` over the
    uv footprint of the camera differentials), shading with the NEE light
    sample and the BSDF sample,
    on coated lanes K7's walks (layered_f and layered_pdf at the light, the
    layered sample) and their finish (coat), the MIS pdf of the coated lanes
    that go on (K7's layered_pdf), the shadow rays, and the direct light
    they let through. On the "cuda" route (step_route) the parts are the
    kernels of csrc/path_step.cu, else their plain versions; K7 runs as
    csrc/layered.cu on CUDA tensors either way."""
    cuda = step_route(state.o.device, meta, skind) == "cuda"
    if meta.volumetric:
        check_volumetric(scene, meta)
        rr, shade, resolve = ((rr_cuda, shade_vol_cuda, resolve_vol_cuda) if cuda
                              else (rr_plain, shade_vol_plain, resolve_vol_plain))
        state, t_max = rr(meta, state, skind, spp)
        hit, duv = closest_hits(scene, meta, state, t_max, spp, footprints)
        state, sh, pending, _ = shade(scene, meta, state, hit, skind, spp, duv=duv)
        if pending is None:
            return state
        return resolve(state, pending, transmittance(scene, meta, sh.o, sh.d, sh.p, sh.medium,
                                                     state.lam, sh.t_max))
    if cuda:
        rr, shade, coat, resolve = rr_cuda, shade_cuda, coat_cuda, resolve_cuda
    else:
        rr, shade, coat, resolve = rr_plain, shade_plain, coat_plain, resolve_plain
    state, t_max = rr(meta, state, skind, spp)
    hit, duv = closest_hits(scene, meta, state, t_max, spp, footprints)
    state, shadow, pending, lanes = shade(scene, meta, state, hit, skind, spp, duv=duv)
    mis = None
    if lanes is not None:
        state, pending, mis_mask, mis_wi = coat(scene, state, pending, lanes,
                                                *layered_answers(lanes, pending))
        mis = (mis_mask, layered.layered_pdf(lanes.lay, lanes.wo, mis_wi, mask=mis_mask))
    if pending is None:
        return state if mis is None else resolve(state, None, None, mis)
    return resolve(state, pending, dispatch.occluded(scene, meta, shadow.o, shadow.d,
                                                     shadow.t_max), mis)
