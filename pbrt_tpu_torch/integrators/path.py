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

A bounce (bounce_step) is the parts around the two visibility dispatches:
the loop head with russian roulette (rr), dispatch.intersect, shading with
the NEE light sample and the BSDF sample (shade), on a scene with coated
materials K7's walks on the coated lanes and their finish (coat, then K7's
layered_pdf for their MIS pdf), dispatch.occluded on the shadow rays, and
the direct light they let through (resolve). On the card the parts are the
four kernels of csrc/path_step.cu (K6, `rr_cuda`, `shade_cuda`,
`coat_cuda`, `resolve_cuda`) for every scene and sampler kind (independent,
stratified, MLT); on CPU tensors their plain versions `rr_plain`,
`shade_plain`, `coat_plain`, `resolve_plain`. `step_route` decides from the
device.
"""
import ctypes
from typing import NamedTuple

import torch

from pbrt_tpu_torch.utils.math import INFINITY, power_heuristic
from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.geometry.ray import offset_ray_origin
from pbrt_tpu_torch.accel import dispatch
from pbrt_tpu_torch.materials import materials, bxdfs, layered, scattering as sc
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


class ShadowRays(NamedTuple):
    """The NEE shadow rays of a bounce; t_max = 0 on lanes without NEE."""
    o: torch.Tensor          # (R,3)
    d: torch.Tensor          # (R,3)
    t_max: torch.Tensor      # (R,)


class NeePending(NamedTuple):
    """A bounce's direct-lighting term, waiting for its shadow ray."""
    mask: torch.Tensor       # (R,) lanes that ran NEE
    beta: torch.Tensor       # (R,4) the throughput it is weighed by
    ld: torch.Tensor         # (R,4) MIS-weighted light sample, 0 where invalid


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


def shade_plain(scene, meta, state: PathState, hit: dispatch.SceneHit, skind="independent",
                spp=0):
    """Everything of a bounce from the escaped-ray branch to the new ray,
    on the state rr_plain returned and its closest hits: escaped rays
    collect the uniform infinite lights and area-light hits their emission
    (MIS-weighted), the BSDF, the NEE draws and light sample with its MIS
    weight (reference sample_Ld, megakernel_path.cu:186-264), the BSDF
    sample and the new ray. -> (the next state, its L without this bounce's
    direct light; the shadow rays; the pending direct-light term; the
    coated lanes, or None in a scene without coated materials). Coated
    lanes get all of this that does not depend on their layered walk; their
    ray, throughput, specular flag and MIS pdf stay as they came, they are
    not active, and their pending term is 0, until K7 and `coat` finish
    them (bounce_step)."""
    r = state.smp
    active = state.active
    beta = state.beta
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
    kind = bsdf.params.kind
    coat = shade & materials.is_coated(kind) if meta.layered else None
    wo = vm.to_local(bsdf.fx, bsdf.fy, bsdf.fz, hit.wo)

    # --- NEE (skipped for specular-only lobes; coated kinds always run it);
    # its draws are masked like the reference's, which consumes them only
    # when sample_Ld runs. Lanes without NEE trace their shadow ray with
    # t_max = 0, which the traversal answers at once.
    spec_only = (((kind == bxdfs.K_CONDUCTOR) | (kind == bxdfs.K_DIELECTRIC))
                 & sc.effectively_smooth(bsdf.params.ax, bsdf.params.ay))
    nee = shade & ~spec_only & (scene.lt_pmf.shape[0] > 0)
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

    # --- BSDF sampling
    r, uc = samplers.get_1d(r, shade, skind, spp)
    r, u2 = samplers.get_2d(r, shade, skind, spp)
    bs = bxdfs.sample(bsdf.params, wo, uc, u2)
    bs = bs._replace(wi=vm.from_local(bsdf.fx, bsdf.fy, bsdf.fz, bs.wi))
    cos_term = vm.absdot(bs.wi, hit.ns)
    beta_new = beta * bs.f * (cos_term / torch.clamp(bs.pdf, min=1e-20))[..., None]

    cont = shade & bs.valid & torch.any(beta_new > 0.0, dim=-1)
    if coat is not None:
        cont = cont & ~coat
    new_o = offset_ray_origin(hit.p, hit.ng, bs.wi, scene.ray_offset_scale)
    c3 = cont[..., None]
    out = state._replace(
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
        prev_pdf=torch.where(cont, bs.pdf, state.prev_pdf),
        prev_p=torch.where(shade[..., None], hit.p, state.prev_p),
        prev_ns=torch.where(shade[..., None], hit.ns, state.prev_ns),
    )
    lanes = None
    if coat is not None:
        lanes = CoatLanes(
            mask=coat, nee=coat & nee, lay=bsdf.lay, wo=wo, wi=wi, uc=uc, u2=u2, p=hit.p,
            ng=hit.ng, ns=hit.ns, beta=beta, light_wi=None if ls is None else ls.wi,
            light_L=None if ls is None else ls.L, light_pdf=pdf_light, light_ok=light_ok,
            light_delta=None if ls is None else ls.is_delta)
    return out, shadow, pending, lanes


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


# ------------------------------------------------------ K6 on the card
#
# csrc/path_step.cu: the parts of a bounce around the two dispatches and,
# on coated lanes, around K7's launches, one kernel each, one thread a lane.
# Every path-integrator render on the card takes them: uncoated and coated
# scenes, the independent, stratified and MLT sampler kinds.

# launches of the path-step kernels (plain ints, added to where each launches)
launches = {"path_rr": 0, "path_shade": 0, "path_coat": 0, "path_resolve": 0}
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
        n = xs[0].shape[0]
        return torch.cat([x.to(torch.float32).reshape(n, -1) for x in xs], dim=1)

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


def _lib():
    from pbrt_tpu_torch import kernels

    lib = kernels.load("path_step")
    if not hasattr(lib, "declared"):
        lib.pbrt_path_args_bytes.restype = ctypes.c_int
        if lib.pbrt_path_args_bytes() != ctypes.sizeof(_StepArgs):
            raise RuntimeError("csrc/path_step.cu's StepArgs is not integrators/path.py's")
        for fn in (lib.pbrt_path_rr, lib.pbrt_path_shade, lib.pbrt_path_coat,
                   lib.pbrt_path_resolve):
            fn.argtypes = [ctypes.POINTER(_StepArgs), ctypes.c_void_p]
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
        setattr(self.c, name, x.data_ptr())
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
        setattr(self.c, name, x.data_ptr())
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

    def launch(self, name):
        from pbrt_tpu_torch import kernels

        self.c.scratch = _scratch(self.dev).data_ptr()
        err = getattr(_lib(), f"pbrt_{name}")(ctypes.byref(self.c),
                                              torch.cuda.current_stream(self.dev).cuda_stream)
        kernels.check(err, name)
        launches[name] += 1


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


def shade_cuda(scene, meta, state: PathState, hit: dispatch.SceneHit, skind="independent",
               spp=0):
    """shade_plain's contract in one launch of csrc/path_step.cu
    `path_shade`; a scene without lights gives (state, None, None, lanes) as
    the plain version does."""
    a = _Args(state.o.shape[0], state.o.device, meta, skind, spp)
    a.state(state, ("o", "d", "L", "beta", "lam", "lam_pdf", "smp_state", "smp_inc",
                    "smp_pixel", "smp_sample", "smp_dim", "active", "specular", "depth",
                    "prev_pdf", "prev_p", "prev_ns"))
    a.put("hit_valid", hit.valid, dtype=torch.bool)
    for k in ("p", "ng", "ns"):
        a.put(f"hit_{k}", getattr(hit, k), 3)
    for k in ("mat", "light"):
        a.put(f"hit_{k}", getattr(hit, k), dtype=torch.int64)
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
    a.launch("path_shade")
    out = state._replace(smp=state.smp._replace(state=st, dim=dim), **out)
    if n_l == 0:
        return out, None, None, lanes
    return out, shadow, NeePending(nee, state.beta, ld), lanes


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


def bounce_step(scene, meta, state: PathState, skind="independent", spp=0):
    """One bounce for all lanes -> the updated PathState: the loop head (RR),
    the closest hits, shading with the NEE light sample and the BSDF sample,
    on coated lanes K7's walks (layered_f and layered_pdf at the light, the
    layered sample) and their finish (coat), the MIS pdf of the coated lanes
    that go on (K7's layered_pdf), the shadow rays, and the direct light
    they let through. On the "cuda" route (step_route) the parts are the
    kernels of csrc/path_step.cu, else their plain versions; K7 runs as
    csrc/layered.cu on CUDA tensors either way."""
    if step_route(state.o.device, meta, skind) == "cuda":
        rr, shade, coat, resolve = rr_cuda, shade_cuda, coat_cuda, resolve_cuda
    else:
        rr, shade, coat, resolve = rr_plain, shade_plain, coat_plain, resolve_plain
    state, t_max = rr(meta, state, skind, spp)
    hit = dispatch.intersect(scene, meta, state.o, state.d, t_max)
    state, shadow, pending, lanes = shade(scene, meta, state, hit, skind, spp)
    mis = None
    if lanes is not None:
        state, pending, mis_mask, mis_wi = coat(scene, state, pending, lanes,
                                                *layered_answers(lanes, pending))
        mis = (mis_mask, layered.layered_pdf(lanes.lay, lanes.wo, mis_wi, mask=mis_mask))
    if pending is None:
        return state if mis is None else resolve(state, None, None, mis)
    return resolve(state, pending, dispatch.occluded(scene, meta, shadow.o, shadow.d,
                                                     shadow.t_max), mis)
