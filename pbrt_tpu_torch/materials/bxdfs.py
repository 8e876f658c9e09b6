"""BxDFs, vectorized and branchless (counterpart of
pbrt_tpu/materials/bxdfs.py; reference bxdfs/): every lane carries a `kind`
code plus a superset of parameters, and f/pdf/sample evaluate every kind and
select by kind. Directions are in the local shading frame (z = shading
normal); wo and wi point away from the surface; f() has no cosine; smooth
lobes return f = pdf = 0 and scatter only through sample() with pdf 1.
"""
from typing import NamedTuple

import torch

from pbrt_tpu_torch.utils.math import INV_PI, sqr
from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.materials import scattering as sc
from pbrt_tpu_torch.sampling import warps

K_DIFFUSE = 0
K_CONDUCTOR = 1
K_DIELECTRIC = 2
K_DIFF_TRANS = 3
K_COATED_DIFFUSE = 4    # layered: dielectric over diffuse (materials/layered.py)
K_COATED_CONDUCTOR = 5  # layered: dielectric over conductor

F_REFLECTION = 1
F_TRANSMISSION = 2
F_DIFFUSE = 4
F_GLOSSY = 8
F_SPECULAR = 16


class BxdfParams(NamedTuple):
    kind: torch.Tensor      # (R,) int
    refl: torch.Tensor      # (R,4) reflectance (diffuse/difftrans)
    trans: torch.Tensor     # (R,4) transmittance (difftrans)
    eta_re: torch.Tensor    # (R,4) conductor eta
    eta_im: torch.Tensor    # (R,4) conductor k
    eta: torch.Tensor       # (R,) dielectric relative IOR (hero wavelength)
    ax: torch.Tensor        # (R,)
    ay: torch.Tensor


class BSDFSample(NamedTuple):
    f: torch.Tensor         # (R,4)
    wi: torch.Tensor        # (R,3)
    pdf: torch.Tensor       # (R,)
    flags: torch.Tensor     # (R,) int
    eta: torch.Tensor       # (R,) relative eta of the event
    valid: torch.Tensor     # (R,) bool


def _same_hemisphere(wo, wi):
    return wo[..., 2] * wi[..., 2] > 0.0


def _safe_alphas(p: BxdfParams):
    """Effectively-smooth lanes take the specular branch; their unselected
    rough formulas run with a tame stand-in alpha."""
    smooth = sc.effectively_smooth(p.ax, p.ay)
    return smooth, torch.where(smooth, 0.25, p.ax), torch.where(smooth, 0.25, p.ay)


def _by_kind(kind, diff, cond, diel, dt):
    k = kind[..., None] if diff.dim() > kind.dim() else kind
    return torch.where(k == K_DIFFUSE, diff, torch.where(
        k == K_CONDUCTOR, cond, torch.where(k == K_DIELECTRIC, diel, dt)))


def f(p: BxdfParams, wo, wi):
    """(R,4) BSDF value. Smooth specular lobes contribute 0 here."""
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    same = _same_hemisphere(wo, wi)

    f_diff = torch.where(same[..., None], p.refl * INV_PI, 0.0)
    f_dt = torch.where(same[..., None], p.refl * INV_PI, p.trans * INV_PI)

    # rough conductor
    smooth, ax_s, ay_s = _safe_alphas(p)
    wm_r = wo + wi
    wm_len = vm.length(wm_r)
    wm = wm_r / torch.clamp(wm_len, min=1e-12)[..., None]
    wm = torch.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    Fc = sc.fr_complex(vm.absdot(wo, wm)[..., None], p.eta_re, p.eta_im)
    denom = 4.0 * torch.abs(cos_o * cos_i)
    d_term = sc.tr_d(wm, ax_s, ay_s) * sc.tr_g(wo, wi, ax_s, ay_s)
    f_cond = torch.where(
        (same & ~smooth & (wm_len > 1e-9) & (denom > 1e-12))[..., None],
        Fc * (d_term / torch.clamp(denom, min=1e-12))[..., None],
        0.0,
    )

    # rough dielectric (reflection + transmission)
    refl_case = same
    etap = torch.where(refl_case, 1.0, torch.where(cos_o > 0.0, p.eta, 1.0 / p.eta))
    wm_d = wi * etap[..., None] + wo
    wm_d_len2 = vm.length_squared(wm_d)
    wm_dn = wm_d / torch.sqrt(torch.clamp(wm_d_len2, min=1e-24))[..., None]
    wm_dn = torch.where((wm_dn[..., 2] < 0.0)[..., None], -wm_dn, wm_dn)
    backfacing = (vm.dot(wm_dn, wi) * cos_i < 0.0) | (vm.dot(wm_dn, wo) * cos_o < 0.0)
    Fd, _, _ = sc.fr_dielectric(vm.dot(wo, wm_dn), p.eta)
    D = sc.tr_d(wm_dn, ax_s, ay_s)
    G = sc.tr_g(wo, wi, ax_s, ay_s)
    f_diel_r = D * Fd * G / torch.clamp(4.0 * torch.abs(cos_o * cos_i), min=1e-12)
    denom_t = sqr(vm.dot(wi, wm_dn) + vm.dot(wo, wm_dn) / etap)
    f_diel_t = (
        D * (1.0 - Fd) * G
        * torch.abs(vm.dot(wi, wm_dn) * vm.dot(wo, wm_dn))
        / torch.clamp(torch.abs(cos_i * cos_o) * denom_t, min=1e-12)
        / sqr(etap)
    )
    f_diel = torch.where(refl_case, f_diel_r, f_diel_t)
    f_diel = torch.where(smooth | backfacing | (wm_d_len2 < 1e-18), 0.0, f_diel)
    f_diel4 = f_diel[..., None] * torch.ones_like(p.refl)

    out = _by_kind(p.kind, f_diff, f_cond, f_diel4, f_dt)
    degen = (cos_o == 0.0) | (cos_i == 0.0)
    return torch.where(degen[..., None], 0.0, out)


def pdf(p: BxdfParams, wo, wi, allow_refl=True, allow_trans=True):
    """(R,) solid-angle pdf of sample() for non-specular lobes. allow_*
    restrict the dielectric lobe choice (BxDFReflTransFlags)."""
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    same = _same_hemisphere(wo, wi)

    pdf_diff = torch.where(same, torch.abs(cos_i) * INV_PI, 0.0)

    pr = torch.amax(p.refl, dim=-1)
    pt = torch.amax(p.trans, dim=-1)
    tot = torch.clamp(pr + pt, min=1e-12)
    pdf_dt = torch.where(same, pr / tot, pt / tot) * torch.abs(cos_i) * INV_PI

    smooth, ax_s, ay_s = _safe_alphas(p)
    wm_r = wo + wi
    wm_len = vm.length(wm_r)
    wm = wm_r / torch.clamp(wm_len, min=1e-12)[..., None]
    wm_f = torch.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    pdf_cond = torch.where(
        same & ~smooth & (wm_len > 1e-9),
        sc.tr_pdf(wo, wm_f, ax_s, ay_s) / torch.clamp(4.0 * vm.absdot(wo, wm_f), min=1e-12),
        0.0,
    )

    refl_case = same
    etap = torch.where(refl_case, 1.0, torch.where(cos_o > 0.0, p.eta, 1.0 / p.eta))
    wm_d = wi * etap[..., None] + wo
    wm_d_len2 = vm.length_squared(wm_d)
    wm_dn = wm_d / torch.sqrt(torch.clamp(wm_d_len2, min=1e-24))[..., None]
    wm_dn = torch.where((wm_dn[..., 2] < 0.0)[..., None], -wm_dn, wm_dn)
    backfacing = (vm.dot(wm_dn, wi) * cos_i < 0.0) | (vm.dot(wm_dn, wo) * cos_o < 0.0)
    Fd, _, _ = sc.fr_dielectric(vm.dot(wo, wm_dn), p.eta)
    R = Fd if allow_refl else torch.zeros_like(Fd)
    Tt = (1.0 - Fd) if allow_trans else torch.zeros_like(Fd)
    tot_d = torch.clamp(R + Tt, min=1e-12)
    pdf_d_r = sc.tr_pdf(wo, wm_dn, ax_s, ay_s) / torch.clamp(
        4.0 * vm.absdot(wo, wm_dn), min=1e-12) * (R / tot_d)
    denom_t = sqr(vm.dot(wi, wm_dn) + vm.dot(wo, wm_dn) / etap)
    dwm_dwi = vm.absdot(wi, wm_dn) / torch.clamp(denom_t, min=1e-12)
    pdf_d_t = sc.tr_pdf(wo, wm_dn, ax_s, ay_s) * dwm_dwi * (Tt / tot_d)
    pdf_diel = torch.where(refl_case, pdf_d_r, pdf_d_t)
    pdf_diel = torch.where(smooth | backfacing | (wm_d_len2 < 1e-18), 0.0, pdf_diel)

    out = _by_kind(p.kind, pdf_diff, pdf_cond, pdf_diel, pdf_dt)
    if not allow_refl:
        out = torch.where(p.kind == K_DIELECTRIC, out, 0.0)
    return torch.where((cos_o == 0.0) | (cos_i == 0.0), 0.0, out)


def sample(p: BxdfParams, wo, uc, u2, allow_refl=True, allow_trans=True,
           mode_radiance=True):
    """Sample an outgoing direction. uc: (R,) lobe choice; u2: (R,2).
    Specular events have pdf 1 and F_SPECULAR. allow_refl/allow_trans
    restrict the dielectric's lobe choice (the layered walk forces entry and
    exit transmission); reflection-only kinds are invalid without
    allow_refl. mode_radiance=False is importance transport: no 1/eta^2 on
    refraction."""
    cos_o = wo[..., 2]
    smooth, ax_s, ay_s = _safe_alphas(p)
    flip_z = torch.tensor([1.0, 1.0, -1.0], device=wo.device)

    # ---- diffuse / diffuse-transmission
    wi_cos = warps.sample_cosine_hemisphere(u2)
    wi_diff = torch.where((cos_o < 0.0)[..., None], wi_cos * flip_z, wi_cos)
    pdf_diff = torch.abs(wi_diff[..., 2]) * INV_PI
    f_diff = p.refl * INV_PI

    pr = torch.amax(p.refl, dim=-1)
    pt = torch.amax(p.trans, dim=-1)
    tot_dt = torch.clamp(pr + pt, min=1e-12)
    dt_reflect = uc < pr / tot_dt
    wi_dt = torch.where(dt_reflect[..., None] ^ (cos_o < 0.0)[..., None],
                        wi_cos, wi_cos * flip_z)
    f_dt = torch.where(dt_reflect[..., None], p.refl, p.trans) * INV_PI
    pdf_dt = torch.abs(wi_dt[..., 2]) * INV_PI * torch.where(dt_reflect, pr / tot_dt, pt / tot_dt)

    # ---- conductor
    wi_spec = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    abs_cos_spec = torch.clamp(vm.abs_cos_theta(wi_spec), min=1e-9)
    F_spec = sc.fr_complex(abs_cos_spec[..., None], p.eta_re, p.eta_im)
    f_cond_smooth = F_spec / abs_cos_spec[..., None]

    wm = sc.tr_sample_wm(torch.where((cos_o < 0.0)[..., None], -wo, wo), u2, ax_s, ay_s)
    wm = torch.where((cos_o < 0.0)[..., None], -wm, wm)
    wi_rough = sc.reflect(wo, wm)
    same_r = _same_hemisphere(wo, wi_rough)
    Fc = sc.fr_complex(vm.absdot(wo, wm)[..., None], p.eta_re, p.eta_im)
    d_g = sc.tr_d(wm, ax_s, ay_s) * sc.tr_g(wo, wi_rough, ax_s, ay_s)
    denom = 4.0 * torch.abs(cos_o * wi_rough[..., 2])
    f_cond_rough = Fc * (d_g / torch.clamp(denom, min=1e-12))[..., None]
    pdf_cond_rough = sc.tr_pdf(wo, wm, ax_s, ay_s) / torch.clamp(
        4.0 * vm.absdot(wo, wm), min=1e-12)
    wi_cond = torch.where(smooth[..., None], wi_spec, wi_rough)
    f_cond = torch.where(smooth[..., None], f_cond_smooth, f_cond_rough)
    pdf_cond = torch.where(smooth, 1.0, pdf_cond_rough)
    valid_cond = torch.where(smooth, cos_o != 0.0, same_r & (cos_o != 0.0))
    flags_cond = torch.where(smooth, F_SPECULAR | F_REFLECTION, F_GLOSSY | F_REFLECTION)

    # ---- dielectric, smooth
    Fsd, _, _ = sc.fr_dielectric(cos_o, p.eta)
    Rs = Fsd if allow_refl else torch.zeros_like(Fsd)
    Ts = (1.0 - Fsd) if allow_trans else torch.zeros_like(Fsd)
    choose_refl_s = uc < Rs / torch.clamp(Rs + Ts, min=1e-12)
    f_d_refl = Fsd / torch.clamp(vm.abs_cos_theta(wi_spec), min=1e-9)
    pdf_d_refl = Rs / torch.clamp(Rs + Ts, min=1e-12)
    n_local = torch.zeros_like(wo)
    n_local[..., 2] = 1.0
    wt, refr_valid, etap_s = sc.refract(wo, n_local, p.eta)
    f_d_trans = (1.0 - Fsd) / torch.clamp(vm.abs_cos_theta(wt), min=1e-9)
    if mode_radiance:
        f_d_trans = f_d_trans / sqr(etap_s)
    pdf_d_trans = Ts / torch.clamp(Rs + Ts, min=1e-12)
    wi_d_smooth = torch.where(choose_refl_s[..., None], wi_spec, wt)
    f_d_smooth = torch.where(choose_refl_s, f_d_refl, f_d_trans)
    pdf_d_smooth = torch.where(choose_refl_s, pdf_d_refl, pdf_d_trans)
    valid_d_smooth = torch.where(choose_refl_s, cos_o != 0.0, refr_valid)
    eta_event_smooth = torch.where(choose_refl_s, 1.0, etap_s)
    flags_d_smooth = torch.where(choose_refl_s, F_SPECULAR | F_REFLECTION,
                                 F_SPECULAR | F_TRANSMISSION)

    # ---- dielectric, rough: sample wm, Fresnel split, reflect/refract
    Frd, _, _ = sc.fr_dielectric(vm.dot(wo, wm), p.eta)
    Rr = Frd if allow_refl else torch.zeros_like(Frd)
    Tr = (1.0 - Frd) if allow_trans else torch.zeros_like(Frd)
    choose_refl_r = uc < Rr / torch.clamp(Rr + Tr, min=1e-12)
    wi_r_refl = sc.reflect(wo, wm)
    same_rr = _same_hemisphere(wo, wi_r_refl)
    D = sc.tr_d(wm, ax_s, ay_s)
    G_r = sc.tr_g(wo, wi_r_refl, ax_s, ay_s)
    f_r_refl = D * G_r * Frd / torch.clamp(4.0 * torch.abs(cos_o * wi_r_refl[..., 2]), min=1e-12)
    pdf_r_refl = sc.tr_pdf(wo, wm, ax_s, ay_s) / torch.clamp(
        4.0 * vm.absdot(wo, wm), min=1e-12) * (Rr / torch.clamp(Rr + Tr, min=1e-12))
    wt_r, refr_valid_r, etap_r = sc.refract(wo, wm, p.eta)
    same_tt = _same_hemisphere(wo, wt_r)
    cos_i_t = wt_r[..., 2]
    denom_t = sqr(vm.dot(wt_r, wm) + vm.dot(wo, wm) / etap_r)
    G_t = sc.tr_g(wo, wt_r, ax_s, ay_s)
    f_r_trans = D * (1.0 - Frd) * G_t * torch.abs(
        vm.dot(wt_r, wm) * vm.dot(wo, wm)
        / torch.clamp(torch.abs(cos_i_t * cos_o) * denom_t, min=1e-12))
    if mode_radiance:
        f_r_trans = f_r_trans / sqr(etap_r)
    dwm_dwi = vm.absdot(wt_r, wm) / torch.clamp(denom_t, min=1e-12)
    pdf_r_trans = sc.tr_pdf(wo, wm, ax_s, ay_s) * dwm_dwi * (
        Tr / torch.clamp(Rr + Tr, min=1e-12))
    wi_d_rough = torch.where(choose_refl_r[..., None], wi_r_refl, wt_r)
    f_d_rough = torch.where(choose_refl_r, f_r_refl, f_r_trans)
    pdf_d_rough = torch.where(choose_refl_r, pdf_r_refl, pdf_r_trans)
    valid_d_rough = torch.where(choose_refl_r, same_rr, refr_valid_r & ~same_tt)
    eta_event_rough = torch.where(choose_refl_r, 1.0, etap_r)
    flags_d_rough = torch.where(choose_refl_r, F_GLOSSY | F_REFLECTION,
                                F_GLOSSY | F_TRANSMISSION)

    wi_diel = torch.where(smooth[..., None], wi_d_smooth, wi_d_rough)
    f_diel = torch.where(smooth, f_d_smooth, f_d_rough)[..., None] * torch.ones_like(p.refl)
    pdf_diel = torch.where(smooth, pdf_d_smooth, pdf_d_rough)
    valid_diel = torch.where(smooth, valid_d_smooth, valid_d_rough)
    eta_diel = torch.where(smooth, eta_event_smooth, eta_event_rough)
    flags_diel = torch.where(smooth, flags_d_smooth, flags_d_rough)

    # ---- combine by kind
    kind = p.kind
    wi = _by_kind(kind, wi_diff, wi_cond, wi_diel, wi_dt)
    f_out = _by_kind(kind, f_diff, f_cond, f_diel, f_dt)
    pdf_out = _by_kind(kind, pdf_diff, pdf_cond, pdf_diel, pdf_dt)
    flags = _by_kind(kind, torch.full_like(kind, F_DIFFUSE | F_REFLECTION), flags_cond,
                     flags_diel, torch.full_like(kind, F_DIFFUSE | F_REFLECTION | F_TRANSMISSION))
    nonzero = cos_o != 0.0
    valid = _by_kind(kind, nonzero, valid_cond, valid_diel, nonzero)
    if not allow_refl:  # reflection-only kinds cannot produce transmission
        valid = valid & (kind == K_DIELECTRIC)
    eta_event = torch.where(kind == K_DIELECTRIC, eta_diel, 1.0)
    valid = valid & (pdf_out > 0.0)
    return BSDFSample(f=f_out, wi=wi, pdf=pdf_out, flags=flags, eta=eta_event, valid=valid)


def is_specular(flags):
    return (flags & F_SPECULAR) != 0


def is_transmission(flags):
    return (flags & F_TRANSMISSION) != 0
