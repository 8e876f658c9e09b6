"""Microfacet distribution and Fresnel functions (counterpart of
pbrt_tpu/materials/scattering.py; reference util/scattering.h):
Trowbridge–Reitz (GGX) with visible-normal sampling, dielectric and
complex-conductor Fresnel, on (...,) lanes in the local shading frame."""
import torch

from pbrt_tpu_torch.utils.math import PI, safe_sqrt, sqr, lerp
from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.sampling import warps


def roughness_to_alpha(roughness):
    return torch.sqrt(torch.clamp(roughness, min=1e-8))


def effectively_smooth(ax, ay):
    return torch.maximum(ax, ay) < 1e-3


def tr_d(wm, ax, ay):
    """GGX NDF D(wm) in ellipsoid form."""
    x, y, z = wm[..., 0], wm[..., 1], wm[..., 2]
    k = sqr(x / ax) + sqr(y / ay) + sqr(z)
    return 1.0 / (PI * ax * ay * torch.clamp(sqr(k), min=1e-16))


def tr_lambda(w, ax, ay):
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    t = (sqr(ax * x) + sqr(ay * y)) / torch.clamp(sqr(z), min=1e-12)
    return (safe_sqrt(1.0 + t) - 1.0) / 2.0


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_pdf(w, wm, ax, ay):
    """Visible-normal density."""
    return (
        tr_g1(w, ax, ay)
        / torch.clamp(vm.abs_cos_theta(w), min=1e-9)
        * tr_d(wm, ax, ay)
        * vm.absdot(w, wm)
    )


def tr_sample_wm(w, u, ax, ay):
    """Sample a visible microfacet normal (Heitz 2018 VNDF warp)."""
    wh = vm.normalize(torch.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], dim=-1))
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    up = torch.zeros_like(wh)
    up[..., 2] = 1.0
    xaxis = torch.zeros_like(wh)
    xaxis[..., 0] = 1.0
    not_polar = (wh[..., 2] < 0.999)[..., None]
    c = torch.where(not_polar, vm.cross(up, wh), xaxis)
    t1 = torch.where(not_polar, vm.normalize(c), xaxis)
    t2 = vm.cross(wh, t1)
    p = warps.sample_uniform_disk_polar(u)
    h = safe_sqrt(1.0 - sqr(p[..., 0]))
    ph_y = lerp((1.0 + wh[..., 2]) / 2.0, h, p[..., 1])
    pz = safe_sqrt(1.0 - sqr(p[..., 0]) - sqr(ph_y))
    nh = p[..., 0][..., None] * t1 + ph_y[..., None] * t2 + pz[..., None] * wh
    wm = torch.stack(
        [ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)], dim=-1)
    return vm.normalize(wm)


def fr_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance, real eta; cos_theta_i < 0 enters
    from below (eta inverted). Returns (F, cos_theta_t, eta_eff)."""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    eta_eff = torch.where(cos_theta_i < 0.0, 1.0 / eta, eta)
    cos_i = torch.abs(cos_theta_i)
    sin2_i = 1.0 - sqr(cos_i)
    sin2_t = sin2_i / sqr(eta_eff)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    r_parl = (eta_eff * cos_i - cos_t) / torch.clamp(eta_eff * cos_i + cos_t, min=1e-12)
    r_perp = (cos_i - eta_eff * cos_t) / torch.clamp(cos_i + eta_eff * cos_t, min=1e-12)
    F = (sqr(r_parl) + sqr(r_perp)) / 2.0
    return torch.where(tir, 1.0, F), cos_t, eta_eff


def fr_complex(cos_theta_i, eta_re, eta_im):
    """Fresnel for conductors with complex IOR; spectral args (..., 4)."""
    cos_i = torch.clamp(cos_theta_i, 0.0, 1.0)
    sin2_i = 1.0 - sqr(cos_i)
    degenerate = sqr(eta_re) + sqr(eta_im) < 1e-12
    eta_re = torch.where(degenerate, 1.0, eta_re)
    eta = torch.complex(eta_re, eta_im)
    sin2_t = sin2_i / (eta * eta)
    cos_t = torch.sqrt(1.0 - sin2_t)
    r_parl = (eta * cos_i - cos_t) / (eta * cos_i + cos_t)
    r_perp = (cos_i - eta * cos_t) / (cos_i + eta * cos_t)
    return (torch.abs(r_parl) ** 2 + torch.abs(r_perp) ** 2) / 2.0


def reflect(wo, n):
    return -wo + 2.0 * vm.dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Snell refraction; wi points away from the surface. -> (wt, valid,
    eta_eff)."""
    cos_i = vm.dot(n, wi)
    flip = cos_i < 0.0
    eta_eff = torch.where(flip, 1.0 / eta, eta)
    cos_i_a = torch.abs(cos_i)
    n_f = torch.where(flip[..., None], -n, n)
    sin2_i = torch.clamp(1.0 - sqr(cos_i_a), min=0.0)
    sin2_t = sin2_i / sqr(eta_eff)
    valid = sin2_t < 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    wt = -wi / eta_eff[..., None] + (cos_i_a / eta_eff - cos_t)[..., None] * n_f
    return wt, valid, eta_eff
