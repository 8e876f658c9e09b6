"""Triangle area lights (counterpart of the area-light parts of
pbrt_tpu/lights/lights.py; reference lights/ + shapes/triangle.cu:25-211):
spherical-triangle sampling with a bilinear cosine warp inside the
[MIN, MAX] solid-angle window, uniform-area sampling outside it."""
from typing import NamedTuple

import torch

from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.sampling import warps
from pbrt_tpu_torch.spectral import spectra

MIN_SPHERICAL_SAMPLE_AREA = 3e-4
MAX_SPHERICAL_SAMPLE_AREA = 6.22


class LightLiSample(NamedTuple):
    L: torch.Tensor        # (R,4)
    wi: torch.Tensor       # (R,3)
    pdf: torch.Tensor      # (R,) solid-angle pdf
    p_light: torch.Tensor  # (R,3)
    valid: torch.Tensor    # (R,)


def emission(scene, light_idx, lam):
    """scale * Lemit(lam) of light light_idx: (R,4)."""
    li = torch.clamp(light_idx, min=0).long()
    return spectra.sample_table(scene.lt_emission, li, lam) * scene.lt_scale[li][..., None]


def area_light_le(scene, light_idx, n, w, lam):
    """Radiance leaving an emissive surface hit: zero from the back side
    unless two-sided."""
    li = torch.clamp(light_idx, min=0).long()
    ok = (vm.dot(n, w) > 0.0) | scene.lt_twosided[li]
    return torch.where((ok & (light_idx >= 0))[..., None], emission(scene, light_idx, lam), 0.0)


def _tri_verts(scene, light_idx):
    t = torch.clamp(scene.lt_tri[torch.clamp(light_idx, min=0).long()], min=0).long()
    return scene.tri_p0[t], scene.tri_p1[t], scene.tri_p2[t]


def _tri_solid_angle(p0, p1, p2, p):
    return vm.spherical_triangle_area(
        vm.normalize(p0 - p), vm.normalize(p1 - p), vm.normalize(p2 - p))


def _tri_area_normal(p0, p1, p2):
    cr = vm.cross(p1 - p0, p2 - p0)
    area = 0.5 * vm.length(cr)
    return area, cr / torch.clamp(2.0 * area, min=1e-12)[..., None]


def _corner_weights(ns_ref, p0, p1, p2, p_ref):
    wi0 = vm.normalize(p0 - p_ref)
    wi1 = vm.normalize(p1 - p_ref)
    wi2 = vm.normalize(p2 - p_ref)
    return torch.stack([
        torch.clamp(vm.absdot(ns_ref, wi1), min=0.01),
        torch.clamp(vm.absdot(ns_ref, wi1), min=0.01),
        torch.clamp(vm.absdot(ns_ref, wi0), min=0.01),
        torch.clamp(vm.absdot(ns_ref, wi2), min=0.01),
    ], dim=-1)


def sample_area_light_li(scene, light_idx, p_ref, ns_ref, u2):
    """-> (p_light (R,3), n_light (R,3), pdf_sa (R,), valid)."""
    p0, p1, p2 = _tri_verts(scene, light_idx)
    area, n_geo = _tri_area_normal(p0, p1, p2)
    sa = _tri_solid_angle(p0, p1, p2, p_ref)
    use_area = (sa < MIN_SPHERICAL_SAMPLE_AREA) | (sa > MAX_SPHERICAL_SAMPLE_AREA)

    # uniform-area sampling, pdf converted to solid angle
    b_area = warps.sample_uniform_triangle(u2)
    pA = b_area[..., 0:1] * p0 + b_area[..., 1:2] * p1 + b_area[..., 2:3] * p2
    wiA = pA - p_ref
    dist2A = vm.length_squared(wiA)
    wiA_n = wiA / torch.sqrt(torch.clamp(dist2A, min=1e-24))[..., None]
    cosA = vm.absdot(n_geo, -wiA_n)
    pdfA = (1.0 / torch.clamp(area, min=1e-12)) * dist2A / torch.clamp(cosA, min=1e-9)
    validA = (dist2A > 0.0) & (cosA > 1e-7) & torch.isfinite(pdfA)

    # spherical triangle with the bilinear cosine warp at the receiver
    has_ns = vm.length_squared(ns_ref) > 0.0
    w_corner = _corner_weights(ns_ref, p0, p1, p2, p_ref)
    u_warp = torch.where(has_ns[..., None], warps.sample_bilinear(u2, w_corner), u2)
    pdf_warp = torch.where(has_ns, warps.bilinear_pdf(u_warp, w_corner), 1.0)
    b_sph, pdf_tri = warps.sample_spherical_triangle(p0, p1, p2, p_ref, u_warp)
    pB = b_sph[..., 0:1] * p0 + b_sph[..., 1:2] * p1 + b_sph[..., 2:3] * p2

    p_light = torch.where(use_area[..., None], pA, pB)
    pdf = torch.where(use_area, pdfA, pdf_tri * pdf_warp)
    valid = torch.where(use_area, validA, pdf_tri > 0.0)
    return p_light, n_geo, pdf, valid


def area_light_pdf_li(scene, light_idx, p_ref, ns_ref, wi, hit_p, hit_n):
    """Solid-angle pdf that sample_area_light_li generates wi towards the
    known hit point (hit_p, geometric normal hit_n) on the light."""
    p0, p1, p2 = _tri_verts(scene, light_idx)
    area, _ = _tri_area_normal(p0, p1, p2)
    sa = _tri_solid_angle(p0, p1, p2, p_ref)
    use_area = (sa < MIN_SPHERICAL_SAMPLE_AREA) | (sa > MAX_SPHERICAL_SAMPLE_AREA)

    dist2 = vm.length_squared(hit_p - p_ref)
    cos_l = vm.absdot(hit_n, -wi)
    pdfA = dist2 / torch.clamp(area * torch.clamp(cos_l, min=1e-9), min=1e-12)
    pdfA = torch.where(torch.isfinite(pdfA), pdfA, 0.0)

    has_ns = vm.length_squared(ns_ref) > 0.0
    u_inv = warps.invert_spherical_triangle_sample(p0, p1, p2, p_ref, wi)
    w_corner = _corner_weights(ns_ref, p0, p1, p2, p_ref)
    pdfB = 1.0 / torch.clamp(sa, min=1e-12) * torch.where(
        has_ns, warps.bilinear_pdf(u_inv, w_corner), 1.0)
    tri_pdf = torch.where(use_area, pdfA, pdfB)
    lt_tri = scene.lt_tri[torch.clamp(light_idx, min=0).long()]
    return torch.where(lt_tri >= 0, tri_pdf, 0.0)


def sample_li(scene, light_idx, p_ref, ns_ref, u2, lam):
    """Li sample of triangle area light light_idx (R,) seen from p_ref."""
    li = torch.clamp(light_idx, min=0).long()
    em = emission(scene, light_idx, lam)
    p_a, n_a, pdf, valid = sample_area_light_li(scene, light_idx, p_ref, ns_ref, u2)
    wi = vm.normalize(p_a - p_ref)
    L = torch.where((vm.dot(n_a, -wi) > 0.0) | scene.lt_twosided[li], 1.0, 0.0)[..., None] * em
    valid = valid & (light_idx >= 0) & (pdf > 0.0)
    return LightLiSample(L=L, wi=wi, pdf=pdf, p_light=p_a, valid=valid)
