"""Material evaluation: material table rows + hit context -> BxdfParams
(counterpart of pbrt_tpu/materials/materials.py without textures, mix and
layered materials; reference materials/*.cu get_bxdf())."""
from typing import NamedTuple

import torch

from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.materials import bxdfs, scattering as sc
from pbrt_tpu_torch.spectral import spectra, sampled
from pbrt_tpu_torch.scene import builder as bd


class Bsdf(NamedTuple):
    """Shading frame + per-lane bxdf parameters."""

    params: bxdfs.BxdfParams
    fx: torch.Tensor  # frame axes (R,3)
    fy: torch.Tensor
    fz: torch.Tensor


def make_bsdf(scene, mat_idx, ns, wl: sampled.Wavelengths):
    """Material mat_idx (R,) -> (Bsdf around ns, new wavelengths): a
    dispersive dielectric terminates the secondary wavelengths (reference
    dielectric_material.cu:40-47)."""
    m = torch.clamp(mat_idx, min=0).long()
    mtype = scene.mat_type[m]
    remap = scene.mat_remap[m]
    urough = scene.mat_urough[m]
    vrough = scene.mat_vrough[m]
    eta_spec = scene.mat_eta_spec[m].long()
    k_spec = scene.mat_k_spec[m].long()
    refl_mode = scene.mat_refl_mode[m]

    refl = torch.clamp(spectra.sigmoid_polynomial(scene.mat_refl_c[m], wl.lam), 0.0, 1.0)
    trans = torch.clamp(spectra.sigmoid_polynomial(scene.mat_trans_c[m], wl.lam), 0.0, 1.0)

    ax = torch.clamp(torch.where(remap, sc.roughness_to_alpha(urough), urough), min=1e-4)
    ay = torch.clamp(torch.where(remap, sc.roughness_to_alpha(vrough), vrough), min=1e-4)

    # conductor spectral IOR; reflectance mode: eta = 1, k = 2 sqrt(r)/sqrt(1-r)
    eta_rows = spectra.sample_table(scene.spec_table, torch.clamp(eta_spec, min=0), wl.lam)
    k_rows = spectra.sample_table(scene.spec_table, torch.clamp(k_spec, min=0), wl.lam)
    r_clamped = torch.clamp(refl, 0.0, 0.9999)
    k_from_r = 2.0 * torch.sqrt(torch.clamp(r_clamped, min=1e-12)) / torch.sqrt(
        torch.clamp(1.0 - r_clamped, 1e-7, 1.0))
    eta_re = torch.where(refl_mode[..., None], torch.ones_like(eta_rows), eta_rows)
    eta_im = torch.where(refl_mode[..., None], k_from_r, k_rows)

    # dielectric eta: float, or the hero wavelength's spectral value
    has_eta_spec = eta_spec >= 0
    eta_d = torch.where(has_eta_spec, eta_rows[..., 0], scene.mat_eta[m])
    eta_d = torch.where(eta_d == 0.0, 1.0, eta_d)

    is_dispersive = (mtype == bd.MAT_DIELECTRIC) & has_eta_spec
    new_pdf = torch.where(is_dispersive[..., None], sampled.terminate_secondary(wl).pdf, wl.pdf)

    kind = torch.where(mtype == bd.MAT_DIFFUSE, bxdfs.K_DIFFUSE, torch.where(
        mtype == bd.MAT_CONDUCTOR, bxdfs.K_CONDUCTOR, torch.where(
            mtype == bd.MAT_DIELECTRIC, bxdfs.K_DIELECTRIC, bxdfs.K_DIFF_TRANS)))
    params = bxdfs.BxdfParams(kind=kind, refl=refl, trans=trans, eta_re=eta_re,
                              eta_im=eta_im, eta=eta_d, ax=ax, ay=ay)
    fx, fy, fz = vm.frame_from_z(ns)
    return Bsdf(params=params, fx=fx, fy=fy, fz=fz), sampled.Wavelengths(wl.lam, new_pdf)


def bsdf_f(b: Bsdf, wo_w, wi_w):
    return bxdfs.f(b.params, vm.to_local(b.fx, b.fy, b.fz, wo_w),
                   vm.to_local(b.fx, b.fy, b.fz, wi_w))


def bsdf_pdf(b: Bsdf, wo_w, wi_w):
    return bxdfs.pdf(b.params, vm.to_local(b.fx, b.fy, b.fz, wo_w),
                     vm.to_local(b.fx, b.fy, b.fz, wi_w))


def bsdf_sample(b: Bsdf, wo_w, uc, u2):
    s = bxdfs.sample(b.params, vm.to_local(b.fx, b.fy, b.fz, wo_w), uc, u2)
    return s._replace(wi=vm.from_local(b.fx, b.fy, b.fz, s.wi))
