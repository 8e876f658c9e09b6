"""Material evaluation: material table rows + hit context -> BxdfParams
(counterpart of pbrt_tpu/materials/materials.py; reference materials/*.cu
get_bxdf()). Coated materials (coateddiffuse, coatedconductor) carry the
parameters of a layered BxDF (materials/layered.py, K7) beside the per-lane
BxdfParams. A mix material is resolved to one of its two materials per hit
(resolve_mix); textured slots override the material's constant
reflectance, transmittance and roughness (textures.slot_values, or K13's
TexLanes)."""
from typing import NamedTuple, Optional

import torch

from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.materials import bxdfs, layered, scattering as sc
from pbrt_tpu_torch.sampling import rng
from pbrt_tpu_torch.spectral import spectra, sampled
from pbrt_tpu_torch.scene import builder as bd
from pbrt_tpu_torch.textures import textures as texlib


class Bsdf(NamedTuple):
    """Shading frame + per-lane bxdf parameters (+ the layered parameters
    when the scene has coated materials, else None)."""

    params: bxdfs.BxdfParams
    fx: torch.Tensor  # frame axes (R,3)
    fy: torch.Tensor
    fz: torch.Tensor
    lay: Optional[layered.LayeredParams] = None


def _float_bits(x):
    """The u32 bits of float32 x, in int64."""
    return x.contiguous().view(torch.int32).long() & rng.M32


def resolve_mix(scene, mat_idx, p, wo):
    """Each lane's material with mix materials resolved (JAX materials.py:30;
    reference base/interaction.cu:49-52: u = the Murmur64A hash of the bits
    of p and wo as 2^-32 of its low word; mix_material.cu:18-21: u < amount
    ? m1 : m2). A mix never resolves to a material-less interface or another
    mix (the builder refuses both), so a material >= 0 stays >= 0. Lanes
    with a material < 0 or not a mix keep theirs."""
    m = torch.clamp(mat_idx, min=0).long()
    words = [_float_bits(p[..., i]) for i in range(3)] + [_float_bits(wo[..., i])
                                                            for i in range(3)]
    u = (rng.murmur64a_u32_words(words) & rng.M32).to(torch.float32) * 2.0 ** -32
    chosen = torch.where(u < scene.mat_mix_amount[m], scene.mat_mix_m1[m],
                         scene.mat_mix_m2[m]).long()
    return torch.where((scene.mat_type[m] == bd.MAT_MIX) & (mat_idx >= 0), chosen,
                       mat_idx.long())


def make_bsdf(scene, mat_idx, ns, wl: sampled.Wavelengths, layered_scene=False, uv=None, p=None,
              duv=None, tex=None):
    """Material mat_idx (R,) -> (Bsdf around ns, new wavelengths): a
    dispersive dielectric terminates the secondary wavelengths (reference
    dielectric_material.cu:40-47). `layered_scene` (SceneMeta.layered) builds
    the layered parameters of coated materials. On a scene with textures the
    slots whose node is >= 0 override the constant reflectance,
    transmittance and roughness, before the roughness becomes alpha and the
    conductor's reflectance mode takes its k (JAX materials.py:79-92): from
    `tex` (a TexLanes whose mat is mat_idx: K13's or its plain version's),
    or evaluated here at uv (R, 2), p (R, 3) and footprints duv (R, 4) or
    None (textures.slot_values)."""
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
    if tex is None and uv is not None and scene.tex.type.shape[0] > 0:
        tex = texlib.TexLanes(mat_idx, *texlib.slot_values(scene, m, uv, ns, wl.lam, p, duv))
    if tex is not None:
        def slot(bit):
            return (tex.mask & bit) != 0
        refl = torch.where(slot(texlib.SLOT_REFL)[..., None], tex.refl, refl)
        trans = torch.where(slot(texlib.SLOT_TRANS)[..., None], tex.trans, trans)
        urough = torch.where(slot(texlib.SLOT_UROUGH), tex.urough, urough)
        vrough = torch.where(slot(texlib.SLOT_VROUGH), tex.vrough, vrough)

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
            mtype == bd.MAT_DIELECTRIC, bxdfs.K_DIELECTRIC, torch.where(
                mtype == bd.MAT_COATED_DIFFUSE, bxdfs.K_COATED_DIFFUSE, torch.where(
                    mtype == bd.MAT_COATED_CONDUCTOR, bxdfs.K_COATED_CONDUCTOR,
                    bxdfs.K_DIFF_TRANS)))))
    params = bxdfs.BxdfParams(kind=kind, refl=refl, trans=trans, eta_re=eta_re,
                              eta_im=eta_im, eta=eta_d, ax=ax, ay=ay)

    lay = None
    if layered_scene:
        # top: a smooth or rough dielectric with the coat's eta and the
        # material's u/v roughness; bottom: diffuse (reflectance) or a
        # conductor (spectrum rows eta/k, conductor roughness). The walk runs
        # 10 steps of 1 sample whatever the material's maxdepth/nsamples say,
        # as in the JAX package.
        top = bxdfs.BxdfParams(
            kind=torch.full_like(kind, bxdfs.K_DIELECTRIC, dtype=torch.int32),
            refl=refl, trans=trans, eta_re=eta_re, eta_im=eta_im,
            eta=scene.mat_ieta[m], ax=ax, ay=ay)

        def alpha(r):
            return torch.clamp(torch.where(remap, sc.roughness_to_alpha(r), r), min=1e-4)

        bottom = bxdfs.BxdfParams(
            kind=torch.where(mtype == bd.MAT_COATED_CONDUCTOR, bxdfs.K_CONDUCTOR,
                             bxdfs.K_DIFFUSE).to(torch.int32),
            refl=refl, trans=trans, eta_re=eta_rows, eta_im=k_rows, eta=eta_d,
            ax=alpha(scene.mat_crough_u[m]), ay=alpha(scene.mat_crough_v[m]))
        albedo = torch.clamp(spectra.sigmoid_polynomial(scene.mat_albedo_c[m], wl.lam),
                             0.0, 1.0)
        lay = layered.LayeredParams(top=top, bottom=bottom, thickness=scene.mat_thickness[m],
                                    g=scene.mat_lay_g[m], albedo=albedo, max_depth=10,
                                    n_samples=1)

    fx, fy, fz = vm.frame_from_z(ns)
    return (Bsdf(params=params, fx=fx, fy=fy, fz=fz, lay=lay),
            sampled.Wavelengths(wl.lam, new_pdf))


def is_coated(kind):
    return (kind == bxdfs.K_COATED_DIFFUSE) | (kind == bxdfs.K_COATED_CONDUCTOR)


def bsdf_f(b: Bsdf, wo_w, wi_w):
    wo = vm.to_local(b.fx, b.fy, b.fz, wo_w)
    wi = vm.to_local(b.fx, b.fy, b.fz, wi_w)
    out = bxdfs.f(b.params, wo, wi)
    if b.lay is not None:
        coat = is_coated(b.params.kind)
        out = torch.where(coat[..., None], layered.layered_f(b.lay, wo, wi, mask=coat), out)
    return out


def bsdf_pdf(b: Bsdf, wo_w, wi_w):
    wo = vm.to_local(b.fx, b.fy, b.fz, wo_w)
    wi = vm.to_local(b.fx, b.fy, b.fz, wi_w)
    out = bxdfs.pdf(b.params, wo, wi)
    if b.lay is not None:
        coat = is_coated(b.params.kind)
        out = torch.where(coat, layered.layered_pdf(b.lay, wo, wi, mask=coat), out)
    return out


def bsdf_sample(b: Bsdf, wo_w, uc, u2):
    wo = vm.to_local(b.fx, b.fy, b.fz, wo_w)
    s = bxdfs.sample(b.params, wo, uc, u2)
    if b.lay is not None:
        coat = is_coated(b.params.kind)
        s = layered.pick(coat, s, layered.layered_sample(b.lay, wo, uc, u2, mask=coat))
    return s._replace(wi=vm.from_local(b.fx, b.fy, b.fz, s.wi))


def mis_direction_pdf(b: Bsdf, wo_w, bs: bxdfs.BSDFSample):
    """Directional pdf to carry into the next bounce's MIS weight. The
    layered sample's pdf is only proportional (layered_bxdf.h:269
    pdf_is_proportional); as the reference integrators do
    (megakernel_path.cu:162), coated lanes take the stochastic BSDF::pdf
    estimate instead. Other lanes keep bs.pdf; a scene without coated
    materials computes nothing here. bs.wi is in world space."""
    if b.lay is None:
        return bs.pdf
    return torch.where(is_coated(b.params.kind), bsdf_pdf(b, wo_w, bs.wi), bs.pdf)
