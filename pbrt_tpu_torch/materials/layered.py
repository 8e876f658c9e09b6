"""Layered BxDF: stochastic transport between a top (dielectric) and a
bottom (diffuse or conductor) interface with an optional Henyey-Greenstein
medium between them (counterpart of pbrt_tpu/materials/layered.py;
reference bxdfs/layered_bxdf.h, pbrt-v4's LayeredBxDF with twoSided=true).

CoatedDiffuseBxDF   = Layered<DielectricBxDF, DiffuseBxDF>
CoatedConductorBxDF = Layered<DielectricBxDF, ConductorBxDF>

Each entry point (`layered_f`, `layered_sample`, `layered_pdf`) launches the
hand-written kernel K7 (csrc/layered.cu) on CUDA tensors and runs its plain
version here only on CPU tensors. The plain versions are the JAX package's
masked-lane walks: every lane runs all max_depth steps and `where` keeps the
live ones. The walk's random numbers come from PCG32 seeded by MurmurHash64A
of the float bits of wo and wi (or uc, u2), so the walk draws no sampler
dimensions. Semantics kept from the JAX package on purpose: the `_r1`
clamp to 1 - 1e-7, `_tr`'s clamps, RR past depth 3, `exit_pdf_trans`
taking the top's pdf with allow_refl=False, and `layered_pdf`'s simplified
TRT estimate blended with 0.1 of the uniform sphere pdf.
"""
import ctypes
from typing import NamedTuple

import torch

from pbrt_tpu_torch.utils.math import PI, power_heuristic
from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.materials import bxdfs, scattering as sc
from pbrt_tpu_torch.sampling import rng as prng
from pbrt_tpu_torch.sampling import warps


class LayeredParams(NamedTuple):
    top: bxdfs.BxdfParams      # dielectric interface
    bottom: bxdfs.BxdfParams   # diffuse or conductor
    thickness: torch.Tensor    # (R,)
    g: torch.Tensor            # (R,)
    albedo: torch.Tensor       # (R,4) medium albedo
    max_depth: int
    n_samples: int


# launches of the K7 kernels (plain ints, added to where they launch)
launches = {"layered_f": 0, "layered_sample": 0, "layered_pdf": 0}


def _u32_bits(x):
    """float32 (R,) -> its bits as a u32 in int64."""
    return x.contiguous().view(torch.int32).long() & prng.M32


def _hash_vec3(v):
    """pbrt::hash(Vector3f) of the float bits -> u64 in int64 (util/hash.h)."""
    return prng.murmur64a_u32_words([_u32_bits(v[..., i]) for i in range(3)])


def _hash_uc_u2(uc, u2):
    return prng.murmur64a_u32_words([_u32_bits(uc), _u32_bits(u2[..., 0]),
                                     _u32_bits(u2[..., 1])])


class _Rng:
    """The walk's PCG32 stream, advanced in place."""

    def __init__(self, seed_a, seed_b):
        self.r = prng.set_sequence(seed_a, seed_b)

    def r1(self):
        state, u = prng.uniform_float(self.r.state, self.r.inc)
        self.r = prng.Pcg32(state, self.r.inc)
        return torch.clamp(u, max=1.0 - 1e-7)

    def r2(self):
        ua = self.r1()
        ub = self.r1()
        return torch.stack([ua, ub], dim=-1)


def _tr(dz, w):
    """Transmittance exp(-|dz / w.z|) (layered_bxdf.h:487-492, sigma_t = 1)."""
    tau = torch.abs(dz) / torch.clamp(torch.abs(w[..., 2]), min=1e-9)
    return torch.exp(-torch.clamp(tau, max=80.0))


def _ok(s):
    return s.valid & torch.any(s.f > 0, dim=-1) & (s.pdf > 0) & (s.wi[..., 2] != 0)


def pick(use_b, a, b):
    """Per-lane choice between two BSDFSamples (b where use_b)."""
    return bxdfs.BSDFSample(*(torch.where(use_b[..., None] if x.dim() > use_b.dim() else use_b,
                                          y, x) for x, y in zip(a, b)))


def _where4(c, a, b):
    return torch.where(c[..., None], a, b)


def layered_f_plain(p: LayeredParams, wo, wi):
    """Stochastic f estimate (layered_bxdf.h:53-245) -> (R,4)."""
    flip = wo[..., 2] < 0.0
    wo = torch.where(flip[..., None], -wo, wo)
    wi = torch.where(flip[..., None], -wi, wi)
    same = wo[..., 2] * wi[..., 2] > 0.0
    exit_is_bottom = ~same
    exit_z = torch.where(exit_is_bottom, 0.0, p.thickness)

    top_specular = sc.effectively_smooth(p.top.ax, p.top.ay)
    bottom_specular = (p.bottom.kind == bxdfs.K_CONDUCTOR) & sc.effectively_smooth(
        p.bottom.ax, p.bottom.ay)
    f_acc = torch.zeros_like(p.albedo)
    f_enter = bxdfs.f(p.top, wo, wi)
    f_acc = f_acc + _where4(same, p.n_samples * f_enter, torch.zeros_like(f_enter))
    exit_specular = torch.where(exit_is_bottom, bottom_specular, top_specular)
    nonexit_specular = torch.where(exit_is_bottom, top_specular, bottom_specular)
    nonexit_is_bottom = ~exit_is_bottom

    r = _Rng(_hash_vec3(wo), _hash_vec3(wi))

    def exit_f(w_neg):
        return _where4(exit_is_bottom, bxdfs.f(p.bottom, w_neg, wi), bxdfs.f(p.top, w_neg, wi))

    def exit_pdf_trans(w_neg):
        pb = bxdfs.pdf(p.bottom, w_neg, wi, allow_refl=True, allow_trans=True)
        pt = bxdfs.pdf(p.top, w_neg, wi, allow_refl=False, allow_trans=True)
        return torch.where(exit_is_bottom, pb, pt)

    def iface_sample(use_bottom, w_in, uc, u2):
        """Reflection-only sample of the top or bottom interface."""
        return pick(use_bottom,
                     bxdfs.sample(p.top, w_in, uc, u2, allow_refl=True, allow_trans=False),
                     bxdfs.sample(p.bottom, w_in, uc, u2, allow_refl=True, allow_trans=False))

    for _ in range(p.n_samples):
        # entrance transmission sample (top interface, transmission only)
        uc = r.r1()
        u2 = r.r2()
        wos = bxdfs.sample(p.top, wo, uc, u2, allow_refl=False, allow_trans=True)
        # virtual light sample from wi through the exit interface; importance
        # transport (!mode): no 1/eta^2
        uc = r.r1()
        u2 = r.r2()
        wis = pick(exit_is_bottom,
                    bxdfs.sample(p.top, wi, uc, u2, allow_refl=False, allow_trans=True,
                                 mode_radiance=False),
                    bxdfs.sample(p.bottom, wi, uc, u2, allow_refl=False, allow_trans=True,
                                 mode_radiance=False))
        alive = _ok(wos) & _ok(wis)
        beta = wos.f * vm.abs_cos_theta(wos.wi)[..., None] / torch.clamp(
            wos.pdf, min=1e-12)[..., None]
        z = p.thickness.clone()
        w = wos.wi
        has_albedo = torch.any(p.albedo > 0, dim=-1)

        for depth in range(p.max_depth):
            # RR past depth 3 when beta is small
            bmax = torch.amax(beta, dim=-1)
            u_rr = r.r1()
            q = torch.clamp(1.0 - bmax, min=0.0)
            if depth > 3:
                kill = alive & (bmax < 0.25) & (u_rr < q)
                beta = _where4(alive & (bmax < 0.25) & ~kill,
                               beta / torch.clamp(1.0 - q, min=1e-9)[..., None], beta)
                alive = alive & ~kill

            # medium segment
            u_d = r.r1()
            dz = -torch.log1p(-u_d) * torch.abs(w[..., 2])
            zp_scatter = torch.where(w[..., 2] > 0, z + dz, z - dz)
            scatter = alive & has_albedo & (zp_scatter > 0) & (zp_scatter < p.thickness)
            z_noal = torch.where(z == p.thickness, 0.0, p.thickness)
            beta = _where4(alive & ~has_albedo, beta * _tr(p.thickness, w)[..., None], beta)
            z_next_boundary = torch.where(
                has_albedo, torch.clamp(zp_scatter, torch.zeros_like(p.thickness),
                                        p.thickness), z_noal)

            # scattering event inside the medium: NEE through the exit
            # interface along wis, then a phase resample
            ph_exit = warps.henyey_greenstein(vm.dot(-w, -wis.wi), p.g)
            wt = torch.where(exit_specular, 1.0, power_heuristic(1.0, wis.pdf, 1.0, ph_exit))
            nee_med = (beta * p.albedo * ph_exit[..., None] * wt[..., None]
                       * _tr(zp_scatter - exit_z, wis.wi)[..., None] * wis.f
                       / torch.clamp(wis.pdf, min=1e-12)[..., None])
            f_acc = f_acc + _where4(scatter, nee_med, torch.zeros_like(nee_med))
            u_ph = r.r2()
            wi_ph, pdf_ph = warps.sample_henyey_greenstein(-w, p.g, u_ph)
            ok_ph = (pdf_ph > 0) & (wi_ph[..., 2] != 0)
            beta_sc = beta * p.albedo
            toward_exit = (((zp_scatter < exit_z) & (wi_ph[..., 2] > 0))
                           | ((zp_scatter > exit_z) & (wi_ph[..., 2] < 0)))
            f_exit = exit_f(-wi_ph)
            wt2 = power_heuristic(1.0, pdf_ph, 1.0, exit_pdf_trans(-wi_ph))
            nee2 = beta_sc * _tr(zp_scatter - exit_z, wi_ph)[..., None] * f_exit * wt2[..., None]
            f_acc = f_acc + _where4(scatter & ok_ph & toward_exit, nee2, torch.zeros_like(nee2))

            # interface event (lanes that reached a boundary)
            at_boundary = alive & ~scatter
            z_b = z_next_boundary
            at_exit = at_boundary & (z_b == exit_z)
            at_nonexit = at_boundary & (z_b != exit_z)

            # exit interface: reflection resample, the walk goes on
            uc_e = r.r1()
            u2_e = r.r2()
            bs_exit = iface_sample(exit_is_bottom, -w, uc_e, u2_e)
            ok_exit = _ok(bs_exit)
            beta_exit = beta * bs_exit.f * vm.abs_cos_theta(bs_exit.wi)[..., None] / torch.clamp(
                bs_exit.pdf, min=1e-12)[..., None]

            # non-exit interface: NEE along wis, then a reflection resample
            f_ne = _where4(nonexit_is_bottom, bxdfs.f(p.bottom, -w, -wis.wi),
                           bxdfs.f(p.top, -w, -wis.wi))
            pdf_ne = torch.where(nonexit_is_bottom, bxdfs.pdf(p.bottom, -w, -wis.wi),
                                 bxdfs.pdf(p.top, -w, -wis.wi))
            wt_ne = torch.where(exit_specular, 1.0, power_heuristic(1.0, wis.pdf, 1.0, pdf_ne))
            nee_ne = (beta * f_ne * vm.abs_cos_theta(wis.wi)[..., None] * wt_ne[..., None]
                      * _tr(p.thickness, wis.wi)[..., None] * wis.f
                      / torch.clamp(wis.pdf, min=1e-12)[..., None])
            f_acc = f_acc + _where4(at_nonexit, nee_ne, torch.zeros_like(nee_ne))

            uc_n = r.r1()
            u2_n = r.r2()
            bs_ne = iface_sample(nonexit_is_bottom, -w, uc_n, u2_n)
            ok_ne = _ok(bs_ne)
            beta_ne = beta * bs_ne.f * vm.abs_cos_theta(bs_ne.wi)[..., None] / torch.clamp(
                bs_ne.pdf, min=1e-12)[..., None]
            f_exit2 = exit_f(-bs_ne.wi)
            pdf_exit2 = exit_pdf_trans(-bs_ne.wi)
            wt3 = torch.where(nonexit_specular, 1.0,
                              power_heuristic(1.0, bs_ne.pdf, 1.0, pdf_exit2))
            nee3 = beta_ne * _tr(p.thickness, bs_ne.wi)[..., None] * f_exit2 * wt3[..., None]
            f_acc = f_acc + _where4(at_nonexit & ok_ne, nee3, torch.zeros_like(nee3))

            new_alive = (scatter & ok_ph) | (at_exit & ok_exit) | (at_nonexit & ok_ne)
            new_beta = _where4(scatter, beta_sc, _where4(at_exit, beta_exit, beta_ne))
            new_w = _where4(scatter, wi_ph, _where4(at_exit, bs_exit.wi, bs_ne.wi))
            new_z = torch.where(scatter, zp_scatter, z_b)
            beta = _where4(new_alive, new_beta, beta)
            w = _where4(new_alive, new_w, w)
            z = torch.where(new_alive, new_z, z)
            alive = new_alive

    return f_acc / p.n_samples


def layered_sample_plain(p: LayeredParams, wo, uc, u2):
    """Stochastic sample (layered_bxdf.h:247-372) -> BSDFSample."""
    flip = wo[..., 2] < 0.0
    wo_f = torch.where(flip[..., None], -wo, wo)

    bs0 = bxdfs.sample(p.top, wo_f, uc, u2)
    ok0 = _ok(bs0)
    is_refl0 = ~bxdfs.is_transmission(bs0.flags)
    refl_done = ok0 & is_refl0        # immediate reflection exits at once
    out_wi = torch.where(flip[..., None], -bs0.wi, bs0.wi)

    # transmitted into the layer: random walk
    r = _Rng(_hash_vec3(wo_f), _hash_uc_u2(uc, u2))
    walking = ok0 & ~is_refl0
    f_cur = bs0.f * vm.abs_cos_theta(bs0.wi)[..., None]
    pdf_cur = bs0.pdf
    spec_path = bxdfs.is_specular(bs0.flags)
    w = bs0.wi
    z = p.thickness.clone()
    has_albedo = torch.any(p.albedo > 0, dim=-1)

    done = torch.zeros_like(walking)
    exit_f_val = torch.zeros_like(f_cur)
    exit_wi = w
    exit_pdf = torch.ones_like(pdf_cur)
    exit_spec = spec_path

    for depth in range(p.max_depth):
        rr_beta = torch.amax(f_cur, dim=-1) / torch.clamp(pdf_cur, min=1e-12)
        u_rr = r.r1()
        if depth > 3:
            q = torch.clamp(1.0 - rr_beta, min=0.0)
            trigger = walking & (rr_beta < 0.25)
            kill = trigger & (u_rr < q)
            pdf_cur = torch.where(trigger & ~kill, pdf_cur * (1.0 - q), pdf_cur)
            walking = walking & ~kill
        walking = walking & (w[..., 2] != 0)

        # medium
        u_d = r.r1()
        dz = -torch.log1p(-u_d) * torch.abs(w[..., 2])
        zp = torch.where(w[..., 2] > 0, z + dz, z - dz)
        scatter = walking & has_albedo & (zp > 0) & (zp < p.thickness)
        u_ph = r.r2()
        wi_ph, pdf_ph = warps.sample_henyey_greenstein(-w, p.g, u_ph)
        ok_ph = (pdf_ph > 0) & (wi_ph[..., 2] != 0)
        f_sc = f_cur * p.albedo * pdf_ph[..., None]
        pdf_sc = pdf_cur * pdf_ph
        # boundary advance
        z_noal = torch.where(z == p.thickness, 0.0, p.thickness)
        f_bnd = _where4(walking & ~has_albedo, f_cur * _tr(p.thickness, w)[..., None], f_cur)
        z_bnd = torch.where(has_albedo, torch.clamp(zp, torch.zeros_like(p.thickness),
                                                    p.thickness), z_noal)

        # interface sample at the boundary
        at_boundary = walking & ~scatter
        use_bottom = z_bnd == 0.0
        uc_i = r.r1()
        u2_i = r.r2()
        bs = pick(use_bottom, bxdfs.sample(p.top, -w, uc_i, u2_i),
                   bxdfs.sample(p.bottom, -w, uc_i, u2_i))
        ok_if = _ok(bs)
        f_if = f_bnd * bs.f
        pdf_if = pdf_cur * bs.pdf
        spec_if = spec_path & bxdfs.is_specular(bs.flags)
        transmitted = bxdfs.is_transmission(bs.flags)

        exiting = at_boundary & ok_if & transmitted
        newly_done = exiting & ~done
        exit_f_val = _where4(newly_done, f_if, exit_f_val)
        exit_wi = _where4(newly_done, bs.wi, exit_wi)
        exit_pdf = torch.where(newly_done, pdf_if, exit_pdf)
        exit_spec = torch.where(newly_done, spec_if, exit_spec)
        done = done | exiting

        # continue: scattered lanes and lanes reflected at an interface
        cont_scatter = scatter & ok_ph
        cont_reflect = at_boundary & ok_if & ~transmitted
        f_cur = _where4(cont_scatter, f_sc,
                        _where4(cont_reflect, f_if * vm.abs_cos_theta(bs.wi)[..., None], f_cur))
        pdf_cur = torch.where(cont_scatter, pdf_sc, torch.where(cont_reflect, pdf_if, pdf_cur))
        spec_path = torch.where(cont_scatter, False, torch.where(cont_reflect, spec_if,
                                                                  spec_path))
        w = _where4(cont_scatter, wi_ph, _where4(cont_reflect, bs.wi, w))
        z = torch.where(cont_scatter, zp, z_bnd)
        walking = cont_scatter | cont_reflect

    exit_wi_o = torch.where(flip[..., None], -exit_wi, exit_wi)
    walk_flags = (torch.where(wo_f[..., 2] * exit_wi[..., 2] > 0, bxdfs.F_REFLECTION,
                              bxdfs.F_TRANSMISSION)
                  | torch.where(exit_spec, bxdfs.F_SPECULAR, bxdfs.F_GLOSSY))
    pdf_out = torch.where(refl_done, bs0.pdf, exit_pdf)
    return bxdfs.BSDFSample(
        f=_where4(refl_done, bs0.f, exit_f_val),
        wi=_where4(refl_done, out_wi, exit_wi_o),
        pdf=pdf_out,
        flags=torch.where(refl_done, bs0.flags, walk_flags).to(torch.int32),
        eta=torch.ones_like(pdf_out),
        valid=refl_done | done,
    )


def layered_pdf_plain(p: LayeredParams, wo, wi):
    """Stochastic pdf estimate (layered_bxdf.h:375-470), simplified to the
    dominant TRT estimator: the entrance reflection pdf plus one MIS'd
    transmission-reflection-transmission sample per n_samples, blended with
    the uniform sphere pdf. The pdf only steers MIS weights, so the coarser
    estimate changes variance, not bias."""
    flip = wo[..., 2] < 0.0
    wo = torch.where(flip[..., None], -wo, wo)
    wi = torch.where(flip[..., None], -wi, wi)
    same = wo[..., 2] * wi[..., 2] > 0.0

    pdf_sum = torch.where(
        same, p.n_samples * bxdfs.pdf(p.top, wo, wi, allow_refl=True, allow_trans=False), 0.0)
    r = _Rng(_hash_vec3(wi), _hash_vec3(wo))
    for _ in range(p.n_samples):
        uc1 = r.r1()
        u21 = r.r2()
        wos = bxdfs.sample(p.top, wo, uc1, u21, allow_refl=False, allow_trans=True)
        uc2 = r.r1()
        u22 = r.r2()
        wis = bxdfs.sample(p.top, wi, uc2, u22, allow_refl=False, allow_trans=True)
        ok = (wos.valid & (wos.pdf > 0) & torch.any(wos.f > 0, dim=-1)
              & wis.valid & (wis.pdf > 0) & torch.any(wis.f > 0, dim=-1))
        r_pdf = bxdfs.pdf(p.bottom, -wos.wi, -wis.wi)
        pdf_sum = pdf_sum + torch.where(same & ok, r_pdf, 0.0)
    return 0.9 * pdf_sum / p.n_samples + 0.1 / (4.0 * PI)


# ------------------------------------------------------------------ K7


class _BxdfPtrs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("kind", "refl", "trans", "eta_re", "eta_im", "eta", "ax", "ay")]


class _LayeredArgs(ctypes.Structure):
    """csrc/layered.cu `LayeredArgs`: device pointers of the lanes' layer."""
    _fields_ = [("top", _BxdfPtrs), ("bottom", _BxdfPtrs), ("thickness", ctypes.c_void_p),
                ("g", ctypes.c_void_p), ("albedo", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("steps", ctypes.c_void_p),
                ("n", ctypes.c_int), ("max_depth", ctypes.c_int)]


def _kernel_lib():
    """The built K7 library, its C functions declared once."""
    from pbrt_tpu_torch import kernels

    lib = kernels.load("layered")
    if not hasattr(lib, "declared"):
        args = ctypes.POINTER(_LayeredArgs)
        lib.pbrt_layered_f.argtypes = [args] + [ctypes.c_void_p] * 4
        lib.pbrt_layered_pdf.argtypes = [args] + [ctypes.c_void_p] * 4
        lib.pbrt_layered_sample.argtypes = [args] + [ctypes.c_void_p] * 10
        for fn in (lib.pbrt_layered_f, lib.pbrt_layered_pdf, lib.pbrt_layered_sample):
            fn.restype = ctypes.c_int
        lib.declared = True
    return lib


def _checked(name, x, shape, dtype, dev):
    """x as a contiguous `dtype` tensor of `shape` on `dev`, or raise."""
    if (not torch.is_tensor(x) or x.device != dev or tuple(x.shape) != shape
            or x.dtype != dtype):
        raise ValueError(f"layered kernel: {name} must be a {dtype} {shape} tensor on {dev}, "
                         f"got {getattr(x, 'dtype', type(x))} "
                         f"{tuple(getattr(x, 'shape', ()))} on {getattr(x, 'device', None)}")
    x = x.contiguous()
    if len(shape) == 2 and shape[1] == 4 and x.data_ptr() % 16:
        raise ValueError(f"layered kernel: {name} rows are read as float4: its data must be "
                         f"16-byte aligned")
    return x


def _args(p: LayeredParams, R, dev, mask, steps):
    """(ctypes LayeredArgs, the tensors it points into, kept alive)."""
    if p.n_samples != 1:
        raise ValueError(f"layered kernel: n_samples must be 1 (its early exit is exact "
                         f"only then), got {p.n_samples}")
    if not 1 <= p.max_depth <= 1 << 16:
        raise ValueError(f"layered kernel: max_depth {p.max_depth} outside 1..65536")
    keep = []

    def ptr(name, x, shape, dtype=torch.float32):
        t = _checked(name, x, shape, dtype, dev)
        keep.append(t)
        return t.data_ptr()

    def bxdf(tag, b):
        return _BxdfPtrs(
            kind=ptr(f"{tag}.kind", b.kind, (R,), torch.int32),
            refl=ptr(f"{tag}.refl", b.refl, (R, 4)), trans=ptr(f"{tag}.trans", b.trans, (R, 4)),
            eta_re=ptr(f"{tag}.eta_re", b.eta_re, (R, 4)),
            eta_im=ptr(f"{tag}.eta_im", b.eta_im, (R, 4)),
            eta=ptr(f"{tag}.eta", b.eta, (R,)), ax=ptr(f"{tag}.ax", b.ax, (R,)),
            ay=ptr(f"{tag}.ay", b.ay, (R,)))

    if steps is not None and (steps.device != dev or steps.dtype != torch.int64
                              or steps.numel() != 1):
        raise ValueError("layered kernel: steps must be an int64 (1,) tensor on the device")
    a = _LayeredArgs(
        top=bxdf("top", p.top), bottom=bxdf("bottom", p.bottom),
        thickness=ptr("thickness", p.thickness, (R,)), g=ptr("g", p.g, (R,)),
        albedo=ptr("albedo", p.albedo, (R, 4)),
        mask=None if mask is None else ptr("mask", mask, (R,), torch.bool),
        steps=None if steps is None else steps.data_ptr(), n=R, max_depth=p.max_depth)
    return a, keep


def _launch(fn, name, p, lead, mask, steps, outs):
    from pbrt_tpu_torch import kernels

    R, dev = lead.shape[0], lead.device
    if R >= 1 << 31:
        raise ValueError(f"layered kernel: {R} lanes (at most 2^31 - 1)")
    a, keep = _args(p, R, dev, mask, steps)
    if R:
        err = fn(ctypes.byref(a), *outs, torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(err, name)
        launches[name] += 1


def layered_f_cuda(p: LayeredParams, wo, wi, mask=None, steps=None):
    """K7 `layered_f` on the current stream. Same contract as the plain
    version on the lanes of `mask` (optional (R,) bool); the others get 0.
    `steps`, an optional int64 (1,) device tensor, accumulates the walk
    steps the lanes took."""
    R, dev = wo.shape[0], wo.device
    wo = _checked("wo", wo, (R, 3), torch.float32, dev)
    wi = _checked("wi", wi, (R, 3), torch.float32, dev)
    f = torch.empty((R, 4), dtype=torch.float32, device=dev)
    _launch(_kernel_lib().pbrt_layered_f, "layered_f", p, wo, mask, steps,
            (wo.data_ptr(), wi.data_ptr(), f.data_ptr()))
    return f


def layered_pdf_cuda(p: LayeredParams, wo, wi, mask=None, steps=None):
    """K7 `layered_pdf`; masked-out lanes get 0. `steps` counts the lanes
    whose estimate reached the base (the only lanes that read it)."""
    R, dev = wo.shape[0], wo.device
    wo = _checked("wo", wo, (R, 3), torch.float32, dev)
    wi = _checked("wi", wi, (R, 3), torch.float32, dev)
    pdf = torch.empty((R,), dtype=torch.float32, device=dev)
    _launch(_kernel_lib().pbrt_layered_pdf, "layered_pdf", p, wo, mask, steps,
            (wo.data_ptr(), wi.data_ptr(), pdf.data_ptr()))
    return pdf


def layered_sample_cuda(p: LayeredParams, wo, uc, u2, mask=None, steps=None):
    """K7 `layered_sample`; masked-out lanes get f = wi = 0, pdf = 0, eta = 1,
    flags 0 and valid False."""
    R, dev = wo.shape[0], wo.device
    wo = _checked("wo", wo, (R, 3), torch.float32, dev)
    uc = _checked("uc", uc, (R,), torch.float32, dev)
    u2 = _checked("u2", u2, (R, 2), torch.float32, dev)
    f = torch.empty((R, 4), dtype=torch.float32, device=dev)
    wi = torch.empty((R, 3), dtype=torch.float32, device=dev)
    pdf = torch.empty((R,), dtype=torch.float32, device=dev)
    eta = torch.empty((R,), dtype=torch.float32, device=dev)
    flags = torch.empty((R,), dtype=torch.int32, device=dev)
    valid = torch.empty((R,), dtype=torch.bool, device=dev)
    _launch(_kernel_lib().pbrt_layered_sample, "layered_sample", p, wo, mask, steps,
            (wo.data_ptr(), uc.data_ptr(), u2.data_ptr(), f.data_ptr(), wi.data_ptr(),
             pdf.data_ptr(), eta.data_ptr(), flags.data_ptr(), valid.data_ptr()))
    return bxdfs.BSDFSample(f=f, wi=wi, pdf=pdf, flags=flags, eta=eta, valid=valid)


def layered_f(p: LayeredParams, wo, wi, mask=None):
    """Stochastic f (R,4): K7 on CUDA tensors (lanes outside `mask` get 0),
    the plain version on CPU tensors (every lane)."""
    return layered_f_cuda(p, wo, wi, mask) if wo.is_cuda else layered_f_plain(p, wo, wi)


def layered_sample(p: LayeredParams, wo, uc, u2, mask=None):
    """Stochastic sample -> BSDFSample: K7 on CUDA tensors, the plain
    version on CPU tensors."""
    if wo.is_cuda:
        return layered_sample_cuda(p, wo, uc, u2, mask)
    return layered_sample_plain(p, wo, uc, u2)


def layered_pdf(p: LayeredParams, wo, wi, mask=None):
    """Stochastic pdf (R,): K7 on CUDA tensors, the plain version on CPU
    tensors."""
    return layered_pdf_cuda(p, wo, wi, mask) if wo.is_cuda else layered_pdf_plain(p, wo, wi)
