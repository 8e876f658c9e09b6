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

A bounce (bounce_step) is three parts around the two visibility dispatches:
the loop head with russian roulette (rr), dispatch.intersect, shading with
the NEE light sample and the BSDF sample (shade), dispatch.occluded on the
shadow rays, and the direct light they let through (resolve). On the card
the parts are the three kernels of csrc/path_step.cu (K6, `rr_cuda`,
`shade_cuda`, `resolve_cuda`); on CPU tensors, and for what the kernels do
not cover (coated materials, whose lanes run K7's walk, and the MLT sampler
kind), their plain versions `rr_plain`, `shade_plain`, `resolve_plain`.
`step_route` decides, from the device, the scene and the sampler kind.
"""
import ctypes
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


def shade_plain(scene, meta, state: PathState, hit: dispatch.SceneHit, skind="independent",
                spp=0):
    """Everything of a bounce from the escaped-ray branch to the new ray,
    on the state rr_plain returned and its closest hits: escaped rays
    collect the uniform infinite lights and area-light hits their emission
    (MIS-weighted), the BSDF, the NEE draws and light sample with its MIS
    weight (reference sample_Ld, megakernel_path.cu:186-264), the BSDF
    sample and the new ray. -> (the next state, its L without this bounce's
    direct light; the shadow rays; the pending direct-light term)."""
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

    # --- NEE (skipped for specular-only lobes; coated kinds always run it);
    # its draws are masked like the reference's, which consumes them only
    # when sample_Ld runs. Lanes without NEE trace their shadow ray with
    # t_max = 0, which the traversal answers at once.
    kind = bsdf.params.kind
    spec_only = (((kind == bxdfs.K_CONDUCTOR) | (kind == bxdfs.K_DIELECTRIC))
                 & sc.effectively_smooth(bsdf.params.ax, bsdf.params.ay))
    nee = shade & ~spec_only & (scene.lt_pmf.shape[0] > 0)
    r, u_l = samplers.get_1d(r, nee, skind, spp)
    r, u_l2 = samplers.get_2d(r, nee, skind, spp)
    shadow = pending = None
    if scene.lt_pmf.shape[0] > 0:
        light_idx, pmf = _pick_light(scene, u_l)
        ls = lights.sample_li(scene, light_idx, hit.p, hit.ns, u_l2, wl.lam)
        f = materials.bsdf_f(bsdf, hit.wo, ls.wi) * vm.absdot(ls.wi, hit.ns)[..., None]
        pdf_bsdf = materials.bsdf_pdf(bsdf, hit.wo, ls.wi)
        f_pos = torch.any(f > 0.0, dim=-1)
        pdf_light = pmf * ls.pdf
        o_sh = offset_ray_origin(hit.p, hit.ng, ls.wi, scene.ray_offset_scale)
        t_sh = vm.distance(o_sh, ls.p_light) * (1.0 - 1e-3)
        shadow = ShadowRays(o_sh, ls.wi, torch.where(nee, t_sh, 0.0))
        contrib = f * ls.L / torch.clamp(pdf_light, min=1e-20)[..., None]
        w = torch.where(ls.is_delta, 1.0, power_heuristic(1.0, pdf_light, 1.0, pdf_bsdf))
        ok = ls.valid & f_pos & (pdf_light > 0.0)
        pending = NeePending(nee, beta, torch.where(ok[..., None], w[..., None] * contrib, 0.0))

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
        prev_pdf=torch.where(cont, pdf_mis, state.prev_pdf),
        prev_p=torch.where(shade[..., None], hit.p, state.prev_p),
        prev_ns=torch.where(shade[..., None], hit.ns, state.prev_ns),
    )
    return out, shadow, pending


def resolve_plain(state: PathState, pending: NeePending, occluded):
    """The direct light of the NEE lanes whose shadow ray is unblocked
    (`occluded`: dispatch.occluded's answer for the shadow rays), added to
    L, and their shadow rays counted. -> the state."""
    ld = torch.where(occluded[..., None], 0.0, pending.ld)
    L = torch.where(pending.mask[..., None], state.L + pending.beta * ld, state.L)
    return state._replace(L=L, n_shadow=state.n_shadow + pending.mask.sum())


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
# csrc/path_step.cu: the three parts of a bounce around the two dispatches,
# one kernel each, one thread a lane. Uncoated scenes with the independent
# or stratified sampler only: coated lanes (K7's walk) and the MLT kind keep
# the plain step.

# launches of the path-step kernels (plain ints, added to where each launches)
launches = {"path_rr": 0, "path_shade": 0, "path_resolve": 0}
STEP_SAMPLERS = ("independent", "stratified")
MAT_F, LT_F, SCAL_F = 14, 18, 3


def step_route(device, meta, skind=None):
    """"cuda" where a bounce runs csrc/path_step.cu (a CUDA device, no coated
    material, the independent or stratified sampler; skind defaults to
    meta.sampler), else "plain"."""
    kind = meta.sampler if skind is None else skind
    if torch.device(device).type != "cuda" or meta.layered or kind not in STEP_SAMPLERS:
        return "plain"
    return "cuda"


def step_tables(scene):
    """Per-scene rows of the path-step kernels, cached on the scene: the
    material table (M, MAT_F) [type, remap, urough, vrough, eta, eta spectrum
    row, k spectrum row, reflectance mode, reflectance coefficients 3,
    transmittance coefficients 3], the light table (L, LT_F) [type,
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
               scene.mat_refl_c, scene.mat_trans_c).contiguous()
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
    "smp_sample", "smp_dim", "active", "specular", "depth", "rr_next", "prev_pdf", "prev_p",
    "prev_ns", "count_in",
    # closest hits (path_shade); the pending term and shadow answers (path_resolve)
    "hit_valid", "hit_p", "hit_ng", "hit_ns", "hit_mat", "hit_light",
    "nee", "ld", "occluded",
    # outputs
    "o_out", "d_out", "L_out", "beta_out", "lam_pdf_out", "smp_state_out", "smp_dim_out",
    "active_out", "specular_out", "depth_out", "rr_next_out", "prev_pdf_out", "prev_p_out",
    "prev_ns_out", "t_max_out", "count_out", "sh_o", "sh_d", "sh_t", "nee_out", "ld_out",
    "scratch",
    # scene rows
    "mat", "spec", "lt", "emission", "uinf", "scal", "tri_p0", "tri_p1", "tri_p2",
    "sph_center", "sph_radius", "dsk_center", "dsk_normal", "dsk_radius", "dsk_inner",
)
_INT_FIELDS = ("n", "n_lights", "n_tris", "max_depth", "stratified", "spp", "sqrt_spp",
               "open_scene")


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
        for fn in (lib.pbrt_path_rr, lib.pbrt_path_shade, lib.pbrt_path_resolve):
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
    With `meta`, the scene and sampler are checked as covered."""

    def __init__(self, R, dev, meta=None, skind=None, spp=0):
        if dev.type != "cuda":
            raise ValueError(f"path step kernel: needs CUDA tensors, got them on {dev}")
        if not 0 < R < 1 << 31:
            raise ValueError(f"path step kernel: needs 0 < R < 2^31 lanes, got {R}")
        self.c, self.keep, self.R, self.dev = _StepArgs(), [], R, dev
        self.c.n = R
        if meta is None:
            return
        if meta.layered:
            raise ValueError("path step kernel: the scene has coated materials, whose lanes "
                             "run K7's walk: its bounces take the plain step")
        if skind not in STEP_SAMPLERS:
            raise ValueError(f"path step kernel: sampler kind {skind!r} takes the plain step")
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


def shade_cuda(scene, meta, state: PathState, hit: dispatch.SceneHit, skind="independent",
               spp=0):
    """shade_plain's contract in one launch of csrc/path_step.cu
    `path_shade`; a scene without lights gives (state, None, None) as the
    plain version does."""
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
    a.launch("path_shade")
    out = state._replace(smp=state.smp._replace(state=st, dim=dim), **out)
    if n_l == 0:
        return out, None, None
    return out, shadow, NeePending(nee, state.beta, ld)


def resolve_cuda(state: PathState, pending: NeePending, occluded):
    """resolve_plain's contract in one launch of csrc/path_step.cu
    `path_resolve`."""
    a = _Args(state.L.shape[0], state.L.device)
    a.put("L", state.L, 4)
    a.put("beta", pending.beta, 4)
    a.put("ld", pending.ld, 4)
    a.put("nee", pending.mask, dtype=torch.bool)
    a.put("occluded", occluded, dtype=torch.bool)
    n = a.counter(state.n_shadow)
    L = a.out("L_out", 4)
    a.launch("path_resolve")
    return state._replace(L=L, n_shadow=n)


def bounce_step(scene, meta, state: PathState, skind="independent", spp=0):
    """One bounce for all lanes -> the updated PathState: the loop head (RR),
    the closest hits, shading with the NEE light sample and the BSDF sample,
    the shadow rays, and the direct light they let through. On the "cuda"
    route (step_route) the three parts around the two dispatches are the
    kernels of csrc/path_step.cu, else their plain versions."""
    if step_route(state.o.device, meta, skind) == "cuda":
        rr, shade, resolve = rr_cuda, shade_cuda, resolve_cuda
    else:
        rr, shade, resolve = rr_plain, shade_plain, resolve_plain
    state, t_max = rr(meta, state, skind, spp)
    hit = dispatch.intersect(scene, meta, state.o, state.d, t_max)
    state, shadow, pending = shade(scene, meta, state, hit, skind, spp)
    if pending is None:
        return state
    return resolve(state, pending, dispatch.occluded(scene, meta, shadow.o, shadow.d,
                                                     shadow.t_max))
