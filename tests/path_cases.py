"""Shared cases of the path step K6 (csrc/path_step.cu, four kernels) and
its plain version (pbrt_tpu_torch/integrators/path.py `rr_plain`,
`shade_plain`, `coat_plain`, `resolve_plain`), read by
tests/test_torch_path_step.py, tests/test_torch_gpu.py and chip_smoke.py.
Imports neither jax nor pbrt_tpu.

The scene is bdpt_cases' four-light scene (distant, spot, uniform infinite
and triangle, sphere and disk area lights; diffuse, rough conductor, smooth
dielectric and diffuse-transmission surfaces) under the path integrator,
with four more materials: a dispersive dielectric (BK7), a smooth spectral
conductor (gold), a reflectance-mode conductor and a rough dielectric; with
`coated`, two coated spheres more (COATED_SHAPES: a rough coat over a
diffuse base with a scattering medium, and a coated conductor), whose lanes
run K7's layered walk. Their walks seed on the float bits of the local
directions, which the kernels (x + y) + z and torch (and XLA) sum apart, so
coated lanes are held on their lane means (COAT_MEAN_SIGMAS), the rest of
the bounce as below.

Criterion (the kernels against the plain parts, and the plain parts
against JAX's bounce_step): the draws (sampler state and dimension) and
the masks (active, specular, NEE, the ray counts' lanes) bit-exact on
EQUAL_FRAC of the lanes; each float field of the path state (L, beta, o,
d, the wavelengths' pdf, prev_*) within ATOL + RTOL |plain| on every
component on CLOSE_FRAC of the lanes; each float field's mean over the
lanes within MEAN_RTOL relative (K7's criterion, tests/layered_cases.py).
The kernels round apart from torch in asinf, atan2f, sinf, cosf and the
complex square root, and torch sums a 3-term dot product in its own
order, where the kernels take (x + y) + z. The NEE light sample (the
shadow ray and the pending term) is held on LIGHT_FRAC of its lanes: the
spherical-triangle sample of a triangle light and its bilinear warp are
ill-conditioned in float32, and an ulp in a corner's direction moves the
sampled point by more than RTOL on ~2 % of a cornell-mesh bounce's NEE
lanes (on the H100; the lane means agree within 1e-6)."""
import torch

from bdpt_cases import FOUR_LIGHTS_PBRT

RTOL, ATOL = 1e-4, 1e-6
EQUAL_FRAC = 0.999
CLOSE_FRAC = 0.995
MEAN_RTOL = 1e-3
LIGHT_FRAC = 0.97
# coated lanes: two runs whose walks are independent estimates agree in a
# field's lane mean within this many standard errors of the difference of
# two independent means, sqrt((var_a + var_b) / n): the bound is exceeded
# by chance with a probability of ~6e-5 a field (a normal tail), and two
# runs whose walks are the same on most lanes sit well inside it
COAT_MEAN_SIGMAS = 4.0

EXTRA_SHAPES = """
AttributeBegin
  Material "dielectric" "spectrum eta" "glass-BK7"
  Translate -2.2 0.45 -1.2
  Shape "sphere" "float radius" [0.45]
AttributeEnd
AttributeBegin
  Material "conductor" "spectrum eta" "metal-Au-eta" "spectrum k" "metal-Au-k"
  Translate 2.2 0.45 -1.2
  Shape "sphere" "float radius" [0.45]
AttributeEnd
AttributeBegin
  Material "conductor" "rgb reflectance" [0.9 0.6 0.3] "float roughness" [0.1]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-3 0 3  3 0 3  3 3 3  -3 3 3]
AttributeEnd
AttributeBegin
  Material "dielectric" "float eta" [1.33] "float roughness" [0.2]
  Translate 0 0.3 -1.9
  Shape "sphere" "float radius" [0.3]
AttributeEnd
"""
COATED_SHAPES = """
AttributeBegin
  Material "coateddiffuse" "rgb reflectance" [0.6 0.35 0.2] "float roughness" [0.05]
    "float thickness" [0.05] "rgb albedo" [0.5 0.6 0.7] "float g" [0.3]
  Translate -1.2 0.4 -1.0
  Shape "sphere" "float radius" [0.4]
AttributeEnd
AttributeBegin
  Material "coatedconductor" "float conductor.roughness" [0.12]
    "float interface.roughness" [0.02]
    "spectrum conductor.eta" "metal-Au-eta" "spectrum conductor.k" "metal-Au-k"
  Translate 1.35 0.4 -1.5
  Shape "sphere" "float radius" [0.4]
AttributeEnd
"""
PATH_PBRT = (FOUR_LIGHTS_PBRT.replace('Integrator "bdpt"', 'Integrator "path"')
             + EXTRA_SHAPES)
COATED_PBRT = PATH_PBRT + COATED_SHAPES


def scene_text(sampler="independent", spp=4, coated=False):
    """PATH_PBRT (with `coated`, COATED_PBRT) with `sampler` at spp."""
    return (COATED_PBRT if coated else PATH_PBRT).replace(
        'Sampler "independent"', f'Sampler "{sampler}" "integer pixelsamples" [{spp}]')


def builder(res, sampler="independent", spp=4, coated=False):
    """SceneBuilder of PATH_PBRT (with `coated`, COATED_PBRT) at res x res
    with `sampler` at spp."""
    from pbrt_tpu_torch.scene import builder as bd, lexer as lx

    text = scene_text(sampler, spp, coated)
    b = bd.SceneBuilder()
    b.parse_tokens(lx.tokenize(text))
    b.film["xresolution"] = b.film["yresolution"] = res
    return b


def camera_state(scene, meta, n_pix=None):
    """The path state of the frame's camera lanes: every pixel x every
    sample (or the first n_pix pixels), drawn as render_wave draws them."""
    from pbrt_tpu_torch.integrators import path, render as rd

    dev = scene.device
    n = meta.resolution[0] * meta.resolution[1] if n_pix is None else n_pix
    ids = torch.arange(n, device=dev).repeat(meta.spp)
    sids = torch.arange(meta.spp, device=dev).repeat_interleave(n)
    rays, wl, r, _ = rd.camera_lanes(scene, meta, ids, sids, rd._use_lens(scene))
    return path.initial_state(rays, wl, r)


def synthetic_state(scene, meta, n, seed, mlt_d=None):
    """n lanes of a bounce in the middle of a path: rays from random points
    of the scene's bounds in random directions (so hits on every shape,
    light and material, and escapes), depths 0 .. max_depth (some past it,
    so dead), about a tenth inactive, RR due on about half (rr_next at or
    below depth), throughputs from 0.01 (RR kills) to 2, a tenth of the
    previous shading normals zero, a tenth of the wavelengths terminated,
    sampler lanes at random dimensions, ray counts 7 and 11. With mlt_d, the
    sampler is the MLT kind's (`from_primary_samples`) over random vectors
    (n, mlt_d), each lane at a dimension 0 .. mlt_d + 8, so that some lanes
    are served from their vector all bounce, some overflow to the stream
    within it, some draw from the stream only."""
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.sampling import samplers
    from pbrt_tpu_torch.spectral import sampled

    g = torch.Generator().manual_seed(seed)
    dev = scene.device
    pts = torch.cat([scene.tri_p0, scene.tri_p1, scene.tri_p2, scene.sph_center]).cpu()
    lo, hi = pts.min(0).values, pts.max(0).values
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    wl = sampled.sample_visible(torch.rand(n, generator=g))
    term = torch.rand(n, generator=g) < 0.1
    lam_pdf = torch.where(term[:, None], sampled.terminate_secondary(wl).pdf, wl.pdf)
    smp = samplers.start_pixel_sample(torch.randint(0, 1 << 16, (n,), generator=g),
                                      torch.randint(0, meta.spp, (n,), generator=g))
    smp = smp._replace(dim=torch.randint(0, 24, (n,), generator=g))
    depth = torch.randint(0, meta.max_depth + 2, (n,), generator=g).float()
    rr_next = depth + torch.randint(-2, 3, (n,), generator=g).float()
    scale = 10.0 ** (torch.rand((n, 1), generator=g) * 2.3 - 2.0)
    beta = torch.rand((n, 4), generator=g) * scale
    prev_ns = torch.randn((n, 3), generator=g)
    prev_ns = prev_ns / prev_ns.norm(dim=-1, keepdim=True)
    prev_ns = torch.where((torch.rand(n, generator=g) < 0.1)[:, None], 0.0, prev_ns)
    state = path.PathState(
        o=o, d=d, L=torch.rand((n, 4), generator=g) * 0.1, beta=beta, lam=wl.lam,
        lam_pdf=lam_pdf, smp=smp, active=torch.rand(n, generator=g) > 0.1,
        specular=torch.rand(n, generator=g) < 0.2, depth=depth, rr_next=rr_next,
        prev_pdf=torch.rand(n, generator=g) * 2.0,
        prev_p=o - d * torch.rand((n, 1), generator=g), prev_ns=prev_ns,
        n_closest=torch.tensor(7, dtype=torch.int64), n_shadow=torch.tensor(11,
                                                                             dtype=torch.int64))
    if mlt_d is not None:
        mlt = samplers.from_primary_samples(torch.rand((n, mlt_d), generator=g))
        state = state._replace(smp=mlt._replace(
            dim=torch.randint(0, mlt_d + 9, (n,), generator=g)))
    return to_device(state, dev)


def mlt_camera_state(scene, meta, mlt_d, seed):
    """The frame's camera lanes (camera_state) with the MLT kind's sampler
    of integrators/mlt.py (`from_primary_samples` over random vectors (R,
    mlt_d), each lane at dimension 3, as mlt._film_and_sampler starts it)."""
    from pbrt_tpu_torch.sampling import samplers

    state = camera_state(scene, meta)
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((state.o.shape[0], mlt_d), generator=g).to(scene.device)
    smp = samplers.from_primary_samples(x)
    return state._replace(smp=smp._replace(dim=torch.full_like(smp.dim, 3)))


def to_device(x, dev):
    """A PathState (or any tuple of tensors) on `dev`."""
    if isinstance(x, tuple):
        return type(x)(*(to_device(v, dev) for v in x))
    return x.to(dev) if torch.is_tensor(x) else x


def clone(x):
    """A copy of x's tensors, in (named) tuples as x holds them."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        items = [clone(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def chain(scene, meta, state, skind, spp, parts):
    """One bounce through parts = (rr, shade, coat, resolve), the two
    dispatches and, on a scene with coated materials, K7 (layered_answers,
    and layered_pdf at the MIS direction), keeping every part's output ->
    dict(rr=(state, t_max), hit, shade=(state, shadow, pending, lanes),
    k7=(f, pdf, sample) or None, coat=(state, pending, mis mask, mis wi) or
    None, mis=(mask, pdf) or None, occluded, out). coat gets copies of
    shade's state and pending term (coat_cuda updates them in place)."""
    from pbrt_tpu_torch.accel import dispatch
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.materials import layered

    rr, shade, coat, resolve = parts
    st1, t_max = rr(meta, state, skind, spp)
    hit = dispatch.intersect(scene, meta, st1.o, st1.d, t_max)
    st2, shadow, pending, lanes = shade(scene, meta, st1, hit, skind, spp)
    out = dict(rr=(st1, t_max), hit=hit, shade=(st2, shadow, pending, lanes), k7=None,
               coat=None, mis=None, occluded=None)
    st3, pend3 = st2, pending
    if lanes is not None:
        k7 = path.layered_answers(lanes, pending)
        st3, pend3, mis_mask, mis_wi = coat(scene, clone(st2), clone(pending), lanes, *k7)
        out.update(k7=k7, coat=(st3, pend3, mis_mask, mis_wi), mis=(mis_mask, layered.layered_pdf(
            lanes.lay, lanes.wo, mis_wi, mask=mis_mask)))
    if pending is not None:
        out["occluded"] = dispatch.occluded(scene, meta, shadow.o, shadow.d, shadow.t_max)
    out["out"] = (st3 if pending is None and out["mis"] is None
                  else resolve(st3, pend3, out["occluded"], out["mis"]))
    return out


def _equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    eq = a == b
    return eq.reshape(eq.shape[0], -1).all(1)


def _close(a, b, rtol=RTOL, atol=ATOL):
    ok = ((a - b).abs() <= atol + rtol * b.abs()) | (torch.isnan(a) & torch.isnan(b))
    return ok.reshape(ok.shape[0], -1).all(1)


def _mean_rel(a, b):
    fa, fb = a.double(), b.double()
    fin = torch.isfinite(fa) & torch.isfinite(fb)
    if not fin.any():
        return 0.0
    ma, mb = float(fa[fin].mean()), float(fb[fin].mean())
    return abs(ma - mb) / max(abs(mb), 1e-30)


class Report:
    """Per-field agreement of two runs of a part: .equal {field: share of
    lanes bit-exact}, .close {field: share within atol + rtol |plain|
    (default ATOL, RTOL)}, .mean {field: relative difference of the lane
    means}, .coat {field: (the difference of the coated lanes' means, its
    bound, the share of those lanes bit-exact)}; .ok() against EQUAL_FRAC,
    CLOSE_FRAC, MEAN_RTOL and the bounds."""

    def __init__(self, rtol=RTOL, atol=ATOL):
        self.equal, self.close, self.mean, self.max_abs = {}, {}, {}, {}
        self.rtol, self.atol, self.frac, self.coat = rtol, atol, {}, {}

    def exact(self, name, a, b, mask=None):
        e = _equal(a, b)
        self.equal[name] = float(e[mask].double().mean()) if mask is not None and mask.any() \
            else float(e.double().mean()) if mask is None else 1.0

    def near(self, name, a, b, mask=None, frac=CLOSE_FRAC):
        """Field `name` close on the share `frac` of the lanes (of `mask`)."""
        self.frac[name] = frac
        if mask is not None:
            if not mask.any():
                self.close[name], self.mean[name] = 1.0, 0.0
                return
            a, b = a[mask], b[mask]
        self.close[name] = float(_close(a, b, self.rtol, self.atol).double().mean())
        diff = (a - b).abs()
        diff = diff[torch.isfinite(diff)]
        self.max_abs[name] = float(diff.max()) if diff.numel() else 0.0
        self.mean[name] = _mean_rel(a, b)

    def coat_mean(self, name, a, b, mask):
        """Field `name` on the coated lanes of `mask`, whose walks may be
        independent estimates: its lane means (a lane's components summed)
        within the larger of MEAN_RTOL relative and COAT_MEAN_SIGMAS
        standard errors of the difference of two independent means."""
        share = float(_equal(a[mask], b[mask]).double().mean()) if mask.any() else 1.0
        va, vb = (x[mask].double().reshape(int(mask.sum()), -1).sum(1) for x in (a, b))
        fin = torch.isfinite(va) & torch.isfinite(vb)
        va, vb = va[fin], vb[fin]
        if va.numel() < 2:
            self.coat[name] = (0.0, 0.0, share)
            return
        diff = abs(float(va.mean() - vb.mean()))
        se = float(((va.var() + vb.var()) / va.numel()).sqrt())
        self.coat[name] = (diff, max(MEAN_RTOL * abs(float(vb.mean())), COAT_MEAN_SIGMAS * se),
                           share)

    def ok(self):
        return (all(v >= EQUAL_FRAC for v in self.equal.values())
                and all(v >= self.frac[k] for k, v in self.close.items())
                and all(v <= MEAN_RTOL for v in self.mean.values())
                and all(d <= tol for d, tol, _ in self.coat.values()))

    def worst(self):
        """(the least bit-exact share, the least close share of the state
        fields, the largest mean difference), each with its field."""
        def pick(d, fn):
            return fn(d.items(), key=lambda kv: kv[1]) if d else ("-", float("nan"))
        state = {k: v for k, v in self.close.items() if self.frac[k] == CLOSE_FRAC}
        return pick(self.equal, min), pick(state, min), pick(self.mean, max)

    def __str__(self):
        (fe, e), (fc, c), (fm, m) = self.worst()
        light = {k: f"{v:.4%}" for k, v in self.close.items() if self.frac[k] != CLOSE_FRAC}
        coat = "; ".join(f"{k} mean diff {d:.3e} (<= {tol:.3e}), {sh:.2%} of the lanes bit-exact"
                         for k, (d, tol, sh) in self.coat.items())
        return (f"bit-exact >= {e:.6%} ({fe}), within rtol {self.rtol:g} atol {self.atol:g} "
                + (f"(light sample {light}) " if light else "") + f">= {c:.6%} "
                f"({fc}), lane means within {m:.2e} ({fm})"
                + (f"; coated lanes: {coat}" if coat else ""))


STATE_FLOATS = ("o", "d", "L", "beta", "lam_pdf", "prev_pdf", "prev_p", "prev_ns")
# the state fields a coated lane's layered walk sets (path_coat, path_resolve)
WALK_FIELDS = ("active", "specular", "o", "d", "L", "beta", "prev_pdf")


def compare_state(rep, a, b, floats=STATE_FLOATS, walk=None):
    """Two PathStates into rep: draws, masks, depth, rr_next and the ray
    counts exact, the float fields close. With `walk` ((R,) bool: the lanes
    whose layered walks may differ), the WALK_FIELDS on the other lanes
    only, and the walk lanes' L, beta and prev_pdf on their lane means
    (Report.coat_mean)."""
    rep.exact("smp.state", a.smp.state, b.smp.state)
    rep.exact("smp.dim", a.smp.dim, b.smp.dim)

    def lanes(k):
        return None if walk is None or k not in WALK_FIELDS else ~walk

    for k in ("active", "specular", "depth", "rr_next"):
        rep.exact(k, getattr(a, k), getattr(b, k), lanes(k))
    for k in ("n_closest", "n_shadow"):
        rep.exact(k, getattr(a, k).reshape(1), getattr(b, k).reshape(1))
    for k in floats:
        rep.near(k, getattr(a, k), getattr(b, k), lanes(k))
    if walk is not None:
        for k in ("L", "beta", "prev_pdf"):
            if k in floats:
                rep.coat_mean(k, getattr(a, k), getattr(b, k), walk)


def compare_rr(args, kernel, plain):
    """rr's kernel and plain version on the same arguments (meta, state,
    skind, spp) -> Report."""
    (st_k, t_k), (st_p, t_p) = kernel(*args), plain(*args)
    rep = Report()
    compare_state(rep, st_k, st_p, ("beta",))
    rep.exact("t_max", t_k, t_p)
    return rep


LAYER_FIELDS = ("refl", "trans", "eta_re", "eta_im", "eta", "ax", "ay")


def compare_lanes(rep, c_k, c_p, draws=True):
    """Two runs' CoatLanes into rep: the masks and the draws (unless not
    `draws`) exact, the layers' kinds exact and fields close, the local
    directions close; the light sample (on the lanes with NEE) as shade's."""
    rep.exact("coat", c_k.mask, c_p.mask)
    rep.exact("coat_nee", c_k.nee, c_p.nee)
    m, nee = c_k.mask & c_p.mask, c_k.nee & c_p.nee
    if draws:
        rep.exact("uc", c_k.uc, c_p.uc, m)
        rep.exact("u2", c_k.u2, c_p.u2, m)
    for tag in ("top", "bottom"):
        ik, ip = getattr(c_k.lay, tag), getattr(c_p.lay, tag)
        rep.exact(f"{tag}.kind", ik.kind, ip.kind, m)
        for k in LAYER_FIELDS:
            rep.near(f"{tag}.{k}", getattr(ik, k), getattr(ip, k), m)
    for k in ("thickness", "g", "albedo"):
        rep.near(k, getattr(c_k.lay, k), getattr(c_p.lay, k), m)
    rep.near("wo_l", c_k.wo, c_p.wo, m)
    if c_p.wi is not None:
        rep.near("wi_l", c_k.wi, c_p.wi, nee, LIGHT_FRAC)
        rep.near("light_L", c_k.light_L, c_p.light_L, nee, LIGHT_FRAC)
        rep.near("light_pdf", c_k.light_pdf, c_p.light_pdf, nee, LIGHT_FRAC)
        rep.exact("light_ok", c_k.light_ok, c_p.light_ok, nee)
        rep.exact("light_delta", c_k.light_delta, c_p.light_delta, nee)


def compare_shade(args, kernel, plain, part="both"):
    """shade's kernel and plain version on the same arguments (scene, meta,
    state, hit, skind, spp) -> Report: the next state, the NEE mask, and on
    the lanes both take NEE on, the shadow rays and the pending term; the
    coated lanes' CoatLanes. part "light" (path_shade against
    shade_light_plain) or "bsdf" (path_bsdf against shade_bsdf_plain): the
    fields that part forms (path.BSDF_FIELDS and the coated lanes' draws
    the BSDF part's, the rest the light part's)."""
    from pbrt_tpu_torch.integrators.path import BSDF_FIELDS

    (st_k, sh_k, pend_k, c_k), p_out = kernel(*args), plain(*args)
    rep = Report()
    if part == "bsdf":
        st_p, draws = p_out
        rep.exact("smp.state", st_k.smp.state, st_p.smp.state)
        rep.exact("smp.dim", st_k.smp.dim, st_p.smp.dim)
        for k in ("active", "specular"):
            rep.exact(k, getattr(st_k, k), getattr(st_p, k))
        for k in STATE_FLOATS:
            if k in BSDF_FIELDS:
                rep.near(k, getattr(st_k, k), getattr(st_p, k))
        if draws is not None:
            coat, uc, u2 = draws
            rep.exact("uc", c_k.uc, uc, coat)
            rep.exact("u2", c_k.u2, u2, coat)
        return rep
    st_p, sh_p, pend_p, c_p = p_out
    if part == "light":
        rep.exact("depth", st_k.depth, st_p.depth)
        for k in STATE_FLOATS:
            if k not in BSDF_FIELDS:
                rep.near(k, getattr(st_k, k), getattr(st_p, k))
    else:
        compare_state(rep, st_k, st_p)
    if pend_p is not None:
        rep.exact("nee", pend_k.mask, pend_p.mask)
        rep.exact("shadow t_max = 0", sh_k.t_max == 0, sh_p.t_max == 0)
        both = pend_k.mask & pend_p.mask
        for k in ("o", "d", "t_max"):
            rep.near(f"shadow.{k}", getattr(sh_k, k), getattr(sh_p, k), both, LIGHT_FRAC)
        rep.near("ld", pend_k.ld, pend_p.ld, both, LIGHT_FRAC)
    if c_p is not None:
        compare_lanes(rep, c_k, c_p, draws=part == "both")
    return rep


def shade_bits(a, b):
    """Two runs of shade on the same arguments, (state, shadow, pending,
    lanes) each -> {field: share of the lanes where a's bits are b's}:
    every lane of the state, the shadow rays and the pending term; the
    coated lanes' layer, directions and draws on the coated lanes, their
    light sample on those with NEE (the kernels write nothing elsewhere)."""
    def share(x, y, m=None):
        e = _equal(x, y)
        if m is not None:
            e = e[m]
        return int(e.sum()) / e.numel() if e.numel() else 1.0

    (st_a, sh_a, pd_a, c_a), (st_b, sh_b, pd_b, c_b) = a, b
    out = {k: share(getattr(st_a, k), getattr(st_b, k))
           for k in ("o", "d", "L", "beta", "lam", "lam_pdf", "active", "specular", "depth",
                     "rr_next", "prev_pdf", "prev_p", "prev_ns")}
    out |= {f"smp.{k}": share(getattr(st_a.smp, k), getattr(st_b.smp, k))
            for k in ("state", "dim")}
    if pd_b is not None:
        out |= {f"shadow.{k}": share(getattr(sh_a, k), getattr(sh_b, k))
                for k in ("o", "d", "t_max")}
        out |= {"nee": share(pd_a.mask, pd_b.mask), "ld": share(pd_a.ld, pd_b.ld)}
    if c_b is not None:
        m, nee = c_b.mask, c_b.nee
        out |= {"coat": share(c_a.mask, m), "coat_nee": share(c_a.nee, nee)}
        for tag in ("top", "bottom"):
            for k in ("kind",) + LAYER_FIELDS:
                out[f"{tag}.{k}"] = share(getattr(getattr(c_a.lay, tag), k),
                                          getattr(getattr(c_b.lay, tag), k), m)
        for k in ("thickness", "g", "albedo", "wo", "uc", "u2"):
            x, y = ((getattr(c.lay, k) if k in ("thickness", "g", "albedo") else getattr(c, k))
                    for c in (c_a, c_b))
            out[k] = share(x, y, m)
        if c_b.wi is not None:
            for k in ("wi", "light_L", "light_pdf", "light_ok", "light_delta"):
                out[k] = share(getattr(c_a, k), getattr(c_b, k), nee)
    return out


def shade_parts():
    """((path_shade's wrapper, its plain part), (path_bsdf's, its plain
    part)): each kernel of shade_cuda alone against its part of
    shade_plain (compare_shade's part "light" and "bsdf")."""
    from functools import partial

    from pbrt_tpu_torch.integrators import path
    return ((partial(path.shade_cuda, kernels=("path_shade",)), path.shade_light_plain),
            (partial(path.shade_cuda, kernels=("path_bsdf",)), path.shade_bsdf_plain))


def composed_shade(light, bsdf):
    """shade(scene, meta, state, hit, skind, spp) from its two parts, each
    called alone on the same arguments (path.merge_shade)."""
    from pbrt_tpu_torch.integrators.path import merge_shade

    return lambda *args: merge_shade(light(*args), bsdf(*args))


def parent_shade_plain(scene, meta, state, hit, skind="independent", spp=0):
    """integrators/path.py's shade_plain as it was before its two parts
    (shade_light_plain, shade_bsdf_plain: the plain versions of the kernels
    path_shade and path_bsdf) were factored out of it, kept as the reference
    the parts are held to bit for bit."""
    from pbrt_tpu_torch.geometry import vecmath as vm
    from pbrt_tpu_torch.geometry.ray import offset_ray_origin
    from pbrt_tpu_torch.integrators.path import (CoatLanes, NeePending, ShadowRays,
                                                 _pick_light)
    from pbrt_tpu_torch.lights import lights
    from pbrt_tpu_torch.materials import bxdfs, materials, scattering as sc
    from pbrt_tpu_torch.sampling import samplers
    from pbrt_tpu_torch.spectral import sampled
    from pbrt_tpu_torch.utils.math import power_heuristic

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


def compare_coat(args, kernel, plain):
    """coat's kernel and plain version on the same arguments (scene, state,
    pending, lanes, f, pdf, sample), the kernel on copies of state and
    pending (it updates them in place) -> Report: the next state, the
    pending term on the coated NEE lanes, the MIS mask and direction."""
    scene, st, pend, *rest = args
    st_k, pend_k, mm_k, mw_k = kernel(scene, clone(st), clone(pend), *rest)
    st_p, pend_p, mm_p, mw_p = plain(*args)
    rep = Report()
    compare_state(rep, st_k, st_p)
    if pend_p is not None:
        rep.near("ld", pend_k.ld, pend_p.ld, rest[0].nee)
    rep.exact("mis_mask", mm_k, mm_p)
    rep.near("mis_wi", mw_k, mw_p, mm_k & mm_p)
    return rep


def compare_resolve(args, kernel, plain):
    """resolve's kernel and plain version on the same arguments (state,
    pending, occluded, mis) -> Report."""
    rep = Report()
    compare_state(rep, kernel(*args), plain(*args), ("L", "prev_pdf"))
    return rep


def compare_parts(scene, meta, state, skind, spp, kernel, plain, shade_split=None):
    """Each of the kernel parts (rr, shade, coat, resolve) against the plain
    part on the same inputs (the plain chain's) -> ({"rr", "shade",
    ["coat",] "resolve": Report}, the plain chain's lane counts {"lanes",
    "traced", "hits", "nee", "coated"}). With shade_split (shade_parts()),
    also shade's two kernels each against its plain part ("shade.light",
    "shade.bsdf")."""
    p = chain(scene, meta, state, skind, spp, plain)
    st1 = p["rr"][0]
    st2, _, pending, lanes = p["shade"]
    shade_args = (scene, meta, st1, p["hit"], skind, spp)
    out = {"rr": compare_rr((meta, state, skind, spp), kernel[0], plain[0]),
           "shade": compare_shade(shade_args, kernel[1], plain[1])}
    for part, (k, pl) in zip(("light", "bsdf"), shade_split or ()):
        out[f"shade.{part}"] = compare_shade(shade_args, k, pl, part)
    st3, pend3 = st2, pending
    if lanes is not None:
        out["coat"] = compare_coat((scene, st2, pending, lanes) + p["k7"], kernel[2], plain[2])
        st3, pend3 = p["coat"][:2]
    out["resolve"] = compare_resolve((st3, pend3, p["occluded"], p["mis"]), kernel[3], plain[3])
    seen = dict(lanes=state.o.shape[0], traced=int(st1.active.sum()),
                hits=int((p["hit"].valid & st1.active).sum()), nee=int(pending.mask.sum()),
                coated=0 if lanes is None else int(lanes.mask.sum()))
    return out, seen


def compare_bounce(scene, meta, state, skind, spp, kernel, plain):
    """The whole bounce through the kernel chain and the plain chain from
    one input state -> (Report, the coated lanes' count): compare_state with
    the coated lanes' walk fields on their lane means (walk: the plain
    chain's coated lanes)."""
    p = chain(scene, meta, state, skind, spp, plain)
    k, lanes = chain(scene, meta, state, skind, spp, kernel)["out"], p["shade"][3]
    p = p["out"]
    rep = Report()
    walk = None if lanes is None else lanes.mask
    compare_state(rep, k, p, walk=walk)
    return rep, 0 if walk is None else int(walk.sum())
