"""The path step K6 on the CPU. Its plain parts (pbrt_tpu_torch/integrators/
path.py `rr_plain`, `shade_plain`, `coat_plain`, `resolve_plain`, around
dispatch.intersect, K7's plain walks and dispatch.occluded) against the JAX
package's `bounce_step`, one bounce at a time for three bounces: each bounce
starts both from the port's state, carried across bit for bit, on
tests/path_cases.py's scene (every light type and shape; diffuse, rough and
smooth conductors, a reflectance-mode conductor, smooth, rough and
dispersive dielectrics, diffuse transmission) compiled by the JAX package
and carried across with scene_from_arrays, for both sampler kinds. Sampler
state and dimension bit-exact on every lane; active, specular and depth
equal on path_cases.EQUAL_FRAC of the lanes; every float field within
JAX_RTOL, JAX_ATOL on path_cases.CLOSE_FRAC of the lanes and its lane mean
within MEAN_RTOL; the ray counts equal. The tolerance is ten times the
kernels' (path_cases.RTOL, ATOL): the two hit records differ, XLA
contracting multiply-adds in the quadric and triangle tests, so a sphere's
normal seen from the camera lens differs by up to ~1e-4 relative on a
percent of the first bounce's lanes, and the directions sampled about it
with it; its transcendentals round apart from torch's, and the
spherical-triangle warps are ill-conditioned in float32. The same on the
scene with path_cases' two coated spheres (the layered walk, K7), where a
coated lane's walk seeds on the float bits of its local directions, which
XLA and torch sum apart: the draws bit-exact and depth equal on every lane,
the other lanes as above, the coated lanes' L, beta and prev_pdf on their
lane means (path_cases.COAT_MEAN_SIGMAS standard errors); and with the MLT
sampler kind over primary-sample vectors shorter and longer than a path's
draws. Then bounce_step on CPU tensors as the chain of its plain parts, bit
for bit; the route function (step_route), the CUDA wrappers refusing CPU
tensors, and the kernels' argument record against csrc/path_step.cu's,
which need no card."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.sampling import rng as jrng, samplers as jsamplers
from pbrt_tpu.scene import builder as jbd, lexer as jlx
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.scene.compile import scene_from_arrays
import bdpt_cases
import path_cases as pc

torch.set_num_threads(2)
PLAIN = (tpath.rr_plain, tpath.shade_plain, tpath.coat_plain, tpath.resolve_plain)
# (sampler kind, resolution, spp): 2048 and 1024 lanes
KINDS = {"independent": (32, 2), "stratified": (16, 4)}
JAX_RTOL, JAX_ATOL = 1e-3, 1e-5


def _scenes(text, res):
    """The JAX package's scene of `text` at res x res and the port's CPU
    twin (scene_from_arrays) -> (JAX scene, JAX meta, port scene, port meta)."""
    b = jbd.SceneBuilder()
    b.parse_tokens(jlx.tokenize(text))
    b.film["xresolution"] = b.film["yresolution"] = res
    js, jm = j_compile(b)
    arrays = {k: (np.asarray(v) if k != "filt" else v) for k, v in js._asdict().items()
              if v is not None and k != "tex"}
    ts, tm = scene_from_arrays(arrays, jm, "cpu")
    return js, jm, ts, tm


def _jax_step(js, jm, skind, spp):
    return jax.jit(lambda s: jpath.bounce_step(js, s, False, skind, spp, (), False,
                                               jm.max_depth, False))


@pytest.fixture(scope="module", params=list(KINDS))
def case(request):
    """(port scene and meta, sampler kind, spp, JAX's bounce step jitted
    once)."""
    skind = request.param
    res, spp = KINDS[skind]
    js, jm, ts, tm = _scenes(pc.scene_text(skind, spp), res)
    return ts, tm, skind, spp, _jax_step(js, jm, skind, spp)


@pytest.fixture(scope="module")
def coated_case():
    """The coated scene (path_cases.COATED_PBRT) at 32^2 x 2, independent:
    (port scene and meta, JAX's bounce step jitted once)."""
    js, jm, ts, tm = _scenes(pc.scene_text("independent", 2, coated=True), 32)
    assert tm.layered
    return ts, tm, _jax_step(js, jm, "independent", 2)


@pytest.fixture(scope="module")
def mlt_case():
    """The uncoated scene at 32^2 x 2 with the MLT kind: (port scene and
    meta, JAX's bounce step jitted once; it traces once a vector length)."""
    js, jm, ts, tm = _scenes(pc.scene_text("independent", 2), 32)
    return ts, tm, _jax_step(js, jm, "mlt", 0)


def _u64(x):
    v = x.numpy().view(np.uint64)
    return jrng.U64(hi=jnp.asarray((v >> np.uint64(32)).astype(np.uint32)),
                    lo=jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def to_jax(st):
    """The port's PathState as the JAX package's, bit for bit (no medium)."""
    R = st.o.shape[0]

    def f(x):
        return jnp.asarray(x.numpy())

    smp = jsamplers.Sampler(state=_u64(st.smp.state), inc=_u64(st.smp.inc),
                            pixel=jnp.asarray(st.smp.pixel.numpy().astype(np.uint32)),
                            sample=jnp.asarray(st.smp.sample.numpy().astype(np.uint32)),
                            dim=jnp.asarray(st.smp.dim.numpy().astype(np.uint32)),
                            mlt_x=None if st.smp.mlt_x is None else jnp.asarray(
                                st.smp.mlt_x.numpy()))
    return jpath.PathState(
        o=f(st.o), d=f(st.d), L=f(st.L), beta=f(st.beta), lam=f(st.lam), lam_pdf=f(st.lam_pdf),
        smp=smp, active=f(st.active), specular=f(st.specular), depth=f(st.depth),
        rr_next=f(st.rr_next), prev_pdf=f(st.prev_pdf), prev_p=f(st.prev_p),
        prev_ns=f(st.prev_ns), medium=jnp.full((R,), -1, jnp.int32), trans_pdf=jnp.ones((R, 4)),
        n_closest=jnp.float32(int(st.n_closest)), n_shadow=jnp.float32(int(st.n_shadow)))


def from_jax(js, mlt_x=None):
    """The JAX package's PathState as the port's CPU one (the MLT kind's
    vectors, which a bounce does not change, given back as mlt_x)."""
    def t(x):
        return torch.from_numpy(np.array(x))

    return tpath.PathState(
        o=t(js.o), d=t(js.d), L=t(js.L), beta=t(js.beta), lam=t(js.lam), lam_pdf=t(js.lam_pdf),
        smp=bdpt_cases.sampler_from_arrays(js.smp)._replace(mlt_x=mlt_x), active=t(js.active),
        specular=t(js.specular), depth=t(js.depth), rr_next=t(js.rr_next),
        prev_pdf=t(js.prev_pdf), prev_p=t(js.prev_p), prev_ns=t(js.prev_ns),
        n_closest=torch.tensor(int(js.n_closest)), n_shadow=torch.tensor(int(js.n_shadow)))


def test_plain_parts_match_jax_bounce_step(case):
    scene, meta, skind, spp, step = case
    state = pc.camera_state(scene, meta)
    for bounce in range(3):
        got = pc.chain(scene, meta, state, skind, spp, PLAIN)["out"]
        want = from_jax(step(to_jax(state)))
        rep = pc.Report(JAX_RTOL, JAX_ATOL)
        pc.compare_state(rep, got, want)
        assert rep.ok(), (bounce, str(rep))
        # the draws bit for bit on every lane
        assert torch.equal(got.smp.state, want.smp.state), bounce
        assert torch.equal(got.smp.dim, want.smp.dim), bounce
        assert int(got.n_closest) == int(want.n_closest) > 0, bounce
        assert int(got.n_shadow) == int(want.n_shadow) > int(state.n_shadow), bounce
        state = got
    assert int(state.active.sum()) > 0


def _bits(st):
    """Every tensor of a PathState, floats as their bits."""
    for x in st:
        if isinstance(x, tuple):
            yield from _bits(x)
        elif x is not None:
            yield x.view(torch.int32) if x.dtype == torch.float32 else x


def test_coated_plain_chain_matches_jax_bounce_step(coated_case):
    """The factored plain chain on the coated scene (shade_plain, K7's plain
    walks, coat_plain, layered_pdf at the MIS direction, resolve_plain)
    against JAX's bounce_step, three bounces each from the port's state:
    the draws bit-exact and depth (the shading mask) equal on every lane,
    so the shading and NEE masks too; the uncoated lanes to the criteria of
    test_plain_parts_match_jax_bounce_step; the coated lanes' L, beta and
    prev_pdf on their lane means (path_cases.Report.coat_mean: within
    COAT_MEAN_SIGMAS standard errors of two independent means)."""
    scene, meta, step = coated_case
    state = pc.camera_state(scene, meta)
    coated = 0
    for bounce in range(3):
        c = pc.chain(scene, meta, state, "independent", 2, PLAIN)
        got, lanes = c["out"], c["shade"][3]
        want = from_jax(step(to_jax(state)))
        rep = pc.Report(JAX_RTOL, JAX_ATOL)
        pc.compare_state(rep, got, want, walk=lanes.mask)
        assert rep.ok(), (bounce, str(rep))
        assert torch.equal(got.smp.state, want.smp.state), bounce
        assert torch.equal(got.smp.dim, want.smp.dim), bounce
        assert torch.equal(got.depth, want.depth), bounce
        assert int(got.n_closest) == int(want.n_closest) > 0, bounce
        assert int(got.n_shadow) == int(want.n_shadow) > int(state.n_shadow), bounce
        coated += int(lanes.mask.sum())
        state = got
    assert coated >= 200 and int(state.active.sum()) > 0


@pytest.mark.parametrize("mlt_d", [8, 40])
def test_mlt_kind_plain_chain_matches_jax_bounce_step(mlt_case, mlt_d):
    """The plain chain with the MLT sampler kind (from_primary_samples lanes
    at dimension 3, as integrators/mlt.py starts them) against JAX's
    bounce_step, three bounces each from the port's state: with D = 8 a
    shading lane's first bounce runs past its vector into the stream, with
    D = 40 no lane leaves it. Draws bit-exact on every lane, the rest to the
    criteria of test_plain_parts_match_jax_bounce_step."""
    scene, meta, step = mlt_case
    state = pc.mlt_camera_state(scene, meta, mlt_d, 3)
    for bounce in range(3):
        got = pc.chain(scene, meta, state, "mlt", 0, PLAIN)["out"]
        want = from_jax(step(to_jax(state)), state.smp.mlt_x)
        rep = pc.Report(JAX_RTOL, JAX_ATOL)
        pc.compare_state(rep, got, want)
        assert rep.ok(), (bounce, str(rep))
        assert torch.equal(got.smp.state, want.smp.state), bounce
        assert torch.equal(got.smp.dim, want.smp.dim), bounce
        assert int(got.n_closest) == int(want.n_closest) > 0, bounce
        assert int(got.n_shadow) == int(want.n_shadow) > int(state.n_shadow), bounce
        state = got
    dims = state.smp.dim
    assert (bool((dims > mlt_d).any()) if mlt_d == 8 else bool((dims < mlt_d).all()))


def _bits(st):
    """Every tensor of a PathState, floats as their bits."""
    for x in st:
        if isinstance(x, tuple):
            yield from _bits(x)
        elif x is not None:
            yield x.view(torch.int32) if x.dtype == torch.float32 else x


def test_bounce_step_is_the_plain_chain(case):
    """On CPU tensors bounce_step takes the plain route: the chain of its
    parts, bit for bit."""
    scene, meta, skind, spp, _ = case
    state = pc.camera_state(scene, meta, n_pix=256)
    a = tpath.bounce_step(scene, meta, state, skind, spp)
    b = pc.chain(scene, meta, state, skind, spp, PLAIN)["out"]
    assert all(torch.equal(x, y) for x, y in zip(_bits(a), _bits(b)))


@pytest.mark.parametrize("which", ["coated", "mlt"])
def test_bounce_step_is_the_factored_plain_chain(coated_case, mlt_case, which):
    """bounce_step on CPU tensors on the coated scene and with the MLT kind:
    the factored plain chain (shade_plain, K7's plain walks, coat_plain, the
    MIS pdf, resolve_plain), bit for bit, over two bounces."""
    if which == "coated":
        scene, meta, _ = coated_case
        state, skind = pc.camera_state(scene, meta, n_pix=512), "independent"
    else:
        scene, meta, _ = mlt_case
        state, skind = pc.mlt_camera_state(scene, meta, 12, 4), "mlt"
    for _ in range(2):
        a = tpath.bounce_step(scene, meta, state, skind, 2)
        b = pc.chain(scene, meta, state, skind, 2, PLAIN)["out"]
        assert all(torch.equal(x, y) for x, y in zip(_bits(a), _bits(b)))
        state = a
    assert int(state.active.sum()) > 0


def test_step_route():
    """"cuda" on a CUDA device for every path-integrator render (uncoated
    and coated scenes; the independent, stratified and MLT kinds), "plain"
    on the CPU."""
    for layered in (False, True):
        for skind in tpath.STEP_SAMPLERS:
            meta = SimpleNamespace(layered=layered, sampler=skind)
            assert tpath.step_route("cpu", meta) == "plain"
            assert tpath.step_route(torch.device("cpu"), meta) == "plain"
            assert tpath.step_route("cuda", meta) == "cuda"
            assert tpath.step_route("cuda:0", meta) == "cuda"
            for kind in tpath.STEP_SAMPLERS:
                assert tpath.step_route("cuda", meta, kind) == "cuda"
                assert tpath.step_route("cpu", meta, kind) == "plain"
    assert tpath.STEP_SAMPLERS == ("independent", "stratified", "mlt")


def test_cuda_wrappers_refuse_cpu_tensors():
    from pbrt_tpu_torch.accel import dispatch
    from pbrt_tpu_torch.scene.compile import compile_scene

    scene, meta = compile_scene(pc.builder(8, coated=True), device="cpu")
    assert meta.layered
    state = pc.camera_state(scene, meta)
    st1, t_max = tpath.rr_plain(meta, state)
    hit = dispatch.intersect(scene, meta, st1.o, st1.d, t_max)
    st2, shadow, pending, lanes = tpath.shade_plain(scene, meta, st1, hit)
    assert lanes is not None and bool(lanes.mask.any())
    k7 = tpath.layered_answers(lanes, pending)
    n0 = dict(tpath.launches)
    with pytest.raises(ValueError):
        tpath.rr_cuda(meta, state)
    with pytest.raises(ValueError):
        tpath.shade_cuda(scene, meta, st1, hit)
    with pytest.raises(ValueError):
        tpath.coat_cuda(scene, st2, pending, lanes, *k7)
    with pytest.raises(ValueError):
        tpath.resolve_cuda(st2, pending, torch.zeros_like(pending.mask))
    with pytest.raises(ValueError):
        tpath.rr_cuda(dataclasses.replace(meta, layered=True), state)
    with pytest.raises(ValueError):
        tpath.rr_cuda(meta, pc.mlt_camera_state(scene, meta, 8, 1), "mlt", 0)
    assert tpath.launches == n0


def test_step_tables_hold_the_scene_rows():
    """The kernels' per-scene rows (path.step_tables) against the scene's
    own fields, and the argument record's layout (every field 8 bytes, as
    csrc/path_step.cu's StepArgs, which the library checks at load)."""
    from pbrt_tpu_torch.lights import lights
    from pbrt_tpu_torch.scene.compile import compile_scene

    scene, meta = compile_scene(pc.builder(8, coated=True), device="cpu")
    tab = tpath.step_tables(scene)
    assert tab is tpath.step_tables(scene)
    M, L = scene.mat_type.shape[0], scene.lt_type.shape[0]
    assert tab["mat"].shape == (M, tpath.MAT_F) and tab["lt"].shape == (L, tpath.LT_F)
    assert torch.equal(tab["mat"][:, 0], scene.mat_type.float())
    assert torch.equal(tab["mat"][:, 8:11], scene.mat_refl_c)
    for col, field in ((14, "mat_ieta"), (15, "mat_crough_u"), (16, "mat_crough_v"),
                       (17, "mat_thickness"), (18, "mat_lay_g")):
        assert torch.equal(tab["mat"][:, col], getattr(scene, field)), field
    assert torch.equal(tab["mat"][:, 19:22], scene.mat_albedo_c)
    assert bool((tab["mat"][:, 0] >= 4).any())
    assert torch.equal(tab["lt"][:, 1], scene.lt_pmf)
    assert torch.equal(tab["lt"][:, 15:18], scene.lt_alias_rows)
    assert torch.equal(tab["uinf"], lights.uniform_infinite_emission(scene))
    dens = lights.infinite_light_density(scene, torch.zeros((1, 3)))[0]
    assert float(tab["scal"][2]) == float(dens) > 0
    import ctypes
    assert ctypes.sizeof(tpath._StepArgs) == 8 * (len(tpath._ARG_FIELDS)
                                                   + len(tpath._INT_FIELDS))


def _struct_fields(src, name):
    """The field names of C struct `name` in source text `src`, in order."""
    import re

    body = src[src.index(f"struct {name} {{") + len(name) + 9:]
    body = re.sub(r"//[^\n]*", "", body[:body.index("};")])
    names = []
    for decl in body.split(";"):
        for i, part in enumerate(decl.split(",")):
            part = part.strip()
            if part:
                names.append(re.search(r"(\w+)\s*$", part).group(1))
    return names


def test_step_args_fields_match_the_cuda_struct():
    """csrc/path_step.cu's StepArgs, its field names in order, against
    path._ARG_FIELDS then _INT_FIELDS: the load-time size check cannot
    tell two swapped fields apart."""
    from pathlib import Path

    src = (Path(tpath.__file__).resolve().parents[1] / "csrc" / "path_step.cu").read_text()
    fields = _struct_fields(src, "StepArgs")
    assert fields == list(tpath._ARG_FIELDS) + list(tpath._INT_FIELDS)
    # and the constants the kernels index the material and light rows by
    for const, value in (("MAT_F", tpath.MAT_F), ("LT_F", tpath.LT_F)):
        assert f"constexpr int {const} = {value};" in src, const
