"""Participating media through the port's path integrator on the CPU,
held against the JAX package on the same inputs: sample_exponential and
the HG phase function and sample within 4 ulps of JAX's on seeded numpy
inputs (XLA's log, exp and sqrt round apart from torch's); the
transmittance hop loop (path.transmittance over transmit_hop_plain) against
JAX's compute_transmittance on tests/test_medium.py's absorbing sphere and
blocked segment; the plain volumetric bounce (rr_plain, shade_vol_plain,
the hop loop, resolve_vol_plain) against JAX's bounce_step(volumetric=True)
one bounce at a time for four bounces from the port's state carried across
bit for bit, on FOG_SPHERE's camera lanes (tests/medium_cases.py), with and
without its light, and on
synthetic lanes of volumetric-caustic (in the fog and out of it): the
draws, masks, medium and depth (0.3 a crossing) equal on path_cases.
EQUAL_FRAC of the lanes (the distance draw's log1p and exp round apart
between XLA and torch, which can flip a scatter decision on a rare lane),
the float fields within JAX_RTOL, JAX_ATOL on path_cases.CLOSE_FRAC of the
lanes and their lane means within path_cases.MEAN_RTOL. Then FOG_SPHERE's
path render at 16^2 x 4 against JAX's on 4x4 block means
(test_torch_render._check), the ray counts within 1 %."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pbrt_tpu.integrators import path as jpath, render as jrender
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.sampling import warps as jwarps, samplers as jsamplers
from pbrt_tpu_torch.integrators import path as tpath, render as trender
from pbrt_tpu_torch.sampling import warps as twarps
from pbrt_tpu_torch.scene.compile import compile_scene
import bdpt_cases
import medium_cases as mc
import medium_jax as mj
import path_cases as pc
from layered_cases import blocks
from test_torch_path_step import _u64
from test_torch_render import _check

torch.set_num_threads(2)
JAX_RTOL, JAX_ATOL = 1e-3, 1e-5
ULPS = 4


def _ulps(a, b):
    """The largest distance in units in the last place of two float32 arrays."""
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    return int(np.abs(a - b).max())


def test_sample_exponential_and_hg_match_jax():
    """sample_exponential, henyey_greenstein and sample_henyey_greenstein
    on seeded numpy inputs against JAX's: the same operations in the same
    order, so within ULPS units in the last place (XLA:CPU's log, exp and
    sqrt are its own approximations and round apart from torch's on ~10 %
    of inputs, by 1-2 ulps), the sampled directions within 2e-6."""
    rng = np.random.default_rng(5)
    n = 4096
    u = rng.uniform(size=(n, 2)).astype(np.float32)
    a = rng.uniform(0.05, 4.0, size=n).astype(np.float32)
    g = rng.uniform(-0.95, 0.95, size=n).astype(np.float32)
    g[:64] = rng.uniform(-2e-3, 2e-3, size=64)    # the |g| < 1e-3 clamp
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    cos = rng.uniform(-1, 1, size=n).astype(np.float32)

    got = twarps.sample_exponential(torch.from_numpy(u[:, 0]), torch.from_numpy(a)).numpy()
    want = np.asarray(jwarps.sample_exponential(jnp.asarray(u[:, 0]), jnp.asarray(a)))
    assert _ulps(got, want) <= ULPS
    got = twarps.henyey_greenstein(torch.from_numpy(cos), torch.from_numpy(g)).numpy()
    want = np.asarray(jwarps.henyey_greenstein(jnp.asarray(cos), jnp.asarray(g)))
    assert _ulps(got, want) <= ULPS
    wi, pdf = twarps.sample_henyey_greenstein(torch.from_numpy(wo), torch.from_numpy(g),
                                              torch.from_numpy(u))
    jwi, jpdf = jwarps.sample_henyey_greenstein(jnp.asarray(wo), jnp.asarray(g), jnp.asarray(u))
    assert _ulps(pdf.numpy(), jpdf) <= ULPS
    np.testing.assert_allclose(wi.numpy(), np.asarray(jwi), rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def fog_absorbing():
    jb, _ = mj.builders(mc.fog_text(0.8, 0.0))
    return mj.twins(jb, 4)


@pytest.fixture(scope="module")
def fog_blocked():
    jb, _ = mj.builders(mc.fog_text(0.1, 0.0))
    return mj.twins(jb, 4)


def _segments(scene, kind, n=8):
    """tests/test_medium.py's segments: straight through the absorbing
    sphere's center, or across the floor."""
    if kind == "sphere":
        c = scene.sph_center[0].numpy()
        p0, p1 = c + [0, 0, -4.0], c + [0, 0, 4.0]
        d, ng = [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]
    else:
        y = float(scene.tri_p0[-1, 1])
        p0, p1 = [0.5, y + 1.0, 2.0], [0.5, y - 1.0, 2.0]
        d, ng = [0.0, -1.0, 0.0], [0.0, 1.0, 0.0]
    return [np.tile(np.asarray(v, np.float32), (n, 1)) for v in (p0, ng, d, p1)]


@pytest.mark.parametrize("kind", ["sphere", "blocked"])
def test_transmittance_matches_jax(kind, fog_absorbing, fog_blocked):
    """The hop loop (dispatch.intersect and transmit_hop_plain, MAX_HOPS
    rounds) against JAX's compute_transmittance, within 1e-6: Beer-Lambert
    through the interface sphere, 0 across the floor."""
    js, jm, ts, tm = fog_absorbing if kind == "sphere" else fog_blocked
    p0, ng, d, p1 = _segments(ts, kind)
    lam = np.full((8, 4), 550.0, np.float32)
    lam[1::2] = [420.0, 500.0, 610.0, 690.0]
    medium = np.full(8, -1, np.int32)
    want = np.asarray(jpath.compute_transmittance(
        js, jnp.asarray(p0), jnp.asarray(ng), jnp.asarray(d), jnp.asarray(p1),
        jnp.asarray(medium), js.ray_offset_scale, jnp.asarray(lam)))
    t = {k: torch.from_numpy(v) for k, v in zip(("p0", "ng", "d", "p1"), (p0, ng, d, p1))}
    from pbrt_tpu_torch.geometry.ray import offset_ray_origin
    from pbrt_tpu_torch.geometry import vecmath as vm

    o = offset_ray_origin(t["p0"], t["ng"], t["d"], ts.ray_offset_scale)
    got = tpath.transmittance(ts, tm, o, t["d"], t["p1"], torch.from_numpy(medium).long(),
                              torch.from_numpy(lam), vm.distance(o, t["p1"]) * (1.0 - 1e-3))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    if kind == "sphere":
        assert (want > 0.05).all() and (want < 0.2).all()
    else:
        assert (want == 0).all()


def to_jax(st):
    """The port's volumetric PathState as the JAX package's, bit for bit."""
    def f(x):
        return jnp.asarray(x.numpy())

    smp = jsamplers.Sampler(state=_u64(st.smp.state), inc=_u64(st.smp.inc),
                            pixel=jnp.asarray(st.smp.pixel.numpy().astype(np.uint32)),
                            sample=jnp.asarray(st.smp.sample.numpy().astype(np.uint32)),
                            dim=jnp.asarray(st.smp.dim.numpy().astype(np.uint32)), mlt_x=None)
    return jpath.PathState(
        o=f(st.o), d=f(st.d), L=f(st.L), beta=f(st.beta), lam=f(st.lam), lam_pdf=f(st.lam_pdf),
        smp=smp, active=f(st.active), specular=f(st.specular), depth=f(st.depth),
        rr_next=f(st.rr_next), prev_pdf=f(st.prev_pdf), prev_p=f(st.prev_p),
        prev_ns=f(st.prev_ns), medium=jnp.asarray(st.medium.numpy().astype(np.int32)),
        trans_pdf=f(st.trans_pdf), n_closest=jnp.float32(int(st.n_closest)),
        n_shadow=jnp.float32(int(st.n_shadow)))


def from_jax(js):
    def t(x):
        return torch.from_numpy(np.array(x))

    return tpath.PathState(
        o=t(js.o), d=t(js.d), L=t(js.L), beta=t(js.beta), lam=t(js.lam), lam_pdf=t(js.lam_pdf),
        smp=bdpt_cases.sampler_from_arrays(js.smp), active=t(js.active),
        specular=t(js.specular), depth=t(js.depth), rr_next=t(js.rr_next),
        prev_pdf=t(js.prev_pdf), prev_p=t(js.prev_p), prev_ns=t(js.prev_ns),
        n_closest=torch.tensor(int(js.n_closest)), n_shadow=torch.tensor(int(js.n_shadow)),
        medium=t(js.medium).long(), trans_pdf=t(js.trans_pdf))


@pytest.fixture(scope="module", params=["fog", "caustic"])
def vol_case(request):
    """(port scene and meta, the first state, JAX's volumetric bounce step
    jitted once)."""
    if request.param == "fog":
        jb, _ = mj.builders(mc.fog_text(0.3, 0.6, 0.3), res=24, max_depth=8)
        js, jm, ts, tm = mj.twins(jb, 2)
        state = pc.camera_state(ts, tm)
        state = state._replace(medium=torch.full_like(state.smp.dim, -1),
                               trans_pdf=torch.ones_like(state.L))
    else:
        jb, _ = mj.builders(path=mc.CAUSTIC, res=16, integrator="path")
        js, jm, ts, tm = mj.twins(jb, 2)
        state = mc.synthetic_fog_lanes(ts, tm, 2048, 11)
    assert tm.volumetric and jm.volumetric
    step = jax.jit(lambda s: jpath.bounce_step(js, s, False, "independent", 2, (), True,
                                               jm.max_depth, False))
    return request.param, ts, tm, state, step


def test_volumetric_bounce_matches_jax(vol_case):
    """Four bounces (see the module's docstring); FOG_SPHERE's lanes cross
    its interface (fractional depths), both scenes' lanes scatter."""
    name, scene, meta, state, step = vol_case
    scattered = crossed = 0
    for bounce in range(4):
        got = tpath.bounce_step(scene, meta, state, "independent", 2)
        want = from_jax(step(to_jax(state)))
        rep = pc.Report(JAX_RTOL, JAX_ATOL)
        pc.compare_state(rep, got, want, pc.STATE_FLOATS + ("trans_pdf",))
        rep.exact("medium", got.medium, want.medium)
        assert rep.ok(), (bounce, str(rep))
        assert int(got.n_closest) == int(want.n_closest) > 0, bounce
        assert abs(int(got.n_shadow) - int(want.n_shadow)) <= 0.001 * int(want.n_shadow) + 1
        frac = got.depth - torch.floor(got.depth)
        crossed += int((frac > 0).sum())
        scattered += int((got.active & (got.medium >= 0)).sum())
        state = got
    assert scattered > 0 and (crossed > 0 or name == "caustic")


def test_volumetric_bounce_without_lights():
    """FOG_SPHERE with and without its light (the JAX package cannot render
    a scene without lights, so the port is held to its lit twin): from the
    same state, over three bounces, a lane in the fog hands on the same
    sampler stream in both scenes (the NEE draws of a scatter point are
    stepped past with no light to pick, as path_bsdf_vol steps past them);
    the lightless scene's bounces add no radiance and trace no shadow
    rays."""
    scenes = []
    for lit in (True, False):
        tb = mj.builders(mc.fog_text(0.3, 0.6, 0.3, lights=lit), res=24, max_depth=8)[1]
        scenes.append(compile_scene(tb, spp_override=2, device="cpu"))
    (s_lit, m_lit), (s_dark, m_dark) = scenes
    assert m_dark.volumetric and s_dark.lt_pmf.shape[0] == 0
    state = pc.camera_state(s_lit, m_lit)
    state = state._replace(medium=torch.full_like(state.smp.dim, -1),
                           trans_pdf=torch.ones_like(state.L))
    in_fog = 0
    for _ in range(3):
        dark = tpath.bounce_step(s_dark, m_dark, state._replace(L=torch.zeros_like(state.L)),
                                 "independent", 2)
        fog = state.active & (state.medium >= 0)
        assert (dark.smp.dim[fog] > state.smp.dim[fog]).all()
        lit = tpath.bounce_step(s_lit, m_lit, state, "independent", 2)
        for k in ("state", "dim"):
            assert torch.equal(getattr(dark.smp, k)[fog], getattr(lit.smp, k)[fog]), k
        assert torch.equal(dark.medium[fog], lit.medium[fog])
        assert float(dark.L.abs().max()) == 0.0 and int(dark.n_shadow) == int(state.n_shadow)
        in_fog += int(fog.sum())
        state = lit
    assert in_fog > 0


def test_fog_sphere_render_matches_jax():
    """FOG_SPHERE at 16^2 x 4, max depth 8, box filter: the port's path
    render against JAX's render_spp_fused (volumetric) on 4x4 block means
    (the two are the same samples but for rare flipped decisions, whose
    lanes then take independent paths), image means within 2 %, ray counts
    within 1 %."""
    jb, tb = mj.builders(mc.fog_text(0.3, 0.6), res=16)
    js, jm = mj.twins(jb, 4)[:2]
    film, n_rays = jrender.render_spp_fused(
        js, jfilm.new_film(jm.resolution), jnp.arange(256, dtype=jnp.int32), 0, n_spp=4,
        lanes_spp=4, max_depth=jm.max_depth, use_lens=False, res_x=16, sampler_kind=jm.sampler,
        spp=4, filter_kind=jm.filter_kind, env_ids=(), volumetric=True, footprints=False)
    want = np.asarray(jfilm.develop(film, jm.resolution, out_matrix=jm.film_out_matrix,
                                    imaging_ratio=jm.film_imaging_ratio))
    scene, meta = compile_scene(tb, spp_override=4, device="cpu")
    img, stats = trender.render(scene, meta, device="cpu", return_stats=True)
    img = img.numpy()
    assert np.isfinite(img).all() and img.shape == want.shape
    _check(blocks(img, 4), blocks(want, 4), "fog sphere")
    assert abs(img.mean() - want.mean()) < 0.02 * want.mean()
    n_port = stats["closest"] + stats["shadow"]
    assert abs(n_port - float(n_rays)) <= 0.01 * float(n_rays), (n_port, float(n_rays))
