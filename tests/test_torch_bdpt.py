"""BDPT of the port (integrators/bdpt.py and what it reads of cameras/ and
lights/) against pbrt_tpu on the same numpy-seeded inputs, on the CPU:

- the camera's importance `we`, its density `pdf_we` and lens sampling
  `sample_wi` (with and without a lens);
- `sample_le` and `pdf_le` on cornell, caustic-glass and a scene with
  every light type the builder emits (triangle, sphere and disk area
  lights, distant, spot and uniform infinite);
- the camera and light subpaths' vertex records, field by field, on
  cornell and on that scene, from the same sampler streams;
- `connect` for every (s, t) strategy at max depth 5, with L, the splat
  raster position and the honest ray count, on the same two scenes; and
  K12's plain version (`connect_all_plain`, every strategy with one
  visibility dispatch) against the strategies one by one.

Tolerances, with their reasons: the same float32 formulas on both sides,
but XLA fuses and reorders a few (3-term dots, the inverse camera
matrices, which the port inverts once in float64 and JAX per call in
float32), so the camera and light functions agree to 2e-5 relative with
an absolute floor of 1e-6 of the field's scale, raster positions to 1e-3
pixels. The walks amplify those ulps at every bounce off a curved surface
(~10x a bounce: sphere normals differ by 5e-6 after one), so vertex
records and strategy contributions are compared per lane to 1e-3
relative, and at most 2 % of lanes may differ (measured: at most 3 of 256
lanes, on the 5th and 6th camera vertices of cornell). Besides, every
strategy must agree to STRATEGY_RTOL on each of its live lanes (either side
nonzero) whose two subpaths agree, so a strategy that is wrong on the few
lanes where it is live fails however rare it is; a lane whose walk turned
apart (9 of cornell's 256, 1 of the four-light scene's) is left to the
subpath test. 1e-2, not 1e-3: a sampled endpoint that differs by an ulp
moves a contribution by up to 6e-3 (measured: four lights, s = 6, t = 1, a
camera pdf of 7214 at the raster's ulp). A vertex's uv is not compared:
only textures read it (a later slice), and the JAX package leaves a disk
hit's uv at that of the losing triangle or sphere candidate. Ray counts
must be equal."""
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from bdpt_cases import FOUR_LIGHTS_PBRT

from pbrt_tpu.cameras import perspective as jcam
from pbrt_tpu.integrators import bdpt as jbdpt, render as jrender
from pbrt_tpu.lights import lights as jl
from pbrt_tpu.scene import builder as jbd, lexer as jlx, testscenes as jts
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch.cameras import perspective as tcam
from pbrt_tpu_torch.integrators import bdpt as tbdpt, render as trender
from pbrt_tpu_torch.lights import lights as tl
from pbrt_tpu_torch.scene import builder as tbd, lexer as tlx
from pbrt_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(2)
RES, SPP = 16, 2
RTOL = 2e-5
WALK_RTOL = 1e-3
LANE_FRAC = 0.98
STRATEGY_RTOL = 1e-2
SCENES_DIR = pathlib.Path(__file__).parent.parent / "scenes"
V_FIELDS = ("vtype", "p", "ng", "ns", "beta", "pdf_fwd", "pdf_rev", "delta", "light",
            "mat", "wo")
STRATEGIES = tbdpt.strategies(5 + 2, 5 + 1, 5)


def _text(name):
    if name == "cornell":
        return jts.CORNELL_PBRT
    if name == "caustic-glass":
        return (SCENES_DIR / "caustic-glass.pbrt").read_text()
    return FOUR_LIGHTS_PBRT


_SCENES = {}


def _scenes(name):
    """(JAX SceneArrays, JAX meta, port Scene, port meta) of scene `name`
    at RES^2 x SPP, box filter, BDPT."""
    if name not in _SCENES:
        jb, tb = jbd.SceneBuilder(), tbd.SceneBuilder()
        jb.parse_tokens(jlx.tokenize(_text(name)))
        tb.parse_tokens(tlx.tokenize(_text(name)))
        for b in (jb, tb):
            b.film["xresolution"] = b.film["yresolution"] = RES
            b.filter = {"type": "box"}
        ja, jm = j_compile(jb, spp_override=SPP, integrator_override="bdpt")
        ts, tm = compile_scene(tb, spp_override=SPP, device="cpu", integrator_override="bdpt")
        _SCENES[name] = (ja, jm, ts, tm)
    return _SCENES[name]


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, name, rtol=RTOL, mask=None):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    if mask is not None:
        got, want = got[mask], want[mask]
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale, err_msg=name)


def _lanes_close(got, want, rtol=RTOL):
    """(R,) bool: lane agrees in every component (rtol, floor 1e-6 of the
    field's scale)."""
    got = _np(got).astype(np.float64).reshape(got.shape[0], -1)
    want = _np(want).astype(np.float64).reshape(want.shape[0], -1)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    return (np.abs(got - want) <= 1e-6 * scale + rtol * np.abs(want)).all(1)


# ------------------------------------------------------------ camera


@pytest.mark.parametrize("name", ["cornell", "caustic-glass", "four lights"])
def test_we_pdf_we_sample_wi_match_jax(name):
    ja, jm, ts, tm = _scenes(name)
    g = np.random.default_rng(5)
    n = 3000
    p_film = g.uniform(-2.0, RES + 2.0, (n, 2)).astype(np.float32)
    u = g.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    rays = tcam.generate_rays(ts, torch.as_tensor(p_film), torch.as_tensor(u))
    o, d = rays.o.numpy(), rays.d.numpy()
    d[::5] = g.normal(size=d[::5].shape)                 # off-frustum and backwards
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jw, jr, jv = jcam.we(ja, jnp.asarray(o), jnp.asarray(d))
    tw, tr, tv = tcam.we(ts, torch.as_tensor(o), torch.as_tensor(d))
    jv = np.asarray(jv)
    # a lane on the raster's edge may fall either side (the inverse matrices)
    edge = (np.abs(np.asarray(jr)) < 1e-3).any(1) | (np.abs(np.asarray(jr) - RES) < 1e-3).any(1)
    np.testing.assert_array_equal(tv.numpy()[~edge], jv[~edge])
    assert jv.sum() > n // 2 and (~jv).sum() > n // 10
    both = jv & tv.numpy()
    _close(tw, jw, "we", mask=both)
    np.testing.assert_allclose(tr.numpy()[both], np.asarray(jr)[both], atol=1e-3)
    for got, want, f in zip(tcam.pdf_we(ts, torch.as_tensor(o), torch.as_tensor(d)),
                            jcam.pdf_we(ja, jnp.asarray(o), jnp.asarray(d)),
                            ("pdf_pos", "pdf_dir")):
        _close(got, want, f, mask=~edge)

    # reference points along the camera rays (seen by the lens unless
    # behind it) and scattered off them
    dist = g.uniform(0.1, 1.5, (n, 1)) * float(ja.scene_radius)
    p_ref = (rays.o.numpy() + rays.d.numpy() * dist
             + g.normal(size=(n, 3)) * 0.1 * float(ja.scene_radius)).astype(np.float32)
    js = jcam.sample_wi(ja, jnp.asarray(p_ref), jnp.asarray(u))
    tsw = tcam.sample_wi(ts, torch.as_tensor(p_ref), torch.as_tensor(u))
    jvalid = np.asarray(js[5])
    edge = (np.abs(np.asarray(js[3])) < 1e-3).any(1) | (np.abs(np.asarray(js[3]) - RES)
                                                         < 1e-3).any(1)
    np.testing.assert_array_equal(tsw[5].numpy()[~edge], jvalid[~edge])
    assert jvalid.sum() > n // 20
    ok = jvalid & tsw[5].numpy()
    for got, want, f in zip(tsw, js, ("wi", "we", "pdf", "raster", "p_lens")):
        if f == "raster":
            np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], atol=1e-3)
        else:
            _close(got, want, f, mask=ok)


# ------------------------------------------------------------ lights


@pytest.mark.parametrize("name", ["cornell", "caustic-glass", "four lights"])
def test_sample_le_pdf_le_match_jax(name):
    ja, jm, ts, tm = _scenes(name)
    g = np.random.default_rng(6)
    n_l = ts.lt_type.shape[0]
    n = 400 * n_l
    idx = np.repeat(np.arange(n_l, dtype=np.int32), n // n_l)
    idx[::13] = -1
    u_pos = g.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    u_dir = g.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    lam = g.uniform(360.0, 830.0, (n, 4)).astype(np.float32)
    want = jl.sample_le(ja, jnp.asarray(idx), jnp.asarray(u_pos), jnp.asarray(u_dir),
                        jnp.asarray(lam))
    got = tl.sample_le(ts, torch.as_tensor(idx).long(), torch.as_tensor(u_pos),
                       torch.as_tensor(u_dir), torch.as_tensor(lam))
    valid = np.asarray(want[6])
    np.testing.assert_array_equal(got[6].numpy(), valid)
    assert valid.sum() > n // 2
    for g_, w_, f in zip(got[:6], want[:6], ("Le", "p", "ng", "w", "pdf_pos", "pdf_dir")):
        _close(g_, w_, f"sample_le {f}", mask=valid)
    # pdf_le of the emitted rays, and of random directions (back sides,
    # outside a spot's cone)
    w_rand = g.normal(size=(n, 3)).astype(np.float32)
    w_rand /= np.linalg.norm(w_rand, axis=1, keepdims=True)
    for w in (np.asarray(want[3]), w_rand):
        jp = jl.pdf_le(ja, jnp.asarray(idx), want[2], jnp.asarray(w))
        tp = tl.pdf_le(ts, torch.as_tensor(idx).long(), torch.as_tensor(np.array(want[2])),
                       torch.as_tensor(w))
        for g_, w_, f in zip(tp, jp, ("pdf_pos", "pdf_dir")):
            _close(g_, w_, f"pdf_le {f}", mask=valid)


# ------------------------------------------------------------ subpaths


_PATHS = {}


def _paths(name):
    """Both packages' camera and light subpaths and every strategy's
    connection on RES^2 x 1 lanes of sample 1, from the same streams."""
    if name in _PATHS:
        return _PATHS[name]
    ja, jm, ts, tm = _scenes(name)
    n_pix = RES * RES
    jp_film, _, jwl, jr = jrender._camera_sample(
        ja, jnp.arange(n_pix, dtype=jnp.int32), 1, res_x=RES, sampler_kind=jm.sampler,
        spp=jm.spp, filter_kind=jm.filter_kind)
    pix = torch.arange(n_pix)
    tp_film, twl, tr, _ = trender.film_samples(ts, tm, pix, torch.ones_like(pix))
    _close(tp_film, jp_film, "p_film")
    _close(twl.lam, jwl.lam, "lambda")
    j_cam, jr, jn_cam = jbdpt.camera_path(ja, jp_film, jr, jwl, jm.max_depth, jm.sampler, jm.spp)
    j_light, jr, jn_light = jbdpt.light_path(ja, jr, jwl, jm.max_depth, jm.sampler, jm.spp)
    t_cam, tr, tn_cam = tbdpt.camera_path(ts, tm, tp_film, tr, twl, tm.sampler, tm.spp)
    t_light, tr, tn_light = tbdpt.light_path(ts, tm, tr, twl, tm.sampler, tm.spp)
    table = tbdpt.strategies(len(t_cam), len(t_light), tm.max_depth)
    samples, tr = tbdpt.sample_endpoints(ts, t_light, t_cam, table, tr, twl, tm.sampler,
                                          tm.spp)
    diverged = np.zeros(n_pix, bool)
    for jvs, tvs in ((j_cam, t_cam), (j_light, t_light)):
        for jv, tv in zip(jvs, tvs):
            diverged |= ~_vertex_agrees(jv, tv)
    j_conn, t_conn = {}, {}
    for s, t in table:
        L, raster, jr, n = jbdpt.connect(ja, j_light, j_cam, s, t, jwl, jr, jm.sampler, jm.spp)
        j_conn[(s, t)] = (np.asarray(L), None if raster is None else np.asarray(raster),
                          float(n))
        t_conn[(s, t)] = tbdpt.connect(ts, tm, t_light, t_cam, s, t, twl.lam,
                                       samples.get((s, t)))
    _PATHS[name] = dict(j_cam=j_cam, j_light=j_light, t_cam=t_cam, t_light=t_light,
                        counts=(float(jn_cam), float(jn_light), int(tn_cam), int(tn_light)),
                        table=table, samples=samples, lam=twl.lam, j_conn=j_conn,
                        t_conn=t_conn, scenes=(ts, tm), diverged=diverged)
    return _PATHS[name]


def _vertex_agrees(jv, tv):
    """(R,) bool: the lane's vertex record agrees field by field (type,
    flags and ids equal; the rest within WALK_RTOL where the vertex
    exists)."""
    exists = np.asarray(jv.vtype) != 0
    lanes = _np(tv.vtype) == np.asarray(jv.vtype)
    for f in V_FIELDS[1:]:
        got, want = getattr(tv, f), getattr(jv, f)
        if f in ("delta", "light", "mat"):
            lanes &= _np(got).astype(np.int64) == np.asarray(want).astype(np.int64)
        else:
            lanes &= _lanes_close(got, want, WALK_RTOL) | ~exists
    return lanes


def _compare_vertices(jvs, tvs, what):
    assert len(jvs) == len(tvs), what
    for i, (jv, tv) in enumerate(zip(jvs, tvs)):
        np.testing.assert_array_equal(tv.vtype.numpy(), np.asarray(jv.vtype), f"{what} {i}")
        lanes = _vertex_agrees(jv, tv)
        assert lanes.mean() >= LANE_FRAC, (what, i, float(lanes.mean()))


@pytest.mark.parametrize("name", ["cornell", "four lights"])
def test_subpaths_match_jax(name):
    """Both subpaths' vertex records field by field, and the walks' honest
    ray counts (JAX counts in float32, exact below 2^24)."""
    p = _paths(name)
    _compare_vertices(p["j_cam"], p["t_cam"], "camera vertex")
    _compare_vertices(p["j_light"], p["t_light"], "light vertex")
    jc, jlc, tc, tlc = p["counts"]
    assert (tc, tlc) == (int(jc), int(jlc))
    assert len(p["t_cam"]) == 5 + 2 and len(p["t_light"]) == 5 + 1


@pytest.mark.parametrize("st", STRATEGIES, ids=[f"s{s}t{t}" for s, t in STRATEGIES])
@pytest.mark.parametrize("name", ["cornell", "four lights"])
def test_connect_matches_jax(name, st):
    """One strategy: L per lane, the splat raster of t = 1, the ray count.
    L within WALK_RTOL on LANE_FRAC of the lanes, and within STRATEGY_RTOL
    on every live lane whose subpaths agree."""
    p = _paths(name)
    assert p["table"] == STRATEGIES
    jL, jraster, jn = p["j_conn"][st]
    tL, traster, tn = p["t_conn"][st]
    assert int(tn) == int(jn), (int(tn), jn)
    ok = _lanes_close(tL, jL, WALK_RTOL)
    assert ok.mean() >= LANE_FRAC, float(ok.mean())
    live = (np.asarray(jL) != 0).any(1) | (tL.numpy() != 0).any(1)
    wrong = live & ~p["diverged"] & ~_lanes_close(tL, jL, STRATEGY_RTOL)
    assert not wrong.any(), (np.nonzero(wrong)[0], int(live.sum()))
    if st[1] == 1:
        live = (np.asarray(jL) != 0).any(1)
        np.testing.assert_allclose(traster.numpy()[live], jraster[live], atol=1e-3)
        assert (tbdpt.splat_pixels(traster, (RES, RES)).numpy()[live & ok]
                == (np.clip(jraster[:, 1].astype(np.int32), 0, RES - 1) * RES
                    + np.clip(jraster[:, 0].astype(np.int32), 0, RES - 1))[live & ok]).all()


@pytest.mark.parametrize("name", ["cornell", "four lights"])
def test_connect_all_plain_matches_strategies(name):
    """K12's plain version (one occluded dispatch for every strategy) gives
    each strategy's L of `connect`, their t > 1 sum, the t = 1 splats with
    their pixel ids, and the summed ray count."""
    p = _paths(name)
    ts, tm = p["scenes"]
    per = []
    L, splat_L, splat_pix, n = tbdpt.connect_all_plain(ts, tm, p["t_light"], p["t_cam"],
                                                       p["lam"], p["table"], p["samples"], per)
    R = L.shape[0]
    t1 = [st for st in p["table"] if st[1] == 1]
    assert splat_L.shape == (len(t1) * R, 4) and splat_pix.shape == (len(t1) * R,)
    want_sum = torch.zeros((R, 4))
    for st, got in zip(p["table"], per):
        want = p["t_conn"][st][0]
        assert torch.equal(got, want), st
        if st[1] > 1:
            want_sum = want_sum + want
    assert torch.equal(L, want_sum)
    for k, st in enumerate(t1):
        assert torch.equal(splat_L[k * R:(k + 1) * R], p["t_conn"][st][0])
        assert torch.equal(splat_pix[k * R:(k + 1) * R],
                           tbdpt.splat_pixels(p["t_conn"][st][1], tm.resolution))
    assert int(n) == sum(int(p["t_conn"][st][2]) for st in p["table"])
