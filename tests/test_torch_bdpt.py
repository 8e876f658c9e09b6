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
  raster position and the honest ray count, on the same two scenes: once
  on JAX's own subpaths, wavelengths and sampler lanes converted to the
  port's tensors (tests/bdpt_cases.py), so that it is tested on the same
  inputs bit for bit, and once on each package's own walks; and K12's
  plain version (`connect_all_plain`, every strategy with one visibility
  dispatch) against the strategies one by one.

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
must be equal on the shared inputs. On the own walks a ray count may
differ only by lanes whose shadow-ray `attempt` flips between the two
walks, each with a vertex that differs from JAX's in some bit: one ulp can
put a vertex into the plane of a light's sampled point (four lights, s = 1,
t = 5, lane 121: the port traces 4 rays, JAX 5).

On the shared inputs every live lane of every strategy must agree to
STRATEGY_RTOL, with no exemption."""
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from bdpt_cases import (FOUR_LIGHTS_PBRT, sampler_from_arrays, vertex_bits_differ,
                        vertices_from_arrays)

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
    connection on RES^2 x 1 lanes of sample 1, from the same streams; and
    the port's connections on JAX's subpaths ("shared"): JAX's vertex
    records, wavelengths and sampler lanes where JAX's connect starts to
    draw, as the port's tensors."""
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
    s_cam, s_light = vertices_from_arrays(j_cam), vertices_from_arrays(j_light)
    s_smp = sampler_from_arrays(jr)
    s_wl = twl._replace(lam=torch.as_tensor(np.array(jwl.lam)),
                        pdf=torch.as_tensor(np.array(jwl.pdf)))
    smp_equal = all(torch.equal(a, b) for a, b in zip(tr[:5], s_smp[:5]))
    samples, tr = tbdpt.sample_endpoints(ts, t_light, t_cam, table, tr, twl, tm.sampler,
                                          tm.spp)
    s_samples, _ = tbdpt.sample_endpoints(ts, s_light, s_cam, table, s_smp, s_wl, tm.sampler,
                                          tm.spp)
    diverged = np.zeros(n_pix, bool)
    for jvs, tvs in ((j_cam, t_cam), (j_light, t_light)):
        for jv, tv in zip(jvs, tvs):
            diverged |= ~_vertex_agrees(jv, tv)
    j_conn, t_conn, s_conn, attempts = {}, {}, {}, {}
    for s, t in table:
        L, raster, jr, n = jbdpt.connect(ja, j_light, j_cam, s, t, jwl, jr, jm.sampler, jm.spp)
        j_conn[(s, t)] = (np.asarray(L), None if raster is None else np.asarray(raster),
                          float(n))
        t_conn[(s, t)] = tbdpt.connect(ts, tm, t_light, t_cam, s, t, twl.lam,
                                       samples.get((s, t)))
        s_conn[(s, t)] = tbdpt.connect(ts, tm, s_light, s_cam, s, t, s_wl.lam,
                                       s_samples.get((s, t)))
        if s > 0:
            attempts[(s, t)] = tuple(
                tbdpt._connection(ts, lv, cv, s, t, smp.get((s, t))).attempt
                for lv, cv, smp in ((t_light, t_cam, samples), (s_light, s_cam, s_samples)))
    _PATHS[name] = dict(j_cam=j_cam, j_light=j_light, t_cam=t_cam, t_light=t_light,
                        s_cam=s_cam, s_light=s_light, smp_equal=smp_equal,
                        counts=(float(jn_cam), float(jn_light), int(tn_cam), int(tn_light)),
                        table=table, samples=samples, lam=twl.lam, j_conn=j_conn,
                        t_conn=t_conn, s_conn=s_conn, attempts=attempts, scenes=(ts, tm),
                        diverged=diverged)
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


def _check_splats(traster, jraster, live, agree):
    """t = 1: the splat raster on the live lanes, its pixel ids on those
    that also agree."""
    np.testing.assert_allclose(traster.numpy()[live], jraster[live], atol=1e-3)
    assert (tbdpt.splat_pixels(traster, (RES, RES)).numpy()[live & agree]
            == (np.clip(jraster[:, 1].astype(np.int32), 0, RES - 1) * RES
                + np.clip(jraster[:, 0].astype(np.int32), 0, RES - 1))[live & agree]).all()


@pytest.mark.parametrize("st", STRATEGIES, ids=[f"s{s}t{t}" for s, t in STRATEGIES])
@pytest.mark.parametrize("name", ["cornell", "four lights"])
def test_connect_matches_jax(name, st):
    """One strategy of the port's connect on JAX's own subpaths, wavelengths
    and sampler lanes (the inputs bit for bit): the ray count exactly, L
    within STRATEGY_RTOL on every live lane (either side nonzero), and the
    splat raster and pixel ids of t = 1. The sampler streams are bit-exact,
    so the port's walks end where JAX's do."""
    p = _paths(name)
    assert p["table"] == STRATEGIES
    assert p["smp_equal"]
    jL, jraster, jn = p["j_conn"][st]
    sL, sraster, sn = p["s_conn"][st]
    assert int(sn) == int(jn), (int(sn), jn)
    live = (np.asarray(jL) != 0).any(1) | (sL.numpy() != 0).any(1)
    wrong = live & ~_lanes_close(sL, jL, STRATEGY_RTOL)
    assert not wrong.any(), (np.nonzero(wrong)[0], int(live.sum()))
    if st[1] == 1:
        live = (np.asarray(jL) != 0).any(1)
        _check_splats(sraster, jraster, live, _lanes_close(sL, jL, WALK_RTOL))


@pytest.mark.parametrize("st", STRATEGIES, ids=[f"s{s}t{t}" for s, t in STRATEGIES])
@pytest.mark.parametrize("name", ["cornell", "four lights"])
def test_connect_own_walks_match_jax(name, st):
    """One strategy on each package's own subpaths: L within WALK_RTOL on
    LANE_FRAC of the lanes, and within STRATEGY_RTOL on every live lane
    whose subpaths agree; the splat raster of t = 1. The ray count may
    differ from JAX's only by lanes whose `attempt` flips between the
    port's own walks and JAX's, and each such lane has a vertex of the
    strategy that differs from JAX's in some bit: the walks rounded apart
    (XLA contracts multiply-adds, R7), not connect."""
    p = _paths(name)
    jL, jraster, jn = p["j_conn"][st]
    tL, traster, tn = p["t_conn"][st]
    ok = _lanes_close(tL, jL, WALK_RTOL)
    assert ok.mean() >= LANE_FRAC, float(ok.mean())
    live = (np.asarray(jL) != 0).any(1) | (tL.numpy() != 0).any(1)
    wrong = live & ~p["diverged"] & ~_lanes_close(tL, jL, STRATEGY_RTOL)
    assert not wrong.any(), (np.nonzero(wrong)[0], int(live.sum()))
    s, t = st
    if s == 0:
        assert int(tn) == int(p["s_conn"][st][2]) == 0
        return
    own, shared = p["attempts"][st]
    assert int(tn) == int(own.sum()) and int(p["s_conn"][st][2]) == int(shared.sum())
    flipped = own != shared
    net = int(own[flipped].sum()) - int(shared[flipped].sum())
    assert int(tn) - int(p["s_conn"][st][2]) == net
    differ = torch.zeros_like(flipped)
    for tvs, svs, n in ((p["t_light"], p["s_light"], s), (p["t_cam"], p["s_cam"], t)):
        for tv, sv in zip(tvs[:n], svs[:n]):
            differ |= vertex_bits_differ(tv, sv)
    assert not (flipped & ~differ).any(), np.nonzero((flipped & ~differ).numpy())[0]
    if t == 1:
        _check_splats(traster, jraster, (np.asarray(jL) != 0).any(1), ok)


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


# ------------------------------------------- K12's layout and warp lists
# What csrc/bdpt.cu reads is checked here without a card: the warps'
# strategy lists of bdpt_connect_weight, and the FieldTable of pointers into
# the walks' own tensors, read back byte by byte the way the kernel reads it.

TABLES = {"cornell": STRATEGIES, "four lights": STRATEGIES,
          "depth 7": tbdpt.strategies(7 + 2, 7 + 1, 7)}


@pytest.mark.parametrize("n_warps", [4, 8, 16])
@pytest.mark.parametrize("name", list(TABLES))
def test_warp_lists_cover_every_strategy_once(name, n_warps):
    """Every strategy in exactly one warp's list (`warp_assignment` at 4, 8
    and 16 warps), each list in table order, the device `order` table the
    kernel's lists' offsets then rows; the table's rows
    (endpoint, ray and splat rows) are those of the (s, t) list; and the
    kernel's schedule (each warp writes its strategies' L, then the t > 1
    rows are summed in table order) rebuilds connect_all_plain's sum, splats
    and pixel ids bit for bit (cornell, four lights: their waves' own L; the
    43-strategy depth-7 table: numpy-seeded values)."""
    table = TABLES[name]
    assert len(table) == (43 if name == "depth 7" else 26)
    st = tbdpt.strategy_table(table, torch.device("cpu"))
    warps = tbdpt.warp_assignment(st.rows, n_warps)
    assert len(warps) == n_warps
    assert sorted(k for w in warps for k in w) == list(range(len(table)))
    assert all(w == sorted(w) for w in warps)
    load = [sum(tbdpt.strategy_cost(*st.rows[k][:2]) for k in w) for w in warps]
    assert max(load) - min(load) <= max(tbdpt.strategy_cost(*r[:2]) for r in st.rows)
    W = tbdpt.CONNECT_WARPS        # the kernel's lists, on the device
    off = st.order[:W + 1].tolist()
    assert st.warps == tbdpt.warp_assignment(st.rows, W)
    assert off == [sum(len(w) for w in st.warps[:i]) for i in range(W + 1)]
    assert st.order[W + 1:].tolist() == [k for w in st.warps for k in w]
    assert [tuple(r[:2]) for r in st.rows] == list(table) and st.tab.tolist() == st.rows
    ends, rays, splats = ([r[i] for r in st.rows if r[i] >= 0] for i in (2, 3, 4))
    assert ends == list(range(len(ends))) and rays == list(range(st.n_ray))
    assert splats == list(range(st.n_t1))
    if name == "depth 7":
        R = 64
        vals = torch.as_tensor(np.random.default_rng(7).normal(size=(len(table), R, 4))
                               .astype(np.float32))
        want_L, want_splat = torch.zeros((R, 4)), [vals[k] for k, (s, t) in enumerate(table)
                                                   if t == 1]
        for k, (s, t) in enumerate(table):
            if t > 1:
                want_L = want_L + vals[k]
        want_splat = torch.cat(want_splat)
    else:
        p = _paths(name)
        per = []
        want_L, want_splat, want_pix, _ = tbdpt.connect_all_plain(
            *p["scenes"], p["t_light"], p["t_cam"], p["lam"], table, p["samples"], per)
        vals, R = torch.stack(per), want_L.shape[0]
    written = torch.full((len(table), R, 4), float("nan"))
    splat_L = torch.full((st.n_t1 * R, 4), float("nan"))
    for w in warps:                         # the warps' writes, in any order
        for k in reversed(w):
            written[k] = vals[k]
            if st.rows[k][4] >= 0:
                splat_L[st.rows[k][4] * R:(st.rows[k][4] + 1) * R] = vals[k]
    L = torch.zeros((R, 4))
    for k in range(len(table)):             # then the sum, in table order
        if st.rows[k][1] > 1:
            L = L + written[k]
    assert torch.equal(L.view(torch.int32), want_L.view(torch.int32))
    assert torch.equal(splat_L.view(torch.int32), want_splat.view(torch.int32))
    if name != "depth 7":
        t1 = [st.rows[k] for k in range(len(table)) if st.rows[k][1] == 1]
        pix = torch.cat([tbdpt.splat_pixels(p["samples"][tuple(r[:2])].raster,
                                            p["scenes"][1].resolution) for r in t1])
        assert torch.equal(pix, want_pix)


def _read_like_kernel(ft):
    """The FieldTable ft read as csrc/bdpt.cu reads it, from the addresses in
    ft.ptrs: vertex slot i, group j at ptrs[i NG + j], staged 32 lanes at a
    time (zeros past lane R - 1); endpoint row i, group j at ptrs[n_slots
    NG + i NEG + j]; per lane the float32 components, the int32 vtype, the
    low word of an int64 id, a bool's byte -> ((n_slots, NF, R), (n_end,
    NSF, R)) float32."""
    import ctypes

    R, n_tiles, ng = ft.R, -(-ft.R // tbdpt.TILE), len(tbdpt.VERTEX_GROUPS)

    def lanes(ptr, dtype, width, tiled):
        gb = width * torch.tensor([], dtype=dtype).element_size()
        n = R * gb
        raw = torch.frombuffer(bytearray((ctypes.c_uint8 * n).from_address(ptr)),
                               dtype=torch.uint8)
        if tiled:                            # the staged tile, zero past R
            raw = torch.cat([raw, torch.zeros(n_tiles * tbdpt.TILE * gb - n, dtype=torch.uint8)])
        rows = raw.reshape(-1, gb)
        if dtype == torch.float32:
            v = rows.view(torch.float32)
        elif dtype == torch.int32:
            v = rows.view(torch.int32).float()
        elif dtype == torch.int64:
            v = rows.view(torch.int32)[:, :1].float()
        else:
            v = (rows[:, :1] != 0).float()
        return v[:R].T

    ptrs = ft.ptrs.tolist()
    verts = torch.stack([torch.cat([lanes(ptrs[i * ng + j], dt, w, True)
                                    for j, (_, dt, w) in enumerate(tbdpt.VERTEX_GROUPS)])
                         for i in range(len(ft.vertex))])
    base = len(ft.vertex) * ng
    ends = [torch.cat([lanes(ptrs[base + i * tbdpt.NEG + j], dt, w, False)
                       for j, (_, dt, w) in enumerate(groups)]) for i, (groups, _) in
            enumerate(ft.ends)]
    ends = [torch.cat([e, torch.zeros((tbdpt.NSF - e.shape[0], R))]) for e in ends]
    assert len(ptrs) == base + len(ft.ends) * tbdpt.NEG
    return verts, torch.stack(ends)


def _cut(p, R):
    """The wave of _paths' record cut to its first R lanes (contiguous
    slices: each field's own storage, from its start)."""
    def cut(x):
        if torch.is_tensor(x):
            return x[:R]
        return type(x)(*map(cut, x))

    return ([cut(v) for v in p["t_cam"]], [cut(v) for v in p["t_light"]],
            {st: cut(x) for st, x in p["samples"].items()})


@pytest.mark.parametrize("R", [RES * RES, 200])
@pytest.mark.parametrize("name", ["cornell", "four lights"])
def test_field_table_reads_back_the_packed_records(name, R):
    """K12's FieldTable of a wave (the walks' own tensors, no copy but the
    endpoints' strided raster), read from its pointers the way the kernel
    reads it, equals the yardsticks' packed copy (pack_vertices,
    pack_endpoints) bit for bit; at RES^2 lanes and at 200, which is no
    multiple of the 32-lane tile."""
    p = _paths(name)
    cam, light, samples = _cut(p, R)
    samples = tbdpt.contiguous_samples(samples)
    ft = tbdpt.field_table(cam, light, p["table"], samples)
    assert (ft.R, ft.n_cam, len(ft.vertex)) == (R, len(cam), len(cam) + len(light))
    assert len(ft.ends) == sum(1 for st in p["table"] if st in samples)
    for v, fields in zip(cam + light, ft.vertex):   # in place: the walks' own storage
        assert fields[1].data_ptr() == v.p.data_ptr() and fields[11] is v.bx.refl
    verts, ends = _read_like_kernel(ft)
    want_v = tbdpt.pack_vertices(cam, light)
    want_e = tbdpt.pack_endpoints(p["table"], samples, R, "cpu")
    assert torch.equal(verts.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(ends.view(torch.int32), want_e.view(torch.int32))


def test_connect_kernel_wrappers_raise():
    """K12's wrappers refuse what the kernels cannot read in place: a strided
    field, a field of another dtype, and CPU tensors (on the card they
    launch or raise; the CPU runs the plain version in li_bdpt). A wave of
    any depth is taken: one past the staged slots (STAGED_SLOTS) builds its
    table too."""
    p = _paths("cornell")
    cam, light, samples = p["t_cam"], p["t_light"], tbdpt.contiguous_samples(p["samples"])
    table = p["table"]
    ft = tbdpt.field_table(cam, light, table, samples)
    strided = cam[:1] + [cam[1]._replace(p=cam[1].p.T.contiguous().T)] + cam[2:]
    with pytest.raises(ValueError, match="slot 1 p"):
        tbdpt.field_table(strided, light, table, samples)
    wrong = cam[:2] + [cam[2]._replace(vtype=cam[2].vtype.long())] + cam[3:]
    with pytest.raises(ValueError, match="slot 2 vtype"):
        tbdpt.field_table(wrong, light, table, samples)
    with pytest.raises(ValueError, match="raster"):
        tbdpt.field_table(cam, light, table, p["samples"])
    deep = tbdpt.field_table(cam * 6, light, table, samples)
    assert len(deep.vertex) == 6 * len(cam) + len(light) > tbdpt.STAGED_SLOTS
    assert deep.ptrs.shape == ((len(deep.vertex) * len(tbdpt.VERTEX_GROUPS)
                                + len(deep.ends) * tbdpt.NEG),)
    st = tbdpt.strategy_table(table, torch.device("cpu"))
    ts, tm = p["scenes"]
    R = ft.R
    with pytest.raises(ValueError, match="CUDA"):
        tbdpt.connect_rays_cuda(ts, ft, st)
    with pytest.raises(ValueError, match="CUDA"):
        tbdpt.connect_weight_cuda(ts, ft, st, p["lam"], torch.zeros(st.n_ray * R, dtype=bool),
                                  tm.resolution)
