"""Participating media through the port's BDPT on the CPU, held against the
JAX package on volumetric-caustic (tests/medium_cases.py) at 16^2, max depth
3, box filter:

- both subpaths from the same sampler streams: the walks' segments through
  the fog (distance draws at every leg, VT_MEDIUM vertices with the HG
  continuation), their vertex records field by field, the medium ids too;
- every (s, t) strategy of the port's plain K12 (`connect_all_plain`, one
  transmittance hop loop for all the strategies' segments) on JAX's own
  subpaths, wavelengths and sampler lanes converted to the port's tensors
  (the inputs bit for bit) against JAX's `connect` (compute_transmittance
  on every segment): the ray counts exactly, L within STRATEGY_RTOL on every
  live lane;
- the BDPT render through render() against JAX's live estimate.

Tolerances: as tests/test_torch_bdpt.py's, for the same reasons (XLA
contracts and reorders a few float32 operations, which the walks amplify),
and the distance draws' log1p and the transmittance's exp, which XLA and
torch round apart by an ulp: a walk whose sampled distance lands within an
ulp of a hit scatters in one package and not in the other. So the vertex
records must agree on LANE_FRAC of the lanes, not all; the strategies are
compared on JAX's own subpaths, where every live lane must agree. The
renders are the same samples but for the lanes whose walks turned apart,
and are held to tests/test_parity.py's criterion on 4x4 block means, image
means within 3 %, ray counts within 1 %."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pbrt_tpu.integrators import bdpt as jbdpt, render as jrender
from pbrt_tpu_torch.integrators import bdpt as tbdpt, render as trender
from pbrt_tpu_torch.scene.compile import compile_scene
from bdpt_cases import sampler_from_arrays, vertices_from_arrays
from layered_cases import blocks
import medium_cases as mc
import medium_jax as mj
from test_torch_bdpt import LANE_FRAC, STRATEGY_RTOL, WALK_RTOL, _lanes_close
from test_torch_render import _check
from test_torch_render_bdpt import _jax_bdpt

torch.set_num_threads(2)
RES, SPP, DEPTH = 16, 2, 3
STRATEGIES = tbdpt.strategies(DEPTH + 2, DEPTH + 1, DEPTH)
V_FIELDS = ("p", "ng", "ns", "beta", "pdf_fwd", "pdf_rev", "wo")
V_IDS = ("delta", "light", "mat", "med", "med_in", "med_out")

_PATHS = {}


def _paths():
    """JAX's and the port's subpaths of the scene's RES^2 lanes of sample 1,
    JAX's connect of every strategy, and the port's plain K12 on JAX's
    subpaths."""
    if _PATHS:
        return _PATHS
    jb, _ = mj.builders(path=mc.CAUSTIC, res=RES, integrator="bdpt", max_depth=DEPTH)
    ja, jm, ts, tm = mj.twins(jb, SPP)
    assert tm.volumetric and ts.med_g.shape[0] == 1
    n_pix = RES * RES
    jp_film, _, jwl, jr = jrender._camera_sample(
        ja, jnp.arange(n_pix, dtype=jnp.int32), 1, res_x=RES, sampler_kind=jm.sampler,
        spp=jm.spp, filter_kind=jm.filter_kind)
    pix = torch.arange(n_pix)
    tp_film, twl, tr, _ = trender.film_samples(ts, tm, pix, torch.ones_like(pix))
    j_cam, jr, jn_cam = jbdpt.camera_path(ja, jp_film, jr, jwl, jm.max_depth, jm.sampler, jm.spp)
    j_light, jr, jn_light = jbdpt.light_path(ja, jr, jwl, jm.max_depth, jm.sampler, jm.spp)
    t_cam, tr, tn_cam = tbdpt.camera_path(ts, tm, tp_film, tr, twl, tm.sampler, tm.spp)
    t_light, _, tn_light = tbdpt.light_path(ts, tm, tr, twl, tm.sampler, tm.spp)
    table = tbdpt.strategies(len(t_cam), len(t_light), tm.max_depth)
    s_cam, s_light = vertices_from_arrays(j_cam), vertices_from_arrays(j_light)
    s_wl = twl._replace(lam=torch.as_tensor(np.array(jwl.lam)),
                        pdf=torch.as_tensor(np.array(jwl.pdf)))
    samples, _ = tbdpt.sample_endpoints(ts, s_light, s_cam, table, sampler_from_arrays(jr),
                                        s_wl, tm.sampler, tm.spp)
    j_conn = {}
    for s, t in table:
        L, raster, jr, n = jbdpt.connect(ja, j_light, j_cam, s, t, jwl, jr, jm.sampler, jm.spp)
        j_conn[(s, t)] = (np.asarray(L), float(n))
    per = []
    L, splat_L, splat_pix, n = tbdpt.connect_all_plain(ts, tm, s_light, s_cam, s_wl.lam, table,
                                                       samples, per)
    _PATHS.update(j_cam=j_cam, j_light=j_light, t_cam=t_cam, t_light=t_light, table=table,
                  j_conn=j_conn, per=dict(zip(table, per)), n=int(n),
                  counts=(float(jn_cam), float(jn_light), int(tn_cam), int(tn_light)),
                  attempts={st: int(tbdpt._connection(ts, s_light, s_cam, *st,
                                                      samples.get(st)).attempt.sum())
                            for st in table if st[0] > 0})
    return _PATHS


def _agree(jv, tv):
    """(R,) bool: the lane's vertex agrees (type and ids equal, the rest
    within WALK_RTOL where it exists)."""
    exists = np.asarray(jv.vtype) != 0
    lanes = tv.vtype.numpy() == np.asarray(jv.vtype)
    for f in V_IDS:
        lanes &= getattr(tv, f).numpy().astype(np.int64) == np.asarray(getattr(jv, f)).astype(
            np.int64)
    for f in V_FIELDS:
        lanes &= _lanes_close(getattr(tv, f), getattr(jv, f), WALK_RTOL) | ~exists
    return lanes


@pytest.mark.parametrize("which", ["camera", "light"])
def test_volumetric_subpaths_match_jax(which):
    """Each slot's vertex records agree on LANE_FRAC of the lanes; medium
    vertices occur in both walks; the walks' ray counts within 1 %."""
    p = _paths()
    jvs, tvs = (p["j_cam"], p["t_cam"]) if which == "camera" else (p["j_light"], p["t_light"])
    assert len(jvs) == len(tvs)
    n_medium = 0
    for i, (jv, tv) in enumerate(zip(jvs, tvs)):
        lanes = _agree(jv, tv)
        assert lanes.mean() >= LANE_FRAC, (which, i, float(lanes.mean()))
        n_medium += int((tv.vtype == tbdpt.VT_MEDIUM).sum())
    assert n_medium > 0
    jc, jlc, tc, tlc = p["counts"]
    j, t = (jc, tc) if which == "camera" else (jlc, tlc)
    assert abs(t - j) <= 0.01 * j, (t, j)


@pytest.mark.parametrize("st", STRATEGIES, ids=[f"s{s}t{t}" for s, t in STRATEGIES])
def test_connect_with_transmittance_matches_jax(st):
    p = _paths()
    assert p["table"] == STRATEGIES
    jL, jn = p["j_conn"][st]
    sL = p["per"][st]
    if st[0] > 0:
        assert p["attempts"][st] == int(jn), (p["attempts"][st], jn)
    live = (jL != 0).any(1) | (sL.numpy() != 0).any(1)
    wrong = live & ~_lanes_close(sL, jL, STRATEGY_RTOL)
    assert not wrong.any(), (np.nonzero(wrong)[0], int(live.sum()))


def test_connect_all_plain_ray_count():
    p = _paths()
    assert p["n"] == sum(p["attempts"].values()) > 0


def test_volumetric_caustic_bdpt_render_matches_jax():
    jb, tb = mj.builders(path=mc.CAUSTIC, res=RES, integrator="bdpt", max_depth=DEPTH)
    want, n_jax = _jax_bdpt(jb, SPP)
    scene, meta = compile_scene(tb, spp_override=SPP, device="cpu", integrator_override="bdpt")
    img, stats = trender.render(scene, meta, device="cpu", return_stats=True)
    img = img.numpy()
    assert np.isfinite(img).all() and img.shape == want.shape
    _check(blocks(img, 4), blocks(want, 4), "volumetric-caustic bdpt")
    assert abs(img.mean() - want.mean()) < 0.03 * want.mean()
    n_port = stats["closest"] + stats["shadow"]
    assert abs(n_port - n_jax) <= 0.01 * n_jax, (n_port, n_jax)
