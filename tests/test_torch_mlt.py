"""MLT of the port (integrators/mlt.py, the sampler kind "mlt",
distribution/distributions.py) against pbrt_tpu on the same numpy-seeded
inputs, on the CPU:

- the "mlt" sampler kind, bit-exact: values from the primary samples while
  dim < D, PCG32 beyond, the stream advancing on every draw, masked draws
  keeping dim and state (lanes overflow D here);
- `alias_sample`, bit-exact;
- `mutate_from_uniforms` against `mutate(x, key)` fed the uniforms that
  `jax.random.split(key, 3)` gives inside it: large-step flags equal,
  values within 1e-6 around [0, 1) (torch.log and XLA's log round apart by
  an ulp); `chain_uniforms` and the plain `mutate` against JAX's
  distribution check (tests/test_mlt.py::test_mutate_distributions);
- `eval_x` on cornell (dense) and cornell-mesh levels 3 (BVH) at max depth
  3, and `eval_x_bdpt` on cornell at max depth 2 (two t = 1 strategies, so
  the splat order is tested), on R = 512 numpy primary samples: pixel ids
  exact; rgb and y per lane within RTOL relative (atol ATOL) on LANE_FRAC
  of the lanes: the same float32 formulas, but XLA fuses and reorders a
  few, and a walk amplifies an ulp at every curved bounce
  (tests/test_torch_bdpt.py measures at most 3 of 256 lanes apart);
- `accept_and_splat` for C = 1 and C = 4 against `_accept_and_splat` and
  `_accept_and_splat_multi` with the accept uniforms passed in: chain
  state and acceptance exact, splat and heat within 1e-5 relative (sums
  in another order).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from mlt_cases import SPLAT_RTOL, accept_inputs, circular_ulps, primary_samples

from pbrt_tpu.distribution import distributions as jdist
from pbrt_tpu.integrators import mlt as jmlt
from pbrt_tpu.sampling import samplers as jsamplers
from pbrt_tpu.scene import builder as jbd, lexer as jlx, testscenes as jts
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch.distribution import distributions as tdist
from pbrt_tpu_torch.integrators import mlt
from pbrt_tpu_torch.sampling import samplers as tsamplers
from pbrt_tpu_torch.scene import builder as tbd, lexer as tlx
from pbrt_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(2)
R_EVAL, RES = 512, 16
RTOL, ATOL, LANE_FRAC = 1e-3, 1e-6, 0.98


def _u64(x):
    """JAX U64 limbs -> int64 numpy with the same bits."""
    hi = np.asarray(x.hi).astype(np.uint64)
    lo = np.asarray(x.lo).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


def test_mlt_sampler_bit_exact():
    """12 draws (1d and 2d, masked and not) from dim 3 of D = 16: many lanes
    run past D onto their PCG32 stream, some masked lanes stay below it."""
    R, D = 256, 16
    x = primary_samples(R, D, 3)
    masks = np.random.default_rng(5).random((12, R)) < 0.7
    sj = jsamplers.from_primary_samples(jnp.asarray(x))
    sj = sj._replace(dim=jnp.full((R,), 3, jnp.uint32))
    st = tsamplers.from_primary_samples(torch.from_numpy(x))
    st = st._replace(dim=torch.full((R,), 3))
    for k in range(12):
        mj = None if k % 3 == 0 else jnp.asarray(masks[k])
        mt = None if k % 3 == 0 else torch.from_numpy(masks[k])
        fj, ft = (jsamplers.get_2d, tsamplers.get_2d) if k % 2 else (jsamplers.get_1d,
                                                                    tsamplers.get_1d)
        sj, uj = fj(sj, mj, "mlt", 0)
        st, ut = ft(st, mt, "mlt", 0)
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
        np.testing.assert_array_equal(st.state.numpy(), _u64(sj.state))
        np.testing.assert_array_equal(st.dim.numpy(), np.asarray(sj.dim).astype(np.int64))
    dim = st.dim.numpy()
    assert (dim > D + 2).any() and (dim < D).any(), dim


def test_alias_sample_bit_exact():
    rng = np.random.default_rng(2)
    w = rng.gamma(0.3, 1.0, 1000)
    w[::7] = 0.0
    q, alias, pdf = tdist.alias_table_build(w)
    for a, b in zip((q, alias, pdf), jdist.alias_table_build(w)):
        np.testing.assert_array_equal(a, b)
    u = rng.random(8192).astype(np.float32)
    u[:3] = [0.0, np.float32(1 - 1e-7), 0.5]
    idx_j, u2_j = jdist.alias_sample(jnp.asarray(q), jnp.asarray(alias), jnp.asarray(u))
    idx_t, u2_t = tdist.alias_sample(torch.from_numpy(q), torch.from_numpy(alias),
                                     torch.from_numpy(u))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(u2_t.numpy(), np.asarray(u2_j))


def test_mutate_matches_jax():
    R, D = 2048, 24
    x = primary_samples(R, D, 1)
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    u_large = np.asarray(jax.random.uniform(k1, (R,)))
    fresh = np.asarray(jax.random.uniform(k2, (R, D)))
    u = np.asarray(jax.random.uniform(k3, (R, D)))
    want = np.asarray(jmlt.mutate(jnp.asarray(x), key))
    got = mlt.mutate_from_uniforms(*map(torch.from_numpy, (x, u_large, fresh, u))).numpy()
    large = u_large < mlt.P_LARGE
    assert 0 < large.sum() < R
    np.testing.assert_array_equal(got[large], want[large])
    assert np.array_equal(got[large], np.clip(fresh[large], 0, np.float32(1 - 1e-7)))
    d = circular_ulps(got, want) * 2.0 ** -24
    assert float(d.max()) <= 1e-6, float(d.max())
    assert ((got >= 0) & (got < 1)).all()


def test_chain_uniforms_and_mutate_distribution():
    """JAX's test_mutate_distributions on the port's streams: uniforms in
    [0, 1); about P_LARGE of the chains take a large step; small steps stay
    near x. Each (pass, purpose) has its own stream."""
    R, D = 4096, 8
    u_large, fresh, u = mlt.chain_uniforms(0, 0, R, D)
    for t in (u_large, fresh, u, mlt.accept_uniforms(0, 0, R)):
        assert ((t >= 0) & (t < 1)).all()
    assert not torch.equal(u_large, mlt.chain_uniforms(0, 1, R, D)[0])
    assert not torch.equal(u_large, mlt.accept_uniforms(0, 0, R))
    x = torch.full((R, D), 0.5)
    out = mlt.mutate(x, 0, 0).numpy()
    np.testing.assert_array_equal(out, mlt.mutate_from_uniforms(x, u_large, fresh, u).numpy())
    assert ((out >= 0) & (out < 1)).all()
    far = np.abs(out - 0.5) > 0.2
    frac_far = far.any(-1).mean()
    assert 0.2 < frac_far < 0.45, frac_far
    near = out[~far.any(-1)]
    assert np.abs(near - 0.5).mean() < 0.05


def _scenes(name, integrator, depth):
    """(JAX SceneArrays, JAX meta, port Scene, port meta) at RES^2."""
    text = jts.CORNELL_PBRT if name == "cornell" else jts.cornell_mesh_pbrt(levels=3)
    out = []
    for bd_, lx_, comp, kw in ((jbd, jlx, j_compile, {}), (tbd, tlx, compile_scene,
                                                           {"device": "cpu"})):
        b = bd_.SceneBuilder()
        b.parse_tokens(lx_.tokenize(text))
        b.film["xresolution"] = b.film["yresolution"] = RES
        b.integrator["maxdepth"] = depth
        out += comp(b, spp_override=1, integrator_override=integrator, **kw)
    return out


def _close_lanes(got, want):
    """Fraction of lanes whose every value is within ATOL + RTOL |want|."""
    err = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    return 1.0 - err.reshape(err.shape[0], -1).any(1).mean()


@pytest.mark.parametrize("name", ["cornell", "cornell-mesh"])
def test_eval_x_matches_jax(name):
    js, jm, ts, tm = _scenes(name, "mltpath", 3)
    assert tm.bvh_nint > 0 if name == "cornell-mesh" else tm.n_spheres == 2
    x = primary_samples(R_EVAL, 16 + 10 * 3, 11)
    rgb_j, y_j, pix_j = jmlt.eval_x(js, jnp.asarray(x), max_depth=3, res_x=RES, res_y=RES,
                                    env_ids=tuple(jm.env_light_ids))
    rgb, y, pix, stats = mlt.eval_x(ts, tm, torch.from_numpy(x))
    np.testing.assert_array_equal(pix.numpy(), np.asarray(pix_j))
    assert pix.dtype == torch.int32 and int(stats["closest"]) >= R_EVAL
    assert _close_lanes(rgb.numpy(), np.asarray(rgb_j)) >= LANE_FRAC
    assert _close_lanes(y.numpy()[:, None], np.asarray(y_j)[:, None]) >= LANE_FRAC
    assert (y.numpy() > 0).mean() > 0.3


def test_eval_x_bdpt_matches_jax():
    """Cornell at max depth 2: C = 3 contributions (the camera sum and the
    t = 1 strategies s = 2, 3, in that order)."""
    js, jm, ts, tm = _scenes("cornell", "mltbdpt", 2)
    x = primary_samples(R_EVAL, 16 + 16 * 4, 12)
    pix_j, rgb_j, y_j = jmlt.eval_x_bdpt(js, jnp.asarray(x), max_depth=2, res_x=RES, res_y=RES,
                                         env_ids=tuple(jm.env_light_ids))
    pix, rgb, y, stats = mlt.eval_x_bdpt(ts, tm, torch.from_numpy(x))
    assert tuple(pix.shape) == (3, R_EVAL) and tuple(rgb.shape) == (3, R_EVAL, 3)
    pix_j, rgb_j = np.asarray(pix_j), np.asarray(rgb_j)
    np.testing.assert_array_equal(pix[0].numpy(), pix_j[0])
    live = np.asarray(rgb_j).any(-1)                       # splats that landed
    np.testing.assert_array_equal(pix.numpy()[live], pix_j[live])
    assert live[1:].any(1).all(), "a t = 1 strategy is never live"
    for c in range(3):
        assert _close_lanes(rgb[c].numpy(), rgb_j[c]) >= LANE_FRAC, c
    assert _close_lanes(y.numpy()[:, None], np.asarray(y_j)[:, None]) >= LANE_FRAC
    assert int(stats["shadow"]) > 0


@pytest.mark.parametrize("C", [1, 4])
def test_accept_and_splat_matches_jax(C):
    R, D, n_pix = 1024, 16, 64
    a = accept_inputs(R, C, D, n_pix, 20 + C)
    splat0 = np.random.default_rng(4).random((n_pix, 3)).astype(np.float32)
    heat0 = np.random.default_rng(5).random(n_pix).astype(np.float32)
    J = {k: jnp.asarray(v) for k, v in a.items()}
    if C == 1:
        sp_j, ht_j, x_j, rgb_j, y_j, pix_j, a_j = jmlt._accept_and_splat(
            jnp.asarray(splat0), jnp.asarray(heat0), J["x_cur"], J["x_prop"], J["rgb_cur"][0],
            J["rgb_prop"][0], J["y_cur"], J["y_prop"], J["pix_cur"][0], J["pix_prop"][0],
            J["u_acc"])
        rgb_j, pix_j = rgb_j[None], pix_j[None]
    else:
        sp_j, ht_j, x_j, pix_j, rgb_j, y_j, a_j = jmlt._accept_and_splat_multi(
            jnp.asarray(splat0), jnp.asarray(heat0), J["x_cur"], J["x_prop"], J["pix_cur"],
            J["pix_prop"], J["rgb_cur"], J["rgb_prop"], J["y_cur"], J["y_prop"], J["u_acc"])
    T = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    cur = mlt.Chains(T["x_cur"], T["pix_cur"], T["rgb_cur"], T["y_cur"])
    prop = mlt.Chains(T["x_prop"], T["pix_prop"], T["rgb_prop"], T["y_prop"])
    splat, heat = torch.from_numpy(splat0.copy()), torch.from_numpy(heat0.copy())
    acc = mlt.accept_and_splat_from_uniforms(splat, heat, cur, prop, T["u_acc"])
    np.testing.assert_array_equal(acc.numpy(), np.asarray(a_j))
    for got, want in zip(cur, (x_j, pix_j, rgb_j, y_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in ((splat, sp_j), (heat, ht_j)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= SPLAT_RTOL * np.abs(want).max()
    accepted = (a["u_acc"] < np.asarray(a_j))
    assert 0 < accepted.sum() < R and (a["y_cur"] == 0).any() and (a["y_prop"] == 0).any()


def test_accept_and_splat_draws_its_stream():
    """On CPU tensors accept_and_splat is the plain version with the
    uniforms of stream (seed, ACCEPT, pass)."""
    a = accept_inputs(256, 2, 8, 32, 7)

    def run(fn, *args):
        T = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
        cur = mlt.Chains(T["x_cur"], T["pix_cur"], T["rgb_cur"], T["y_cur"])
        prop = mlt.Chains(T["x_prop"], T["pix_prop"], T["rgb_prop"], T["y_prop"])
        splat, heat = torch.zeros((32, 3)), torch.zeros(32)
        fn(splat, heat, cur, prop, *args)
        return list(cur) + [splat, heat]

    for g, w in zip(run(mlt.accept_and_splat, 5, 9),
                    run(mlt.accept_and_splat_from_uniforms, mlt.accept_uniforms(5, 9, 256))):
        assert torch.equal(g, w)
