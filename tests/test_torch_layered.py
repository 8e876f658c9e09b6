"""pbrt_tpu_torch's layered BxDF (the plain versions of K7) against
pbrt_tpu.materials.layered on the same numpy lanes: the synthetic cases of
tests/layered_cases.py (smooth and rough coats, a scattering medium with
g in {-0.5, 0, 0.7}, smooth and rough conductor bases, wo below the horizon
and grazing) and the coats of tests/test_layered.py's `_params`; beside
them bxdfs.sample/pdf with allow_refl/allow_trans/mode_radiance and the
Henyey-Greenstein warps.

Tolerances: XLA and torch round exp, log1p, sin and cos differently by an
ulp, and the walk compares its draws against computed thresholds (the
Fresnel choice, russian roulette, the boundary tests), so a rare lane may
take another branch. The walk's outputs are therefore held statistically,
as on the card, to tests/layered_cases.py's criteria: valid and flags equal
on >= 99.9 % of lanes, f, wi and pdf within rtol 1e-4, atol 1e-6 on
>= 99.5 %, and the lane means within 1e-3 relative. The BxDF functions and
warps take no such branch and are held lane by lane to 1e-5 relative."""
import functools

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from layered_cases import (BXDF_FIELDS, CASES, CLOSE_FRAC, EQUAL_FRAC, MEAN_RTOL,
                           frac_close, lanes)
from test_layered import _params
from pbrt_tpu.materials import bxdfs as jb, layered as jl
from pbrt_tpu.sampling import warps as jw
from pbrt_tpu_torch.materials import bxdfs as tb, layered as tl
from pbrt_tpu_torch.sampling import warps as tw

torch.set_num_threads(2)
N = 4096


@functools.cache
def _jitted(name):
    """pbrt_tpu.materials.layered.<name> compiled once for the module (called
    eagerly, its fori_loop compiles again on every call); max_depth and
    n_samples stay Python ints."""
    fn = getattr(jl, name)
    return jax.jit(lambda top, bottom, thickness, g, albedo, *args: fn(
        jl.LayeredParams(top, bottom, thickness, g, albedo, 10, 1), *args))


def _jax(name, pj, *args):
    assert (pj.max_depth, pj.n_samples) == (10, 1)
    return _jitted(name)(pj.top, pj.bottom, pj.thickness, pj.g, pj.albedo,
                         *(jnp.asarray(a) for a in args))


def assert_walk_close(got, want, name):
    assert frac_close(got, want) >= CLOSE_FRAC, (name, frac_close(got, want))
    m_got, m_want = float(np.mean(got)), float(np.mean(want))
    assert abs(m_got - m_want) <= MEAN_RTOL * abs(m_want) + 1e-9, (name, m_got, m_want)


def _both(arrays):
    """(JAX LayeredParams, port LayeredParams) from numpy lanes."""
    def make(b_mod, l_mod, conv):
        def bx(tag):
            return b_mod.BxdfParams(*(conv(arrays[f"{tag}_{f}"]) for f in BXDF_FIELDS))
        return l_mod.LayeredParams(bx("top"), bx("bottom"), conv(arrays["thickness"]),
                                   conv(arrays["g"]), conv(arrays["albedo"]), 10, 1)
    return make(jb, jl, jnp.asarray), make(tb, tl, torch.from_numpy)


def _from_jax_params(pj):
    """numpy lanes of a JAX LayeredParams (tests/test_layered.py `_params`)."""
    out = {}
    for tag in ("top", "bottom"):
        for f in BXDF_FIELDS:
            out[f"{tag}_{f}"] = np.array(getattr(getattr(pj, tag), f))
    for f in ("thickness", "g", "albedo"):
        out[f] = np.array(getattr(pj, f))
    return out


SETS = ["synthetic", "_params diffuse", "_params conductor", "_params medium"]


@pytest.fixture(scope="module", params=SETS)
def case(request):
    arrays = lanes(N, 5)
    if request.param != "synthetic":
        kw = {"_params diffuse": dict(coat_rough=0.2, refl=0.6),
              "_params conductor": dict(bottom_kind=jb.K_CONDUCTOR),
              "_params medium": dict(albedo=0.7, g=0.3, thickness=0.05)}[request.param]
        arrays.update(_from_jax_params(_params(N, **kw)))
    pj, pt = _both(arrays)
    return request.param, arrays, pj, pt


def test_layered_f_matches_jax(case):
    name, a, pj, pt = case
    want = np.asarray(_jax("layered_f", pj, a["wo"], a["wi"]))
    got = tl.layered_f(pt, torch.from_numpy(a["wo"]), torch.from_numpy(a["wi"])).numpy()
    assert got.shape == (N, 4) and np.isfinite(got).all()
    assert_walk_close(got, want, name)
    if name == "synthetic":   # every case contributes
        for c, label in enumerate(CASES):
            m = a["case"] == c
            assert frac_close(got[m], want[m]) >= 0.99, label


def test_layered_pdf_matches_jax(case):
    name, a, pj, pt = case
    want = np.asarray(_jax("layered_pdf", pj, a["wo"], a["wi"]))
    got = tl.layered_pdf(pt, torch.from_numpy(a["wo"]), torch.from_numpy(a["wi"])).numpy()
    assert got.shape == (N,) and bool((got > 0).all())
    assert_walk_close(got, want, name)


def test_layered_sample_matches_jax(case):
    name, a, pj, pt = case
    sj = _jax("layered_sample", pj, a["wo"], a["uc"], a["u2"])
    st = tl.layered_sample(pt, torch.from_numpy(a["wo"]), torch.from_numpy(a["uc"]),
                           torch.from_numpy(a["u2"]))
    for f in ("valid", "flags"):
        eq = float((getattr(st, f).numpy() == np.asarray(getattr(sj, f))).mean())
        assert eq >= EQUAL_FRAC, (name, f, eq)
    assert 0.3 < float(st.valid.numpy().mean()) <= 1.0
    for f in ("f", "wi", "pdf", "eta"):
        assert_walk_close(getattr(st, f).numpy(), np.asarray(getattr(sj, f)), (name, f))
    # the estimator f |cos| / pdf of the valid lanes
    def est(s, valid):
        s = [np.asarray(x) for x in (s.f, s.wi, s.pdf)]
        return np.where(valid[:, None], s[0] * np.abs(s[1][:, 2:3])
                        / np.maximum(s[2], 1e-12)[:, None], 0.0)
    vj = np.asarray(sj.valid)
    m_t, m_j = est(st, st.valid.numpy()).mean(), est(sj, vj).mean()
    assert abs(m_t - m_j) <= MEAN_RTOL * abs(m_j), (name, m_t, m_j)


def _rel_close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if want.size == 0:
        return
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * 1e-2 * scale)


@pytest.mark.parametrize("flags", [(True, True, True), (False, True, True),
                                   (True, False, True), (False, True, False)])
def test_bxdf_sample_and_pdf_with_lobe_flags(flags):
    """bxdfs.sample/pdf restricted to reflection or transmission, in either
    transport mode, for the interfaces of the synthetic lanes."""
    allow_refl, allow_trans, mode = flags
    a = lanes(N, 8)
    pj, pt = _both(a)
    for tag in ("top", "bottom"):
        bj, bt = getattr(pj, tag), getattr(pt, tag)
        sj = jb.sample(bj, jnp.asarray(a["wo"]), jnp.asarray(a["uc"]), jnp.asarray(a["u2"]),
                       allow_refl, allow_trans, mode)
        st = tb.sample(bt, torch.from_numpy(a["wo"]), torch.from_numpy(a["uc"]),
                       torch.from_numpy(a["u2"]), allow_refl, allow_trans, mode)
        ok = np.asarray(sj.valid)
        np.testing.assert_array_equal(st.valid.numpy(), ok)
        # reflection-only bases give no transmission sample
        assert ok.any() == (allow_refl or tag == "top")
        np.testing.assert_array_equal(st.flags.numpy()[ok], np.asarray(sj.flags)[ok])
        for f in ("f", "pdf", "eta"):
            _rel_close(getattr(st, f).numpy()[ok], np.asarray(getattr(sj, f))[ok])
        np.testing.assert_allclose(st.wi.numpy()[ok], np.asarray(sj.wi)[ok], atol=1e-6)
        _rel_close(tb.pdf(bt, torch.from_numpy(a["wo"]), torch.from_numpy(a["wi"]),
                          allow_refl, allow_trans).numpy(),
                   jb.pdf(bj, jnp.asarray(a["wo"]), jnp.asarray(a["wi"]), allow_refl,
                          allow_trans))
    assert bool((tb.is_transmission(st.flags) == ((st.flags & tb.F_TRANSMISSION) != 0)).all())


def test_henyey_greenstein_warps():
    g = np.random.default_rng(4)
    cos_t = g.uniform(-1, 1, N).astype(np.float32)
    hg_g = g.choice(np.array([-0.5, 0.0, 0.0005, 0.7], np.float32), N)
    _rel_close(tw.henyey_greenstein(torch.from_numpy(cos_t), torch.from_numpy(hg_g)).numpy(),
               jw.henyey_greenstein(jnp.asarray(cos_t), jnp.asarray(hg_g)))
    wo = g.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u = g.random((N, 2)).astype(np.float32)
    wi_t, pdf_t = tw.sample_henyey_greenstein(torch.from_numpy(wo), torch.from_numpy(hg_g),
                                              torch.from_numpy(u))
    wi_j, pdf_j = jw.sample_henyey_greenstein(jnp.asarray(wo), jnp.asarray(hg_g), jnp.asarray(u))
    np.testing.assert_allclose(wi_t.numpy(), np.asarray(wi_j), atol=2e-6)
    _rel_close(pdf_t.numpy(), pdf_j, rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(wi_t.numpy(), axis=-1), 1.0, atol=1e-5)


def test_world_directions_round_apart_under_xla():
    """Why the coated renders are compared on block means: the walk seeds its
    PCG32 with the float bits of its local directions, and the directions
    come from `from_local` / `to_local` sums of products. Eagerly the two
    packages agree bit for bit; compiled, XLA contracts the sums into fused
    multiply-adds and the bits differ on most lanes (65 % of from_local's
    and 72 % of to_local's on these 4096 lanes, JAX 0.9 on the CPU), so the
    two packages' walks are independent draws. Should XLA stop contracting,
    this fails, and the render checks of tests/scene_render_check.py can go
    back to per pixel."""
    from pbrt_tpu.geometry import vecmath as jv
    from pbrt_tpu_torch.geometry import vecmath as tv

    g = np.random.default_rng(0)

    def unit(a):
        return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)
    z = unit(g.normal(size=(N, 3)))
    x = unit(np.cross(z, g.normal(size=(N, 3))))
    y = np.cross(z, x).astype(np.float32)
    v = unit(g.normal(size=(N, 3)))
    for name in ("from_local", "to_local"):
        args_j = [jnp.asarray(a) for a in (x, y, z, v)]
        want = getattr(tv, name)(*(torch.from_numpy(a) for a in (x, y, z, v))).numpy()
        eager = np.asarray(getattr(jv, name)(*args_j))
        jitted = np.asarray(jax.jit(getattr(jv, name))(*args_j))
        np.testing.assert_array_equal(eager.view(np.int32), want.view(np.int32))
        np.testing.assert_allclose(jitted, want, atol=4e-7)
        differ = float((jitted.view(np.int32) != want.view(np.int32)).any(axis=1).mean())
        assert differ > 0.25, (name, differ)
