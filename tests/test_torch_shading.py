"""pbrt_tpu_torch shading vs pbrt_tpu on the same SceneArrays (carried
across with scene_from_arrays): make_bsdf and bsdf_f/pdf/sample for every
material kind of the slice, triangle-light sample_li/area_light_pdf_li and
camera generate_rays, within 1e-5 relative."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pbrt_tpu.cameras import perspective as jcam
from pbrt_tpu.integrators import path as jpath
from pbrt_tpu.lights import lights as jlights
from pbrt_tpu.materials import materials as jmat
from pbrt_tpu.scene import builder as jbd, lexer as jlx, testscenes as jts
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu.spectral import sampled as jsampled
from pbrt_tpu_torch.cameras import perspective as tcam
from pbrt_tpu_torch.integrators import path as tpath
from pbrt_tpu_torch.lights import lights as tlights
from pbrt_tpu_torch.materials import materials as tmat
from pbrt_tpu_torch.scene.compile import scene_from_arrays
from pbrt_tpu_torch.spectral import sampled as tsampled

torch.set_num_threads(2)
N = 4096
EXTRA_MATERIALS = """
Material "conductor" "float roughness" [0.3]
Material "conductor" "rgb reflectance" [0.9 0.6 0.3] "float roughness" [0.1]
Material "conductor" "spectrum eta" "metal-Au-eta" "spectrum k" "metal-Au-k"
Material "dielectric" "float eta" [1.33] "float roughness" [0.2]
Material "dielectric" "spectrum eta" "glass-BK7"
Material "diffusetransmission" "rgb reflectance" [0.3 0.5 0.2]
"""


@pytest.fixture(scope="module")
def scenes():
    b = jbd.SceneBuilder()
    b.parse_tokens(jlx.tokenize(jts.cornell_mesh_pbrt(levels=2) + EXTRA_MATERIALS))
    b.film["xresolution"] = b.film["yresolution"] = 32
    js, jm = j_compile(b, spp_override=1)
    arrays = {k: (np.asarray(v) if k != "filt" else v) for k, v in js._asdict().items()
              if v is not None and k != "tex"}
    ts, tm = scene_from_arrays(arrays, jm, "cpu")
    return js, ts, tm


def _unit(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def lanes(scenes):
    js, _, _ = scenes
    g = np.random.default_rng(21)
    M = js.mat_type.shape[0]
    mat = g.integers(0, M, N).astype(np.int32)
    ns = _unit(g, N)
    wo = _unit(g, N)
    wo = np.where((wo * ns).sum(-1, keepdims=True) < 0, -wo, wo)   # mostly front side
    wo[::7] *= -1
    wi = _unit(g, N)
    u = g.random(N).astype(np.float32)
    uc = g.random(N).astype(np.float32)
    u2 = g.random((N, 2)).astype(np.float32)
    return mat, ns, wo, wi, u, uc, u2


def _close(got, want, rtol=1e-5, atol=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * 1e-2 * scale if atol is None else atol)


def _f64(scene):
    """The scene with every float tensor in float64 (conditioning probe)."""
    def up(x):
        return x.double() if x.is_floating_point() else x
    kw = {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)}
    kw = {k: (type(v)(*map(up, v)) if k == "filt" else v if k == "tex" else up(v))
          for k, v in kw.items()}
    return type(scene)(**kw)


@pytest.fixture(scope="module")
def bsdfs(scenes, lanes):
    js, ts, _ = scenes
    mat, ns, wo, wi, u, uc, u2 = lanes
    wlj = jsampled.sample_visible(jnp.asarray(u))
    wlt = tsampled.sample_visible(torch.from_numpy(u))
    bj, wj = jmat.make_bsdf(js, jnp.asarray(mat), jnp.asarray(ns), wlj)
    bt, wt = tmat.make_bsdf(ts, torch.from_numpy(mat), torch.from_numpy(ns), wlt)
    return bj, wj, bt, wt


@pytest.mark.parametrize("field", ["kind", "refl", "trans", "eta_re", "eta_im", "eta",
                                   "ax", "ay"])
def test_make_bsdf_params(bsdfs, field):
    bj, _, bt, _ = bsdfs
    _close(getattr(bt.params, field).numpy(), np.asarray(getattr(bj.params, field)))


def test_make_bsdf_frame_and_wavelengths(bsdfs):
    bj, wj, bt, wt = bsdfs
    for a in ("fx", "fy", "fz"):
        _close(getattr(bt, a).numpy(), np.asarray(getattr(bj, a)))
    _close(wt.pdf.numpy(), np.asarray(wj.pdf), rtol=2e-6 * 5)


def test_bsdf_f_and_pdf(bsdfs, lanes):
    bj, _, bt, _ = bsdfs
    _, _, wo, wi, _, _, _ = lanes
    _close(tmat.bsdf_f(bt, torch.from_numpy(wo), torch.from_numpy(wi)).numpy(),
           jmat.bsdf_f(bj, jnp.asarray(wo), jnp.asarray(wi)))
    _close(tmat.bsdf_pdf(bt, torch.from_numpy(wo), torch.from_numpy(wi)).numpy(),
           jmat.bsdf_pdf(bj, jnp.asarray(wo), jnp.asarray(wi)))


@pytest.mark.parametrize("field", ["f", "wi", "pdf", "flags", "eta", "valid"])
def test_bsdf_sample(bsdfs, lanes, field):
    bj, _, bt, _ = bsdfs
    _, _, wo, _, _, uc, u2 = lanes
    sj = jmat.bsdf_sample(bj, jnp.asarray(wo), jnp.asarray(uc), jnp.asarray(u2))
    st = tmat.bsdf_sample(bt, torch.from_numpy(wo), torch.from_numpy(uc), torch.from_numpy(u2))
    want, got = np.asarray(getattr(sj, field)), getattr(st, field).numpy()
    if field in ("flags", "valid"):
        np.testing.assert_array_equal(got, want)
    else:
        ok = np.asarray(sj.valid)
        # directions are unit vectors: their error is absolute
        _close(got[ok], want[ok], atol=1e-6 if field == "wi" else None)


@pytest.fixture(scope="module")
def light_lanes(scenes):
    js, _, _ = scenes
    g = np.random.default_rng(33)
    L = js.lt_type.shape[0]
    pts = np.concatenate([np.asarray(js.tri_p0), np.asarray(js.tri_p2)])
    lo, hi = pts.min(0), pts.max(0)
    p_ref = (lo + (hi - lo) * (0.05 + 0.8 * g.random((N, 3)))).astype(np.float32)
    ns_ref = _unit(g, N)
    ns_ref[::5] = 0.0                        # medium-like lanes: no normal
    li = g.integers(0, L, N).astype(np.int32)
    u2 = g.random((N, 2)).astype(np.float32)
    lam = np.array(jsampled.sample_visible(jnp.asarray(g.random(N).astype(np.float32))).lam)
    return li, p_ref, ns_ref, u2, lam


def test_pick_light(scenes):
    js, ts, _ = scenes
    u = np.random.default_rng(2).random(N).astype(np.float32)
    ij, pj = jpath._pick_light(js, jnp.asarray(u))
    it, pt = tpath._pick_light(ts, torch.from_numpy(u))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_sample_li_and_pdf_li(scenes, light_lanes):
    js, ts, _ = scenes
    li, p_ref, ns_ref, u2, lam = light_lanes
    lj = jlights.sample_li(js, *map(jnp.asarray, (li, p_ref, ns_ref, u2, lam)),
                           js.scene_radius)
    lt = tlights.sample_li(ts, *map(torch.from_numpy, (li, p_ref, ns_ref, u2, lam)))
    np.testing.assert_array_equal(lt.valid.numpy(), np.asarray(lj.valid))
    ok = np.asarray(lj.valid)
    l64 = tlights.sample_li(_f64(ts), *(torch.from_numpy(x).double() if x.dtype == np.float32
                                        else torch.from_numpy(x)
                                        for x in (li, p_ref, ns_ref, u2, lam)))
    _close(lt.L.numpy()[ok], np.asarray(lj.L)[ok])
    for f in ("wi", "pdf", "p_light"):
        # spherical-triangle sampling is float32-ill-conditioned on some
        # lanes (test_torch_sampling): agree to 1e-5 on the median lane and
        # nowhere further apart than the two results are from float64
        a, b, c = getattr(lt, f).numpy()[ok], np.asarray(getattr(lj, f))[ok], \
            getattr(l64, f).numpy()[ok]
        err = np.abs(a - b).reshape(len(a), -1).max(-1)
        cond = (np.abs(b - c) + np.abs(a - c)).reshape(len(a), -1).max(-1)
        scale = np.abs(b).reshape(len(b), -1).max(-1)
        assert np.median(err / scale) <= 1e-5, f
        assert np.all(err <= cond + 1e-5 * scale), f
    n_l = np.array(lj.n_light)
    pj = jlights.area_light_pdf_li(js, jnp.asarray(li), jnp.asarray(p_ref), jnp.asarray(ns_ref),
                                   lj.wi, lj.p_light, jnp.asarray(n_l))
    pt = tlights.area_light_pdf_li(ts, torch.from_numpy(li), torch.from_numpy(p_ref),
                                   torch.from_numpy(ns_ref), torch.from_numpy(np.array(lj.wi)),
                                   torch.from_numpy(np.array(lj.p_light)),
                                   torch.from_numpy(n_l))
    # the inverse spherical-triangle map is float32-ill-conditioned on a few
    # lanes (see test_torch_sampling); the median lane must agree to 1e-5
    rel = np.abs(pt.numpy() - np.asarray(pj)) / np.maximum(np.abs(np.asarray(pj)), 1e-30)
    assert np.median(rel[ok]) <= 1e-5 and np.mean(rel[ok] > 1e-3) < 0.01
    le_j = jlights.area_light_le(js, jnp.asarray(li), jnp.asarray(n_l), -lj.wi, jnp.asarray(lam))
    le_t = tlights.area_light_le(ts, torch.from_numpy(li), torch.from_numpy(n_l),
                                 -torch.from_numpy(np.array(lj.wi)), torch.from_numpy(lam))
    _close(le_t.numpy(), np.asarray(le_j))


def test_generate_rays(scenes):
    js, ts, _ = scenes
    g = np.random.default_rng(4)
    p_film = (g.random((N, 2)) * 32).astype(np.float32)
    u_lens = g.random((N, 2)).astype(np.float32)
    rj = jcam.generate_rays(js, jnp.asarray(p_film), jnp.asarray(u_lens))
    rt = tcam.generate_rays(ts, torch.from_numpy(p_film), torch.from_numpy(u_lens))
    _close(rt.o.numpy(), np.asarray(rj.o))
    _close(rt.d.numpy(), np.asarray(rj.d))


def test_spectral_lookups(scenes):
    """sample_dense/sample_table/sigmoid_polynomial: the JAX package's
    one-hot matrix-unit lookups against the port's plain indexing."""
    from pbrt_tpu.spectral import spectra as jspec
    from pbrt_tpu_torch.spectral import spectra as tspec

    js, ts, _ = scenes
    g = np.random.default_rng(12)
    lam = (355.0 + 480.0 * g.random((N, 4))).astype(np.float32)
    lam[:4] = [[359.5, 360.5, 829.5, 830.5]] * 4
    row = np.array(js.spec_table)[0]
    np.testing.assert_array_equal(tspec.sample_dense(torch.from_numpy(row), torch.from_numpy(lam)).numpy(),
                                  np.asarray(jspec.sample_dense(jnp.asarray(row), jnp.asarray(lam))))
    idx = g.integers(0, js.spec_table.shape[0], N).astype(np.int32)
    np.testing.assert_array_equal(
        tspec.sample_table(ts.spec_table, torch.from_numpy(idx).long(), torch.from_numpy(lam)),
        np.asarray(jspec.sample_table(js.spec_table, jnp.asarray(idx), jnp.asarray(lam))))
    c = np.asarray(js.mat_refl_c)[g.integers(0, js.mat_refl_c.shape[0], N)]
    # s = 0.5 x / sqrt(1 + x^2) + 0.5 is computed around 0.5, so its error is
    # absolute: one float32 ulp of 0.5 is 6e-8
    _close(tspec.sigmoid_polynomial(torch.from_numpy(c), torch.from_numpy(lam)).numpy(),
           np.asarray(jspec.sigmoid_polynomial(jnp.asarray(c), jnp.asarray(lam))), rtol=1e-6,
           atol=1.2e-7)
