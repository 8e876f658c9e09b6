"""Light sampling of the port against pbrt_tpu on the same numpy-seeded
inputs: sample_li for sphere and disk area lights, distant, uniform
infinite and spot lights (one scene holds all five), the sphere and disk
branches of area_light_pdf_li at the sampled points, and the uniform
infinite light's escaped-ray radiance and density.

Tolerance 2e-5 relative (atol 2e-6): the same float32 formulas on both
sides; the JAX package's XLA may fuse or reorder a few of them."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pbrt_tpu.lights import lights as jl
from pbrt_tpu.scene import builder as jbd, lexer as jlx
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch.lights import lights as tl
from pbrt_tpu_torch.scene import builder as tbd, lexer as tlx
from pbrt_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(2)
N = 4000
LIGHTS_PBRT = """
LookAt 0 1 -6  0 1 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "distant" "point3 from" [1 3 -2] "point3 to" [0 0 0] "rgb L" [2 1.5 1]
LightSource "infinite" "rgb L" [0.3 0.4 0.5]
LightSource "spot" "point3 from" [0 4 0] "point3 to" [0.5 0 0]
    "float coneangle" [40] "float conedeltaangle" [10] "rgb I" [5 4 3]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 3 2]
  Translate 1.5 2 0.5
  Shape "sphere" "float radius" [0.6]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 6 6] "bool twosided" [true]
  Translate -1.5 2.5 0
  Rotate 90 1 0 0
  Shape "disk" "float radius" [0.5] "float innerradius" [0.1]
AttributeEnd
Material "diffuse"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
"""
TYPES = {"distant": 0, "uniform infinite": 1, "spot": 2, "sphere": 3, "disk": 4}


@pytest.fixture(scope="module")
def scenes():
    jb = jbd.SceneBuilder()
    jb.parse_tokens(jlx.tokenize(LIGHTS_PBRT))
    ja, _ = j_compile(jb, spp_override=1)
    tb = tbd.SceneBuilder()
    tb.parse_tokens(tlx.tokenize(LIGHTS_PBRT))
    ts, tm = compile_scene(tb, spp_override=1, device="cpu")
    assert tm.open_scene and ts.lt_type.tolist() == [1, 2, 4, 0, 0]
    return ja, ts


def _inputs(seed, light):
    g = np.random.default_rng(seed)
    p = g.uniform(-3.0, 3.0, (N, 3)) + np.array([0.0, 1.0, 6.0])  # render space
    p[: N // 8] = np.array([1.5, 1.0, 6.5]) + g.uniform(-0.3, 0.3, (N // 8, 3))  # in the sphere
    ns = g.normal(size=(N, 3))
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    ns[::7] = 0.0                     # medium-like lanes without a normal
    u2 = g.uniform(0.0, 1.0, (N, 2))
    lam = g.uniform(360.0, 830.0, (N, 4))
    idx = np.full(N, TYPES[light], np.int32)
    idx[::11] = -1                    # no light
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(p), f32(ns), f32(u2), f32(lam), idx


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-6, err_msg=name)


@pytest.mark.parametrize("light", list(TYPES))
def test_sample_li_matches_jax(scenes, light):
    ja, ts = scenes
    p, ns, u2, lam, idx = _inputs(TYPES[light] + 1, light)
    want = jl.sample_li(ja, jnp.asarray(idx), jnp.asarray(p), jnp.asarray(ns), jnp.asarray(u2),
                        jnp.asarray(lam), ja.scene_radius)
    got = tl.sample_li(ts, torch.as_tensor(idx).long(), *map(torch.as_tensor, (p, ns, u2, lam)))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > N // 2
    for f in ("is_delta", "is_distant"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    for f in ("L", "wi", "pdf", "p_light", "n_light"):
        _close(getattr(got, f).numpy()[valid], np.asarray(getattr(want, f))[valid], f)


@pytest.mark.parametrize("light", ["sphere", "disk"])
def test_area_light_pdf_li_matches_jax(scenes, light):
    """pdf_li of the sampled points of sphere and disk emitters, seen as
    hits; for the sphere, from outside (cone) and inside (area) alike."""
    ja, ts = scenes
    p, ns, u2, lam, idx = _inputs(10 + TYPES[light], light)
    ls = jl.sample_li(ja, jnp.asarray(idx), jnp.asarray(p), jnp.asarray(ns), jnp.asarray(u2),
                      jnp.asarray(lam), ja.scene_radius)
    want = np.asarray(jl.area_light_pdf_li(ja, jnp.asarray(idx), jnp.asarray(p), jnp.asarray(ns),
                                           ls.wi, ls.p_light, ls.n_light))
    args = [torch.as_tensor(np.array(x)) for x in (p, ns, ls.wi, ls.p_light, ls.n_light)]
    got = tl.area_light_pdf_li(ts, torch.as_tensor(idx).long(), *args).numpy()
    ok = np.asarray(ls.valid)
    _close(got[ok], want[ok], "pdf_li")
    _close(got[ok], np.asarray(ls.pdf)[ok], "pdf_li vs the sampling pdf")


def test_uniform_infinite_escape_matches_jax(scenes):
    ja, ts = scenes
    _, _, u2, lam, _ = _inputs(20, "uniform infinite")
    d = np.asarray(u2[:, :1].repeat(3, 1) - 0.5, np.float32)
    _close(tl.infinite_le(ts, torch.as_tensor(d), torch.as_tensor(lam)).numpy(),
           jl.infinite_le(ja, (), jnp.asarray(d), jnp.asarray(lam)), "infinite_le")
    _close(tl.infinite_light_density(ts, torch.as_tensor(d)).numpy(),
           jl.infinite_light_density(ja, (), jnp.asarray(d)), "infinite_light_density")
    assert tl.uniform_infinite_pdf_li() == jl.uniform_infinite_pdf_li()
