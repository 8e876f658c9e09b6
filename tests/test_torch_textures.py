"""The port's textures, mix and named materials against the JAX package on
the CPU (pbrt_tpu_torch/textures/, materials.resolve_mix and the textured
make_bsdf, cameras/differentials.py, the builder and compiler): the same
inputs, made from a seed with numpy, through both.

Inputs: tests/texture_cases.py (images in every format written by the
test, a scene whose textures reach every node type, mapping and wrap mode
through every textured slot and a mix material). The JAX evaluations are
jitted once for the file. Tolerances: the image readers, the compiled
tables and resolve_mix exactly; texture values to 1e-5 plus 1e-4 of the
value on all but 0.1 % of the lanes (XLA's acos, atan2 and its contracted
sums round apart from torch's by an ulp: jitted and eager JAX themselves
differ by up to 3e-5 on 0.2 % of footprint lanes, and an ulp can move a
point across a checker's or texel's cell edge); differentials and
make_bsdf to a relative 1e-4."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import texture_cases as tc
from pbrt_tpu.cameras import differentials as jdif
from pbrt_tpu.materials import materials as jmat
from pbrt_tpu.scene import builder as jbd, lexer as jlx
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu.spectral import sampled as jsampled
from pbrt_tpu.textures import image as jimage, textures as jtx
from pbrt_tpu_torch.cameras import differentials as tdif
from pbrt_tpu_torch.materials import materials as tmat
from pbrt_tpu_torch.scene import builder as tbd, lexer as tlx
from pbrt_tpu_torch.scene.compile import compile_arrays, scene_from_arrays
from pbrt_tpu_torch.spectral import sampled as tsampled
from pbrt_tpu_torch.textures import image as timage, textures as ttx

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-4
FAR_FRAC = 1e-3
R = 4096


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """texture_cases' scene through both packages -> (JAX scene, port
    arrays, port scene, port meta)."""
    text = tc.scene_text(tmp_path_factory.mktemp("tex"))
    jb = jbd.SceneBuilder()
    jb.parse_tokens(jlx.tokenize(text))
    js, _ = j_compile(jb)
    tb = tbd.SceneBuilder()
    tb.parse_tokens(tlx.tokenize(text))
    ta, tm = compile_arrays(tb)
    ts, _ = scene_from_arrays(ta, tm, "cpu")
    return js, ta, ts, tm


def _lanes(seed, footprints=False):
    g = np.random.default_rng(seed)
    ns = g.normal(size=(R, 3))
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    return dict(uv=g.uniform(-1.5, 2.5, (R, 2)).astype(np.float32), ns=ns.astype(np.float32),
                lam=g.uniform(360, 830, (R, 4)).astype(np.float32),
                p=g.uniform(-3.5, 3.5, (R, 3)).astype(np.float32),
                duv=g.normal(0, 0.05, (R, 4)).astype(np.float32) if footprints else None)


def _far(got, want):
    """The share of lanes with a component off by more than ATOL + RTOL of
    the value."""
    want = np.asarray(want, np.float64)
    far = ~(np.abs(np.asarray(got, np.float64) - want) <= ATOL + RTOL * np.abs(want))
    return float(far.reshape(far.shape[0], -1).any(axis=1).mean())


@pytest.mark.parametrize("kind", ["png", "tga", "tga_rle", "pfm", "exr", "exr_zip"])
def test_image_readers_match_jax(tmp_path, kind):
    """Each reader on an image the test writes: the same array as the JAX
    package's reader, and the written values (8-bit formats sRGB-decoded)."""
    path, raw = tc.write_images(tmp_path)[kind]
    got = timage.load_image(path)
    np.testing.assert_array_equal(got, jimage.load_image(path))
    want = timage.srgb_to_linear(raw) if raw.dtype == np.uint8 else raw
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_tables_match_jax(twins):
    """build_tex_arrays (every node field and the atlas) and the material
    table's mix and slot columns equal to the JAX package's."""
    js, ta, ts, tm = twins
    assert tm.textured and ts.tex.type.shape[0] == np.asarray(js.tex.type).shape[0] > 20
    for f in ttx.TexArrays._fields[:-1]:
        np.testing.assert_array_equal(getattr(ta["tex"], f), np.asarray(getattr(js.tex, f)), f)
    for f in ttx.ImageAtlas._fields:
        np.testing.assert_array_equal(getattr(ta["tex"].imgs, f),
                                      np.asarray(getattr(js.tex.imgs, f)), f)
    for f in ("mat_type", "mat_mix_m1", "mat_mix_m2", "mat_mix_amount", "mat_refl_tex",
              "mat_trans_tex", "mat_urough_tex", "mat_vrough_tex", "mat_refl_c", "mat_urough",
              "cam_ray_deltas"):
        np.testing.assert_array_equal(ta[f], np.asarray(getattr(js, f)), f)
    kinds = set(ta["tex"].type.tolist())
    assert kinds == set(range(6)) and set(ta["tex"].mapkind.tolist()) == set(range(4))
    assert set(ta["tex"].imgs.wrap.tolist()) == set(range(4))


@pytest.mark.parametrize("footprints", [False, True])
def test_eval_spectrum_and_float_match_jax(twins, footprints):
    """eval_spectrum and eval_float on every node of the table (each node
    type, mapping, wrap mode, image format), random uv, hit points, normals
    and wavelengths, with and without footprints."""
    js, _, ts, _ = twins
    L = _lanes(1 + footprints, footprints)
    nt = ts.tex.type.shape[0]
    node = np.random.default_rng(3).integers(-1, nt, R).astype(np.int32)
    ja = {k: None if v is None else jnp.asarray(v) for k, v in L.items()}
    ta = {k: None if v is None else torch.as_tensor(v) for k, v in L.items()}
    j_spec = jax.jit(lambda n, uv, ns, lam, p, duv: jtx.eval_spectrum(js.tex, n, uv, ns, lam, p,
                                                                       duv))
    j_float = jax.jit(lambda n, uv, p, duv: jtx.eval_float(js.tex, n, uv, 0.0, p, duv))
    want = j_spec(jnp.asarray(node), ja["uv"], ja["ns"], ja["lam"], ja["p"], ja["duv"])
    got = ttx.eval_spectrum(ts.tex, torch.as_tensor(node), ta["uv"], ta["ns"], ta["lam"],
                            ta["p"], ta["duv"])
    assert _far(got, want) <= FAR_FRAC
    want = j_float(jnp.asarray(node), ja["uv"], ja["p"], ja["duv"])
    got = ttx.eval_float(ts.tex, torch.as_tensor(node), ta["uv"], 0.0, ta["p"], ta["duv"])
    assert _far(got[:, None], np.asarray(want)[:, None]) <= FAR_FRAC
    # the image fetch alone, every image and wrap mode, uv well outside [0, 1]
    for img in range(int(ts.tex.imgs.width.shape[0])):
        idx = np.full(R, img, np.int32)
        st = np.random.default_rng(img).uniform(-2.0, 3.0, (R, 2)).astype(np.float32)
        np.testing.assert_allclose(
            ttx.image_bilerp(ts.tex.imgs, torch.as_tensor(idx), torch.as_tensor(st)).numpy(),
            np.asarray(jtx.image_bilerp(js.tex.imgs, jnp.asarray(idx), jnp.asarray(st))),
            rtol=1e-5, atol=1e-6)


def test_resolve_mix_bits_match_jax(twins):
    """resolve_mix on the same p and wo: the same material on every lane."""
    js, _, ts, _ = twins
    g = np.random.default_rng(4)
    M = ts.mat_type.shape[0]
    mat = g.integers(-1, M, 20000).astype(np.int32)
    p = g.normal(0, 3, (20000, 3)).astype(np.float32)
    wo = g.normal(size=(20000, 3)).astype(np.float32)
    want = np.asarray(jmat.resolve_mix(js, jnp.asarray(mat), jnp.asarray(p), jnp.asarray(wo)))
    got = tmat.resolve_mix(ts, torch.as_tensor(mat).long(), torch.as_tensor(p),
                           torch.as_tensor(wo)).numpy()
    np.testing.assert_array_equal(got, want)
    is_mix = np.asarray(js.mat_type)[np.maximum(mat, 0)] == tbd.MAT_MIX
    m1, m2 = int(ts.mat_mix_m1[M - 1]), int(ts.mat_mix_m2[M - 1])
    assert set(got[is_mix & (mat >= 0)].tolist()) == {m1, m2}


def test_differentials_match_jax(twins):
    """pixel_ray_deltas (the compiled cam_ray_deltas, test_tables_match_jax),
    approximate_dp_dxy and duv_dxy on random hits."""
    js, _, ts, _ = twins
    g = np.random.default_rng(5)
    n = 2000

    def unit(k):
        v = g.normal(size=(k, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    p, nrm, o, d = (g.uniform(-3, 3, (n, 3)).astype(np.float32), unit(n),
                    g.uniform(-1, 1, (n, 3)).astype(np.float32), unit(n))
    dpdu, dpdv = g.normal(size=(n, 3)).astype(np.float32), g.normal(size=(n, 3)).astype(
        np.float32)
    dpdv[:10] = 2 * dpdu[:10]  # degenerate parameterizations
    jd = tuple(js.cam_ray_deltas[i] for i in range(4))
    td = tuple(ts.cam_ray_deltas[i] for i in range(4))
    for spp in (1, 16, 100):
        want = jdif.approximate_dp_dxy(*map(jnp.asarray, (p, nrm, o, d)), jd, spp)
        got = tdif.approximate_dp_dxy(*map(torch.as_tensor, (p, nrm, o, d)), td, spp)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    want = jdif.duv_dxy(*map(jnp.asarray, (p, o, dpdu, dpdv)))
    got = tdif.duv_dxy(*map(torch.as_tensor, (p, o, dpdu, dpdv)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
    assert all(float(torch.abs(x[:10]).max()) == 0.0 for x in got)


@pytest.mark.parametrize("footprints", [False, True])
def test_make_bsdf_textured_slots_match_jax(twins, footprints):
    """make_bsdf with uv, p (and footprints) on every material: the BxDF
    parameters the textured slots reach (reflectance, transmittance, alpha,
    the reflectance-mode conductor's k), and the layer of the textured
    coateddiffuse."""
    js, _, ts, tm = twins
    L = _lanes(6, footprints)
    M = ts.mat_type.shape[0]
    mat = np.random.default_rng(6).integers(0, M - 1, R).astype(np.int32)  # the mix row last
    jwl = jsampled.Wavelengths(lam=jnp.asarray(L["lam"]), pdf=jnp.ones((R, 4)))
    twl = tsampled.Wavelengths(lam=torch.as_tensor(L["lam"]), pdf=torch.ones((R, 4)))
    jb, _ = jmat.make_bsdf(js, jnp.asarray(mat), jnp.asarray(L["ns"]), jwl, jnp.asarray(L["uv"]),
                           jnp.asarray(L["p"]),
                           duv=None if L["duv"] is None else jnp.asarray(L["duv"]))
    tb, _ = tmat.make_bsdf(ts, torch.as_tensor(mat).long(), torch.as_tensor(L["ns"]), twl,
                           tm.layered, uv=torch.as_tensor(L["uv"]), p=torch.as_tensor(L["p"]),
                           duv=None if L["duv"] is None else torch.as_tensor(L["duv"]))
    np.testing.assert_array_equal(tb.params.kind.numpy(), np.asarray(jb.params.kind))
    for f in ("refl", "trans", "ax", "ay", "eta_im", "eta"):
        assert _far(getattr(tb.params, f), getattr(jb.params, f)) <= FAR_FRAC, f
    # the coated kinds' layer takes the textured reflectance and transmittance
    assert tm.layered and tb.lay is not None
    for side in ("top", "bottom"):
        for f in ("refl", "trans", "ax", "ay"):
            assert _far(getattr(getattr(tb.lay, side), f), getattr(getattr(jb.lay, side), f)) \
                <= FAR_FRAC, (side, f)
    textured = np.asarray(js.mat_refl_tex)[mat] >= 0
    assert textured.mean() > 0.5


def test_eval_lanes_plain_contract(twins):
    """K13's plain version: the mix resolved on every lane, the slots
    evaluated on the lanes asked for (mask bits of the nodes >= 0), none on
    the others; its values are make_bsdf's overrides."""
    _, _, ts, _ = twins
    L = tc.synthetic_lanes(ts, 5000, 2, footprints=True)
    out = ttx.eval_lanes_plain(ts, L["lanes"], L["mat"], L["p"], L["wo"], L["uv"], L["ns"],
                               L["lam"], L["duv"])
    assert torch.equal(out.mat, tmat.resolve_mix(ts, L["mat"], L["p"], L["wo"]))
    m = torch.clamp(out.mat, min=0)
    want = sum(((getattr(ts, f"mat_{k}_tex")[m] >= 0) & L["lanes"]).to(torch.uint8) * bit
               for bit, k in ((1, "refl"), (2, "trans"), (4, "urough"), (8, "vrough")))
    assert torch.equal(out.mask, want) and bool((out.mask == 15).any() or (out.mask > 4).any())
    assert not bool(out.mask[~L["lanes"]].any())
    refl, trans, ur, vr, _ = ttx.slot_values(ts, m, L["uv"], L["ns"], L["lam"], L["p"],
                                             L["duv"])
    sel = (out.mask & 1) != 0
    assert torch.equal(out.refl[sel], refl[sel]) and float(out.refl[sel].max()) <= 1.0


def test_kernel_wrapper_refuses_cpu_tensors(twins):
    """K13's wrapper launches on CUDA tensors or raises: eval_lanes takes
    the plain version only because the tensors lie on the CPU."""
    _, _, ts, _ = twins
    L = tc.synthetic_lanes(ts, 64, 1)
    args = (ts, L["lanes"], L["mat"], L["p"], L["wo"], L["uv"], L["ns"], L["lam"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttx.eval_lanes_cuda(*args)
    assert torch.equal(ttx.eval_lanes(*args).mask, ttx.eval_lanes_plain(*args).mask)


def test_hit_record_uv_derivatives(tmp_path):
    """dispatch.intersect assembles dpdu and dpdv only when asked (the
    record itself the same): on the BVH route the hit triangle's tri_rec
    columns 21:27 (compiled equal to the JAX package's tri_rec,
    tests/test_torch_scene.py), which equal the triangle's partial
    derivatives solved from its vertices and uv in float64; zeros on a
    miss."""
    from pbrt_tpu_torch.accel import bvh, dispatch as tdispatch
    from pbrt_tpu_torch.scene import testscenes as tts

    tb = tts.textured_cornell_mesh_builder(levels=2, image_dir=tmp_path, res=8, spp=1)
    ta, tm = compile_arrays(tb)
    ts, _ = scene_from_arrays(ta, tm, "cpu")
    assert ts.bvh_rows.shape[0] > 0
    # camera rays (the camera sits at the render-space origin) into the box
    g = np.random.default_rng(8)
    d = g.normal([0, -0.05, 1], 0.08, (512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    args = tuple(map(torch.as_tensor, (np.zeros((512, 3), np.float32), d,
                                       np.full(512, 1e30, np.float32))))
    plain = tdispatch.intersect(ts, tm, *args)
    hit, dpdu, dpdv = tdispatch.intersect(ts, tm, *args, derivatives=True)
    assert all(torch.equal(x, y) for x, y in zip(plain, hit))
    assert float(hit.valid.float().mean()) > 0.9
    prim = torch.clamp(bvh.closest_hit_tris(ts, tm, *args).prim, min=0)
    rec = ts.tri_rec[prim]
    v = hit.valid[:, None]
    assert torch.equal(dpdu, torch.where(v, rec[:, 21:24], 0.0))
    assert torch.equal(dpdv, torch.where(v, rec[:, 24:27], 0.0))
    P = torch.stack([ts.tri_p0, ts.tri_p1, ts.tri_p2], 1)[prim].double().numpy()
    UV = torch.stack([ts.tri_uv0, ts.tri_uv1, ts.tri_uv2], 1)[prim].double().numpy()
    dp1, dp2, du1, du2 = P[:, 1] - P[:, 0], P[:, 2] - P[:, 0], UV[:, 1] - UV[:, 0], UV[:, 2] - \
        UV[:, 0]
    det = du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]
    ok = hit.valid.numpy() & (np.abs(det) > 1e-12)
    want_u = (du2[:, 1:2] * dp1 - du1[:, 1:2] * dp2) / np.where(ok, det, 1.0)[:, None]
    np.testing.assert_allclose(dpdu.numpy()[ok], want_u[ok], rtol=1e-5, atol=1e-3)
    assert float(torch.abs(dpdu).max()) > 0


PARSED = {
    "texture": 'Texture "t" "spectrum" "checkerboard"\nMaterial "diffuse" "texture reflectance" '
               '["t"]',
    "named material": 'MakeNamedMaterial "a" "string type" ["diffuse"]\nNamedMaterial "a"',
    "mix material": 'MakeNamedMaterial "a" "string type" ["diffuse"]\n'
                    'MakeNamedMaterial "b" "string type" ["conductor"]\n'
                    'Material "mix" "string materials" ["a" "b"] "float amount" [0.3]',
    "textured parameter": 'Texture "r" "float" "constant"\n'
                          'Material "conductor" "texture roughness" ["r"]',
}


@pytest.mark.parametrize("what", sorted(PARSED))
def test_textures_mix_and_named_materials_parse(what):
    """Texture, textured parameters, mix and named materials parse and
    compile, as in the JAX package; the scene is textured."""
    b = tbd.SceneBuilder()
    b.parse_tokens(tlx.tokenize("WorldBegin\n" + PARSED[what]))
    arrays, meta = compile_arrays(b)
    assert meta.textured == (what != "named material")
    if what == "mix material":
        assert arrays["mat_type"][-1] == tbd.MAT_MIX and arrays["mat_mix_amount"][-1] == \
            np.float32(0.3)


def test_unported_builder_constructs_name_their_slices():
    """An image infinite light still raises, naming its slice; no message of
    the builder names the textures slice any more."""
    b = tbd.SceneBuilder()
    with pytest.raises(NotImplementedError, match="planned slice: image infinite light"):
        b.parse_tokens(tlx.tokenize('WorldBegin\nLightSource "infinite" "string filename" '
                                    '["sky.exr"]'))
    src = Path(tbd.__file__).read_text()
    slices = set(re.findall(r'_later\([^)]*?"([^"]+)"\)', src))
    assert slices == {"AOV", "lights", "image infinite light", "filters"}, slices
    assert "textures" not in " ".join(re.findall(r"_later\(.*", src))


@pytest.mark.parametrize("text,match", [
    ('Material "mix" "string materials" ["i" "d"]', "material-less interface"),
    ('Material "mix" "string materials" ["d" "m"]', "another mix"),
    ('Texture "r" "float" "constant"\nMaterial "coateddiffuse" "texture thickness" ["r"]',
     "thickness"),
])
def test_builder_refuses_what_the_kernels_do_not_cover(text, match):
    """A mix of an interface or of a mix, and a texture bound to a parameter
    that the JAX package reads as a constant, raise ValueError."""
    b = tbd.SceneBuilder()
    head = ('MakeNamedMaterial "i" "string type" ["interface"]\n'
            'MakeNamedMaterial "d" "string type" ["diffuse"]\n'
            'MakeNamedMaterial "m" "string type" ["mix"] "string materials" ["d" "d"]\n')
    with pytest.raises(ValueError, match=match):
        b.parse_tokens(tlx.tokenize("WorldBegin\n" + head + text))


def test_dense_route_textured_frames(tmp_path):
    """texture_cases' scene (44 triangles: the dense route) renders with the
    path integrator and BDPT on the CPU at 8^2 x 2: finite, the two
    estimates within 15 %."""
    from pbrt_tpu_torch.integrators.render import render
    from pbrt_tpu_torch.scene.compile import compile_scene

    b = tbd.SceneBuilder()
    b.parse_tokens(tlx.tokenize(tc.scene_text(tmp_path)))
    b.film["xresolution"] = b.film["yresolution"] = 8
    means = []
    for integ in ("path", "bdpt"):
        scene, meta = compile_scene(b, device="cpu", integrator_override=integ)
        assert meta.textured and scene.bvh_rows.shape[0] == 0
        img = render(scene, meta, device="cpu")
        assert bool(torch.isfinite(img).all())
        means.append(float(img.mean()))
    assert abs(means[1] - means[0]) < 0.15 * means[0], means


def test_bdpt_walk_evaluates_textures_through_the_kernel_wrapper(tmp_path, monkeypatch):
    """BDPT's walk takes its mix choices and textured slots from
    textures.eval_lanes (K13 on CUDA tensors), once a walk step: 2 max_depth
    + 1 calls a wave."""
    from pbrt_tpu_torch.integrators import render as trd
    from pbrt_tpu_torch.scene.compile import compile_scene

    b = tbd.SceneBuilder()
    b.parse_tokens(tlx.tokenize(tc.scene_text(tmp_path)))
    b.film["xresolution"] = b.film["yresolution"] = 4
    scene, meta = compile_scene(b, 1, device="cpu", integrator_override="bdpt")
    calls = []
    orig = ttx.eval_lanes

    def counted(*a, **k):
        calls.append(a[2].shape[0])
        return orig(*a, **k)

    monkeypatch.setattr(ttx, "eval_lanes", counted)
    img = trd.render(scene, meta, device="cpu")
    assert bool(torch.isfinite(img).all())
    waves = sum(1 for _ in trd.wave_lanes(16, 1, "cpu"))
    assert calls == [16] * ((2 * meta.max_depth + 1) * waves)


def test_tex_work_reads_each_texel_and_rgb2spec_row_once(twins):
    """K13's byte count takes the distinct texels and rgb2spec rows a launch
    reads: the same lanes twice over add only their per-lane bytes."""
    from pbrt_tpu_torch.spectral.rgb2spec import RES

    _, _, ts, _ = twins
    for footprints in (False, True):
        L = tc.synthetic_lanes(ts, 512, 4, footprints)
        two = {k: (None if v is None else torch.cat([v, v])) for k, v in L.items()}
        works = []
        for x in (L, two):
            out = ttx.eval_lanes_plain(ts, x["lanes"], x["mat"], x["p"], x["wo"], x["uv"],
                                       x["ns"], x["lam"], x["duv"])
            works.append(tc.tex_work(ts, x["lanes"], x["mat"], out, x["uv"], x["p"], x["duv"]))
        (b1, o1), (b2, o2) = works
        table = (ts.tex.type.shape[0] * ttx.NODE_F + ts.mat_type.shape[0] * ttx.MATT_F) * 4
        shared_max = ts.tex.imgs.data.shape[0] * 12 + 3 * RES ** 3 * 12 + RES * 4
        assert o2 == 2 * o1
        # doubling adds the per-lane bytes b2 - b1 only; the rest of b1 is
        # the tables and the distinct texels and rgb2spec rows
        assert 0 < b1 - (b2 - b1) - table <= shared_max
