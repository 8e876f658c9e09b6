"""Textured frames of the port on the CPU against the JAX package's:
scene/testscenes.py's textured cornell-mesh (levels 2: a uv checkerboard
floor, an imagemap back wall, named materials, a mix of a diffuse and a
conductor with an imagemap-scaled roughness, a diffuse transmitter with a
planar checkerboard and a directionmix), its images written from a seed.

The mix material chooses by a hash of the bits of the hit point, which XLA
computes with contracted multiply-adds and torch does not, so the two
packages resolve some hits to the other material and those paths go on
independently (resolve_mix itself is bit-exact on the same inputs:
tests/test_torch_textures.py). So:
  - the path frame is held on 4x4-block means to tests/test_parity.py's
    criterion, its mean to 1 % and its honest ray count to 1 %, from one
    live JAX render;
  - BDPT: both packages' camera subpaths at max depth 1 on the same
    sampler streams, each vertex's type equal on >= 97 % of the lanes and
    its record (point, throughput, pdfs, wo) within 1e-3 on >= 94 %, the
    walk's ray count within 1 % (a JAX BDPT render's compile does not fit
    the test budget, nor does more than one eager JAX walk, ~23 s each; the
    walk, which the light subpath shares, is where textures enter BDPT, and
    K12 reads the vertices' cached BSDF).
The coated case (a coateddiffuse with a textured reflectance) is held to
JAX where the texture enters it, the layer's parameters of make_bsdf
(tests/test_torch_textures.py), and renders here with and without
footprints: a live JAX render of a coated scene costs as much again."""
import numpy as np
import torch
import jax.numpy as jnp

from layered_cases import blocks
from test_torch_render import _check
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import bdpt as jbdpt, render as jrender
from pbrt_tpu.scene import builder as jbd, lexer as jlx
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch.integrators import bdpt as tbdpt, render as trender
from pbrt_tpu_torch.scene import builder as tbd, lexer as tlx, testscenes as tts
from pbrt_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(2)
TYPE_FRAC, RECORD_FRAC = 0.97, 0.94


def _builders(text, max_depth):
    out = []
    for bd_, lx_ in ((jbd, jlx), (tbd, tlx)):
        b = bd_.SceneBuilder()
        b.parse_tokens(lx_.tokenize(text))
        b.filter = {"type": "box"}
        b.integrator["maxdepth"] = max_depth
        out.append(b)
    return out


def test_textured_frame_matches_jax(tmp_path):
    """24^2 x 4 spp, max depth 3, through render() and JAX's
    render_spp_fused."""
    res, spp = 24, 4
    text = tts.textured_cornell_mesh_pbrt(levels=2, image_dir=tmp_path, res=res, spp=spp)
    jb, tb = _builders(text, 3)
    js, jm = j_compile(jb, spp_override=spp)
    film, n_rays = jrender.render_spp_fused(
        js, jfilm.new_film(jm.resolution), jnp.arange(res * res, dtype=jnp.int32), 0,
        n_spp=spp, lanes_spp=spp, max_depth=jm.max_depth, use_lens=False, res_x=res,
        sampler_kind=jm.sampler, spp=spp, filter_kind=jm.filter_kind, env_ids=(),
        volumetric=False, footprints=False)
    want = np.asarray(jfilm.develop(film, jm.resolution, out_matrix=jm.film_out_matrix,
                                    imaging_ratio=jm.film_imaging_ratio))
    scene, meta = compile_scene(tb, spp_override=spp, device="cpu")
    assert meta.textured
    img, stats = trender.render(scene, meta, device="cpu", return_stats=True)
    img = img.numpy()
    assert img.shape == want.shape and np.isfinite(img).all()
    _check(blocks(img, 4), blocks(want, 4), "textured cornell-mesh")
    assert abs(img.mean() - want.mean()) < 0.01 * want.mean()
    n_port = stats["closest"] + stats["shadow"]
    assert abs(n_port - float(n_rays)) <= 0.01 * float(n_rays), (n_port, float(n_rays))
    # footprints: the same frame with image lookups over the uv footprint,
    # finite and within a few percent of the point-sampled one
    img_fp = trender.render(scene, meta, device="cpu", footprints=True).numpy()
    assert np.isfinite(img_fp).all() and abs(img_fp.mean() - img.mean()) < 0.05 * img.mean()


def test_textured_coated_frame_renders(tmp_path):
    """The coated variant (the floor a coateddiffuse over the checkerboard:
    K7's layer takes the textured reflectance), path and BDPT, finite, the
    two estimates within 10 % on an 8^2 x 4 frame; with footprints too."""
    b = tts.textured_cornell_mesh_builder(levels=1, image_dir=tmp_path, res=8, spp=4,
                                          coated=True)
    b.integrator["maxdepth"] = 3
    means = []
    for integ in ("path", "bdpt"):
        scene, meta = compile_scene(b, device="cpu", integrator_override=integ)
        assert meta.textured and meta.layered
        img = trender.render(scene, meta, device="cpu", footprints=integ == "path").numpy()
        assert np.isfinite(img).all() and img.mean() > 0
        means.append(img.mean())
    assert abs(means[1] - means[0]) < 0.1 * means[0], means


def _lanes_close(got, want, rtol=1e-3):
    got = got.numpy().astype(np.float64).reshape(got.shape[0], -1)
    want = np.asarray(want, np.float64).reshape(want.shape[0], -1)
    floor = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    return (np.abs(got - want) <= rtol * np.abs(want) + floor).all(axis=1)


def test_textured_bdpt_subpaths_match_jax(tmp_path):
    """The camera walks of 16^2 lanes of sample 1, max depth 1."""
    res = 16
    text = tts.textured_cornell_mesh_pbrt(levels=2, image_dir=tmp_path, res=res, spp=1)
    jb, tb = _builders(text, 1)
    ja, jm = j_compile(jb)
    ts, tm = compile_scene(tb, device="cpu", integrator_override="bdpt")
    assert tm.textured
    n = res * res
    jp_film, _, jwl, jr = jrender._camera_sample(
        ja, jnp.arange(n, dtype=jnp.int32), 1, res_x=res, sampler_kind=jm.sampler, spp=jm.spp,
        filter_kind=jm.filter_kind)
    pix = torch.arange(n)
    tp_film, twl, tr, _ = trender.film_samples(ts, tm, pix, torch.ones_like(pix))
    j_cam, jr, jn_cam = jbdpt.camera_path(ja, jp_film, jr, jwl, jm.max_depth, jm.sampler,
                                          jm.spp)
    t_cam, tr, tn_cam = tbdpt.camera_path(ts, tm, tp_film, tr, twl, tm.sampler, tm.spp)
    assert len(j_cam) == len(t_cam)
    for jv, tv in zip(j_cam, t_cam):
        same_type = tv.vtype.numpy() == np.asarray(jv.vtype)
        assert same_type.mean() >= TYPE_FRAC
        ok = same_type.copy()
        for f in ("p", "beta", "pdf_fwd", "pdf_rev", "wo"):
            ok &= _lanes_close(getattr(tv, f), getattr(jv, f))
        assert ok.mean() >= RECORD_FRAC, float(ok.mean())
    assert abs(int(tn_cam) - float(jn_cam)) <= 0.01 * float(jn_cam)
    # the walk reached textured surfaces, mix materials among them
    mats = torch.cat([v.mat[v.mat >= 0] for v in t_cam])
    assert bool((ts.mat_refl_tex[mats] >= 0).any()) and bool(
        (ts.mat_type[mats] == tbd.MAT_MIX).any())
