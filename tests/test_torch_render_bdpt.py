"""BDPT end to end on the CPU: pbrt_tpu_torch renders with `Integrator
"bdpt"` through compile_scene/load_scene, render, render_to_png and the CLI,
and must reproduce the JAX package's committed BDPT golden and live JAX BDPT
estimates of the same scenes under tests/test_parity.py's image criterion,
with JAX's honest ray count.

The live JAX estimate (`_jax_bdpt`) calls the functions the JAX package's
BDPT render stages (render.py `_camera_sample`, bdpt.py `camera_path`,
`light_path` and `connect` strategy by strategy, film.py `add_samples`,
`add_splats`, `develop` with splat_scale 1 / spp), eagerly and with all
samples of the frame in one batch, and sums the ray counts those functions
return: `li_bdpt_staged`, which `render` runs on the CPU, drops them. JAX
counts in float32, exact below 2^24 rays."""
import pathlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import bdpt as jbdpt, render as jrender
from pbrt_tpu.scene import builder as jbd, lexer as jlx, testscenes as jts
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch import cli
from pbrt_tpu_torch.film import png
from pbrt_tpu_torch.integrators import render as rd
from pbrt_tpu_torch.scene import builder as tbd, lexer as tlx, testscenes as tts
from pbrt_tpu_torch.scene.compile import compile_scene, load_scene

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).parent.parent
GOLDENS = ROOT / "tests" / "goldens.npz"


def _check(img, golden, name, atol=5e-3, rtol=0.05):
    """tests/test_parity.py::_check: per-pixel relative-with-floor error on
    fewer than 0.5 % of pixels, and the image mean within 1 %."""
    assert np.isfinite(img).all(), name
    err = np.abs(img - golden)
    tol = atol + rtol * np.abs(golden)
    frac_bad = float((err > tol).mean())
    assert frac_bad < 0.005, (name, frac_bad, float(err.max()))
    assert abs(img.mean() - golden.mean()) < 0.01 * max(golden.mean(), 1e-3), name


def _builders(text, res):
    """(JAX builder, port builder) of `text` at res^2, box filter."""
    out = []
    for bd_, lx_ in ((jbd, jlx), (tbd, tlx)):
        b = bd_.SceneBuilder()
        b.parse_tokens(lx_.tokenize(text))
        b.film["xresolution"] = b.film["yresolution"] = res
        b.filter = {"type": "box"}
        out.append(b)
    return out


def _jax_bdpt(b, spp):
    """Live JAX BDPT estimate of builder b -> (image, honest ray count)."""
    js, jm = j_compile(b, spp_override=spp, integrator_override="bdpt")
    res_x, res_y = jm.resolution
    n_pix = res_x * res_y
    pix = jnp.tile(jnp.arange(n_pix, dtype=jnp.int32), jm.spp)
    sample = jnp.repeat(jnp.arange(jm.spp, dtype=jnp.int32), n_pix)
    p_film, weight, wl, r = jrender._camera_sample(
        js, pix, sample, res_x=res_x, sampler_kind=jm.sampler, spp=jm.spp,
        filter_kind=jm.filter_kind)
    cam_vs, r, n_cam = jbdpt.camera_path(js, p_film, r, wl, jm.max_depth, jm.sampler, jm.spp)
    light_vs, r, n_light = jbdpt.light_path(js, r, wl, jm.max_depth, jm.sampler, jm.spp)
    n_rays = float(n_cam) + float(n_light)
    L = jnp.zeros((pix.shape[0], 4))
    film = jfilm.new_film(jm.resolution)
    for t in range(1, len(cam_vs) + 1):
        for s in range(0, len(light_vs) + 1):
            depth = s + t - 2
            if (s == 1 and t == 1) or depth < 0 or depth > jm.max_depth or (t == 1 and s < 2):
                continue
            Lst, raster, r, n = jbdpt.connect(js, light_vs, cam_vs, s, t, wl, r, jm.sampler,
                                              jm.spp)
            n_rays += float(n)
            if t == 1:
                px = jnp.clip(raster[..., 0].astype(jnp.int32), 0, res_x - 1)
                py = jnp.clip(raster[..., 1].astype(jnp.int32), 0, res_y - 1)
                film = jfilm.add_splats(film, py * res_x + px, Lst, wl.lam, wl.pdf,
                                        jnp.ones(pix.shape[0]))
            else:
                L = L + Lst
    film = jfilm.add_samples(film, pix, L, wl.lam, wl.pdf, weight)
    img = jfilm.develop(film, jm.resolution, splat_scale=1.0 / jm.spp,
                        out_matrix=jm.film_out_matrix, imaging_ratio=jm.film_imaging_ratio)
    return np.asarray(img), n_rays


def test_cornell_bdpt_matches_golden():
    """The bench config's scene at the golden's size: cornell 24^2 x 8,
    box filter, max depth 5 (dense K3/K4 route; goldens.npz
    cornell_bdpt_24_spp8, the JAX package's parity gate)."""
    scene, meta = compile_scene(tts.cornell_builder(24, "box"), spp_override=8, device="cpu",
                                integrator_override="bdpt")
    assert (meta.integrator, meta.max_depth) == ("bdpt", 5)
    img = rd.render(scene, meta, device="cpu").numpy()
    assert img.shape == (24, 24, 3)
    _check(img, np.load(GOLDENS)["cornell_bdpt_24_spp8"], "cornell_bdpt")


@pytest.mark.parametrize("name", ["cornell", "cornell-mesh", "caustic-glass"])
def test_bdpt_render_matches_live_jax(name):
    """cornell 16^2 x 2 (dense triangles and spheres), cornell-mesh levels 2
    at 12^2 x 2 (the BVH route) and caustic-glass at 16^2 x 4 (disk light,
    glass, max depth 7): the image under _check and the honest ray count
    (walk segments of live lanes plus attempted connections) equal to
    JAX's."""
    if name == "caustic-glass":
        text, res, spp = (ROOT / "scenes" / "caustic-glass.pbrt").read_text(), 16, 4
    elif name == "cornell":
        text, res, spp = jts.CORNELL_PBRT, 16, 2
    else:
        text, res, spp = jts.cornell_mesh_pbrt(levels=2), 12, 2
    jb, tb = _builders(text, res)
    want, n_jax = _jax_bdpt(jb, spp)
    scene, meta = compile_scene(tb, spp_override=spp, device="cpu", integrator_override="bdpt")
    assert (scene.bvh_rows.shape[0] > 0) == (name == "cornell-mesh")
    img, stats = rd.render(scene, meta, device="cpu", return_stats=True)
    _check(img.numpy(), want, name)
    assert stats["closest"] + stats["shadow"] == int(n_jax), (stats, n_jax)
    assert stats["shadow"] > 0


@pytest.mark.parametrize("lanes", [100, 600])
def test_bdpt_wave_batching_does_not_change_the_image(monkeypatch, lanes):
    """Streams key on absolute (pixel, sample) ids, so waves of 100 lanes
    (pixel tiles of one sample) or 600 (two samples a wave, whose splats
    read their lanes' wavelengths row by row) change only the order of the
    film sums."""
    scene, meta = compile_scene(tts.cornell_builder(16, "box"), spp_override=4, device="cpu",
                                integrator_override="bdpt")
    want, st_want = rd.render(scene, meta, device="cpu", return_stats=True)
    monkeypatch.setattr(rd, "LANES_PER_WAVE", lanes)
    got, st_got = rd.render(scene, meta, device="cpu", return_stats=True)
    assert st_got == st_want
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_bdpt_entry_points(tmp_path):
    """load_scene takes the file's own integrator (caustic-glass: bdpt, max
    depth 7); render_to_png and the CLI write its PNG; an MLT override
    compiles with the default 100 mutations per pixel."""
    path = str(ROOT / "scenes" / "caustic-glass.pbrt")
    scene, meta = load_scene(path, device="cpu", spp=1)
    assert (meta.integrator, meta.max_depth) == ("bdpt", 7)
    out = tmp_path / "cli.png"
    assert cli.main([path, "--spp", "1", "--resolution", "8x6", "--outfile", str(out),
                     "--device", "cpu", "--quiet"]) == 0
    assert png.read_png(str(out)).shape == (6, 8, 3)
    b = tbd.SceneBuilder().parse_file(path)
    b.film["xresolution"] = b.film["yresolution"] = 8
    scene, meta = compile_scene(b, spp_override=1, device="cpu")
    p, _, stats = rd.render_to_png(scene, meta, out_path=str(tmp_path / "r.png"), device="cpu")
    assert png.read_png(p).shape == (8, 8, 3) and stats["shadow"] > 0
    for itype in ("mlt", "mltbdpt"):
        _, meta = load_scene(path, device="cpu", integrator=itype)
        assert (meta.integrator, meta.max_depth, meta.mutations_per_pixel) == (itype, 7, 100)
