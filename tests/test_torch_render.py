"""The slices end to end on the CPU: pbrt_tpu_torch renders cornell-mesh
(levels 3, BVH), the plain cornell box (dense triangles and spheres),
caustic-glass with the path integrator (a disk light, BK7 glass) and the
terrain height field (open scene: wavefront loop, distant and uniform
infinite lights) through its normal entry points, and must reproduce the
JAX package's committed goldens and live JAX renders of the same scenes
under tests/test_parity.py's image criterion, with the same honest ray
counts; without a card the entry points refuse to run unless asked for the
CPU."""
import pathlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import render as jrender
from pbrt_tpu.scene import builder as jbd, lexer as jlx, testscenes as jts
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch import cli
from pbrt_tpu_torch.integrators.render import render
from pbrt_tpu_torch.scene import testscenes as tts
from pbrt_tpu_torch.scene.compile import compile_scene, load_scene

torch.set_num_threads(2)
GOLDENS = pathlib.Path(__file__).parent / "goldens.npz"


def _check(img, golden, name, atol=5e-3, rtol=0.05):
    """tests/test_parity.py::_check: per-pixel relative-with-floor error on
    fewer than 0.5 % of pixels, and the image mean within 1 %."""
    assert np.isfinite(img).all(), name
    err = np.abs(img - golden)
    tol = atol + rtol * np.abs(golden)
    frac_bad = float((err > tol).mean())
    assert frac_bad < 0.005, (name, frac_bad, float(err.max()))
    assert abs(img.mean() - golden.mean()) < 0.01 * max(golden.mean(), 1e-3), name


def test_cpu_render_matches_golden():
    scene, meta = compile_scene(tts.cornell_mesh_builder(levels=3, res=48, filter_kind="box"),
                                spp_override=4, device="cpu")
    assert scene.bvh_rows.shape[0] > 0
    img = render(scene, meta, device="cpu").numpy()
    assert img.shape == (48, 48, 3)
    _check(img, np.load(GOLDENS)["cornell_mesh_l3_48_spp4"], "cornell_mesh")


def test_cpu_dense_render_matches_golden():
    """The plain cornell box (12 triangles, 2 spheres: K3 and K4's plain
    versions) at 64^2 x 8 spp, box filter: the JAX package's golden."""
    scene, meta = tts.cornell(res=64, spp=8, device="cpu", filter_kind="box")
    assert scene.bvh_rows.shape[0] == 0 and meta.n_spheres == 2
    img = render(scene, meta, device="cpu").numpy()
    _check(img, np.load(GOLDENS)["cornell_path_64_spp8"], "cornell_path")


def _jax_render(b, spp):
    """A live JAX render of builder b through its batched loop -> (image,
    honest ray count)."""
    js, jm = j_compile(b, spp_override=spp)
    res_x, res_y = jm.resolution
    film, n_rays = jrender.render_spp_fused(
        js, jfilm.new_film(jm.resolution), jnp.arange(res_x * res_y, dtype=jnp.int32), 0,
        n_spp=spp, lanes_spp=spp, max_depth=jm.max_depth, use_lens=False, res_x=res_x,
        sampler_kind=jm.sampler, spp=spp, filter_kind=jm.filter_kind, env_ids=(),
        volumetric=False, footprints=False)
    return np.asarray(jfilm.develop(film, jm.resolution, out_matrix=jm.film_out_matrix,
                                    imaging_ratio=jm.film_imaging_ratio)), float(n_rays)


def _scene_text(name, tmp_path):
    if name == "cornell":
        return jts.CORNELL_PBRT, "box"
    if name == "caustic-glass":
        text = (pathlib.Path(__file__).parent.parent / "scenes" / "caustic-glass.pbrt").read_text()
        return text.replace('Integrator "bdpt"', 'Integrator "path"'), "box"
    return tts.terrain_pbrt(tts.terrain_ply_path(16, tmp_path)), "mitchell"


@pytest.mark.parametrize("name", ["cornell", "caustic-glass", "terrain"])
def test_cpu_scene_render_matches_live_jax_render(name, tmp_path, monkeypatch):
    """cornell (dense K3/K4), caustic-glass (disk light, spectral eta) and
    terrain n=16 (450 triangles, BVH, wavefront loop through a pool of 256
    lanes for 4,096 work items) at 32^2 x 4 against JAX, with JAX's exact
    honest ray count."""
    from pbrt_tpu_torch.integrators import render as rd
    from pbrt_tpu_torch.scene import builder as tbd, lexer as tlx

    text, filt = _scene_text(name, tmp_path)
    res, spp = 32, 4
    builders = []
    for bd_, lx_ in ((jbd, jlx), (tbd, tlx)):
        b = bd_.SceneBuilder()
        b.parse_tokens(lx_.tokenize(text))
        b.film["xresolution"] = b.film["yresolution"] = res
        b.filter = {"type": filt}
        builders.append(b)
    want, n_jax = _jax_render(builders[0], spp)
    scene, meta = compile_scene(builders[1], spp_override=spp, device="cpu")
    assert meta.open_scene == (name == "terrain")
    monkeypatch.setattr(rd, "POOL_LANES", 256)
    img, stats = render(scene, meta, device="cpu", return_stats=True)
    _check(img.numpy(), want, name)
    assert stats["closest"] + stats["shadow"] == n_jax


@pytest.mark.parametrize("sampler,filt", [("independent", "box"), ("stratified", "mitchell")])
def test_cpu_render_matches_live_jax_render(sampler, filt):
    res, spp = 24, 4 if sampler == "stratified" else 2
    b = jbd.SceneBuilder()
    b.parse_tokens(jlx.tokenize(jts.cornell_mesh_pbrt(levels=3)))
    b.film["xresolution"] = b.film["yresolution"] = res
    b.filter = {"type": filt}
    b.sampler["type"] = sampler
    js, jm = j_compile(b, spp_override=spp)
    film, n_rays = jrender.render_spp_fused(
        js, jfilm.new_film(jm.resolution), jnp.arange(res * res, dtype=jnp.int32), 0,
        n_spp=spp, lanes_spp=spp, max_depth=jm.max_depth, use_lens=False, res_x=res,
        sampler_kind=jm.sampler, spp=spp, filter_kind=jm.filter_kind, env_ids=(),
        volumetric=False, footprints=False)
    want = np.asarray(jfilm.develop(film, jm.resolution, out_matrix=jm.film_out_matrix,
                                    imaging_ratio=jm.film_imaging_ratio))
    tb = tts.cornell_mesh_builder(levels=3, res=res, filter_kind=filt)
    tb.sampler["type"] = sampler
    scene, meta = compile_scene(tb, spp_override=spp, device="cpu")
    img, stats = render(scene, meta, device="cpu", return_stats=True)
    _check(img.numpy(), want, "live jax render")
    n_port = stats["closest"] + stats["shadow"]
    assert abs(n_port - float(n_rays)) <= 0.01 * float(n_rays), (n_port, float(n_rays))


def test_cli_renders_on_cpu(tmp_path):
    scene_file = tmp_path / "cm.pbrt"
    scene_file.write_text(tts.cornell_mesh_pbrt(levels=1))
    out = tmp_path / "out.png"
    assert cli.main([str(scene_file), "--spp", "1", "--resolution", "8x6",
                     "--outfile", str(out), "--device", "cpu", "--quiet"]) == 0
    from pbrt_tpu_torch.film import png
    assert png.read_png(str(out)).shape == (6, 8, 3)


def test_entry_points_refuse_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None renders on it")
    scene_file = tmp_path / "cm.pbrt"
    scene_file.write_text(tts.cornell_mesh_pbrt(levels=1))
    scene, meta = load_scene(str(scene_file), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render(scene, meta)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_scene(str(scene_file))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(scene_file), "--outfile", str(tmp_path / "x.png"), "--quiet"])


@pytest.mark.parametrize("lanes", [300, 1200])
def test_wave_batching_does_not_change_the_image(monkeypatch, lanes):
    """Streams key on absolute (pixel, sample) ids, so splitting the frame
    into smaller waves (300 lanes: pixel tiles of one sample; 1200: two
    samples per wave) changes only the order of the film sums."""
    from pbrt_tpu_torch.integrators import render as rd

    scene, meta = compile_scene(tts.cornell_mesh_builder(levels=2, res=20, filter_kind="box"),
                                spp_override=4, device="cpu")
    want, st_want = render(scene, meta, device="cpu", return_stats=True)
    monkeypatch.setattr(rd, "LANES_PER_WAVE", lanes)
    got, st_got = render(scene, meta, device="cpu", return_stats=True)
    assert st_got == st_want
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
