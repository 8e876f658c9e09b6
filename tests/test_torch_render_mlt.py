"""MLT end to end on the CPU: pbrt_tpu_torch renders `Integrator
"mltpath"`, "mlt" and "mltbdpt" through mlt.render_mlt, render,
render_to_png and the CLI.

The cornell box at 16^2, max depth 3 (box filter), is rendered with 1024
chains and 32 mutations per pixel (8 passes) by both MLT integrators. The
image mean of an MLT frame is the bootstrap's mean luminance b mapped to
RGB, so its error is the bootstrap's: the luminance of one path sample has
a relative standard deviation of about 6.8 on this scene (path and BDPT
alike), so n_bootstrap = 32768 (mltpath) and 16384 (mltbdpt) give 3.7 %
and 5.2 %; the reference, the port's path render at 256 spp (65,536
samples), adds 2.6 %. The bounds are tests/test_mlt.py's own, 15 % and
20 %, more than 3 standard deviations of the difference either way. The
light's pixels (top rows, centre) must be the brightest region, as there.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import cli
from pbrt_tpu_torch.film import png
from pbrt_tpu_torch.integrators import mlt, render as rd
from pbrt_tpu_torch.scene import builder as tbd, testscenes as tts
from pbrt_tpu_torch.scene.compile import compile_scene, load_scene

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).parent.parent
RES, DEPTH, CHAINS, MUTATIONS = 16, 3, 1024, 32
BOUND = {"mltpath": 0.15, "mltbdpt": 0.20}
BOOTSTRAP = {"mltpath": 32768, "mltbdpt": 16384}


@pytest.fixture(scope="module")
def path_mean():
    scene, meta = tts.cornell(res=RES, spp=256, device="cpu", filter_kind="box")
    img = rd.render(scene, dataclasses.replace(meta, max_depth=DEPTH), device="cpu")
    return float(img.mean())


@pytest.mark.parametrize("integrator", ["mltpath", "mltbdpt"])
def test_mlt_render_matches_path_mean(integrator, path_mean):
    scene, meta = tts.cornell(res=RES, spp=1, device="cpu", filter_kind="box",
                              integrator=integrator)
    meta = dataclasses.replace(meta, max_depth=DEPTH, mutations_per_pixel=MUTATIONS)
    img, heat, stats = mlt.render_mlt(scene, meta, n_chains=CHAINS,
                                      n_bootstrap=BOOTSTRAP[integrator], device="cpu",
                                      return_heatmap=True)
    img = img.numpy()
    n_passes = MUTATIONS * RES * RES // CHAINS
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert abs(img.mean() - path_mean) < BOUND[integrator] * path_mean, (img.mean(), path_mean)
    assert img[:3, 6:10].mean() > 2 * img[8:13, 5:11].mean()
    assert tuple(heat.shape) == (RES, RES) and (heat >= 0).all()
    assert float(heat.sum()) <= n_passes * CHAINS * (1 + 1e-6)
    assert stats["mutations"] == n_passes * CHAINS
    assert stats["closest"] > (BOOTSTRAP[integrator] + (n_passes + 1) * CHAINS) // 2
    assert stats["shadow"] > 0


def test_mlt_entry_points(tmp_path):
    """The CLI with --integrator mltpath and --heatmap writes both PNGs;
    render_to_png renders "mlt" from load_scene with the default 8192
    chains; render() returns the mutation count."""
    scene_file = tmp_path / "cornell.pbrt"
    scene_file.write_text(tts.CORNELL_PBRT.replace(
        'Integrator "path" "integer maxdepth" [5]',
        'Integrator "path" "integer maxdepth" [2] "integer mutationsperpixel" [4]'))
    out, heat = tmp_path / "mlt.png", tmp_path / "heat.png"
    assert cli.main([str(scene_file), "--resolution", "16x12", "--integrator", "mltpath",
                     "--heatmap", str(heat), "--outfile", str(out), "--device", "cpu",
                     "--quiet"]) == 0
    assert png.read_png(str(out)).shape == (12, 16, 3)
    h = png.read_png(str(heat))
    assert h.shape == (12, 16, 3) and h.max() == 255 and (h[..., 0] == h[..., 2]).all()

    scene, meta = load_scene(str(scene_file), device="cpu", integrator="mlt")
    assert (meta.integrator, meta.max_depth, meta.mutations_per_pixel) == ("mlt", 2, 4)
    b = tbd.SceneBuilder().parse_file(str(scene_file))
    b.film["xresolution"] = b.film["yresolution"] = 8
    scene, meta = compile_scene(b, device="cpu", integrator_override="mlt")
    p, _, stats = rd.render_to_png(scene, meta, out_path=str(tmp_path / "b.png"), device="cpu",
                                   heatmap_path=str(tmp_path / "bh.png"))
    assert png.read_png(p).shape == (8, 8, 3) and png.read_png(str(tmp_path / "bh.png")).any()
    assert stats["mutations"] == mlt.N_CHAINS and stats["shadow"] > 0


def test_volumetric_caustic_still_raises_for_media():
    """The repo's own MLT scene, which once raised for its media, loads with
    the JAX package's tables: the medium's sigma rows and g, the shapes'
    media, the camera's and the light's medium, volumetric, and MLT over
    BDPT's 16 + 40 (max_depth + 2) = 376 primary samples a chain. (The
    name is kept from when the scene was refused.)"""
    import jax  # noqa: F401  (tests/conftest.py pins JAX to the CPU)
    from pbrt_tpu.scene.compile import load_scene as j_load

    scene, meta = load_scene(str(ROOT / "scenes" / "volumetric-caustic.pbrt"), device="cpu")
    js, jm = j_load(str(ROOT / "scenes" / "volumetric-caustic.pbrt"))
    assert meta.integrator == jm.integrator == "mlt" and meta.volumetric and jm.volumetric
    for k in ("tri_med", "sph_med", "camera_medium", "lt_medium", "med_g"):
        np.testing.assert_array_equal(getattr(scene, k).numpy(), np.asarray(getattr(js, k)), k)
    for k in ("med_sigma_a", "med_sigma_s"):
        np.testing.assert_allclose(getattr(scene, k).numpy(), np.asarray(getattr(js, k)),
                                   rtol=1e-6)
    assert mlt.bdpt_dims(meta) == 376
