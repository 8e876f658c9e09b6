"""Multi-process rendering of the port on the CPU: two gloo ranks
(tests/parallel_cases.py, spawned processes that never load JAX) render
the path family split by pixels (cornell-mesh through the batched loop,
terrain n = 16 through the wavefront loop) and with the geometry split
into 2 parts over the 2 ranks, and must give the single-process films,
images and exact ray counts; one live JAX scene-sharded render (8 virtual
devices) holds the frame under tests/test_parity.py's criterion; the CLI's
--shard-scene writes its PNG."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import parallel_cases as pc
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.integrators import render as jrender
from pbrt_tpu.parallel.scene_shard import build_scene_shard as j_build_scene_shard
from pbrt_tpu.scene import testscenes as jts
from pbrt_tpu_torch import cli
from pbrt_tpu_torch.film import film as filmlib
from pbrt_tpu_torch.integrators import render as rd
from pbrt_tpu_torch.scene import testscenes as tts

torch.set_num_threads(2)


def _check(img, golden, name, atol=5e-3, rtol=0.05):
    """tests/test_parity.py::_check."""
    assert np.isfinite(img).all(), name
    err = np.abs(img - golden)
    tol = atol + rtol * np.abs(golden)
    frac_bad = float((err > tol).mean())
    assert frac_bad < 0.005, (name, frac_bad, float(err.max()))
    assert abs(img.mean() - golden.mean()) < 0.01 * max(golden.mean(), 1e-3), name


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of every case in parallel_cases.CASES, from one
    spawn of two gloo processes."""
    return pc.run_ranks(2, tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """Every case rendered by this process alone (no process group)."""
    old = rd.POOL_LANES
    rd.POOL_LANES = pc.TERRAIN_POOL
    try:
        return {case: pc.render_case(case, tmp_path_factory.mktemp(case))
                for case in pc.CASES}
    finally:
        rd.POOL_LANES = old


@pytest.mark.parametrize("case", ["cornell-mesh", "terrain"])
def test_pixel_parallel_matches_single_process(ranks, single, case):
    """Rank r renders pixels [r n / 2, (r + 1) n / 2) with all samples; the
    all-reduced films agree with one process's within 1e-5 and the ray
    counts exactly, on both ranks (terrain: wavefront pools of 1024 lanes a
    rank for 2048 work items, so lanes recycle)."""
    want = single[case]
    for got in ranks:
        np.testing.assert_allclose(got[f"{case}/rgb_sum"], want["rgb_sum"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got[f"{case}/weight_sum"], want["weight_sum"], rtol=1e-5,
                                   atol=1e-6)
        assert int(got[f"{case}/film_rays"]) == int(want["film_rays"]) > 0
        assert int(got[f"{case}/dropped"]) == 0
        np.testing.assert_allclose(got[f"{case}/img"], want["img"], rtol=1e-5, atol=1e-6)
        for k in ("closest", "shadow"):
            assert int(got[f"{case}/{k}"]) == int(want[k])


def test_scene_sharded_ranks_match_unsharded(ranks, single):
    """2 ranks x 1 part each (all_gather of the candidate packs, select,
    all_reduce of the shadow bits) against this process's unsharded render
    of the frame: same ray counts, same image, on both ranks."""
    want = single["cornell-mesh"]
    for got in ranks:
        for k in ("closest", "shadow"):
            assert int(got[f"sharded/{k}"]) == int(want[k])
        np.testing.assert_allclose(got["sharded/img"], want["img"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(single["sharded"]["img"], want["img"], rtol=1e-5, atol=1e-6)


def test_frame_matches_live_jax_scene_sharded_render(single):
    """The JAX package's scene-sharded render of the same frame over 8
    virtual devices (render_spp_fused_scene_sharded): JAX's exact ray count
    and the image criterion."""
    js, jm = jts.cornell_mesh(res=pc.RES, spp=pc.SPP, levels=3)
    n_pix = pc.RES * pc.RES
    film, n_rays = jrender.render_spp_fused_scene_sharded(
        js, j_build_scene_shard(js, 8), jfilm.new_film(jm.resolution),
        jnp.arange(n_pix, dtype=jnp.int32), 0, devices=jax.devices()[:8], n_spp=pc.SPP,
        lanes_spp=1, max_depth=pc.DEPTH, use_lens=False, res_x=pc.RES,
        sampler_kind=jm.sampler, spp=pc.SPP, filter_kind=jm.filter_kind, env_ids=(),
        volumetric=False)
    want = np.asarray(jfilm.develop(film, jm.resolution, out_matrix=jm.film_out_matrix,
                                    imaging_ratio=jm.film_imaging_ratio))
    got = single["sharded"]
    assert int(got["closest"]) + int(got["shadow"]) == float(n_rays)
    _check(got["img"], want, "scene-sharded cornell-mesh")


def test_wave_lanes_cover_a_pixel_range():
    """wave_lanes(n, spp, pix0) yields every (pixel, sample) of pixels pix0
    .. pix0 + n - 1 once, also when the range is wider than a wave."""
    old = rd.LANES_PER_WAVE
    rd.LANES_PER_WAVE = 48
    try:
        for n, spp in ((20, 5), (100, 3)):
            pairs = [(int(p), int(s)) for ids, sids in rd.wave_lanes(n, spp, "cpu", pix0=7)
                     for p, s in zip(ids, sids)]
            assert sorted(pairs) == [(p, s) for p in range(7, 7 + n) for s in range(spp)]
    finally:
        rd.LANES_PER_WAVE = old


def test_render_pixel_parallel_without_a_group_renders_the_frame():
    scene, meta = pc.cornell_mesh()
    meta = dataclasses.replace(meta, spp=1)
    film = filmlib.new_film(meta.resolution, "cpu")
    stats, dropped = rd.render_pixel_parallel(scene, meta, film)
    assert dropped == 0 and bool((film.weight_sum != 0).all())
    assert int(stats["closest"]) >= pc.RES * pc.RES


def test_cli_shard_scene_writes_png(tmp_path):
    scene_file = tmp_path / "cornell-mesh.pbrt"
    scene_file.write_text(tts.cornell_mesh_pbrt(levels=3))
    out = tmp_path / "out.png"
    assert cli.main([str(scene_file), "--spp", "1", "--resolution", "16x16", "--outfile",
                     str(out), "--shard-scene", "4", "--device", "cpu", "--quiet"]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_scene_sharding_refuses_other_integrators():
    scene, meta = tts.cornell_mesh(res=8, spp=1, levels=3, device="cpu", integrator="bdpt")
    with pytest.raises(ValueError, match="path family"):
        rd.render(scene, meta, device="cpu", shard_parts=2)
