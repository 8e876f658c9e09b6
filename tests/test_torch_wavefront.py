"""The wavefront loop of the port (K8's plain version and the loop around
it) against pbrt_tpu's lane recycling: the recycle step equals JAX's cumsum
ranks on numpy-seeded masks, and a wavefront render equals the batched
render of the same frame in honest ray count exactly, with no dropped work
item, including a deep queue (8,192 work items through a pool of 64 lanes,
as tests/test_parallel.py::test_wavefront_bound_deep_queue). The images
differ only in the order of the film sums: tests/test_parity.py's _check."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pbrt_tpu_torch.integrators import render as rd
from pbrt_tpu_torch.scene import testscenes as tts
from pbrt_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(2)


def _check(img, ref, name, atol=5e-3, rtol=0.05):
    assert np.isfinite(img).all(), name
    frac_bad = float((np.abs(img - ref) > atol + rtol * np.abs(ref)).mean())
    assert frac_bad < 0.005, (name, frac_bad)
    assert abs(img.mean() - ref.mean()) < 0.01 * max(ref.mean(), 1e-3), name


@pytest.mark.parametrize("density,left", [(0.05, 10 ** 6), (0.6, 10 ** 6), (0.6, 300),
                                          (1.0, 0)])
def test_recycle_step_matches_jax_cumsum(density, left):
    """rank/work/recycle/in_flight of the plain recycle step against the JAX
    loop body (render.py:316-332) on the same masks."""
    R, total = 4096, 10 ** 7
    g = np.random.default_rng(int(density * 100) + left % 977)
    in_flight = g.uniform(size=R) < 0.9
    finished = in_flight & (g.uniform(size=R) < density)
    next_work = total - left
    counters = torch.tensor([next_work, 0], dtype=torch.int64)
    rank, work, recycle, in_flight_new = rd.recycle_plain(
        torch.as_tensor(finished), torch.as_tensor(in_flight), counters, total)

    j_rank = jnp.cumsum(jnp.asarray(finished).astype(jnp.int32)) - 1
    j_work = np.asarray(next_work + j_rank)
    j_recycle = finished & (j_work < total)
    np.testing.assert_array_equal(recycle.numpy(), j_recycle)
    np.testing.assert_array_equal(work.numpy()[finished], j_work[finished])
    np.testing.assert_array_equal(rank.numpy()[finished], np.asarray(j_rank)[finished])
    np.testing.assert_array_equal(in_flight_new.numpy(), (in_flight & ~finished) | j_recycle)
    assert int(counters[0]) == next_work + int(j_recycle.sum())
    assert int(counters[1]) == int(((in_flight & ~finished) | j_recycle).sum())


def _render_both(scene, meta, pool, monkeypatch):
    """The frame through the wavefront loop and through one batched wave ->
    (films, ray counts) of both."""
    monkeypatch.setattr(rd, "POOL_LANES", pool)
    n_pix = meta.resolution[0] * meta.resolution[1]
    film_w = rd.filmlib.new_film(meta.resolution, "cpu")
    st_w, dropped = rd.render_wavefront(scene, meta, film_w)
    assert dropped == 0
    film_b = rd.filmlib.new_film(meta.resolution, "cpu")
    st_b = rd.render_wave(scene, meta, film_b, torch.arange(n_pix).repeat(meta.spp),
                          torch.arange(meta.spp).repeat_interleave(n_pix))
    assert {k: int(v) for k, v in st_w.items()} == {k: int(v) for k, v in st_b.items()}
    np.testing.assert_allclose(float(film_w.weight_sum.sum()), float(film_b.weight_sum.sum()),
                               rtol=1e-5)
    develop = lambda f: rd.filmlib.develop(f, meta.resolution, meta.film_out_matrix,
                                           meta.film_imaging_ratio).numpy()
    return develop(film_w), develop(film_b), {k: int(v) for k, v in st_b.items()}


def test_wavefront_equals_batched_on_terrain(monkeypatch, tmp_path):
    """terrain (n=16) at 16^2 x 4: 1,024 work items through 128 lanes; the
    public entry takes the wavefront loop for this open scene."""
    scene, meta = tts.terrain(res=16, spp=4, n=16, device="cpu", cache_dir=tmp_path)
    assert meta.open_scene
    img_w, img_b, st_b = _render_both(scene, meta, 128, monkeypatch)
    _check(img_w, img_b, "terrain wavefront vs batched")
    n0 = rd.launches["wavefront_recycle"]
    img, st = rd.render(scene, meta, device="cpu", return_stats=True)
    assert st == st_b and rd.launches["wavefront_recycle"] == n0  # plain version on the CPU
    _check(img.numpy(), img_b, "terrain render()")


def test_wavefront_bound_deep_queue(monkeypatch):
    """2,048 work items through 16 lanes, max depth 3: far more refills than
    2 * max_depth; every item scheduled, the same rays and film weight."""
    scene, meta = compile_scene(tts.cornell_mesh_builder(levels=2, res=8), spp_override=32,
                                device="cpu")
    meta.max_depth = 3
    img_w, img_b, _ = _render_both(scene, meta, 16, monkeypatch)
    _check(img_w, img_b, "deep queue wavefront vs batched")
