"""pbrt_tpu_torch film (K5 and K5s module) vs pbrt_tpu.film.

On the CPU `add_samples` and `add_splats` run the Triton kernels' plain
versions (the torch op chain plus index_add_). Seeded L/lambda/pdf/weights
with NaN and inf lanes, zero pdfs, signed weights and repeated pixel ids
must accumulate as pbrt_tpu.film.film.add_samples and add_splats do, within
1e-5 relative (summation order); develop (with its 0.25 |weight_sum| clamp
and BDPT's splat term) and to_srgb8 must match. The Triton kernels
themselves are held against the plain versions on the card by
tests/test_torch_gpu.py."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pbrt_tpu.film import film as jfilm
from pbrt_tpu_torch.film import film as tfilm

torch.set_num_threads(2)
RES = (24, 16)


def _samples(seed, n=6000):
    g = np.random.default_rng(seed)
    n_pix = RES[0] * RES[1]
    pix = g.integers(0, n_pix, n).astype(np.int32)
    pix[: n // 4] = g.integers(0, 8, n // 4)          # heavily repeated pixels
    L = (g.random((n, 4)) * 4.0).astype(np.float32)
    lam = (360.0 + 470.0 * g.random((n, 4))).astype(np.float32)
    lam[:8] = [[359.4, 360.5, 829.5, 830.6]] * 8       # bin edges and ties
    pdf = (0.0005 + 0.005 * g.random((n, 4))).astype(np.float32)
    pdf[::29, 2] = 0.0
    L[::31, 1] = np.nan
    L[::37, 3] = np.inf
    w = (g.random(n) * 2.0 - 0.4).astype(np.float32)
    return pix, L, lam, pdf, w


def _both(seed):
    pix, L, lam, pdf, w = _samples(seed)
    jf = jfilm.add_samples(jfilm.new_film(RES), *map(jnp.asarray, (pix, L, lam, pdf, w)))
    tf = tfilm.new_film(RES, "cpu")
    tfilm.add_samples(tf, torch.from_numpy(pix.astype(np.int64)),
                      *map(torch.from_numpy, (L, lam, pdf, w)))
    return jf, tf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_samples_matches_jax(seed):
    jf, tf = _both(seed)
    want = np.asarray(jf.rgb_sum)
    scale = np.abs(want).max()
    np.testing.assert_allclose(tf.rgb_sum.numpy(), want, rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(tf.weight_sum.numpy(), np.asarray(jf.weight_sum),
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(tf.rgb_sum.numpy()).all()


def test_develop_and_clamp_match_jax():
    jf, tf = _both(3)
    # pixels whose |weight_sum| falls below 0.25, both signs, exercise the clamp
    ws = np.asarray(jf.weight_sum).copy()
    ws[:6] = [0.01, -0.02, 0.24, -0.3, 0.0, 0.26]
    jf = jf._replace(weight_sum=jnp.asarray(ws))
    tf = tf._replace(weight_sum=torch.from_numpy(ws))
    m = np.array([[3.24, -1.53, -0.49], [-0.97, 1.87, 0.04], [0.05, -0.2, 1.05]], np.float32)
    want = np.asarray(jfilm.develop(jf, RES, out_matrix=m, imaging_ratio=1.5))
    got = tfilm.develop(tf, RES, out_matrix=m, imaging_ratio=1.5).numpy()
    assert got.shape == (RES[1], RES[0], 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(tfilm.to_srgb8(got / np.abs(got).max()),
                                  jfilm.to_srgb8(jnp.asarray(want / np.abs(want).max())))


@pytest.mark.parametrize("seed", [4, 5])
def test_add_splats_matches_jax(seed):
    """BDPT's t = 1 splats: JAX adds them with weight 1; the port's splats of
    a wave read their wavelengths as row i % n_lam (three strategies'
    splats over one wave's lanes here)."""
    pix, L, lam, pdf, _ = _samples(seed)
    n = pix.shape[0] // 3
    lam, pdf = lam[:n], pdf[:n]
    jf = jfilm.add_splats(jfilm.new_film(RES), jnp.asarray(pix), jnp.asarray(L),
                          jnp.asarray(np.tile(lam, (3, 1))), jnp.asarray(np.tile(pdf, (3, 1))),
                          jnp.ones(pix.shape[0]))
    tf = tfilm.add_splats(tfilm.new_film(RES, "cpu"), torch.from_numpy(pix.astype(np.int64)),
                          *map(torch.from_numpy, (L, lam, pdf)))
    want = np.asarray(jf.splat)
    np.testing.assert_allclose(tf.splat.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    assert float(tf.rgb_sum.abs().sum()) == 0.0 and float(tf.weight_sum.abs().sum()) == 0.0


def test_develop_with_splats_matches_jax():
    """develop adds splat_scale x the splats after the division by the
    clamped weight sum, then the imaging ratio and the output matrix."""
    jf, tf = _both(6)
    pix, L, lam, pdf, _ = _samples(7)
    jf = jfilm.add_splats(jf, *map(jnp.asarray, (pix, L, lam, pdf)), jnp.ones(pix.shape[0]))
    tfilm.add_splats(tf, torch.from_numpy(pix.astype(np.int64)),
                     *map(torch.from_numpy, (L, lam, pdf)))
    m = np.array([[3.24, -1.53, -0.49], [-0.97, 1.87, 0.04], [0.05, -0.2, 1.05]], np.float32)
    want = np.asarray(jfilm.develop(jf, RES, splat_scale=0.125, out_matrix=m, imaging_ratio=1.5))
    got = tfilm.develop(tf, RES, out_matrix=m, imaging_ratio=1.5, splat_scale=0.125).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    plain = tfilm.develop(tf, RES, out_matrix=m, imaging_ratio=1.5).numpy()
    assert np.abs(got - plain).max() > 1e-3 * np.abs(plain).max()
