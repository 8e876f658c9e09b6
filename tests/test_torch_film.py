"""pbrt_tpu_torch film (K5 module) vs pbrt_tpu.film.

On the CPU `add_samples` runs the Triton kernel's plain version (the torch
op chain plus index_add_). Seeded L/lambda/pdf/weights with NaN and inf
lanes, zero pdfs, signed weights and repeated pixel ids must accumulate as
pbrt_tpu.film.film.add_samples does, within 1e-5 relative (summation
order); develop (with its 0.25 |weight_sum| clamp) and to_srgb8 must match.
The Triton kernel itself is held against the plain version on the card by
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
