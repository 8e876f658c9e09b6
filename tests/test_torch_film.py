"""pbrt_tpu_torch film (K5 and K5s module) vs pbrt_tpu.film.

On the CPU `add_samples`, `add_samples_tiled` and `add_splats` run the
kernels' plain versions (the torch op chain plus index_add_; the tiled one
sums each pixel's replicates in csrc/film.cu's fixed order). Seeded
L/lambda/pdf/weights with NaN and inf lanes, zero pdfs, signed weights and
repeated pixel ids (or, tiled, k replicates of a pixel tile that starts past
pixel 0) must accumulate as pbrt_tpu.film.film.add_samples,
add_samples_tiled and add_splats do, within 1e-5 relative (summation
order); the tiled sums must equal, bit for bit, a float32 numpy evaluation
of the documented order, and the splat kernel's order (a thread a wave lane
over its strategies, all-zero rows skipped) is mirrored in numpy; develop (with its 0.25 |weight_sum| clamp and
BDPT's splat term) and to_srgb8 must match. The kernels themselves are held
against the plain versions on the card by tests/test_torch_gpu.py."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pbrt_tpu.film import film as jfilm
from pbrt_tpu_torch.film import film as tfilm, film_kernel

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


def _tiled(seed, n, k, p0):
    """k replicates of the pixel tile p0 .. p0 + n - 1 (lane j n + p), with
    _samples' NaN and inf lanes, zero pdfs and signed weights, and zero
    radiance (+0 and -0, also over a NaN pdf)."""
    _, L, lam, pdf, w = _samples(seed, n * k)
    L[::23, 0] = 0.0
    L[::43, 2] = -0.0
    pdf[::86, 2] = np.nan
    return np.arange(p0, p0 + n, dtype=np.int64), L, lam, pdf, w


@pytest.mark.parametrize("k", [1, 4, 16])
def test_add_samples_tiled_matches_jax(k):
    """The tiled add (the batched loop's, BDPT's and the pixel-parallel
    render's waves) against pbrt_tpu.film.film.add_samples_tiled, on a film
    that already holds samples (both add into it)."""
    pix, L, lam, pdf, w = _tiled(10 + k, 200, k, p0=100)
    jf, tf = _both(8)
    jf = jfilm.add_samples_tiled(jf, *map(jnp.asarray, (pix.astype(np.int32), L, lam, pdf, w)),
                                 k)
    tfilm.add_samples_tiled(tf, torch.from_numpy(pix), *map(torch.from_numpy, (L, lam, pdf, w)),
                            k)
    want = np.asarray(jf.rgb_sum)
    np.testing.assert_allclose(tf.rgb_sum.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(tf.weight_sum.numpy(), np.asarray(jf.weight_sum), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(tf.rgb_sum.numpy()).all()


def _lane_values_np(L, lam, pdf, w):
    """csrc/film.cu's lane value in float32 numpy: s = L / pdf (0 where pdf
    == 0; +0, or NaN for a NaN pdf, where L == 0), x = ((X0 s0 + X1 s1) +
    X2 s2) + X3 s3, x / 4, non-finite -> 0."""
    cie = film_kernel.cie_table("cpu").numpy()
    with np.errstate(all="ignore"):
        q = L / np.where(pdf == 0, np.float32(1), pdf)
        s = np.where(pdf == 0, np.float32(0),
                     np.where(L == 0, np.where(np.isnan(pdf), pdf, np.float32(0)), q))
        b = np.clip(np.round(lam).astype(np.int64) - 360, 0, 470)
        t = cie[:, b] * s                                          # (3, R, 4)
        xyz = ((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]
        xyz = xyz * np.float32(0.25)
        xyz = np.where(np.isfinite(xyz), xyz, np.float32(0))
        return np.concatenate([w[None] * xyz, w[None]]).T.astype(np.float32)


@pytest.mark.parametrize("n,k,G", [(200, 1, 1), (200, 3, 2), (200, 16, 16), (32768, 16, 4),
                                   (65536, 16, 2)])
def test_add_samples_tiled_plain_sums_in_the_fixed_order(n, k, G):
    """The tiled plain version's film, bit for bit: G = tile_group(n, k)
    partial sums, a_g over replicates g, g + G, ... from +0 in order, then
    ((a0 + a1) + (a2 + a3)) + ..., then one add into the pixel. Other
    orders round apart on these inputs (checked)."""
    assert film_kernel.tile_group(n, k) == G
    pix, L, lam, pdf, w = _tiled(20 + k, n, k, p0=3)
    v = _lane_values_np(L, lam, pdf, w).reshape(k, n, 4)
    a = np.zeros((G, n, 4), np.float32)
    for j in range(k):
        a[j % G] = a[j % G] + v[j]
    while a.shape[0] > 1:
        a = a[0::2] + a[1::2]
    base = np.random.default_rng(k).normal(size=(n + 3, 4)).astype(np.float32)
    want = base.copy()
    want[pix] = want[pix] + a[0]
    rgb, ws = torch.from_numpy(base[:, :3].copy()), torch.from_numpy(base[:, 3].copy())
    film_kernel.add_samples_tiled_plain(rgb, ws, torch.from_numpy(pix),
                                        *map(torch.from_numpy, (L, lam, pdf, w)), k)
    np.testing.assert_array_equal(rgb.numpy(), want[:, :3])
    np.testing.assert_array_equal(ws.numpy(), want[:, 3])
    if k > 1:  # the order is visible in the bits
        seq = base.copy()
        seq[pix] = seq[pix] + np.cumsum(v, axis=0, dtype=np.float32)[-1]
        assert not np.array_equal(seq, want)


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


def _splat_mirror(n_px, pix, L, lam, pdf):
    """K5s (csrc/film.cu film_add_splats_kernel) in float32 numpy, its
    threads one after another: lane j's splats j, j + n_lam, ... in order, a
    splat whose L row is all zero skipped before anything else is read, one
    whose XYZ is zero adding nothing. -> (splat film, adds made)."""
    n_lam = lam.shape[0]
    reps = L.shape[0] // n_lam
    v = _lane_values_np(L, np.tile(lam, (reps, 1)), np.tile(pdf, (reps, 1)),
                        np.ones(L.shape[0], np.float32))[:, :3]
    film = np.zeros((n_px, 3), np.float32)
    adds = 0
    for j in range(n_lam):
        for m in range(reps):
            i = m * n_lam + j
            if not L[i].any() or not v[i].any():
                continue
            film[pix[i]] = film[pix[i]] + v[i]
            adds += 1
    return film, adds


@pytest.mark.parametrize("n_lam,reps,pixels", [(1, 600, 5), (400, 7, None), (700, 3, 24 * 16),
                                               (333, 5, 1)],
                         ids=["one lane", "distinct pixels", "a wave", "one pixel"])
def test_splat_kernel_order_mirror(n_lam, reps, pixels):
    """The splat kernel's order against `add_splats_plain` (index_add_ in
    splat order): bit for bit on a wave of one lane (its strategies in
    order are the splat order) and where every splat has a pixel of its own;
    elsewhere (a wave's splats over the film, every splat on one pixel)
    within float rounding, rtol 1e-5, the order of the adds. Zero splats
    (all-zero rows, +0 and -0, over NaN and zero pdfs) take no add."""
    g = np.random.default_rng(n_lam + reps)
    n = n_lam * reps
    _, L, lam, pdf, _ = _samples(30 + reps, n)
    lam, pdf = lam[:n_lam].copy(), pdf[:n_lam].copy()
    pdf[2::5, 1] = np.nan
    L[::3] = 0.0
    L[1::7] = -0.0
    if pixels is None:
        pix = g.permutation(n).astype(np.int64)
    else:
        pix = g.integers(0, pixels, n).astype(np.int64)
    n_px = max(n, RES[0] * RES[1])
    want, adds = _splat_mirror(n_px, pix, L, lam, pdf)
    got = torch.zeros((n_px, 3))
    film_kernel.add_splats_plain(got, torch.from_numpy(pix), *map(torch.from_numpy, (L, lam, pdf)))
    v = _lane_values_np(L, np.tile(lam, (reps, 1)), np.tile(pdf, (reps, 1)), np.ones(n, np.float32))
    assert adds == int((v[:, :3] != 0).any(1).sum()) and n // 3 < adds < n
    if n_lam == 1 or pixels is None:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
