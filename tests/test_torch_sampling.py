"""pbrt_tpu_torch sampling vs pbrt_tpu: PCG32, MurmurHash64A and the
samplers are bit-exact on 4096 seeded (pixel, sample) pairs; the spectral
and geometric warps agree to 1e-6 relative (float32 transcendental
functions differ by an ulp or two between XLA and PyTorch on the CPU)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pbrt_tpu.sampling import rng as jrng, samplers as jsamplers, warps as jwarps
from pbrt_tpu.spectral import sampled as jsampled
from pbrt_tpu_torch.sampling import rng as trng, samplers as tsamplers, warps as twarps
from pbrt_tpu_torch.spectral import sampled as tsampled

torch.set_num_threads(2)
N = 4096


def _u64(x):
    """JAX U64 limbs -> int64 numpy with the same bits."""
    hi = np.asarray(x.hi).astype(np.uint64)
    lo = np.asarray(x.lo).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


def _limbs(v):
    """int64 numpy -> JAX U64."""
    u = np.asarray(v).view(np.uint64)
    return jrng.U64(jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
                    jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


@pytest.fixture
def words():
    g = np.random.default_rng(7)
    return g.integers(0, 2**32, (3, N), dtype=np.uint64).astype(np.int64)


@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_murmur_hash_bit_exact(words, n_words):
    ws = words[:n_words]
    want = _u64(jrng.murmur64a_u32_words([jnp.asarray(w.astype(np.uint32)) for w in ws]))
    got = trng.murmur64a_u32_words([torch.from_numpy(w) for w in ws]).numpy()
    np.testing.assert_array_equal(got, want)


def test_hash_int_and_mix_bits_bit_exact(words):
    x = words[0]
    h_j = jrng.hash_int(jnp.asarray(x.astype(np.uint32)))
    h_t = trng.hash_int(torch.from_numpy(x))
    np.testing.assert_array_equal(h_t.numpy(), _u64(h_j))
    np.testing.assert_array_equal(trng.mix_bits(h_t).numpy(), _u64(jrng.mix_bits(h_j)))


def test_pcg32_step_and_advance_bit_exact(words):
    g = np.random.default_rng(11)
    seq = torch.from_numpy(g.integers(-2**63, 2**63 - 1, N, dtype=np.int64))
    r_t = trng.from_seed(seq)
    r_j = jrng.from_seed(_limbs(seq.numpy()))
    np.testing.assert_array_equal(r_t.state.numpy(), _u64(r_j.state))
    np.testing.assert_array_equal(r_t.inc.numpy(), _u64(r_j.inc))
    delta = g.integers(0, 2**40, N, dtype=np.int64)
    a_t = trng.advance(r_t, torch.from_numpy(delta))
    a_j = jrng.advance(r_j, _limbs(delta))
    np.testing.assert_array_equal(a_t.state.numpy(), _u64(a_j.state))
    s_t, u_t = trng.uniform_float(a_t.state, a_t.inc)
    a_j2, u_j = jrng.uniform_float(a_j)
    np.testing.assert_array_equal(s_t.numpy(), _u64(a_j2.state))
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))


@pytest.fixture
def pixel_sample():
    g = np.random.default_rng(3)
    return (g.integers(0, 1 << 20, N).astype(np.int32),
            g.integers(0, 64, N).astype(np.int32))


def _draws(mod, s, kind, spp, masks, conv):
    """A fixed sequence of pixel/1d/2d draws, masked like bounce_step's."""
    outs = []
    s, u = mod.get_pixel_2d(s, None, kind, spp)
    outs.append(u)
    for m in masks:
        s, u = mod.get_1d(s, conv(m), kind, spp)
        outs.append(u)
        s, u = mod.get_2d(s, conv(m), kind, spp)
        outs.append(u)
    return s, outs


@pytest.mark.parametrize("kind,spp", [("independent", 16), ("stratified", 16),
                                      ("stratified", 4)])
def test_samplers_bit_exact(pixel_sample, kind, spp):
    pix, smp = pixel_sample
    smp = smp % spp
    g = np.random.default_rng(5)
    masks = [g.random(N) < 0.7 for _ in range(3)]
    s_j = jsamplers.start_pixel_sample(jnp.asarray(pix), jnp.asarray(smp))
    s_t = tsamplers.start_pixel_sample(torch.from_numpy(pix), torch.from_numpy(smp))
    np.testing.assert_array_equal(s_t.state.numpy(), _u64(s_j.state))
    np.testing.assert_array_equal(s_t.inc.numpy(), _u64(s_j.inc))
    s_j, out_j = _draws(jsamplers, s_j, kind, spp, masks, jnp.asarray)
    s_t, out_t = _draws(tsamplers, s_t, kind, spp, masks, torch.from_numpy)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(s_t.state.numpy(), _u64(s_j.state))
    np.testing.assert_array_equal(s_t.dim.numpy(), np.asarray(s_j.dim).astype(np.int64))


def test_permutation_element_bit_exact(words):
    i = words[0] % 64
    p = words[1]
    for l in (4, 16, 25, 64):
        want = jsamplers.permutation_element(jnp.asarray(i.astype(np.uint32)), l,
                                             jnp.asarray(p.astype(np.uint32)))
        got = tsamplers.permutation_element(torch.from_numpy(i), l, torch.from_numpy(p))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_sample_visible():
    u = np.random.default_rng(1).random(N).astype(np.float32)
    wj = jsampled.sample_visible(jnp.asarray(u))
    wt = tsampled.sample_visible(torch.from_numpy(u))
    np.testing.assert_allclose(wt.lam.numpy(), np.asarray(wj.lam), rtol=1e-6)
    # the pdf squares a cosh: up to ~10 float32 ulp between the two libms
    np.testing.assert_allclose(wt.pdf.numpy(), np.asarray(wj.pdf), rtol=2e-6)
    tj = jsampled.terminate_secondary(wj)
    tt = tsampled.terminate_secondary(wt)
    np.testing.assert_allclose(tt.pdf.numpy(), np.asarray(tj.pdf), rtol=2e-6)


def _u2(seed):
    return np.random.default_rng(seed).random((N, 2)).astype(np.float32)


@pytest.mark.parametrize("name", ["sample_uniform_disk_concentric", "sample_uniform_disk_polar",
                                  "sample_cosine_hemisphere", "sample_uniform_triangle"])
def test_simple_warps(name):
    u = _u2(2)
    want = np.array(getattr(jwarps, name)(jnp.asarray(u)))
    got = getattr(twarps, name)(torch.from_numpy(u)).numpy()
    if name == "sample_cosine_hemisphere":
        # z = sqrt(1 - x^2 - y^2) turns one ulp of x^2 near the rim into
        # ~1e-6 of z: compare z^2, which is as well conditioned as x and y
        want[..., 2] **= 2
        got[..., 2] **= 2
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _tri_setup(seed):
    g = np.random.default_rng(seed)
    v = [g.normal(0, 1, (N, 3)).astype(np.float32) + np.array([0, 0, 4], np.float32)
         for _ in range(3)]
    p = g.normal(0, 0.3, (N, 3)).astype(np.float32)
    return v, p


def test_spherical_triangle_and_bilinear_warps():
    (v0, v1, v2), p = _tri_setup(4)
    u = _u2(6)
    w = np.random.default_rng(8).uniform(0.01, 1.0, (N, 4)).astype(np.float32)
    bj, pdfj = jwarps.sample_spherical_triangle(*map(jnp.asarray, (v0, v1, v2, p, u)))
    bt, pdft = twarps.sample_spherical_triangle(*map(torch.from_numpy, (v0, v1, v2, p, u)))
    b64, pdf64 = twarps.sample_spherical_triangle(
        *(torch.from_numpy(x.astype(np.float64)) for x in (v0, v1, v2, p, u)))
    # Arvo's construction is ill-conditioned in float32 on some lanes: the
    # pdf is 1/(alpha + beta + gamma - pi), and the barycentrics of the JAX
    # package itself are off by up to ~0.9 against a float64 evaluation. So
    # the port must agree to 1e-6 on the median lane, and nowhere stray
    # further from the JAX result than the two float32 results are from
    # float64 (measured: the port-JAX gap is ~10x below that bound at p90).
    bj, bt, b64 = np.asarray(bj), bt.numpy(), b64.numpy()
    err = np.abs(bt - bj).max(-1)
    assert np.median(err) <= 1e-6
    assert np.all(err <= np.abs(bj - b64).max(-1) + np.abs(bt - b64).max(-1) + 1e-5)
    pj, pt, p64 = np.asarray(pdfj), pdft.numpy(), pdf64.numpy()
    assert np.median(np.abs(pt - pj) / pj) <= 1e-6
    assert np.all(np.abs(pt - pj) <= np.abs(pj - p64) + np.abs(pt - p64) + 1e-6 * pj)
    sj = jwarps.sample_bilinear(jnp.asarray(u), jnp.asarray(w))
    st = twarps.sample_bilinear(torch.from_numpy(u), torch.from_numpy(w))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        twarps.bilinear_pdf(st, torch.from_numpy(w)).numpy(),
        np.asarray(jwarps.bilinear_pdf(sj, jnp.asarray(w))), rtol=1e-6)
    d = v1 + 0.3 * (v2 - v1) - p
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ij = np.asarray(jwarps.invert_spherical_triangle_sample(
        *map(jnp.asarray, (v0, v1, v2, p, d))))
    it = twarps.invert_spherical_triangle_sample(
        *map(torch.from_numpy, (v0, v1, v2, p, d))).numpy()
    i64 = twarps.invert_spherical_triangle_sample(
        *(torch.from_numpy(x.astype(np.float64)) for x in (v0, v1, v2, p, d))).numpy()
    err = np.abs(it - ij).max(-1)      # u0 = A'/A: the same conditioning
    assert np.median(err) <= 1e-6
    assert np.all(err <= np.abs(ij - i64).max(-1) + np.abs(it - i64).max(-1) + 1e-5)
