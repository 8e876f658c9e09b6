"""Spectrum representations (counterpart of pbrt_tpu/spectral/spectra.py).

The scene compiler type-erases every non-RGB spectrum into a dense 1 nm
table of 471 bins on the host (numpy); device evaluation is one indexed
lookup per wavelength. The JAX package's one-hot matrix-unit lookup was a
TPU gather workaround and is not ported: here it is plain indexing.
RGB-fitted spectra stay parametric: 3 sigmoid-polynomial coefficients.
"""
import numpy as np
import torch

from pbrt_tpu_torch.spectral import cie


# ----------------------------------------------------------------- host build


def from_interleaved(samples, normalize):
    """Piecewise-linear from interleaved [λ0, v0, λ1, v1, ...] with optional
    photometric normalization (reference base/spectrum.cu:101,
    piecewise_linear_spectrum.cu:6-39). Dense (471,)."""
    samples = np.asarray(samples, dtype=np.float64)
    dense = cie.dense_from_interleaved(samples[0::2], samples[1::2])
    if normalize:
        dense = dense * (cie.CIE_Y_INTEGRAL / cie.inner_product(dense, cie.Y()))
    return dense


# --------------------------------------------------------------- device eval


def lam_bins(lam):
    """Nearest 1 nm bin of each wavelength (reference DenselySampledSpectrum)."""
    return torch.clamp(torch.round(lam).long() - cie.LAMBDA_MIN, 0,
                       cie.LAMBDA_RANGE - 1)


def sample_dense(values, lam):
    """Sample a dense (471,) spectrum at wavelengths lam (..., N)."""
    return values[lam_bins(lam)]


def sample_table(table, spec_idx, lam):
    """Sample row `spec_idx` (...) of a (n_spectra, 471) table at lam
    (..., N) -> (..., N)."""
    return table[spec_idx[..., None], lam_bins(lam)]


def sigmoid(x):
    """Jakob–Hanika sigmoid with the ±inf -> 0/1 limits
    (reference rgb_sigmoid_polynomial.h)."""
    xc = torch.clamp(x, -1e15, 1e15)
    s = 0.5 * xc / torch.sqrt(1.0 + xc * xc) + 0.5
    return torch.where(x >= 1e15, 1.0, torch.where(x <= -1e15, 0.0, s))


def sigmoid_polynomial(c, lam):
    """sigmoid(c0·λ² + c1·λ + c2) at λ; c (..., 3), lam (..., N) -> (..., N)."""
    x = (c[..., 0:1] * lam + c[..., 1:2]) * lam + c[..., 2:3]
    return sigmoid(x)
