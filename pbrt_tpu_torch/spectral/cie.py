"""CIE 1931 colorimetry data and constants.

Loads the public CIE datasets extracted to pbrt_tpu_torch/data/cie.npz
(parity source: reference src/pbrt/spectrum_util/spectrum_constants_cie.h).
Host-side numpy only; device code receives these as torch tensors.
"""
import functools
import pathlib

import numpy as np

LAMBDA_MIN = 360
LAMBDA_MAX = 830
LAMBDA_RANGE = LAMBDA_MAX - LAMBDA_MIN + 1  # 471
N_SPECTRUM_SAMPLES = 4
CIE_Y_INTEGRAL = 106.856895

_DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


@functools.lru_cache(None)
def _cie():
    return np.load(_DATA / "cie.npz")


@functools.lru_cache(None)
def lambdas():
    """The 1nm wavelength grid 360..830, float64 (471,)."""
    return _cie()["lambda_"]


@functools.lru_cache(None)
def X():
    return _cie()["x"]


@functools.lru_cache(None)
def Y():
    return _cie()["y"]


@functools.lru_cache(None)
def Z():
    return _cie()["z"]


@functools.lru_cache(None)
def illum_d65():
    """CIE D6500 illuminant resampled onto the 1nm grid, normalized to
    photometric units like the reference (piecewise-linear, normalize=True:
    scale by CIE_Y_integral / <S, Y>; reference global_spectra.cu:28-31)."""
    inter = _cie()["illum_d6500_interleaved"]
    lam, val = inter[0::2], inter[1::2]
    dense = dense_from_interleaved(lam, val)
    return dense * (CIE_Y_INTEGRAL / inner_product(dense, Y()))


def dense_from_interleaved(lam, val):
    """Resample a piecewise-linear (λ, v) spectrum onto the 1nm grid with the
    reference's edge extension (piecewise_linear_spectrum.cu:17-28)."""
    lam = np.asarray(lam, dtype=np.float64)
    val = np.asarray(val, dtype=np.float64)
    if lam[0] > LAMBDA_MIN:
        lam = np.concatenate([[LAMBDA_MIN - 1], lam])
        val = np.concatenate([[val[0]], val])
    if lam[-1] < LAMBDA_MAX:
        lam = np.concatenate([lam, [LAMBDA_MAX + 1]])
        val = np.concatenate([val, [val[-1]]])
    return np.interp(lambdas(), lam, val)


def inner_product(a, b):
    """<a, b> = sum over the 1nm grid (reference base/spectrum.h:98-108)."""
    return float(np.sum(np.asarray(a) * np.asarray(b)))


def to_xyz(dense):
    """Spectrum -> CIE XYZ (reference base/spectrum.h:110-115)."""
    return (
        np.array(
            [inner_product(dense, X()), inner_product(dense, Y()), inner_product(dense, Z())]
        )
        / CIE_Y_INTEGRAL
    )


def to_photometric(dense):
    """<s, Y> luminous scale (reference base/spectrum.cu:159-165).

    For RGB-illuminant spectra the reference uses the underlying illuminant's
    inner product; callers handle that case."""
    return inner_product(dense, Y())


@functools.lru_cache(None)
def d_illuminant_s():
    """(s_lambda, s0, s1, s2) basis for CIE D illuminants."""
    c = _cie()
    return c["s_lambda"], c["s0"], c["s1"], c["s2"]


def cie_d(temperature):
    """CIE D-series illuminant SPD on the 1nm grid, normalized like the
    reference create_cie_d (base/spectrum.cu:16-60): chromaticity from CCT,
    S0+M1*S1+M2*S2 basis."""
    cct = temperature * 1.4388 / 1.4380
    if cct < 7000:
        x = -4.607e9 / cct**3 + 2.9678e6 / cct**2 + 0.09911e3 / cct + 0.244063
    else:
        x = -2.0064e9 / cct**3 + 1.9018e6 / cct**2 + 0.24748e3 / cct + 0.23704
    y = -3.0 * x * x + 2.870 * x - 0.275
    m = 0.0241 + 0.2562 * x - 0.7341 * y
    m1 = (-1.3515 - 1.7703 * x + 5.9114 * y) / m
    m2 = (0.0300 - 31.4424 * x + 30.0717 * y) / m
    s_lam, s0, s1, s2 = d_illuminant_s()
    vals = s0 + m1 * s1 + m2 * s2
    return dense_from_interleaved(s_lam, vals)
