"""Sampled spectra: a SampledSpectrum is a (..., 4) tensor; wavelengths are
the pair (lam, pdf) of (..., 4) tensors (counterpart of
pbrt_tpu/spectral/sampled.py; reference sampled_wavelengths.h)."""
from typing import NamedTuple

import torch

from pbrt_tpu_torch.spectral import cie

N = cie.N_SPECTRUM_SAMPLES


class Wavelengths(NamedTuple):
    lam: torch.Tensor
    pdf: torch.Tensor


def visible_wavelengths_pdf(lam):
    """pdf of the visible-importance distribution (reference
    util/sampling.h:296-302)."""
    p = 0.0039398042 / torch.square(torch.cosh(0.0072 * (lam - 538.0)))
    return torch.where((lam < cie.LAMBDA_MIN) | (lam > cie.LAMBDA_MAX), 0.0, p)


def sample_visible_wavelengths(u):
    return 538.0 - 138.888889 * torch.arctanh(0.85691062 - 1.82750197 * u)


def sample_visible(u):
    """Stratified 4-wavelength visible sampling from one uniform (...,)
    (reference sampled_wavelengths.h:61-78)."""
    i = torch.arange(N, dtype=u.dtype, device=u.device)
    up = u[..., None] + i / N
    up = torch.where(up > 1.0, up - 1.0, up)
    lam = sample_visible_wavelengths(up)
    return Wavelengths(lam=lam, pdf=visible_wavelengths_pdf(lam))


def terminate_secondary(wl: Wavelengths):
    """Collapse to the hero wavelength (dispersion); idempotent (reference
    sampled_wavelengths.h:119-131)."""
    already = torch.all(wl.pdf[..., 1:] == 0.0, dim=-1)
    pdf0 = torch.where(already, wl.pdf[..., 0], wl.pdf[..., 0] / N)
    new_pdf = torch.cat([pdf0[..., None], torch.zeros_like(wl.pdf[..., 1:])], dim=-1)
    return Wavelengths(lam=wl.lam, pdf=new_pdf)
