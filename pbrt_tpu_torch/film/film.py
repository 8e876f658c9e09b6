"""RGB film: spectral samples -> sensor RGB accumulation -> image
(counterpart of pbrt_tpu/film/film.py; reference film/rgb_film.cu).

The film is three accumulators, rgb_sum (H*W, 3), weight_sum (H*W,) and
BDPT's splat (H*W, 3), updated in place (the JAX package returns a new film
per add). On CUDA tensors `add_samples_tiled` and `add_samples` launch the
two entry points of the CUDA film kernel (K5, csrc/film.cu: the tiled one
without atomics, the scatter one with them) and `add_splats` the Triton
splat kernel (K5s), all through film_kernel.py; on CPU tensors they run the
kernels' plain versions.
"""
from typing import NamedTuple

import numpy as np
import torch

from pbrt_tpu_torch.film import film_kernel
from pbrt_tpu_torch.spectral import colorspace


class Film(NamedTuple):
    rgb_sum: torch.Tensor     # (H*W, 3) sensor rgb
    weight_sum: torch.Tensor  # (H*W,)
    splat: torch.Tensor       # (H*W, 3) BDPT's light-tracing splats


def new_film(resolution, device):
    w, h = resolution
    return Film(rgb_sum=torch.zeros((w * h, 3), dtype=torch.float32, device=device),
                weight_sum=torch.zeros((w * h,), dtype=torch.float32, device=device),
                splat=torch.zeros((w * h, 3), dtype=torch.float32, device=device))


def add_samples(film: Film, pixel_idx, L, lam, pdf, weight):
    """Weighted add of (R,) samples with any pixel ids into the film, in
    place (reference rgb_film.cu:64-80); on the card the order of the sums
    varies from run to run."""
    fn = film_kernel.add_samples_cuda if film.rgb_sum.is_cuda else film_kernel.add_samples_plain
    fn(film.rgb_sum, film.weight_sum, pixel_idx, L, lam, pdf, weight)
    return film


def add_samples_tiled(film: Film, pixel_idx, L, lam, pdf, weight, k):
    """add_samples for a lane grid of k replicates of the n distinct pixel
    ids pixel_idx (R = k n; lane j n + p is replicate j of pixel_idx[p]), in
    place (pbrt_tpu/film/film.py:54). Each pixel's k lanes are summed in a
    fixed order, so the film is the same bits on every run, on the card and
    on the CPU."""
    fn = (film_kernel.add_samples_tiled_cuda if film.rgb_sum.is_cuda
          else film_kernel.add_samples_tiled_plain)
    fn(film.rgb_sum, film.weight_sum, pixel_idx, L, lam, pdf, weight, k)
    return film


def add_splats(film: Film, pixel_idx, L, lam, pdf):
    """Unnormalized add of (R,) splats (weight 1) into film.splat, in place;
    lam and pdf may have fewer rows than L, which then reads row i % rows
    (BDPT's t = 1 strategies of one wave share their lanes' wavelengths)."""
    fn = film_kernel.add_splats_triton if film.splat.is_cuda else film_kernel.add_splats_plain
    fn(film.splat, pixel_idx, L, lam, pdf)
    return film


def develop(film: Film, resolution, out_matrix=None, imaging_ratio=1.0, splat_scale=0.0):
    """-> (H, W, 3) linear output RGB (reference rgb_film.cu:108-122).
    |weight_sum| is clamped to at least 0.25, keeping its sign, as in the
    JAX package (film.py:92-95): mitchell's signed weights can leave a
    pixel's weight sum near 0 at low spp. The splats, times splat_scale,
    are added after the division."""
    w, h = resolution
    ws = film.weight_sum[:, None]
    mag = torch.clamp(torch.abs(ws), min=0.25)
    rgb = film.rgb_sum / torch.where(ws < 0, -mag, mag)
    if splat_scale:
        rgb = rgb + splat_scale * film.splat
    rgb = rgb * imaging_ratio
    m = colorspace.srgb().rgb_from_xyz if out_matrix is None else out_matrix
    return colorspace.apply_matrix(m, rgb).reshape(h, w, 3)


def to_srgb8(linear_rgb):
    """(H, W, 3) linear -> uint8 sRGB numpy."""
    enc = colorspace.srgb_encode(torch.clamp(torch.as_tensor(linear_rgb), 0.0, 1.0))
    return np.asarray(torch.round(enc * 255.0).to(torch.uint8).cpu())
