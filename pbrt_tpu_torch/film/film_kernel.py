"""Film sample and splat accumulation as fused Triton kernels (K5, K5s).

Replaces the TPU hot path pbrt_tpu/film/film.py:44 `add_samples` (and :54
`add_samples_tiled`, with colorspace.py:50 `to_sensor_rgb`): per lane,
look up the CIE X, Y, Z curves at the 4 wavelengths (nearest 1 nm bin),
divide L by the wavelength pdf, average, zero non-finite components, weight,
and scatter-add into the film's rgb_sum (H*W, 3) and weight_sum (H*W,) with
atomics. The JAX package's k-fold pre-reduction of sample replicates was a
workaround for the TPU's scalar-unit scatter and is not ported.

What bounds it on the H100: bytes. Per lane it reads 13 floats and an index
(56 B), gathers 12 curve values from a 5.6 KB table that stays in cache,
and does 4 atomic adds into a film that fits in L2; a few dozen float ops
per lane are nothing against that. Fusing the chain into one pass is the
whole gain over the plain version's ~20 eager ops, each of which reads and
writes the lanes again. Triton serves as well as CUDA here: an elementwise
pass plus a scatter, with no data reuse and no matrix unit.

K5s replaces pbrt_tpu/film/film.py:70 `add_splats`, BDPT's light-tracing
(t = 1) contributions: the same pass into the film's splat (H*W, 3), with
no weight sum and weight 1. The wave's splats are its lanes'
t = 1 strategies stacked, so they read their wavelengths as row i % n_lam
of the wave's (n_lam, 4) lam and pdf instead of a repeated copy.
"""
import os

import torch

from pbrt_tpu_torch.spectral import cie, colorspace

# launches of the Triton kernel (plain int, added to where it launches)
launches = {"film_add_samples": 0, "film_add_splats": 0}

BLOCK = 256
_KERNEL = []
_CIE = {}


def cie_table(device):
    """(3, 471) float32 CIE X/Y/Z curves on `device` (cached)."""
    device = torch.device(device)
    if device not in _CIE:
        _CIE[device] = torch.as_tensor(colorspace.cie_xyz_dense(), device=device)
    return _CIE[device]


def add_samples_plain(rgb_sum, weight_sum, pixel_idx, L, lam, pdf, weight):
    """Plain version: the torch op chain plus index_add_ (in place)."""
    rgb = colorspace.to_sensor_rgb(L, lam, pdf, cie_table(L.device))
    rgb = torch.where(torch.isfinite(rgb), rgb, 0.0)
    rgb_sum.index_add_(0, pixel_idx, weight[..., None] * rgb)
    weight_sum.index_add_(0, pixel_idx, weight)


def add_splats_plain(splat, pixel_idx, L, lam, pdf):
    """Plain version of K5s: the torch op chain plus index_add_ (in place).
    Splat i reads wavelength row i % lam.shape[0]."""
    reps = L.shape[0] // max(lam.shape[0], 1)
    if reps != 1:
        lam, pdf = lam.repeat(reps, 1), pdf.repeat(reps, 1)
    rgb = colorspace.to_sensor_rgb(L, lam, pdf, cie_table(L.device))
    rgb = torch.where(torch.isfinite(rgb), rgb, 0.0)
    splat.index_add_(0, pixel_idx, rgb)


def _build():
    """Define the Triton kernels (triton is imported here, at first launch)."""
    from pbrt_tpu_torch.kernels import BUILD_DIR

    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def sensor_xyz(offs, lrow, m, L_ptr, lam_ptr, pdf_ptr, cie_ptr,
                   LAMBDA_MIN: tl.constexpr, LAMBDA_RANGE: tl.constexpr, BLOCK: tl.constexpr):
        # sensor XYZ of lanes offs (wavelengths of rows lrow), non-finite
        # components zeroed
        x = tl.zeros([BLOCK], dtype=tl.float32)
        y = tl.zeros([BLOCK], dtype=tl.float32)
        z = tl.zeros([BLOCK], dtype=tl.float32)
        for j in tl.static_range(4):
            Lj = tl.load(L_ptr + offs * 4 + j, mask=m, other=0.0)
            lamj = tl.load(lam_ptr + lrow * 4 + j, mask=m, other=0.0)
            pdfj = tl.load(pdf_ptr + lrow * 4 + j, mask=m, other=1.0)
            s = tl.where(pdfj != 0.0, Lj / tl.where(pdfj == 0.0, 1.0, pdfj), 0.0)
            # round half to even, then the 1 nm bin (spectra.lam_bins)
            fl = tl.floor(lamj)
            frac = lamj - fl
            fi = fl.to(tl.int32)
            r = fi + tl.where((frac > 0.5) | ((frac == 0.5) & ((fi & 1) == 1)), 1, 0)
            b = tl.minimum(tl.maximum(r - LAMBDA_MIN, 0), LAMBDA_RANGE - 1)
            x += tl.load(cie_ptr + b, mask=m, other=0.0) * s
            y += tl.load(cie_ptr + LAMBDA_RANGE + b, mask=m, other=0.0) * s
            z += tl.load(cie_ptr + 2 * LAMBDA_RANGE + b, mask=m, other=0.0) * s
        x = x / 4.0
        y = y / 4.0
        z = z / 4.0
        # NaN guard: |v| <= FLT_MAX is false for NaN and +-inf
        x = tl.where(tl.abs(x) <= 3.4028234663852886e38, x, 0.0)
        y = tl.where(tl.abs(y) <= 3.4028234663852886e38, y, 0.0)
        z = tl.where(tl.abs(z) <= 3.4028234663852886e38, z, 0.0)
        return x, y, z

    @triton.jit
    def film_add_kernel(pix_ptr, L_ptr, lam_ptr, pdf_ptr, w_ptr, cie_ptr,
                        rgb_ptr, wsum_ptr, n,
                        LAMBDA_MIN: tl.constexpr, LAMBDA_RANGE: tl.constexpr,
                        BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        pix = tl.load(pix_ptr + offs, mask=m, other=0)
        w = tl.load(w_ptr + offs, mask=m, other=0.0)
        x, y, z = sensor_xyz(offs, offs, m, L_ptr, lam_ptr, pdf_ptr, cie_ptr,
                             LAMBDA_MIN, LAMBDA_RANGE, BLOCK)
        tl.atomic_add(rgb_ptr + pix * 3, w * x, mask=m)
        tl.atomic_add(rgb_ptr + pix * 3 + 1, w * y, mask=m)
        tl.atomic_add(rgb_ptr + pix * 3 + 2, w * z, mask=m)
        tl.atomic_add(wsum_ptr + pix, w, mask=m)

    @triton.jit
    def film_splat_kernel(pix_ptr, L_ptr, lam_ptr, pdf_ptr, cie_ptr, splat_ptr, n, n_lam,
                          LAMBDA_MIN: tl.constexpr, LAMBDA_RANGE: tl.constexpr,
                          BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        pix = tl.load(pix_ptr + offs, mask=m, other=0)
        x, y, z = sensor_xyz(offs, offs % n_lam, m, L_ptr, lam_ptr, pdf_ptr, cie_ptr,
                             LAMBDA_MIN, LAMBDA_RANGE, BLOCK)
        # zero splats (strategies that did not connect: most of them, all
        # clamped onto one pixel) add nothing and take no atomic
        live = m & ((x != 0.0) | (y != 0.0) | (z != 0.0))
        tl.atomic_add(splat_ptr + pix * 3, x, mask=live)
        tl.atomic_add(splat_ptr + pix * 3 + 1, y, mask=live)
        tl.atomic_add(splat_ptr + pix * 3 + 2, z, mask=live)

    return film_add_kernel, film_splat_kernel


def _check_args(what, dev, checks):
    for name, x, dtype, shape in checks:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def add_samples_triton(rgb_sum, weight_sum, pixel_idx, L, lam, pdf, weight):
    """Launch the fused kernel on the current stream (in place) and count
    the launch."""
    R = pixel_idx.shape[0]
    dev = rgb_sum.device
    _check_args("film_add_samples", dev, (
        ("rgb_sum", rgb_sum, torch.float32, (rgb_sum.shape[0], 3)),
        ("weight_sum", weight_sum, torch.float32, (rgb_sum.shape[0],)),
        ("pixel_idx", pixel_idx, torch.int64, (R,)),
        ("L", L, torch.float32, (R, 4)), ("lam", lam, torch.float32, (R, 4)),
        ("pdf", pdf, torch.float32, (R, 4)), ("weight", weight, torch.float32, (R,))))
    if not _KERNEL:
        _KERNEL.extend(_build())
    if R == 0:
        return
    grid = ((R + BLOCK - 1) // BLOCK,)
    _KERNEL[0][grid](pixel_idx, L, lam, pdf, weight, cie_table(dev), rgb_sum,
                     weight_sum, R,
                     LAMBDA_MIN=cie.LAMBDA_MIN, LAMBDA_RANGE=cie.LAMBDA_RANGE,
                     BLOCK=BLOCK, num_warps=4)
    launches["film_add_samples"] += 1


def add_splats_triton(splat, pixel_idx, L, lam, pdf):
    """Launch K5s on the current stream (in place) and count the launch;
    same contract as add_splats_plain (R splats, n_lam wavelength rows with
    n_lam dividing R)."""
    R, n_lam = pixel_idx.shape[0], lam.shape[0]
    dev = splat.device
    _check_args("film_add_splats", dev, (
        ("splat", splat, torch.float32, (splat.shape[0], 3)),
        ("pixel_idx", pixel_idx, torch.int64, (R,)),
        ("L", L, torch.float32, (R, 4)), ("lam", lam, torch.float32, (n_lam, 4)),
        ("pdf", pdf, torch.float32, (n_lam, 4))))
    if R and (n_lam == 0 or R % n_lam):
        raise ValueError(f"film_add_splats: {n_lam} wavelength rows do not divide {R} splats")
    if not _KERNEL:
        _KERNEL.extend(_build())
    if R == 0:
        return
    grid = ((R + BLOCK - 1) // BLOCK,)
    _KERNEL[1][grid](pixel_idx, L, lam, pdf, cie_table(dev), splat, R, n_lam,
                     LAMBDA_MIN=cie.LAMBDA_MIN, LAMBDA_RANGE=cie.LAMBDA_RANGE,
                     BLOCK=BLOCK, num_warps=4)
    launches["film_add_splats"] += 1
