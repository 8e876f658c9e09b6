"""Film sample and splat accumulation (K5, K5s): the wrappers of the CUDA
film kernel csrc/film.cu (K5), the Triton splat kernel (K5s), and the plain
versions of all three entry points.

K5 replaces the TPU hot path pbrt_tpu/film/film.py:44 `add_samples` and :54
`add_samples_tiled` (with colorspace.py:50 `to_sensor_rgb`): per lane, look
up the CIE X, Y, Z curves at the 4 wavelengths (nearest 1 nm bin), divide L
by the wavelength pdf, average, zero non-finite components, weight, and add
into the film's rgb_sum (H*W, 3) and weight_sum (H*W,). Two entry points
(csrc/film.cu says how each is laid out on the card):
  - tiled (`film_add_samples`): a wave of k replicates of n distinct pixel
    ids, lane j n + p, as the batched loop, BDPT and the pixel-parallel
    render lay out their waves. Each pixel's k lanes are summed in a fixed
    order (`add_samples_tiled_plain` spells it out), then added to the
    pixel once: no atomics, the same bits on every run and on the CPU.
  - scatter (`film_add_scatter`): any pixel ids (the wavefront loop); one
    relaxed atomic add a component, none for a lane of weight 0, so the
    order of the sums, and their last bits, vary from run to run.
The JAX package pre-reduces the k replicates with a reshape-sum before
its scatter because the TPU's scatter is scalar-bound; the tiled entry
takes the same layout and needs no scatter at all.

K5s replaces pbrt_tpu/film/film.py:70 `add_splats`, BDPT's light-tracing
(t = 1) contributions: the same pass into the film's splat (H*W, 3), with
no weight sum and weight 1, as a Triton kernel with atomics. The wave's
splats are its lanes' t = 1 strategies stacked, so they read their
wavelengths as row i % n_lam of the wave's (n_lam, 4) lam and pdf instead
of a repeated copy.
"""
import ctypes
import os

import torch

from pbrt_tpu_torch.spectral import cie, colorspace, spectra

# launches of each entry point (plain ints, added to where they launch)
launches = {"film_add_samples": 0, "film_add_scatter": 0, "film_add_splats": 0}

BLOCK = 256
_KERNEL = []
_CIE = {}


def cie_table(device):
    """(3, 471) float32 CIE X/Y/Z curves on `device` (cached)."""
    device = torch.device(device)
    if device not in _CIE:
        _CIE[device] = torch.as_tensor(colorspace.cie_xyz_dense(), device=device)
    return _CIE[device]


def lane_values(L, lam, pdf, weight):
    """(R, 4) (w x, w y, w z, w) of each lane, in csrc/film.cu's order: s =
    L / pdf (0 where pdf == 0; where L == 0, +0, or NaN for a NaN pdf: the
    kernel does not divide there, and a film sum cannot tell -0 from +0),
    x = ((X0 s0 + X1 s1) + X2 s2) + X3 s3, x / 4, non-finite components
    zeroed."""
    q = L / torch.where(pdf == 0.0, 1.0, pdf)
    s = torch.where(pdf == 0.0, 0.0,
                    torch.where(L == 0.0, torch.where(torch.isnan(pdf), pdf, 0.0), q))
    terms = cie_table(L.device)[:, spectra.lam_bins(lam)] * s      # (3, R, 4)
    xyz = ((terms[..., 0] + terms[..., 1]) + terms[..., 2]) + terms[..., 3]
    xyz = xyz * 0.25
    xyz = torch.where(torch.isfinite(xyz), xyz, 0.0)
    return torch.cat([weight[None] * xyz, weight[None]]).T


def tile_group(n, k):
    """G, the lanes of a warp that share one pixel's k replicates in the
    tiled entry: the largest power of two up to min(k, 32) that is at most
    2 or keeps the launch below 2^17 threads (n G), so that a wave of few
    pixels and many samples still fills the card. (At cornell-mesh's n =
    65,536 and k = 16: G = 2, 8 lanes a thread; G = 4 and G = 1 ran slower
    on an H100.)"""
    g = 1
    while g < 32 and 2 * g <= k and (g < 2 or n * g < 1 << 17):
        g *= 2
    return g


def add_samples_plain(rgb_sum, weight_sum, pixel_idx, L, lam, pdf, weight):
    """Plain version of the scatter entry: lane_values plus index_add_ (in
    place)."""
    v = lane_values(L, lam, pdf, weight)
    rgb_sum.index_add_(0, pixel_idx, v[:, :3])
    weight_sum.index_add_(0, pixel_idx, v[:, 3])


def add_samples_tiled_plain(rgb_sum, weight_sum, pixel_idx, L, lam, pdf, weight, k):
    """Plain version of the tiled entry, in its order of sums (in place):
    lane j n + p is replicate j of the distinct pixel pixel_idx[p]. With G =
    tile_group(n, k), partial sum a_g adds replicates g, g + G, g + 2G, ...
    in order from +0; the pixel's total is ((a_0 + a_1) + (a_2 + a_3)) + ...
    (pairs, level by level), added to the pixel once."""
    n = pixel_idx.shape[0]
    G = tile_group(n, k)
    v = lane_values(L, lam, pdf, weight).view(k, n, 4)
    acc = torch.zeros((G, n, 4), dtype=v.dtype, device=v.device)
    for m in range(0, k, G):
        rows = v[m:m + G]
        acc[:rows.shape[0]] = acc[:rows.shape[0]] + rows
    while acc.shape[0] > 1:
        acc = acc[0::2] + acc[1::2]
    rgb_sum[pixel_idx] = rgb_sum[pixel_idx] + acc[0, :, :3]
    weight_sum[pixel_idx] = weight_sum[pixel_idx] + acc[0, :, 3]


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
    """Define the Triton splat kernel (triton is imported here, at first
    launch)."""
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

    return film_splat_kernel


def _check_args(what, dev, checks):
    for name, x, dtype, shape in checks:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def _film_lib():
    from pbrt_tpu_torch import kernels

    lib = kernels.load("film")
    if not hasattr(lib, "declared"):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pbrt_film_add_tiled.argtypes = [P] * 5 + [I, I, I, P, I, I, P, P, P]
        lib.pbrt_film_add_tiled.restype = I
        lib.pbrt_film_add_scatter.argtypes = [P] * 5 + [I, P, I, I, P, P, P]
        lib.pbrt_film_add_scatter.restype = I
        lib.declared = True
    return lib


def _check_samples(what, rgb_sum, weight_sum, pixel_idx, L, lam, pdf, weight, R):
    """The K5 entry points' argument checks: dtypes, shapes, contiguity, one
    CUDA device, and 16-byte rows (read as float4)."""
    dev = rgb_sum.device
    _check_args(what, dev, (
        ("rgb_sum", rgb_sum, torch.float32, (rgb_sum.shape[0], 3)),
        ("weight_sum", weight_sum, torch.float32, (rgb_sum.shape[0],)),
        ("pixel_idx", pixel_idx, torch.int64, (pixel_idx.shape[0],)),
        ("L", L, torch.float32, (R, 4)), ("lam", lam, torch.float32, (R, 4)),
        ("pdf", pdf, torch.float32, (R, 4)), ("weight", weight, torch.float32, (R,))))
    if not rgb_sum.is_cuda or R >= 1 << 31:
        raise ValueError(f"{what}: needs CUDA tensors and fewer than 2^31 lanes, got {R} "
                         f"on {dev}")
    for name, x in (("L", L), ("lam", lam), ("pdf", pdf)):
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} rows must be 16-byte aligned (read as float4)")


def add_samples_cuda(rgb_sum, weight_sum, pixel_idx, L, lam, pdf, weight):
    """Launch the scatter entry of csrc/film.cu on the current stream (in
    place) and count the launch; same contract as add_samples_plain."""
    from pbrt_tpu_torch import kernels

    R = pixel_idx.shape[0]
    _check_samples("film_add_scatter", rgb_sum, weight_sum, pixel_idx, L, lam, pdf, weight, R)
    lib = _film_lib()
    if R == 0:
        return
    dev = rgb_sum.device
    err = lib.pbrt_film_add_scatter(
        pixel_idx.data_ptr(), L.data_ptr(), lam.data_ptr(), pdf.data_ptr(), weight.data_ptr(),
        R, cie_table(dev).data_ptr(), cie.LAMBDA_MIN, cie.LAMBDA_RANGE, rgb_sum.data_ptr(),
        weight_sum.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "film_add_scatter")
    launches["film_add_scatter"] += 1


def add_samples_tiled_cuda(rgb_sum, weight_sum, pixel_idx, L, lam, pdf, weight, k):
    """Launch the tiled entry of csrc/film.cu on the current stream (in
    place) and count the launch; same contract as add_samples_tiled_plain
    (pixel_idx (n,) distinct ids, the other arguments k n rows)."""
    from pbrt_tpu_torch import kernels

    n = pixel_idx.shape[0]
    _check_samples("film_add_samples", rgb_sum, weight_sum, pixel_idx, L, lam, pdf, weight,
                   n * k)
    if k < 1:
        raise ValueError(f"film_add_samples: k must be >= 1, got {k}")
    lib = _film_lib()
    if n == 0:
        return
    dev = rgb_sum.device
    err = lib.pbrt_film_add_tiled(
        pixel_idx.data_ptr(), L.data_ptr(), lam.data_ptr(), pdf.data_ptr(), weight.data_ptr(),
        n, k, tile_group(n, k), cie_table(dev).data_ptr(), cie.LAMBDA_MIN, cie.LAMBDA_RANGE,
        rgb_sum.data_ptr(), weight_sum.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "film_add_samples")
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
        _KERNEL.append(_build())
    if R == 0:
        return
    grid = ((R + BLOCK - 1) // BLOCK,)
    _KERNEL[0][grid](pixel_idx, L, lam, pdf, cie_table(dev), splat, R, n_lam,
                     LAMBDA_MIN=cie.LAMBDA_MIN, LAMBDA_RANGE=cie.LAMBDA_RANGE,
                     BLOCK=BLOCK, num_warps=4)
    launches["film_add_splats"] += 1
