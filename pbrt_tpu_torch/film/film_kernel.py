"""Film sample and splat accumulation (K5, K5s): the wrappers of the CUDA
film kernel csrc/film.cu and the plain versions of its three entry points.

K5 replaces the TPU hot path pbrt_tpu/film/film.py:44 `add_samples` and :54
`add_samples_tiled` (with colorspace.py:50 `to_sensor_rgb`): per lane, look
up the CIE X, Y, Z curves at the 4 wavelengths (nearest 1 nm bin), divide L
by the wavelength pdf, average, zero non-finite components, weight, and add
into the film's rgb_sum (H*W, 3) and weight_sum (H*W,). Three entry points
(csrc/film.cu says how each is laid out on the card):
  - tiled (`film_add_samples`): a wave of k replicates of n distinct pixel
    ids, lane j n + p, as the batched loop, BDPT and the pixel-parallel
    render lay out their waves. Each pixel's k lanes are summed in a fixed
    order (`add_samples_tiled_plain` spells it out), then added to the
    pixel once: no atomics, the same bits on every run and on the CPU.
  - scatter (`film_add_scatter`): any pixel ids (the wavefront loop); one
    relaxed atomic add a component, none for a lane of weight 0, so the
    order of the sums, and their last bits, vary from run to run.
  - splats (`film_add_splats`, K5s): pbrt_tpu/film/film.py:70 `add_splats`,
    BDPT's light-tracing (t = 1) contributions, the same value with weight 1
    into the film's splat (H*W, 3), no weight sum. The wave's splats are its
    lanes' t = 1 strategies stacked, so splat i reads its wavelengths as row
    i % n_lam of the wave's (n_lam, 4) lam and pdf instead of a repeated
    copy. A thread takes a wave lane and its strategies in order; a splat
    whose L row is all zero reads nothing more and takes no atomic.
The JAX package pre-reduces the k replicates with a reshape-sum before
its scatter because the TPU's scatter is scalar-bound; the tiled entry
takes the same layout and needs no scatter at all.
"""
import ctypes

import torch

from pbrt_tpu_torch.spectral import cie, colorspace, spectra

# launches of each entry point (plain ints, added to where they launch)
launches = {"film_add_samples": 0, "film_add_scatter": 0, "film_add_splats": 0}

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
    """Plain version of K5s (in place): each splat's value in csrc/film.cu's
    order (`lane_values` with weight 1), then index_add_. Splat i reads
    wavelength row i % lam.shape[0]."""
    reps = L.shape[0] // max(lam.shape[0], 1)
    if reps != 1:
        lam, pdf = lam.repeat(reps, 1), pdf.repeat(reps, 1)
    v = lane_values(L, lam, pdf, torch.ones(L.shape[0], dtype=L.dtype, device=L.device))
    splat.index_add_(0, pixel_idx, v[:, :3])


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
        lib.pbrt_film_add_splats.argtypes = [P] * 4 + [I, I, P, I, I, P, P]
        lib.pbrt_film_add_splats.restype = I
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


def add_splats_cuda(splat, pixel_idx, L, lam, pdf):
    """Launch K5s, the splat entry of csrc/film.cu, on the current stream (in
    place) and count the launch; same contract as add_splats_plain (R
    splats, n_lam wavelength rows with n_lam dividing R)."""
    from pbrt_tpu_torch import kernels

    R, n_lam = pixel_idx.shape[0], lam.shape[0]
    dev = splat.device
    _check_args("film_add_splats", dev, (
        ("splat", splat, torch.float32, (splat.shape[0], 3)),
        ("pixel_idx", pixel_idx, torch.int64, (R,)),
        ("L", L, torch.float32, (R, 4)), ("lam", lam, torch.float32, (n_lam, 4)),
        ("pdf", pdf, torch.float32, (n_lam, 4))))
    if not splat.is_cuda or R >= 1 << 31:
        raise ValueError(f"film_add_splats: needs CUDA tensors and fewer than 2^31 splats, got "
                         f"{R} on {dev}")
    if R and (n_lam == 0 or R % n_lam):
        raise ValueError(f"film_add_splats: {n_lam} wavelength rows do not divide {R} splats")
    for name, x in (("L", L), ("lam", lam), ("pdf", pdf)):
        if x.data_ptr() % 16:
            raise ValueError(f"film_add_splats: {name} rows must be 16-byte aligned (read as "
                             f"float4)")
    lib = _film_lib()
    if R == 0:
        return
    err = lib.pbrt_film_add_splats(
        pixel_idx.data_ptr(), L.data_ptr(), lam.data_ptr(), pdf.data_ptr(), n_lam, R // n_lam,
        cie_table(dev).data_ptr(), cie.LAMBDA_MIN, cie.LAMBDA_RANGE, splat.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "film_add_splats")
    launches["film_add_splats"] += 1
