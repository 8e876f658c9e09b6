"""Render orchestration: (pixel, sample) lanes -> film -> image
(counterpart of pbrt_tpu/integrators/render.py `render` for the path
family, with one batched sample loop like its `_spp_loop`).

The lanes of one wave are `k` replicates of the whole pixel grid, sample
ids s0 .. s0+k-1. Every lane's sampler stream keys on its absolute
(pixel, sample) ids, so the estimator does not depend on how the lanes are
batched into waves; LANES_PER_WAVE is a memory/occupancy choice for the GPU
(2^20 lanes: a 256x256 x 16 spp frame in one wave).
"""
import time

import torch

from pbrt_tpu_torch.cameras import perspective
from pbrt_tpu_torch.film import film as filmlib, png
from pbrt_tpu_torch.filters import filters
from pbrt_tpu_torch.integrators import path as path_integrator
from pbrt_tpu_torch.sampling import samplers
from pbrt_tpu_torch.scene.builder import PATH_INTEGRATORS
from pbrt_tpu_torch.spectral import sampled
from pbrt_tpu_torch.utils.device import resolve_device

LANES_PER_WAVE = 1 << 20


def render_wave(scene, meta, film, pixel_ids, s0, k):
    """Trace samples s0 .. s0+k-1 of every pixel in pixel_ids (n,) and add
    them to `film` in place. -> {"closest", "shadow"} ray counts (0-dim)."""
    n_pix = pixel_ids.shape[0]
    dev = pixel_ids.device
    ids = pixel_ids.repeat(k)
    sample_ids = s0 + torch.arange(k, device=dev).repeat_interleave(n_pix)
    skind, spp = meta.sampler, meta.spp

    # camera sample: pixel (2d), lambda (1d), lens (2d, only with a lens);
    # draw order of reference evaluate_pixel_sample
    r = samplers.start_pixel_sample(ids, sample_ids)
    r, u_pixel = samplers.get_pixel_2d(r, None, skind, spp)
    fp, weight = filters.sample(scene.filt, meta.filter_kind, u_pixel)
    res_x = meta.resolution[0]
    p_film = torch.stack([(ids % res_x).to(torch.float32),
                          (ids // res_x).to(torch.float32)], dim=-1) + 0.5 + fp
    r, u_lam = samplers.get_1d(r, None, skind, spp)
    wl = sampled.sample_visible(u_lam)
    if float(scene.camera_lens_radius) > 0.0:
        r, u_lens = samplers.get_2d(r, None, skind, spp)
    else:
        u_lens = torch.zeros((ids.shape[0], 2), device=dev)
    rays = perspective.generate_rays(scene, p_film, u_lens)
    L, wl_out, stats = path_integrator.li(scene, meta, rays, wl, r, skind, spp)
    filmlib.add_samples(film, ids, L, wl_out.lam, wl_out.pdf, weight.contiguous())
    return stats


def render(scene, meta, device=None, return_stats=False):
    """Full render -> (H, W, 3) linear RGB tensor on `device` (None means
    "cuda"; without a card that raises). With return_stats, also returns
    {"closest": n, "shadow": n} counts of the rays actually traced."""
    device = resolve_device(device)
    if meta.integrator not in PATH_INTEGRATORS:
        raise NotImplementedError(f"integrator {meta.integrator!r} is not ported yet")
    if scene.device != device:
        scene = scene.to(device)
    res_x, res_y = meta.resolution
    n_pix = res_x * res_y
    film = filmlib.new_film(meta.resolution, device)
    pixel_ids = torch.arange(n_pix, device=device)
    k_max = max(1, LANES_PER_WAVE // n_pix)
    n_closest = n_shadow = 0
    s0 = 0
    while s0 < meta.spp:
        k = min(k_max, meta.spp - s0)
        if n_pix > LANES_PER_WAVE:
            stats = [render_wave(scene, meta, film, pixel_ids[t0:t0 + LANES_PER_WAVE], s0, 1)
                     for t0 in range(0, n_pix, LANES_PER_WAVE)]
        else:
            stats = [render_wave(scene, meta, film, pixel_ids, s0, k)]
        for st in stats:
            n_closest = n_closest + st["closest"]
            n_shadow = n_shadow + st["shadow"]
        s0 += k
    img = filmlib.develop(film, meta.resolution, out_matrix=meta.film_out_matrix,
                          imaging_ratio=meta.film_imaging_ratio)
    if return_stats:
        return img, {"closest": int(n_closest), "shadow": int(n_shadow)}
    return img


def render_to_png(scene, meta, out_path=None, device=None, verbose=False):
    """Render and write an sRGB PNG -> (path, seconds, ray counts)."""
    t0 = time.time()
    img, stats = render(scene, meta, device=device, return_stats=True)
    rgb8 = filmlib.to_srgb8(img)
    t1 = time.time()
    path = out_path or meta.filename
    png.write_png(path, rgb8)
    if verbose:
        rays = stats["closest"] + stats["shadow"]
        print(f"render {t1 - t0:.3f} s, {rays} rays "
              f"({rays / max(t1 - t0, 1e-9) / 1e6:.2f} M rays/s) -> {path}")
    return path, t1 - t0, stats
