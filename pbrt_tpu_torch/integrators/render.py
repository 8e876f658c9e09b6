"""Render orchestration: (pixel, sample) lanes -> film -> image
(counterpart of pbrt_tpu/integrators/render.py `render` for the path
family, its batched `_spp_loop` and its `_wavefront_loop`, for BDPT, and
its dispatch of the MLT integrators to integrators/mlt.py, which have no
film and never take the wavefront loop).

Every lane's sampler stream keys on its absolute (pixel, sample) ids, so
the estimator does not depend on how lanes are scheduled; only the order of
the film sums does. Waves of up to LANES_PER_WAVE = 2^20 lanes (`wave_lanes`:
`k` replicates of the whole pixel grid, sample ids s0 .. s0+k-1, or pixel
tiles of one sample where the grid is wider than a wave) serve the batched
loop and BDPT. A wave's film add is the tiled one (K5, csrc/film.cu): each
pixel's k lanes summed in a fixed order, no atomics, so those films are the
same bits on every run; the wavefront loop's add scatters with atomics.
Two schedules for the path family, chosen as the JAX package
chooses:
  - closed scenes: the batched loop. Each wave is traced for max_depth
    bounces (a 256x256 x 16 spp frame in one wave).
  - open scenes (infinite lights: many paths escape early): the wavefront
    loop. A persistent pool of POOL_LANES lanes takes one bounce step per
    iteration; a lane whose path ended adds its radiance to the film (K5's
    scatter entry) and is recycled with the next work item (K8,
    csrc/wavefront.cu, a single-pass scan), so the pool
    stays full instead of decaying with the live fraction.
Under a process group (parallel/dist.py, one rank per card) the path family
splits its pixels over the ranks and all-reduces films and ray counts
(`render_pixel_parallel`), or, asked for N parts, splits its geometry and
replicates its rays (`shard_scene`, K11a/K11b).
BDPT (`render_bdpt`) takes each wave through the two subpaths, the
strategies (K12 on the card), the tiled film add of L (K5) and of the t = 1
splats (K5s); develop adds the splats scaled by 1 / spp. A BDPT lane holds
(max_depth + 2) + (max_depth + 1) vertex records of ~50 floats, twice (the
walk's and K12's packed copy), and its strategies' shadow rays and splats:
caustic-glass (max depth 7, four waves) peaks at 11.25 GiB a frame on an
NVIDIA H100 80GB HBM3 (profile_render, PERF.md).
"""
import ctypes
import time

import torch
import torch.distributed

from pbrt_tpu_torch.cameras import perspective
from pbrt_tpu_torch.film import film as filmlib, png
from pbrt_tpu_torch.filters import filters
from pbrt_tpu_torch.integrators import bdpt, mlt, path as path_integrator
from pbrt_tpu_torch.parallel import dist as pdist, scene_shard
from pbrt_tpu_torch.sampling import samplers
from pbrt_tpu_torch.scene.builder import MLT_INTEGRATORS, PATH_INTEGRATORS, check_integrator
from pbrt_tpu_torch.spectral import sampled
from pbrt_tpu_torch.utils.device import resolve_device

# lanes a wave: a 128^2 x 8 BDPT frame in one wave, a 256^2 x 64 one in four
LANES_PER_WAVE = 1 << 20
# lanes of the wavefront pool; below the 2^20 work items of a 256^2 x 16 spp
# frame, so lanes are recycled there. Chosen on the H100 by the terrain frame
# time (profile_render.py, PERF.md): 2^19 lanes 0.29 s, 2^18 0.41 s, 2^17
# 0.61 s; each iteration costs the same ~2.5k eager launches at any width
POOL_LANES = 1 << 19

# launches of the recycle kernel (plain int, added to where it launches)
launches = {"wavefront_recycle": 0}


def film_samples(scene, meta, pixel_ids, sample_ids):
    """Film positions of (pixel, sample) lanes, in the draw order of
    reference evaluate_pixel_sample: pixel (2d), then lambda (1d). ->
    (p_film (R,2), wavelengths, sampler, filter weight)."""
    skind, spp = meta.sampler, meta.spp
    r = samplers.start_pixel_sample(pixel_ids, sample_ids)
    r, u_pixel = samplers.get_pixel_2d(r, None, skind, spp)
    fp, weight = filters.sample(scene.filt, meta.filter_kind, u_pixel)
    res_x = meta.resolution[0]
    p_film = torch.stack([(pixel_ids % res_x).to(torch.float32),
                          (pixel_ids // res_x).to(torch.float32)], dim=-1) + 0.5 + fp
    r, u_lam = samplers.get_1d(r, None, skind, spp)
    return p_film, sampled.sample_visible(u_lam), r, weight.contiguous()


def camera_lanes(scene, meta, pixel_ids, sample_ids, use_lens):
    """Camera samples of (pixel, sample) lanes: film_samples, then the lens
    (2d, only with a lens). -> (rays, wavelengths, sampler, filter weight)."""
    p_film, wl, r, weight = film_samples(scene, meta, pixel_ids, sample_ids)
    if use_lens:
        r, u_lens = samplers.get_2d(r, None, meta.sampler, meta.spp)
    else:
        u_lens = torch.zeros((pixel_ids.shape[0], 2), device=pixel_ids.device)
    return perspective.generate_rays(scene, p_film, u_lens), wl, r, weight


def _use_lens(scene):
    return float(scene.camera_lens_radius) > 0.0


def wave_lanes(n_pix, spp, device, pix0=0):
    """The waves of n_pix pixels (pix0 .. pix0 + n_pix - 1) x spp samples:
    yields each wave's (pixel ids, sample ids, k), (R,) int64, R <=
    LANES_PER_WAVE. A wave is a tile of n distinct pixel ids repeated for k
    samples (lane j n + p: pixel tile[p], sample s0 + j; the tile is
    ids[:n]): k = LANES_PER_WAVE // n_pix samples of every pixel or, where
    the pixel range is wider than a wave, a tile of LANES_PER_WAVE pixels at
    one sample."""
    k_max = max(1, LANES_PER_WAVE // n_pix)
    tile = min(n_pix, LANES_PER_WAVE)
    s0 = 0
    while s0 < spp:
        k = min(k_max, spp - s0)
        for t0 in range(pix0, pix0 + n_pix, tile):
            pix = torch.arange(t0, min(t0 + tile, pix0 + n_pix), device=device)
            yield pix.repeat(k), s0 + torch.arange(k, device=device).repeat_interleave(
                pix.shape[0]), k
        s0 += k


def render_wave(scene, meta, film, ids, sample_ids, k, footprints=False):
    """Trace the (pixel, sample) lanes ids, sample_ids (R,), a tile of R / k
    distinct pixels repeated k times (wave_lanes), and add them to `film` in
    place (the tiled film add). -> {"closest", "shadow"} ray counts
    (0-dim). `footprints`: path.li's."""
    rays, wl, r, weight = camera_lanes(scene, meta, ids, sample_ids, _use_lens(scene))
    L, wl_out, stats = path_integrator.li(scene, meta, rays, wl, r, meta.sampler, meta.spp,
                                          footprints)
    filmlib.add_samples_tiled(film, ids[:ids.shape[0] // k], L, wl_out.lam, wl_out.pdf,
                              weight, k)
    return stats


# ------------------------------------------------------------ wavefront (K8)

def recycle_plain(finished, in_flight, counters, total, with_rank=True):
    """Plain version of the recycle kernel. finished, in_flight (R,) bool;
    counters (2,) int64 [next_work, n_in_flight], updated in place. ->
    (rank (R,) int32 exclusive rank among finished lanes, or None without
    with_rank; work (R,) int64 = next_work + rank, recycle (R,) bool =
    finished & (work < total), in_flight (R,) bool = (in_flight & ~finished)
    | recycle)."""
    f = finished.to(torch.int32)
    rank = torch.cumsum(f, 0, dtype=torch.int32) - f
    work = counters[0] + rank.long()
    recycle = finished & (work < total)
    in_flight = (in_flight & ~finished) | recycle
    counters[0] += recycle.sum()
    counters[1] = in_flight.sum()
    return (rank if with_rank else None), work, recycle, in_flight


def _recycle_lib():
    from pbrt_tpu_torch import kernels

    lib = kernels.load("wavefront")
    if not hasattr(lib, "declared"):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pbrt_wavefront_tiles.argtypes = [I]
        lib.pbrt_wavefront_tiles.restype = I
        lib.pbrt_wavefront_recycle.argtypes = [P, P, I, ctypes.c_longlong, P, I] + [P] * 7
        lib.pbrt_wavefront_recycle.restype = I
        lib.declared = True
    return lib


# the recycle kernel's scratch on each device: its ticket word (the call's
# epoch and tile count) and two status arrays of `cap` words, one for even
# and one for odd epochs, each cleared by the call between two uses
# (csrc/wavefront.cu); so it is zeroed once, when it is allocated or grown
_SCRATCH = {}


def _recycle_scratch(dev, tiles):
    """-> (scratch, cap) for a call of `tiles` tiles on `dev`."""
    s = _SCRATCH.get(dev)
    if s is None or (s.shape[0] - 1) // 2 < tiles:
        s = _SCRATCH[dev] = torch.zeros(1 + 2 * tiles, dtype=torch.int64, device=dev)
    return s, (s.shape[0] - 1) // 2


def recycle_cuda(finished, in_flight, counters, total, with_rank=True):
    """Launch csrc/wavefront.cu on the current stream (one launch); same
    contract as recycle_plain. Calls on one device share a scratch, so they
    must be ordered (one stream)."""
    from pbrt_tpu_torch import kernels

    R, dev = finished.shape[0], finished.device
    for name, x in (("finished", finished), ("in_flight", in_flight)):
        if x.dtype != torch.bool or tuple(x.shape) != (R,) or x.device != dev \
                or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"wavefront recycle: {name} must be a contiguous, 16-byte "
                             f"aligned bool ({R},) tensor on {dev}")
    if counters.dtype != torch.int64 or counters.shape != (2,) or counters.device != dev:
        raise ValueError("wavefront recycle: counters must be an int64 (2,) tensor on the device")
    if not finished.is_cuda or not 0 < R < 1 << 30:
        raise ValueError(f"wavefront recycle: needs 0 < R < 2^30 lanes on a CUDA device, "
                         f"got {R} on {dev}")
    lib = _recycle_lib()
    scratch, cap = _recycle_scratch(dev, lib.pbrt_wavefront_tiles(R))
    rank = torch.empty(R, dtype=torch.int32, device=dev) if with_rank else None
    work = torch.empty(R, dtype=torch.int64, device=dev)
    recycle = torch.empty(R, dtype=torch.bool, device=dev)
    in_flight_out = torch.empty(R, dtype=torch.bool, device=dev)
    err = lib.pbrt_wavefront_recycle(
        finished.data_ptr(), in_flight.data_ptr(), R, int(total), scratch.data_ptr(), cap,
        rank.data_ptr() if with_rank else None, work.data_ptr(), recycle.data_ptr(),
        in_flight_out.data_ptr(), counters.data_ptr(), counters.data_ptr() + 8,
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "wavefront_recycle")
    launches["wavefront_recycle"] += 1
    return rank, work, recycle, in_flight_out


def recycle(finished, in_flight, counters, total, with_rank=True):
    """K8: the kernel on CUDA tensors, its plain version on CPU tensors."""
    if finished.is_cuda:
        return recycle_cuda(finished, in_flight, counters, total, with_rank)
    return recycle_plain(finished, in_flight, counters, total, with_rank)


def _merge(new, old, mask):
    """Per-lane select of two PathStates (or Samplers); 0-dim fields (the
    ray counters) and absent ones keep `old`."""
    out = []
    for n, o in zip(new, old):
        if isinstance(o, tuple):
            out.append(_merge(n, o, mask))
        elif o is None or o.dim() == 0:
            out.append(o)
        else:
            out.append(torch.where(mask.reshape((-1,) + (1,) * (o.dim() - 1)), n, o))
    return type(old)(*out)


def render_wavefront(scene, meta, film, pix0=0, n_pix=None, pool=None, footprints=False):
    """All meta.spp samples of the pixels pix0 .. pix0 + n_pix - 1 (default:
    the whole frame) through the wavefront loop (pbrt_tpu/integrators/
    render.py:228-345), a pool of `pool` lanes (default POOL_LANES). Work
    item w is (pixel pix0 + w % n_pix, sample w // n_pix). -> ({"closest",
    "shadow"} ray counts as 0-dim tensors, dropped work items as an int: 0 in
    a correct run)."""
    res_x, res_y = meta.resolution
    n_pix = res_x * res_y if n_pix is None else n_pix
    total = n_pix * meta.spp
    R = min(POOL_LANES if pool is None else pool, total)
    dev = film.rgb_sum.device
    use_lens = _use_lens(scene)

    def camera_lane(work):
        pix = pix0 + work % n_pix
        rays, wl, r, weight = camera_lanes(scene, meta, pix, work // n_pix, use_lens)
        return pix, weight, path_integrator.initial_state(
            rays, wl, r, path_integrator.camera_medium(scene, meta))

    pix, weight, state = camera_lane(torch.arange(R, device=dev))
    in_flight = torch.ones(R, dtype=torch.bool, device=dev)
    counters = torch.tensor([R, R], dtype=torch.int64, device=dev)  # next_work, n_in_flight
    # a path ends at the latest one step after its max_depth-th bounce (on a
    # volumetric scene interface crossings add 0.3 depth a step: ceil(max_depth
    # / 0.3) + 2 steps, JAX render.py:297-298); the loop leaves as soon as no
    # lane is in flight
    per_path = (-(-meta.max_depth * 10 // 3) + 2 if meta.volumetric else meta.max_depth + 1)
    it_bound = (-(-total // R) + 2) * per_path
    n_in_flight, it = R, 0
    while n_in_flight > 0 and it < it_bound:
        st = path_integrator.bounce_step(scene, meta, state, meta.sampler, meta.spp, footprints)
        finished = in_flight & ~st.active
        filmlib.add_samples(film, pix, st.L, st.lam, st.lam_pdf,
                            torch.where(finished, weight, 0.0))
        _, work, rec, in_flight = recycle(finished, in_flight, counters, total,
                                          with_rank=False)
        pix_n, w_n, st_n = camera_lane(torch.clamp(work, max=total - 1))
        state = _merge(st_n, st, rec)
        pix = torch.where(rec, pix_n, pix)
        weight = torch.where(rec, w_n, torch.where(finished, 0.0, weight))
        # the loop's one host sync an iteration: the in-flight count
        n_in_flight = int(counters[1])
        it += 1
    dropped = total - int(counters[0]) + n_in_flight
    return {"closest": state.n_closest, "shadow": state.n_shadow}, dropped


def render_batched(scene, meta, film, pix0=0, n_pix=None, footprints=False):
    """All meta.spp samples of the pixels pix0 .. pix0 + n_pix - 1 (default:
    the whole frame) through the batched loop (pbrt_tpu/integrators/
    render.py `_spp_loop`): waves of up to LANES_PER_WAVE lanes, each traced
    for max_depth bounces. -> {"closest", "shadow"} ray counts as 0-dim
    tensors."""
    res_x, res_y = meta.resolution
    n_pix = res_x * res_y if n_pix is None else n_pix
    n_closest = n_shadow = 0
    for ids, sample_ids, k in wave_lanes(n_pix, meta.spp, film.rgb_sum.device, pix0):
        st = render_wave(scene, meta, film, ids, sample_ids, k, footprints)
        n_closest = n_closest + st["closest"]
        n_shadow = n_shadow + st["shadow"]
    return {"closest": n_closest, "shadow": n_shadow}


def render_bdpt(scene, meta, film):
    """All meta.spp samples of every pixel through BDPT
    (pbrt_tpu/integrators/render.py:42-83, 677-695): waves of up to
    LANES_PER_WAVE (pixel, sample) lanes (wave_lanes), each a camera sample
    without a lens draw, li_bdpt, then K5 for L and K5s for the splats. ->
    {"closest", "shadow"} ray counts as 0-dim tensors."""
    res_x, res_y = meta.resolution
    n_closest = n_shadow = 0
    for ids, sample_ids, k in wave_lanes(res_x * res_y, meta.spp, film.rgb_sum.device):
        p_film, wl, r, weight = film_samples(scene, meta, ids, sample_ids)
        L, (splat_pix, splat_L), stats = bdpt.li_bdpt(scene, meta, p_film, r, wl,
                                                      meta.sampler, meta.spp)
        lam, pdf = wl.lam.contiguous(), wl.pdf.contiguous()
        filmlib.add_samples_tiled(film, ids[:ids.shape[0] // k], L.contiguous(), lam, pdf,
                                  weight, k)
        filmlib.add_splats(film, splat_pix, splat_L, lam, pdf)
        n_closest = n_closest + stats["closest"]
        n_shadow = n_shadow + stats["shadow"]
    return {"closest": n_closest, "shadow": n_shadow}


def write_heatmap_png(path, heat):
    """Normalized grayscale PNG of an MLT sampling-density heatmap (H, W)
    (reference film/grey_scale_film.cu write_to_png)."""
    h = heat.detach().cpu().to(torch.float32)
    g = h / max(float(h.max()), 1e-12)
    g8 = torch.round(torch.clamp(g, 0.0, 1.0) * 255.0).to(torch.uint8)
    png.write_png(path, g8[..., None].expand(*g8.shape, 3).numpy())


def shard_scene(scene, n_parts):
    """The scene with its triangle soup split into n_parts morton parts
    (parallel/scene_shard.py, host numpy), of which Scene.shard holds this
    rank's `part_range` on the scene's device. A render of such a scene is
    scene-sharded (pbrt_tpu/integrators/render.py:460-540): rays are
    replicated on every rank, each rank traverses only its parts (K11a/K11b),
    and under a process group every closest hit and shadow ray is resolved
    across ranks, so every rank's film comes out whole. render() takes the
    path family only, as the JAX package does."""
    shard = scene_shard.build_scene_shard(scene, n_parts)
    return scene.with_shard(shard.local(pdist.rank(), pdist.world()).to(scene.device))


def render_pixel_parallel(scene, meta, film, footprints=False):
    """The path family under a process group of W ranks (pbrt_tpu/
    integrators/render.py:361-450, `render_wavefront_sharded` and
    `render_spp_fused_sharded`): rank r renders the pixels [r n / W, (r + 1)
    n / W) with all their samples, the wavefront loop with a pool of
    max(1024, POOL_LANES // W) lanes, then the films and ray counts are
    all-reduced. Sample streams key on absolute (pixel, sample) ids, so the
    image and the ray count are the single-process ones. A world size that
    does not divide the pixel count renders the whole frame on every rank.
    -> (ray counts, dropped work items), summed over the ranks."""
    n_pix = meta.resolution[0] * meta.resolution[1]
    W = pdist.world()
    split = torch.distributed.is_initialized() and n_pix % W == 0
    pix0, n_loc = (pdist.rank() * (n_pix // W), n_pix // W) if split else (0, n_pix)
    dropped = 0
    if meta.open_scene:
        stats, dropped = render_wavefront(scene, meta, film, pix0, n_loc,
                                          pool=max(1024, POOL_LANES // W) if split else None,
                                          footprints=footprints)
    else:
        stats = render_batched(scene, meta, film, pix0, n_loc, footprints)
    if split:
        pdist.all_reduce_film(film)
        dev = film.rgb_sum.device
        counts = torch.stack([torch.as_tensor(v, dtype=torch.int64, device=dev)
                              for v in (stats["closest"], stats["shadow"], dropped)])
        torch.distributed.all_reduce(counts)
        stats, dropped = {"closest": counts[0], "shadow": counts[1]}, int(counts[2])
    return stats, dropped


def render(scene, meta, device=None, return_stats=False, heatmap_path=None, shard_parts=0,
           footprints=False):
    """Full render -> (H, W, 3) linear RGB tensor on `device` (None means
    "cuda"; without a card that raises). MLT scenes take mlt.render_mlt
    (and write their sampling-density heatmap to heatmap_path, if given);
    BDPT scenes take render_bdpt; of the path family, open scenes take the
    wavefront loop, closed ones the batched loop, split over the ranks of a
    process group by pixels (render_pixel_parallel); with shard_parts = N >
    0 (or a scene whose shard is set, see shard_scene) the geometry is split
    into N parts over the ranks instead, and the batched loop renders the
    frame, as in the JAX package. BDPT and MLT frames are not split: each
    rank renders them whole. With return_stats, also returns {"closest": n,
    "shadow": n} counts of the rays actually traced (BDPT: subpath segments
    and attempted connections; MLT: of every evaluation, and "mutations"),
    and a path-family render prints its bounce step's route
    (path.step_route: "cuda", the kernels of csrc/path_step.cu, or
    "plain"). `footprints` (the path family, as JAX render.py:168, :231):
    image textures average four taps over the uv footprint of the camera
    differentials; off by default."""
    device = resolve_device(device)
    check_integrator(meta.integrator)
    if scene.device != device:
        scene = scene.to(device)
    if (shard_parts or scene.shard is not None) and meta.integrator not in PATH_INTEGRATORS:
        raise ValueError(f"scene sharding supports the path family, not {meta.integrator!r}")
    if shard_parts:
        scene = shard_scene(scene, shard_parts)
    if meta.integrator in MLT_INTEGRATORS:
        img, heat, stats = mlt.render_mlt(scene, meta, device=device, return_heatmap=True)
        if heatmap_path:
            write_heatmap_png(heatmap_path, heat)
        return (img, stats) if return_stats else img
    film = filmlib.new_film(meta.resolution, device)
    splat_scale = 0.0
    if scene.shard is not None:
        stats = render_batched(scene, meta, film, footprints=footprints)
    elif meta.integrator == "bdpt":
        stats = render_bdpt(scene, meta, film)
        splat_scale = 1.0 / meta.spp
    else:
        stats, dropped = render_pixel_parallel(scene, meta, film, footprints)
        if dropped != 0:
            raise RuntimeError(f"wavefront loop dropped {dropped} work items "
                               "(its iteration bound tripped)")
    img = filmlib.develop(film, meta.resolution, out_matrix=meta.film_out_matrix,
                          imaging_ratio=meta.film_imaging_ratio, splat_scale=splat_scale)
    if return_stats:
        if meta.integrator in PATH_INTEGRATORS:
            print(f"render: path step route {path_integrator.step_route(device, meta)}",
                  flush=True)
        return img, {k: int(v) for k, v in stats.items()}
    return img


def render_to_png(scene, meta, out_path=None, device=None, verbose=False, heatmap_path=None,
                  shard_parts=0):
    """Render and write an sRGB PNG (and, for MLT, the heatmap PNG to
    heatmap_path if given; under a process group, rank 0 alone writes) ->
    (path, seconds, ray counts)."""
    t0 = time.time()
    img, stats = render(scene, meta, device=device, return_stats=True,
                        heatmap_path=heatmap_path if pdist.rank() == 0 else None,
                        shard_parts=shard_parts)
    rgb8 = filmlib.to_srgb8(img)
    t1 = time.time()
    path = out_path or meta.filename
    if pdist.rank() != 0:
        return path, t1 - t0, stats
    png.write_png(path, rgb8)
    if verbose:
        rays = stats["closest"] + stats["shadow"]
        print(f"render {t1 - t0:.3f} s, {rays} rays "
              f"({rays / max(t1 - t0, 1e-9) / 1e6:.2f} M rays/s) -> {path}")
    return path, t1 - t0, stats
