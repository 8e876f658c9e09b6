"""Smoke test of the PyTorch/CUDA port (pbrt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero before the
result line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels from the sources in this checkout (nvcc for the CUDA
     source, Triton's JIT for the film kernel);
  3. the BVH traversal kernel (closest hit and any hit) against its plain
     version on cornell-mesh (levels 5, 16,396 triangles), 65,536 camera rays
     plus 65,536 random interior rays;
  4. the film kernel against its plain version, 131,072 lanes with NaN and
     zero-pdf lanes into a 256^2 film;
  5. a small render (cornell-mesh levels 3, 48^2, 4 spp, box filter) on the
     card against tests/goldens.npz and against the same render on the CPU;
  6. the full-width render through the normal entry point: cornell-mesh
     levels 5, 256^2, 16 spp, max depth 5, mitchell filter, with every
     kernel's launch count (each must be > 0) and the honest rays/s;
  7. each kernel against its plain version again, and timed with CUDA
     events beside its plain version, its bound and (for the film)
     PyTorch's index_add_ alone, on the arguments of its first launch in the
     full-width render: the shapes and data the main path gives it;
  8. a `kernels` JSON line; the last line is the JSON result.
Without a card, or outside a checkout of the repository, it fails.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
# float32 outside the tensor cores: the published 67 TFLOP/s counts a fused
# multiply-add as two ops; the kernels count every mul and add on its own
# (the CUDA source is built with --fmad=false), and those issue at one op a
# lane a cycle: 132 SMs x 128 lanes x 1.98 GHz, half the published rate
H100_F32_OPS_PER_S = 67e12 / 2
# float ops of one internal-row visit (8 slab tests) and of one leaf
# triangle test, counted from csrc/bvh_traverse.cu
SLAB_VISIT_OPS = 8 * 22
TRI_TEST_OPS = 78
# float ops of one film lane, counted from film/film_kernel.py
FILM_LANE_OPS = 4 * 10 + 3 * 2 + 4


def log(msg):
    print(msg, flush=True)


def events_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def require(ok, *what):
    """A phase check: raise (and so exit non-zero) when it does not hold."""
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + " ".join(map(str, what)))


def check_image(img, golden, name, atol=5e-3, rtol=0.05):
    """The image criterion of tests/test_parity.py::_check."""
    require(np.isfinite(img).all(), name)
    err = np.abs(img - golden)
    tol = atol + rtol * np.abs(golden)
    frac_bad = float((err > tol).mean())
    require(frac_bad < 0.005, name, frac_bad, float(err.max()))
    require(abs(img.mean() - golden.mean()) < 0.01 * max(golden.mean(), 1e-3),
            name, float(img.mean()), float(golden.mean()))
    return frac_bad


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
        return 2
    sys.path.insert(0, str(ROOT))
    from pbrt_tpu_torch import kernels
    from pbrt_tpu_torch.accel import bvh
    from pbrt_tpu_torch.film import film as filmlib, film_kernel, png
    from pbrt_tpu_torch.geometry import intersect as ix
    from pbrt_tpu_torch.integrators import render as rd
    from pbrt_tpu_torch.sampling import samplers
    from pbrt_tpu_torch.scene import testscenes as ts
    from pbrt_tpu_torch.scene.compile import compile_scene
    from pbrt_tpu_torch.cameras import perspective
    from pbrt_tpu_torch.utils.math import INFINITY

    dev = torch.device("cuda")
    t_start = time.time()
    # ---- 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.time()
    built = kernels.build()
    for name, (sec, report) in built.items():
        log(f"build {name}: {sec:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)})")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    probe = filmlib.new_film((4, 4), dev)
    film_kernel.add_samples_triton(
        probe.rgb_sum, probe.weight_sum, torch.zeros(1, dtype=torch.int64, device=dev),
        torch.ones((1, 4), device=dev), torch.full((1, 4), 550.0, device=dev),
        torch.ones((1, 4), device=dev), torch.ones(1, device=dev))
    torch.cuda.synchronize()
    log(f"build total (nvcc + triton jit): {time.time() - t0:.1f} s")

    # sampler streams: bit-exact between the card and the CPU
    pix = torch.arange(4096, dtype=torch.int64) * 7919 % 65536
    smp = torch.arange(4096, dtype=torch.int64) % 16
    for kind in ("independent", "stratified"):
        outs = []
        for d_ in ("cpu", "cuda"):
            r = samplers.start_pixel_sample(pix.to(d_), smp.to(d_))
            r, u2 = samplers.get_2d(r, None, kind, 16)
            r, u1 = samplers.get_1d(r, None, kind, 16)
            outs.append((r.state.cpu(), u2.cpu(), u1.cpu()))
        require(all(torch.equal(a, b) for a, b in zip(*outs)), kind)
    log("sampler streams bit-exact on the card vs CPU: ok")

    # ---- 3. BVH traversal vs plain on camera + interior rays, cornell-mesh l5
    scene, meta = compile_scene(ts.cornell_mesh_builder(levels=5, res=256), 16, device=dev)
    rows, n_int, depth = scene.bvh_rows, meta.bvh_nint, meta.bvh_depth
    log(f"cornell-mesh levels 5: {meta.n_tris} tris, {rows.shape[0]} rows "
        f"({rows.numel() * 4 / 1e6:.2f} MB), depth {depth}")
    g = torch.Generator(device="cpu").manual_seed(1234)
    n_cam = 65536
    p_film = torch.rand((n_cam, 2), generator=g) * torch.tensor(meta.resolution,
                                                                  dtype=torch.float32)
    rays = perspective.generate_rays(scene, p_film.to(dev), torch.zeros((n_cam, 2), device=dev))
    pts = torch.cat([scene.tri_p0, scene.tri_p1, scene.tri_p2]).cpu()
    lo, hi = pts.min(0).values, pts.max(0).values
    o_in = lo + (hi - lo) * (0.05 + 0.9 * torch.rand((65536, 3), generator=g))
    d_in = torch.randn((65536, 3), generator=g)
    d_in = d_in / d_in.norm(dim=-1, keepdim=True)
    o = torch.cat([rays.o, o_in.to(dev)]).contiguous()
    d = torch.cat([rays.d, d_in.to(dev)]).contiguous()
    t_max = torch.full((o.shape[0],), INFINITY, device=dev)
    t_max[::97] = 0.0                       # masked lanes
    ov0 = int(bvh.overflow_counter(dev).item())

    def compare_closest(o, d, t_max):
        """Kernel vs plain closest hit; differing winners must be verified
        ties. -> (hits, ties, max rel err of t, of b, max abs err of t)."""
        _, p_k = bvh.traverse_cuda(rows, n_int, depth, o, d, t_max)
        _, p_p = bvh.traverse_plain(rows, n_int, o, d, t_max)
        require(torch.equal(p_k >= 0, p_p >= 0), "closest hit: hit/miss disagree")

        def refit(prim):
            pc = prim.clamp(min=0)
            return ix.intersect_tri_lanes(o, d, t_max, scene.tri_p0[pc], scene.tri_p1[pc],
                                          scene.tri_p2[pc])

        tr_k, b_k, ok_k = refit(p_k)
        tr_p, b_p, ok_p = refit(p_p)
        hit = p_p >= 0
        differ = hit & (p_k != p_p)
        if bool(differ.any()):
            require(bool((ok_k[differ] & ok_p[differ]).all()), "different winner that misses")
            rel = (tr_k[differ] - tr_p[differ]).abs() / tr_p[differ].abs()
            require(float(rel.max()) <= 1e-6, "prim disagreement is not a tie",
                    float(rel.max()))
        same = hit & ~differ
        t_err = float(((tr_k - tr_p).abs() / tr_p.abs().clamp(min=1e-6))[same].max())
        b_err = float((b_k - b_p).abs()[same].max())
        require(t_err <= 1e-5 and b_err <= 1e-5, "t/b disagree", t_err, b_err)
        return (int(hit.sum()), int(differ.sum()), t_err, b_err,
                float((tr_k - tr_p).abs()[same].max()))

    def compare_any(o, d, t_max):
        _, pa_k = bvh.traverse_cuda(rows, n_int, depth, o, d, t_max, any_hit=True)
        _, pa_p = bvh.traverse_plain(rows, n_int, o, d, t_max, any_hit=True)
        n_diff = int(((pa_k >= 0) != (pa_p >= 0)).sum())
        require(n_diff == 0, "occluded disagrees on", n_diff)
        return int((pa_p >= 0).sum())

    n_hit, n_ties, t_err, b_err, _ = compare_closest(o, d, t_max)
    t_cl, _ = bvh.traverse_plain(rows, n_int, o, d, t_max)
    u = torch.rand(o.shape[0], generator=g).to(dev)
    t_sh = torch.where(t_cl < INFINITY, t_cl * 2.0 * u, 1e3)       # [0, 2 t_closest]
    t_sh[::89] = 0.0
    n_occ = compare_any(o, d, t_sh.contiguous())
    log(f"bvh vs plain on {o.shape[0]} camera+interior rays: {n_hit} hits, {n_ties} ties "
        f"(verified), max rel err t {t_err:.2e} b {b_err:.2e}; any hit {n_occ} occluded, "
        f"0 disagree")

    # ---- 4. film kernel vs plain with NaN lanes and zero pdfs, 256^2 film
    n_lanes, n_px = 131072, 256 * 256
    pix = torch.randint(0, n_px, (n_lanes,), generator=g).to(dev)
    L = (torch.rand((n_lanes, 4), generator=g) * 3.0).to(dev)
    lam = (360.0 + 470.0 * torch.rand((n_lanes, 4), generator=g)).to(dev)
    pdf = (0.001 + 0.004 * torch.rand((n_lanes, 4), generator=g)).to(dev)
    pdf[::37, 1] = 0.0
    L[::53, 2] = float("nan")
    w = (torch.rand(n_lanes, generator=g) * 2.0 - 0.5).to(dev)

    def compare_film(args):
        fk, fp = filmlib.new_film((256, 256), dev), filmlib.new_film((256, 256), dev)
        film_kernel.add_samples_triton(fk.rgb_sum, fk.weight_sum, *args)
        film_kernel.add_samples_plain(fp.rgb_sum, fp.weight_sum, *args)
        scale = float(fp.rgb_sum.abs().max())
        err = max(float((fk.rgb_sum - fp.rgb_sum).abs().max()),
                  float((fk.weight_sum - fp.weight_sum).abs().max()))
        require(torch.allclose(fk.rgb_sum, fp.rgb_sum, rtol=1e-5, atol=1e-6 * scale), err)
        require(torch.allclose(fk.weight_sum, fp.weight_sum, rtol=1e-5, atol=1e-6), err)
        return err

    film_err = compare_film((pix, L, lam, pdf, w))
    log(f"film_add_samples vs plain on {n_lanes} lanes with NaN/zero-pdf lanes: max abs err "
        f"{film_err:.2e} (rtol 1e-5: atomic order)")

    # ---- 5. small render vs golden and vs CPU
    golden = np.load(ROOT / "tests" / "goldens.npz")["cornell_mesh_l3_48_spp4"]
    b_small = ts.cornell_mesh_builder(levels=3, res=48, filter_kind="box")
    s_small, m_small = compile_scene(b_small, 4, device=dev)
    img_gpu = rd.render(s_small, m_small).cpu().numpy()
    img_cpu = rd.render(s_small, m_small, device="cpu").numpy()
    fb_g = check_image(img_gpu, golden, "cuda render vs golden")
    fb_c = check_image(img_gpu, img_cpu, "cuda render vs cpu render")
    log(f"small render 48^2 x 4 spp: vs golden {fb_g:.4%} bad px, vs cpu {fb_c:.4%} bad px, "
        f"means {img_gpu.mean():.5f} / {golden.mean():.5f} / {img_cpu.mean():.5f}")

    # ---- 6. full width through the normal entry point. A first render keeps
    # a copy of the arguments of each kernel's first launch (the shapes and
    # data the main path gives the kernels, for phase 7); the second is the
    # measured run, with the launch counts set to 0 just before it.
    captured = {}
    orig_bvh, orig_film = bvh.traverse_cuda, film_kernel.add_samples_triton

    def capture_bvh(rows_, n_int_, depth_, o_, d_, t_max_, any_hit=False, stats=None):
        captured.setdefault(any_hit, (o_.clone(), d_.clone(), t_max_.clone()))
        return orig_bvh(rows_, n_int_, depth_, o_, d_, t_max_, any_hit, stats)

    def capture_film(rgb_sum, weight_sum, *args):
        captured.setdefault("film", tuple(a.clone() for a in args))
        return orig_film(rgb_sum, weight_sum, *args)

    bvh.traverse_cuda, film_kernel.add_samples_triton = capture_bvh, capture_film
    try:
        rd.render(scene, meta)
    finally:
        bvh.traverse_cuda, film_kernel.add_samples_triton = orig_bvh, orig_film
    for k in bvh.launches:
        bvh.launches[k] = 0
    film_kernel.launches["film_add_samples"] = 0
    torch.cuda.synchronize()
    t0 = time.time()
    img, stats = rd.render(scene, meta, return_stats=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {**bvh.launches, **film_kernel.launches}
    img = img.cpu().numpy()
    n_rays = stats["closest"] + stats["shadow"]
    require(img.shape == (256, 256, 3) and np.isfinite(img).all(), "non-finite pixels")
    require(all(v > 0 for v in counts.values()), "kernel not launched", counts)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_png = kernels.BUILD_DIR / "cornell_mesh.png"
    png.write_png(str(out_png), filmlib.to_srgb8(img))
    log(f"full render 256^2 x 16 spp depth 5 mitchell: {wall:.3f} s wall, "
        f"{stats['closest']} closest + {stats['shadow']} shadow rays = "
        f"{n_rays / wall / 1e6:.3f} M rays/s; launches {counts}; "
        f"mean {img.mean():.5f}; all finite; peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB -> {out_png.relative_to(ROOT)}")

    # ---- 7. each kernel against its plain version and timed, on the
    # arguments of its first main-path launch
    def bound(nbytes, ops):
        tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_OPS_PER_S * 1e3
        return (max(tb, to), "bytes" if tb >= to else "operations")

    timing = {}
    for any_hit in (False, True):
        o_, d_, t_ = captured[any_hit]
        R = o_.shape[0]
        if any_hit:
            err = 0.0
            n_live = compare_any(o_, d_, t_)
        else:
            n_live, _, _, _, err = compare_closest(o_, d_, t_)
        work = torch.zeros(2, dtype=torch.int64, device=dev)
        bvh.traverse_cuda(rows, n_int, depth, o_, d_, t_, any_hit, stats=work)
        n_nodes, n_tris = (int(x) for x in work.cpu())
        ms = events_ms(lambda: bvh.traverse_cuda(rows, n_int, depth, o_, d_, t_, any_hit), 20)
        ms_plain = events_ms(lambda: bvh.traverse_plain(rows, n_int, o_, d_, t_, any_hit), 1)
        b = bound(rows.numel() * 4 + R * 7 * 4 + R * 8,
                  n_nodes * SLAB_VISIT_OPS + n_tris * TRI_TEST_OPS)
        name = "bvh_any_hit" if any_hit else "bvh_closest_hit"
        timing[name] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                            library_ms=None, max_abs_err=err)
        log(f"{name} at the main path's launch ({R} lanes, {n_live} "
            f"{'occluded' if any_hit else 'hits'}, {n_nodes} node visits, {n_tris} tri "
            f"tests): kernel {ms:.3f} ms, plain {ms_plain:.1f} ms, bound {b[0]:.4f} ms "
            f"({b[1]}); matches plain")
    args = captured["film"]
    n_l = args[0].shape[0]
    err = compare_film(args)
    fk = filmlib.new_film((256, 256), dev)
    ms = events_ms(lambda: film_kernel.add_samples_triton(fk.rgb_sum, fk.weight_sum, *args), 50)
    ms_plain = events_ms(lambda: film_kernel.add_samples_plain(fk.rgb_sum, fk.weight_sum,
                                                               *args), 20)
    rgbw = torch.rand((n_l, 3), device=dev)
    ms_lib = events_ms(lambda: fk.rgb_sum.index_add_(0, args[0], rgbw), 50)
    b = bound(n_l * (8 + 13 * 4) + 3 * 471 * 4 + n_px * 4 * 4, n_l * FILM_LANE_OPS)
    timing["film_add_samples"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                      library_ms=ms_lib, max_abs_err=max(err, film_err))
    log(f"film_add_samples at the main path's launch ({n_l} lanes): kernel {ms:.4f} ms, "
        f"plain {ms_plain:.3f} ms, index_add_ {ms_lib:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); "
        f"max abs err {err:.2e}")
    ov = int(bvh.overflow_counter(dev).item()) - ov0
    require(ov == 0, "traversal overflow lanes", ov)
    log("traversal overflow counter: 0")

    # ---- 8. kernels line and result
    meta_k = {
        "bvh_closest_hit": ("cuda", "pbrt_tpu_torch/csrc/bvh_traverse.cu",
                            "pbrt_tpu/accel/bvh.py:909"),
        "bvh_any_hit": ("cuda", "pbrt_tpu_torch/csrc/bvh_traverse.cu",
                        "pbrt_tpu/accel/bvh.py:1218"),
        "film_add_samples": ("triton", "pbrt_tpu_torch/film/film_kernel.py",
                             "pbrt_tpu/film/film.py:44"),
    }
    kern = [dict(name=name, route=route, source=src, replaces=rep, launches=counts[name],
                 **timing[name], ok=True)
            for name, (route, src, rep) in meta_k.items()]
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
