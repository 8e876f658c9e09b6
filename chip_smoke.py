"""Smoke test of the PyTorch/CUDA port (pbrt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero before the
result line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels from the sources in this checkout (one nvcc per CUDA
     source, all started together; Triton's JIT for the film kernel);
  3. the BVH traversal kernel (closest hit and any hit) against its plain
     version on cornell-mesh (levels 5, 16,396 triangles), 65,536 camera rays
     plus 65,536 random interior rays;
  4. the film kernel against its plain version, 131,072 lanes with NaN and
     zero-pdf lanes into a 256^2 film; the splat kernel (K5s) likewise,
     three strategies' splats over 43,690 lanes' wavelengths;
  5. the dense kernels (K3 triangles, K4 spheres and disks) against their
     plain versions on 131,072 camera and interior rays of the plain cornell
     box and of caustic-glass, and on synthetic partial spheres and disks
     (z window, phimax < 2 pi, inner radius) with masked lanes;
  6. the wavefront recycle kernel (K8) against torch.cumsum's plain version
     on random finished masks at the pool size, next_work near the end too;
     the layered BxDF kernel (K7: layered_f, layered_sample, layered_pdf)
     against its plain version on 2^18 synthetic lanes (tests/
     layered_cases.py: smooth and rough coats, a medium with g in {-0.5, 0,
     0.7}, smooth and rough conductor bases, wo below the horizon and
     grazing). K7 is not bit-exact (its transcendentals round apart from
     torch's, and the walk compares its draws with them), so it is held
     statistically: valid and flags equal on >= 99.9 % of lanes; f, wi and
     pdf within rtol 1e-4, atol 1e-6 on >= 99.5 %; lane means of f, pdf and
     f |cos| / pdf within 1e-3 relative; the fractions are printed;
  7. small renders on the card against tests/goldens.npz and against the
     same render on the CPU: cornell-mesh levels 3 at 48^2 x 4 spp, the plain
     cornell box at 64^2 x 8 spp (box filter), caustic-glass with the path
     integrator at 48^2 x 4 spp (card against CPU; its disk light runs the
     disk kernel), and material-testball at 32^2 x 4 spp (box filter, card
     against CPU; the walk seeds on float bits, which differ between the two
     by an ulp, so the renders are independent estimates and are compared on
     16x16-pixel block means and the image mean); then BDPT: cornell 24^2 x
     8 (box filter) against tests/goldens.npz's cornell_bdpt_24_spp8 and
     the CPU render, caustic-glass (its file's BDPT, max depth 7) at 32^2 x
     4 and cornell-mesh levels 3 at 48^2 x 4 (the BVH route) against the CPU
     render;
  8. the full-width renders through the normal entry point, 256^2, 16 spp,
     max depth 5, mitchell filter: cornell-mesh levels 5 (BVH), the plain
     cornell box (dense), terrain (130,050 PLY triangles, sky and sun: the
     wavefront loop; its compile seconds, and its honest ray count equal to
     the same frame through the batched loop); then the coated scenes at
     their files' settings, each rendered once: staircase (63,212 triangles,
     coateddiffuse; 256^2 x 256 spp stratified, max depth 8; its compile
     seconds, rays/s and peak memory) and material-testball
     (coatedconductor, partial-sphere pedestal; 256^2 x 64 spp, max depth
     6); then BDPT at the bench's settings: cornell-bdpt (128^2 x 8, max
     depth 5, one wave) and caustic-glass at its file's (256^2 x 64, max
     depth 7, four waves of 2^20 lanes). Each is driven with the launch
     counts set to 0 just before it and read just after; every kernel of its
     path must have launched (a BDPT frame: exactly K12's two entry points,
     one K5, one K5s and one occluded dispatch a wave, and 2 max_depth + 1
     closest-hit dispatches);
  9. each kernel against its plain version again, and timed beside its
     plain version, its bound and (film: index_add_; recycle: torch.cumsum)
     one PyTorch call: the kernel and the library call from CUDA-graph
     replays (device time, without the host's time to launch each call,
     which the log prints beside it), the plain version with CUDA events;
     all on the arguments of its first
     launch in the full-width render of its path: the shapes and data the
     main path gives it (the BVH kernel on terrain and staircase is timed
     only: the plain sweep over 63k-130k triangles is not repeated); K7's
     three entry points on their first launches in the staircase and
     testball frames, against the plain version on the coated lanes, timed
     on staircase's; K12 on the first waves of the two BDPT frames and on a
     24^2 x 2 wave of tests/bdpt_cases.py's four-light scene (distant, spot,
     uniform infinite and three kinds of area light) against its plain
     version (bdpt_cases: every strategy within rtol 1e-4, atol 1e-6 on >=
     99.99 % of its live lanes, equal ray counts), both entry points timed
     on caustic-glass's; K5s on caustic-glass's first launch;
 10. MLT: cornell 24^2 with mltpath and mltbdpt (1024 chains, 18 passes)
     on the card and on the CPU with one seed (tests/mlt_cases.py: >= 99 %
     of the (chain, pass) accept decisions equal, 8x8 block means within
     5 %); caustic-glass with mlt (MLT over BDPT, max depth 7) and
     cornell-mesh levels 5 with mltpath (max depth 5) at 256^2 with 8192
     chains through render(), cut from 100 to 4 and 8 mutations per pixel
     (32 and 64 passes) so that the phase fits this script's time, each
     with K12m-a and K12m-b launched exactly once a pass and its image mean
     within mlt_cases.FRAME_MEAN_RTOL of phase 8's BDPT or path frame; both
     kernels against their plain versions on those frames' first passes
     (draws and chain state bit-exact, splat sums within 1e-5) and timed on
     caustic-glass's beside their byte bounds, plain versions and (K12m-b)
     index_add_;
 11. scene sharding (K11a `bvh_closest_hit_parts`, K11b `bvh_any_hit_parts`,
     `shard_select`, csrc/scene_shard.cu): (a) cornell-mesh levels 5 split
     into 8 morton parts (per-part tables under a quarter of the unsharded
     ones); on phase 3's 131,072 camera and interior rays K11a's candidate
     packs and K11b's bits bit-exact with their plain versions and with the
     unfused yardstick (K1 over each part, then an argmin); against the
     unsharded K1 equal hit sets, t within rtol 1e-5, the same triangle on
     >= 99 % of hits and equal t on the rest; the select kernel bit-exact
     with its plain version on 4 stacked packs with planted ties; (b) the
     scene-sharded frames through render() of the scene split by
     render.shard_scene (its host build timed alone): cornell-mesh (8 parts)
     and terrain (4 parts, the batched loop) at phase 8's settings, K11a and
     K11b launched and K1 not, the ray counts equal to phase 8's frames
     (terrain: the batched loop's), the images within check_image of them;
     (c) NCCL at world size 1 (a file store): the pixel-parallel cornell-mesh
     frame (its film all-reduced) and the scene-sharded one through
     render(shard_parts=8), as the CLI's --shard-scene calls it (every
     closest hit through an all_gather and the select kernel, every shadow
     batch through an all_reduce), each with phase 8's ray count and image;
     (d) K11a and K11b at their first
     launches in (b)'s cornell-mesh frame (2^20 lanes) and the select
     kernel at its first in (c): held against their plain versions again
     (K11a bit-exact but for verified ties, K1's criterion of phases 3 and
     9: a winner that differs must hit at a t within 1e-6 relative of the
     other's; over 2^20 lanes a tie decided by the traversal order or by
     the bound carried across parts occurs), and timed beside them, their
     operation or byte bounds and the unfused yardstick. Scaling across cards is not measurable on
     one card;
 12. instancing (K1i `bvh_closest_hit_inst`, `bvh_any_hit_inst`, the
     two-level variant of csrc/bvh_traverse.cu over csrc/bvh_stepper.cuh),
     on the instanced cornell box of testscenes.instanced_cornell_pbrt (36
     ball and 16 gem instances): (a) at levels (3, 2), every instance shared, on 131,072
     camera and 131,072 interior rays: closest hit bit-exact with the plain
     version (t, prim and inst) but on verified ties (K1's criterion), any
     hit equal; against K1 on the same scene flattened: hit masks equal on
     >= 99.99 % of lanes and t within rtol 1e-4 plus 1e-5 of the ray
     origin's magnitude on every common hit (flattening rounds the vertices
     in float64, K1i the ray in float32, both at the coordinates' scale; the
     fraction within rtol 1e-4 alone is printed); (b) the scene at 48^2
     x 4 (path) on the card against the CPU and against the card's
     flattened render, at 24^2 x 8 through BDPT (K12, K5s and K1i launched)
     against the CPU, and 1024 chains of mltpath at 24^2 on the card and the
     CPU with one seed (tests/mlt_cases.py's criteria); (c) the full-width
     frame cornell-instanced at levels (6, 5) under instancing "auto"
     (1,310,732 world triangles: 253,964 flattened, 29 + 13 instances of 2
     prototypes of 40,960 triangles) at 256^2 x 16, max depth 5, mitchell,
     through render(): K1i launched and K1 not, its compile seconds, honest
     rays/s (median and quartiles over repeated renders), frame seconds,
     peak memory and table bytes; then the same file flattened (K1), its ray
     count within 1 % and its image against the instanced one: means within
     1 % and check_image's per-pixel tolerance on >= 98 % of pixel values
     (the twins round their geometry apart, and a path that an ulp turns at
     a glass or glossy surface moves its pixel at 16 spp), while the noise
     floor, the flattened frame against its own second estimate (samples
     16..31), must fall outside that 2 %; where the bad pixels lie (gems,
     balls) is printed with the same numbers; (d) K1i at its first launches
     in (c)'s frame (2^20 lanes): held against its plain version on those
     arguments (closest hit bit-exact but on verified ties, any hit equal),
     and timed beside its operation bound, the plain version and the
     flattened frame's K1 on the same rays (a yardstick, not a library
     call);
 13. a `kernels` JSON line; the last line is the JSON result.
Without a card, or outside a checkout of the repository, it fails.
"""
import dataclasses
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
# (the CUDA sources are built with --fmad=false), and those run at one op
# a lane a cycle: 132 SMs x 128 lanes x 1.98 GHz, half the published rate
H100_F32_OPS_PER_S = 67e12 / 2
# float ops counted from the CUDA sources: one internal-row visit (8 slab
# tests); a triangle test by how far it goes (watertight.cuh): every test
# to the edge-sign exit, those past it to the det / t-range exit, those past
# that to the t error bound, and the barycentrics of a refit winner; one
# sphere and one disk candidate of dense_intersect.cu, and the reprojection
# of a sphere hit
SLAB_VISIT_OPS = 8 * 22
TRI_EDGE_OPS, TRI_RANGE_OPS, TRI_BOUND_OPS, TRI_BARY_OPS = 30, 11, 33, 3
TRI_FULL_OPS = TRI_EDGE_OPS + TRI_RANGE_OPS + TRI_BOUND_OPS
SPHERE_TEST_OPS = 35
SPHERE_HIT_OPS = 30
DISK_TEST_OPS = 36
# float ops of one film lane, counted from film/film_kernel.py
FILM_LANE_OPS = 4 * 10 + 3 * 2 + 4
# float ops of K12 per lane and strategy, counted from csrc/bdpt.cu and
# csrc/bxdf.cuh and rounded down: bdpt_connect_rays forms a strategy's
# connection (one or two directions and BSDF values in local frames, the
# geometry term, the offset shadow ray: ~100); bdpt_connect_weight forms it
# again and the MIS weight (four junction pdfs, each a direction, a BSDF,
# camera or light pdf and an area conversion, ~60, and the ratio walks)
K12_OPS = {"bdpt_connect_rays": 100, "bdpt_connect_weight": 400}
# float ops of K7, counted from csrc/layered.cu and csrc/bxdf.cuh for the
# main path's lanes (a rough dielectric coat over a diffuse or rough
# conductor base, no medium), rounded down: a rough dielectric sample ~150,
# its f or pdf ~100; a diffuse sample ~20, its pdf ~10; a conductor sample
# ~400 (four complex Fresnel terms). (per lane, per step): layered_f per
# lane f_enter and two samples, per walk step a boundary event (an exit
# resample, or NEE through the base plus a base resample and the coat's f
# and pdf); layered_sample per lane the coat's sample, per step one
# interface sample; layered_pdf per lane with wo and wi on one side the
# coat's pdf and two samples, per lane that reaches the base its pdf
LAYERED_OPS = {"layered_f": (400, 250), "layered_sample": (150, 100),
               "layered_pdf": (400, 10)}
# float ops of one instance entry of K1i, counted from csrc/bvh_stepper.cuh
# and csrc/watertight.cuh: two 3x4 transforms (a dot product is a multiply
# and two fused multiply-adds, 5 ops; the origin adds its translation: 18 +
# 15), the shear (10) and 1/d (12)
INST_ENTRY_OPS = 55
# float ops of K12m-a per chain and dimension, counted from csrc/mlt.cu:
# two uniforms (a multiply and a min each), erfinv (~15 with its log and
# two square roots), the perturbation, the wrap and the clip (~8)
MUTATE_OPS = 25


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


def graph_ms(fn, calls=20, reps=5):
    """Device milliseconds of one fn() call: `calls` calls captured in one
    CUDA graph, replayed `reps` times between CUDA events, so the host's
    time to launch each call (argument checks, output allocations, the
    launch) is not counted. fn launches on the current stream and does not
    synchronize."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * calls)


def kernel_ms(fn, reps=50):
    """(device ms of one call from graph_ms, ms of one call launched by
    the host back to back, from events_ms)."""
    return graph_ms(fn), events_ms(fn, reps)


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


def bound(nbytes, ops):
    """(least ms, "bytes" or "operations") of the H100 for the work."""
    tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_OPS_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def tri_test_ops(n_tests, n_edge, n_range):
    """Float ops of n_tests watertight tests of which n_edge got past the
    edge-sign test and n_range past the t-range test."""
    return n_tests * TRI_EDGE_OPS + n_edge * TRI_RANGE_OPS + n_range * TRI_BOUND_OPS


def tri_stages(o, d, t_max, p0, p1, p2):
    """(R, T) masks of how far the watertight test of every ray against
    every triangle goes at a fixed t_max (csrc/watertight.cuh, the plain
    arithmetic of geometry/intersect.py): past the edge-sign test, and past
    the det and t-range tests."""
    from pbrt_tpu_torch.geometry import intersect as ix

    kz, sx, sy, sz = (x[:, None] for x in ix.ray_shear(d))
    a, b, c = (ix.permute_by_kz(p[None] - o[:, None], kz) for p in (p0, p1, p2))
    ax, ay = a[0] + sx * a[2], a[1] + sy * a[2]
    bx, by = b[0] + sx * b[2], b[1] + sy * b[2]
    cx, cy = c[0] + sx * c[2], c[1] + sy * c[2]
    e0, e1, e2 = cx * by - cy * bx, ax * cy - ay * cx, bx * ay - by * ax
    edge = ~(((e0 < 0) | (e1 < 0) | (e2 < 0)) & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    ts = e0 * (sz * a[2]) + e1 * (sz * b[2]) + e2 * (sz * c[2])
    tm = t_max[:, None] * det
    in_range = torch.where(det < 0, (ts < 0) & (ts > tm), (ts > 0) & (ts < tm))
    return edge, edge & (det != 0) & in_range


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from quadric_edges import clip_edge_distance
    from layered_cases import (ATOL, BXDF_FIELDS, CASES as LAYERED_CASES, CLOSE_FRAC,
                               EQUAL_FRAC, MEAN_RTOL, RTOL, blocks, frac_close,
                               lanes as layered_lanes)
    import bdpt_cases
    import mlt_cases
    from pbrt_tpu_torch import kernels
    from pbrt_tpu_torch.accel import bvh, dispatch
    from pbrt_tpu_torch.film import film as filmlib, film_kernel, png
    from pbrt_tpu_torch.geometry import intersect as ix
    from pbrt_tpu_torch.integrators import bdpt, mlt, render as rd
    from pbrt_tpu_torch.materials import bxdfs, layered
    from pbrt_tpu_torch.parallel import scene_shard as ss
    from pbrt_tpu_torch.sampling import samplers
    from pbrt_tpu_torch.scene import builder as bd, testscenes as ts
    from pbrt_tpu_torch.scene.compile import compile_scene, load_scene
    from pbrt_tpu_torch.cameras import perspective
    from pbrt_tpu_torch.utils.math import INFINITY

    dev = torch.device("cuda")
    t_start = time.time()
    counters = (bvh.launches, film_kernel.launches, ix.launches, rd.launches, layered.launches,
                bdpt.launches, mlt.launches, ss.launches)

    def reset_counts():
        for c in counters:
            for k in c:
                c[k] = 0

    def read_counts():
        return {k: v for c in counters for k, v in c.items()}

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
            if "Function properties for" in line:
                log(f"  ptxas: {line.split(' for ', 1)[1].strip()}")
            elif "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    probe = filmlib.new_film((4, 4), dev)
    film_kernel.add_samples_triton(
        probe.rgb_sum, probe.weight_sum, torch.zeros(1, dtype=torch.int64, device=dev),
        torch.ones((1, 4), device=dev), torch.full((1, 4), 550.0, device=dev),
        torch.ones((1, 4), device=dev), torch.ones(1, device=dev))
    film_kernel.add_splats_triton(
        probe.splat, torch.zeros(1, dtype=torch.int64, device=dev), torch.ones((1, 4), device=dev),
        torch.full((1, 4), 550.0, device=dev), torch.ones((1, 4), device=dev))
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

    g = torch.Generator(device="cpu").manual_seed(1234)

    def camera_and_interior_rays(scene, meta, n_cam=65536, n_in=65536):
        """n_cam camera rays plus n_in random interior rays of the scene's
        triangle bounds; every 97th lane masked (t_max = 0)."""
        p_film = torch.rand((n_cam, 2), generator=g) * torch.tensor(meta.resolution,
                                                                      dtype=torch.float32)
        rays = perspective.generate_rays(scene, p_film.to(dev), torch.zeros((n_cam, 2),
                                                                            device=dev))
        pts = torch.cat([scene.tri_p0, scene.tri_p1, scene.tri_p2]).cpu()
        lo, hi = pts.min(0).values, pts.max(0).values
        o_in = lo + (hi - lo) * (0.05 + 0.9 * torch.rand((n_in, 3), generator=g))
        d_in = torch.randn((n_in, 3), generator=g)
        d_in = d_in / d_in.norm(dim=-1, keepdim=True)
        o = torch.cat([rays.o, o_in.to(dev)]).contiguous()
        d = torch.cat([rays.d, d_in.to(dev)]).contiguous()
        t_max = torch.full((o.shape[0],), INFINITY, device=dev)
        t_max[::97] = 0.0
        return o, d, t_max

    def shadow_t(t_closest):
        """Shadow-ray lengths in [0, 2 t_closest], every 89th lane masked."""
        u = torch.rand(t_closest.shape[0], generator=g).to(dev)
        t = torch.where(t_closest < INFINITY, t_closest * 2.0 * u, 1e3)
        t[::89] = 0.0
        return t.contiguous()

    # ---- 3. BVH traversal vs plain on camera + interior rays, cornell-mesh l5
    scene, meta = compile_scene(ts.cornell_mesh_builder(levels=5, res=256), 16, device=dev)
    rows, n_int, depth = scene.bvh_rows, meta.bvh_nint, meta.bvh_depth
    log(f"cornell-mesh levels 5: {meta.n_tris} tris, {rows.shape[0]} rows "
        f"({rows.numel() * 4 / 1e6:.2f} MB), depth {depth}")
    o, d, t_max = camera_and_interior_rays(scene, meta)
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
    n_occ = compare_any(o, d, shadow_t(t_cl))
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

    def compare_splats(args):
        """K5s vs its plain version into fresh 256^2 films -> max abs err."""
        fk, fp = filmlib.new_film((256, 256), dev), filmlib.new_film((256, 256), dev)
        film_kernel.add_splats_triton(fk.splat, *args)
        film_kernel.add_splats_plain(fp.splat, *args)
        scale = float(fp.splat.abs().max())
        err = float((fk.splat - fp.splat).abs().max())
        require(torch.allclose(fk.splat, fp.splat, rtol=1e-5, atol=1e-6 * scale), "K5s", err)
        return err

    # three strategies' splats over one wave's lanes: wavelength row i % n_lam
    n_lam = n_lanes // 3
    splat_err = compare_splats((pix[:3 * n_lam], L[:3 * n_lam], lam[:n_lam], pdf[:n_lam]))
    log(f"film_add_splats vs plain on {3 * n_lam} splats over {n_lam} lanes' wavelengths with "
        f"NaN/zero-pdf lanes: max abs err {splat_err:.2e} (rtol 1e-5: atomic order)")

    # ---- 5. dense kernels (K3, K4) vs plain
    def compare_dense_tris(o, d, t_max, tris, any_hit=False):
        """K3 vs plain: prim ids, t and barycentrics bit for bit; any hit
        identical. -> (lanes hit or occluded, max abs err of t)."""
        if any_hit:
            k = ix.dense_tris_cuda(o, d, t_max, *tris, any_hit=True)
            require(torch.equal(k, ix.occluded_tris_dense_plain(o, d, t_max, *tris)),
                    "dense any hit disagrees")
            return int(k.sum()), 0.0
        k = ix.dense_tris_cuda(o, d, t_max, *tris)
        p = ix.intersect_tris_dense_plain(o, d, t_max, *tris)
        require(torch.equal(k.prim, p.prim), "dense tri prim ids differ",
                int((k.prim != p.prim).sum()))
        require(torch.equal(k.t, p.t) and torch.equal(k.b, p.b), "dense tri t/b differ")
        return int((p.prim >= 0).sum()), 0.0

    def compare_quadrics(kind, o, d, t_max, soa):
        """K4 vs plain: winners equal but on lanes within 1e-5 of a clip edge
        (atan2f vs torch.atan2); t, p, n to 1e-6 relative. -> (hits,
        edge disagreements, max abs err of t)."""
        cuda_fn = ix.dense_spheres_cuda if kind == "spheres" else ix.dense_disks_cuda
        plain_fn = (ix.intersect_spheres_dense_plain if kind == "spheres"
                    else ix.intersect_disks_dense_plain)
        tk, ik, pk, nk = cuda_fn(o, d, t_max, soa)
        tp, ip, pp, np_ = plain_fn(o, d, t_max, soa)
        differ = ik != ip
        n_edge = int(differ.sum())
        if n_edge:
            margin = clip_edge_distance(o[differ], d[differ],
                                        soa if kind == "spheres" else None,
                                        soa if kind == "disks" else None)
            require(bool((margin < 1e-5).all()), f"{kind}: a disagreement off the clip edges",
                    float(margin.max()))
        same = ~differ & (ip >= 0)
        require(torch.allclose(tk[same], tp[same], rtol=1e-6), kind, "t differs")
        require(torch.allclose(pk[same], pp[same], rtol=1e-6, atol=1e-6), kind, "p differs")
        require(torch.allclose(nk[same], np_[same], rtol=1e-6, atol=1e-6), kind, "n differs")
        err = float((tk[same] - tp[same]).abs().max()) if bool(same.any()) else 0.0
        return int((ip >= 0).sum()), n_edge, err

    s_corn, m_corn = ts.cornell(res=256, spp=16, device=dev)
    s_caus, m_caus = load_scene(str(ROOT / "scenes" / "caustic-glass.pbrt"), device=dev,
                                spp=4, integrator="path")
    for label, sc, mt in (("cornell", s_corn, m_corn), ("caustic-glass", s_caus, m_caus)):
        o, d, t_max = camera_and_interior_rays(sc, mt)
        tris = (sc.tri_p0, sc.tri_p1, sc.tri_p2)
        n_h, _ = compare_dense_tris(o, d, t_max, tris)
        t_cl = ix.intersect_tris_dense_plain(o, d, t_max, *tris).t
        n_o, _ = compare_dense_tris(o, d, shadow_t(t_cl), tris, any_hit=True)
        msg = f"dense kernels vs plain on {label} ({o.shape[0]} rays): tris {n_h} hits " \
              f"(prim/t/b bit-exact), {n_o} occluded (identical)"
        n_s = compare_quadrics("spheres", o, d, t_max, ix.SphereSoA(
            sc.sph_center, sc.sph_radius, table=sc.sph_table))
        msg += f"; spheres {n_s[0]} hits, max abs err t {n_s[2]:.2e}"
        if mt.n_disks:
            n_d = compare_quadrics("disks", o, d, t_max, ix.DiskSoA(
                sc.dsk_center, sc.dsk_normal, sc.dsk_radius, sc.dsk_inner, table=sc.dsk_table))
            msg += f"; disks {n_d[0]} hits, max abs err t {n_d[2]:.2e}"
        log(msg)

    # synthetic partial quadrics in [-1, 1]^3, masked and short lanes
    rng = np.random.default_rng(7)
    nq = 32
    rot = np.linalg.qr(rng.normal(size=(nq, 3, 3)))[0]
    rad = rng.uniform(0.1, 0.4, nq)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    sph_p = ix.with_table(ix.SphereSoA(f(rng.uniform(-0.8, 0.8, (nq, 3))), f(rad), f(rot),
                         f(-rad * rng.uniform(0.2, 1.0, nq)), f(rad * rng.uniform(0.2, 1.0, nq)),
                         f(rng.uniform(1.0, 2 * np.pi, nq))))
    dsk_p = ix.with_table(ix.DiskSoA(f(rng.uniform(-0.8, 0.8, (nq, 3))), f(rot[:, 2]), f(rad),
                       f(rad * rng.uniform(0.0, 0.5, nq)), f(rot[:, 0]),
                       f(np.cross(rot[:, 2], rot[:, 0])), f(rng.uniform(1.0, 2 * np.pi, nq))))
    o_q = f(rng.uniform(-1.0, 1.0, (131072, 3)))
    d_q = f(rng.normal(size=(131072, 3)))
    d_q = (d_q / d_q.norm(dim=-1, keepdim=True)).contiguous()
    t_q = torch.full((131072,), INFINITY, device=dev)
    t_q[::13] = 0.0
    t_q[5::13] = f(rng.uniform(0.0, 2.0, t_q[5::13].shape[0]))
    for kind, soa in (("spheres", sph_p), ("disks", dsk_p)):
        n_h, n_edge, err = compare_quadrics(kind, o_q, d_q, t_q, soa)
        log(f"partial {kind} ({nq}) vs plain on 131072 rays: {n_h} hits, {n_edge} "
            f"disagreements, all within 1e-5 of a clip edge; max abs err t {err:.2e}")

    # ---- 6. K8 vs torch.cumsum's plain version at the pool size
    R = rd.POOL_LANES
    for density, left in ((0.03, 10 ** 7), (0.5, 10 ** 7), (0.5, 1000), (1.0, 0), (0.4, -3)):
        in_flight = (torch.rand(R, generator=g) < 0.95).to(dev)
        finished = in_flight & (torch.rand(R, generator=g) < density).to(dev)
        total = 1 << 26
        ck = torch.tensor([total - left, 0], dtype=torch.int64, device=dev)
        cp = ck.clone()
        out_k = rd.recycle_cuda(finished, in_flight, ck, total)
        out_p = rd.recycle_plain(finished, in_flight, cp, total)
        require(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(out_k, out_p))
                and torch.equal(ck, cp), "recycle differs from cumsum", density, left)
    log(f"wavefront_recycle vs torch.cumsum at {R} lanes, 5 masks (next_work up to 3 past "
        f"the end): rank, work, recycle, in_flight and counters bit-exact")

    # ---- 6b. K7 vs plain on synthetic lanes
    def sub_params(p, idx):
        def bx(b):
            return bxdfs.BxdfParams(*(x[idx] for x in b))
        return layered.LayeredParams(bx(p.top), bx(p.bottom), p.thickness[idx], p.g[idx],
                                     p.albedo[idx], p.max_depth, p.n_samples)

    def compare_layered(name, p, args, mask=None):
        """K7 entry point `name` against its plain version on the lanes of
        `mask` (all lanes when None), held to the statistical criteria of
        the module docstring. -> {lanes, agreement fraction of each output,
        mean_rel: relative difference of the lane means, max_abs_err: the
        largest error of f (or pdf) among the lanes within tolerance}."""
        out_k = getattr(layered, f"{name}_cuda")(p, *args, mask)
        idx = (torch.arange(args[0].shape[0], device=dev) if mask is None
               else mask.nonzero()[:, 0])
        out_p = getattr(layered, f"{name}_plain")(sub_params(p, idx), *(a[idx] for a in args))
        res = {"lanes": int(idx.shape[0])}
        if name == "layered_sample":
            k = bxdfs.BSDFSample(*(x[idx] for x in out_k))
            for f in ("valid", "flags"):
                res[f] = float((getattr(k, f) == getattr(out_p, f)).float().mean())
                require(res[f] >= EQUAL_FRAC, name, f, res[f])
            pairs = {f: (getattr(k, f), getattr(out_p, f)) for f in ("f", "wi", "pdf")}

            def est(s):
                return torch.where(s.valid[:, None], s.f * s.wi[:, 2:3].abs()
                                   / s.pdf.clamp(min=1e-12)[:, None], 0.0)
            means = (est(k), est(out_p))
        else:
            k = out_k[idx]
            pairs = {"f" if name == "layered_f" else "pdf": (k, out_p)}
            means = (k, out_p)
        err = 0.0
        for f, (a, b) in pairs.items():
            res[f] = frac_close(a, b)
            require(res[f] >= CLOSE_FRAC, name, f, res[f])
            d = (a.double() - b.double()).abs().reshape(a.shape[0], -1)
            ok = (d <= ATOL + RTOL * b.double().abs().reshape(b.shape[0], -1)).all(1)
            if f != "wi" and bool(ok.any()):
                err = max(err, float(d[ok].max()))
        m_k, m_p = float(means[0].double().mean()), float(means[1].double().mean())
        res["mean_rel"] = abs(m_k - m_p) / max(abs(m_p), 1e-30)
        require(res["mean_rel"] <= MEAN_RTOL, name, "lane means differ", m_k, m_p)
        res["max_abs_err"] = err
        return res

    def agreement(res):
        return ", ".join(f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}"
                         for k, v in res.items())

    n7 = 1 << 18
    lanes7 = {k: torch.as_tensor(v, device=dev) for k, v in layered_lanes(n7, 11).items()}

    def bx7(tag):
        return bxdfs.BxdfParams(*(lanes7[f"{tag}_{f}"] for f in BXDF_FIELDS))
    p7 = layered.LayeredParams(bx7("top"), bx7("bottom"), lanes7["thickness"], lanes7["g"],
                               lanes7["albedo"], 10, 1)
    layered_err = {}
    for name, args in (("layered_f", (lanes7["wo"], lanes7["wi"])),
                       ("layered_sample", (lanes7["wo"], lanes7["uc"], lanes7["u2"])),
                       ("layered_pdf", (lanes7["wo"], lanes7["wi"]))):
        res = compare_layered(name, p7, args)
        layered_err[name] = res["max_abs_err"]
        log(f"{name} vs plain on {n7} synthetic lanes ({len(LAYERED_CASES)} cases: "
            f"{'; '.join(LAYERED_CASES)}): {agreement(res)}")

    # ---- 7. small renders vs golden and vs CPU
    goldens = np.load(ROOT / "tests" / "goldens.npz")
    for label, (sc, mt), key in (
            ("cornell-mesh l3 48^2 x 4", compile_scene(
                ts.cornell_mesh_builder(levels=3, res=48, filter_kind="box"), 4, device=dev),
             "cornell_mesh_l3_48_spp4"),
            ("cornell 64^2 x 8", ts.cornell(res=64, spp=8, device=dev, filter_kind="box"),
             "cornell_path_64_spp8")):
        img_gpu = rd.render(sc, mt).cpu().numpy()
        img_cpu = rd.render(sc, mt, device="cpu").numpy()
        fb_g = check_image(img_gpu, goldens[key], f"{label} vs golden")
        fb_c = check_image(img_gpu, img_cpu, f"{label} vs cpu render")
        log(f"small render {label}: vs golden {fb_g:.4%} bad px, vs cpu {fb_c:.4%} bad px, "
            f"means {img_gpu.mean():.5f} / {goldens[key].mean():.5f} / {img_cpu.mean():.5f}")

    # the layered kernel's path at a small size: material-testball 32^2 x 4,
    # box filter, card against CPU (independent walks: block means)
    b_tb = bd.SceneBuilder().parse_file(str(ROOT / "scenes" / "material-testball.pbrt"))
    b_tb.film["xresolution"] = b_tb.film["yresolution"] = 32
    b_tb.filter = {"type": "box"}
    s_tb32, m_tb32 = compile_scene(b_tb, 4, device=dev)
    reset_counts()
    img_gpu = rd.render(s_tb32, m_tb32).cpu().numpy()
    counts = {k: v for k, v in read_counts().items() if v}
    require(all(counts.get(k, 0) > 0 for k in layered.launches), "K7 not launched", counts)
    img_cpu = rd.render(s_tb32, m_tb32, device="cpu").numpy()
    px_bad = float((np.abs(img_gpu - img_cpu) > 5e-3 + 0.05 * np.abs(img_cpu)).mean())
    fb_c = check_image(blocks(img_gpu, 16), blocks(img_cpu, 16),
                       "material-testball vs cpu render (16x16 block means)")
    log(f"material-testball 32^2 x 4 spp box: launches {counts}; vs cpu on 16x16 block means "
        f"{fb_c:.4%} bad, per pixel {px_bad:.4%} bad (independent walks), means "
        f"{img_gpu.mean():.5f} / {img_cpu.mean():.5f}")

    # BDPT at small sizes: cornell against the golden and the CPU, caustic-
    # glass (its own BDPT settings, disk light) and cornell-mesh (the BVH
    # route) against the CPU
    b_cg = bd.SceneBuilder().parse_file(str(ROOT / "scenes" / "caustic-glass.pbrt"))
    b_cg.film["xresolution"] = b_cg.film["yresolution"] = 32
    for label, (sc, mt), key in (
            ("cornell bdpt 24^2 x 8", ts.cornell(res=24, spp=8, device=dev, filter_kind="box",
                                                 integrator="bdpt"), "cornell_bdpt_24_spp8"),
            ("caustic-glass bdpt 32^2 x 4", compile_scene(b_cg, 4, device=dev), None),
            ("cornell-mesh l3 bdpt 48^2 x 4", compile_scene(
                ts.cornell_mesh_builder(levels=3, res=48, filter_kind="box"), 4, device=dev,
                integrator_override="bdpt"), None)):
        require(mt.integrator == "bdpt", label)
        reset_counts()
        img_gpu, st_gpu = rd.render(sc, mt, return_stats=True)
        img_gpu = img_gpu.cpu().numpy()
        counts = {k: v for k, v in read_counts().items() if v}
        require(all(counts.get(k, 0) > 0 for k in ("bdpt_connect_rays", "bdpt_connect_weight",
                                                   "film_add_splats")), label, counts)
        img_cpu, st_cpu = rd.render(sc, mt, device="cpu", return_stats=True)
        img_cpu = img_cpu.numpy()
        fb_c = check_image(img_gpu, img_cpu, f"{label} vs cpu render")
        msg = f"small render {label}: vs cpu {fb_c:.4%} bad px"
        if key:
            msg += f", vs golden {check_image(img_gpu, goldens[key], f'{label} vs golden'):.4%}"
        n_g, n_c = sum(st_gpu.values()), sum(st_cpu.values())
        require(abs(n_g - n_c) <= 1e-3 * n_c, label, "ray counts", st_gpu, st_cpu)
        log(f"{msg}; rays card {n_g} cpu {n_c}; means {img_gpu.mean():.5f} / "
            f"{img_cpu.mean():.5f}; launches {counts}")

    # ---- 8. full-width renders through the normal entry point, each once,
    # with the launch counts set to 0 just before it and read just after. The
    # render keeps a copy of the arguments of each kernel's first launch (the
    # shapes and data the main path gives the kernels, for phase 9); its wall
    # time includes those copies.
    patches = [
        (bvh, "traverse_cuda",
         lambda a, k: "bvh_any_hit" if (a[6] if len(a) > 6 else k.get("any_hit"))
         else "bvh_closest_hit"),
        (film_kernel, "add_samples_triton", lambda a, k: "film_add_samples"),
        (ix, "dense_tris_cuda",
         lambda a, k: "dense_tri_any" if k.get("any_hit") else "dense_tri_closest"),
        (ix, "dense_spheres_cuda", lambda a, k: "dense_spheres"),
        (ix, "dense_disks_cuda", lambda a, k: "dense_disks"),
        (rd, "recycle_cuda", lambda a, k: "wavefront_recycle"),
        (layered, "layered_f_cuda", lambda a, k: "layered_f"),
        (layered, "layered_sample_cuda", lambda a, k: "layered_sample"),
        (layered, "layered_pdf_cuda", lambda a, k: "layered_pdf"),
        (film_kernel, "add_splats_triton", lambda a, k: "film_add_splats"),
        (bdpt, "connect_rays_cuda", lambda a, k: "bdpt_connect_rays"),
        (bdpt, "connect_weight_cuda", lambda a, k: "bdpt_connect_weight"),
        (bdpt, "connect_all_cuda", lambda a, k: "bdpt_wave"),
        (mlt, "mutate_cuda", lambda a, k: "mlt_mutate"),
        (mlt, "accept_and_splat_cuda", lambda a, k: "mlt_accept_splat"),
        (ss, "closest_parts_cuda", lambda a, k: "bvh_closest_hit_parts"),
        (ss, "any_parts_cuda", lambda a, k: "bvh_any_hit_parts"),
        (ss, "select_cuda", lambda a, k: "shard_select"),
        (bvh, "traverse_inst_cuda",
         lambda a, k: "bvh_any_hit_inst" if (a[8] if len(a) > 8 else k.get("any_hit"))
         else "bvh_closest_hit_inst"),
    ]
    captured = {}

    def clone(x):
        if torch.is_tensor(x):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):  # LayeredParams, mlt.Chains
            return type(x)(*map(clone, x))
        return x

    def render_captured(tag, sc, mt, **kw):
        """One render with each kernel's first-launch arguments kept."""
        origs = []
        for mod, name, key_fn in patches:
            orig = getattr(mod, name)
            origs.append((mod, name, orig))

            def wrapped(*a, _orig=orig, _key=key_fn, **k):
                # the film kernel adds into its first two arguments in place
                first_args = captured.setdefault(tag, {})
                if _key(a, k) not in first_args:
                    first_args[_key(a, k)] = (tuple(clone(x) for x in a),
                                              {n: clone(v) for n, v in k.items()}, _orig)
                return _orig(*a, **k)

            setattr(mod, name, wrapped)
        try:
            return rd.render(sc, mt, **kw)
        finally:
            for mod, name, orig in origs:
                setattr(mod, name, orig)

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    main_counts, main_counts_frame, frame_means, frame_imgs = {}, {}, {}, {}

    def full_render(tag, sc, mt, must, **kw):
        """The measured render of a full-width frame, its kernels'
        first-launch arguments kept."""
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        img, stats = render_captured(tag, sc, mt, return_stats=True, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        main_counts_frame.clear()
        main_counts_frame.update(counts)
        img = img.cpu().numpy()
        n_rays = stats["closest"] + stats["shadow"]
        require(img.shape == (mt.resolution[1], mt.resolution[0], 3) and np.isfinite(img).all(),
                tag, "non-finite pixels")
        require(all(counts.get(k, 0) > 0 for k in must), tag, "kernel not launched", counts)
        for k in must:  # a kernel on several paths: counted on its first
            main_counts.setdefault(k, counts[k])
        out_png = kernels.BUILD_DIR / f"{tag}.png"
        png.write_png(str(out_png), filmlib.to_srgb8(img))
        frame_means[tag] = float(img.mean())
        frame_imgs[tag] = img
        per = (f"{mt.mutations_per_pixel} mutations/pixel" if mt.integrator in bd.MLT_INTEGRATORS
               else f"{mt.spp} spp {mt.filter_kind}")
        log(f"full render {tag} {mt.integrator} {mt.resolution[0]}^2 x {per} depth "
            f"{mt.max_depth}: {wall:.3f} s wall (first-launch copies included), "
            f"{stats['closest']} closest + {stats['shadow']} shadow rays = "
            f"{n_rays / wall / 1e6:.3f} M rays/s; launches {counts}; mean {img.mean():.5f}; "
            f"all finite; peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} over the "
            f"{held / 2**30:.2f} held before it) -> {out_png.relative_to(ROOT)}")
        return stats

    st_cm = full_render("cornell_mesh", scene, meta, ("bvh_closest_hit", "bvh_any_hit",
                                                      "film_add_samples"))
    full_render("cornell", s_corn, m_corn, ("dense_tri_closest", "dense_tri_any",
                                            "dense_spheres", "film_add_samples"))
    t0 = time.time()
    s_terr, m_terr = ts.terrain(res=256, spp=16, device=dev)
    log(f"terrain compile: {time.time() - t0:.2f} s ({m_terr.n_tris} tris, PLY written and "
        f"read, SAH BVH of {s_terr.bvh_rows.shape[0]} rows, depth {m_terr.bvh_depth})")
    require(m_terr.open_scene, "terrain must take the wavefront loop")
    st_w = full_render("terrain", s_terr, m_terr, ("bvh_closest_hit", "bvh_any_hit",
                                                   "wavefront_recycle", "film_add_samples"))
    t0 = time.time()
    st_terr_b = rd.render_batched(s_terr, m_terr, filmlib.new_film(m_terr.resolution, dev))
    st_terr_b = {k: int(v) for k, v in st_terr_b.items()}
    require(st_w == st_terr_b, "wavefront and batched ray counts differ", st_w, st_terr_b)
    log(f"terrain through the batched loop: {time.time() - t0:.3f} s wall, the same "
        f"{st_terr_b['closest']} + {st_terr_b['shadow']} rays as the wavefront loop (no work item "
        f"dropped or repeated; render() raises on dropped != 0)")

    # the disk kernel's path: caustic-glass (path) 48^2 x 4, card vs CPU
    b_c48 = bd.SceneBuilder().parse_file(str(ROOT / "scenes" / "caustic-glass.pbrt"))
    b_c48.film["xresolution"] = b_c48.film["yresolution"] = 48
    s_c48, m_c48 = compile_scene(b_c48, 4, device=dev, integrator_override="path")
    reset_counts()
    img_gpu = render_captured("caustic", s_c48, m_c48).cpu().numpy()
    counts = {k: v for k, v in read_counts().items() if v}
    require(counts.get("dense_disks", 0) > 0, "disk kernel not launched", counts)
    main_counts.setdefault("dense_disks", counts["dense_disks"])
    img_cpu = rd.render(s_c48, m_c48, device="cpu").numpy()
    fb_c = check_image(img_gpu, img_cpu, "caustic-glass vs cpu render")
    log(f"caustic-glass (path) 48^2 x 4 spp: launches {counts}; vs cpu {fb_c:.4%} bad px, "
        f"means {img_gpu.mean():.5f} / {img_cpu.mean():.5f}")

    # the coated scenes at their files' settings, each rendered once
    k7 = tuple(layered.launches)
    t0 = time.time()
    s_st, m_st = load_scene(str(ROOT / "scenes" / "staircase.pbrt"), device=dev)
    log(f"staircase compile: {time.time() - t0:.2f} s ({m_st.n_tris} tris, PLY read, SAH BVH "
        f"of {s_st.bvh_rows.shape[0]} rows, depth {m_st.bvh_depth})")
    require(not m_st.open_scene and m_st.layered, "staircase: closed coated scene")
    full_render("staircase", s_st, m_st, ("bvh_closest_hit", "bvh_any_hit",
                                          "film_add_samples") + k7)
    s_tb, m_tb = load_scene(str(ROOT / "scenes" / "material-testball.pbrt"), device=dev)
    require(m_tb.sph_partial and m_tb.layered, "testball: partial sphere, coated")
    full_render("testball", s_tb, m_tb, ("bvh_closest_hit", "bvh_any_hit", "dense_spheres",
                                         "film_add_samples") + k7)

    # BDPT at the bench's settings: every kernel of a wave launched exactly
    # as often as the estimator needs
    def bdpt_launches(mt):
        """{kernel: launches} of a BDPT frame: per wave K12's two entry
        points, one K5, one K5s, one occluded dispatch for every strategy's
        shadow ray (K3a and K4), and max_depth + 1 camera and max_depth light
        closest-hit dispatches (K3, K4)."""
        waves = sum(1 for _ in rd.wave_lanes(mt.resolution[0] * mt.resolution[1], mt.spp,
                                             "cpu"))
        walk = 2 * mt.max_depth + 1
        out = {"bdpt_connect_rays": waves, "bdpt_connect_weight": waves,
               "film_add_samples": waves, "film_add_splats": waves,
               "dense_tri_closest": waves * walk, "dense_tri_any": waves,
               "dense_spheres": waves * (walk + 1)}
        if mt.n_disks:
            out["dense_disks"] = waves * (walk + 1)
        return out, waves

    s_cb, m_cb = ts.cornell(res=128, spp=8, device=dev, integrator="bdpt")
    b_cgf = bd.SceneBuilder().parse_file(str(ROOT / "scenes" / "caustic-glass.pbrt"))
    s_cgf, m_cgf = compile_scene(b_cgf, device=dev)
    require((m_cb.max_depth, m_cgf.integrator, m_cgf.max_depth, m_cgf.spp, m_cgf.resolution)
            == (5, "bdpt", 7, 64, (256, 256)), "BDPT frame settings")
    bdpt_got = {}
    for tag, sc, mt in (("cornell_bdpt", s_cb, m_cb), ("caustic_bdpt", s_cgf, m_cgf)):
        want, waves = bdpt_launches(mt)
        full_render(tag, sc, mt, tuple(want))
        got = {k: main_counts_frame[k] for k in want}
        require(got == want, tag, "launches", got, "expected", want)
        bdpt_got[tag] = got
        log(f"{tag}: {waves} wave(s) of {captured[tag]['bdpt_wave'][0][4].shape[0]} lanes, "
            f"launches as expected {want}")
    # the kernels line reports BDPT's kernels as caustic-glass's frame counted them
    for k in ("bdpt_connect_rays", "bdpt_connect_weight", "film_add_splats"):
        main_counts[k] = bdpt_got["caustic_bdpt"][k]

    # ---- 9. each kernel against its plain version and timed, on the
    # arguments of its first main-path launch
    timing = {}

    def first(tag, name):
        a, k, orig = captured[tag][name]
        return a, k, orig

    for any_hit in (False, True):
        name = "bvh_any_hit" if any_hit else "bvh_closest_hit"
        (_, _, _, o_, d_, t_, *_), _, _ = first("cornell_mesh", name)
        R_ = o_.shape[0]
        if any_hit:
            err = 0.0
            n_live = compare_any(o_, d_, t_)
        else:
            n_live, _, _, _, err = compare_closest(o_, d_, t_)
        work = torch.zeros(4, dtype=torch.int64, device=dev)
        bvh.traverse_cuda(rows, n_int, depth, o_, d_, t_, any_hit, stats=work)
        n_nodes, n_tris, n_edge, n_range = (int(x) for x in work.cpu())
        ms, call = kernel_ms(lambda: bvh.traverse_cuda(rows, n_int, depth, o_, d_, t_, any_hit),
                             20)
        ms_plain = events_ms(lambda: bvh.traverse_plain(rows, n_int, o_, d_, t_, any_hit), 1)
        b = bound(rows.numel() * 4 + R_ * 7 * 4 + R_ * 8,
                  n_nodes * SLAB_VISIT_OPS + tri_test_ops(n_tris, n_edge, n_range))
        timing[name] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                            library_ms=None, max_abs_err=err)
        log(f"{name} at the main path's launch ({R_} lanes, {n_live} "
            f"{'occluded' if any_hit else 'hits'}, {n_nodes} node visits, {n_tris} tri "
            f"tests, {n_edge} past the edge test, {n_range} past t range): kernel {ms:.3f} ms "
            f"(host-paced {call:.3f} ms), plain {ms_plain:.1f} ms, bound {b[0]:.4f} ms "
            f"({b[1]}); matches plain")
        # the same kernel on terrain's and staircase's first launches: timed only
        for tag in ("terrain", "staircase"):
            (rows_t, nint_t, depth_t, o_t, d_t, t_t, *_), _, _ = first(tag, name)
            work = torch.zeros(4, dtype=torch.int64, device=dev)
            bvh.traverse_cuda(rows_t, nint_t, depth_t, o_t, d_t, t_t, any_hit, stats=work)
            nn_t, nt_t, ne_t, nr_t = (int(x) for x in work.cpu())
            ms_t, call_t = kernel_ms(lambda: bvh.traverse_cuda(rows_t, nint_t, depth_t, o_t,
                                                               d_t, t_t, any_hit), 20)
            b_t = bound(rows_t.numel() * 4 + o_t.shape[0] * 36,
                        nn_t * SLAB_VISIT_OPS + tri_test_ops(nt_t, ne_t, nr_t))
            timing[name][f"{tag}_ms"] = ms_t
            timing[name][f"{tag}_bound_ms"] = b_t[0]
            log(f"{name} on {tag}'s first launch ({o_t.shape[0]} lanes, {nn_t} node visits, "
                f"{nt_t} tri tests, {ne_t} past the edge test, {nr_t} past t range; timed "
                f"only): kernel {ms_t:.3f} ms (host-paced {call_t:.3f} ms), bound "
                f"{b_t[0]:.4f} ms ({b_t[1]})")

    args = first("cornell_mesh", "film_add_samples")[0][2:]
    n_l = args[0].shape[0]
    err = compare_film(args)
    fk = filmlib.new_film((256, 256), dev)
    ms, call = kernel_ms(lambda: film_kernel.add_samples_triton(fk.rgb_sum, fk.weight_sum,
                                                                *args))
    ms_plain = events_ms(lambda: film_kernel.add_samples_plain(fk.rgb_sum, fk.weight_sum,
                                                               *args), 20)
    rgbw = torch.rand((n_l, 3), device=dev)
    ms_lib = graph_ms(lambda: fk.rgb_sum.index_add_(0, args[0], rgbw))
    b = bound(n_l * (8 + 13 * 4) + 3 * 471 * 4 + n_px * 4 * 4, n_l * FILM_LANE_OPS)
    timing["film_add_samples"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                      library_ms=ms_lib, max_abs_err=max(err, film_err))
    log(f"film_add_samples at the main path's launch ({n_l} lanes): kernel {ms:.4f} ms "
        f"(host-paced {call:.4f} ms), plain {ms_plain:.3f} ms, index_add_ {ms_lib:.4f} ms, "
        f"bound {b[0]:.4f} ms ({b[1]}); max abs err {err:.2e}")

    # K3 on cornell's first launches
    for any_hit in (False, True):
        name = "dense_tri_any" if any_hit else "dense_tri_closest"
        (o_, d_, t_, *tris), _, _ = first("cornell", name)
        R_, T_ = o_.shape[0], tris[0].shape[0]
        n_h, err = compare_dense_tris(o_, d_, t_, tris, any_hit)
        # each live lane tests every triangle against its fixed t_max, the
        # any-hit sweep up to its first hit; the closest-hit winner is refit
        edge, in_range = tri_stages(o_, d_, t_, *tris)
        tested = (t_ > 0)[:, None].expand(R_, T_)
        if any_hit:
            _, hit = ix.intersect_tri_block(o_, ix.ray_shear(d_), t_, *tris)
            first_hit = torch.where(hit.any(1), hit.int().argmax(1), T_)
            tested = tested & (torch.arange(T_, device=dev)[None] <= first_hit[:, None])
            out_b = R_ * 4
        else:
            out_b = R_ * 20
        n_t, n_e, n_r = (int(x.sum()) for x in (tested, tested & edge, tested & in_range))
        ops = tri_test_ops(n_t, n_e, n_r) + (0 if any_hit else n_h * (TRI_FULL_OPS
                                                                        + TRI_BARY_OPS))
        ms, call = kernel_ms(lambda: ix.dense_tris_cuda(o_, d_, t_, *tris, any_hit=any_hit))
        plain = ix.occluded_tris_dense_plain if any_hit else ix.intersect_tris_dense_plain
        ms_plain = events_ms(lambda: plain(o_, d_, t_, *tris), 3)
        b = bound(R_ * 28 + T_ * 36 + out_b, ops)
        timing[name] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                            library_ms=None, max_abs_err=err)
        log(f"{name} at the main path's launch ({R_} lanes x {T_} tris, {n_h} "
            f"{'occluded' if any_hit else 'hits'}, {n_t} tests, {n_e} past the edge test, "
            f"{n_r} past t range): kernel {ms:.4f} ms (host-paced {call:.4f} ms), "
            f"plain {ms_plain:.3f} ms, bound {b[0]:.4f} ms ({b[1]}); bit-exact")

    # K4 on the first launches of cornell (spheres) and caustic-glass (disks)
    for name, tag, kind, test_ops, hit_ops, width in (
            ("dense_spheres", "cornell", "spheres", SPHERE_TEST_OPS, SPHERE_HIT_OPS, 64),
            ("dense_disks", "caustic", "disks", DISK_TEST_OPS, 0, 60)):
        (o_, d_, t_, soa), _, orig = first(tag, name)
        R_, n_q = o_.shape[0], soa.center.shape[0]
        n_h, n_edge, err = compare_quadrics(kind, o_, d_, t_, soa)
        ms, call = kernel_ms(lambda: orig(o_, d_, t_, soa))
        plain = (ix.intersect_spheres_dense_plain if kind == "spheres"
                 else ix.intersect_disks_dense_plain)
        ms_plain = events_ms(lambda: plain(o_, d_, t_, soa), 3)
        b = bound(R_ * 28 + n_q * width + R_ * 32,
                  int((t_ > 0).sum()) * n_q * test_ops + n_h * hit_ops)
        timing[name] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                            library_ms=None, max_abs_err=err)
        log(f"{name} at the main path's launch ({R_} lanes x {n_q} {kind}, {n_h} hits, "
            f"{n_edge} edge disagreements): kernel {ms:.4f} ms (host-paced {call:.4f} "
            f"ms), plain {ms_plain:.3f} ms, "
            f"bound {b[0]:.4f} ms ({b[1]}); max abs err t {err:.2e}")

    # K8 on terrain's first launch
    (fin, inf_, cnt, total), _, _ = first("terrain", "wavefront_recycle")
    R_ = fin.shape[0]
    ck, cp = cnt.clone(), cnt.clone()
    out_k = rd.recycle_cuda(fin, inf_, ck, total)
    out_p = rd.recycle_plain(fin, inf_, cp, total)
    require(all(torch.equal(a, b) for a, b in zip(out_k, out_p)) and torch.equal(ck, cp),
            "recycle differs from cumsum on the main path's launch")
    ms, call = kernel_ms(lambda: rd.recycle_cuda(fin, inf_, cnt.clone(), total))
    ms_plain = events_ms(lambda: rd.recycle_plain(fin, inf_, cnt.clone(), total), 20)
    fin_i = fin.to(torch.int32)
    ms_lib = graph_ms(lambda: torch.cumsum(fin_i, 0, dtype=torch.int32))
    b = bound(R_ * 2 + R_ * 14 + 16, 2 * R_)
    timing["wavefront_recycle"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                       library_ms=ms_lib, max_abs_err=0.0)
    log(f"wavefront_recycle at the main path's launch ({R_} lanes, {int(fin.sum())} finished, "
        f"work {int(cnt[0])} of {total}): kernel {ms:.4f} ms (host-paced {call:.4f} "
        f"ms), plain {ms_plain:.3f} ms, "
        f"torch.cumsum {ms_lib:.4f} ms, bound {b[0]:.5f} ms ({b[1]}); bit-exact")

    # K7 on its first launches in the coated frames: against the plain
    # version on the coated lanes of both, timed on staircase's (2^20 lanes)
    for name, out_b in (("layered_f", 16), ("layered_sample", 41), ("layered_pdf", 4)):
        for tag in ("testball", "staircase"):
            (p_, *args_, mask_), _, _ = first(tag, name)
            res = compare_layered(name, p_, args_, mask_)
            log(f"{name} vs plain on {tag}'s first launch ({args_[0].shape[0]} lanes, the "
                f"coated ones compared): {agreement(res)}")
        cuda_fn = getattr(layered, f"{name}_cuda")
        plain_fn = getattr(layered, f"{name}_plain")
        R_, n_live = args_[0].shape[0], int(mask_.sum())
        steps = torch.zeros(1, dtype=torch.int64, device=dev)
        cuda_fn(p_, *args_, mask_, steps)
        n_steps = int(steps.item())
        ms, call = kernel_ms(lambda: cuda_fn(p_, *args_, mask_))
        ms_plain = events_ms(lambda: plain_fn(p_, *args_), 1)
        # each input read once, by the lanes that need it, and each output
        # written once, every lane; every lane reads the mask. A coated lane
        # of layered_f or layered_sample reads both interfaces (2 x 80
        # bytes), thickness, g and albedo (24) and wo, wi (or wo, uc, u2:
        # 24). One of layered_pdf reads wo, wi (24); with both on one side,
        # the coat (80) too; and, where its estimate reaches the base (the
        # step counter), the base (80)
        lane_ops, step_ops = LAYERED_OPS[name]
        if name == "layered_pdf":
            n_same = int((mask_ & (args_[0][:, 2] * args_[1][:, 2] > 0)).sum())
            n_bytes = n_live * 24 + n_same * 80 + n_steps * 80
            n_ops = n_same * lane_ops + n_steps * step_ops
            work = f"{n_same} with wo, wi on one side, {n_steps} reached the base"
        else:
            n_bytes = n_live * 208
            n_ops = n_live * lane_ops + n_steps * step_ops
            work = f"{n_steps} walk steps"
        b = bound(R_ + n_bytes + R_ * out_b, n_ops)
        timing[name] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                            library_ms=None, max_abs_err=max(res["max_abs_err"],
                                                             layered_err[name]))
        log(f"{name} at the main path's launch (staircase, {R_} lanes, {n_live} coated, "
            f"{work}): kernel {ms:.4f} ms (host-paced {call:.4f} ms), plain "
            f"{ms_plain:.3f} ms, bound {b[0]:.5f} ms ({b[1]})")

    # K12 on the first waves of the BDPT frames against its plain version;
    # both entry points timed on caustic-glass's (graph replays of 5 calls:
    # each call allocates its outputs, ~1 GB of shadow rays at 2^20 lanes)
    # and on a 24^2 x 2 wave of the four-light scene (lens; distant, spot and
    # uniform infinite lights, escaped camera rays, the delta-light rule)
    s_fl, m_fl = compile_scene(bdpt_cases.four_lights_builder(24), 2, device=dev,
                               integrator_override="bdpt")
    pix_fl = torch.arange(24 * 24, device=dev).repeat(2)
    smp_fl = torch.arange(2, device=dev).repeat_interleave(24 * 24)
    waves_b = {"four_lights": (s_fl, m_fl) + bdpt_cases.wave_inputs(s_fl, m_fl, pix_fl, smp_fl)}
    for tag in ("cornell_bdpt", "caustic_bdpt"):
        waves_b[tag] = first(tag, "bdpt_wave")[0]
    k12_err = 0.0
    for tag, wave in waves_b.items():
        res = bdpt_cases.compare(*wave)
        bdpt_cases.require_agreement(res)
        k12_err = max(k12_err, res["max_abs_err"])
        log(f"K12 vs plain on {tag}'s {'first ' * (tag != 'four_lights')}wave ({res['lanes']} "
            f"lanes x {res['strategies']} strategies, {res['strategies_live']} live on some "
            f"lane, {res['live']} live contributions): worst strategy {res['worst']} agrees on "
            f"{res['frac']:.6%} of its live lanes within rtol {bdpt_cases.RTOL:g}, atol "
            f"{bdpt_cases.ATOL:g} (>= {bdpt_cases.CLOSE_FRAC:.2%} required of every strategy), "
            f"L {res['L_frac']:.6%}; rays {res['rays_kernel']} = plain {res['rays_plain']}; "
            f"splat pixels differing {res['splat_pix_differ']}; max abs err over all "
            f"contributions {res['max_abs_err']:.3e}")
    scene_b, meta_b, light_vs, cam_vs, lam_b, table_b, samples_b = waves_b["caustic_bdpt"]
    a_rays = first("caustic_bdpt", "bdpt_connect_rays")[0]
    a_wt = first("caustic_bdpt", "bdpt_connect_weight")[0]
    verts, ends, st_b = a_rays[1], a_rays[2], a_rays[3]
    R_, n_slots = verts.shape[2], verts.shape[0]
    in_b = verts.numel() * 4 + ends.numel() * 4 + st_b.tab.numel() * 4
    plain_rays = lambda: bdpt.connect_rays_plain(scene_b, light_vs, cam_vs, table_b, samples_b)
    conns_b = plain_rays()[0]
    plain_wt = lambda: bdpt.connect_weight_plain(scene_b, meta_b, light_vs, cam_vs, lam_b,
                                                 table_b, samples_b, conns_b, a_wt[7])
    n_con = st_b.n_ray
    for name, fn, plain, out_b, extra_in, n_s in (
            ("bdpt_connect_rays", lambda: bdpt.connect_rays_cuda(*a_rays), plain_rays,
             n_con * R_ * 28 + 8, 0, n_con),
            ("bdpt_connect_weight", lambda: bdpt.connect_weight_cuda(*a_wt), plain_wt,
             R_ * 16 + st_b.n_t1 * R_ * 24, R_ * 16 + n_con * R_ + 471 * 4 * (
                 1 + s_cgf.lt_type.shape[0]), len(table_b))):
        ms = graph_ms(fn, calls=5)
        ms_plain = events_ms(plain, 1)
        b = bound(in_b + extra_in + out_b, R_ * n_s * K12_OPS[name])
        timing[name] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                            library_ms=None, max_abs_err=k12_err)
        log(f"{name} at caustic-glass's first wave ({R_} lanes, {n_slots} vertex slots, "
            f"{n_s} strategies): kernel {ms:.3f} ms, plain {ms_plain:.1f} ms, bound "
            f"{b[0]:.4f} ms ({b[1]}; {(in_b + extra_in + out_b) / 1e9:.3f} GB)")

    # K5s on caustic-glass's first launch
    sp_args = first("caustic_bdpt", "film_add_splats")[0][1:]
    n_s5, n_lam5 = sp_args[0].shape[0], sp_args[2].shape[0]
    err = compare_splats(sp_args)
    fk = filmlib.new_film((256, 256), dev)
    ms = graph_ms(lambda: film_kernel.add_splats_triton(fk.splat, *sp_args))
    ms_plain = events_ms(lambda: film_kernel.add_splats_plain(fk.splat, *sp_args), 20)
    rgb_s = torch.rand((n_s5, 3), device=dev)
    ms_lib = graph_ms(lambda: fk.splat.index_add_(0, sp_args[0], rgb_s))
    b = bound(n_s5 * (8 + 16) + n_lam5 * 32 + 3 * 471 * 4 + n_px * 3 * 4, n_s5 * FILM_LANE_OPS)
    timing["film_add_splats"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                     library_ms=ms_lib, max_abs_err=max(err, splat_err))
    log(f"film_add_splats at caustic-glass's first launch ({n_s5} splats over {n_lam5} lanes): "
        f"kernel {ms:.4f} ms, plain {ms_plain:.3f} ms, index_add_ {ms_lib:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]}); max abs err {err:.2e}")

    # ---- 10. MLT (K12m): cornell 24^2 on the card and the CPU with one
    # seed; the two full-width frames, cut in mutations per pixel; both
    # kernels against their plain versions at the frames' first passes, and
    # timed on caustic-glass's
    for integ in ("mltpath", "mltbdpt"):
        sc, mt = ts.cornell(res=24, spp=1, device=dev, filter_kind="box", integrator=integ)
        mt = dataclasses.replace(mt, mutations_per_pixel=mlt_cases.SMALL_MUTATIONS)
        runs = {}
        for d_ in (dev, torch.device("cpu")):
            acc = []
            reset_counts()
            img, st = mlt.render_mlt(
                sc, mt, n_chains=mlt_cases.SMALL_CHAINS, n_bootstrap=mlt_cases.SMALL_BOOTSTRAP,
                device=d_, on_pass=lambda i, a, acc=acc, d_=d_: acc.append(
                    mlt.accept_uniforms(0, i, mlt_cases.SMALL_CHAINS, d_) < a))
            runs[d_.type] = (img.cpu().numpy(), torch.stack(acc).cpu(), st,
                             {k: v for k, v in read_counts().items() if v})
        (img_g, acc_g, st_g, counts), (img_c, acc_c, st_c, _) = runs["cuda"], runs["cpu"]
        n_passes = acc_g.shape[0]
        require(counts.get("mlt_mutate") == n_passes == counts.get("mlt_accept_splat"), integ,
                counts)
        res = mlt_cases.compare_renders(img_g, img_c, acc_g, acc_c)
        log(f"small MLT render cornell {integ} 24^2, {mlt_cases.SMALL_CHAINS} chains x "
            f"{n_passes} passes, card vs cpu with one seed: accept decisions equal on "
            f"{res['decisions']:.4%} of (chain, pass) (>= {mlt_cases.DECISION_FRAC:.0%} "
            f"required), 8x8 block means worst {res['block_rel']:.4%} apart (<= "
            f"{mlt_cases.BLOCK_RTOL:.0%}), means {img_g.mean():.5f} / {img_c.mean():.5f}; rays "
            f"card {st_g['closest'] + st_g['shadow']} cpu {st_c['closest'] + st_c['shadow']}; "
            f"launches {counts}")

    s_cgm, m_cgm = compile_scene(bd.SceneBuilder().parse_file(
        str(ROOT / "scenes" / "caustic-glass.pbrt")), device=dev, integrator_override="mlt")
    s_cmm, m_cmm = ts.cornell_mesh(res=256, levels=5, device=dev, integrator="mltpath")
    require((m_cgm.resolution, m_cgm.max_depth, m_cgm.mutations_per_pixel, m_cmm.max_depth,
             m_cmm.n_tris) == ((256, 256), 7, 100, 5, 16396), "MLT frame settings")
    mlt_frames = (
        ("caustic_mlt", s_cgm, dataclasses.replace(m_cgm, mutations_per_pixel=4), "caustic_bdpt",
         ("dense_tri_closest", "dense_tri_any", "dense_spheres", "dense_disks",
          "bdpt_connect_rays", "bdpt_connect_weight")),
        ("cornell_mesh_mlt", s_cmm, dataclasses.replace(m_cmm, mutations_per_pixel=8),
         "cornell_mesh", ("bvh_closest_hit", "bvh_any_hit")))
    log("MLT frames at full width (256^2, the scene's max depth, 8192 chains), cut from 100 "
        "mutations per pixel (800 passes) to 4 (caustic-glass mlt: 32 passes) and 8 "
        "(cornell-mesh mltpath: 64 passes) so that this phase fits the script's time; "
        "python -m pbrt_tpu_torch.profile_render runs them uncut")
    for tag, sc, mt, ref, must in mlt_frames:
        full_render(tag, sc, mt, must + ("mlt_mutate", "mlt_accept_splat"))
        n_passes = max(1, mt.mutations_per_pixel * mt.resolution[0] * mt.resolution[1]
                       // mlt.N_CHAINS)
        got = {k: main_counts_frame[k] for k in mlt.launches}
        require(got == {k: n_passes for k in mlt.launches}, tag, "launches", got, n_passes)
        rel = abs(frame_means[tag] - frame_means[ref]) / frame_means[ref]
        require(rel <= mlt_cases.FRAME_MEAN_RTOL[tag], tag, "image mean", frame_means[tag],
                ref, frame_means[ref])
        log(f"{tag}: K12m-a and K12m-b launched once a pass ({n_passes}); image mean "
            f"{frame_means[tag]:.5f} vs the {ref} frame's {frame_means[ref]:.5f}: {rel:.3%} "
            f"apart (<= {mlt_cases.FRAME_MEAN_RTOL[tag]:.0%})")

    mlt_err = {}
    for tag in ("caustic_mlt", "cornell_mesh_mlt"):
        (x_, seed_, pass_), _, _ = first(tag, "mlt_mutate")
        R_, D_ = x_.shape
        draws = torch.empty((R_, 1 + 2 * D_), device=dev)
        res_m = mlt_cases.compare_mutate(x_, mlt.mutate_cuda(x_, seed_, pass_, draws), draws,
                                         mlt.mutate_from_uniforms, mlt.chain_uniforms, seed_,
                                         pass_)
        (sp_, ht_, cur_, prop_, _, _), _, _ = first(tag, "mlt_accept_splat")
        res_a = mlt_cases.compare_accept(
            lambda *a: mlt.accept_and_splat_cuda(*a, seed_, pass_),
            lambda *a: mlt.accept_and_splat_from_uniforms(
                *a, mlt.accept_uniforms(seed_, pass_, R_, dev)), sp_, ht_, cur_, prop_)
        mlt_err["mlt_mutate"] = max(mlt_err.get("mlt_mutate", 0.0),
                                    res_m["max_ulps"] * 2.0 ** -24)
        mlt_err["mlt_accept_splat"] = max(mlt_err.get("mlt_accept_splat", 0.0),
                                          res_a["max_abs_err"])
        log(f"K12m vs plain on {tag}'s first pass ({R_} chains, D {D_}, C "
            f"{cur_.pix.shape[0]}): mlt_mutate draws bit-exact, {res_m['large']} large steps "
            f"equal, values within {res_m['max_ulps']:.0f} x 2^-24 (<= "
            f"{mlt_cases.MUTATE_ULPS}); mlt_accept_splat acceptance and chain state exact "
            f"({res_a['accepted']} accepted), splat and heat max abs err "
            f"{res_a['max_abs_err']:.3e} (<= {mlt_cases.SPLAT_RTOL:g} of the largest sum)")

    # timed on caustic-glass's first pass: x (8192, 160); C = 8
    (x_, seed_, pass_), _, _ = first("caustic_mlt", "mlt_mutate")
    R_, D_ = x_.shape
    ms = graph_ms(lambda: mlt.mutate_cuda(x_, seed_, pass_))
    ms_plain = events_ms(lambda: mlt.mutate_from_uniforms(
        x_, *mlt.chain_uniforms(seed_, pass_, R_, D_, dev)), 3)
    b = bound(R_ * D_ * 8, R_ * D_ * MUTATE_OPS)
    timing["mlt_mutate"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                library_ms=None, max_abs_err=mlt_err["mlt_mutate"])
    log(f"mlt_mutate at caustic-glass's first pass ({R_} chains x {D_}): kernel {ms:.4f} ms, "
        f"plain {ms_plain:.3f} ms (its 1 + 2 D stream draws included), bound {b[0]:.5f} ms "
        f"({b[1]}; {R_ * D_ * 8 / 1e6:.2f} MB)")
    (sp_, ht_, cur_, prop_, seed_, pass_), _, _ = first("caustic_mlt", "mlt_accept_splat")
    C_, n_pix_ = cur_.pix.shape[0], ht_.shape[0]
    u_acc = mlt.accept_uniforms(seed_, pass_, R_, dev)
    y_c, y_p = cur_.y, prop_.y
    a_ = torch.where(y_c > 0, torch.clamp(y_p / torch.clamp(y_c, min=1e-12), max=1.0), 1.0)
    n_acc = int((u_acc < a_).sum())
    live = torch.cat([(cur_.rgb.abs().sum(-1) > 0) & (y_c > 0)[None],
                      (prop_.rgb.abs().sum(-1) > 0) & (y_p > 0)[None]])
    pix_all = torch.cat([cur_.pix, prop_.pix])
    n_touched = int(torch.unique(torch.cat([pix_all[live], cur_.pix[0], prop_.pix[0]])).numel())
    # reads: both states' y, pix and rgb; writes: a; an accepted chain's
    # proposal row read and its state row written; the touched pixels of
    # splat and heat read and written
    nbytes = (R_ * 8 + 2 * C_ * R_ * 16 + R_ * 4 + n_acc * (D_ * 8 + C_ * 16 + 4)
              + n_touched * 16 * 2)
    b = bound(nbytes, R_ * 10 + int(live.sum()) * 3)
    clone_ch = lambda ch: type(ch)(*(t.clone() for t in ch))
    cur_k, sp_k, ht_k = clone_ch(cur_), sp_.clone(), ht_.clone()
    ms = graph_ms(lambda: mlt.accept_and_splat_cuda(sp_k, ht_k, cur_k, prop_, seed_, pass_))
    cur_p, sp_p, ht_p = clone_ch(cur_), sp_.clone(), ht_.clone()
    ms_plain = events_ms(lambda: mlt.accept_and_splat_from_uniforms(
        sp_p, ht_p, cur_p, prop_, mlt.accept_uniforms(seed_, pass_, R_, dev)), 3)
    idx_all = pix_all.reshape(-1).long()
    rgb_all = torch.rand((idx_all.shape[0], 3), device=dev)
    ms_lib = graph_ms(lambda: sp_k.index_add_(0, idx_all, rgb_all))
    timing["mlt_accept_splat"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                      library_ms=ms_lib, max_abs_err=mlt_err["mlt_accept_splat"])
    log(f"mlt_accept_splat at caustic-glass's first pass ({R_} chains, C {C_}, {n_acc} "
        f"accepted, {int(live.sum())} live contributions over {n_touched} pixels): kernel "
        f"{ms:.4f} ms, plain {ms_plain:.3f} ms, index_add_ of its {idx_all.shape[0]} splats "
        f"{ms_lib:.4f} ms, bound {b[0]:.5f} ms ({b[1]}; {nbytes / 1e6:.2f} MB)")

    # ---- 11. scene sharding: K11a, K11b and the select kernel
    # (a) against their plain versions, the unfused yardstick and K1 on
    # phase 3's rays over cornell-mesh levels 5 in 8 parts
    sh8 = ss.build_scene_shard(scene, 8).to(dev)
    full_b = sum(x.numel() * 4 for x in (scene.bvh_rows, scene.tri_rec, scene.tri_p0,
                                         scene.tri_p1, scene.tri_p2))
    part_b = ss.shard_bytes(sh8)
    require(part_b < full_b / 4, "per-part tables not under a quarter", part_b, full_b)
    log(f"cornell-mesh levels 5 in 8 parts: rows {tuple(sh8.rows.shape)}, recv "
        f"{tuple(sh8.recv.shape)}, n_int {sh8.n_int}, depth {sh8.depth}; {part_b / 1e6:.3f} MB "
        f"a part against {full_b / 1e6:.3f} MB of unsharded tables ({part_b / full_b:.3f})")

    def unfused_pack(sh, o, d, t_max):
        """The yardstick: K1 over each part, then an argmin over the parts
        and a gather of the winner's recv row (closest_parts_plain's
        arithmetic around bvh.traverse_cuda)."""
        ts_, rvs = [], []
        for p in range(sh.rows.shape[0]):
            t, prim = bvh.traverse_cuda(sh.rows[p], sh.n_int, sh.depth, o, d, t_max)
            found = prim >= 0
            ts_.append(torch.where(found, t, torch.inf))
            rvs.append(torch.where(found[:, None], sh.recv[p][prim.clamp(min=0)], 0.0))
        t = torch.stack(ts_)
        best = torch.argmin(t, dim=0)
        rr = torch.arange(o.shape[0], device=o.device)
        return torch.cat([t[best, rr][:, None], torch.stack(rvs)[best, rr]], dim=1)

    def unfused_any(sh, o, d, t_max):
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for p in range(sh.rows.shape[0]):
            occ |= bvh.traverse_cuda(sh.rows[p], sh.n_int, sh.depth, o, d, t_max,
                                     any_hit=True)[1] >= 0
        return occ

    def plain_ms_of(fn):
        """(result, ms) of one call of a plain version, CUDA events around it."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def pack_ties(pk, ref, o, d, t_max, what, ties_ok):
        """Lanes where the pack pk differs from ref: none, or (ties_ok) only
        verified ties, as K1's in phases 3 and 9: both winners are hits
        whose t agree within 1e-6 relative (a tie decided by the traversal
        order, or by the bound carried across parts). -> their count."""
        differ = (pk != ref).any(1)
        n = int(differ.sum())
        if n:
            require(ties_ok, what, "differs on", n, "lanes")
            ts_ = []
            for pack in (pk[differ], ref[differ]):
                tr, _, ok = ix.intersect_tri_lanes(o[differ], d[differ], t_max[differ],
                                                   pack[:, 28:31], pack[:, 31:34],
                                                   pack[:, 34:37])
                require(bool(ok.all()) and bool(torch.isfinite(pack[:, 0]).all()), what,
                        "a differing winner that misses")
                ts_ += [tr, pack[:, 0]]
            rel = max(float(((ts_[0] - ts_[2]).abs() / ts_[2].abs()).max()),
                      float(((ts_[1] - ts_[3]).abs() / ts_[3].abs()).max()))
            require(rel <= 1e-6, what, "a differing winner is not a tie", rel)
        return n

    def compare_parts(sh, o, d, t_max, ties_ok=False):
        """K11a against its plain version and the yardstick (bit for bit; with
        ties_ok, but for verified ties) and the unsharded K1 -> (hits, lanes
        whose winner differs from K1's, max rel err of t against K1, tie
        lanes against plain and yardstick, plain ms)."""
        pk = ss.closest_parts_cuda(sh.rows, sh.recv, sh.n_int, sh.depth, o, d, t_max)
        pp, ms_p = plain_ms_of(lambda: ss.closest_parts_plain(sh.rows, sh.recv, sh.n_int, o, d,
                                                              t_max))
        n_tp = pack_ties(pk, pp, o, d, t_max, "K11a against its plain version", ties_ok)
        n_ty = pack_ties(pk, unfused_pack(sh, o, d, t_max), o, d, t_max,
                         "K11a against the unfused K1-per-part yardstick", ties_ok)
        t1, p1 = bvh.traverse_cuda(rows, n_int, depth, o, d, t_max)
        hit = p1 >= 0
        require(torch.equal(hit, torch.isfinite(pk[:, 0])), "K11a: hit set differs from K1's")
        rel = ((pk[hit, 0] - t1[hit]).abs() / t1[hit].abs()).max() if bool(hit.any()) else 0.0
        require(float(rel) <= 1e-5, "K11a: t differs from K1's", float(rel))
        pc = p1.clamp(min=0)
        same = (pk[:, 28:] == torch.cat([scene.tri_p0[pc], scene.tri_p1[pc], scene.tri_p2[pc]],
                                        dim=1)).all(1) & hit
        n_hit, n_same = int(hit.sum()), int(same.sum())
        require(n_same >= 0.99 * n_hit, "K11a: winners differ from K1's", n_same, n_hit)
        other = hit & ~same
        if ties_ok:
            rel_o = ((pk[other, 0] - t1[other]).abs() / t1[other].abs()).max() \
                if bool(other.any()) else 0.0
            require(float(rel_o) <= 1e-6, "K11a: a different winner than K1's at another t")
        else:
            require(torch.equal(pk[other, 0], t1[other]), "K11a: a different winner at another t")
        both = torch.isfinite(pk[:, 0]) & torch.isfinite(pp[:, 0])
        err_t = float((pk[both, 0] - pp[both, 0]).abs().max()) if bool(both.any()) else 0.0
        return n_hit, n_hit - n_same, float(rel), (n_tp, n_ty, err_t), ms_p

    def compare_any_parts(sh, o, d, t_max):
        """K11b against its plain version, the yardstick and K1a -> (occluded,
        plain ms)."""
        ok = ss.any_parts_cuda(sh.rows, sh.n_int, sh.depth, o, d, t_max)
        op, ms_p = plain_ms_of(lambda: ss.any_parts_plain(sh.rows, sh.n_int, o, d, t_max))
        require(torch.equal(ok, op), "K11b differs from its plain version",
                int((ok != op).sum()))
        require(torch.equal(ok, unfused_any(sh, o, d, t_max)), "K11b differs from the yardstick")
        require(torch.equal(ok, bvh.traverse_cuda(rows, n_int, depth, o, d, t_max,
                                                  any_hit=True)[1] >= 0),
                "K11b differs from the unsharded K1a")
        return int(ok.sum()), ms_p

    o, d, t_max = camera_and_interior_rays(scene, meta)
    n_hit, n_tie, rel, _, _ = compare_parts(sh8, o, d, t_max)
    t_cl, _ = bvh.traverse_cuda(rows, n_int, depth, o, d, t_max)
    n_occ, _ = compare_any_parts(sh8, o, d, shadow_t(t_cl))
    log(f"bvh_closest_hit_parts vs plain on {o.shape[0]} camera+interior rays over 8 parts: "
        f"packs bit-exact (and with the unfused K1-per-part yardstick); against the unsharded "
        f"K1 {n_hit} hits, the same triangle on all but {n_tie} (equal t), max rel err t "
        f"{rel:.2e}; bvh_any_hit_parts {n_occ} occluded, bit-exact with plain, yardstick and "
        f"K1a")

    def planted_packs(pack, W=4):
        """W packs from one: rank w's rows rolled by 17 w, and on every third
        ray ranks 1 and 2 tied with rank 0's t."""
        packs = torch.stack([pack.roll(17 * w, dims=0) for w in range(W)]).contiguous()
        packs[1:3, ::3, 0] = packs[0, ::3, 0]
        return packs

    pk8 = ss.closest_parts_cuda(sh8.rows, sh8.recv, sh8.n_int, sh8.depth, o, d, t_max)
    packs4 = planted_packs(pk8)
    require(torch.equal(ss.select_cuda(packs4), ss.select_plain(packs4)),
            "shard_select differs from its plain version")
    log(f"shard_select vs plain on 4 stacked packs of {o.shape[0]} rays, ties planted on every "
        f"third ray: bit-exact")

    # (b) the scene-sharded full-width frames through render(shard_parts=N)
    parts_k = ("bvh_closest_hit_parts", "bvh_any_hit_parts", "film_add_samples")

    def sharded_frame(tag, sc, mt, n_parts, ref_tag, ref_stats, must=parts_k, prebuilt=True):
        """A scene-sharded frame through render(): of the scene split by
        rd.shard_scene first (its host build and upload timed alone, the
        frame's wall time without it) or, prebuilt=False, through
        render(shard_parts=n_parts) as the CLI's --shard-scene calls it."""
        kw = {"shard_parts": n_parts}
        if prebuilt:
            t0 = time.time()
            sc = rd.shard_scene(sc, n_parts)
            torch.cuda.synchronize()
            log(f"{tag}: shard_scene ({n_parts} parts of rows {tuple(sc.shard.rows.shape)}, "
                f"host build and upload) {time.time() - t0:.2f} s")
            kw = {}
        st = full_render(tag, sc, mt, must, **kw)
        k1 = {k: main_counts_frame.get(k, 0) for k in bvh.launches}
        require(not any(k1.values()), tag, "K1 launched on a sharded frame", k1)
        require(st == ref_stats, tag, "ray counts differ from the unsharded frame", st,
                ref_stats)
        fb = check_image(frame_imgs[tag], frame_imgs[ref_tag], f"{tag} vs {ref_tag}")
        log(f"{tag}: {n_parts} parts, ray counts equal to the {ref_tag} frame's {ref_stats}, "
            f"K1 not launched; vs that frame {fb:.4%} bad px, means {frame_means[tag]:.5f} / "
            f"{frame_means[ref_tag]:.5f}")

    sharded_frame("cornell_mesh_sharded", scene, meta, 8, "cornell_mesh", st_cm)
    sharded_frame("terrain_sharded", s_terr, m_terr, 4, "terrain", st_terr_b)

    # (c) NCCL at world size 1: the collectives are issued (and counted)
    import torch.distributed as tdist

    issued = {"all_reduce": 0, "all_gather": 0}

    def counting(name):
        orig = getattr(tdist, name)

        def call(*a, **k):
            issued[name] += 1
            return orig(*a, **k)
        return orig, call

    store = kernels.BUILD_DIR / "nccl_world1"
    store.unlink(missing_ok=True)
    tdist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                             device_id=torch.device("cuda", torch.cuda.current_device()))
    origs = {n: counting(n) for n in issued}
    try:
        for n, (_, call) in origs.items():
            setattr(tdist, n, call)
        st = full_render("cornell_mesh_dp_nccl", scene, meta, ("bvh_closest_hit", "bvh_any_hit",
                                                               "film_add_samples"))
        require(st == st_cm, "NCCL pixel-parallel frame: ray counts", st, st_cm)
        require(issued["all_reduce"] >= 4, "NCCL pixel-parallel frame: no all_reduce", issued)
        fb = check_image(frame_imgs["cornell_mesh_dp_nccl"], frame_imgs["cornell_mesh"],
                         "NCCL pixel-parallel frame")
        log(f"NCCL world size 1, pixel-parallel cornell-mesh: the cornell_mesh frame's ray "
            f"counts, {issued['all_reduce']} all_reduce issued (film and counts), vs that frame "
            f"{fb:.4%} bad px")
        issued.update(all_reduce=0, all_gather=0)
        sharded_frame("cornell_mesh_sharded_nccl", scene, meta, 8, "cornell_mesh", st_cm,
                      must=parts_k + ("shard_select",), prebuilt=False)
        n_sel = main_counts_frame["shard_select"]
        require(issued["all_gather"] == n_sel == main_counts_frame["bvh_closest_hit_parts"]
                and issued["all_reduce"] == main_counts_frame["bvh_any_hit_parts"],
                "NCCL scene-sharded frame: collectives", issued, main_counts_frame)
        log(f"NCCL world size 1, scene-sharded cornell-mesh: {issued['all_gather']} all_gather "
            f"of the candidate packs, each resolved by shard_select, and {issued['all_reduce']} "
            f"all_reduce(MAX) of the shadow bits")
    finally:
        for n, (orig, _) in origs.items():
            setattr(tdist, n, orig)
        tdist.destroy_process_group()
    log("scaling across cards: not measurable on one card (one H100 in this machine; NCCL ran "
        "at world size 1)")

    # (d) timed at their first launches in (b)'s cornell-mesh frame and, the
    # select kernel, in (c)'s
    (rows_s, recv_s, nint_s, depth_s, o_, d_, t_), _, _ = first("cornell_mesh_sharded",
                                                                "bvh_closest_hit_parts")
    sh_f = sh8._replace(rows=rows_s, recv=recv_s)
    R_ = o_.shape[0]
    n_h, n_tie, rel, (n_tp, n_ty, err_t), ms_plain = compare_parts(sh_f, o_, d_, t_,
                                                                   ties_ok=True)
    work = torch.zeros(4, dtype=torch.int64, device=dev)
    ss.closest_parts_cuda(rows_s, recv_s, nint_s, depth_s, o_, d_, t_, stats=work)
    n_nodes, n_tris, n_edge, n_range = (int(x) for x in work.cpu())
    ms, call = kernel_ms(lambda: ss.closest_parts_cuda(rows_s, recv_s, nint_s, depth_s, o_, d_,
                                                       t_), 20)
    ms_y = graph_ms(lambda: unfused_pack(sh_f, o_, d_, t_))
    b = bound(rows_s.numel() * 4 + n_h * ss.REC_W * 4 + R_ * 28 + R_ * ss.PACK_W * 4,
              n_nodes * SLAB_VISIT_OPS + tri_test_ops(n_tris, n_edge, n_range))
    timing["bvh_closest_hit_parts"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0],
                                           bound_by=b[1], library_ms=None, max_abs_err=err_t,
                                           yardstick_ms=ms_y)
    log(f"bvh_closest_hit_parts at the main path's launch ({R_} lanes x 8 parts, {n_h} hits, "
        f"{n_nodes} node visits, {n_tris} tri tests, {n_edge} past the edge test, {n_range} "
        f"past t range): kernel {ms:.3f} ms (host-paced {call:.3f} ms), unfused K1-per-part "
        f"yardstick {ms_y:.3f} ms, plain {ms_plain:.1f} ms, bound {b[0]:.4f} ms ({b[1]}); "
        f"packs bit-exact with plain but on {n_tp} and with the yardstick but on {n_ty} "
        f"verified tie lanes; against the unsharded K1 the same triangle on all but {n_tie} "
        f"hits, max rel err t {rel:.2e}; max abs err of t against plain {err_t:.2e}")
    (rows_s, nint_s, depth_s, o_, d_, t_), _, _ = first("cornell_mesh_sharded",
                                                        "bvh_any_hit_parts")
    n_o, ms_plain = compare_any_parts(sh_f, o_, d_, t_)
    work.zero_()
    ss.any_parts_cuda(rows_s, nint_s, depth_s, o_, d_, t_, stats=work)
    n_nodes, n_tris, n_edge, n_range = (int(x) for x in work.cpu())
    ms, call = kernel_ms(lambda: ss.any_parts_cuda(rows_s, nint_s, depth_s, o_, d_, t_), 20)
    ms_y = graph_ms(lambda: unfused_any(sh_f, o_, d_, t_))
    b = bound(rows_s.numel() * 4 + o_.shape[0] * 29,
              n_nodes * SLAB_VISIT_OPS + tri_test_ops(n_tris, n_edge, n_range))
    timing["bvh_any_hit_parts"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                       library_ms=None, max_abs_err=0.0, yardstick_ms=ms_y)
    log(f"bvh_any_hit_parts at the main path's launch ({o_.shape[0]} lanes x 8 parts, {n_o} "
        f"occluded, {n_nodes} node visits, {n_tris} tri tests): kernel {ms:.3f} ms "
        f"(host-paced {call:.3f} ms), unfused K1a-per-part yardstick {ms_y:.3f} ms, plain "
        f"{ms_plain:.1f} ms, bound {b[0]:.4f} ms ({b[1]}); bit-exact")
    (packs_s,), _, _ = first("cornell_mesh_sharded_nccl", "shard_select")
    W_, R_ = packs_s.shape[0], packs_s.shape[1]
    out_p, _ = plain_ms_of(lambda: ss.select_plain(packs_s))
    require(torch.equal(ss.select_cuda(packs_s), out_p), "shard_select differs on the main "
            "path's launch")
    ms, call = kernel_ms(lambda: ss.select_cuda(packs_s))
    ms_plain = events_ms(lambda: ss.select_plain(packs_s), 20)
    b = bound((W_ + 1) * R_ * ss.PACK_W * 4, W_ * R_)
    timing["shard_select"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                  library_ms=None, max_abs_err=0.0)
    log(f"shard_select at the main path's launch ({W_} rank x {R_} packs): kernel {ms:.4f} ms "
        f"(host-paced {call:.4f} ms), plain {ms_plain:.3f} ms, bound {b[0]:.5f} ms ({b[1]}); "
        f"bit-exact")

    # ---- 12. instancing (K1i) on the instanced cornell box
    def inst_scene(levels, mode, res=256, spp=16, filt=None, integrator=None):
        """(builder, scene, meta) of the instanced cornell box under
        instancing `mode`, compiled on the card."""
        b = ts.instanced_cornell_builder(levels, res, spp, mode, filt)
        sc, mt = compile_scene(b, device=dev, integrator_override=integrator)
        return b, sc, mt

    def inst_rays(sc, mt):
        """131,072 camera rays and 131,072 rays from random points of the
        box inside the scene's bounding sphere; every 97th lane masked."""
        p_film = torch.rand((131072, 2), generator=g) * torch.tensor(mt.resolution,
                                                                      dtype=torch.float32)
        rays = perspective.generate_rays(sc, p_film.to(dev), torch.zeros((131072, 2),
                                                                          device=dev))
        c, r = sc.scene_center.cpu(), float(sc.scene_radius)
        o_in = c + 0.55 * r * (2.0 * torch.rand((131072, 3), generator=g) - 1.0)
        d_in = torch.randn((131072, 3), generator=g)
        d_in = d_in / d_in.norm(dim=-1, keepdim=True)
        o = torch.cat([rays.o, o_in.to(dev)]).contiguous()
        d = torch.cat([rays.d, d_in.to(dev)]).contiguous()
        t_max = torch.full((o.shape[0],), INFINITY, device=dev)
        t_max[::97] = 0.0
        return o, d, t_max

    def inst_args(sc, mt):
        return sc.bvh_rows, mt.bvh_nint, mt.bvh_ninst, mt.bvh_depth, mt.bvh_iterb

    def compare_inst(args, leaves, o, d, t_max):
        """K1i (launch arguments `args` but the rays) vs plain closest hit
        (the scene's bvh_leaves): prim, inst and t bit-exact but on verified
        ties (K1's criterion). -> (hits, instanced hits, ties, plain t, max
        abs err of t, plain ms)."""
        tk, pk, ik = bvh.traverse_inst_cuda(*args, o, d, t_max)
        (tp, pp, ip), ms_p = plain_ms_of(lambda: bvh.traverse_inst_plain(
            args[0], args[1], leaves, o, d, t_max))
        require(torch.equal(pk >= 0, pp >= 0), "K1i closest hit: hit/miss disagree")
        same = (pk == pp) & (ik == ip)
        require(torch.equal(tk[same], tp[same]), "K1i: t differs on the same winner")
        differ = ~same
        if bool(differ.any()):
            rel = (tk[differ] - tp[differ]).abs() / tp[differ].abs()
            require(float(rel.max()) <= 1e-6, "K1i winner disagreement is not a tie",
                    float(rel.max()))
        hit = pp >= 0
        err = float((tk - tp).abs()[hit].max()) if bool(hit.any()) else 0.0
        return int(hit.sum()), int((ip >= 0).sum()), int(differ.sum()), tp, err, ms_p

    def compare_inst_any(args, leaves, o, d, t_max):
        """K1i any hit vs plain: the bits equal. -> (occluded, plain ms)."""
        ak = bvh.traverse_inst_cuda(*args, o, d, t_max, any_hit=True)[1]
        ap, ms_p = plain_ms_of(lambda: bvh.traverse_inst_plain(args[0], args[1], leaves, o, d,
                                                               t_max, any_hit=True)[1])
        require(torch.equal(ak >= 0, ap >= 0), "K1i any hit disagrees on",
                int(((ak >= 0) != (ap >= 0)).sum()))
        return int((ap >= 0).sum()), ms_p

    # (a) levels (3, 2), every instance shared, against the plain version and
    # against K1 on the same scene flattened
    _, s_ia, m_ia = inst_scene((3, 2), "bvh")
    _, s_fa, m_fa = inst_scene((3, 2), "flatten")
    require(m_ia.bvh_ninst == 52 and m_fa.bvh_ninst == 0, "instanced (3, 2) scenes",
            m_ia.bvh_ninst, m_fa.bvh_ninst)
    o_a, d_a, t_a = inst_rays(s_ia, m_ia)
    n_h, n_hi, n_tie, t_cl, _, _ = compare_inst(inst_args(s_ia, m_ia), m_ia.bvh_leaves, o_a, d_a,
                                                t_a)
    n_o, _ = compare_inst_any(inst_args(s_ia, m_ia), m_ia.bvh_leaves, o_a, d_a, shadow_t(t_cl))
    tf_, pf_ = bvh.traverse_cuda(s_fa.bvh_rows, m_fa.bvh_nint, m_fa.bvh_depth, o_a, d_a, t_a)
    ti_, pi_, _ = bvh.traverse_inst_cuda(*inst_args(s_ia, m_ia), o_a, d_a, t_a)
    hi_, hf_ = pi_ >= 0, pf_ >= 0
    mask_eq = float((hi_ == hf_).float().mean())
    both = hi_ & hf_
    # t rounds with the coordinates, not with t: an interior ray that starts
    # near a surface has a t of ~1e-2 against coordinates of ~1e3 in render
    # space, so the bound has a floor of 1e-5 of the origin's magnitude
    dt = (ti_ - tf_).abs()[both]
    t_rel = float((dt <= 1e-4 * tf_[both].abs()).float().mean())
    t_ok = float((dt <= 1e-4 * tf_[both].abs() + 1e-5 * o_a.abs().amax(1)[both])
                 .float().mean())
    require(mask_eq >= 0.9999 and t_ok == 1.0, "K1i vs K1 flattened", mask_eq, t_ok)
    log(f"instanced cornell (3, 2), {m_ia.bvh_ninst} instances, {s_ia.bvh_rows.shape[0]} rows "
        f"(flattened: {m_fa.n_tris} tris, {s_fa.bvh_rows.shape[0]} rows): K1i vs plain on "
        f"{o_a.shape[0]} camera+interior rays: {n_h} hits ({n_hi} in instances), {n_tie} "
        f"verified ties, t bit-exact on the same winner; any hit {n_o} occluded, 0 disagree; "
        f"against K1 on the flattened scene: hit masks equal on {mask_eq:.6%} of lanes, t "
        f"within rtol 1e-4 on {t_rel:.4%} of common hits and within rtol 1e-4 plus 1e-5 of "
        f"the origin's magnitude on {t_ok:.4%}")

    # (b) small renders: path 48^2 x 4 (card, CPU, card flattened), BDPT
    # 24^2 x 8 (card, CPU), mltpath 24^2 (card, CPU, one seed)
    k1i = ("bvh_closest_hit_inst", "bvh_any_hit_inst")
    k1 = ("bvh_closest_hit", "bvh_any_hit")
    for label, mode, res, spp, integ in (("path 48^2 x 4", "bvh", 48, 4, None),
                                          ("bdpt 24^2 x 8", "bvh", 24, 8, "bdpt")):
        _, sc, mt = inst_scene((3, 2), mode, res=res, spp=spp, filt="box", integrator=integ)
        reset_counts()
        img_gpu, st_gpu = rd.render(sc, mt, return_stats=True)
        img_gpu = img_gpu.cpu().numpy()
        counts = {k: v for k, v in read_counts().items() if v}
        must = k1i + (("bdpt_connect_rays", "bdpt_connect_weight", "film_add_splats")
                      if integ else ("film_add_samples",))
        require(all(counts.get(k, 0) > 0 for k in must) and not any(k in counts for k in k1),
                label, "launches", counts)
        img_cpu, st_cpu = rd.render(sc, mt, device="cpu", return_stats=True)
        img_cpu = img_cpu.numpy()
        fb_c = check_image(img_gpu, img_cpu, f"instanced {label} vs cpu render")
        n_g, n_c = sum(st_gpu.values()), sum(st_cpu.values())
        require(abs(n_g - n_c) <= 1e-3 * n_c, label, "ray counts", st_gpu, st_cpu)
        msg = (f"small instanced render {label}: vs cpu {fb_c:.4%} bad px, rays card {n_g} cpu "
               f"{n_c}, means {img_gpu.mean():.5f} / {img_cpu.mean():.5f}; launches {counts}")
        if not integ:
            _, sf, mf = inst_scene((3, 2), "flatten", res=res, spp=spp, filt="box")
            img_f, st_f = rd.render(sf, mf, return_stats=True)
            fb_f = check_image(img_gpu, img_f.cpu().numpy(), f"instanced {label} vs flattened")
            require(abs(sum(st_f.values()) - n_g) <= 1e-3 * n_g, "flattened ray count", st_f)
            msg += f"; vs the card's flattened render {fb_f:.4%} bad px, rays {sum(st_f.values())}"
        log(msg)
    _, sc, mt = inst_scene((3, 2), "bvh", res=24, spp=1, filt="box", integrator="mltpath")
    mt = dataclasses.replace(mt, mutations_per_pixel=mlt_cases.SMALL_MUTATIONS)
    runs = {}
    for d_ in (dev, torch.device("cpu")):
        acc = []
        reset_counts()
        img, st = mlt.render_mlt(
            sc, mt, n_chains=mlt_cases.SMALL_CHAINS, n_bootstrap=mlt_cases.SMALL_BOOTSTRAP,
            device=d_, on_pass=lambda i, a, acc=acc, d_=d_: acc.append(
                mlt.accept_uniforms(0, i, mlt_cases.SMALL_CHAINS, d_) < a))
        runs[d_.type] = (img.cpu().numpy(), torch.stack(acc).cpu(), st,
                         {k: v for k, v in read_counts().items() if v})
    (img_g, acc_g, st_g, counts), (img_c, acc_c, st_c, _) = runs["cuda"], runs["cpu"]
    n_passes = acc_g.shape[0]
    require(counts.get("mlt_mutate") == n_passes == counts.get("mlt_accept_splat")
            and all(counts.get(k, 0) > 0 for k in k1i), "instanced mltpath", counts)
    res = mlt_cases.compare_renders(img_g, img_c, acc_g, acc_c)
    log(f"small instanced MLT render mltpath 24^2, {mlt_cases.SMALL_CHAINS} chains x {n_passes} "
        f"passes, card vs cpu with one seed: accept decisions equal on {res['decisions']:.4%} "
        f"(>= {mlt_cases.DECISION_FRAC:.0%} required), 8x8 block means worst "
        f"{res['block_rel']:.4%} apart (<= {mlt_cases.BLOCK_RTOL:.0%}), means "
        f"{img_g.mean():.5f} / {img_c.mean():.5f}; launches {counts}")

    # (c) the full-width frame cornell-instanced, then its flattened twin
    def repeat_frames(sc, mt, n=7):
        """Honest rays/s and frame seconds of n more renders -> (rays/s
        median, quartiles, frame seconds median)."""
        rates, walls = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.time()
            _, st = rd.render(sc, mt, return_stats=True)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            rates.append((st["closest"] + st["shadow"]) / walls[-1])
        q1, med, q3 = np.percentile(rates, [25, 50, 75])
        return med, (q1, q3), float(np.median(walls))

    def table_bytes(sc):
        return (sc.bvh_rows.numel() + sc.tri_rec.numel()) * 4

    inst_frame = {}
    for tag, mode in (("cornell_instanced", "auto"), ("cornell_instanced_flat", "flatten")):
        t0 = time.time()
        b_, sc, mt = inst_scene((6, 5), mode)
        compile_s = time.time() - t0
        n_flat = len(b_.tri_p)
        n_proto = sum(p["P"].shape[0] for p in b_.protos)
        n_world = n_flat + sum(b_.protos[i["proto"]]["P"].shape[0] for i in b_.instances)
        require(n_world == 1310732 and (mode == "flatten" or (
            n_flat, len(b_.instances), len(b_.protos), n_proto) == (253964, 42, 2, 40960)),
            tag, "triangle split", n_world, n_flat, len(b_.instances), n_proto)
        log(f"{tag} compile: {compile_s:.2f} s (parse, loop subdivision, host build of "
            f"{'both levels' if mt.bvh_ninst else 'one level'}): {n_world} world triangles, "
            f"{n_flat} stored flat, {len(b_.instances)} instances of {len(b_.protos)} "
            f"prototypes ({n_proto} triangles); {sc.bvh_rows.shape[0]} rows, depth "
            f"{mt.bvh_depth}; bvh_rows + tri_rec {table_bytes(sc) / 2**20:.2f} MiB")
        del b_
        st = full_render(tag, sc, mt, (k1i if mt.bvh_ninst else k1) + ("film_add_samples",))
        require(not any(k in main_counts_frame for k in (k1 if mt.bvh_ninst else k1i)), tag,
                "launched the other traversal", main_counts_frame)
        peak = torch.cuda.max_memory_allocated()
        med, (q1, q3), wall = repeat_frames(sc, mt)
        inst_frame[tag] = dict(scene=sc, meta=mt, stats=st, rate=med, wall=wall, peak=peak,
                               bytes=table_bytes(sc), compile=compile_s)
        log(f"{tag}: honest rays/s median {med / 1e6:.3f} M (quartiles {q1 / 1e6:.3f} .. "
            f"{q3 / 1e6:.3f}) over 7 renders, frame {wall:.4f} s median, peak mem "
            f"{peak / 2**30:.2f} GiB, tables {table_bytes(sc) / 2**20:.2f} MiB")
    fi, ff = inst_frame["cornell_instanced"], inst_frame["cornell_instanced_flat"]
    n_i, n_f = (sum(x["stats"].values()) for x in (fi, ff))
    require(abs(n_i - n_f) <= 0.01 * n_f, "instanced vs flattened ray counts", n_i, n_f)
    # the twins are not the same float32 geometry (flattening rounds the
    # vertices in render space, K1i the ray in object space): nearly every
    # path is the same (the ray counts differ by ~1e-6), but a path that an
    # ulp turns apart at a glass or glossy surface moves its pixel at 16 spp.
    # So the frames are held to check_image's mean rule and its per-pixel
    # tolerance on >= 98 % of pixel values (0.82 % fell outside it in one
    # run on an H100); (b) holds the small render to check_image itself. The
    # noise floor shows what the 2 % rule tells apart: the flattened twin
    # against its own second estimate (samples 16..31 of every pixel, the
    # same batched loop) must fall outside it. Where the bad pixels lie is
    # read from the material of each pixel centre's first hit.
    img_i, img_f = frame_imgs["cornell_instanced"], frame_imgs["cornell_instanced_flat"]
    s_ff, m_ff = ff["scene"], ff["meta"]
    W_, H_ = m_ff.resolution
    film2 = filmlib.new_film(m_ff.resolution, dev)
    for ids, sids in rd.wave_lanes(W_ * H_, m_ff.spp, dev):
        rd.render_wave(s_ff, m_ff, film2, ids, sids + m_ff.spp)
    img_f2 = filmlib.develop(film2, m_ff.resolution, out_matrix=m_ff.film_out_matrix,
                             imaging_ratio=m_ff.film_imaging_ratio).cpu().numpy()
    ys, xs = torch.meshgrid(torch.arange(H_), torch.arange(W_), indexing="ij")
    p_c = (torch.stack([xs.reshape(-1), ys.reshape(-1)], 1).float() + 0.5).to(dev)
    rays_c = perspective.generate_rays(s_ff, p_c, torch.zeros_like(p_c))
    hit_c = dispatch.intersect(s_ff, m_ff, rays_c.o, rays_c.d,
                               torch.full((W_ * H_,), INFINITY, device=dev))
    kind = torch.where(hit_c.valid, s_ff.mat_type[hit_c.mat.clamp(min=0)], -1)
    kind = kind.reshape(H_, W_).cpu().numpy()
    on_gem, on_ball = kind == bd.MAT_DIELECTRIC, kind == bd.MAT_CONDUCTOR

    def twin_reading(img, ref):
        """(share of pixel values outside check_image's tolerance, pixels
        with such a value, their shares on the gems and on the balls)"""
        bad = np.abs(img - ref) > 5e-3 + 0.05 * np.abs(ref)
        px = bad.any(-1)
        n = max(int(px.sum()), 1)
        return float(bad.mean()), int(px.sum()), (px & on_gem).sum() / n, (px & on_ball).sum() / n

    px_bad, n_px, gem_i, ball_i = twin_reading(img_i, img_f)
    floor_bad, n_px_f, gem_f, ball_f = twin_reading(img_f2, img_f)
    mean_rel = abs(float(img_i.mean()) / float(img_f.mean()) - 1.0)
    require(np.isfinite(img_i).all() and px_bad < 0.02 < floor_bad and mean_rel < 0.01,
            "cornell-instanced vs its flattened twin (and the twin's noise floor)", px_bad,
            floor_bad, mean_rel)
    log(f"cornell-instanced against its flattened twin: rays {n_i} / {n_f} "
        f"({n_i / n_f - 1:+.4%}), per pixel value {px_bad:.4%} bad (< 2 %), means "
        f"{img_i.mean():.5f} / {img_f.mean():.5f} ({mean_rel:.4%} apart); noise floor, the "
        f"twin against its second estimate (samples 16..31): {floor_bad:.4%} bad (> 2 %), "
        f"means {img_f2.mean():.5f} / {img_f.mean():.5f}; pixels with a bad value: twins "
        f"{n_px}, {gem_i:.2%} on the gems and {ball_i:.2%} on the balls; floor {n_px_f}, "
        f"{gem_f:.2%} / {ball_f:.2%}; the gems are {on_gem.mean():.2%} of the frame's "
        f"pixels, the balls {on_ball.mean():.2%}; "
        f"rays/s {fi['rate'] / 1e6:.3f} / "
        f"{ff['rate'] / 1e6:.3f} M ({fi['rate'] / ff['rate']:.3f}x), frame {fi['wall']:.4f} / "
        f"{ff['wall']:.4f} s, peak {fi['peak'] / 2**30:.2f} / {ff['peak'] / 2**30:.2f} GiB, "
        f"tables {fi['bytes'] / 2**20:.2f} / {ff['bytes'] / 2**20:.2f} MiB "
        f"({ff['bytes'] / fi['bytes']:.2f}x), compile {fi['compile']:.2f} / "
        f"{ff['compile']:.2f} s")

    # (d) K1i at its first launches in the instanced frame: held against
    # its plain version on those arguments, and timed beside its bound, the
    # plain version and the flattened frame's K1 on the same rays
    leaves_i = fi["meta"].bvh_leaves
    for any_hit, name in ((False, "bvh_closest_hit_inst"), (True, "bvh_any_hit_inst")):
        (rows_, nint_, ninst_, depth_, iterb_, o_, d_, t_, *_), _, _ = first(
            "cornell_instanced", name)
        args_ = (rows_, nint_, ninst_, depth_, iterb_)
        R_ = o_.shape[0]
        if any_hit:
            (n_live, ms_plain), n_tie, err = compare_inst_any(args_, leaves_i, o_, d_, t_), 0, 0.0
        else:
            n_live, _, n_tie, _, err, ms_plain = compare_inst(args_, leaves_i, o_, d_, t_)
        tk, pk, ik = bvh.traverse_inst_cuda(*args_, o_, d_, t_, any_hit)
        tf_, pf_ = bvh.traverse_cuda(s_ff.bvh_rows, m_ff.bvh_nint, m_ff.bvh_depth, o_, d_, t_,
                                     any_hit)
        agree = float(((pk >= 0) == (pf_ >= 0)).float().mean())
        require(agree >= 0.9999, name, "against K1 on the flattened frame", agree)
        work = torch.zeros(5, dtype=torch.int64, device=dev)
        bvh.traverse_inst_cuda(*args_, o_, d_, t_, any_hit, stats=work)
        n_nodes, n_tris, n_edge, n_range, n_ent = (int(x) for x in work.cpu())
        ms, call = kernel_ms(lambda: bvh.traverse_inst_cuda(*args_, o_, d_, t_, any_hit), 20)
        ms_y = graph_ms(lambda: bvh.traverse_cuda(s_ff.bvh_rows, m_ff.bvh_nint, m_ff.bvh_depth,
                                                  o_, d_, t_, any_hit))
        b = bound(rows_.numel() * 4 + R_ * 7 * 4 + R_ * (4 if any_hit else 12),
                  n_nodes * SLAB_VISIT_OPS + tri_test_ops(n_tris, n_edge, n_range)
                  + n_ent * INST_ENTRY_OPS)
        timing[name] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                            library_ms=None, max_abs_err=err, yardstick_ms=ms_y)
        log(f"{name} at the main path's launch ({R_} lanes, {n_live} "
            f"{'occluded' if any_hit else 'hits'}, {int((ik >= 0).sum())} in instances, "
            f"{n_nodes} node visits, {n_ent} instance entries, {n_tris} tri tests, {n_edge} past "
            f"the edge test, {n_range} past t range): against its plain version on these "
            f"arguments {'the bits equal' if any_hit else f'bit-exact but on {n_tie} verified ties'}"
            f", max abs err of t {err:.3e}; kernel {ms:.3f} ms (host-paced {call:.3f} ms), the "
            f"flattened frame's K1 on the same rays {ms_y:.3f} ms (yardstick; hit masks equal on "
            f"{agree:.6%}), plain {ms_plain:.1f} ms, bound {b[0]:.4f} ms ({b[1]})")
    del inst_frame, fi, ff, s_ff, s_fa

    ov = int(bvh.overflow_counter(dev).item()) - ov0
    require(ov == 0, "traversal overflow lanes", ov)
    log("traversal overflow counter: 0")

    # ---- 13. kernels line and result
    meta_k = {
        "bvh_closest_hit": ("cuda", "pbrt_tpu_torch/csrc/bvh_traverse.cu",
                            "pbrt_tpu/accel/bvh.py:909"),
        "bvh_any_hit": ("cuda", "pbrt_tpu_torch/csrc/bvh_traverse.cu",
                        "pbrt_tpu/accel/bvh.py:1218"),
        "film_add_samples": ("triton", "pbrt_tpu_torch/film/film_kernel.py",
                             "pbrt_tpu/film/film.py:44"),
        "dense_tri_closest": ("cuda", "pbrt_tpu_torch/csrc/dense_intersect.cu",
                              "pbrt_tpu/geometry/intersect.py:224"),
        "dense_tri_any": ("cuda", "pbrt_tpu_torch/csrc/dense_intersect.cu",
                          "pbrt_tpu/geometry/intersect.py:244"),
        "dense_spheres": ("cuda", "pbrt_tpu_torch/csrc/dense_intersect.cu",
                          "pbrt_tpu/geometry/intersect.py:267"),
        "dense_disks": ("cuda", "pbrt_tpu_torch/csrc/dense_intersect.cu",
                        "pbrt_tpu/geometry/intersect.py:358"),
        "wavefront_recycle": ("cuda", "pbrt_tpu_torch/csrc/wavefront.cu",
                              "pbrt_tpu/integrators/render.py:228"),
        "layered_f": ("cuda", "pbrt_tpu_torch/csrc/layered.cu",
                      "pbrt_tpu/materials/layered.py:82"),
        "layered_sample": ("cuda", "pbrt_tpu_torch/csrc/layered.cu",
                           "pbrt_tpu/materials/layered.py:334"),
        "layered_pdf": ("cuda", "pbrt_tpu_torch/csrc/layered.cu",
                        "pbrt_tpu/materials/layered.py:475"),
        "film_add_splats": ("triton", "pbrt_tpu_torch/film/film_kernel.py",
                            "pbrt_tpu/film/film.py:70"),
        "bdpt_connect_rays": ("cuda", "pbrt_tpu_torch/csrc/bdpt.cu",
                              "pbrt_tpu/integrators/bdpt.py:731"),
        "bdpt_connect_weight": ("cuda", "pbrt_tpu_torch/csrc/bdpt.cu",
                                "pbrt_tpu/integrators/bdpt.py:608"),
        "mlt_mutate": ("cuda", "pbrt_tpu_torch/csrc/mlt.cu", "pbrt_tpu/integrators/mlt.py:53"),
        "mlt_accept_splat": ("cuda", "pbrt_tpu_torch/csrc/mlt.cu",
                             "pbrt_tpu/integrators/mlt.py:106"),
        "bvh_closest_hit_parts": ("cuda", "pbrt_tpu_torch/csrc/scene_shard.cu",
                                  "pbrt_tpu/parallel/scene_shard.py:226"),
        "bvh_any_hit_parts": ("cuda", "pbrt_tpu_torch/csrc/scene_shard.cu",
                              "pbrt_tpu/parallel/scene_shard.py:256"),
        "shard_select": ("cuda", "pbrt_tpu_torch/csrc/scene_shard.cu",
                         "pbrt_tpu/parallel/scene_shard.py:226"),
        "bvh_closest_hit_inst": ("cuda", "pbrt_tpu_torch/csrc/bvh_traverse.cu",
                                 "pbrt_tpu/accel/bvh.py:794"),
        "bvh_any_hit_inst": ("cuda", "pbrt_tpu_torch/csrc/bvh_traverse.cu",
                             "pbrt_tpu/accel/bvh.py:794"),
    }
    kern = [dict(name=name, route=route, source=src, replaces=rep, launches=main_counts[name],
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
