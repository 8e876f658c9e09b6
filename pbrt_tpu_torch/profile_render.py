"""Where the time of a full-width render goes, on the GPU.

    python -m pbrt_tpu_torch.profile_render
        [--scene cornell-mesh|cornell|terrain|staircase|testball|cornell-bdpt|caustic-glass
                 |caustic-glass-mlt|cornell-mesh-mltpath|cornell-instanced
                 |cornell-instanced-flat|volumetric-caustic|volumetric-caustic-bdpt
                 |volumetric-caustic-path|textured-cornell-mesh]
        [--shard-scene N] [--traversal | --layered]
        [--out build/pbrt_tpu_torch/profile_render.json]

Renders the scene through the normal `render()` entry: cornell-mesh levels
5, the plain cornell box and terrain (130,050 triangles) at 256^2, 16 spp,
max depth 5, mitchell filter (the full-width frames of chip_smoke.py);
staircase (scenes/staircase.pbrt: 256^2, 256 spp stratified, max depth 8)
and testball (scenes/material-testball.pbrt: 256^2, 64 spp stratified, max
depth 6) at their files' own settings; with BDPT, cornell-bdpt (the plain
cornell box at 128^2 x 8, max depth 5) and caustic-glass
(scenes/caustic-glass.pbrt: 256^2 x 64, max depth 7); cornell-instanced
(testscenes.instanced_cornell_pbrt at levels (6, 5) under instancing
"auto": 1,310,732 world triangles, 42 instances of 2 prototypes under the
two-level BVH) and its flattened twin at cornell-mesh's settings;
volumetric-caustic (scenes/volumetric-caustic.pbrt: homogeneous fog, a
spot beam through a glass ball, 128^2, max depth 7) with its file's MLT
over BDPT (uncut, 100 mutations per pixel), with BDPT at 8 spp and with the
path integrator at its file's 16 spp; textured-cornell-mesh
(testscenes.textured_cornell_mesh_pbrt, levels 5, at cornell-mesh's
settings: checkerboard, imagemap, mix and named materials, K13). One
warm-up render,
REPS timed renders (11; 3 for staircase, whose frame is ~25x a cornell-mesh
frame's work, and for caustic-glass; 5 for testball), host clock around a synchronized render (the
honest rays/s of each, and their median and quartiles), then one render
under torch.profiler. For an open scene
(terrain) the timed renders go round robin over the schedules: the
wavefront loop with pools of 2^17, 2^18 and 2^19 lanes and the batched
loop, all on the same frame, so the pool choice (render.POOL_LANES) and
wavefront against batched are compared within one call. Prints the card's
name and power limit, the device busy share (summed device time of all
kernels in the profiled render over the median wall time of the unprofiled
renders of the default schedule: the profiler slows the host, not the
kernels), the peak device memory of one frame, the device time of the
hand-written kernels and of the eager PyTorch ops around them, and the top
kernels by device time; for the path family also the bounce step's route
(path.step_route: "cuda", the kernels of csrc/path_step.cu, which every
path-integrator frame on the card takes, coated scenes and MLT's path
evaluations too) and the device kernels a bounce (all of the profiled
frame's over its bounces: max_depth a wave on the batched loop, one an
iteration on the wavefront loop); writes the same as JSON to --out.

The MLT frames, caustic-glass with "mlt" (MLT over BDPT, max depth 7) and
cornell-mesh levels 5 with "mltpath" (max depth 5), both at 256^2 with
8192 chains and 100 mutations per pixel (800 passes), take minutes each:
after a warm-up frame cut to 1 mutation per pixel, the uncut frame is
rendered once (frame seconds, mutations/s, honest rays/s, peak memory),
with torch.profiler recording only PROFILED_PASSES passes from the middle
of the frame: their device time (kernels only: the profiler's step
annotations span the whole step on the device timeline and are left out)
over PROFILED_PASSES times the median wall time of the unprofiled passes
is the busy share. mltpath's evaluations take the path step's route (printed).

With --traversal (a single-level BVH scene) the profiled render is
replaced: one more frame is rendered with the arguments of every K1 and
K1a launch (bvh.traverse_cuda) kept, and each launch is then replayed
twice, each timed as graph_ms times (TURN_CALLS calls in a CUDA graph, so
the host's launch time is left out). Prints, per kind, the launches and
their summed device time: the frame's whole K1 and K1a device time, where
a profiled staircase frame does not finish in minutes.

With --layered (a coated scene: staircase, testball) the profiled render
is replaced too: one more frame is rendered until its first wave has made
its K7 launches (max_depth each of layered_f and layered_sample, twice that
of layered_pdf, issued from the path step) and its shading launches
(shade_cuda: path_shade and path_bsdf, max_depth), their arguments kept,
and each launch is replayed in turns with its yardstick, the kernels as
first written (layered_f_lane_cuda, layered_sample_lane_cuda,
layered_pdf_lane_cuda, path.shade_lane_cuda): yardstick, kernel, kernel,
yardstick, their bits compared. Prints each entry's summed device time over
the wave and that sum times the frame's waves, where a profiled staircase
frame does not finish in minutes.

With --shard-scene N (path family) the scene's triangles are split into N
morton parts once (render.shard_scene, its host seconds printed), all on
this card, and every frame is the scene-sharded render of the batched loop
(K11a/K11b in place of K1).
"""
import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

LEVELS, RES, SPP, REPS = 5, 256, 16, 11
SCENE_REPS = {"staircase": 3, "testball": 5, "caustic-glass": 3}
SCENE_FILES = {"staircase": "staircase.pbrt", "testball": "material-testball.pbrt",
               "caustic-glass": "caustic-glass.pbrt"}
POOLS = (1 << 17, 1 << 18, 1 << 19)
PROFILED_PASSES = 8
TURN_CALLS = 4
# hand-written kernels by a substring of their device symbol
KERNELS = {"bvh": "pbrt_wide::wide_kernel", "bvh_inst": "inst_wide_kernel",
           "bvh_refit": "refit_kernel",
           "dense": "dense_",
           "recycle": "recycle_", "film": "film_add_tiled_kernel",
           "film_scatter": "film_add_scatter_kernel", "layered": "LayeredArgs", "bdpt": "connect_",
           "splat": "film_splat_kernel", "mlt": "mutate_kernel|accept_splat_kernel",
           "shard": "parts_wide_kernel|select_kernel",
           "path_step": "StepArgs", "transmit": "transmit_hop_kernel"}


def _device_us(e):
    """Device microseconds of a key_averages() entry that is a GPU kernel
    (CPU-side op entries, which also carry their kernels' time, give 0)."""
    if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


def _kernel_sums(rows):
    """{kernel group: device us}, {kernel group: launches} of key_averages
    rows (name, device us, count); a group's pattern lists alternatives
    separated by "|"."""
    def hit(name, pat):
        return any(sub in name for sub in pat.split("|"))
    return ({k: sum(r[1] for r in rows if hit(r[0], p)) for k, p in KERNELS.items()},
            {k: sum(r[2] for r in rows if hit(r[0], p)) for k, p in KERNELS.items()})


def _profile_mlt(scene, meta, label, card, out_path):
    """The uncut MLT frame once, with PROFILED_PASSES passes from its middle
    under torch.profiler (see the module docstring)."""
    import dataclasses

    from pbrt_tpu_torch.integrators import mlt, path as pth

    if meta.integrator == "mltpath":
        print(f"path step route of the evaluations: {pth.step_route('cuda', meta, 'mlt')}",
              flush=True)
    res_x, res_y = meta.resolution
    n_passes = max(1, meta.mutations_per_pixel * res_x * res_y // mlt.N_CHAINS)
    t0 = time.perf_counter()
    mlt.render_mlt(scene, dataclasses.replace(meta, mutations_per_pixel=1))
    torch.cuda.synchronize()
    print(f"warm-up frame (1 mutation/px): {time.perf_counter() - t0:.2f} s", flush=True)
    start = max(PROFILED_PASSES + 1, n_passes // 2)
    if start + PROFILED_PASSES > n_passes:
        raise ValueError(f"{n_passes} passes: too few for the profiled window")
    window = {}
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=start - 1, warmup=1, active=PROFILED_PASSES,
                                         repeat=1),
        on_trace_ready=lambda p: window.setdefault("ev", p.key_averages()))
    stamps = []

    def on_pass(i, a):
        # profiler step k is pass k: the bootstrap and pass 0 are step 0
        stamps.append(time.perf_counter())
        prof.step()

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof:
        img, stats = mlt.render_mlt(scene, meta, on_pass=on_pass)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = sorted(((e.key, _device_us(e), e.count) for e in window["ev"]
                   if _device_us(e) > 0 and not e.key.startswith("ProfilerStep")),
                  key=lambda r: -r[1])
    dev_s = sum(r[1] for r in rows) / 1e6
    # pass i ends at stamps[i]; passes start .. start + P - 1 were recorded,
    # pass start - 1 warmed the profiler up
    pass_s = np.diff(np.asarray(stamps))              # pass_s[i - 1]: pass i
    outside = np.r_[pass_s[:start - 2], pass_s[start + PROFILED_PASSES:]]
    plain_wall = float(np.median(outside)) * PROFILED_PASSES
    prof_wall = stamps[start - 1 + PROFILED_PASSES] - stamps[start - 1]
    kern_us, kern_n = _kernel_sums(rows)
    rays = stats["closest"] + stats["shadow"]
    out = dict(
        card=card, scene=label, res=res_x, max_depth=meta.max_depth, chains=mlt.N_CHAINS,
        passes=n_passes, mutations=stats["mutations"], wall_s=wall,
        bootstrap_and_first_pass_s=stamps[0] - t0, rays=rays,
        mrays_per_s=rays / wall / 1e6, mutations_per_s=stats["mutations"] / wall,
        peak_gib=peak_gib, mean=float(img.mean()), finite=bool(torch.isfinite(img).all()),
        profiled_passes=[start, start + PROFILED_PASSES - 1],
        median_pass_s=plain_wall / PROFILED_PASSES, unprofiled_window_wall_s=plain_wall,
        profiled_window_wall_s=prof_wall,
        window_device_busy_s=dev_s, device_busy_share=dev_s / plain_wall,
        window_kernels_s={k: v / 1e6 for k, v in kern_us.items()},
        window_kernel_launches=kern_n, window_launches_total=sum(r[2] for r in rows),
        top=[dict(name=k[:120], device_s=us / 1e6, count=c) for k, us, c in rows[:25]])
    print(f"{label}: {n_passes} passes x {mlt.N_CHAINS} chains, frame {wall:.3f} s "
          f"(bootstrap and first pass {out['bootstrap_and_first_pass_s']:.3f} s; median "
          f"pass {out['median_pass_s']:.4f} s; the {PROFILED_PASSES} profiled passes "
          f"{prof_wall:.3f} s), {out['mutations_per_s']:.0f} mutations/s, {rays} rays = "
          f"{out['mrays_per_s']:.3f} M rays/s, peak {peak_gib:.2f} GiB, mean "
          f"{out['mean']:.5f}, finite {out['finite']}", flush=True)
    print(f"passes {start}..{start + PROFILED_PASSES - 1}: device busy {dev_s:.4f} s against "
          f"{PROFILED_PASSES} median passes' {plain_wall:.4f} s = "
          f"{out['device_busy_share']:.1%}; "
          + ", ".join(f"{k} {v / 1e6:.5f} s x{kern_n[k]}" for k, v in kern_us.items() if v)
          + f"; {out['window_launches_total']} launches", flush=True)
    for r in out["top"][:15]:
        print(f"  {r['device_s'] * 1e3:9.3f} ms  x{r['count']:<6d} {r['name']}")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(out, indent=1))
    return 0


def _graph_ms(fn, calls=TURN_CALLS):
    """Device ms of one fn() call: `calls` calls captured in one CUDA graph,
    replayed twice between CUDA events (the second timed)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def _traversal_turns(render, card, label, out_path):
    """Every K1/K1a launch of one frame replayed twice (see the module
    docstring)."""
    from pbrt_tpu_torch.accel import bvh

    kept, orig = [], bvh.traverse_cuda

    def keep(rows, n_int, depth, o, d, t_max, any_hit=False, stats=None):
        kept.append((rows, n_int, depth, o.clone(), d.clone(), t_max.clone(), any_hit))
        return orig(rows, n_int, depth, o, d, t_max, any_hit, stats)

    bvh.traverse_cuda = keep
    try:
        render()
    finally:
        bvh.traverse_cuda = orig
    torch.cuda.synchronize()
    if not kept:
        raise SystemExit("--traversal: the frame launched no K1 or K1a (a single-level BVH "
                         "scene is needed)")
    sums = {kind: dict(launches=0, k1_ms=0.0) for kind in ("bvh_closest_hit", "bvh_any_hit")}
    per_launch = []
    for rows, n_int, depth, o, d, t_max, any_hit in kept:
        args = (rows, n_int, depth, o, d, t_max, any_hit)
        turns = [_graph_ms(lambda: bvh.traverse_cuda(*args)) for _ in range(2)]
        kind = "bvh_any_hit" if any_hit else "bvh_closest_hit"
        s = sums[kind]
        s["launches"] += 1
        s["k1_ms"] += (turns[0] + turns[1]) / 2
        per_launch.append(dict(kind=kind, lanes=o.shape[0], live=int((t_max > 0).sum()),
                               turns_ms=turns))
    kept.clear()
    for kind, s in sums.items():
        if s["launches"]:
            print(f"{kind}: {s['launches']} launches of the frame, K1 {s['k1_ms']:.3f} ms "
                  f"(device, graph replays)", flush=True)
    out = dict(card=card, scene=label, traversal=sums, launches=per_launch)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(out, indent=1))
    return 0


def _clone(x):
    """A copy of x's tensors, in tuples and named tuples as x holds them."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        items = [_clone(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _same_bits(a, b):
    """a and b (tensors, or tuples of them) hold the same bits."""
    if isinstance(a, tuple):
        return all(_same_bits(x, y) for x, y in zip(a, b) if x is not None)
    if not torch.is_tensor(a):
        return a == b
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _same_shading(a, b):
    """Two shade_cuda answers the same bits: the next state, the shadow
    rays and the pending term on every lane, the coated lanes' layer,
    directions and draws on the coated lanes, their light sample on those
    with NEE (the kernels write nothing else there)."""
    (st_a, sh_a, pd_a, c_a), (st_b, sh_b, pd_b, c_b) = a, b
    if not _same_bits((st_a, sh_a, pd_a), (st_b, sh_b, pd_b)):
        return False
    if c_b is None:
        return True
    m, nee = c_b.mask, c_b.nee
    lay = lambda c: (c.lay.top, c.lay.bottom, c.lay.thickness, c.lay.g, c.lay.albedo, c.wo,
                     c.uc, c.u2)
    light = lambda c: (c.wi, c.light_L, c.light_pdf, c.light_ok, c.light_delta)

    def on(x, mask):
        return tuple(on(v, mask) for v in x) if isinstance(x, tuple) else (
            x[mask] if torch.is_tensor(x) else x)
    return (_same_bits((c_a.mask, c_a.nee), (m, nee))
            and _same_bits(on(lay(c_a), m), on(lay(c_b), m))
            and (c_b.wi is None or _same_bits(on(light(c_a), nee), on(light(c_b), nee))))


def _layered_turns(render, max_depth, waves, card, label, out_path):
    """K7's and the shading kernels' launches of one wave replayed, each in
    turns with its yardstick (see the module docstring)."""
    from pbrt_tpu_torch.integrators import path as pth
    from pbrt_tpu_torch.materials import layered

    names = ("layered_f", "layered_sample", "layered_pdf")
    origs = {n: getattr(layered, f"{n}_cuda") for n in names}
    orig_shade = pth.shade_cuda
    kept = []

    class _WaveDone(Exception):
        pass

    def keeper(name):
        def call(*args, **kw):
            if len(kept) == 5 * max_depth:     # the second wave's first launch
                raise _WaveDone
            kept.append((name, _clone(args)))
            return (orig_shade if name == "path_shade" else origs[name])(*args, **kw)
        return call

    for n in names:
        setattr(layered, f"{n}_cuda", keeper(n))
    pth.shade_cuda = keeper("path_shade")
    try:
        render()
    except _WaveDone:
        pass
    finally:
        for n, fn in origs.items():
            setattr(layered, f"{n}_cuda", fn)
        pth.shade_cuda = orig_shade
    torch.cuda.synchronize()
    if not any(name != "path_shade" for name, _ in kept):
        raise SystemExit("--layered: the frame launched no K7 (a coated scene is needed)")
    fns = {n: (origs[n], getattr(layered, f"{n}_lane_cuda")) for n in names}
    fns["path_shade"] = (orig_shade, pth.shade_lane_cuda)
    sums = {n: dict(launches=0, kernel_ms=0.0, yardstick_ms=0.0, bits_differ=0) for n in fns}
    per_launch = []
    for name, args in kept:
        new_fn, yard = fns[name]
        turns = [_graph_ms(lambda f=f: f(*args)) for f in (yard, new_fn, new_fn, yard)]
        k_ms, y_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        s = sums[name]
        same = _same_shading if name == "path_shade" else _same_bits
        s["bits_differ"] += int(not same(new_fn(*args), yard(*args)))
        s["launches"] += 1
        s["kernel_ms"] += k_ms
        s["yardstick_ms"] += y_ms
        lanes = args[2].o.shape[0] if name == "path_shade" else args[1].shape[0]
        per_launch.append(dict(name=name, lanes=lanes, turns_ms=turns))
    kept.clear()
    for name, s in sums.items():
        s["kernel_ms_frame"] = s["kernel_ms"] * waves
        s["yardstick_ms_frame"] = s["yardstick_ms"] * waves
        print(f"{name}: {s['launches']} launches of the first wave, kernel {s['kernel_ms']:.3f} "
              f"ms (x{waves} waves {s['kernel_ms_frame']:.3f} ms; device, graph replays), "
              f"yardstick {s['yardstick_ms']:.3f} ms in turns (x{waves} waves "
              f"{s['yardstick_ms_frame']:.3f} ms), speed-up "
              f"{s['yardstick_ms'] / s['kernel_ms']:.3f}x; bits differ on {s['bits_differ']} "
              f"launches", flush=True)
    out = dict(card=card, scene=label, waves=waves, layered=sums, launches=per_launch)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(out, indent=1))
    return 0


def _scene(name):
    from pbrt_tpu_torch.scene import testscenes as ts

    if name == "cornell-mesh":
        return ts.cornell_mesh(res=RES, spp=SPP, levels=LEVELS), f"cornell-mesh levels {LEVELS}"
    if name == "cornell":
        return ts.cornell(res=RES, spp=SPP), "cornell (12 tris, 2 spheres, dense)"
    if name == "cornell-mesh-mltpath":
        return (ts.cornell_mesh(res=RES, levels=LEVELS, integrator="mltpath"),
                f"cornell-mesh levels {LEVELS} mltpath (256^2, max depth 5, 100 mutations/px)")
    if name == "caustic-glass-mlt":
        from pbrt_tpu_torch.scene.compile import load_scene

        path = Path(__file__).resolve().parent.parent / "scenes" / "caustic-glass.pbrt"
        return (load_scene(str(path), integrator="mlt"),
                "caustic-glass mlt (caustic-glass.pbrt, MLT over BDPT, 100 mutations/px)")
    if name == "cornell-bdpt":
        return (ts.cornell(res=128, spp=8, integrator="bdpt"),
                "cornell-bdpt (128^2 x 8, max depth 5, dense)")
    if name.startswith("cornell-instanced"):
        from pbrt_tpu_torch.scene.compile import compile_scene

        mode = "flatten" if name.endswith("flat") else "auto"
        return (compile_scene(ts.instanced_cornell_builder(res=RES, spp=SPP, instancing=mode)),
                f"cornell-instanced (levels (6, 5), instancing {mode!r}, 1,310,732 world tris)")
    if name.startswith("volumetric-caustic"):
        from pbrt_tpu_torch.scene.compile import load_scene

        path = str(Path(__file__).resolve().parent.parent / "scenes" / "volumetric-caustic.pbrt")
        if name.endswith("bdpt"):
            return (load_scene(path, spp=8, integrator="bdpt"),
                    "volumetric-caustic bdpt (128^2 x 8, max depth 7, fog)")
        if name.endswith("path"):
            return (load_scene(path, integrator="path"),
                    "volumetric-caustic path (128^2 x 16, max depth 7, fog)")
        return (load_scene(path), "volumetric-caustic mlt (its file: MLT over BDPT, 100 "
                                  "mutations/px, fog)")
    if name == "textured-cornell-mesh":
        from pbrt_tpu_torch.scene.compile import compile_scene

        return (compile_scene(ts.textured_cornell_mesh_builder(levels=LEVELS, res=RES, spp=SPP)),
                f"textured cornell-mesh levels {LEVELS} (checkerboard, imagemap, mix, K13)")
    if name in SCENE_FILES:
        from pbrt_tpu_torch.scene.compile import load_scene

        path = Path(__file__).resolve().parent.parent / "scenes" / SCENE_FILES[name]
        return load_scene(str(path)), f"{name} ({SCENE_FILES[name]}, its own settings)"
    return ts.terrain(res=RES, spp=SPP), "terrain (130,050 tris, PLY, sky + sun)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("cornell-mesh", "cornell", "terrain", "staircase",
                                        "testball", "cornell-bdpt", "caustic-glass",
                                        "caustic-glass-mlt", "cornell-mesh-mltpath",
                                        "cornell-instanced", "cornell-instanced-flat",
                                        "volumetric-caustic", "volumetric-caustic-bdpt",
                                        "volumetric-caustic-path", "textured-cornell-mesh"),
                    default="cornell-mesh")
    ap.add_argument("--shard-scene", type=int, default=0, metavar="N",
                    help="split the triangles into N parts (path family)")
    ap.add_argument("--traversal", action="store_true",
                    help="time every K1/K1a launch of a frame instead of the profiled "
                         "render")
    ap.add_argument("--layered", action="store_true",
                    help="time the K7 and shading launches of a coated frame's first wave "
                         "against their yardsticks instead of the profiled render")
    ap.add_argument("--out", default="build/pbrt_tpu_torch/profile_render.json")
    args = ap.parse_args(argv)

    from pbrt_tpu_torch.film import film as filmlib
    from pbrt_tpu_torch.integrators import path as pth, render as rd
    from pbrt_tpu_torch.scene.builder import MLT_INTEGRATORS, PATH_INTEGRATORS

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    (scene, meta), label = _scene(args.scene)
    if args.shard_scene and meta.integrator not in PATH_INTEGRATORS:
        ap.error(f"--shard-scene takes a path-family scene, not {args.scene}")
    if meta.integrator in MLT_INTEGRATORS:
        return _profile_mlt(scene, meta, label, card, args.out)
    route = pth.step_route("cuda", meta) if meta.integrator in PATH_INTEGRATORS else None
    if route:
        print(f"path step route: {route}", flush=True)
    default = f"wavefront {rd.POOL_LANES}" if meta.open_scene else "batched"
    schedules = {"batched": None}                          # name -> wavefront pool
    if meta.open_scene:
        schedules = {f"wavefront {p}": p for p in POOLS} | schedules
    if meta.integrator == "bdpt":                          # render_bdpt's waves
        default, schedules = "bdpt", {"bdpt": None}
    if args.shard_scene:                                   # the batched loop, sharded
        t0 = time.perf_counter()
        scene = rd.shard_scene(scene, args.shard_scene)
        print(f"shard_scene: {args.shard_scene} parts of rows {tuple(scene.shard.rows.shape)}, "
              f"recv {tuple(scene.shard.recv.shape)} in {time.perf_counter() - t0:.2f} s "
              "(host build and upload)", flush=True)
        label += f", geometry in {args.shard_scene} parts"
        default = f"sharded {args.shard_scene}"
        schedules = {default: None}

    def render(sched):
        """One frame -> ray counts: the default schedule through render(),
        the others through their loop with render()'s film and develop."""
        if sched == default:
            return rd.render(scene, meta, return_stats=True)[1]
        film = filmlib.new_film(meta.resolution, "cuda")
        if schedules[sched] is None:
            st = rd.render_batched(scene, meta, film)
        else:
            st, dropped = rd.render_wavefront(scene, meta, film, pool=schedules[sched])
            if dropped:
                raise RuntimeError(f"{sched}: {dropped} work items dropped")
        filmlib.develop(film, meta.resolution, meta.film_out_matrix, meta.film_imaging_ratio)
        return {k: int(v) for k, v in st.items()}

    for sched in schedules:                                # build + warm up
        render(sched)
    torch.cuda.synchronize()
    runs = {sched: [] for sched in schedules}
    for _ in range(SCENE_REPS.get(args.scene, REPS)):
        for sched in schedules:
            t0 = time.perf_counter()
            st = render(sched)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rays = st["closest"] + st["shadow"]
            runs[sched].append(dict(wall_s=wall, rays=rays, mrays_per_s=rays / wall / 1e6))
            print(f"{sched}: render {wall:.4f} s, {rays} rays, "
                  f"{runs[sched][-1]['mrays_per_s']:.3f} M rays/s", flush=True)
    summary = {}
    for sched, rs in runs.items():
        q = np.quantile([r["mrays_per_s"] for r in rs], [0.25, 0.5, 0.75])
        summary[sched] = dict(mrays_per_s_quartiles=list(map(float, q)),
                              median_wall_s=float(np.median([r["wall_s"] for r in rs])),
                              rays=rs[0]["rays"])
        print(f"{sched}: median {q[1]:.3f} M rays/s (quartiles {q[0]:.3f} .. {q[2]:.3f}, "
              f"{len(rs)} renders); median frame {summary[sched]['median_wall_s']:.4f} s; "
              f"{rs[0]['rays']} rays", flush=True)
    median_wall = summary[default]["median_wall_s"]

    torch.cuda.reset_peak_memory_stats()
    render(default)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"peak device memory of one {default} frame: {peak_gib:.2f} GiB", flush=True)
    if args.traversal:
        return _traversal_turns(lambda: render(default), card, label, args.out)
    if args.layered:
        waves = sum(1 for _ in rd.wave_lanes(meta.resolution[0] * meta.resolution[1], meta.spp,
                                             "cpu"))
        return _layered_turns(lambda: render(default), meta.max_depth, waves, card, label,
                              args.out)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render(default)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    ev = prof.key_averages()
    rows = sorted(((e.key, _device_us(e), e.count) for e in ev if _device_us(e) > 0),
                  key=lambda r: -r[1])
    total_us = sum(r[1] for r in rows)
    kern_us, kern_n = _kernel_sums(rows)
    other_us = total_us - sum(kern_us.values())
    bounces = None
    if route:
        bounces = kern_n["recycle"] if default.startswith("wavefront") else meta.max_depth * sum(
            1 for _ in rd.wave_lanes(meta.resolution[0] * meta.resolution[1], meta.spp, "cpu"))
    out = dict(
        card=card, scene=label, res=meta.resolution[0], spp=meta.spp,
        max_depth=meta.max_depth, default_schedule=default,
        runs=runs, schedules=summary, mrays_per_s_quartiles=summary[default][
            "mrays_per_s_quartiles"], median_wall_s=median_wall,
        profiled_wall_s=prof_wall, device_busy_s=total_us / 1e6, peak_gib=peak_gib,
        device_busy_share=total_us / 1e6 / median_wall,
        kernels_s={k: v / 1e6 for k, v in kern_us.items()}, kernel_launches=kern_n,
        other_kernels_s=other_us / 1e6, kernel_launches_total=sum(r[2] for r in rows),
        top=[dict(name=k[:120], device_s=us / 1e6, count=c) for k, us, c in rows[:25]],
        path_step_route=route, bounces=bounces,
        kernel_launches_per_bounce=(sum(r[2] for r in rows) / bounces) if bounces else None,
    )
    print(f"profiled render ({default}) {prof_wall:.4f} s wall; device busy "
          f"{total_us / 1e6:.4f} s, {out['device_busy_share']:.1%} of the median frame; "
          + ", ".join(f"{k} kernels {v / 1e6:.5f} s x{kern_n[k]}" for k, v in kern_us.items())
          + f", other kernels {other_us / 1e6:.4f} s; {out['kernel_launches_total']} kernel "
          f"launches in all", flush=True)
    if bounces:
        print(f"path step route {route}: {bounces} bounces, "
              f"{out['kernel_launches_per_bounce']:.1f} device kernels a bounce", flush=True)
    for r in out["top"][:15]:
        print(f"  {r['device_s'] * 1e3:9.3f} ms  x{r['count']:<6d} {r['name']}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
