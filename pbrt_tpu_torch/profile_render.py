"""Where the time of a full-width render goes, on the GPU.

    python -m pbrt_tpu_torch.profile_render [--out build/pbrt_tpu_torch/profile_render.json]

Renders cornell-mesh levels 5 at 256^2, 16 spp (the full-width frame of
chip_smoke.py) through the normal `render()` entry: one warm-up render,
REPS timed renders (host clock around a synchronized render; the honest
rays/s of each, and their median and quartiles), then one render under
torch.profiler. Prints the card's name and power limit, the device busy
share (summed device time of all kernels in the profiled render over the
median wall time of the unprofiled renders: the profiler slows the host, not
the kernels), the device time of the two hand-written kernels and of the
eager PyTorch ops around them, and the top kernels by device time; writes
the same as JSON to --out.
"""
import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

LEVELS, RES, SPP, REPS = 5, 256, 16, 11


def _device_us(e):
    """Device microseconds of a key_averages() entry that is a GPU kernel
    (CPU-side op entries, which also carry their kernels' time, give 0)."""
    if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/pbrt_tpu_torch/profile_render.json")
    args = ap.parse_args(argv)

    from pbrt_tpu_torch.integrators.render import render
    from pbrt_tpu_torch.scene import testscenes as ts

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    scene, meta = ts.cornell_mesh(res=RES, spp=SPP, levels=LEVELS)
    render(scene, meta)                                   # build + warm up
    torch.cuda.synchronize()
    runs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        _, st = render(scene, meta, return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append(dict(wall_s=wall, rays=st["closest"] + st["shadow"],
                         mrays_per_s=(st["closest"] + st["shadow"]) / wall / 1e6))
        print(f"render {wall:.4f} s, {runs[-1]['rays']} rays, "
              f"{runs[-1]['mrays_per_s']:.3f} M rays/s", flush=True)

    q = np.quantile([r["mrays_per_s"] for r in runs], [0.25, 0.5, 0.75])
    median_wall = float(np.median([r["wall_s"] for r in runs]))
    print(f"median {q[1]:.3f} M rays/s (quartiles {q[0]:.3f} .. {q[2]:.3f}, "
          f"{len(runs)} renders); median frame {median_wall:.4f} s", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render(scene, meta)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    ev = prof.key_averages()
    rows = sorted(((e.key, _device_us(e), e.count) for e in ev if _device_us(e) > 0),
                  key=lambda r: -r[1])
    total_us = sum(r[1] for r in rows)
    bvh_us = sum(r[1] for r in rows if "traverse_kernel" in r[0])
    film_us = sum(r[1] for r in rows if "film_add_kernel" in r[0])
    out = dict(
        card=card, scene=f"cornell-mesh levels {LEVELS}", res=RES, spp=SPP,
        runs=runs, mrays_per_s_quartiles=list(map(float, q)), median_wall_s=median_wall,
        profiled_wall_s=prof_wall, device_busy_s=total_us / 1e6,
        device_busy_share=total_us / 1e6 / median_wall,
        bvh_kernel_s=bvh_us / 1e6, film_kernel_s=film_us / 1e6,
        other_kernels_s=(total_us - bvh_us - film_us) / 1e6,
        top=[dict(name=k[:120], device_s=us / 1e6, count=c) for k, us, c in rows[:25]],
    )
    print(f"profiled render {prof_wall:.4f} s wall; device busy {total_us / 1e6:.4f} s, "
          f"{out['device_busy_share']:.1%} of the median frame; bvh kernel "
          f"{bvh_us / 1e6:.4f} s, film kernel {film_us / 1e6:.5f} s, other kernels "
          f"{out['other_kernels_s']:.4f} s", flush=True)
    for r in out["top"][:15]:
        print(f"  {r['device_s'] * 1e3:9.3f} ms  x{r['count']:<6d} {r['name']}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
