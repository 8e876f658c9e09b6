"""K6's path_shade: designs measured against the kernels the port runs and
not kept.

Builds tools/k6_designs.cu (nvcc with the port's flags; it includes
pbrt_tpu_torch/csrc/path_step.cu) beside the port's path-step library and
prints each kernel's ptxas report (registers, stack frame, spills). Then,
on the first and third shading launches of the staircase frame
(scenes/staircase.pbrt at its own settings) and of the cornell-mesh frame
(levels 5, 256^2 x 16 spp; each frame is stopped once both are held):
  - every design's outputs against the yardstick's (path_shade_lane,
    shading as first written): the same bits on every lane
    (tests/path_cases.py shade_bits);
  - the designs timed in turns (device time of CUDA-graph replays): the
    yardstick, the port's two kernels, the designs, then the same in
    reverse; each time is the mean of its two turns.
The designs (tools/k6_designs.cu): shading as one kernel capped at 96 and
80 registers (whole<5>, whole<6>: blocks of 128 an SM); the port's split at
other caps; the lanes listed by material kind, so that a warp carries one
kind; the split's two bodies fused into one kernel, a lane's light part
then its BSDF part. Beside them, not designs: path_shade alone, and alone
with the scene's lights hidden (no NEE), what the light sample costs. Prints a line each and writes them as JSON to --out. Needs a card;
from the repo root:
    python tools/k6_designs.py --out chiprun_out/k6_designs.json
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from pbrt_tpu_torch import kernels  # noqa: E402
from pbrt_tpu_torch.integrators import path as pth  # noqa: E402
from pbrt_tpu_torch.profile_render import _clone, _graph_ms  # noqa: E402

SOURCE = ROOT / "tools" / "k6_designs.cu"
# not a design: path_shade alone as the port launches it, and again with
# the scene's lights hidden (n_lights 0: no NEE draws, pick or sample), whose
# difference is what the NEE light sample costs; not the same outputs
DIAGNOSTICS = ("path_shade alone", "path_shade alone without NEE")
DESIGNS = {0: "whole, 96 registers (5 blocks)", 1: "whole, 80 registers (6 blocks)",
           2: "split, light 4 blocks + bsdf 6", 3: "split, light 5 blocks + bsdf 6",
           4: "split, light 6 blocks + bsdf 6", 5: "split, light 5 blocks + bsdf 8",
           6: "listed by material kind, light 5 blocks + bsdf 6",
           7: "fused, light then bsdf in one kernel (4 blocks)",
           8: "fused, light then bsdf in one kernel (6 blocks)"}


def build():
    """The design library, built while the port's path-step source builds
    -> (ctypes library, the design source's ptxas report)."""
    h = hashlib.sha1()
    for f in (SOURCE, kernels.SOURCES["path_step"],
              *sorted((kernels.PKG_DIR / "csrc").glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    path = kernels.BUILD_DIR / f"libk6_designs_{h.hexdigest()[:12]}.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    proc = None if path.exists() else subprocess.Popen(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kernels.build(["path_step"])
    report = ""
    if proc is not None:
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{report}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.pbrt_k6_design.argtypes = [ctypes.POINTER(pth._StepArgs), ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.pbrt_k6_design.restype = ctypes.c_int
    lib.pbrt_k6_buckets.restype = ctypes.c_int
    return lib, report


def ptxas_lines(report):
    """{kernel: "registers, stack frame, spills"} of a ptxas report."""
    lines, out = report.splitlines(), {}
    for k, line in enumerate(lines):
        if "Compiling entry function" in line:
            rest = lines[k + 1:k + 6]
            frame = next((x.strip() for x in rest if "stack frame" in x), "")
            regs = next((x.split(":", 1)[1].strip() for x in rest if "registers" in x), "")
            out[line.split("'")[1]] = f"{regs}; {frame}"
    return out


def shade_alone(no_nee):
    """path_shade alone (shade_cuda's record), with n_lights 0 if no_nee."""
    def launch(self, name, _orig=pth._Args.launch):
        if no_nee:
            self.c.n_lights = 0
        _orig(self, name)

    def run(*args):
        orig = pth._Args.launch
        pth._Args.launch = launch
        try:
            return pth.shade_cuda(*args, kernels=("path_shade",))
        finally:
            pth._Args.launch = orig
    return run


def design_fn(lib, design):
    """shade(scene, meta, state, hit, skind, spp) through design `design`:
    shade_cuda's argument record and outputs, the design's launches."""
    buckets = lib.pbrt_k6_buckets()

    def launch(self, name):
        self.c.scratch = pth._scratch(self.dev).data_ptr()
        scratch = torch.zeros(3 * buckets + (buckets * self.R if design == 6 else 0),
                              dtype=torch.int32, device=self.dev)
        self.keep.append(scratch)
        err = lib.pbrt_k6_design(ctypes.byref(self.c), design, scratch.data_ptr(),
                                 torch.cuda.current_stream(self.dev).cuda_stream)
        kernels.check(err, f"k6 design {design}")

    def run(*args):
        orig = pth._Args.launch
        pth._Args.launch = launch
        try:
            return pth.shade_cuda(*args, kernels=("path_shade",))
        finally:
            pth._Args.launch = orig
    return run


class _Held(Exception):
    pass


def shading_launches(scene, meta):
    """The arguments of the frame's first and third shade_cuda calls."""
    from pbrt_tpu_torch.integrators import render as rd

    held, orig = [], pth.shade_cuda

    def keep(*args, **kw):
        held.append(_clone(args))
        if len(held) == 3:
            raise _Held
        return orig(*args, **kw)

    pth.shade_cuda = keep
    try:
        rd.render(scene, meta)
    except _Held:
        pass
    finally:
        pth.shade_cuda = orig
    return {"first": held[0], "third": held[2]}


def main(argv=None):
    import path_cases as pc
    from pbrt_tpu_torch.scene import testscenes as ts
    from pbrt_tpu_torch.scene.compile import load_scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/k6_designs.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k6_designs: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    lib, report = build()
    props = ptxas_lines(report)
    for name, p in props.items():
        print(f"ptxas {name}: {p}", flush=True)
    dev = torch.device("cuda")
    frames = {"staircase": load_scene(str(ROOT / "scenes" / "staircase.pbrt"), device=dev),
              "cornell_mesh": ts.cornell_mesh(res=256, spp=16, levels=5, device=dev)}
    fns = {"yardstick": pth.shade_lane_cuda, "kernel": pth.shade_cuda,
           **{DESIGNS[d]: design_fn(lib, d) for d in DESIGNS},
           **{name: shade_alone(k == 1) for k, name in enumerate(DIAGNOSTICS)}}
    out = dict(card=card, ptxas=props, launches={})
    failed = []
    for tag, (scene, meta) in frames.items():
        for which, a in shading_launches(scene, meta).items():
            label = f"{tag} {which}"
            ref = fns["yardstick"](*a)
            bits = {}
            for d, fn in fns.items():
                if d in DIAGNOSTICS:
                    continue
                b = pc.shade_bits(fn(*a), ref)
                bits[d] = all(v == 1.0 for v in b.values())
                if not bits[d]:
                    failed.append((label, d, {k: v for k, v in b.items() if v != 1.0}))
            order = list(fns)
            turns = {d: [] for d in order}
            for d in order + order[::-1]:
                turns[d].append(_graph_ms(lambda fn=fns[d]: fn(*a)))
            ms = {d: sum(v) / len(v) for d, v in turns.items()}
            out["launches"][label] = dict(lanes=a[2].o.shape[0], bits_equal=bits, turns=turns,
                                          ms=ms)
            print(f"{label} ({a[2].o.shape[0]} lanes): " + "; ".join(
                f"{d} {ms[d]:.4f} ms ({ms['yardstick'] / ms[d]:.3f}x the yardstick, turns "
                f"{turns[d][0]:.4f} / {turns[d][1]:.4f}"
                f"{'' if d in DIAGNOSTICS else ', bits equal' if bits[d] else ', BITS DIFFER'})"
                for d in order), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    if failed:
        raise SystemExit(f"k6_designs: bits differ from the yardstick: {failed}")
    print("k6_designs: every design has the yardstick's bits", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
