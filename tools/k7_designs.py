"""K7's layered_f and layered_pdf: designs measured against the kernels the
port runs and not kept, and the kernels as first written read by their warps.

Builds tools/k7_designs.cu (nvcc with the port's flags; it includes
pbrt_tpu_torch/csrc/layered.cu) beside the port's K7 libraries. Then, on the
first layered_f and layered_pdf launches of the staircase and testball
frames (scenes/*.pbrt at their own settings; the frame is stopped once both
are held) and on 2^18 all-coated lanes of tests/layered_cases.py (its
synthetic cases and its deep medium, max depth 10, seed 11 as in
chip_smoke.py):
  - the kernels as first written (the yardstick, csrc/layered_lane.cu), whose
    warp w holds lanes 32 w .. 32 w + 31, read from walk_steps_kernel's
    per-lane step counts: coated lanes a warp, the steps of a warp's
    longest walk, the share of its slots' steps used, the coated lanes by
    their steps;
  - every design's bits and step counts against the yardstick's;
  - each entry's designs timed in turns (device time of CUDA-graph
    replays): the yardstick, the port's kernel, the designs, then the same
    in reverse; each time is the mean of its two turns.
Prints a line each and writes them as JSON to --out. Needs a card; from the
repo root:
    python tools/k7_designs.py --out chiprun_out/k7_designs.json
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
from pbrt_tpu_torch.materials import bxdfs, layered  # noqa: E402
from pbrt_tpu_torch.profile_render import _clone, _graph_ms  # noqa: E402

SOURCE = ROOT / "tools" / "k7_designs.cu"
REFILLS = (8, 16, 32)
CALLS = 20          # calls a timed graph replays
FRAMES = {"staircase": "staircase.pbrt", "testball": "material-testball.pbrt"}


def build():
    """The design library, built while the port's K7 sources build ->
    (ctypes library, the design source's ptxas report)."""
    h = hashlib.sha1()
    for f in (SOURCE, kernels.SOURCES["layered"], *sorted((kernels.PKG_DIR / "csrc").glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    path = kernels.BUILD_DIR / f"libk7_designs_{h.hexdigest()[:12]}.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    proc = None if path.exists() else subprocess.Popen(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kernels.build(["layered", "layered_lane"])
    report = ""
    if proc is not None:
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{report}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    args, v = ctypes.POINTER(layered._LayeredArgs), ctypes.c_void_p
    lib.pbrt_k7_ticket_f.argtypes = [args, v, v, v, ctypes.c_int, v, v]
    lib.pbrt_k7_ticket_pdf.argtypes = [args, v, v, v, v, v]
    lib.pbrt_k7_walk_steps.argtypes = [args, v, v, v, v, v]
    return lib, report


def launch(fn, p, wo, wi, mask, steps, out, *extra):
    a, keep = layered._args(p, wo.shape[0], wo.device, mask, steps)
    err = fn(ctypes.byref(a), wo.data_ptr(), wi.data_ptr(), out.data_ptr(), *extra,
             torch.cuda.current_stream().cuda_stream)
    kernels.check(err, fn.__name__)
    return out


def entries(lib):
    """{entry: {design: fn(p, wo, wi, mask, steps=None) -> output}}."""
    def ticket_f(refill):
        def run(p, wo, wi, mask, steps=None):
            f = torch.empty((wo.shape[0], 4), dtype=torch.float32, device=wo.device)
            ticket = torch.zeros(1, dtype=torch.int32, device=wo.device)
            return launch(lib.pbrt_k7_ticket_f, p, wo, wi, mask, steps, f, refill,
                          ticket.data_ptr())
        return run

    def ticket_pdf(p, wo, wi, mask, steps=None):
        pdf = torch.empty((wo.shape[0],), dtype=torch.float32, device=wo.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=wo.device)
        return launch(lib.pbrt_k7_ticket_pdf, p, wo, wi, mask, steps, pdf, ticket.data_ptr())

    return {"layered_f": {"yardstick": layered.layered_f_lane_cuda,
                          "kernel": layered.layered_f_cuda,
                          **{f"ticket, refill at {r}": ticket_f(r) for r in REFILLS}},
            "layered_pdf": {"yardstick": layered.layered_pdf_lane_cuda,
                            "kernel": layered.layered_pdf_cuda,
                            "ticket, coated lanes only": ticket_pdf}}


class _Held(Exception):
    pass


def first_launches(scene_file):
    """{entry: (p, wo, wi, mask)} of the frame's first layered_f and
    layered_pdf launches."""
    from pbrt_tpu_torch.integrators import render as rd
    from pbrt_tpu_torch.scene.compile import load_scene

    scene, meta = load_scene(str(ROOT / "scenes" / scene_file))
    held, origs = {}, {n: getattr(layered, f"{n}_cuda") for n in ("layered_f", "layered_pdf")}

    def keeper(name):
        def call(p, wo, wi, mask=None, steps=None):
            held.setdefault(name, _clone((p, wo, wi, mask)))
            if len(held) == len(origs):
                raise _Held
            return origs[name](p, wo, wi, mask, steps)
        return call

    for n in origs:
        setattr(layered, f"{n}_cuda", keeper(n))
    try:
        rd.render(scene, meta)
    except _Held:
        pass
    finally:
        for n, fn in origs.items():
            setattr(layered, f"{n}_cuda", fn)
    return held


def synthetic(make):
    from layered_cases import BXDF_FIELDS

    t = {k: torch.as_tensor(v, device="cuda") for k, v in make(1 << 18, 11).items()}

    def bx(tag):
        return bxdfs.BxdfParams(*(t[f"{tag}_{f}"] for f in BXDF_FIELDS))
    p = layered.LayeredParams(bx("top"), bx("bottom"), t["thickness"], t["g"], t["albedo"],
                              10, 1)
    return {n: (p, t["wo"], t["wi"], None) for n in ("layered_f", "layered_pdf")}


def steps_of(fn, p, wo, wi, mask):
    st = torch.zeros(1, dtype=torch.int64, device=wo.device)
    out = fn(p, wo, wi, mask, st)
    return out, int(st.item())


def yardstick_warps(lib, p, wo, wi, mask):
    """The first-written layered_f's warps, from each lane's steps."""
    R = wo.shape[0]
    f = torch.empty((R, 4), dtype=torch.float32, device=wo.device)
    lane_steps = torch.empty(R, dtype=torch.int32, device=wo.device)
    launch(lib.pbrt_k7_walk_steps, p, wo, wi, mask, None, f, lane_steps.data_ptr())
    f_y, steps_y = steps_of(layered.layered_f_lane_cuda, p, wo, wi, mask)
    m = torch.ones(R, dtype=torch.bool, device=wo.device) if mask is None else mask
    pad = (-R) % 32
    m_ = torch.cat([m, m.new_zeros(pad)]).view(-1, 32)
    s_ = torch.cat([lane_steps, lane_steps.new_zeros(pad)]).view(-1, 32)
    live = m_.sum(1)
    busy = live > 0
    longest = s_.max(1).values[busy].double()
    steps = int(lane_steps.sum())
    return dict(bits_equal=torch.equal(f.view(torch.int32), f_y.view(torch.int32))
                and steps == steps_y,
                lanes=R, coated=int(m.sum()), warps=int(m_.shape[0]), busy_warps=int(busy.sum()),
                coated_per_warp=float(live.double().mean()),
                coated_per_busy_warp=float(live[busy].double().mean()), steps=steps,
                steps_per_coated_lane=steps / max(int(m.sum()), 1),
                longest_walk_mean=float(longest.mean()), longest_walk_max=int(longest.max()),
                slot_steps_used=steps / max(32 * float(longest.sum()), 1.0),
                coated_lanes_by_steps=torch.bincount(lane_steps[m].long()).tolist())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/k7_designs.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k7_designs: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    lib, report = build()
    lines = report.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and any(
                n in line for n in ("ticket_f_kernel", "ticket_pdf_kernel", "walk_steps_kernel")):
            print("ptxas: " + " | ".join(x.strip() for x in lines[k:k + 4]), flush=True)
    from layered_cases import deep_medium_lanes, lanes

    launches = {f"{tag} 1st": first_launches(f) for tag, f in FRAMES.items()}
    launches["2^18 all coated (synthetic)"] = synthetic(lanes)
    launches["2^18 all coated (deep medium)"] = synthetic(deep_medium_lanes)
    table = entries(lib)
    out = dict(card=card, ptxas=report, launches={})
    failed = []
    for label, held in launches.items():
        rec = out["launches"][label] = {}
        p, wo, wi, mask = held["layered_f"]
        if "1st" in label:
            rec["yardstick_warps"] = w = yardstick_warps(lib, p, wo, wi, mask)
            print(f"{label}: the first-written layered_f's warps: "
                  + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                              for k, v in w.items()), flush=True)
            if not w["bits_equal"]:
                failed.append((label, "walk_steps"))
        for name, fns in table.items():
            p, wo, wi, mask = held[name]
            ref, ref_steps = steps_of(fns["yardstick"], p, wo, wi, mask)
            bits = {}
            for d, fn in fns.items():
                got, st = steps_of(fn, p, wo, wi, mask)
                bits[d] = torch.equal(got.view(torch.int32), ref.view(torch.int32)) \
                    and st == ref_steps
                if not bits[d]:
                    failed.append((label, name, d))
            order = list(fns)
            turns = {d: [] for d in order}
            for d in order + order[::-1]:
                turns[d].append(_graph_ms(lambda fn=fns[d]: fn(p, wo, wi, mask), CALLS))
            ms = {d: sum(v) / len(v) for d, v in turns.items()}
            rec[name] = dict(lanes=wo.shape[0], coated=wo.shape[0] if mask is None
                             else int(mask.sum()), steps=ref_steps, bits_equal=bits, turns=turns,
                             ms=ms)
            print(f"{label} {name} ({rec[name]['coated']} coated of {wo.shape[0]}, "
                  f"{ref_steps} steps): " + "; ".join(
                      f"{d} {ms[d]:.4f} ms ({ms['yardstick'] / ms[d]:.3f}x the yardstick, "
                      f"turns {turns[d][0]:.4f} / {turns[d][1]:.4f}"
                      f"{', bits equal' if bits.get(d, True) else ', BITS DIFFER'})"
                      for d in order), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    if failed:
        raise SystemExit(f"k7_designs: bits or steps differ from the yardstick: {failed}")
    print("k7_designs: every design has the yardstick's bits and step counts", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
