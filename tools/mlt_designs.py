"""K12m-a (mlt_mutate) and K12m-b (mlt_accept_splat): designs measured
against the kernels the port runs and not kept.

Builds tools/mlt_designs.cu (nvcc with the port's flags; it includes
pbrt_tpu_torch/csrc/mlt.cu) beside the port's MLT library, and, with --old,
an earlier csrc/mlt.cu (for example the one-thread-a-chain kernels as first
written, `git show 943a96c:pbrt_tpu_torch/csrc/mlt.cu > build/mlt_old/mlt.cu`
in a checkout; that file is not kept in the repo), and prints each kernel's
ptxas report (registers, stack frame, spills). Then, on the arguments of the
first pass of the caustic-glass-mlt frame (scenes/caustic-glass.pbrt with
"mlt": 8192 chains, D = 160, C = 8) and of the cornell-mesh-mltpath frame
(levels 5, 256^2, max depth 5: D = 66, C = 1), each render stopped once
both kernels have been called:
  - every design against the plain version (tests/mlt_cases.py
    compare_mutate and compare_accept: the draws bit-exact, the state and
    acceptance exact);
  - the designs timed in turns (device time of CUDA-graph replays, 20 calls
    a graph, K12m-b on a fresh copy of the state each turn): the port's
    kernel, the designs, the old kernel, then the same in reverse; each
    time is the mean of its two turns;
  - with --old, the cornell-mesh-mltpath frame cut to 1 mutation per pixel
    (8 passes) rendered with the port's kernels and with the old ones
    behind the same wrappers, in five rounds of (old, port, port, old): each
    frame's median pass-to-pass time (host clock, synchronized).
The designs: K12m-a with 32, 16 and 8 lanes a chain, at 32 and 16 also as
one loop with the kind of step (large or small) a branch in it, and one
thread a (chain, dimension); K12m-b with 32, 16 and 8 lanes a chain. Beside K12m-a,
not designs: an empty launch and PyTorch's copy of x. Prints a line each
and writes them as JSON to --out. Needs a card; from the repo root:
    python tools/mlt_designs.py --old build/mlt_old/mlt.cu --out chiprun_out/mlt_designs.json
"""
import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from pbrt_tpu_torch import kernels  # noqa: E402
from pbrt_tpu_torch.integrators import mlt  # noqa: E402
from pbrt_tpu_torch.profile_render import _clone  # noqa: E402

SOURCE = ROOT / "tools" / "mlt_designs.cu"
MUTATE_DESIGNS = {0: "32 lanes a chain", 1: "16 lanes a chain", 3: "8 lanes a chain",
                  2: "a thread a (chain, dim)", 4: "32 lanes, one loop, a branch a step",
                  5: "16 lanes, one loop, a branch a step"}
ACCEPT_DESIGNS = {0: "32 lanes a chain", 1: "16 lanes a chain", 2: "8 lanes a chain"}
# not designs, timed in K12m-a's turns: an empty block, the least a launch
# in a graph costs; PyTorch's copy of x, K12m-a's bytes without its work
DIAGNOSTICS = ("an empty launch", "torch copy of x")
OLD = "old: a thread a chain"
P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint


def _nvcc(source, tag):
    """Start nvcc on source (the port's flags, csrc/ on the include path)
    -> (library path, process or None if built)."""
    h = hashlib.sha1(source.read_bytes())
    for f in (kernels.SOURCES["mlt"], *sorted((kernels.PKG_DIR / "csrc").glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    path = kernels.BUILD_DIR / f"lib{tag}_{h.hexdigest()[:12]}.so"
    if path.exists():
        return path, None
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    return path, (tmp, subprocess.Popen(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.PKG_DIR / "csrc"), "-o",
         str(tmp), str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))


def build(old):
    """The design library and, if old is a path, the old kernels' library,
    built while the port's MLT source builds -> ({tag: ctypes library},
    {tag: ptxas report})."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {"mlt_designs": _nvcc(SOURCE, "mlt_designs")}
    if old:
        jobs["mlt_old"] = _nvcc(Path(old).resolve(), "mlt_old")
    reports = {"port": kernels.build(["mlt"])["mlt"][1]}
    libs = {}
    for tag, (path, job) in jobs.items():
        reports[tag] = ""
        if job is not None:
            tmp, proc = job
            reports[tag], _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {tag}:\n{reports[tag]}")
            os.replace(tmp, path)
        libs[tag] = ctypes.CDLL(str(path))
    d = libs["mlt_designs"]
    d.pbrt_mlt_design_mutate.argtypes = [I, P, P, P, I, I, U, U, P]
    d.pbrt_mlt_design_accept.argtypes = [I] + [P] * 11 + [I] * 4 + [U, U, P]
    d.pbrt_mlt_design_empty.argtypes = [P]
    if "mlt_old" in libs:
        libs["mlt_old"].pbrt_mlt_mutate.argtypes = [P, P, P, I, I, U, U, P]
        libs["mlt_old"].pbrt_mlt_accept_splat.argtypes = [P] * 11 + [I] * 4 + [U, U, P]
    return libs, reports


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


def graph_ms(fn, calls=20, reps=5):
    """Device ms of one fn() call: `calls` calls in one CUDA graph, replayed
    `reps` times between CUDA events."""
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
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * calls)


class _Held(Exception):
    pass


def first_pass(scene, meta):
    """The arguments of the frame's first mutate_cuda and
    accept_and_splat_cuda calls (copies)."""
    held, orig = {}, (mlt.mutate_cuda, mlt.accept_and_splat_cuda)

    def mutate(*args):
        held.setdefault("mutate", _clone(args))
        return orig[0](*args)

    def accept(*args):
        held["accept"] = _clone(args)
        raise _Held

    mlt.mutate_cuda, mlt.accept_and_splat_cuda = mutate, accept
    try:
        mlt.render_mlt(scene, meta)
    except _Held:
        pass
    finally:
        mlt.mutate_cuda, mlt.accept_and_splat_cuda = orig
    return held


def mutate_fns(libs):
    """{label: fn(x, seed, pass, draws) -> x_prop}."""
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def lib_fn(call):
        def run(x, seed, pass_idx, draws=None):
            out = torch.empty_like(x)
            err = call(x.data_ptr(), out.data_ptr(), 0 if draws is None else draws.data_ptr(),
                       *x.shape, seed & 0xFFFFFFFF, pass_idx & 0xFFFFFFFF, stream())
            kernels.check(err, "mlt design")
            return out
        return run

    d = libs["mlt_designs"]
    fns = {"port": mlt.mutate_cuda}
    fns.update({f"design {k}: {v}": lib_fn(lambda *a, k=k: d.pbrt_mlt_design_mutate(k, *a))
                for k, v in MUTATE_DESIGNS.items()})
    if "mlt_old" in libs:
        fns[OLD] = lib_fn(libs["mlt_old"].pbrt_mlt_mutate)
    return fns


def accept_fns(libs):
    """{label: fn(splat, heat, cur, prop, seed, pass) -> a}."""
    def lib_fn(call):
        def run(splat, heat, cur, prop, seed, pass_idx):
            (R, D), C = cur.x.shape, cur.pix.shape[0]
            a = torch.empty((R,), device=cur.x.device)
            err = call(splat.data_ptr(), heat.data_ptr(), *(t.data_ptr() for t in cur),
                       *(t.data_ptr() for t in prop), a.data_ptr(), R, D, C, heat.shape[0],
                       seed & 0xFFFFFFFF, pass_idx & 0xFFFFFFFF,
                       torch.cuda.current_stream().cuda_stream)
            kernels.check(err, "mlt design")
            return a
        return run

    d = libs["mlt_designs"]
    fns = {"port": mlt.accept_and_splat_cuda}
    fns.update({f"design {k}: {v}": lib_fn(lambda *a, k=k: d.pbrt_mlt_design_accept(k, *a))
                for k, v in ACCEPT_DESIGNS.items()})
    if "mlt_old" in libs:
        fns[OLD] = lib_fn(libs["mlt_old"].pbrt_mlt_accept_splat)
    return fns


def frame_turns(scene, meta, libs, rounds=5):
    """The frame cut to 1 mutation per pixel with the port's kernels and
    with the old ones behind the port's wrappers (mlt._lib pointed at the
    old library), in rounds of (old, port, port, old) -> {"port", "old":
    [each frame's median pass-to-pass seconds]}."""
    meta = dataclasses.replace(meta, mutations_per_pixel=1)
    got = {"port": [], "old": []}
    port_lib = mlt._lib
    for _ in range(rounds):
        for which in ("old", "port", "port", "old"):
            stamps = []

            def on_pass(i, a, stamps=stamps):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
            if which == "old":
                mlt._lib = lambda: libs["mlt_old"]
            try:
                mlt.render_mlt(scene, meta, on_pass=on_pass)
            finally:
                mlt._lib = port_lib
            got[which].append(statistics.median(b - a for a, b in zip(stamps, stamps[1:])))
    return got


def in_turns(timers):
    """{label: ms}: each timer run in order, then in reverse; the mean."""
    order = list(timers) + list(reversed(timers))
    got = {k: [] for k in timers}
    for k in order:
        got[k].append(timers[k]())
    return {k: sum(v) / len(v) for k, v in got.items()}


def main(argv=None):
    import mlt_cases
    from pbrt_tpu_torch.scene import builder as bd, testscenes as ts
    from pbrt_tpu_torch.scene.compile import compile_scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="an earlier csrc/mlt.cu to time beside the designs")
    ap.add_argument("--out", default="chiprun_out/mlt_designs.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mlt_designs: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    libs, reports = build(args.old)
    ptxas = {tag: ptxas_lines(r) for tag, r in reports.items()}
    for tag, props in ptxas.items():
        for name, p in props.items():
            print(f"ptxas {tag} {name}: {p}", flush=True)
    dev = torch.device("cuda")
    frames = {
        "caustic_glass_mlt": compile_scene(bd.SceneBuilder().parse_file(
            str(ROOT / "scenes" / "caustic-glass.pbrt")), device=dev, integrator_override="mlt"),
        "cornell_mesh_mltpath": ts.cornell_mesh(res=256, levels=5, device=dev,
                                                integrator="mltpath")}
    out = dict(card=card, ptxas=ptxas, frames={})
    failed = []
    for tag, (scene, meta) in frames.items():
        held = first_pass(scene, meta)
        x, seed, pass_idx = held["mutate"]
        R, D = x.shape
        row = out["frames"][tag] = {"chains": R, "D": D}
        fns = mutate_fns(libs)
        for label, fn in fns.items():
            draws = torch.empty((R, 1 + 2 * D), device=dev)
            try:
                mlt_cases.compare_mutate(x, fn(x, seed, pass_idx, draws), draws,
                                         mlt.mutate_from_uniforms, mlt.chain_uniforms, seed,
                                         pass_idx)
            except AssertionError as e:
                failed.append((tag, "mlt_mutate", label, str(e)))
        copy = torch.empty_like(x)
        empty = libs["mlt_designs"].pbrt_mlt_design_empty
        row["mlt_mutate_ms"] = in_turns({
            **{label: (lambda fn=fn: graph_ms(lambda: fn(x, seed, pass_idx)))
               for label, fn in fns.items()},
            DIAGNOSTICS[0]: lambda: graph_ms(
                lambda: empty(torch.cuda.current_stream().cuda_stream)),
            DIAGNOSTICS[1]: lambda: graph_ms(lambda: copy.copy_(x))})

        splat, heat, cur, prop, seed, pass_idx = held["accept"]
        row["C"] = cur.pix.shape[0]
        fns = accept_fns(libs)
        for label, fn in fns.items():
            try:
                mlt_cases.compare_accept(
                    lambda *a, fn=fn: fn(*a, seed, pass_idx),
                    lambda *a: mlt.accept_and_splat_from_uniforms(
                        *a, mlt.accept_uniforms(seed, pass_idx, R, dev)),
                    splat, heat, cur, prop)
            except AssertionError as e:
                failed.append((tag, "mlt_accept_splat", label, str(e)))

        def accept_timer(fn):
            def run():
                sp, ht, ck = splat.clone(), heat.clone(), _clone(cur)
                return graph_ms(lambda: fn(sp, ht, ck, prop, seed, pass_idx))
            return run
        row["mlt_accept_splat_ms"] = in_turns({label: accept_timer(fn)
                                               for label, fn in fns.items()})
        for kern in ("mlt_mutate", "mlt_accept_splat"):
            print(f"{tag} (R {R}, D {D}, C {row['C']}) {kern}, ms in turns: "
                  + "; ".join(f"{k} {v:.5f}" for k, v in row[f"{kern}_ms"].items()), flush=True)
    if args.old:
        got = out["cornell_mesh_mltpath_frame_pass_s"] = frame_turns(
            *frames["cornell_mesh_mltpath"], libs)
        ratios = [p / o for p, o in zip(got["port"], got["old"])]
        print("cornell-mesh-mltpath cut to 8 passes, median pass in rounds of (old, port, port, "
              f"old): port {statistics.median(got['port']):.5f} s, old "
              f"{statistics.median(got['old']):.5f} s; frames port {got['port']}, old "
              f"{got['old']}; port / old by frame {[round(r, 4) for r in ratios]}", flush=True)
    out["failed"] = failed
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    if failed:
        print("FAILED", failed, flush=True)
        return 1
    print("every design equal to the plain version", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
