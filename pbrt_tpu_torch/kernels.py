"""Build and load the hand-written CUDA kernels of the port.

Every CUDA source under csrc/ is compiled by nvcc into a shared library with
a plain C interface for Hopper (`-gencode arch=compute_90a,code=sm_90a`) and
loaded with ctypes; pointers and the stream are passed as integers. The
libraries go to build/pbrt_tpu_torch/ beside the package, named by a hash of
the source, the shared headers (csrc/*.cuh) and the flags, so an unchanged
source is built once per checkout.
`build()` starts one nvcc per source at the same time. Nothing is built when
a module is imported: the first launch on a CUDA tensor builds what it needs.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build" / "pbrt_tpu_torch"
SOURCES = {name: PKG_DIR / "csrc" / f"{name}.cu"
           for name in ("bvh_traverse", "dense_intersect", "wavefront", "layered",
                        "layered_lane", "bdpt", "bdpt_lane", "mlt", "scene_shard", "film",
                        "path_step", "transmit", "texture")}
# --fmad=false: no contraction into fused multiply-adds, so every float op
# rounds as the plain torch version's does (the watertight test needs it)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_LIBS = {}


def nvcc_path():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name):
    h = hashlib.sha1(SOURCES[name].read_bytes())
    for header in sorted((PKG_DIR / "csrc").glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build(names=None):
    """Compile the named sources (default: all), in parallel. Returns
    {name: (seconds, ptxas report)}; an up-to-date library costs 0 s."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    t0 = time.time()
    for name in names:
        lib = library_path(name)
        log = lib.with_suffix(".log")
        if lib.exists():
            out[name] = (0.0, log.read_text() if log.exists() else "")
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, log)
    for name, (p, tmp, lib, log) in procs.items():
        report, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n{report}")
        log.write_text(report)
        os.replace(tmp, lib)
        out[name] = (time.time() - t0, report)
    return out


def load(name):
    """ctypes handle of the built library `name` (built on first use)."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def check(err, what):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
