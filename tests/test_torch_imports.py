"""The port stands alone: no file of pbrt_tpu_torch/, not chip_smoke.py and
not the test helpers it imports (tests/quadric_edges.py,
tests/layered_cases.py, tests/bdpt_cases.py, tests/mlt_cases.py,
tests/instancing_cases.py, tests/path_cases.py, tests/medium_cases.py) and not
tests/parallel_cases.py, whose spawned ranks must not load JAX, imports jax
or anything of the JAX package pbrt_tpu (AST scan), none imports triton
(every kernel is CUDA C++), and the port ships its own copies of the data
tables."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "pbrt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                          ROOT / "tests" / "quadric_edges.py",
                                                          ROOT / "tests" / "layered_cases.py",
                                                          ROOT / "tests" / "bdpt_cases.py",
                                                          ROOT / "tests" / "mlt_cases.py",
                                                          ROOT / "tests" / "instancing_cases.py",
                                                          ROOT / "tests" / "path_cases.py",
                                                          ROOT / "tests" / "medium_cases.py",
                                                          ROOT / "tests" / "parallel_cases.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pbrt_tpu") or top.startswith("jax")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_pbrt_tpu_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, (str(path), bad)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_triton_imports(path):
    """Every kernel of the port is CUDA C++ built by kernels.py: no module
    imports triton, at its top or inside a function."""
    bad = [m for m in _imports(path) if m.split(".")[0] == "triton"]
    assert not bad, (str(path), bad)


def test_scan_sees_the_whole_port():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for must in ("pbrt_tpu_torch/accel/bvh.py", "pbrt_tpu_torch/film/film_kernel.py",
                 "pbrt_tpu_torch/integrators/render.py", "pbrt_tpu_torch/integrators/bdpt.py",
                 "pbrt_tpu_torch/integrators/mlt.py",
                 "pbrt_tpu_torch/distribution/distributions.py",
                 "pbrt_tpu_torch/parallel/scene_shard.py", "pbrt_tpu_torch/parallel/dist.py",
                 "tests/parallel_cases.py", "tests/instancing_cases.py", "tests/path_cases.py",
                 "chip_smoke.py"):
        assert must in names
    assert _forbidden("jax.numpy") and _forbidden("pbrt_tpu.scene")
    assert not _forbidden("pbrt_tpu_torch.scene")


@pytest.mark.parametrize("name", ["cie.npz", "metal.npz", "glass.npz", "rgb2spec_srgb.npz"])
def test_data_tables_are_byte_identical_copies(name):
    assert (ROOT / "pbrt_tpu_torch" / "data" / name).read_bytes() == \
        (ROOT / "pbrt_tpu" / "data" / name).read_bytes()
