"""pbrt_tpu_torch — the PyTorch/CUDA port of pbrt_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same layout (scene/,
spectral/, geometry/, sampling/, filters/, cameras/, materials/, lights/,
accel/, integrators/, film/). It imports torch, never jax, and nothing of
pbrt_tpu. Plain tensor code is PyTorch; the hot paths are hand-written
kernels (CUDA under csrc/, built at first use by kernels.py; the Triton
splat kernel in film/film_kernel.py) with a plain PyTorch version beside
each, which is what runs on CPU tensors.

Entry points: scene.compile.load_scene(path, device=None),
integrators.render.render(scene, meta, device=None), render_to_png, and
`python -m pbrt_tpu_torch.cli`. device=None means "cuda"; without a card
they raise rather than fall back to the CPU.
"""
from pbrt_tpu_torch.scene.compile import load_scene  # noqa: F401
from pbrt_tpu_torch.integrators.render import render, render_to_png  # noqa: F401

__version__ = "0.1.0"
