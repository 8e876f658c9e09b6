"""Rays and robust ray spawning (counterpart of pbrt_tpu/geometry/ray.py;
reference base/ray.h:30-59): a normal offset proportional to the hit
point's magnitude times the scene epsilon."""
from typing import NamedTuple

import torch

from pbrt_tpu_torch.geometry import vecmath as vm


class Rays(NamedTuple):
    o: torch.Tensor  # (..., 3)
    d: torch.Tensor  # (..., 3)


def offset_ray_origin(p, n, w, scale):
    """Offset p along ±n, on the side w leaves from."""
    mag = torch.amax(torch.abs(p), dim=-1, keepdim=True)
    eps = scale * torch.clamp(mag, min=1.0)
    n_off = torch.where(vm.dot(n, w)[..., None] < 0.0, -n, n)
    return p + n_off * eps
