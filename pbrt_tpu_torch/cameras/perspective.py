"""Perspective camera ray generation in render space (counterpart of
pbrt_tpu/cameras/perspective.py `generate_rays`; reference
cameras/perspective.cu:66-86)."""
import torch

from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.geometry.ray import Rays
from pbrt_tpu_torch.sampling import warps


def xform_point(m, p):
    """Apply a (4,4) matrix to points (..., 3)."""
    r = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return r / w[..., None]


def generate_rays(scene, p_film, u_lens):
    """p_film: (R,2) raster positions; u_lens: (R,2) for defocus -> Rays."""
    R = p_film.shape[0]
    zeros = torch.zeros((R, 1), dtype=p_film.dtype, device=p_film.device)
    p_cam = xform_point(scene.camera_from_raster, torch.cat([p_film, zeros], dim=-1))
    d = vm.normalize(p_cam)
    o = torch.zeros_like(d)

    lens_r = scene.camera_lens_radius
    p_lens2 = lens_r * warps.sample_uniform_disk_concentric(u_lens)
    ft = scene.camera_focal_distance / torch.clamp(d[..., 2], min=1e-9)
    o_lens = torch.cat([p_lens2, zeros], dim=-1)
    d_lens = vm.normalize(d * ft[..., None] - o_lens)
    use_lens = lens_r > 0.0
    o = torch.where(use_lens, o_lens, o)
    d = torch.where(use_lens, d_lens, d)

    m = scene.render_from_camera
    return Rays(o=xform_point(m, o), d=vm.normalize(d @ m[:3, :3].T))
