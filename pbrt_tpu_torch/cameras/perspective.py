"""Perspective camera in render space (counterpart of
pbrt_tpu/cameras/perspective.py; reference cameras/perspective.cu): ray
generation (:66-86) and, for BDPT's light-tracing strategies, the camera's
importance `we`, its density `pdf_we` and lens sampling `sample_wi`
(:89-176). The inverse matrices come from `Scene.camera_inverse`, taken once
per scene."""
import torch

from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.geometry.ray import Rays
from pbrt_tpu_torch.sampling import warps
from pbrt_tpu_torch.utils.math import PI


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


# --------------------------------------------------- light-tracing support


def xform_point3(m, p):
    """xform_point with each row spelled ((m0 x + m1 y) + m2 z) + m3, the
    order of csrc/bdpt.cu."""
    def row(i):
        return ((m[i, 0] * p[..., 0] + m[i, 1] * p[..., 1]) + m[i, 2] * p[..., 2]) + m[i, 3]
    return torch.stack([row(0), row(1), row(2)], dim=-1) / row(3)[..., None]


def camera_z(scene):
    """The camera's viewing axis in render space."""
    return vm.normalize(scene.render_from_camera[:3, 2])


def lens_area(scene):
    r = scene.camera_lens_radius
    return torch.where(r > 0, PI * r ** 2, 1.0)


def we(scene, o_r, d_r):
    """Importance of the ray (o_r, d_r) leaving the lens -> (we (R,),
    raster position (R,2), valid (R,))."""
    z = camera_z(scene)
    cos_t = vm.dot(d_r, z)
    fwd = cos_t > scene.camera_cos_total
    cos_safe = torch.clamp(cos_t, min=1e-6)
    focus_t = torch.where(scene.camera_lens_radius > 0, scene.camera_focal_distance, 1.0)
    p_focus = o_r + d_r * (focus_t / cos_safe)[..., None]
    cam_from_render, raster_from_cam = scene.camera_inverse
    p_raster = xform_point3(raster_from_cam, xform_point3(cam_from_render, p_focus))
    res = scene.camera_res.to(torch.float32)
    inb = ((p_raster[..., 0] >= 0.0) & (p_raster[..., 0] < res[0])
           & (p_raster[..., 1] >= 0.0) & (p_raster[..., 1] < res[1]))
    val = 1.0 / (scene.camera_A * lens_area(scene) * cos_safe ** 4)
    valid = fwd & inb
    return torch.where(valid, val, 0.0), p_raster[..., :2], valid


def pdf_we(scene, o_r, d_r):
    """-> (pdf_pos (R,), pdf_dir (R,)) of the camera emitting (o_r, d_r)."""
    _, _, valid = we(scene, o_r, d_r)
    cos_t = torch.clamp(vm.dot(d_r, camera_z(scene)), min=1e-6)
    area = lens_area(scene)
    pdf_pos = torch.where(valid, 1.0 / area, 0.0)
    pdf_dir = torch.where(valid, 1.0 / (scene.camera_A * cos_t ** 3), 0.0)
    return pdf_pos, pdf_dir


def sample_wi(scene, p_ref, u2):
    """A lens point seen from p_ref (BDPT's t = 1 strategies) -> (wi (R,3),
    we (R,), pdf (R,), raster (R,2), p_lens (R,3), valid (R,))."""
    lens_r = scene.camera_lens_radius
    p_lens2 = lens_r * warps.sample_uniform_disk_concentric(u2)
    zeros = torch.zeros_like(p_lens2[..., :1])
    p_lens = xform_point3(scene.render_from_camera, torch.cat([p_lens2, zeros], dim=-1))
    to_lens = p_lens - p_ref
    dist2 = vm.length_squared(to_lens)
    wi = to_lens / torch.sqrt(torch.clamp(dist2, min=1e-24))[..., None]
    pdf = dist2 / torch.clamp(vm.absdot(camera_z(scene), wi) * lens_area(scene), min=1e-12)
    wv, p_raster, valid = we(scene, p_lens, -wi)
    return wi, wv, pdf, p_raster, p_lens, valid & (dist2 > 0)
