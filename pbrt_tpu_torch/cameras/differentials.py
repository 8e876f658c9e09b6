"""Approximate camera differentials without ray differentials (counterpart
of pbrt_tpu/cameras/differentials.py; reference CameraBase::
approximate_dp_dxy, cameras/camera_base.h:110-139, and the texture-mapping
footprint chain, texture_mapping_2d.cu, texture_eval_context.h:10-44).

The neighbouring pixels' rays (one-pixel origin and direction deltas, taken
once per scene) are intersected with the tangent plane of the hit: the
first-order motion of the hit point per pixel step, then the uv footprint
by a least-squares solve against the surface's dpdu and dpdv. Image texture
lookups average four taps over that footprint when a render asks for
footprints (off by default, as in the JAX package); the reference's MIPMap
ignores the footprint (textures/mipmap.cu:22-25).
"""
import torch

from pbrt_tpu_torch.cameras import perspective
from pbrt_tpu_torch.geometry import vecmath as vm


def pixel_ray_deltas(scene, res_x):
    """(do_dx, dd_dx, do_dy, dd_dy), each (3,): the change of the camera
    ray's origin and direction per +1 pixel step in x and y at the image
    centre (the analogue of the reference's minPosDifferentialX /
    minDirDifferentialX, camera_base.h:96-97). `scene`: anything with the
    compiled camera's tensors."""
    c = res_x * 0.5
    dev = scene.camera_from_raster.device
    p = torch.tensor([[c, c], [c + 1.0, c], [c, c + 1.0]], dtype=torch.float32, device=dev)
    rays = perspective.generate_rays(scene, p, torch.zeros((3, 2), device=dev))
    return (rays.o[1] - rays.o[0], rays.d[1] - rays.d[0], rays.o[2] - rays.o[0],
            rays.d[2] - rays.d[0])


def approximate_dp_dxy(p, n, ray_o, ray_d, deltas, spp):
    """The hit point's first-order motion per pixel step (camera_base.h:
    110-139): p, n (R, 3) the hits and their normals, ray_o / ray_d (R, 3)
    the rays that found them, deltas from pixel_ray_deltas -> (dpdx, dpdy)
    (R, 3), scaled by max(0.125, 1 / sqrt(spp)) as the reference does."""
    do_dx, dd_dx, do_dy, dd_dy = deltas

    def shift(do, dd):
        o2 = ray_o + do
        d2 = ray_d + dd
        denom = vm.dot(d2, n)
        safe = torch.where(torch.abs(denom) < 1e-12,
                           torch.where(denom < 0, -1e-12, 1e-12), denom)
        t2 = vm.dot(p - o2, n) / safe
        return o2 + d2 * t2[..., None] - p

    spp_scale = torch.clamp(1.0 / torch.sqrt(torch.tensor(float(spp))), min=0.125).to(p.device)
    return shift(do_dx, dd_dx) * spp_scale, shift(do_dy, dd_dy) * spp_scale


def duv_dxy(dpdx, dpdy, dpdu, dpdv):
    """Screen-space uv derivatives: dpdx ~ dpdu dudx + dpdv dvdx solved in
    least squares per lane (texture_mapping_2d.cu:8-26) -> (dudx, dvdx, dudy,
    dvdy) (R,); zeros where |dpdu x dpdv| ~ 0."""
    uu = vm.dot(dpdu, dpdu)
    uv = vm.dot(dpdu, dpdv)
    vv = vm.dot(dpdv, dpdv)
    det = uu * vv - uv * uv
    ok = torch.abs(det) > 1e-18
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)

    def solve(dp):
        bu = vm.dot(dp, dpdu)
        bv = vm.dot(dp, dpdv)
        return (vv * bu - uv * bv) * inv_det, (uu * bv - uv * bu) * inv_det

    dudx, dvdx = solve(dpdx)
    dudy, dvdy = solve(dpdy)
    return dudx, dvdx, dudy, dvdy
