"""Watertight ray–triangle test in plain torch (counterpart of
pbrt_tpu/geometry/intersect.py `_ray_shear`, `_watertight_core`,
`intersect_tri_lanes`, `intersect_tri_block`; reference
shapes/triangle.cu:213-323).

The BVH kernel (csrc/bvh_traverse.cu) inlines the same arithmetic per leaf
triangle; these functions are its plain version (the dense sweep in
accel/bvh.py) and the refit against the winning triangle after traversal.
"""
from typing import NamedTuple

import torch

from pbrt_tpu_torch.utils.math import clamp_mag, gamma


class TriHit(NamedTuple):
    t: torch.Tensor      # (R,) hit distance (INFINITY on a miss)
    prim: torch.Tensor   # (R,) int64 leaf-order triangle index (-1 on a miss)
    b: torch.Tensor      # (R, 3) barycentrics


def permute_by_kz(v, kz):
    """Cyclic permutation (v[kz+1], v[kz+2], v[kz]) of (..., 3) -> 3 tensors."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    is0 = kz == 0
    is1 = kz == 1
    px = torch.where(is0, y, torch.where(is1, z, x))
    py = torch.where(is0, z, torch.where(is1, x, y))
    pz = torch.where(is0, x, torch.where(is1, y, z))
    return px, py, pz


def ray_shear(d):
    """Per-ray permutation axis kz and shear constants (sx, sy, sz) so that
    |d_z| is the largest component after permuting (triangle.cu:220-247)."""
    kz = torch.argmax(torch.abs(d), dim=-1)
    dx, dy, dz = permute_by_kz(d, kz)
    dz_safe = clamp_mag(dz, 1e-12)
    return kz, -dx / dz_safe, -dy / dz_safe, 1.0 / dz_safe


def watertight_core(a, b, c, sx, sy, sz, t_max):
    """Watertight test on translated+permuted vertices, each a tuple of 3
    tensors; shear constants broadcast against them. -> (t, (b0, b1, b2), hit)."""
    ax = a[0] + sx * a[2]
    ay = a[1] + sy * a[2]
    bx = b[0] + sx * b[2]
    by = b[1] + sy * b[2]
    cx = c[0] + sx * c[2]
    cy = c[1] + sy * c[2]

    e0 = cx * by - cy * bx
    e1 = ax * cy - ay * cx
    e2 = bx * ay - by * ax

    hit = ~(((e0 < 0) | (e1 < 0) | (e2 < 0)) & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    hit &= det != 0.0

    az = sz * a[2]
    bz = sz * b[2]
    cz = sz * c[2]
    t_scaled = e0 * az + e1 * bz + e2 * cz
    hit &= torch.where(
        det < 0,
        (t_scaled < 0) & (t_scaled > t_max * det),
        (t_scaled > 0) & (t_scaled < t_max * det),
    )

    max_e = torch.maximum(torch.maximum(torch.abs(e0), torch.abs(e1)), torch.abs(e2))
    inv_det = 1.0 / clamp_mag(det, 1e-8 * max_e + 1e-30)
    t = t_scaled * inv_det

    # conservative t error bound (reference triangle.cu:299-320)
    max_z = torch.maximum(torch.maximum(torch.abs(az), torch.abs(bz)), torch.abs(cz))
    max_x = torch.maximum(torch.maximum(torch.abs(ax), torch.abs(bx)), torch.abs(cx))
    max_y = torch.maximum(torch.maximum(torch.abs(ay), torch.abs(by)), torch.abs(cy))
    delta_z = gamma(3) * max_z
    delta_x = gamma(5) * (max_x + max_z)
    delta_y = gamma(5) * (max_y + max_z)
    delta_e = 2 * (gamma(2) * max_x * max_y + delta_y * max_x + delta_x * max_y)
    delta_t = 3 * (
        gamma(3) * max_e * max_z + delta_e * max_z + delta_z * max_e
    ) * torch.abs(inv_det)
    hit &= t > delta_t
    return t, (e0 * inv_det, e1 * inv_det, e2 * inv_det), hit


def intersect_tri_lanes(o, d, t_max, p0, p1, p2):
    """Ray i against triangle i: o, d, p0, p1, p2 (R, 3); t_max (R,).
    -> (t (R,), bary (R, 3), hit (R,))."""
    kz, sx, sy, sz = ray_shear(d)

    def prep(pv):
        return permute_by_kz(pv - o, kz)

    t, bary, hit = watertight_core(prep(p0), prep(p1), prep(p2), sx, sy, sz, t_max)
    return t, torch.stack(bary, dim=-1), hit


def intersect_tri_block(o, shear, t_max, p0, p1, p2):
    """Every ray against every triangle of a block: o (R, 3), shear from
    `ray_shear`, t_max (R,), p0/p1/p2 (T, 3). -> (t (R, T), hit (R, T))."""
    kz, sx, sy, sz = shear

    def prep(pv):
        return permute_by_kz(pv[None, :, :] - o[:, None, :], kz[:, None])

    t, _, hit = watertight_core(
        prep(p0), prep(p1), prep(p2),
        sx[:, None], sy[:, None], sz[:, None], t_max[:, None],
    )
    return t, hit
