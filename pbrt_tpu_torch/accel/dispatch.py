"""Scene-level closest-hit and any-hit queries on triangle scenes
(counterpart of pbrt_tpu/accel/dispatch.py `intersect`/`occluded`;
reference accelerator/hlbvh.h + base/interaction.h). The hit record is
assembled from the packed per-triangle `tri_rec` row exactly as the JAX
package does (dispatch.py:146-219, 286-301); its medium and uv-derivative
columns are read only by the media and texture slices and are not
assembled here. Spheres, disks, instancing and scene sharding are later
slices: the scene compiler refuses scenes that have them.
"""
from typing import NamedTuple

import torch

from pbrt_tpu_torch.utils.math import INFINITY
from pbrt_tpu_torch.geometry import vecmath as vm
from pbrt_tpu_torch.accel import bvh


class SceneHit(NamedTuple):
    valid: torch.Tensor   # (R,)
    t: torch.Tensor       # (R,)
    p: torch.Tensor       # (R,3)
    ng: torch.Tensor      # (R,3) geometric normal, face-forwarded to ns
    ns: torch.Tensor      # (R,3) shading normal
    uv: torch.Tensor      # (R,2)
    mat: torch.Tensor     # (R,) material (-1 on a miss)
    light: torch.Tensor   # (R,) area light (-1 none)
    wo: torch.Tensor      # (R,3)


def intersect(scene, meta, o, d, t_max) -> SceneHit:
    th = bvh.closest_hit_tris(scene, meta, o, d, t_max)
    valid = th.t < INFINITY
    tri = torch.clamp(th.prim, min=0)
    p0, p1, p2 = scene.tri_p0[tri], scene.tri_p1[tri], scene.tri_p2[tri]
    b = th.b
    p_t = b[..., 0:1] * p0 + b[..., 1:2] * p1 + b[..., 2:3] * p2
    ng_t = vm.normalize(vm.cross(p1 - p0, p2 - p0))
    rec = scene.tri_rec[tri]                       # (R, 27)
    n0, n1, n2 = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
    uv0, uv1, uv2 = rec[:, 9:11], rec[:, 11:13], rec[:, 13:15]
    mat_t = rec[:, 15].long()
    light_t = rec[:, 16].long()
    rev = rec[:, 17] > 0.5
    has_n = rec[:, 18] > 0.5
    ng_t = torch.where(rev[..., None], -ng_t, ng_t)
    ns_t = vm.normalize(b[..., 0:1] * n0 + b[..., 1:2] * n1 + b[..., 2:3] * n2)
    ng_adj = torch.where(has_n[..., None], vm.face_forward(ng_t, ns_t), ng_t)
    ns_t = torch.where(has_n[..., None], ns_t, ng_adj)
    uv_t = b[..., 0:1] * uv0 + b[..., 1:2] * uv1 + b[..., 2:3] * uv2

    zaxis = torch.zeros_like(ng_adj)
    zaxis[..., 2] = 1.0
    v3 = valid[..., None]
    return SceneHit(
        valid=valid,
        t=torch.where(valid, th.t, 1.0),
        p=torch.where(v3, p_t, o),
        ng=torch.where(v3, ng_adj, zaxis),
        ns=torch.where(v3, ns_t, zaxis),
        uv=torch.where(v3, uv_t, 0.0),
        mat=torch.where(valid, mat_t, -1),
        light=torch.where(valid, light_t, -1),
        wo=-d,
    )


def occluded(scene, meta, o, d, t_max):
    """Any hit between o and o + t_max * d (R,)."""
    return bvh.any_hit_tris(scene, meta, o, d, t_max)
