"""Scene-level closest-hit and any-hit queries (counterpart of
pbrt_tpu/accel/dispatch.py `intersect`/`occluded`; reference
accelerator/hlbvh.h + base/interaction.h).

Triangles go through the BVH kernel (K1) on scenes of at least
MIN_TRIS_FOR_BVH triangles and through the dense sweep (K3) below that;
spheres and disks always go through the dense quadric sweeps (K4). The
three closest hits merge by t (triangle < sphere <= disk on ties, as in the
JAX package), and the hit record is assembled as it does: from the packed
per-triangle `tri_rec` row on BVH scenes, from the per-column tables on
dense ones, with the sphere uv of reference sphere.h:74-81, and on a
scene with media the shape's inside and outside medium (med_in, med_out;
-1 on a miss, and everywhere on a scene without media). The surface's uv
derivatives dpdu and dpdv (tri_rec's columns 21:27 on the BVH route, zeros
on dense triangles and spheres; a disk keeps its losing candidate's, as in
the JAX package) are assembled only when a caller asks for them
(`derivatives`: a render with texture footprints), and returned beside the
record. On a scene-sharded render (Scene.shard set) triangles go
through the parts' traversal of parallel/scene_shard.py (K11a/K11b) instead,
whose winner arrives with its tri_rec row and vertices; the same record
assembly serves both. On an instanced scene (a two-level table) the BVH
kernel is K1i, and an instanced winner's record, assembled in its
prototype's object space, is mapped to render space with its instance's
transforms.
"""
from typing import NamedTuple

import torch

from pbrt_tpu_torch.utils.math import INFINITY, PI
from pbrt_tpu_torch.geometry import intersect as ix, vecmath as vm
from pbrt_tpu_torch.accel import bvh
from pbrt_tpu_torch.parallel import scene_shard


class SceneHit(NamedTuple):
    valid: torch.Tensor   # (R,)
    t: torch.Tensor       # (R,)
    p: torch.Tensor       # (R,3)
    ng: torch.Tensor      # (R,3) geometric normal, face-forwarded to ns
    ns: torch.Tensor      # (R,3) shading normal
    uv: torch.Tensor      # (R,2)
    mat: torch.Tensor     # (R,) material (-1 on a miss and on a material-less interface)
    light: torch.Tensor   # (R,) area light (-1 none)
    med_in: torch.Tensor  # (R,) int64 interior medium (-1 vacuum or a miss)
    med_out: torch.Tensor  # (R,) int64 exterior medium
    wo: torch.Tensor      # (R,3)


def _spheres(scene, meta):
    """SphereSoA with the scene's packed kernel table, and the clip fields
    only when a partial sphere exists, so full-sphere scenes run the kernel
    without the clip code."""
    if meta.sph_partial:
        return ix.SphereSoA(scene.sph_center, scene.sph_radius, rot=scene.sph_rot,
                            zmin=scene.sph_zmin, zmax=scene.sph_zmax, phimax=scene.sph_phimax,
                            table=scene.sph_table)
    return ix.SphereSoA(scene.sph_center, scene.sph_radius, table=scene.sph_table)


def _disks(scene, meta):
    if meta.dsk_partial:
        return ix.DiskSoA(scene.dsk_center, scene.dsk_normal, scene.dsk_radius,
                          scene.dsk_inner, xaxis=scene.dsk_xaxis, yaxis=scene.dsk_yaxis,
                          phimax=scene.dsk_phimax, table=scene.dsk_table)
    return ix.DiskSoA(scene.dsk_center, scene.dsk_normal, scene.dsk_radius, scene.dsk_inner,
                      table=scene.dsk_table)


def _record_fields(rec, media):
    """The columns of packed tri_rec rows (R, 27) -> (n0, n1, n2, uv0, uv1,
    uv2, mat, light, rev, has_n, (inside, outside) media (R, 2), None on a
    scene without media)."""
    return (rec[:, 0:3], rec[:, 3:6], rec[:, 6:9], rec[:, 9:11], rec[:, 11:13], rec[:, 13:15],
            rec[:, 15].long(), rec[:, 16].long(), rec[:, 17] > 0.5, rec[:, 18] > 0.5,
            rec[:, 19:21].long() if media else None)


def _matvec(m, v):
    """m (R, 3, 3) times v (R, 3), each row summed as (m0 v0 + m1 v1) + m2 v2."""
    return (m[:, :, 0] * v[:, None, 0] + m[:, :, 1] * v[:, None, 1]) + m[:, :, 2] * v[:, None, 2]


def _to_world(scene, inst):
    """(p -> o2w p, n -> w2o^T n) of the instances `inst` (R,) (-1: the
    identity), and the mask of instanced lanes with their mirror flags (JAX
    dispatch.py:152-221)."""
    is_i = inst >= 0
    iw = torch.clamp(inst, min=0)
    o2w = scene.inst_o2w[iw].reshape(-1, 3, 4)
    w2o = scene.inst_w2o[iw].reshape(-1, 3, 4)

    def point(p):
        return torch.where(is_i[:, None], _matvec(o2w[:, :, :3], p) + o2w[:, :, 3], p)

    def normal(n):
        # (M^-T n)_i = sum_j w2o[j, i] n_j
        return _matvec(w2o[:, :, :3].transpose(1, 2), n)

    return point, normal, is_i, scene.inst_swap[iw] > 0.5


def _triangle_record(p0, p1, p2, b, fields, inst=None):
    """Hit record of the winning triangles (p0, p1, p2 (R, 3), barycentrics
    b, and their _record_fields) -> (p, ng (face-forwarded), ns, uv, mat,
    light, media (R, 2)). `inst`, on an instanced scene, is (_to_world(...) of the
    winners' instances): the record is mapped from object to render space,
    p through o2w, the normals through w2o^T, the shading normal negated on a
    mirrored instance. The geometric normal is not: the stored rev (def-space
    orientation) and the sign of the transform's determinant cancel, see JAX
    dispatch.py:155-160."""
    n0, n1, n2, uv0, uv1, uv2, mat_t, light_t, rev, has_n, med_t = fields
    p_t = b[..., 0:1] * p0 + b[..., 1:2] * p1 + b[..., 2:3] * p2
    ng_t = vm.normalize(vm.cross(p1 - p0, p2 - p0))
    if inst is not None:
        point, normal, is_i, swap = inst
        p_t = point(p_t)
        ng_t = torch.where(is_i[:, None], vm.normalize(normal(ng_t)), ng_t)
    ng_t = torch.where(rev[..., None], -ng_t, ng_t)
    ns_t = vm.normalize(b[..., 0:1] * n0 + b[..., 1:2] * n1 + b[..., 2:3] * n2)
    if inst is not None:
        ns_w = vm.normalize(normal(ns_t))
        ns_t = torch.where(is_i[:, None], torch.where(swap[:, None], -ns_w, ns_w), ns_t)
    ng_adj = torch.where(has_n[..., None], vm.face_forward(ng_t, ns_t), ng_t)
    ns_t = torch.where(has_n[..., None], ns_t, ng_adj)
    uv_t = b[..., 0:1] * uv0 + b[..., 1:2] * uv1 + b[..., 2:3] * uv2
    return p_t, ng_adj, ns_t, uv_t, mat_t, light_t, med_t


def _closest_triangles(scene, meta, o, d, t_max, media, derivatives=False):
    """Closest triangle hit and its record on the scene's route -> (t (R,),
    INFINITY on a miss, (p, ng, ns, uv, mat, light, media; media only where
    `media`, else None), (dpdu, dpdv) where `derivatives`, else None).
      - scene-sharded (scene.shard set; JAX dispatch.py:80-93, 122-145): the
        parts' traversal (K11a) delivers the winner's record row and
        vertices, and the hit is refit against them (the BVH route's refit,
        lane i's triangle the pack's row i);
      - BVH (K1, K1i on an instanced scene): one wide tri_rec row gather for
        the whole record;
      - dense (K3): the per-column tables."""
    if scene.shard is not None:
        _, rec, p0, p1, p2, valid = scene_shard.closest_hit_parts(scene.shard, o, d, t_max)
        p0, p1, p2 = (x.contiguous() for x in (p0, p1, p2))
        lane = torch.where(valid, torch.arange(o.shape[0], device=o.device), -1)
        refit = bvh.refit_cuda if o.is_cuda else bvh.refit_plain
        t, _, b = refit(p0, p1, p2, o, d, t_max, lane)
        derivs = (rec[:, 21:24], rec[:, 24:27]) if derivatives else None
        return t, _triangle_record(p0, p1, p2, b, _record_fields(rec, media)), derivs
    inst = derivs = None
    if scene.bvh_rows.shape[0] > 0:
        th = bvh.closest_hit_tris(scene, meta, o, d, t_max)
        tri = torch.clamp(th.prim, min=0)
        rec = scene.tri_rec[tri]
        fields = _record_fields(rec, media)
        if th.inst is not None:
            inst = _to_world(scene, th.inst)
        if derivatives:
            derivs = (rec[:, 21:24], rec[:, 24:27])
    else:
        th = ix.intersect_tris_dense(o, d, t_max, scene.tri_p0, scene.tri_p1, scene.tri_p2)
        tri = torch.clamp(th.prim, min=0)
        fields = (scene.tri_n0[tri], scene.tri_n1[tri], scene.tri_n2[tri], scene.tri_uv0[tri],
                  scene.tri_uv1[tri], scene.tri_uv2[tri], scene.tri_mat[tri].long(),
                  scene.tri_light[tri].long(), scene.tri_rev[tri], scene.tri_has_n[tri],
                  scene.tri_med[tri].long() if media else None)
        if derivatives:
            derivs = (torch.zeros_like(o), torch.zeros_like(o))
    return th.t, _triangle_record(scene.tri_p0[tri], scene.tri_p1[tri], scene.tri_p2[tri],
                                  th.b, fields, inst), derivs


def _sphere_uv(scene, sph, p_s):
    """u = phi / phimax, v = (theta - theta(zmax)) / (theta(zmin) -
    theta(zmax)) in the sphere's object frame (reference sphere.h:74-81)."""
    rad = torch.clamp(scene.sph_radius[sph], min=1e-12)
    rot, rel = scene.sph_rot[sph], p_s - scene.sph_center[sph]
    # local_i = sum_j rot[j, i] rel_j, spelled out (a batched einsum of 3x3
    # matrices goes to a cuBLAS gemv per chunk)
    local = rel[:, 0:1] * rot[:, 0] + rel[:, 1:2] * rot[:, 1] + rel[:, 2:3] * rot[:, 2]
    phi = torch.atan2(local[:, 1], local[:, 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)

    def acos(x):
        return torch.arccos(torch.clamp(x, -1.0, 1.0))

    theta = acos(local[:, 2] / rad)
    th_min = acos(scene.sph_zmax[sph] / rad)
    th_max = acos(scene.sph_zmin[sph] / rad)
    u = phi / torch.clamp(scene.sph_phimax[sph], min=1e-6)
    v = (theta - th_min) / torch.clamp(th_max - th_min, min=1e-6)
    return torch.stack([u, v], dim=-1)


def intersect(scene, meta, o, d, t_max, derivatives=False):
    """The closest hits of the rays o + t d, t < t_max -> their SceneHit;
    with `derivatives`, (SceneHit, dpdu (R, 3), dpdv (R, 3)), the surface's
    uv derivatives (0 on a miss)."""
    R = o.shape[0]
    dev = o.device
    have_tris = scene.tri_p0.shape[0] > 0
    have_sph = scene.sph_center.shape[0] > 0
    have_dsk = scene.dsk_center.shape[0] > 0
    # the shapes' media are assembled on a scene with media only
    media = scene.med_sigma_a.shape[0] > 0
    inf = torch.full((R,), INFINITY, device=dev)

    t_tri = t_s = t_d = inf
    dpdu = dpdv = torch.zeros((R, 3), device=dev) if derivatives else None
    if have_tris:
        t_tri, tri_record, derivs = _closest_triangles(scene, meta, o, d, t_max, media,
                                                       derivatives)
        if derivatives:
            dpdu, dpdv = derivs
    if have_sph:
        t_s, idx_s, p_s, n_s = ix.intersect_spheres_dense(o, d, t_max, _spheres(scene, meta))
    if have_dsk:
        t_d, idx_d, p_d, n_d = ix.intersect_disks_dense(o, d, t_max, _disks(scene, meta))

    use_sphere = (t_s < t_tri) & (t_s <= t_d)
    use_disk = (t_d < t_tri) & (t_d < t_s)
    t = torch.minimum(torch.minimum(t_tri, t_s), t_d)
    valid = t < INFINITY

    if have_tris:
        p_hit, ng, ns, uv, mat, light, med = tri_record
    else:
        p_hit, ng, ns = (torch.zeros((R, 3), device=dev) for _ in range(3))
        uv = torch.zeros((R, 2), device=dev)
        mat = light = torch.full((R,), -1, dtype=torch.int64, device=dev)
        med = torch.full((R, 2), -1, dtype=torch.int64, device=dev) if media else None
    if have_sph:
        sph = torch.clamp(idx_s, min=0)
        s3 = use_sphere[..., None]
        p_hit = torch.where(s3, p_s, p_hit)
        ng = torch.where(s3, n_s, ng)
        ns = torch.where(s3, n_s, ns)
        uv = torch.where(s3, _sphere_uv(scene, sph, p_s), uv)
        mat = torch.where(use_sphere, scene.sph_mat[sph].long(), mat)
        light = torch.where(use_sphere, scene.sph_light[sph].long(), light)
        if media:
            med = torch.where(s3, scene.sph_med[sph].long(), med)
        if derivatives:
            dpdu, dpdv = torch.where(s3, 0.0, dpdu), torch.where(s3, 0.0, dpdv)
    if have_dsk:
        dk = torch.clamp(idx_d, min=0)
        d3 = use_disk[..., None]
        p_hit = torch.where(d3, p_d, p_hit)
        ng = torch.where(d3, n_d, ng)
        ns = torch.where(d3, n_d, ns)
        mat = torch.where(use_disk, scene.dsk_mat[dk].long(), mat)
        light = torch.where(use_disk, scene.dsk_light[dk].long(), light)
        if media:
            med = torch.where(d3, scene.dsk_med[dk].long(), med)

    if media:
        med_in, med_out = torch.where(valid, med[:, 0], -1), torch.where(valid, med[:, 1], -1)
    else:
        med_in = med_out = torch.full((R,), -1, dtype=torch.int64, device=dev)
    zaxis = torch.zeros_like(ng)
    zaxis[..., 2] = 1.0
    v3 = valid[..., None]
    hit = SceneHit(
        valid=valid,
        t=torch.where(valid, t, 1.0),
        p=torch.where(v3, p_hit, o),
        ng=torch.where(v3, ng, zaxis),
        ns=torch.where(v3, ns, zaxis),
        uv=torch.where(v3, uv, 0.0),
        mat=torch.where(valid, mat, -1),
        light=torch.where(valid, light, -1),
        med_in=med_in,
        med_out=med_out,
        wo=-d,
    )
    if derivatives:
        return hit, torch.where(v3, dpdu, 0.0), torch.where(v3, dpdv, 0.0)
    return hit


def occluded(scene, meta, o, d, t_max):
    """Any hit between o and o + t_max * d (R,) (reference integrator_base
    unoccluded)."""
    occ = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    if scene.tri_p0.shape[0] > 0:
        if scene.shard is not None:
            occ = occ | scene_shard.any_hit_parts(scene.shard, o, d, t_max)
        elif scene.bvh_rows.shape[0] > 0:
            occ = occ | bvh.any_hit_tris(scene, meta, o, d, t_max)
        else:
            occ = occ | ix.occluded_tris_dense(o, d, t_max, scene.tri_p0, scene.tri_p1,
                                               scene.tri_p2)
    if scene.sph_center.shape[0] > 0:
        occ = occ | ix.occluded_spheres_dense(o, d, t_max, _spheres(scene, meta))
    if scene.dsk_center.shape[0] > 0:
        occ = occ | (ix.intersect_disks_dense(o, d, t_max, _disks(scene, meta))[1] >= 0)
    return occ
