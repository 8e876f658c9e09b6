"""Scene compiler: SceneBuilder output -> `Scene` tensors + `SceneMeta`.

Counterpart of pbrt_tpu/scene/compile.py, as host numpy with no JAX: the
same render-space conversion (world translated so the camera sits at the
origin), the same SAH wide BVH and leaf-order reordering for scenes of at
least MIN_TRIS_FOR_BVH triangles (smaller ones keep their triangles in
scene order for the dense kernel, with empty BVH tables), sphere and disk
tables, material/light tables, power-proportional light alias table,
filter tables and the camera importance constants of BDPT, so every array
comes out equal to the JAX package's `SceneArrays` field of the same name.
`Scene` holds only the fields the path and BDPT integrators read; the JAX
package's zero-byte shape markers (BVH depth,
partial quadrics, coated materials) become plain ints and bools of
`SceneMeta`.
"""
from dataclasses import dataclass, fields
from functools import cached_property

import numpy as np
import torch

from pbrt_tpu_torch.accel import bvh as bvhlib
from pbrt_tpu_torch.distribution.distributions import alias_table_build
from pbrt_tpu_torch.filters import filters as filterlib
from pbrt_tpu_torch.geometry import intersect as ix, transform as tf
from pbrt_tpu_torch.scene import builder as bd
from pbrt_tpu_torch.spectral import cie, colorspace as cspace, rgb2spec
from pbrt_tpu_torch.utils.device import resolve_device


@dataclass
class Scene:
    """Device tensors of a compiled scene (render space)."""

    # triangles, in BVH leaf order (padding rows are degenerate zeros) on
    # BVH scenes, in scene order on dense ones
    tri_p0: torch.Tensor         # (T, 3) f32
    tri_p1: torch.Tensor
    tri_p2: torch.Tensor
    tri_n0: torch.Tensor         # (T, 3) f32 vertex normals (zeros without)
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_has_n: torch.Tensor      # (T,) bool
    tri_uv0: torch.Tensor        # (T, 2) f32
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_mat: torch.Tensor        # (T,) i32
    tri_light: torch.Tensor      # (T,) i32 area light or -1
    tri_rev: torch.Tensor        # (T,) bool
    tri_rec: torch.Tensor        # (T, 27) f32 packed hit record of BVH scenes
                                 # [n0 n1 n2 uv0 uv1 uv2 mat light rev has_n
                                 #  med_in med_out dpdu dpdv]; (0, 27) on dense
    bvh_rows: torch.Tensor       # (n_int + P, 72) f32 unified node/leaf table
                                 # ((0, 72) on dense scenes)
    # spheres (render space); the clip columns hold the full range on full
    # spheres, and SceneMeta.sph_partial says whether any sphere is clipped
    sph_center: torch.Tensor     # (S, 3) f32
    sph_radius: torch.Tensor     # (S,)
    sph_mat: torch.Tensor        # (S,) i32
    sph_light: torch.Tensor      # (S,) i32
    sph_rot: torch.Tensor        # (S, 3, 3) object-frame rotation (uv + clip)
    sph_zmin: torch.Tensor       # (S,)
    sph_zmax: torch.Tensor
    sph_phimax: torch.Tensor     # (S,) radians
    # disks (render space)
    dsk_center: torch.Tensor     # (D, 3)
    dsk_normal: torch.Tensor     # (D, 3)
    dsk_radius: torch.Tensor     # (D,)
    dsk_inner: torch.Tensor      # (D,)
    dsk_mat: torch.Tensor        # (D,) i32
    dsk_light: torch.Tensor      # (D,) i32
    dsk_xaxis: torch.Tensor      # (D, 3) in-plane frame for phi clipping
    dsk_yaxis: torch.Tensor
    dsk_phimax: torch.Tensor     # (D,) radians
    # materials
    mat_type: torch.Tensor       # (M,) i32
    mat_refl_c: torch.Tensor     # (M, 3) sigmoid coefficients
    mat_trans_c: torch.Tensor    # (M, 3)
    mat_urough: torch.Tensor     # (M,)
    mat_vrough: torch.Tensor
    mat_remap: torch.Tensor      # (M,) bool
    mat_eta: torch.Tensor        # (M,) dielectric eta (float mode)
    mat_eta_spec: torch.Tensor   # (M,) i32 row into spec_table or -1
    mat_k_spec: torch.Tensor
    mat_refl_mode: torch.Tensor  # (M,) bool: conductor from reflectance
    # coated (layered) materials; SceneMeta.layered says whether any is used
    mat_thickness: torch.Tensor  # (M,)
    mat_ieta: torch.Tensor       # (M,) interface (coat) eta
    mat_lay_g: torch.Tensor      # (M,) medium HG asymmetry
    mat_albedo_c: torch.Tensor   # (M, 3) medium albedo sigmoid coefficients
    mat_crough_u: torch.Tensor   # (M,) conductor (bottom) roughness
    mat_crough_v: torch.Tensor
    spec_table: torch.Tensor     # (NS, 471) f32
    # lights: area (triangle, sphere, disk), distant, uniform infinite, spot
    lt_type: torch.Tensor        # (L,) i32
    lt_emission: torch.Tensor    # (L, 471) f32
    lt_scale: torch.Tensor       # (L,)
    lt_twosided: torch.Tensor    # (L,) bool
    lt_tri: torch.Tensor         # (L,) i32 emitter triangle (leaf order) or -1
    lt_sph: torch.Tensor         # (L,) i32 emitter sphere or -1
    lt_dsk: torch.Tensor         # (L,) i32 emitter disk or -1
    lt_direction: torch.Tensor   # (L, 3) distant: towards the light; spot: axis
    lt_position: torch.Tensor    # (L, 3) spot position (render space)
    lt_cos_start: torch.Tensor   # (L,) spot falloff
    lt_cos_end: torch.Tensor
    lt_pmf: torch.Tensor         # (L,)
    lt_alias_rows: torch.Tensor  # (L, 3) [q, alias, pmf]
    filt: filterlib.FilterTables  # of tensors
    # camera (render space)
    camera_from_raster: torch.Tensor  # (4, 4)
    render_from_camera: torch.Tensor  # (4, 4)
    camera_lens_radius: torch.Tensor  # ()
    camera_focal_distance: torch.Tensor
    camera_A: torch.Tensor       # () image plane area at z = 1 (pdf_we)
    camera_cos_total: torch.Tensor  # () cosine of the frustum's corner angle
    camera_res: torch.Tensor     # (2,) i32 raster bounds of we()
    scene_radius: torch.Tensor   # ()
    scene_center: torch.Tensor   # (3,) bounding-sphere center (sample_le disks)
    ray_offset_scale: torch.Tensor  # () epsilon of spawned rays

    def to(self, device):
        """A copy of the scene on `device`."""
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            kw[f.name] = (filterlib.FilterTables(*(x.to(device) for x in v))
                          if f.name == "filt" else v.to(device))
        return Scene(**kw)

    @property
    def device(self):
        return self.bvh_rows.device

    # the dense quadric kernels' row tables (csrc/dense_intersect.cu), packed
    # from the columns above once per scene, at first use; the kernels read
    # the clip columns only when SceneMeta.sph_partial / dsk_partial
    @cached_property
    def sph_table(self):
        return ix.sphere_table(self.sph_center, self.sph_radius, self.sph_rot, self.sph_zmin,
                               self.sph_zmax, self.sph_phimax)

    @cached_property
    def dsk_table(self):
        return ix.disk_table(self.dsk_center, self.dsk_normal, self.dsk_radius, self.dsk_inner,
                             self.dsk_xaxis, self.dsk_yaxis, self.dsk_phimax)

    @cached_property
    def camera_inverse(self):
        """(camera_from_render, raster_from_camera) float32 (4, 4), inverted
        once per scene in float64 from the float32 matrices (the camera's
        importance functions map render-space points back to the raster)."""
        def inv(m):
            return torch.as_tensor(np.linalg.inv(m.double().cpu().numpy()).astype(np.float32),
                                   device=m.device)
        return inv(self.render_from_camera), inv(self.camera_from_raster)


@dataclass
class SceneMeta:
    """Static scene configuration (host values)."""

    resolution: tuple
    spp: int
    sampler: str
    integrator: str
    max_depth: int
    filename: str
    n_tris: int
    n_spheres: int
    n_disks: int
    n_lights: int
    filter_kind: str
    film_imaging_ratio: float
    film_out_matrix: np.ndarray   # (3, 3) output RGB from sensor XYZ
    open_scene: bool              # has infinite lights: rays escape, so the
                                  # render takes the wavefront loop
    bvh_nint: int                 # internal BVH rows (leaf chunk c = row n_int + c)
    bvh_depth: int                # deepest internal chain (traversal stack bound)
    sph_partial: bool             # some sphere is clipped (zmin/zmax/phimax)
    dsk_partial: bool             # some disk is clipped (phimax)
    layered: bool                 # some material is coated: make_bsdf builds
                                  # the layered parameters (K7)
    mutations_per_pixel: int      # MLT: mutations per pixel of a frame


def scene_from_arrays(arrays, meta, device):
    """Scene + SceneMeta from a {field: array} mapping, e.g. the JAX
    package's `SceneArrays` converted field by field with np.asarray (its
    `filt` may be a FilterTables or a dict). `meta` is any object with the
    SceneMeta attributes; bvh_nint/bvh_depth and sph_partial/dsk_partial
    come from the JAX zero-byte markers `arrays['bvh_nint']`, `['bvh_depth']`,
    `['sph_partial_marker']`, `['dsk_partial_marker']` and layered from
    `['lay_marker']` when present."""
    device = torch.device(device)
    kw = {}
    for f in fields(Scene):
        v = arrays[f.name]
        if f.name == "filt":
            items = v._asdict() if hasattr(v, "_asdict") else dict(v)
            kw["filt"] = filterlib.FilterTables(
                **{k: torch.as_tensor(np.array(items[k])).to(device)
                   for k in filterlib.FilterTables._fields})
        else:
            kw[f.name] = torch.as_tensor(np.array(v)).to(device)
    m = {f.name: getattr(meta, f.name, None) for f in fields(SceneMeta)}
    get = arrays.get if hasattr(arrays, "get") else (lambda k: None)
    for marker in ("bvh_nint", "bvh_depth"):
        a = get(marker)
        if a is not None and np.ndim(a) == 2:
            m[marker] = int(np.shape(a)[0])
    for name, marker in (("sph_partial", "sph_partial_marker"),
                         ("dsk_partial", "dsk_partial_marker"), ("layered", "lay_marker")):
        if get(marker) is not None:
            m[name] = np.shape(get(marker))[0] > 0
    missing = [k for k, v in m.items() if v is None]
    if missing:
        raise ValueError(f"scene_from_arrays: meta lacks {missing}")
    return Scene(**kw), SceneMeta(**m)


def build_perspective_matrices(fov, resolution):
    """camera_from_raster per reference cameras/perspective.cu:20-41."""
    resx, resy = resolution
    aspect = resx / resy
    if aspect > 1.0:
        x0, x1, y0, y1 = -aspect, aspect, -1.0, 1.0
    else:
        x0, x1, y0, y1 = -1.0, 1.0, -1.0 / aspect, 1.0 / aspect
    ndc_from_screen = tf.scale(1.0 / (x1 - x0), 1.0 / (y1 - y0), 1.0) @ tf.translate(
        -x0, -y1, 0.0)
    raster_from_ndc = tf.scale(resx, -resy, 1.0)
    raster_from_screen = raster_from_ndc @ ndc_from_screen
    screen_from_camera = tf.perspective(fov, 1e-2, 1000.0)
    return np.linalg.inv(screen_from_camera) @ np.linalg.inv(raster_from_screen)


def _dpduv(tp_, tuv_):
    """Per-triangle dpdu/dpdv from vertex uv deltas (zeros when degenerate)."""
    dp1 = tp_[:, 1] - tp_[:, 0]
    dp2 = tp_[:, 2] - tp_[:, 0]
    duv1 = tuv_[:, 1] - tuv_[:, 0]
    duv2 = tuv_[:, 2] - tuv_[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]
    dpdu = (duv2[:, 1:2] * dp1 - duv1[:, 1:2] * dp2) * inv
    dpdv = (-duv2[:, 0:1] * dp1 + duv1[:, 0:1] * dp2) * inv
    return dpdu.astype(np.float32), dpdv.astype(np.float32)


def compile_arrays(b: bd.SceneBuilder, spp_override=None, integrator_override=None):
    """Host compile -> ({field: numpy array} for every Scene field, SceneMeta)."""
    f32 = np.float32
    integrator = integrator_override or b.integrator["type"]
    bd.check_integrator(integrator)

    # ---- camera / render space
    world_from_camera = np.linalg.inv(b.camera["camera_from_world"])
    cam_pos = world_from_camera[:3, 3]
    render_from_world = np.linalg.inv(tf.translate(*cam_pos))
    render_from_camera = render_from_world @ world_from_camera
    resolution = (b.film["xresolution"], b.film["yresolution"])
    camera_from_raster = build_perspective_matrices(b.camera["fov"], resolution)

    # ---- triangles: BVH leaf order from MIN_TRIS_FOR_BVH on, else scene order
    T = len(b.tri_p)
    tp = np.stack(b.tri_p) - cam_pos if T else np.zeros((0, 3, 3))
    has_n = np.array([n is not None for n in b.tri_n], bool)
    tn = (np.stack([n if n is not None else np.zeros((3, 3)) for n in b.tri_n])
          if T else np.zeros((0, 3, 3)))
    tuv = (np.stack([u if u is not None else np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])
                     for u in b.tri_uv]) if T else np.zeros((0, 3, 2)))
    tri_mat = np.asarray(b.tri_mat, np.int32).reshape(T)
    tri_light = np.asarray(b.tri_light, np.int32).reshape(T)
    tri_rev = np.asarray(b.tri_rev, bool).reshape(T)
    tri_med = np.full((T, 2), -1, np.int32)
    tri_newpos = np.arange(T, dtype=np.int32)

    if T >= bvhlib.MIN_TRIS_FOR_BVH:
        bvh = bvhlib.build_bvh(tp[:, 0], tp[:, 1], tp[:, 2])
        n_pad = int(bvh.n_padded)
        live = bvh.src >= 0
        tri_newpos[bvh.src[live]] = np.nonzero(live)[0].astype(np.int32)

        def reorder_pad(a, fill):
            return bvhlib.reorder_pad(bvh, a, fill)

        tp = reorder_pad(tp, 0.0)
        tn = reorder_pad(tn, 0.0)
        tuv = reorder_pad(tuv, 0.0)
        has_n = reorder_pad(has_n, False)
        tri_mat = reorder_pad(tri_mat, -1)
        tri_light = reorder_pad(tri_light, -1)
        tri_rev = reorder_pad(tri_rev, False)
        tri_med = reorder_pad(tri_med, -1)
        dpdu, dpdv = _dpduv(tp.reshape(n_pad, 3, 3), tuv.reshape(n_pad, 3, 2))
        tri_rec = np.concatenate([
            tn.reshape(n_pad, 9).astype(f32), tuv.reshape(n_pad, 6).astype(f32),
            tri_mat[:, None].astype(f32), tri_light[:, None].astype(f32),
            tri_rev[:, None].astype(f32), has_n[:, None].astype(f32),
            tri_med.astype(f32), dpdu, dpdv,
        ], axis=1)
        bvh_rows, bvh_nint, bvh_depth = bvh.rows, int(bvh.n_int), int(bvh.max_depth)
    else:
        # dense route: the hit record is gathered column by column
        tri_rec = np.zeros((0, 27), f32)
        bvh_rows, bvh_nint, bvh_depth = np.zeros((0, bvhlib.ROW_W), f32), 0, 0

    # ---- spheres (reference shapes/sphere.cu:15-26) and disks (disk.cu)
    S, D = len(b.spheres), len(b.disks)

    def col(items, key, shape, dtype):
        return np.asarray([it[key] for it in items], dtype).reshape((len(items),) + shape)

    sph_center = col(b.spheres, "center", (3,), np.float64) - cam_pos
    sph_radius = col(b.spheres, "radius", (), np.float64)
    dsk_center = col(b.disks, "center", (3,), np.float64) - cam_pos
    dsk_radius = col(b.disks, "radius", (), f32)

    # ---- materials
    def coeffs_of(rgb):
        if rgb is None:
            return np.zeros(3, f32)
        return rgb2spec.rgb_to_coefficients_np(np.clip(rgb, 0.0, 1.0))

    mats = b.materials
    mat_type = np.array([m.type for m in mats], np.int32)
    mat_refl_c = np.stack([coeffs_of(m.reflectance_rgb) for m in mats])
    mat_trans_c = np.stack([coeffs_of(m.transmittance_rgb) for m in mats])
    mat_refl_mode = np.array(
        [m.type == bd.MAT_CONDUCTOR and m.reflectance_rgb is not None for m in mats])
    # a coated conductor's conductor_eta_spec / conductor_k_spec are not
    # carried here: its base conductor reads spectrum row 0 as both eta and k,
    # as in the JAX package (ROADMAP.md R6)
    mat_albedo_c = np.stack([coeffs_of(m.albedo_rgb) for m in mats])

    NS = max(1, len(b.spectra_rows))
    spec_table = np.zeros((NS, cie.LAMBDA_RANGE), f32)
    for i, row in enumerate(b.spectra_rows):
        spec_table[i] = row

    # ---- lights, power-proportional pmf (reference PowerLightSampler,
    # power_light_sampler.cu): phi ~ pi * (1|2) * area * <Le> for area
    # emitters, <Le> for the others
    L = len(b.lights)
    power = np.zeros(L)
    for i, l in enumerate(b.lights):
        le = float(np.mean(l.emission_dense)) * l.scale
        if l.type == bd.LIGHT_AREA and l.tri_index >= 0:
            p = tp[tri_newpos[l.tri_index]]
            area = 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
        elif l.type == bd.LIGHT_AREA and l.sphere_index >= 0:
            area = 4 * np.pi * b.spheres[l.sphere_index]["radius"] ** 2
        elif l.type == bd.LIGHT_AREA and l.disk_index >= 0:
            dk = b.disks[l.disk_index]
            area = np.pi * (dk["radius"] ** 2 - dk["inner"] ** 2)
        else:
            power[i] = le
            continue
        power[i] = np.pi * (2.0 if l.two_sided else 1.0) * area * le
    if power.sum() <= 0:
        power = np.ones(L)
    lt_pmf = (power / power.sum()).astype(f32) if L else np.zeros((0,), f32)
    if L:
        lt_q, lt_alias, _ = alias_table_build(lt_pmf)
        lt_alias_rows = np.stack([lt_q, lt_alias.astype(f32), lt_pmf], axis=1).astype(f32)
    else:
        lt_alias_rows = np.zeros((0, 3), f32)

    # ---- scene bounds -> epsilon (reference scene_builder.cu:914-918); tp[:T]
    # as in the JAX package, plus the quadrics' bounding boxes
    all_pts = [tp[:T].reshape(-1, 3)] if T else []
    if S:
        all_pts += [sph_center + sph_radius[:, None], sph_center - sph_radius[:, None]]
    if D:
        all_pts += [dsk_center + dsk_radius[:, None], dsk_center - dsk_radius[:, None]]
    pts = np.concatenate(all_pts) if all_pts else np.zeros((1, 3))
    center = 0.5 * (pts.min(0) + pts.max(0))
    radius = float(np.linalg.norm(pts - center, axis=-1).max())

    filter_kind, _, filt = filterlib.build_filter(b.filter)

    # camera importance constants (reference perspective.cu:43-63): the area
    # of the image rectangle projected to the z = 1 plane, and the smallest
    # corner cosine (camera_from_raster's last row is not applied, as in the
    # JAX package)
    corners_raster = np.array([[0, 0, 0], [resolution[0], 0, 0], [0, resolution[1], 0],
                               [resolution[0], resolution[1], 0]], np.float64)
    corners_cam = (camera_from_raster[:3, :3] @ corners_raster.T).T + camera_from_raster[:3, 3]
    corners_z1 = corners_cam[:, :2] / corners_cam[:, 2:3]
    cam_A = float(abs((corners_z1[1, 0] - corners_z1[0, 0])
                      * (corners_z1[2, 1] - corners_z1[0, 1])))
    corner_dirs = corners_cam / np.linalg.norm(corners_cam, axis=-1, keepdims=True)
    cos_total = float(corner_dirs[:, 2].min())

    # ---- PixelSensor (reference rgb_film.cu:27-48)
    iso = float(b.film.get("iso", 100.0))
    exposure = float(b.film.get("exposuretime", 1.0))
    wb_temp = float(b.film.get("whitebalance", 0.0))
    out_space = cspace.srgb()
    xyz_from_sensor = np.eye(3)
    if wb_temp > 0.0:
        src_xyz = cie.to_xyz(cie.cie_d(wb_temp))
        src_xy = src_xyz[:2] / max(src_xyz.sum(), 1e-12)
        xyz_from_sensor = cspace.white_balance_matrix(src_xy, out_space.w)

    lights = b.lights
    arrays = dict(
        tri_p0=tp[:, 0].astype(f32), tri_p1=tp[:, 1].astype(f32), tri_p2=tp[:, 2].astype(f32),
        tri_n0=tn[:, 0].astype(f32), tri_n1=tn[:, 1].astype(f32), tri_n2=tn[:, 2].astype(f32),
        tri_has_n=has_n, tri_uv0=tuv[:, 0].astype(f32), tri_uv1=tuv[:, 1].astype(f32),
        tri_uv2=tuv[:, 2].astype(f32), tri_mat=tri_mat, tri_light=tri_light, tri_rev=tri_rev,
        tri_rec=tri_rec, bvh_rows=bvh_rows,
        sph_center=sph_center.astype(f32), sph_radius=sph_radius.astype(f32),
        sph_mat=col(b.spheres, "mat", (), np.int32),
        sph_light=col(b.spheres, "light", (), np.int32),
        sph_rot=col(b.spheres, "rot", (3, 3), f32),
        sph_zmin=col(b.spheres, "zmin", (), f32), sph_zmax=col(b.spheres, "zmax", (), f32),
        sph_phimax=col(b.spheres, "phimax", (), f32),
        dsk_center=dsk_center.astype(f32), dsk_normal=col(b.disks, "normal", (3,), f32),
        dsk_radius=dsk_radius, dsk_inner=col(b.disks, "inner", (), f32),
        dsk_mat=col(b.disks, "mat", (), np.int32), dsk_light=col(b.disks, "light", (), np.int32),
        dsk_xaxis=col(b.disks, "xaxis", (3,), f32), dsk_yaxis=col(b.disks, "yaxis", (3,), f32),
        dsk_phimax=col(b.disks, "phimax", (), f32),
        mat_type=mat_type,
        mat_refl_c=mat_refl_c.astype(f32), mat_trans_c=mat_trans_c.astype(f32),
        mat_urough=np.array([m.uroughness for m in mats], f32),
        mat_vrough=np.array([m.vroughness for m in mats], f32),
        mat_remap=np.array([m.remap_roughness for m in mats]),
        mat_eta=np.array([m.eta_float for m in mats], f32),
        mat_eta_spec=np.array([m.eta_spec for m in mats], np.int32),
        mat_k_spec=np.array([m.k_spec for m in mats], np.int32),
        mat_refl_mode=mat_refl_mode,
        mat_thickness=np.array([m.thickness for m in mats], f32),
        mat_ieta=np.array([m.interface_eta for m in mats], f32),
        mat_lay_g=np.array([m.g for m in mats], f32),
        mat_albedo_c=mat_albedo_c.astype(f32),
        mat_crough_u=np.array([m.crough_u for m in mats], f32),
        mat_crough_v=np.array([m.crough_v for m in mats], f32),
        spec_table=spec_table,
        lt_type=np.array([l.type for l in lights], np.int32),
        lt_emission=(np.stack([l.emission_dense for l in lights]).astype(f32)
                     if L else np.zeros((0, cie.LAMBDA_RANGE), f32)),
        lt_scale=np.array([l.scale for l in lights], f32),
        lt_twosided=np.array([l.two_sided for l in lights], bool),
        lt_tri=np.array([tri_newpos[l.tri_index] if l.tri_index >= 0 else -1
                         for l in lights], np.int32),
        lt_sph=np.array([l.sphere_index for l in lights], np.int32),
        lt_dsk=np.array([l.disk_index for l in lights], np.int32),
        lt_direction=np.array([np.zeros(3) if l.direction is None else l.direction
                               for l in lights], f32).reshape(L, 3),
        lt_position=np.array([np.zeros(3) if l.position is None else l.position - cam_pos
                              for l in lights], f32).reshape(L, 3),
        lt_cos_start=np.array([l.cos_falloff_start for l in lights], f32),
        lt_cos_end=np.array([l.cos_falloff_end for l in lights], f32),
        lt_pmf=lt_pmf, lt_alias_rows=lt_alias_rows,
        filt=filt,
        camera_from_raster=np.asarray(camera_from_raster, f32),
        render_from_camera=np.asarray(render_from_camera, f32),
        camera_lens_radius=np.asarray(b.camera.get("lensradius", 0.0), f32),
        camera_focal_distance=np.asarray(b.camera.get("focaldistance", 1e6), f32),
        camera_A=np.asarray(cam_A, f32),
        camera_cos_total=np.asarray(cos_total, f32),
        camera_res=np.array(resolution, np.int32),
        scene_radius=np.asarray(radius, f32),
        scene_center=np.asarray(center, f32),
        ray_offset_scale=np.asarray(min(radius * 1e-5, 1e-3) / max(radius, 1e-6), f32),
    )
    spp = spp_override or b.sampler["pixelsamples"]
    if b.sampler["type"] == "stratified" and int(round(spp ** 0.5)) ** 2 != spp:
        spp = max(1, int(spp ** 0.5)) ** 2  # nearest square below
    meta = SceneMeta(
        resolution=resolution,
        spp=spp,
        sampler=b.sampler["type"],
        integrator=integrator,
        max_depth=b.integrator.get("maxdepth", 5),
        filename=b.film["filename"],
        n_tris=T,
        n_spheres=S,
        n_disks=D,
        n_lights=L,
        filter_kind=filter_kind,
        film_imaging_ratio=exposure * iso / 100.0,
        film_out_matrix=np.asarray(out_space.rgb_from_xyz @ xyz_from_sensor, f32),
        open_scene=any(l.type == bd.LIGHT_UNIFORM_INFINITE for l in lights),
        bvh_nint=bvh_nint,
        bvh_depth=bvh_depth,
        sph_partial=any(sp["partial"] for sp in b.spheres),
        dsk_partial=any(dk["partial"] for dk in b.disks),
        layered=any(m.type in (bd.MAT_COATED_DIFFUSE, bd.MAT_COATED_CONDUCTOR) for m in mats),
        mutations_per_pixel=b.integrator.get("mutations", 100),
    )
    return arrays, meta


def compile_scene(b: bd.SceneBuilder, spp_override=None, device=None,
                  integrator_override=None):
    """-> (Scene on `device`, SceneMeta). device=None means "cuda"."""
    device = resolve_device(device)
    arrays, meta = compile_arrays(b, spp_override, integrator_override)
    scene, _ = scene_from_arrays(arrays, meta, device)
    return scene, meta


def load_scene(path, device=None, spp=None, integrator=None):
    """Parse and compile a .pbrt file -> (Scene, SceneMeta); `integrator`
    overrides the file's (e.g. "path" for a scene written for BDPT)."""
    device = resolve_device(device)
    return compile_scene(bd.SceneBuilder().parse_file(path), spp_override=spp, device=device,
                         integrator_override=integrator)
