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
import copy
from types import SimpleNamespace
from dataclasses import dataclass, fields
from functools import cached_property

import numpy as np
import torch

from pbrt_tpu_torch.accel import bvh as bvhlib
from pbrt_tpu_torch.cameras import differentials
from pbrt_tpu_torch.distribution.distributions import alias_table_build
from pbrt_tpu_torch.filters import filters as filterlib
from pbrt_tpu_torch.geometry import intersect as ix, transform as tf
from pbrt_tpu_torch.scene import builder as bd
from pbrt_tpu_torch.spectral import cie, colorspace as cspace, rgb2spec
from pbrt_tpu_torch.textures import textures as texlib
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
                                 # ((0, 72) on dense scenes; n_int + I + P rows
                                 # with I instance rows on instanced ones)
    # instances of a two-level table (render space; (0, ...) without)
    inst_w2o: torch.Tensor       # (I, 12) f32 render -> object affine, row-major 3x4
    inst_o2w: torch.Tensor       # (I, 12) f32 object -> render affine
    inst_swap: torch.Tensor      # (I,) f32 1.0 where the transform mirrors
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
    # homogeneous media and each shape's (inside, outside) medium (-1 vacuum;
    # tri_med in the triangles' order, also columns 19:21 of tri_rec)
    med_sigma_a: torch.Tensor    # (NM, 471) f32
    med_sigma_s: torch.Tensor    # (NM, 471) f32
    med_g: torch.Tensor          # (NM,) f32 HG asymmetry
    tri_med: torch.Tensor        # (T, 2) i32
    sph_med: torch.Tensor        # (S, 2) i32
    dsk_med: torch.Tensor        # (D, 2) i32
    camera_medium: torch.Tensor  # () i32 the medium camera rays start in
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
    # mix materials (MAT_MIX rows): the two materials and the amount
    mat_mix_m1: torch.Tensor     # (M,) i32
    mat_mix_m2: torch.Tensor
    mat_mix_amount: torch.Tensor  # (M,)
    # texture slots: a node of `tex` or -1 (the constant columns above)
    mat_refl_tex: torch.Tensor   # (M,) i32
    mat_trans_tex: torch.Tensor
    mat_urough_tex: torch.Tensor
    mat_vrough_tex: torch.Tensor
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
    lt_medium: torch.Tensor      # (L,) i32 light subpaths start in it
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
    cam_ray_deltas: torch.Tensor  # (4, 3) one-pixel camera ray deltas (do_dx, dd_dx,
                                  # do_dy, dd_dy) of footprint-aware texture lookups
    tex: texlib.TexArrays         # the texture node table, of tensors (0 rows
                                  # on a scene without textures)
    # the parts of the triangle soup this rank traverses (parallel/
    # scene_shard.SceneShard, JAX compile.py:170-174): None unless a
    # scene-sharded render sets it (with_shard). Not a dataclass field: the
    # fields are the compiled scene's tensors.
    shard = None

    def to(self, device):
        """A copy of the scene (and its shard) on `device`."""
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            kw[f.name] = (filterlib.FilterTables(*(x.to(device) for x in v)) if f.name == "filt"
                          else texlib.to_device(v, device) if f.name == "tex" else v.to(device))
        return Scene(**kw).with_shard(None if self.shard is None else self.shard.to(device))

    def with_shard(self, shard):
        """A copy of the scene that traverses `shard` (a SceneShard or None)
        for its triangles."""
        out = copy.copy(self)
        out.shard = shard
        return out

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
    bvh_ninst: int                # instance rows of a two-level table (0: one level)
    bvh_iterb: int                # two-level traversal's iteration bound (0: one level)
    bvh_leaves: tuple             # two-level: (first, end) leaf rows of the static
                                  # triangles, then of each instance's prototype
                                  # (the plain traversal's sweeps; () one level)
    sph_partial: bool             # some sphere is clipped (zmin/zmax/phimax)
    dsk_partial: bool             # some disk is clipped (phimax)
    layered: bool                 # some material is coated: make_bsdf builds
                                  # the layered parameters (K7)
    volumetric: bool              # media or material-less interfaces: the
                                  # integrators take their medium branches
    textured: bool                # textured material slots or mix materials:
                                  # a bounce evaluates them (K13)
    mutations_per_pixel: int      # MLT: mutations per pixel of a frame


def scene_from_arrays(arrays, meta, device):
    """Scene + SceneMeta from a {field: array} mapping, e.g. the JAX
    package's `SceneArrays` converted field by field with np.asarray (its
    `filt` may be a FilterTables or a dict). `meta` is any object with the
    SceneMeta attributes; bvh_nint/bvh_depth/bvh_ninst/bvh_iterb and
    sph_partial/dsk_partial come from the JAX zero-byte markers
    `arrays['bvh_nint']`, `['bvh_depth']`, `['bvh_ninst']`, `['bvh_iterb']`,
    `['sph_partial_marker']`, `['dsk_partial_marker']` and layered from
    `['lay_marker']` when present. The JAX package has no bvh_leaves: a
    two-level scene needs them in `meta`; one level takes (). `arrays['tex']`
    is a TexArrays of arrays (absent or None: no textures); a meta without
    `textured` (the JAX package's) takes it from that table and the
    material types."""
    device = torch.device(device)
    kw = {}
    get = arrays.get if hasattr(arrays, "get") else (lambda k: None)
    for f in fields(Scene):
        if f.name == "tex":
            tex = get("tex")
            kw["tex"] = texlib.to_device(texlib.empty_arrays() if tex is None else tex, device)
            continue
        v = arrays[f.name]
        if f.name == "filt":
            items = v._asdict() if hasattr(v, "_asdict") else dict(v)
            kw["filt"] = filterlib.FilterTables(
                **{k: torch.as_tensor(np.array(items[k])).to(device)
                   for k in filterlib.FilterTables._fields})
        else:
            kw[f.name] = torch.as_tensor(np.array(v)).to(device)
    m = {f.name: getattr(meta, f.name, None) for f in fields(SceneMeta)}
    for marker in ("bvh_nint", "bvh_depth", "bvh_ninst", "bvh_iterb"):
        a = get(marker)
        if a is not None and np.ndim(a) == 2:
            m[marker] = int(np.shape(a)[0])
    for name, marker in (("sph_partial", "sph_partial_marker"),
                         ("dsk_partial", "dsk_partial_marker"), ("layered", "lay_marker")):
        if get(marker) is not None:
            m[name] = np.shape(get(marker))[0] > 0
    if m["bvh_leaves"] is None and m["bvh_ninst"] == 0:
        m["bvh_leaves"] = ()
    if m["textured"] is None:
        m["textured"] = bool(kw["tex"].type.shape[0] > 0 or (kw["mat_type"] == bd.MAT_MIX).any())
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
    """Host compile -> ({field: numpy array} for every Scene field, `filt` a
    FilterTables and `tex` a textures.TexArrays of them, SceneMeta)."""
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
    tri_med = np.asarray(b.tri_med, np.int32).reshape(T, 2)
    tri_newpos = np.arange(T, dtype=np.int32)
    instances, protos = b.instances, b.protos
    n_inst = len(instances)
    inst_w2o = np.zeros((0, 12), f32)
    inst_o2w = np.zeros((0, 12), f32)
    inst_swap = np.zeros((0,), f32)
    bvh_ninst = bvh_iterb = 0
    bvh_leaves = ()
    inst_bounds = []
    bvh = None

    if n_inst:
        # ---- two-level BVH (JAX compile.py:318-383): a top tree over the
        # static triangles and the instances' boxes, one shared tree per
        # prototype in object space; the columns are concatenated as
        # [static | proto 0 | proto 1 ...] (prototype rows carry no light)
        o2w = np.stack([np.asarray(ins["o2w"], np.float64).reshape(3, 4) for ins in instances])
        o2w[:, :, 3] -= cam_pos                       # render space
        inst_proto = [ins["proto"] for ins in instances]
        bvh = bvhlib.build_two_level(tp, [p["P"] for p in protos], inst_proto, o2w)
        bvh_ninst, bvh_iterb = int(bvh.n_inst), min(int(bvh.iter_bound), 2 ** 24)
        bvh_leaves = bvh.leaf_ranges[:1] + tuple(bvh.leaf_ranges[1 + p] for p in inst_proto)

        def cat(static, key):
            return np.concatenate([static] + [p[key] for p in protos], axis=0)

        tp, tn, tuv, has_n, tri_mat, tri_rev = (
            cat(tp, "P"), cat(tn, "N"), cat(tuv, "UV"), cat(has_n, "has_n"),
            cat(tri_mat, "mat"), cat(tri_rev, "rev"))
        tri_light = np.concatenate([tri_light, np.full(tp.shape[0] - T, -1, np.int32)])
        # prototypes carry no media (the builder refuses them)
        tri_med = np.concatenate([tri_med, np.full((tp.shape[0] - T, 2), -1, np.int32)])
        m4 = np.tile(np.eye(4), (n_inst, 1, 1))
        m4[:, :3, :4] = o2w
        inst_w2o = np.linalg.inv(m4)[:, :3, :4].reshape(n_inst, 12).astype(f32)
        inst_o2w = o2w.reshape(n_inst, 12).astype(f32)
        inst_swap = np.array([1.0 if ins["swap"] else 0.0 for ins in instances], f32)
        # the instances' world boxes count in the scene bounds
        for i, p in enumerate(inst_proto):
            P = protos[p]["P"].reshape(-1, 3)
            inst_bounds.append(np.stack(bvhlib._transform_aabb(P.min(0), P.max(0), o2w[i])))
    elif T >= bvhlib.MIN_TRIS_FOR_BVH:
        bvh = bvhlib.build_bvh(tp[:, 0], tp[:, 1], tp[:, 2])

    if bvh is not None:
        n_pad = int(bvh.n_padded)
        static_rows = (bvh.src >= 0) & (bvh.src < T)
        tri_newpos[bvh.src[static_rows]] = np.nonzero(static_rows)[0].astype(np.int32)

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
    # as in the JAX package (on a two-level table the static rows, which
    # tri_newpos names, and the instances' world boxes), plus the quadrics'
    # bounding boxes
    if n_inst:
        all_pts = ([tp[tri_newpos].reshape(-1, 3)] if T else []) + inst_bounds
    else:
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
        inst_w2o=inst_w2o, inst_o2w=inst_o2w, inst_swap=inst_swap,
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
        med_sigma_a=(np.stack([m["sigma_a"] for m in b.media]).astype(f32) if b.media
                     else np.zeros((0, cie.LAMBDA_RANGE), f32)),
        med_sigma_s=(np.stack([m["sigma_s"] for m in b.media]).astype(f32) if b.media
                     else np.zeros((0, cie.LAMBDA_RANGE), f32)),
        med_g=np.array([m["g"] for m in b.media], f32),
        tri_med=tri_med,
        sph_med=col(b.spheres, "med", (2,), np.int32),
        dsk_med=col(b.disks, "med", (2,), np.int32),
        camera_medium=np.asarray(b.camera_medium, np.int32),
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
        mat_mix_m1=np.array([m.mix_m1 for m in mats], np.int32),
        mat_mix_m2=np.array([m.mix_m2 for m in mats], np.int32),
        mat_mix_amount=np.array([m.mix_amount for m in mats], f32),
        mat_refl_tex=np.array([m.refl_tex for m in mats], np.int32),
        mat_trans_tex=np.array([m.trans_tex for m in mats], np.int32),
        mat_urough_tex=np.array([m.urough_tex for m in mats], np.int32),
        mat_vrough_tex=np.array([m.vrough_tex for m in mats], np.int32),
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
        lt_medium=np.array([l.medium for l in lights], np.int32),
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
    # the texture nodes (JAX compile.py:464, the same camera position)
    arrays["tex"] = texlib.build_tex_arrays(b.textures, b._search_dir, cam_pos=cam_pos)
    # footprint-aware texture lookups' camera deltas (JAX compile.py:777-783)
    cam = SimpleNamespace(**{k: torch.as_tensor(arrays[k]) for k in (
        "camera_from_raster", "render_from_camera", "camera_lens_radius",
        "camera_focal_distance")})
    arrays["cam_ray_deltas"] = torch.stack(
        differentials.pixel_ray_deltas(cam, resolution[0])).numpy()
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
        bvh_ninst=bvh_ninst,
        bvh_iterb=bvh_iterb,
        bvh_leaves=bvh_leaves,
        sph_partial=any(sp["partial"] for sp in b.spheres),
        dsk_partial=any(dk["partial"] for dk in b.disks),
        layered=any(m.type in (bd.MAT_COATED_DIFFUSE, bd.MAT_COATED_CONDUCTOR) for m in mats),
        volumetric=bool(b.media or any(m < 0 for m in b.tri_mat)
                        or any(sp["mat"] < 0 for sp in b.spheres)),
        textured=bool(b.textures) or any(m.type == bd.MAT_MIX for m in mats),
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
