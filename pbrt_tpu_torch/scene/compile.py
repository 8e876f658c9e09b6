"""Scene compiler: SceneBuilder output -> `Scene` tensors + `SceneMeta`.

Counterpart of pbrt_tpu/scene/compile.py, as host numpy with no JAX: the
same render-space conversion (world translated so the camera sits at the
origin), the same SAH wide BVH and leaf-order reordering, material/light
tables, power-proportional light alias table and filter tables, so every
array comes out equal to the JAX package's `SceneArrays` field of the same
name. `Scene` holds only the fields the path integrator on triangle scenes
reads; the JAX package's zero-byte shape markers become plain ints of
`SceneMeta`.
"""
from dataclasses import dataclass, fields

import numpy as np
import torch

from pbrt_tpu_torch.accel import bvh as bvhlib
from pbrt_tpu_torch.filters import filters as filterlib
from pbrt_tpu_torch.geometry import transform as tf
from pbrt_tpu_torch.scene import builder as bd
from pbrt_tpu_torch.spectral import cie, colorspace as cspace, rgb2spec
from pbrt_tpu_torch.utils.device import resolve_device


@dataclass
class Scene:
    """Device tensors of a compiled scene (render space)."""

    # triangles, in BVH leaf order (padding rows are degenerate zeros)
    tri_p0: torch.Tensor         # (T, 3) f32
    tri_p1: torch.Tensor
    tri_p2: torch.Tensor
    tri_rec: torch.Tensor        # (T, 27) f32 packed hit record
                                 # [n0 n1 n2 uv0 uv1 uv2 mat light rev has_n
                                 #  med_in med_out dpdu dpdv]
    bvh_rows: torch.Tensor       # (n_int + P, 72) f32 unified node/leaf table
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
    spec_table: torch.Tensor     # (NS, 471) f32
    # lights (triangle area lights)
    lt_type: torch.Tensor        # (L,) i32
    lt_emission: torch.Tensor    # (L, 471) f32
    lt_scale: torch.Tensor       # (L,)
    lt_twosided: torch.Tensor    # (L,) bool
    lt_tri: torch.Tensor         # (L,) i32 leaf-order emitter triangle
    lt_pmf: torch.Tensor         # (L,)
    lt_alias_rows: torch.Tensor  # (L, 3) [q, alias, pmf]
    filt: filterlib.FilterTables  # of tensors
    # camera (render space)
    camera_from_raster: torch.Tensor  # (4, 4)
    render_from_camera: torch.Tensor  # (4, 4)
    camera_lens_radius: torch.Tensor  # ()
    camera_focal_distance: torch.Tensor
    scene_radius: torch.Tensor   # ()
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
    n_lights: int
    filter_kind: str
    film_imaging_ratio: float
    film_out_matrix: np.ndarray   # (3, 3) output RGB from sensor XYZ
    bvh_nint: int                 # internal BVH rows (leaf chunk c = row n_int + c)
    bvh_depth: int                # deepest internal chain (traversal stack bound)


def scene_from_arrays(arrays, meta, device):
    """Scene + SceneMeta from a {field: array} mapping, e.g. the JAX
    package's `SceneArrays` converted field by field with np.asarray (its
    `filt` may be a FilterTables or a dict). `meta` is any object with the
    SceneMeta attributes; bvh_nint/bvh_depth come from the JAX zero-byte
    markers `arrays['bvh_nint']`/`['bvh_depth']` when present."""
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
    for marker in ("bvh_nint", "bvh_depth"):
        a = arrays.get(marker) if hasattr(arrays, "get") else None
        if a is not None and np.ndim(a) == 2:
            m[marker] = int(np.shape(a)[0])
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


def alias_table_build(values):
    """Vose's O(N) alias table (reference alias_table.cu:9-104):
    weights (N,) -> (q (N,) f32, alias (N,) i32, pdf (N,) f32)."""
    values = np.asarray(values, np.float64).reshape(-1)
    n = values.size
    total = values.sum()
    if total <= 0:
        return (np.ones(n, np.float32), np.arange(n, dtype=np.int32),
                np.full(n, 1.0 / n, np.float32))
    pdf = values / total
    scaled = pdf * n
    q = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        q[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        q[i] = 1.0
        alias[i] = i
    return q.astype(np.float32), alias, pdf.astype(np.float32)


def compile_arrays(b: bd.SceneBuilder, spp_override=None):
    """Host compile -> ({field: numpy array} for every Scene field, SceneMeta)."""
    f32 = np.float32

    # ---- camera / render space
    world_from_camera = np.linalg.inv(b.camera["camera_from_world"])
    cam_pos = world_from_camera[:3, 3]
    render_from_world = np.linalg.inv(tf.translate(*cam_pos))
    render_from_camera = render_from_world @ world_from_camera
    resolution = (b.film["xresolution"], b.film["yresolution"])
    camera_from_raster = build_perspective_matrices(b.camera["fov"], resolution)

    # ---- triangles -> BVH leaf order
    T = len(b.tri_p)
    if T < bvhlib.MIN_TRIS_FOR_BVH:
        raise bd._later(f"scenes under {bvhlib.MIN_TRIS_FOR_BVH} triangles "
                        "(the dense triangle kernel K3)", "plain cornell")
    tp = np.stack(b.tri_p) - cam_pos
    has_n = np.array([n is not None for n in b.tri_n])
    tn = np.stack([n if n is not None else np.zeros((3, 3)) for n in b.tri_n])
    tuv = np.stack([u if u is not None else np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])
                    for u in b.tri_uv])
    tri_mat = np.asarray(b.tri_mat, np.int32).reshape(T)
    tri_light = np.asarray(b.tri_light, np.int32).reshape(T)
    tri_rev = np.asarray(b.tri_rev, bool).reshape(T)
    tri_med = np.full((T, 2), -1, np.int32)

    bvh = bvhlib.build_bvh(tp[:, 0], tp[:, 1], tp[:, 2])
    n_pad = int(bvh.n_padded)
    live = bvh.src >= 0
    tri_newpos = np.empty(T, np.int32)
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

    NS = max(1, len(b.spectra_rows))
    spec_table = np.zeros((NS, cie.LAMBDA_RANGE), f32)
    for i, row in enumerate(b.spectra_rows):
        spec_table[i] = row

    # ---- lights: triangle area lights, power-proportional pmf
    # (reference PowerLightSampler, power_light_sampler.cu)
    L = len(b.lights)
    power = np.zeros(L)
    for i, l in enumerate(b.lights):
        le = float(np.mean(l.emission_dense)) * l.scale
        p = tp[tri_newpos[l.tri_index]]
        area = 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
        power[i] = np.pi * (2.0 if l.two_sided else 1.0) * area * le
    if power.sum() <= 0:
        power = np.ones(L)
    lt_pmf = (power / power.sum()).astype(f32) if L else np.zeros((0,), f32)
    if L:
        lt_q, lt_alias, _ = alias_table_build(lt_pmf)
        lt_alias_rows = np.stack([lt_q, lt_alias.astype(f32), lt_pmf], axis=1).astype(f32)
    else:
        lt_alias_rows = np.zeros((0, 3), f32)

    # ---- scene bounds -> epsilon (reference scene_builder.cu:914-918)
    pts = tp[:T].reshape(-1, 3)
    center = 0.5 * (pts.min(0) + pts.max(0))
    radius = float(np.linalg.norm(pts - center, axis=-1).max())

    filter_kind, _, filt = filterlib.build_filter(b.filter)

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

    arrays = dict(
        tri_p0=tp[:, 0].astype(f32), tri_p1=tp[:, 1].astype(f32),
        tri_p2=tp[:, 2].astype(f32), tri_rec=tri_rec, bvh_rows=bvh.rows,
        mat_type=mat_type,
        mat_refl_c=mat_refl_c.astype(f32), mat_trans_c=mat_trans_c.astype(f32),
        mat_urough=np.array([m.uroughness for m in mats], f32),
        mat_vrough=np.array([m.vroughness for m in mats], f32),
        mat_remap=np.array([m.remap_roughness for m in mats]),
        mat_eta=np.array([m.eta_float for m in mats], f32),
        mat_eta_spec=np.array([m.eta_spec for m in mats], np.int32),
        mat_k_spec=np.array([m.k_spec for m in mats], np.int32),
        mat_refl_mode=mat_refl_mode,
        spec_table=spec_table,
        lt_type=np.array([l.type for l in b.lights], np.int32),
        lt_emission=(np.stack([l.emission_dense for l in b.lights]).astype(f32)
                     if L else np.zeros((0, cie.LAMBDA_RANGE), f32)),
        lt_scale=np.array([l.scale for l in b.lights], f32),
        lt_twosided=np.array([l.two_sided for l in b.lights], bool),
        lt_tri=np.array([tri_newpos[l.tri_index] for l in b.lights], np.int32),
        lt_pmf=lt_pmf, lt_alias_rows=lt_alias_rows,
        filt=filt,
        camera_from_raster=np.asarray(camera_from_raster, f32),
        render_from_camera=np.asarray(render_from_camera, f32),
        camera_lens_radius=np.asarray(b.camera.get("lensradius", 0.0), f32),
        camera_focal_distance=np.asarray(b.camera.get("focaldistance", 1e6), f32),
        scene_radius=np.asarray(radius, f32),
        ray_offset_scale=np.asarray(min(radius * 1e-5, 1e-3) / max(radius, 1e-6), f32),
    )
    spp = spp_override or b.sampler["pixelsamples"]
    if b.sampler["type"] == "stratified" and int(round(spp ** 0.5)) ** 2 != spp:
        spp = max(1, int(spp ** 0.5)) ** 2  # nearest square below
    meta = SceneMeta(
        resolution=resolution,
        spp=spp,
        sampler=b.sampler["type"],
        integrator=b.integrator["type"],
        max_depth=b.integrator.get("maxdepth", 5),
        filename=b.film["filename"],
        n_tris=T,
        n_lights=L,
        filter_kind=filter_kind,
        film_imaging_ratio=exposure * iso / 100.0,
        film_out_matrix=np.asarray(out_space.rgb_from_xyz @ xyz_from_sensor, f32),
        bvh_nint=int(bvh.n_int),
        bvh_depth=int(bvh.max_depth),
    )
    return arrays, meta


def compile_scene(b: bd.SceneBuilder, spp_override=None, device=None):
    """-> (Scene on `device`, SceneMeta). device=None means "cuda"."""
    device = resolve_device(device)
    arrays, meta = compile_arrays(b, spp_override)
    scene, _ = scene_from_arrays(arrays, meta, device)
    return scene, meta


def load_scene(path, device=None):
    """Parse and compile a .pbrt file -> (Scene, SceneMeta)."""
    device = resolve_device(device)
    return compile_scene(bd.SceneBuilder().parse_file(path), device=device)
