"""SceneBuilder: .pbrt token stream -> host-side scene description.

Counterpart of pbrt_tpu/scene/builder.py (reference scene/scene_builder.cu),
trimmed to what the port renders so far: transforms, the perspective camera,
film, independent/stratified samplers, box and mitchell pixel filters,
attribute blocks, diffuse/conductor/dielectric/diffusetransmission and
coateddiffuse/coatedconductor materials, diffuse area lights, distant/uniform-infinite/spot light
sources, triangle meshes (trianglemesh, loopsubdiv, plymesh) and full or
partial spheres and disks. Every other directive, type or parameter that
would change the image raises NotImplementedError naming the slice of the
port that will bring it; nothing is silently dropped. The integrator type is
recorded as written; the compiler refuses what the port cannot render, so a
scene file written for another integrator can be rendered with an override.
"""
import copy
import functools
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from pbrt_tpu_torch.scene import lexer as lx
from pbrt_tpu_torch.scene.params import ParameterDict, parse_parameters
from pbrt_tpu_torch.geometry import transform as tf
from pbrt_tpu_torch.spectral import cie, spectra

# material type codes (device dispatch; same values as the JAX package)
MAT_DIFFUSE = 0
MAT_CONDUCTOR = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_TRANSMISSION = 3
MAT_COATED_DIFFUSE = 4
MAT_COATED_CONDUCTOR = 5

LIGHT_AREA = 0
LIGHT_DISTANT = 1
LIGHT_UNIFORM_INFINITE = 2
# 3 is the image-infinite light of the JAX package (textures slice)
LIGHT_SPOT = 4

PATH_INTEGRATORS = ("path", "volpath", "megakernelpath")
MLT_INTEGRATORS = ("mltpath", "mlt", "mltbdpt")
RENDERED_INTEGRATORS = PATH_INTEGRATORS + ("bdpt",) + MLT_INTEGRATORS


def _later(what, slice_name):
    return NotImplementedError(
        f"{what} is not ported to pbrt_tpu_torch yet (planned slice: {slice_name})")


def check_integrator(itype):
    """Raise for an integrator the port does not render yet."""
    if itype not in RENDERED_INTEGRATORS:
        if itype in ("ambientocclusion", "surfacenormal"):
            raise _later(f"integrator {itype!r}", "AOV")
        raise ValueError(f"unknown integrator {itype!r}")


@functools.lru_cache(None)
def named_spectra():
    """Built-in named spectra (reference scene_builder.cu:100-136): metal
    eta/k and glass eta as dense rows, unnormalized piecewise-linear."""
    import pathlib

    data = pathlib.Path(__file__).resolve().parent.parent / "data"
    out = {}
    metal = np.load(data / "metal.npz")
    for m in ["Ag", "Al", "Au", "Cu"]:
        out[f"metal-{m}-eta"] = spectra.from_interleaved(metal[f"{m}_eta"], False)
        out[f"metal-{m}-k"] = spectra.from_interleaved(metal[f"{m}_k"], False)
    glass = np.load(data / "glass.npz")
    out["glass-BK7"] = spectra.from_interleaved(glass["GlassBK7_eta"], False)
    out["glass-SF11"] = spectra.from_interleaved(glass["GlassSF11_eta"], False)
    return out


@dataclass
class MaterialSpec:
    type: int
    reflectance_rgb: Optional[np.ndarray] = None
    eta_spec: int = -1                      # dense spectrum row
    k_spec: int = -1
    eta_float: float = 1.5
    uroughness: float = 0.0
    vroughness: float = 0.0
    remap_roughness: bool = True
    transmittance_rgb: Optional[np.ndarray] = None
    # coated (layered) materials; max_depth and n_samples are parsed but the
    # walk runs 10 steps of 1 sample, as the JAX package's make_bsdf does
    thickness: float = 0.01
    interface_eta: float = 1.5
    g: float = 0.0
    albedo_rgb: Optional[np.ndarray] = None
    max_depth: int = 10
    n_samples: int = 1
    # a coated conductor's base: resolved, but (as in the JAX package) not
    # carried into the material table
    conductor_eta_spec: int = -1
    conductor_k_spec: int = -1
    crough_u: float = 0.0
    crough_v: float = 0.0


@dataclass
class AreaLightSpec:
    emission_dense: np.ndarray  # (471,)
    scale: float
    two_sided: bool


@dataclass
class LightSpec:
    type: int
    emission_dense: np.ndarray
    scale: float
    two_sided: bool = False
    tri_index: int = -1
    sphere_index: int = -1
    disk_index: int = -1
    # distant / spot
    direction: Optional[np.ndarray] = None
    position: Optional[np.ndarray] = None
    cos_falloff_start: float = 0.0
    cos_falloff_end: float = 0.0


@dataclass
class GraphicsState:
    ctm: np.ndarray = field(default_factory=tf.identity)
    material_idx: int = 0
    area_light: Optional[AreaLightSpec] = None
    reverse_orientation: bool = False


def _swaps_handedness(m):
    return np.linalg.det(np.asarray(m)[:3, :3]) < 0


def _no_textures(pd: ParameterDict, names):
    for n in names:
        if pd.get_texture_name(n) is not None:
            raise _later(f"texture parameter {n!r}", "textures")


class SceneBuilder:
    def __init__(self):
        self.state = GraphicsState()
        self.stack = []
        self.in_world = False
        self._search_dir = "."

        self.materials = [MaterialSpec(type=MAT_DIFFUSE, reflectance_rgb=np.array([0.5, 0.5, 0.5]))]
        self.spectra_rows = []  # list of (471,) float64
        self._spectra_index = {}
        self.tri_p = []
        self.tri_n = []
        self.tri_uv = []
        self.tri_mat = []
        self.tri_light = []
        self.tri_rev = []
        self.spheres = []    # dict(center, radius, mat, light, rot, zmin, zmax, phimax, partial)
        self.disks = []      # dict(center, normal, radius, inner, mat, light, xaxis, yaxis, ...)
        self.lights = []

        self.film = {"xresolution": 1920, "yresolution": 1080, "filename": "out.png"}
        self.camera = {"type": "perspective", "fov": 90.0, "camera_from_world": tf.identity()}
        self.sampler = {"type": "stratified", "pixelsamples": 4}
        self.integrator = {"type": "path", "maxdepth": 5}
        self.filter = {"type": "mitchell"}

    # ------------------------------------------------------------- spectra

    def add_spectrum_row(self, dense, key=None):
        if key is not None and key in self._spectra_index:
            return self._spectra_index[key]
        idx = len(self.spectra_rows)
        self.spectra_rows.append(np.asarray(dense, dtype=np.float64))
        if key is not None:
            self._spectra_index[key] = idx
        return idx

    def resolve_spectrum(self, pd: ParameterDict, name):
        """A 'spectrum'-typed parameter -> dense row index, or None."""
        raw = pd.get_spectrum_raw(name)
        if raw is None:
            if name in pd and pd.type_of(name) == "blackbody":
                raise _later("blackbody spectra", "lights")
            return None
        kind, val = raw
        if kind == "named":
            reg = named_spectra()
            if val not in reg:
                raise ValueError(f"unknown named spectrum {val!r}")
            return self.add_spectrum_row(reg[val], key=("named", val))
        return self.add_spectrum_row(spectra.from_interleaved(val, False))

    def illuminant_dense(self, pd: ParameterDict, name):
        """Illuminant spectrum parameter -> (dense emission row, photometric
        norm) (reference rgb_illuminant_spectrum.cu:27-28)."""
        rgb = pd.get_rgb(name)
        if rgb is not None:
            from pbrt_tpu_torch.spectral import rgb2spec

            s = 2.0 * float(np.max(rgb))
            if s == 0.0:
                return np.zeros(cie.LAMBDA_RANGE), cie.CIE_Y_INTEGRAL
            c = rgb2spec.rgb_to_coefficients_np(rgb / s).astype(np.float64)
            lam = cie.lambdas()
            x = (c[0] * lam + c[1]) * lam + c[2]
            sig = 0.5 * x / np.sqrt(1.0 + x * x) + 0.5
            dense = s * sig * cie.illum_d65()
            return dense, cie.inner_product(cie.illum_d65(), cie.Y())
        spec_idx = self.resolve_spectrum(pd, name)
        if spec_idx is not None:
            dense = self.spectra_rows[spec_idx]
            return dense, cie.inner_product(dense, cie.Y())
        dense = cie.illum_d65()
        return dense, cie.inner_product(dense, cie.Y())

    # ------------------------------------------------------------ materials

    def make_material(self, mtype: str, pd: ParameterDict) -> int:
        """MaterialSpec factory (reference base/material.cu:34-76)."""
        if mtype in ("", "interface", "none"):
            raise _later("material-less interfaces", "media")
        if mtype == "diffuse":
            _no_textures(pd, ["reflectance"])
            spec = MaterialSpec(
                type=MAT_DIFFUSE,
                reflectance_rgb=np.asarray(pd.get_rgb("reflectance", np.array([0.5, 0.5, 0.5]))),
            )
        elif mtype == "conductor":
            _no_textures(pd, ["reflectance", "roughness", "uroughness", "vroughness"])
            eta_idx = self.resolve_spectrum(pd, "eta")
            k_idx = self.resolve_spectrum(pd, "k")
            refl = pd.get_rgb("reflectance")
            if refl is None and eta_idx is None:
                eta_idx = self.add_spectrum_row(named_spectra()["metal-Cu-eta"],
                                                key=("named", "metal-Cu-eta"))
            if refl is None and k_idx is None:
                k_idx = self.add_spectrum_row(named_spectra()["metal-Cu-k"],
                                              key=("named", "metal-Cu-k"))
            rough = pd.get_float("roughness", 0.0)
            spec = MaterialSpec(
                type=MAT_CONDUCTOR,
                reflectance_rgb=None if refl is None else np.asarray(refl),
                eta_spec=-1 if eta_idx is None else eta_idx,
                k_spec=-1 if k_idx is None else k_idx,
                uroughness=pd.get_float("uroughness", rough),
                vroughness=pd.get_float("vroughness", rough),
                remap_roughness=pd.get_bool("remaproughness", True),
            )
        elif mtype == "dielectric":
            _no_textures(pd, ["roughness", "uroughness", "vroughness"])
            eta_f = (pd.get_float("eta", None)
                     if ("eta" not in pd or pd.type_of("eta") == "float")
                     else None)
            eta_idx = None
            if eta_f is None:
                eta_idx = self.resolve_spectrum(pd, "eta")
            rough = pd.get_float("roughness", 0.0)
            spec = MaterialSpec(
                type=MAT_DIELECTRIC,
                eta_float=1.5 if eta_f is None else float(eta_f),
                eta_spec=-1 if eta_idx is None else eta_idx,
                uroughness=pd.get_float("uroughness", rough),
                vroughness=pd.get_float("vroughness", rough),
                remap_roughness=pd.get_bool("remaproughness", True),
            )
        elif mtype == "diffusetransmission":
            _no_textures(pd, ["reflectance", "transmittance"])
            spec = MaterialSpec(
                type=MAT_DIFFUSE_TRANSMISSION,
                reflectance_rgb=np.asarray(pd.get_rgb("reflectance", np.array([0.25, 0.25, 0.25]))),
                transmittance_rgb=np.asarray(
                    pd.get_rgb("transmittance", np.array([0.25, 0.25, 0.25]))),
            )
        elif mtype == "coateddiffuse":
            _no_textures(pd, ["reflectance", "roughness", "uroughness", "vroughness",
                              "thickness", "g", "albedo"])
            rough = pd.get_float("roughness", 0.0)
            spec = MaterialSpec(
                type=MAT_COATED_DIFFUSE,
                reflectance_rgb=np.asarray(pd.get_rgb("reflectance", np.array([0.5, 0.5, 0.5]))),
                uroughness=pd.get_float("uroughness", rough),
                vroughness=pd.get_float("vroughness", rough),
                remap_roughness=pd.get_bool("remaproughness", True),
                thickness=pd.get_float("thickness", 0.01),
                interface_eta=pd.get_float("eta", 1.5),
                g=pd.get_float("g", 0.0),
                albedo_rgb=np.asarray(pd.get_rgb("albedo", np.array([0.0, 0.0, 0.0]))),
                max_depth=pd.get_integer("maxdepth", 10),
                n_samples=pd.get_integer("nsamples", 1),
            )
        elif mtype == "coatedconductor":
            _no_textures(pd, ["interface.roughness", "interface.uroughness",
                              "interface.vroughness", "conductor.roughness",
                              "conductor.uroughness", "conductor.vroughness", "reflectance",
                              "thickness", "g", "albedo"])
            irough = pd.get_float("interface.roughness", 0.0)
            crough = pd.get_float("conductor.roughness", 0.0)
            ceta = self.resolve_spectrum(pd, "conductor.eta")
            ck = self.resolve_spectrum(pd, "conductor.k")
            if ceta is None:
                ceta = self.add_spectrum_row(named_spectra()["metal-Cu-eta"],
                                             key=("named", "metal-Cu-eta"))
            if ck is None:
                ck = self.add_spectrum_row(named_spectra()["metal-Cu-k"],
                                           key=("named", "metal-Cu-k"))
            spec = MaterialSpec(
                type=MAT_COATED_CONDUCTOR,
                uroughness=pd.get_float("interface.uroughness", irough),
                vroughness=pd.get_float("interface.vroughness", irough),
                remap_roughness=pd.get_bool("remaproughness", True),
                thickness=pd.get_float("thickness", 0.01),
                interface_eta=pd.get_float("interface.eta", 1.5),
                g=pd.get_float("g", 0.0),
                albedo_rgb=np.asarray(pd.get_rgb("albedo", np.array([0.0, 0.0, 0.0]))),
                max_depth=pd.get_integer("maxdepth", 10),
                n_samples=pd.get_integer("nsamples", 1),
                conductor_eta_spec=ceta,
                conductor_k_spec=ck,
                crough_u=pd.get_float("conductor.uroughness", crough),
                crough_v=pd.get_float("conductor.vroughness", crough),
            )
        elif mtype == "mix":
            raise _later("material 'mix'", "textures")
        else:
            raise ValueError(f"material type {mtype!r} not implemented")
        self.materials.append(spec)
        return len(self.materials) - 1

    # -------------------------------------------------------------- shapes

    def add_triangle_mesh(self, pd: ParameterDict):
        """reference shapes/triangle_mesh.cu + base/shape.cu trianglemesh."""
        P = pd.get_points3("P")
        indices = pd.get_integers("indices")
        if P is None or indices is None:
            raise ValueError("trianglemesh needs P and indices")
        self._emit_mesh(P, np.asarray(indices).reshape(-1, 3),
                        pd.get_normals("N"), pd.get_points2("uv"))

    def _emit_mesh(self, P, idx, N=None, UV=None):
        ctm = self.state.ctm
        Pw = (P @ ctm[:3, :3].T) + ctm[:3, 3]
        Nw = None
        if N is not None:
            inv = np.linalg.inv(ctm)
            Nw = N @ inv[:3, :3]
            Nw = Nw / np.maximum(np.linalg.norm(Nw, axis=-1, keepdims=True), 1e-30)
        rev = self.state.reverse_orientation ^ _swaps_handedness(ctm)
        if Nw is not None and rev:
            Nw = -Nw
        al = self.state.area_light
        for tri in idx:
            li = -1
            if al is not None:
                self.lights.append(LightSpec(
                    type=LIGHT_AREA, emission_dense=al.emission_dense,
                    scale=al.scale, two_sided=al.two_sided,
                    tri_index=len(self.tri_p)))
                li = len(self.lights) - 1
            self.tri_p.append(Pw[tri])
            self.tri_n.append(None if Nw is None else Nw[tri])
            self.tri_uv.append(None if UV is None else UV[tri])
            self.tri_mat.append(self.state.material_idx)
            self.tri_light.append(li)
            self.tri_rev.append(rev)

    def _area_light_of(self, **shape_index):
        """Append the current area light for a quadric -> its index, or -1."""
        al = self.state.area_light
        if al is None:
            return -1
        self.lights.append(LightSpec(type=LIGHT_AREA, emission_dense=al.emission_dense,
                                     scale=al.scale, two_sided=al.two_sided, **shape_index))
        return len(self.lights) - 1

    def add_sphere(self, pd: ParameterDict):
        """reference shapes/sphere.cu:13-26: radius, optional zmin/zmax
        clipping and phimax (partial spheres); rotation and uniform scale."""
        radius = pd.get_float("radius", 1.0)
        ctm = self.state.ctm
        s = abs(np.linalg.det(ctm[:3, :3])) ** (1.0 / 3.0)
        rot = ctm[:3, :3] / max(s, 1e-30)
        if not np.allclose(rot @ rot.T, np.eye(3), atol=1e-4):
            raise NotImplementedError("sphere with non-uniform-scale transform not supported yet")
        z_min = max(min(pd.get_float("zmin", -radius), radius), -radius)
        z_max = min(max(pd.get_float("zmax", radius), -radius), radius)
        if z_min > z_max:
            z_min, z_max = z_max, z_min
        phi_max = np.deg2rad(np.clip(pd.get_float("phimax", 360.0), 0.0, 360.0))
        partial = (z_min > -radius + 1e-6 * radius or z_max < radius - 1e-6 * radius
                   or phi_max < 2.0 * np.pi - 1e-6)
        if partial and self.state.area_light is not None:
            raise NotImplementedError("partial spheres as area lights not supported")
        li = self._area_light_of(sphere_index=len(self.spheres))
        self.spheres.append(dict(
            center=ctm[:3, 3].copy(), radius=radius * s, mat=self.state.material_idx,
            light=li, rot=rot.astype(np.float64), zmin=z_min * s, zmax=z_max * s,
            phimax=float(phi_max), partial=partial))

    def add_disk(self, pd: ParameterDict):
        """reference shapes/disk.cu: annulus in the z = height plane of the
        object frame, optional phimax < 360 (clipped on the in-plane angle
        from the object x axis)."""
        phi_max = np.deg2rad(np.clip(pd.get_float("phimax", 360.0), 0.0, 360.0))
        ctm = self.state.ctm
        height = pd.get_float("height", 0.0)
        radius = pd.get_float("radius", 1.0)
        inner = pd.get_float("innerradius", 0.0)
        sc = abs(np.linalg.det(ctm[:3, :3])) ** (1.0 / 3.0)
        n = ctm[:3, :3] @ np.array([0.0, 0.0, 1.0])
        n = n / max(np.linalg.norm(n), 1e-12)
        xax = ctm[:3, :3] @ np.array([1.0, 0.0, 0.0])
        xax = xax / max(np.linalg.norm(xax), 1e-12)
        yax = np.cross(n, xax)
        partial = phi_max < 2.0 * np.pi - 1e-6
        if partial and self.state.area_light is not None:
            raise NotImplementedError("partial disks as area lights not supported")
        center = ctm[:3, 3] + n * height * sc
        if self.state.reverse_orientation ^ _swaps_handedness(ctm):
            n = -n
        li = self._area_light_of(disk_index=len(self.disks))
        self.disks.append(dict(
            center=center, normal=n, radius=radius * sc, inner=inner * sc,
            mat=self.state.material_idx, light=li, xaxis=xax, yaxis=yax,
            phimax=float(phi_max), partial=partial))

    def _add_light_source(self, ltype, pd: ParameterDict):
        """LightSource (reference lights/*.cu constructors)."""
        ctm = self.state.ctm

        def world(p):
            return p @ ctm[:3, :3].T + ctm[:3, 3]

        frm = world(pd.get_point3("from", np.zeros(3)))
        to = world(pd.get_point3("to", np.array([0.0, 0.0, 1.0])))
        if ltype == "distant":
            dense, photometric = self.illuminant_dense(pd, "L")
            d = frm - to  # direction TOWARDS the light
            self.lights.append(LightSpec(
                type=LIGHT_DISTANT, emission_dense=dense,
                scale=pd.get_float("scale", 1.0) / photometric,
                direction=d / np.linalg.norm(d)))
        elif ltype == "infinite":
            if pd.get_string("filename", None) is not None:
                raise _later("image infinite lights", "textures")
            dense, photometric = self.illuminant_dense(pd, "L")
            self.lights.append(LightSpec(
                type=LIGHT_UNIFORM_INFINITE, emission_dense=dense,
                scale=pd.get_float("scale", 1.0) / photometric))
        elif ltype == "spot":
            dense, photometric = self.illuminant_dense(pd, "I")
            scale = pd.get_float("scale", 1.0) / photometric
            d = to - frm
            cone = pd.get_float("coneangle", 30.0)
            delta = pd.get_float("conedeltaangle", 5.0)
            cos_end = float(np.cos(np.deg2rad(cone)))
            cos_start = float(np.cos(np.deg2rad(cone - delta)))
            # "power" overrides the intensity scale: phi = scale * k_e with
            # k_e the cone integral of the smoothstep falloff
            # (reference spot_light.cu:29-34)
            phi_v = pd.get_float("power", -1.0)
            if phi_v > 0:
                scale *= phi_v / (2.0 * np.pi * ((1.0 - cos_start) + (cos_start - cos_end) / 2.0))
            self.lights.append(LightSpec(
                type=LIGHT_SPOT, emission_dense=dense, scale=scale, position=frm,
                direction=d / np.linalg.norm(d), cos_falloff_start=cos_start,
                cos_falloff_end=cos_end))
        else:
            raise ValueError(f"light {ltype!r} not supported")

    # ------------------------------------------------------------- parsing

    def parse_file(self, path):
        tokens = lx.tokenize_file(path)
        self._search_dir = os.path.dirname(os.path.abspath(path))
        self.parse_tokens(tokens)
        return self

    def parse_tokens(self, tokens):
        i = 0
        n = len(tokens)
        while i < n:
            tok = tokens[i]
            if tok.kind != lx.KEYWORD:
                raise ValueError(f"expected directive, got {tok}")
            kw = tok.value
            i += 1

            if kw == "WorldBegin":
                self.in_world = True
                self.state.ctm = tf.identity()
                continue
            if kw == "AttributeBegin":
                self.stack.append(copy.deepcopy(self.state))
                continue
            if kw == "AttributeEnd":
                self.state = self.stack.pop()
                continue
            if kw == "ReverseOrientation":
                self.state.reverse_orientation = not self.state.reverse_orientation
                continue
            if kw == "Identity":
                self.state.ctm = tf.identity()
                continue

            if kw == "LookAt":
                vals = [tokens[i + k].value for k in range(9)]
                i += 9
                self.state.ctm = self.state.ctm @ np.linalg.inv(
                    tf.lookat(vals[0:3], vals[3:6], vals[6:9]))
                continue
            if kw == "Translate":
                vals = [tokens[i + k].value for k in range(3)]
                i += 3
                self.state.ctm = self.state.ctm @ tf.translate(*vals)
                continue
            if kw == "Scale":
                vals = [tokens[i + k].value for k in range(3)]
                i += 3
                self.state.ctm = self.state.ctm @ tf.scale(*vals)
                continue
            if kw == "Rotate":
                vals = [tokens[i + k].value for k in range(4)]
                i += 4
                self.state.ctm = self.state.ctm @ tf.rotate(*vals)
                continue
            if kw in ("Transform", "ConcatTransform"):
                assert tokens[i].kind == lx.LBRACKET
                vals = [tokens[i + 1 + k].value for k in range(16)]
                i += 18
                m = np.asarray(vals, dtype=np.float64).reshape(4, 4).T
                self.state.ctm = m if kw == "Transform" else self.state.ctm @ m
                continue

            if kw == "Include":
                fname = tokens[i].value
                i += 1
                sub = lx.tokenize_file(os.path.join(self._search_dir, fname))
                tokens = tokens[:i] + sub + tokens[i:]
                n = len(tokens)
                continue

            if kw == "Camera":
                ctype = tokens[i].value
                i += 1
                pd, i = parse_parameters(tokens, i)
                if ctype != "perspective":
                    raise ValueError(f"camera {ctype!r} not supported")
                self.camera = {
                    "type": ctype,
                    "fov": pd.get_float("fov", 90.0),
                    "lensradius": pd.get_float("lensradius", 0.0),
                    "focaldistance": pd.get_float("focaldistance", 1e6),
                    "camera_from_world": self.state.ctm.copy(),
                }
                continue
            if kw == "Film":
                i += 1
                pd, i = parse_parameters(tokens, i)
                self.film = {
                    "xresolution": pd.get_integer("xresolution", 1920),
                    "yresolution": pd.get_integer("yresolution", 1080),
                    "filename": pd.get_string("filename", "out.png"),
                    "iso": pd.get_float("iso", 100.0),
                    "whitebalance": pd.get_float("whitebalance", 0.0),
                    "exposuretime": pd.get_float("exposuretime", 1.0),
                }
                continue
            if kw == "Sampler":
                stype = tokens[i].value
                i += 1
                pd, i = parse_parameters(tokens, i)
                if stype not in ("independent", "stratified"):
                    raise ValueError(f"sampler {stype!r} not supported")
                self.sampler = {"type": stype,
                                "pixelsamples": pd.get_integer("pixelsamples", 4)}
                continue
            if kw == "Integrator":
                itype = tokens[i].value
                i += 1
                pd, i = parse_parameters(tokens, i)
                # MLT reads "mutationsperpixel" only, as the JAX package does
                self.integrator = {"type": itype,
                                   "maxdepth": pd.get_integer("maxdepth", 5),
                                   "mutations": pd.get_integer("mutationsperpixel", 100)}
                continue
            if kw == "PixelFilter":
                ftype = tokens[i].value
                i += 1
                pd, i = parse_parameters(tokens, i)
                if ftype not in ("box", "mitchell"):
                    raise _later(f"pixel filter {ftype!r}", "filters")
                self.filter = {
                    "type": ftype,
                    "xradius": pd.get_float("xradius", None),
                    "yradius": pd.get_float("yradius", None),
                    "B": pd.get_float("B", 1.0 / 3.0),
                    "C": pd.get_float("C", 1.0 / 3.0),
                }
                continue

            if kw == "Material":
                mtype = tokens[i].value
                i += 1
                pd, i = parse_parameters(tokens, i)
                self.state.material_idx = self.make_material(mtype, pd)
                continue

            if kw == "AreaLightSource":
                ltype = tokens[i].value
                i += 1
                pd, i = parse_parameters(tokens, i)
                if ltype != "diffuse":
                    raise ValueError("only diffuse area lights supported")
                dense, photometric = self.illuminant_dense(pd, "L")
                self.state.area_light = AreaLightSpec(
                    emission_dense=dense,
                    scale=pd.get_float("scale", 1.0) / photometric,
                    two_sided=pd.get_bool("twosided", False))
                continue

            if kw == "Shape":
                stype = tokens[i].value
                i += 1
                pd, i = parse_parameters(tokens, i)
                if stype == "trianglemesh":
                    self.add_triangle_mesh(pd)
                elif stype == "loopsubdiv":
                    from pbrt_tpu_torch.scene.subdivide import loop_subdivide

                    P = pd.get_points3("P")
                    idx = np.asarray(pd.get_integers("indices"), np.int32).reshape(-1, 3)
                    P2, idx2, N2 = loop_subdivide(np.asarray(P), idx,
                                                  pd.get_integer("levels", 3))
                    self._emit_mesh(P2, idx2, N2, None)
                elif stype == "sphere":
                    self.add_sphere(pd)
                elif stype == "disk":
                    self.add_disk(pd)
                elif stype == "plymesh":
                    from pbrt_tpu_torch.scene.ply import read_ply

                    P, idx, N, UV = read_ply(os.path.join(self._search_dir,
                                                          pd.get_string("filename")))
                    self._emit_mesh(P, idx, N, UV)
                else:
                    raise ValueError(f"shape {stype!r} not supported yet")
                continue

            if kw == "LightSource":
                ltype = tokens[i].value
                i += 1
                pd, i = parse_parameters(tokens, i)
                self._add_light_source(ltype, pd)
                continue
            if kw == "Texture":
                raise _later("textures", "textures")
            if kw in ("MakeNamedMaterial", "NamedMaterial"):
                raise _later("named materials", "textures (mix and named materials)")
            if kw in ("MakeNamedMedium", "MediumInterface"):
                raise _later("participating media", "media")
            if kw in ("ObjectBegin", "ObjectEnd", "ObjectInstance"):
                raise _later("object instancing", "instancing")
            if kw in ("CoordinateSystem", "CoordSysTransform"):
                raise _later(kw, "CLI and operations")
            raise ValueError(f"unknown directive {kw!r}")
