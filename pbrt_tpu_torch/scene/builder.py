"""SceneBuilder: .pbrt token stream -> host-side scene description.

Counterpart of pbrt_tpu/scene/builder.py (reference scene/scene_builder.cu),
trimmed to what the port renders so far: transforms, the perspective camera,
film, independent/stratified samplers, box and mitchell pixel filters,
attribute blocks, diffuse/conductor/dielectric/diffusetransmission,
coateddiffuse/coatedconductor and mix materials, named materials
(MakeNamedMaterial/NamedMaterial), textures (Texture: constant, scale, mix,
checkerboard, directionmix and imagemap nodes under uv, spherical,
cylindrical or planar mappings) bound to the material parameters the JAX
package textures, diffuse area lights, distant/uniform-infinite/spot light
sources, triangle meshes (trianglemesh, loopsubdiv, plymesh), full or
partial spheres and disks, named coordinate systems, object instancing
(ObjectBegin/ObjectEnd/ObjectInstance: small scenes replay the definition's
geometry, larger ones share it as a prototype under a two-level BVH, as the
JAX package does), homogeneous participating media (MakeNamedMedium,
MediumInterface: each shape's inside and outside medium, each light's and
the camera's medium) and material-less interfaces (Material "interface",
"none" or "": material -1). Every other directive, type or parameter that
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
from pbrt_tpu_torch.textures import textures as texlib

# material type codes (device dispatch; same values as the JAX package);
# a material-less interface is material -1
MAT_INTERFACE = -1
MAT_DIFFUSE = 0
MAT_CONDUCTOR = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_TRANSMISSION = 3
MAT_COATED_DIFFUSE = 4
MAT_COATED_CONDUCTOR = 5
MAT_MIX = 6

LIGHT_AREA = 0
LIGHT_DISTANT = 1
LIGHT_UNIFORM_INFINITE = 2
# 3 is the image-infinite light of the JAX package (a later slice)
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
    # mix: two material indices (neither a mix nor an interface) and the
    # amount, the probability of the second
    mix_m1: int = -1
    mix_m2: int = -1
    mix_amount: float = 0.5
    # texture slots (node index into SceneBuilder.textures, -1: the constant)
    refl_tex: int = -1
    trans_tex: int = -1
    urough_tex: int = -1
    vrough_tex: int = -1


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
    # the graphics state's outside medium where the light was made: light
    # subpaths start their walk in it
    medium: int = -1


@dataclass
class GraphicsState:
    ctm: np.ndarray = field(default_factory=tf.identity)
    material_idx: int = 0
    area_light: Optional[AreaLightSpec] = None
    reverse_orientation: bool = False
    inside_medium: int = -1
    outside_medium: int = -1


def _swaps_handedness(m):
    return np.linalg.det(np.asarray(m)[:3, :3]) < 0


def _no_textures(pd: ParameterDict, mtype, names):
    """Refuse a texture bound to a parameter that the JAX package reads as a
    constant only (it would fall back to the default there)."""
    for n in names:
        if pd.get_texture_name(n) is not None:
            raise ValueError(f"texture parameter {n!r} of material {mtype!r} is not supported "
                             f"(the JAX package textures only reflectance, transmittance and "
                             f"roughness slots)")


class SceneBuilder:
    def __init__(self):
        self.state = GraphicsState()
        self.stack = []
        self.in_world = False
        self._search_dir = "."

        self.materials = [MaterialSpec(type=MAT_DIFFUSE, reflectance_rgb=np.array([0.5, 0.5, 0.5]))]
        self.named_materials = {}
        self.float_textures = {}     # name -> (class, params, ctm)
        self.spectrum_textures = {}
        self.textures = []           # list[TexSpec], the flat node table
        self._texture_index = {}     # (name, is_spectrum) -> node index
        self.spectra_rows = []  # list of (471,) float64
        self._spectra_index = {}
        self.tri_p = []
        self.tri_n = []
        self.tri_uv = []
        self.tri_mat = []
        self.tri_light = []
        self.tri_rev = []
        self.tri_med = []    # (inside, outside) medium per triangle, -1 vacuum
        self.spheres = []    # dict(center, radius, mat, light, rev, rot, zmin, zmax, phimax,
                             #      partial, med)
        self.disks = []      # dict(center, normal, radius, inner, mat, light, xaxis, yaxis,
                             #      ..., med)
        self.lights = []
        self.media = []              # dict(sigma_a, sigma_s dense rows, g)
        self.named_media = {}
        self.camera_medium = -1      # the outside medium at WorldBegin
        # object instancing (reference scene_builder.cu:809-876): a definition
        # records its shape chunks in the space of its definition; each
        # ObjectInstance replays them under the instance CTM (flatten) or,
        # for its triangles, records (prototype, o2w, swap) for compile.py's
        # two-level BVH. `instancing` is set before parsing:
        #   "auto"    - flatten while the scene stays under AUTO_FLATTEN_TRIS
        #               triangles, then share the definition as a prototype;
        #   "flatten" - always replay the geometry;
        #   "bvh"     - always share triangles through the two-level BVH.
        # Quadrics always flatten.
        self.object_defs = {}        # name -> dict(tris=[chunk], spheres=[], disks=[])
        self.active_object = None    # name while recording a definition
        self.named_coordinate_systems = {}
        self.instancing = "auto"
        self.protos = []             # per-prototype per-triangle columns
        self.instances = []          # dict(proto, o2w (3, 4), swap)
        self._proto_index = {}       # definition name -> prototype index

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

    # ------------------------------------------------------------ textures

    def _const_tex(self, is_spectrum, rgb=None, value=0.0):
        self.textures.append(texlib.TexSpec(kind="constant", is_spectrum=is_spectrum, rgb=rgb,
                                            value=value))
        return len(self.textures) - 1

    def _child_tex(self, pd: ParameterDict, name, is_spectrum, default=None):
        """A tex1/tex2/amount parameter that may name a texture, hold an
        rgb or float constant, or be absent -> node index or -1."""
        tn = pd.get_texture_name(name)
        if tn is not None:
            return self.texture_index(tn, is_spectrum)
        if is_spectrum:
            rgb = pd.get_rgb(name)
            if rgb is not None:
                return self._const_tex(True, rgb=np.asarray(rgb))
            v = pd.get_float(name, None)
            if v is not None:
                return self._const_tex(True, rgb=np.array([v, v, v]))
        else:
            v = pd.get_float(name, None)
            if v is not None:
                return self._const_tex(False, value=float(v))
        if default is not None:
            if is_spectrum:
                return self._const_tex(True, rgb=np.array([default] * 3))
            return self._const_tex(False, value=float(default))
        return -1

    def texture_index(self, name, is_spectrum):
        """A named texture -> its node index in self.textures, built (with its
        children) at first use (reference base/spectrum_texture.cu:15-50,
        base/float_texture.cu:11-24; JAX builder.py:297-367)."""
        key = (name, is_spectrum)
        if key in self._texture_index:
            return self._texture_index[key]
        table = self.spectrum_textures if is_spectrum else self.float_textures
        if name not in table:
            # pbrt lets a spectrum slot name a float texture and the reverse
            other = self.float_textures if is_spectrum else self.spectrum_textures
            if name not in other:
                raise ValueError(f"unknown texture {name!r}")
            table = other
        tclass, pd, tex_ctm = table[name]
        mapping = pd.get_string("mapping", "uv")
        if mapping not in ("uv", "spherical", "cylindrical", "planar"):
            raise ValueError(f"texture mapping {mapping!r} not supported")
        spec = texlib.TexSpec(
            kind=tclass, is_spectrum=is_spectrum,
            uscale=pd.get_float("uscale", 1.0), vscale=pd.get_float("vscale", 1.0),
            udelta=pd.get_float("udelta", 0.0), vdelta=pd.get_float("vdelta", 0.0),
            mapping=mapping,
            v1=np.asarray(pd.get_vector3("v1", np.array([1.0, 0.0, 0.0]))),
            v2=np.asarray(pd.get_vector3("v2", np.array([0.0, 1.0, 0.0]))),
            # the world -> texture transform of the Texture's declaration
            tex_from_world=np.linalg.inv(tex_ctm))
        if tclass == "constant":
            vtype = pd.type_of("value") if "value" in pd else None
            rgb = pd.get_rgb("value") if vtype in ("rgb", "color") else None
            v = pd.get_float("value", 1.0) if rgb is None else None
            if is_spectrum:
                spec.rgb = np.asarray(rgb) if rgb is not None else np.array([v, v, v])
            else:
                spec.value = float(rgb[0] if v is None else v)
        elif tclass == "imagemap":
            spec.filename = pd.get_string("filename")
            spec.image_scale = pd.get_float("scale", 1.0)
            spec.invert = pd.get_bool("invert", False)
            spec.wrap = pd.get_string("wrap", "repeat")
        elif tclass == "scale":
            spec.tex1 = self._child_tex(pd, "tex", is_spectrum, default=1.0)
            spec.amount_tex = self._child_tex(pd, "scale", False)
            spec.amount = pd.get_float("scale", 1.0)
        elif tclass == "mix":
            spec.tex1 = self._child_tex(pd, "tex1", is_spectrum, default=0.0)
            spec.tex2 = self._child_tex(pd, "tex2", is_spectrum, default=1.0)
            spec.amount_tex = self._child_tex(pd, "amount", False)
            spec.amount = pd.get_float("amount", 0.5)
        elif tclass in ("checkerboard", "directionmix"):
            spec.tex1 = self._child_tex(pd, "tex1", is_spectrum, default=0.0)
            spec.tex2 = self._child_tex(pd, "tex2", is_spectrum, default=1.0)
            if tclass == "directionmix":
                d = pd.get_vector3("dir", np.array([0.0, 1.0, 0.0]))
                spec.dir = tex_ctm[:3, :3] @ np.asarray(d)
        else:
            raise ValueError(f"texture class {tclass!r} not supported")
        self.textures.append(spec)
        idx = len(self.textures) - 1
        self._texture_index[key] = idx
        return idx

    def _tex_slot(self, pd: ParameterDict, name, spectrum=True):
        """The node of a material parameter bound to a texture, else -1."""
        tn = pd.get_texture_name(name)
        return -1 if tn is None else self.texture_index(tn, spectrum)

    def _rough_slots(self, pd: ParameterDict):
        """(urough node, vrough node): each of u/vroughness, else roughness."""
        r = self._tex_slot(pd, "roughness", False)
        return tuple(self._tex_slot(pd, n, False) if pd.get_texture_name(n) else r
                     for n in ("uroughness", "vroughness"))

    # --------------------------------------------------------------- media

    def make_medium(self, pd: ParameterDict) -> int:
        """Homogeneous medium (reference medium/homogeneous_medium.cu:15-38):
        sigma_a and sigma_s unbounded spectra (an RGB through the sigmoid at
        twice its largest component, a spectrum row, or a constant, 1 by
        default), times `scale`; the HG asymmetry g -> its table index."""
        def sigma_of(name, default):
            rgb = pd.get_rgb(name)
            if rgb is not None:
                from pbrt_tpu_torch.spectral import rgb2spec

                m = float(np.max(rgb))
                sc = 2.0 * m if m > 0 else 1.0
                c = rgb2spec.rgb_to_coefficients_np(
                    np.asarray(rgb) / sc if m > 0 else np.zeros(3)).astype(np.float64)
                lam = cie.lambdas()
                x = (c[0] * lam + c[1]) * lam + c[2]
                return sc * (0.5 * x / np.sqrt(1.0 + x * x) + 0.5)
            idx = self.resolve_spectrum(pd, name)
            if idx is not None:
                return self.spectra_rows[idx]
            return np.full(cie.LAMBDA_RANGE, pd.get_float(name, default))

        scale = pd.get_float("scale", 1.0)
        self.media.append(dict(sigma_a=sigma_of("sigma_a", 1.0) * scale,
                               sigma_s=sigma_of("sigma_s", 1.0) * scale,
                               g=pd.get_float("g", 0.0)))
        return len(self.media) - 1

    def _media(self):
        return (self.state.inside_medium, self.state.outside_medium)

    # ------------------------------------------------------------ materials

    def make_material(self, mtype: str, pd: ParameterDict) -> int:
        """MaterialSpec factory (reference base/material.cu:34-76); a
        material-less interface is MAT_INTERFACE."""
        if mtype in ("", "interface", "none"):
            return MAT_INTERFACE
        if mtype == "diffuse":
            spec = MaterialSpec(
                type=MAT_DIFFUSE,
                reflectance_rgb=np.asarray(pd.get_rgb("reflectance", np.array([0.5, 0.5, 0.5]))),
                refl_tex=self._tex_slot(pd, "reflectance"),
            )
        elif mtype == "conductor":
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
                refl_tex=self._tex_slot(pd, "reflectance"),
            )
            spec.urough_tex, spec.vrough_tex = self._rough_slots(pd)
        elif mtype == "dielectric":
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
            spec.urough_tex, spec.vrough_tex = self._rough_slots(pd)
        elif mtype == "diffusetransmission":
            spec = MaterialSpec(
                type=MAT_DIFFUSE_TRANSMISSION,
                reflectance_rgb=np.asarray(pd.get_rgb("reflectance", np.array([0.25, 0.25, 0.25]))),
                transmittance_rgb=np.asarray(
                    pd.get_rgb("transmittance", np.array([0.25, 0.25, 0.25]))),
                refl_tex=self._tex_slot(pd, "reflectance"),
                trans_tex=self._tex_slot(pd, "transmittance"),
            )
        elif mtype == "coateddiffuse":
            _no_textures(pd, mtype, ["roughness", "uroughness", "vroughness", "thickness", "g",
                                     "albedo"])
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
                refl_tex=self._tex_slot(pd, "reflectance"),
            )
        elif mtype == "coatedconductor":
            _no_textures(pd, mtype, ["interface.roughness", "interface.uroughness",
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
            names = pd._get("materials", {"string"}, None)
            if names is None or len(names) != 2:
                raise ValueError("mix material needs 2 named materials")
            m1, m2 = (self.named_materials[n] for n in names)
            for n, m in zip(names, (m1, m2)):
                if m < 0 or self.materials[m].type == MAT_MIX:
                    raise ValueError(f"mix material of {n!r}: a mix of a material-less interface "
                                     f"or of another mix is not supported")
            spec = MaterialSpec(type=MAT_MIX, mix_m1=m1, mix_m2=m2,
                                mix_amount=pd.get_float("amount", 0.5))
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
        if self.active_object is not None:
            self._no_area_light_in_definition()
            self.object_defs[self.active_object]["tris"].append(
                dict(P=Pw, idx=np.asarray(idx), N=Nw, UV=UV, mat=self.state.material_idx,
                     rev=rev, med=self._media()))
            return
        self._append_tris(Pw, idx, Nw, UV, self.state.material_idx, rev, self._media(),
                          al=self.state.area_light)

    def _append_tris(self, Pw, idx, Nw, UV, mat, rev, med, al=None):
        for tri in idx:
            li = -1
            if al is not None:
                self.lights.append(LightSpec(
                    type=LIGHT_AREA, emission_dense=al.emission_dense,
                    scale=al.scale, two_sided=al.two_sided,
                    tri_index=len(self.tri_p), medium=self.state.outside_medium))
                li = len(self.lights) - 1
            self.tri_p.append(Pw[tri])
            self.tri_n.append(None if Nw is None else Nw[tri])
            self.tri_uv.append(None if UV is None else UV[tri])
            self.tri_mat.append(mat)
            self.tri_light.append(li)
            self.tri_rev.append(rev)
            self.tri_med.append(med)

    def _no_area_light_in_definition(self):
        if self.state.area_light is not None:
            raise ValueError("area lights inside ObjectBegin/ObjectEnd are not supported")

    # "flatten" mode: the most triangles a scene may replay
    MAX_FLATTENED_TRIS = 4_000_000
    # "auto" mode: replay instances while the scene stays under this many
    # triangles, then share the definition as a prototype
    AUTO_FLATTEN_TRIS = 262_144

    def _promote_proto(self, name):
        """Register object_defs[name]'s triangle chunks as a shared
        prototype: per-triangle columns in definition space, read by
        compile.py's two-level BVH branch -> its prototype index."""
        if name in self._proto_index:
            return self._proto_index[name]
        default_uv = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])
        Ps, Ns, UVs, hn, mats, revs = [], [], [], [], [], []
        for c in self.object_defs[name]["tris"]:
            idx = np.asarray(c["idx"]).reshape(-1, 3)
            n = idx.shape[0]
            Ps.append(np.asarray(c["P"])[idx])
            has = c["N"] is not None
            Ns.append(np.asarray(c["N"])[idx] if has else np.zeros((n, 3, 3)))
            hn.append(np.full(n, has, bool))
            UVs.append(np.asarray(c["UV"])[idx] if c["UV"] is not None
                       else np.tile(default_uv, (n, 1, 1)))
            mats.append(np.full(n, c["mat"], np.int32))
            revs.append(np.full(n, c["rev"], bool))
        self.protos.append(dict(P=np.concatenate(Ps), N=np.concatenate(Ns),
                                UV=np.concatenate(UVs), has_n=np.concatenate(hn),
                                mat=np.concatenate(mats), rev=np.concatenate(revs)))
        self._proto_index[name] = len(self.protos) - 1
        return self._proto_index[name]

    def _emit_instance(self, name):
        """ObjectInstance: the definition under the current CTM (the final
        transform is CTM_instance . CTM_definition, the reference's
        TransformedPrimitive, scene_builder.cu:856-876). Triangles are
        replayed in world space or shared as a prototype (see `instancing`);
        quadrics are always replayed."""
        if name not in self.object_defs:
            raise ValueError(f"ObjectInstance {name!r} not defined")
        ctm = self.state.ctm
        M, t = ctm[:3, :3], ctm[:3, 3]
        inv = np.linalg.inv(ctm)
        swap = _swaps_handedness(ctm)
        d = self.object_defs[name]
        n_new = sum(len(c["idx"]) for c in d["tris"])
        mode = self.instancing
        use_proto = bool(d["tris"]) and (
            mode == "bvh" or (mode == "auto" and (
                name in self._proto_index or len(self.tri_p) + n_new > self.AUTO_FLATTEN_TRIS)))
        if use_proto:
            if any(c["med"] != (-1, -1) or c["mat"] < 0 for c in d["tris"]):
                raise ValueError(
                    f"ObjectInstance {name!r}: a shared (two-level BVH) instance with media or "
                    "material-less interfaces is not supported; use instancing='flatten'")
            self.instances.append(dict(proto=self._promote_proto(name),
                                       o2w=np.asarray(ctm[:3, :4], np.float64).copy(),
                                       swap=bool(swap)))
        else:
            if len(self.tri_p) + n_new > self.MAX_FLATTENED_TRIS:
                raise NotImplementedError(
                    "instancing='flatten' replays past MAX_FLATTENED_TRIS; "
                    "use instancing='auto' or 'bvh' (two-level BVH)")
            for c in d["tris"]:
                Nw = None
                if c["N"] is not None:
                    Nw = c["N"] @ inv[:3, :3]
                    Nw = Nw / np.maximum(np.linalg.norm(Nw, axis=-1, keepdims=True), 1e-30)
                    if swap:
                        Nw = -Nw
                self._append_tris(c["P"] @ M.T + t, c["idx"], Nw, c["UV"], c["mat"],
                                  c["rev"] ^ swap, c["med"])
        sc = abs(np.linalg.det(M)) ** (1.0 / 3.0)
        for s in d["spheres"]:
            rot_i = M / max(sc, 1e-30)
            if not np.allclose(rot_i @ rot_i.T, np.eye(3), atol=1e-4):
                raise ValueError("sphere instances support uniform scaling only")
            # a mirrored instance flips orientation, as rev ^ swap for triangles
            self.spheres.append(dict(
                s, center=np.asarray(s["center"]) @ M.T + t, radius=s["radius"] * sc,
                rot=rot_i @ s["rot"], zmin=s["zmin"] * sc, zmax=s["zmax"] * sc,
                rev=s["rev"] ^ swap))
        for dk in d["disks"]:
            n2 = dk["normal"] @ inv[:3, :3]
            n2 = n2 / max(np.linalg.norm(n2), 1e-30)
            if swap:
                n2 = -n2  # a mirrored disk shades and emits on its other side
            xax = M @ dk["xaxis"]
            xax = xax / max(np.linalg.norm(xax), 1e-30)
            self.disks.append(dict(dk, center=np.asarray(dk["center"]) @ M.T + t, normal=n2,
                                   radius=dk["radius"] * sc, inner=dk["inner"] * sc,
                                   xaxis=xax, yaxis=np.cross(n2, xax)))

    def _area_light_of(self, **shape_index):
        """Append the current area light for a quadric -> its index, or -1."""
        al = self.state.area_light
        if al is None:
            return -1
        self.lights.append(LightSpec(type=LIGHT_AREA, emission_dense=al.emission_dense,
                                     scale=al.scale, two_sided=al.two_sided,
                                     medium=self.state.outside_medium, **shape_index))
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
        sphere = dict(
            center=ctm[:3, 3].copy(), radius=radius * s, mat=self.state.material_idx,
            light=-1, rev=bool(self.state.reverse_orientation ^ _swaps_handedness(ctm)),
            rot=rot.astype(np.float64), zmin=z_min * s, zmax=z_max * s,
            phimax=float(phi_max), partial=partial, med=self._media())
        if self.active_object is not None:
            self._no_area_light_in_definition()
            self.object_defs[self.active_object]["spheres"].append(sphere)
            return
        sphere["light"] = self._area_light_of(sphere_index=len(self.spheres))
        self.spheres.append(sphere)

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
        disk = dict(
            center=center, normal=n, radius=radius * sc, inner=inner * sc,
            mat=self.state.material_idx, light=-1, xaxis=xax, yaxis=yax,
            phimax=float(phi_max), partial=partial, med=self._media())
        if self.active_object is not None:
            self._no_area_light_in_definition()
            self.object_defs[self.active_object]["disks"].append(disk)
            return
        disk["light"] = self._area_light_of(disk_index=len(self.disks))
        self.disks.append(disk)

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
                direction=d / np.linalg.norm(d), medium=self.state.outside_medium))
        elif ltype == "infinite":
            if pd.get_string("filename", None) is not None:
                raise _later("image infinite lights", "image infinite light")
            dense, photometric = self.illuminant_dense(pd, "L")
            self.lights.append(LightSpec(
                type=LIGHT_UNIFORM_INFINITE, emission_dense=dense,
                scale=pd.get_float("scale", 1.0) / photometric,
                medium=self.state.outside_medium))
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
                cos_falloff_end=cos_end, medium=self.state.outside_medium))
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
                self.camera_medium = self.state.outside_medium
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
                tname, ttype, tclass = (t.value for t in tokens[i:i + 3])
                i += 3
                pd, i = parse_parameters(tokens, i)
                table = self.float_textures if ttype == "float" else self.spectrum_textures
                table[tname] = (tclass, pd, self.state.ctm.copy())
                continue
            if kw == "MakeNamedMaterial":
                mname = tokens[i].value
                i += 1
                pd, i = parse_parameters(tokens, i)
                self.named_materials[mname] = self.make_material(pd.get_string("type"), pd)
                continue
            if kw == "NamedMaterial":
                self.state.material_idx = self.named_materials[tokens[i].value]
                i += 1
                continue
            if kw == "MakeNamedMedium":
                mname = tokens[i].value
                i += 1
                pd, i = parse_parameters(tokens, i)
                if pd.get_string("type", "homogeneous") != "homogeneous":
                    raise ValueError("only homogeneous media are supported (like the reference)")
                self.named_media[mname] = self.make_medium(pd)
                continue
            if kw == "MediumInterface":
                inside = tokens[i].value
                i += 1
                outside = ""
                if i < len(tokens) and tokens[i].kind == "str":
                    outside = tokens[i].value
                    i += 1
                self.state.inside_medium = self.named_media.get(inside, -1)
                self.state.outside_medium = self.named_media.get(outside, -1)
                continue
            if kw == "CoordinateSystem":
                self.named_coordinate_systems[tokens[i].value] = self.state.ctm.copy()
                i += 1
                continue
            if kw == "CoordSysTransform":
                name = tokens[i].value
                i += 1
                if name not in self.named_coordinate_systems:
                    raise ValueError(f"coordinate system {name!r} not defined")
                # restores the saved CTM (reference scene_builder.cu:308-317)
                self.state.ctm = self.named_coordinate_systems[name].copy()
                continue
            if kw == "ObjectBegin":
                if self.active_object is not None:
                    raise ValueError("ObjectBegin inside an instance definition")
                name = tokens[i].value
                i += 1
                self.stack.append(copy.deepcopy(self.state))
                self.object_defs[name] = dict(tris=[], spheres=[], disks=[])
                self.active_object = name
                continue
            if kw == "ObjectEnd":
                if self.active_object is None:
                    raise ValueError("ObjectEnd without ObjectBegin")
                self.active_object = None
                self.state = self.stack.pop()
                continue
            if kw == "ObjectInstance":
                name = tokens[i].value
                i += 1
                if self.active_object is not None:
                    raise ValueError("ObjectInstance inside an instance definition")
                self._emit_instance(name)
                continue
            raise ValueError(f"unknown directive {kw!r}")
