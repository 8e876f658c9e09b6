"""Textures: a flat node table evaluated per lane (counterpart of
pbrt_tpu/textures/textures.py; reference textures/, base/float_texture.cu,
base/spectrum_texture.cu).

Every texture is a row of one node table. A combinator node (scale, mix,
checkerboard, directionmix) references leaf children (constant or
imagemap); deeper nests are refused at build time, as the JAX package does,
so evaluation is a fixed two-level walk. Images live in one atlas (TOTAL, 3)
of linear RGB with per-image (offset, width, height, wrap); a bilinear
fetch is four texel reads (gpu_image.cu:272-294). An image leaf's RGB is
lifted to a spectrum after the fetch (scale, invert, clamp, then the
rgb2spec table: spectrum_image_texture.cu:20-28).

The hot path of a textured scene, per shading lane: the mix material's
choice (materials.resolve_mix), then each of the chosen material's four
slots (reflectance, transmittance, u and v roughness) whose node is >= 0
evaluated into make_bsdf's overrides. `eval_lanes` is that, K13: on CUDA
tensors one launch of csrc/texture.cu `pbrt_tex_eval` (`eval_lanes_cuda`),
on CPU tensors its plain version `eval_lanes_plain`, which is also the
oracle of the kernel on the card. The plain parts of the integrators call
the plain version themselves.
"""
import ctypes
import math
import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from pbrt_tpu_torch.spectral import rgb2spec, spectra

# node types
TEX_CONST = 0
TEX_IMAGE = 1
TEX_SCALE = 2
TEX_MIX = 3
TEX_CHECKER = 4
TEX_DIRMIX = 5

# wrap modes (gpu_image.cu remap_pixel_coord); octahedralsphere clamps
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_BLACK = 2
WRAP_OCTAHEDRAL = 3
_WRAP_NAMES = {"repeat": WRAP_REPEAT, "clamp": WRAP_CLAMP, "black": WRAP_BLACK,
               "octahedralsphere": WRAP_OCTAHEDRAL}

MAP_UV = 0
MAP_SPHERICAL = 1
MAP_CYLINDRICAL = 2
MAP_PLANAR = 3
_MAP_NAMES = {"uv": MAP_UV, "spherical": MAP_SPHERICAL, "cylindrical": MAP_CYLINDRICAL,
              "planar": MAP_PLANAR}

# the slots of a material row and the bits of TexLanes.mask
SLOT_REFL, SLOT_TRANS, SLOT_UROUGH, SLOT_VROUGH = 1, 2, 4, 8


@dataclass
class TexSpec:
    """One texture node as parsed by the SceneBuilder (host only)."""

    kind: str                       # constant/imagemap/scale/mix/checkerboard/directionmix
    is_spectrum: bool
    rgb: Optional[np.ndarray] = None     # spectrum constant
    value: float = 0.0                   # float constant
    filename: str = ""
    image_scale: float = 1.0
    invert: bool = False
    wrap: str = "repeat"
    # mapping (reference textures/texture_mapping_2d): uv, or spherical /
    # cylindrical / planar coordinates of the hit point in texture space
    mapping: str = "uv"
    uscale: float = 1.0
    vscale: float = 1.0
    udelta: float = 0.0
    vdelta: float = 0.0
    v1: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 0.0]))
    v2: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    tex_from_world: np.ndarray = field(default_factory=lambda: np.eye(4))
    # combinators: children are indices into the same spec list (or -1)
    tex1: int = -1
    tex2: int = -1
    amount: float = 0.5
    amount_tex: int = -1            # float texture of a mix's amount / a scale
    dir: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))


class ImageAtlas(NamedTuple):
    data: object     # (TOTAL, 3) f32 linear rgb
    offset: object   # (NI,) i32
    width: object    # (NI,) i32
    height: object   # (NI,) i32
    wrap: object     # (NI,) i32


class TexArrays(NamedTuple):
    """The node table (spectrum and float nodes share it; a slot's kind says
    which it is), numpy arrays or tensors. A table of 0 rows: no textures."""

    type: object      # (NT,) i32
    coeffs: object    # (NT, 3) sigmoid coefficients (spectrum constant)
    cscale: object    # (NT,) constant scale (unbounded rgb) / float value
    img: object       # (NT,) i32 image index or -1
    img_scale: object  # (NT,)
    img_invert: object  # (NT,) bool
    child: object     # (NT, 2) i32
    amount: object    # (NT,)
    amount_tex: object  # (NT,) i32 float-texture node of the amount
    uvmap: object     # (NT, 4) su, sv, du, dv
    mapkind: object   # (NT,) i32: 0 uv, 1 spherical, 2 cylindrical, 3 planar
    tex_from_render: object  # (NT, 4, 4) position -> texture space
    map_v1: object    # (NT, 3) planar s axis
    map_v2: object    # (NT, 3) planar t axis
    dir: object       # (NT, 3) directionmix axis
    imgs: ImageAtlas


def build_tex_arrays(specs, scene_root, cam_pos=None):
    """Host: list[TexSpec] -> TexArrays of numpy arrays (JAX textures.py:118):
    loads the images into the atlas, fits the constants' rgb coefficients.
    cam_pos: the render-space origin in world coordinates (the geometry is
    emitted relative to the camera; the texture transform maps from there).
    `to_device` makes the tensors."""
    from pbrt_tpu_torch.textures.image import load_image

    NT = len(specs)
    f32 = np.float32
    ttype = np.zeros(NT, np.int32)
    coeffs = np.zeros((NT, 3), f32)
    cscale = np.zeros(NT, f32)
    img = np.full(NT, -1, np.int32)
    img_scale = np.ones(NT, f32)
    img_invert = np.zeros(NT, bool)
    child = np.full((NT, 2), -1, np.int32)
    amount = np.full(NT, 0.5, f32)
    amount_tex = np.full(NT, -1, np.int32)
    uvmap = np.tile(np.array([1.0, 1.0, 0.0, 0.0], f32), (NT, 1))
    tdir = np.tile(np.array([0.0, 1.0, 0.0], f32), (NT, 1))
    mapkind = np.zeros(NT, np.int32)
    tex_from_render = np.tile(np.eye(4, dtype=f32), (max(NT, 1), 1, 1))[:NT]
    map_v1 = np.tile(np.array([1.0, 0.0, 0.0], f32), (NT, 1))
    map_v2 = np.tile(np.array([0.0, 1.0, 0.0], f32), (NT, 1))
    world_from_render = np.eye(4)
    if cam_pos is not None:
        world_from_render[:3, 3] = np.asarray(cam_pos)

    files, file_index = [], {}

    def image_id(fn):
        path = fn if os.path.isabs(fn) else os.path.join(scene_root, fn)
        if path not in file_index:
            file_index[path] = len(files)
            files.append(path)
        return file_index[path]

    kind_codes = {"constant": TEX_CONST, "imagemap": TEX_IMAGE, "scale": TEX_SCALE,
                  "mix": TEX_MIX, "checkerboard": TEX_CHECKER, "directionmix": TEX_DIRMIX}
    for i, s in enumerate(specs):
        ttype[i] = kind_codes[s.kind]
        uvmap[i] = [s.uscale, s.vscale, s.udelta, s.vdelta]
        mapkind[i] = _MAP_NAMES[s.mapping]
        tex_from_render[i] = (s.tex_from_world @ world_from_render).astype(f32)
        map_v1[i] = s.v1
        map_v2[i] = s.v2
        if s.kind == "constant":
            if s.is_spectrum and s.rgb is not None:
                rgb = np.asarray(s.rgb, np.float64)
                m = float(rgb.max())
                if m <= 1.0:
                    coeffs[i] = rgb2spec.rgb_to_coefficients_np(np.clip(rgb, 0, 1))
                    cscale[i] = 1.0
                else:
                    # unbounded rgb: normalized by 2 max (rgb_unbounded_spectrum)
                    coeffs[i] = rgb2spec.rgb_to_coefficients_np(rgb / (2 * m))
                    cscale[i] = 2 * m
            else:
                cscale[i] = s.value
        elif s.kind == "imagemap":
            img[i] = image_id(s.filename)
            img_scale[i] = s.image_scale
            img_invert[i] = s.invert
        else:
            child[i] = [s.tex1, s.tex2]
            amount[i] = s.amount
            amount_tex[i] = s.amount_tex
            tdir[i] = np.asarray(s.dir) / max(np.linalg.norm(s.dir), 1e-9)
            for c in (s.tex1, s.tex2, s.amount_tex):
                if c >= 0 and ttype[c] not in (TEX_CONST, TEX_IMAGE) and c < i:
                    raise ValueError("nested combinator textures unsupported (combinators may "
                                     "only reference constant/imagemap leaves)")

    wrap_by_file = np.zeros(max(1, len(files)), np.int32)
    for i, s in enumerate(specs):
        if s.kind == "imagemap":
            wrap_by_file[img[i]] = _WRAP_NAMES.get(s.wrap, WRAP_REPEAT)
    datas, offsets, widths, heights, total = [], [], [], [], 0
    for path in files:
        im = load_image(path)
        h, w, _ = im.shape
        datas.append(im.reshape(-1, 3))
        offsets.append(total)
        widths.append(w)
        heights.append(h)
        total += h * w
    if not files:
        datas, offsets, widths, heights = [np.zeros((1, 3), f32)], [0], [1], [1]
    atlas = ImageAtlas(data=np.concatenate(datas).astype(f32),
                       offset=np.array(offsets, np.int32), width=np.array(widths, np.int32),
                       height=np.array(heights, np.int32), wrap=wrap_by_file)
    return TexArrays(type=ttype, coeffs=coeffs, cscale=cscale, img=img, img_scale=img_scale,
                     img_invert=img_invert, child=child, amount=amount, amount_tex=amount_tex,
                     uvmap=uvmap, mapkind=mapkind, tex_from_render=tex_from_render,
                     map_v1=map_v1, map_v2=map_v2, dir=tdir, imgs=atlas)


def to_device(tex: TexArrays, device):
    """TexArrays of arrays (numpy, the JAX package's, or tensors) -> tensors
    on `device`."""
    def conv(x):
        return x.to(device) if torch.is_tensor(x) else torch.as_tensor(np.array(x)).to(device)
    return TexArrays(*(conv(x) for x in tex[:-1]), imgs=ImageAtlas(*(conv(x) for x in tex.imgs)))


def empty_arrays():
    """The node table of a scene without textures."""
    return build_tex_arrays([], ".")


# ------------------------------------------------------------ plain version


def _dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2, the kernel's order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _wrap_coord(c, n, wrap):
    """Integer pixel coordinate wrap (gpu_image.cu:20-75) -> (coordinate,
    black: outside the image under the black mode)."""
    rep = torch.remainder(c, torch.clamp(n, min=1))
    clp = torch.minimum(torch.clamp(c, min=0), n - 1)
    out = torch.where(wrap == WRAP_REPEAT, rep, clp)
    black = (wrap == WRAP_BLACK) & ((c < 0) | (c >= n))
    return out, black


def image_bilerp(imgs: ImageAtlas, img_idx, st):
    """Bilinear fetch (gpu_image.cu:272-294): image img_idx (R,) at st (R, 2)
    -> (R, 3)."""
    idx = torch.clamp(img_idx, min=0).long()
    w = imgs.width[idx].long()
    h = imgs.height[idx].long()
    off = imgs.offset[idx].long()
    wrap = imgs.wrap[idx]
    x = st[..., 0] * w.to(torch.float32) - 0.5
    y = st[..., 1] * h.to(torch.float32) - 0.5
    xf, yf = torch.floor(x), torch.floor(y)
    xi, yi = xf.long(), yf.long()
    dx = (x - xf)[..., None]
    dy = (y - yf)[..., None]

    def fetch(cx, cy):
        px, bx = _wrap_coord(cx, w, wrap)
        py, by = _wrap_coord(cy, h, wrap)
        v = imgs.data[off + py * w + px]
        return torch.where((bx | by)[..., None], 0.0, v)

    return ((((1 - dx) * (1 - dy)) * fetch(xi, yi) + (dx * (1 - dy)) * fetch(xi + 1, yi))
            + ((1 - dx) * dy) * fetch(xi, yi + 1)) + (dx * dy) * fetch(xi + 1, yi + 1)


def _mapped_uv(tex: TexArrays, node, uv, p=None):
    """(s, t) by the node's mapping (reference texture_mapping_2d): the
    scaled and offset surface uv, or spherical / cylindrical / planar
    coordinates of the hit point p in the node's texture space."""
    m = tex.uvmap[node]
    st = torch.stack([uv[..., 0] * m[..., 0] + m[..., 2], uv[..., 1] * m[..., 1] + m[..., 3]],
                     -1)
    if p is None:
        return st
    mk = tex.mapkind[node]
    M = tex.tex_from_render[node]
    pt = torch.stack([_dot3(M[:, i, :3], p) + M[:, i, 3] for i in range(3)], -1)
    r_len = torch.sqrt(torch.clamp(_dot3(pt, pt), min=1e-20))
    theta = torch.arccos(torch.clamp(pt[..., 2] / r_len, -1.0, 1.0))
    phi = torch.atan2(pt[..., 1], pt[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    sph = torch.stack([theta / math.pi, phi / (2.0 * math.pi)], -1)
    cyl = torch.stack([phi / (2.0 * math.pi), pt[..., 2]], -1)
    pla = torch.stack([_dot3(pt, tex.map_v1[node]) + m[..., 2],
                       _dot3(pt, tex.map_v2[node]) + m[..., 3]], -1)
    out = torch.where((mk == MAP_SPHERICAL)[..., None], sph, st)
    out = torch.where((mk == MAP_CYLINDRICAL)[..., None], cyl, out)
    return torch.where((mk == MAP_PLANAR)[..., None], pla, out)


def _leaf_rgb_or_value(tex: TexArrays, node, uv, p=None, duv=None):
    """A leaf node -> (type, rgb (R, 3), constant coefficients (R, 3),
    cscale (R,)). duv (R, 4) = (dudx, dvdx, dudy, dvdy): an image fetch
    averages four bilinear taps over the footprint (uv-mapped nodes only)."""
    node_c = torch.clamp(node, min=0).long()
    t = tex.type[node_c]
    st = _mapped_uv(tex, node_c, uv, p)
    st = torch.stack([st[..., 0], 1.0 - st[..., 1]], -1)  # flip v (spectrum_image_texture.cu:18)

    def img_at(st_):
        rgb_ = tex.img_scale[node_c][..., None] * image_bilerp(tex.imgs, tex.img[node_c], st_)
        rgb_ = torch.where(tex.img_invert[node_c][..., None], 1.0 - rgb_, rgb_)
        return torch.clamp(rgb_, min=0.0)

    if duv is None:
        rgb = img_at(st)
    else:
        m = tex.uvmap[node_c]
        is_uv = (tex.mapkind[node_c] == MAP_UV)[..., None].to(torch.float32)
        gx = torch.stack([duv[..., 0] * m[..., 0], duv[..., 1] * m[..., 1]], -1) * is_uv
        gy = torch.stack([duv[..., 2] * m[..., 0], duv[..., 3] * m[..., 1]], -1) * is_uv
        qx, qy = 0.25 * gx, 0.25 * gy
        rgb = 0.25 * (((img_at((st + qx) + qy) + img_at((st + qx) - qy))
                       + img_at((st - qx) + qy)) + img_at((st - qx) - qy))
    return t, rgb, tex.coeffs[node_c], tex.cscale[node_c]


def _leaf_spectrum(tex: TexArrays, node, uv, lam, p=None, duv=None):
    """A leaf -> spectral values (R, 4); 0 where node < 0."""
    t, rgb, coeffs, cscale = _leaf_rgb_or_value(tex, node, uv, p, duv)
    is_img = t == TEX_IMAGE
    c = torch.where(is_img[..., None], rgb2spec.rgb_to_coefficients(torch.clamp(rgb, 0.0, 1.0)),
                    coeffs)
    val = spectra.sigmoid_polynomial(c, lam) * torch.where(is_img, 1.0, cscale)[..., None]
    return torch.where((node < 0)[..., None], 0.0, val)


def _leaf_float(tex: TexArrays, node, uv, default=0.0, p=None, duv=None):
    t, rgb, _, cscale = _leaf_rgb_or_value(tex, node, uv, p, duv)
    v = torch.where(t == TEX_IMAGE, rgb[..., 0], cscale)
    return torch.where(node < 0, default, v)


def _amount(tex: TexArrays, node_c, uv, p):
    """A combinator's amount: its float texture (point-sampled) or constant."""
    at = tex.amount_tex[node_c]
    return torch.where(at >= 0, _leaf_float(tex, at, uv, p=p), tex.amount[node_c])


def eval_spectrum(tex: TexArrays, node, uv, ns, lam, p=None, duv=None):
    """A spectrum texture per lane (JAX textures.py:370): node (R,), uv (R, 2),
    ns (R, 3) the shading normal (directionmix), lam (R, 4), p (R, 3) the hit
    point (non-uv mappings), duv (R, 4) footprints or None -> (R, 4); 0
    where node < 0."""
    node_c = torch.clamp(node, min=0).long()
    t = tex.type[node_c]
    self_val = _leaf_spectrum(tex, node_c, uv, lam, p, duv)
    v1 = _leaf_spectrum(tex, tex.child[node_c, 0], uv, lam, p, duv)
    v2 = _leaf_spectrum(tex, tex.child[node_c, 1], uv, lam, p, duv)
    amt = _amount(tex, node_c, uv, p)[..., None]
    scale_val = v1 * amt
    # mix: (1 - amount) tex1 + amount tex2 (spectrum_mix_texture.cu:27-39)
    mix_val = (1.0 - amt) * v1 + amt * v2
    # checkerboard, point-sampled (the filter width -> 0 limit of
    # spectrum_checkerboard_texture.cu:7-33)
    st = _mapped_uv(tex, node_c, uv, p)
    parity = (torch.floor(st[..., 0]) + torch.floor(st[..., 1])).to(torch.int32) & 1
    checker_val = torch.where((parity == 0)[..., None], v1, v2)
    # directionmix: amount = |n . dir| (spectrum_direction_mix_texture.cu:27-40)
    amt_d = torch.abs(_dot3(ns, tex.dir[node_c]))[..., None]
    dirmix_val = amt_d * v1 + (1.0 - amt_d) * v2
    out = self_val
    for kind, val in ((TEX_SCALE, scale_val), (TEX_MIX, mix_val), (TEX_CHECKER, checker_val),
                      (TEX_DIRMIX, dirmix_val)):
        out = torch.where((t == kind)[..., None], val, out)
    return torch.where((node < 0)[..., None], 0.0, out)


def eval_float(tex: TexArrays, node, uv, default=0.0, p=None, duv=None):
    """A float texture per lane (JAX textures.py:415; base/float_texture.cu:
    11-24: constant, imagemap, scale) -> (R,); `default` where node < 0."""
    node_c = torch.clamp(node, min=0).long()
    t = tex.type[node_c]
    self_val = _leaf_float(tex, node_c, uv, p=p, duv=duv)
    v1 = _leaf_float(tex, tex.child[node_c, 0], uv, p=p, duv=duv)
    out = torch.where(t == TEX_SCALE, v1 * _amount(tex, node_c, uv, p), self_val)
    return torch.where(node < 0, default, out)


class TexLanes(NamedTuple):
    """K13's answer for a bounce's lanes: each lane's material with mix
    resolved, and on the lanes asked for the chosen material's textured
    slots (mask bits SLOT_*; a slot's value is make_bsdf's, clamped)."""
    mat: torch.Tensor      # (R,) int64
    refl: torch.Tensor     # (R, 4) in [0, 1]
    trans: torch.Tensor    # (R, 4) in [0, 1]
    urough: torch.Tensor   # (R,)
    vrough: torch.Tensor   # (R,)
    mask: torch.Tensor     # (R,) uint8


def slot_values(scene, mat, uv, ns, lam, p=None, duv=None):
    """make_bsdf's texture overrides (JAX materials.py:79-92) of material
    `mat` (R,) >= 0 -> (refl, trans, urough, vrough, mask (R,) uint8 of the
    slots whose node is >= 0)."""
    tex = scene.tex
    m = torch.clamp(mat, min=0).long()
    rt, tt, ut, vt = (getattr(scene, f"mat_{k}_tex")[m]
                      for k in ("refl", "trans", "urough", "vrough"))
    refl = torch.clamp(eval_spectrum(tex, rt, uv, ns, lam, p, duv), 0.0, 1.0)
    trans = torch.clamp(eval_spectrum(tex, tt, uv, ns, lam, p, duv), 0.0, 1.0)
    urough = eval_float(tex, ut, uv, p=p, duv=duv)
    vrough = eval_float(tex, vt, uv, p=p, duv=duv)
    mask = ((rt >= 0).to(torch.uint8) * SLOT_REFL + (tt >= 0).to(torch.uint8) * SLOT_TRANS
            + (ut >= 0).to(torch.uint8) * SLOT_UROUGH + (vt >= 0).to(torch.uint8) * SLOT_VROUGH)
    return refl, trans, urough, vrough, mask


def eval_lanes_plain(scene, lanes, mat, p, wo, uv, ns, lam, duv=None):
    """The plain version of K13: every lane's material with mix resolved
    (materials.resolve_mix on p and wo), then on `lanes` (R,) bool the
    chosen material's slots (slot_values) -> TexLanes; the other lanes'
    mask is 0 and their values are not read."""
    from pbrt_tpu_torch.materials.materials import resolve_mix

    m = resolve_mix(scene, mat, p, wo)
    refl, trans, urough, vrough, mask = slot_values(scene, m, uv, ns, lam, p, duv)
    return TexLanes(m, refl, trans, urough, vrough, torch.where(lanes, mask, 0))


# ------------------------------------------------------------------- K13

# K13's launches (the counts chip_smoke.py resets and reads)
launches = {"tex_eval": 0}

# csrc/texture.cu's tables: node rows (NT, NODE_F) [type, image, image
# scale, invert, child 2, amount, amount node, uvmap 4, mapping, coefficients
# 3, cscale, tex_from_render rows 0-2 (12), dir 3, v1 3, v2 3, 2 unused] and
# material rows (M, MATT_F) [type, mix m1, mix m2, mix amount, refl node,
# trans node, urough node, vrough node], float32; image rows (NI, 4) int64
# [offset, width, height, wrap]
NODE_F, MATT_F = 40, 8


def tex_tables(scene):
    """K13's rows of the scene, cached on it, with the atlas and the rgb2spec
    table."""
    cached = scene.__dict__.get("_tex_tables")
    if cached is not None:
        return cached
    tex, dev = scene.tex, scene.mat_type.device
    nt = tex.type.shape[0]

    def col(x, w=1):
        return x.to(torch.float32).reshape(nt, w)

    node = torch.cat([col(tex.type), col(tex.img), col(tex.img_scale), col(tex.img_invert),
                      col(tex.child, 2), col(tex.amount), col(tex.amount_tex),
                      col(tex.uvmap, 4), col(tex.mapkind), col(tex.coeffs, 3), col(tex.cscale),
                      col(tex.tex_from_render[:, :3, :], 12), col(tex.dir, 3),
                      col(tex.map_v1, 3), col(tex.map_v2, 3),
                      torch.zeros((nt, 2), dtype=torch.float32, device=dev)], 1).contiguous()
    mat = torch.stack([scene.mat_type.to(torch.float32), scene.mat_mix_m1.to(torch.float32),
                       scene.mat_mix_m2.to(torch.float32), scene.mat_mix_amount,
                       *(getattr(scene, f"mat_{k}_tex").to(torch.float32)
                         for k in ("refl", "trans", "urough", "vrough"))], 1).contiguous()
    imgs = tex.imgs
    image = torch.stack([imgs.offset, imgs.width, imgs.height, imgs.wrap], 1).long().contiguous()
    if node.shape[1] != NODE_F or mat.shape[1] != MATT_F:
        raise RuntimeError("texture tables do not match csrc/texture.cu's layout")
    z_nodes, coeffs = rgb2spec.device_table(dev)
    cached = dict(node=node, mat=mat, image=image, texels=imgs.data.contiguous(),
                  z_nodes=z_nodes, coeffs=coeffs)
    scene.__dict__["_tex_tables"] = cached
    return cached


_TEX_FIELDS = ("lanes", "mat", "p", "wo", "uv", "ns", "lam", "duv", "mat_out", "refl", "trans",
               "urough", "vrough", "mask", "node", "mat_rows", "image", "texels", "z_nodes",
               "coeffs")


class _TexArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in _TEX_FIELDS] + [
        (k, ctypes.c_longlong) for k in ("n", "n_mat", "n_node")]


def _lib():
    from pbrt_tpu_torch import kernels

    lib = kernels.load("texture")
    if not hasattr(lib, "declared"):
        lib.pbrt_tex_args_bytes.restype = ctypes.c_int
        if lib.pbrt_tex_args_bytes() != ctypes.sizeof(_TexArgs):
            raise RuntimeError("csrc/texture.cu's TexArgs is not textures.py's")
        lib.pbrt_tex_eval.argtypes = [ctypes.POINTER(_TexArgs), ctypes.c_void_p]
        lib.pbrt_tex_eval.restype = ctypes.c_int
        lib.declared = True
    return lib


def eval_lanes_cuda(scene, lanes, mat, p, wo, uv, ns, lam, duv=None):
    """eval_lanes_plain's contract in one launch of K13 (csrc/texture.cu
    `pbrt_tex_eval`) on CUDA tensors."""
    from pbrt_tpu_torch import kernels

    R, dev = mat.shape[0], mat.device
    if dev.type != "cuda" or not 0 < R < 1 << 31:
        raise ValueError(f"texture kernel: needs 0 < R < 2^31 lanes of CUDA tensors, got {R} "
                         f"on {dev}")
    a, keep = _TexArgs(), []

    def put(name, x, width=None, dtype=torch.float32, rows=None):
        shape = ((R if rows is None else rows),) + (() if width is None else (width,))
        if (not torch.is_tensor(x) or x.device != dev or x.dtype != dtype
                or tuple(x.shape) != shape):
            raise ValueError(f"texture kernel: {name} must be a {dtype} {shape} tensor on {dev}, "
                             f"got {getattr(x, 'dtype', x)} {tuple(getattr(x, 'shape', ()))} "
                             f"on {getattr(x, 'device', None)}")
        x = x.contiguous()
        if width == 4 and x.data_ptr() % 16:
            raise ValueError(f"texture kernel: {name} rows are read as float4: its data must "
                             f"be 16-byte aligned")
        keep.append(x)
        setattr(a, name, x.data_ptr())

    put("lanes", lanes, dtype=torch.bool)
    put("mat", mat, dtype=torch.int64)
    for k, x, w in (("p", p, 3), ("wo", wo, 3), ("uv", uv, 2), ("ns", ns, 3), ("lam", lam, 4)):
        put(k, x, w)
    if duv is not None:
        put("duv", duv, 4)
    tab = tex_tables(scene)
    n_mat, n_node = tab["mat"].shape[0], tab["node"].shape[0]
    put("mat_rows", tab["mat"], MATT_F, rows=n_mat)
    put("node", tab["node"], NODE_F, rows=n_node)
    put("image", tab["image"], 4, torch.int64, rows=tab["image"].shape[0])
    put("texels", tab["texels"], 3, rows=tab["texels"].shape[0])
    put("z_nodes", tab["z_nodes"], rows=rgb2spec.RES)
    put("coeffs", tab["coeffs"].reshape(-1), rows=tab["coeffs"].numel())
    a.n, a.n_mat, a.n_node = R, n_mat, n_node
    out = TexLanes(*(torch.empty(s, dtype=dt, device=dev) for s, dt in (
        ((R,), torch.int64), ((R, 4), torch.float32), ((R, 4), torch.float32),
        ((R,), torch.float32), ((R,), torch.float32), ((R,), torch.uint8))))
    for k, x in zip(("mat_out", "refl", "trans", "urough", "vrough", "mask"), out):
        setattr(a, k, x.data_ptr())
    err = _lib().pbrt_tex_eval(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "tex_eval")
    launches["tex_eval"] += 1
    return out


def eval_lanes(scene, lanes, mat, p, wo, uv, ns, lam, duv=None):
    """K13: on CUDA tensors one launch of csrc/texture.cu (eval_lanes_cuda),
    on CPU tensors its plain version (eval_lanes_plain) -> TexLanes."""
    fn = eval_lanes_cuda if mat.device.type == "cuda" else eval_lanes_plain
    return fn(scene, lanes, mat, p, wo, uv, ns, lam, duv)
