"""Shared inputs of the texture tests and chip_smoke.py: images in every
format the readers take, written from a seed; a scene whose textures reach
every node type, mapping and wrap mode through every material slot, mix
and named materials; synthetic shading lanes over it; and the agreement
criteria of K13 (csrc/texture.cu) against its plain version.

Torch and numpy only (chip_smoke.py imports it on the card)."""
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

# K13 against its plain version: materials and slot masks bit for bit; the
# spectra and roughness within TEX_ATOL on all but TEX_FRAC_FAR of the
# slots (the card's acosf / atan2f round apart from torch's, and a point on
# a checker's or a texel's cell edge may then fall into the other cell)
TEX_ATOL = 1e-5
TEX_FRAC_FAR = 1e-3


def _png(path, img8):
    h, w, _ = img8.shape

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    raw = b"".join(b"\x00" + img8[y].tobytes() for y in range(h))
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2, 0, 0, 0)) + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b""))


def _pfm(path, img):
    h, w, _ = img.shape
    Path(path).write_bytes(b"PF\n" + f"{w} {h}\n-1.0\n".encode()
                           + np.flipud(img).astype("<f4").tobytes())


def _tga(path, img8, rle=False):
    """24-bit TGA, origin top-left; type 10 (RLE) as raw packets if rle."""
    h, w, _ = img8.shape
    bgr = img8[..., ::-1].reshape(-1, 3)
    header = bytes([0, 0, 10 if rle else 2]) + bytes(9) + struct.pack("<HH", w, h) + bytes(
        [24, 0x20])
    if rle:
        body = b"".join(bytes([min(127, len(bgr) - i - 1)]) + bgr[i:i + 128].tobytes()
                        for i in range(0, len(bgr), 128))
    else:
        body = bgr.tobytes()
    Path(path).write_bytes(header + body)


def _exr(path, img, comp):
    """A scanline EXR of float channels B, G, R: comp 0 (NONE) or 3 (ZIP)."""
    h, w, _ = img.shape

    def attr(name, atype, payload):
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<I", len(payload)) + payload)

    def chan(name):
        return name.encode() + b"\x00" + struct.pack("<IiII", 2, 0, 1, 1)

    header = (attr("channels", "chlist", chan("B") + chan("G") + chan("R") + b"\x00")
              + attr("compression", "compression", bytes([comp]))
              + attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + attr("lineOrder", "lineOrder", b"\x00")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\x00")
    per_block = 16 if comp == 3 else 1
    head = b"\x76\x2f\x31\x01" + struct.pack("<I", 2) + header
    n_blocks = (h + per_block - 1) // per_block
    pos = len(head) + 8 * n_blocks
    offsets, blocks = [], []
    for b0 in range(n_blocks):
        y0 = b0 * per_block
        raw = b"".join(img[y, :, c].astype("<f4").tobytes()
                       for y in range(y0, min(y0 + per_block, h)) for c in (2, 1, 0))
        payload = raw
        if comp == 3:
            a = np.frombuffer(raw, np.uint8)
            half = (len(a) + 1) // 2
            inter = np.empty(len(a), np.uint8)
            inter[:half] = a[0::2]
            inter[half:] = a[1::2]
            d = inter.astype(np.int16)
            d[1:] = ((d[1:] - d[:-1].copy()) + 128) & 0xFF
            z = zlib.compress(d.astype(np.uint8).tobytes())
            payload = z if len(z) < len(raw) else raw
        offsets.append(pos)
        blocks.append(struct.pack("<iI", y0, len(payload)) + payload)
        pos += len(blocks[-1])
    Path(path).write_bytes(head + b"".join(struct.pack("<Q", o) for o in offsets)
                           + b"".join(blocks))


def write_images(directory, seed=7):
    """Small images from `seed`, one in each format and variant the readers
    take -> {name: (path, the linear rgb a reader must return or None for the
    8-bit ones, whose sRGB decode the test checks)}."""
    rng = np.random.default_rng(seed)
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    out = {}
    img8 = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    _png(d / "a.png", img8)
    out["png"] = (str(d / "a.png"), img8)
    _tga(d / "b.tga", img8[:4], rle=False)
    out["tga"] = (str(d / "b.tga"), img8[:4])
    _tga(d / "c.tga", img8[1:], rle=True)
    out["tga_rle"] = (str(d / "c.tga"), img8[1:])
    f = rng.uniform(0.0, 2.0, (4, 7, 3)).astype(np.float32)
    _pfm(d / "d.pfm", f)
    out["pfm"] = (str(d / "d.pfm"), f)
    _exr(d / "e.exr", f[:, :5], 0)
    out["exr"] = (str(d / "e.exr"), f[:, :5])
    g = rng.uniform(0.0, 1.5, (20, 3, 3)).astype(np.float32)
    _exr(d / "f.exr", g, 3)
    out["exr_zip"] = (str(d / "f.exr"), g)
    return out


def scene_text(directory):
    """A scene whose named materials reach every texture node type (constant,
    an unbounded rgb constant, imagemap, scale, mix, checkerboard, directionmix),
    mapping (uv, spherical, cylindrical, planar) and wrap mode (repeat,
    clamp, black, octahedralsphere), each image format, every textured slot
    (diffuse and coated-diffuse reflectance, conductor roughness u and v,
    diffuse transmission's two) and a mix material; the images are written
    into `directory` by write_images. One quad per material in a box under a
    light, so that the scene renders."""
    imgs = write_images(directory)
    p = {k: v[0] for k, v in imgs.items()}
    tex = f"""
Texture "c" "spectrum" "constant"
Texture "i-png" "spectrum" "imagemap" "string filename" ["{p['png']}"] "float uscale" [3]
  "float vscale" [2] "float udelta" [0.1]
Texture "i-pfm" "spectrum" "imagemap" "string filename" ["{p['pfm']}"] "string wrap" ["clamp"]
  "bool invert" [true] "float scale" [0.8]
Texture "i-tga" "spectrum" "imagemap" "string filename" ["{p['tga']}"] "string wrap" ["black"]
  "string mapping" ["spherical"]
Texture "i-tga-rle" "spectrum" "imagemap" "string filename" ["{p['tga_rle']}"]
Texture "i-exr" "spectrum" "imagemap" "string filename" ["{p['exr']}"]
  "string wrap" ["octahedralsphere"] "string mapping" ["cylindrical"]
Texture "i-exr-zip" "spectrum" "imagemap" "string filename" ["{p['exr_zip']}"]
  "string mapping" ["planar"] "vector3 v1" [0.01 0.002 0] "vector3 v2" [0 0.01 0.003]
  "float udelta" [0.2] "float vdelta" [-0.1]
Texture "f-img" "float" "imagemap" "string filename" ["{p['png']}"] "string wrap" ["clamp"]
Texture "f-img-blk" "float" "imagemap" "string filename" ["{p['tga']}"] "string wrap" ["black"]
  "float uscale" [1.5]
Texture "f-scale" "float" "scale" "texture tex" ["f-img"] "float scale" [0.5]
Texture "s-scale" "spectrum" "scale" "texture tex" ["i-png"] "texture scale" ["f-img-blk"]
Texture "s-mix" "spectrum" "mix" "texture tex1" ["i-pfm"] "rgb tex2" [0.1 0.9 0.2]
  "texture amount" ["f-img"]
Texture "s-mix-c" "spectrum" "mix" "rgb tex1" [1.9 0.3 0.1] "texture tex2" ["i-exr"]
  "float amount" [0.3]
Texture "s-check" "spectrum" "checkerboard" "float uscale" [4] "float vscale" [3]
  "texture tex1" ["i-tga-rle"] "rgb tex2" [0.05 0.05 0.05]
Texture "s-check-sph" "spectrum" "checkerboard" "string mapping" ["spherical"]
  "float uscale" [8] "rgb tex1" [0.7 0.7 0.2] "rgb tex2" [0.2 0.2 0.7]
Texture "s-dirmix" "spectrum" "directionmix" "texture tex1" ["i-exr-zip"]
  "rgb tex2" [0.3 0.3 0.3] "vector3 dir" [0 1 1]
"""
    mats = [("diffuse", f'"texture reflectance" ["{t}"]') for t in (
        "c", "i-png", "i-pfm", "i-tga", "i-tga-rle", "i-exr", "i-exr-zip", "s-scale",
        "s-mix", "s-mix-c", "s-check", "s-check-sph", "s-dirmix")]
    mats += [("conductor", '"texture uroughness" ["f-img"] "texture vroughness" ["f-scale"]'),
             ("conductor", '"texture roughness" ["f-img-blk"] "rgb reflectance" [0.8 0.6 0.3]'),
             ("dielectric", '"texture roughness" ["f-scale"]'),
             ("diffusetransmission",
              '"texture reflectance" ["s-check"] "texture transmittance" ["s-dirmix"]'),
             ("diffuse", '"rgb reflectance" [0.5 0.5 0.5]'),
             ("coateddiffuse", '"texture reflectance" ["s-mix"] "float roughness" [0.1]')]
    out = [
        'Integrator "path" "integer maxdepth" [3]\n'
        'Sampler "independent" "integer pixelsamples" [2]\n'
        'Film "rgb" "integer xresolution" [16] "integer yresolution" [16]\n'
        'LookAt 0 0 -6  0 0 0  0 1 0\nCamera "perspective" "float fov" [50]\n'
        'WorldBegin\n', tex]
    names = []
    for i, (kind, params) in enumerate(mats):
        names.append(f"m{i}")
        out.append(f'MakeNamedMaterial "m{i}" "string type" ["{kind}"] {params}\n')
    names.append("mix")
    out.append('MakeNamedMaterial "mix" "string type" ["mix"] "string materials" ["m1" "m13"] '
               '"float amount" [0.4]\n')
    out.append('AttributeBegin\n  AreaLightSource "diffuse" "rgb L" [8 8 8]\n'
               '  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
               '    "point3 P" [-1 2.9 -1  1 2.9 -1  1 2.9 1  -1 2.9 1]\nAttributeEnd\n')
    n = len(names)
    for i, name in enumerate(names):
        x0 = -3.0 + 6.0 * i / n
        x1 = -3.0 + 6.0 * (i + 1) / n
        out.append(f'NamedMaterial "{name}"\n'
                   f'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
                   f'  "point3 P" [{x0} -3 2  {x1} -3 2  {x1} 3 2  {x0} 3 2]\n'
                   f'  "point2 uv" [0 0  1 0  1 1  0 1]\n')
    out.append('NamedMaterial "mix"\nShape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
               '  "point3 P" [-3 -3 -2  3 -3 -2  3 -3 2  -3 -3 2]\n'
               '  "point2 uv" [0 0  2 0  2 2  0 2]\n')
    return "".join(out)


def synthetic_lanes(scene, R, seed=0, footprints=False, device="cpu"):
    """R shading lanes over `scene` from `seed`: each a material (-1 on ~5 %,
    every material of the table otherwise), whether it is evaluated (~90 %
    of those with a material), the hit point in the box, wo and the shading
    normal unit vectors, uv in [-1.5, 2.5), wavelengths in [360, 830), and
    with `footprints` uv footprints -> dict of tensors on `device`."""
    rng = np.random.default_rng(seed)
    M = scene.mat_type.shape[0]
    mat = rng.integers(0, M, R)
    mat[rng.uniform(size=R) < 0.05] = -1
    lanes = (mat >= 0) & (rng.uniform(size=R) < 0.9)

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    f32 = np.float32
    out = dict(lanes=lanes, mat=mat.astype(np.int64), p=rng.uniform(-3.5, 3.5, (R, 3)),
               wo=unit(R), uv=rng.uniform(-1.5, 2.5, (R, 2)), ns=unit(R),
               lam=rng.uniform(360.0, 830.0, (R, 4)),
               duv=rng.normal(0.0, 0.05, (R, 4)) if footprints else None)
    return {k: None if v is None else torch.as_tensor(
        v.astype(f32) if v.dtype == np.float64 else v).to(device) for k, v in out.items()}


def compare(got, want):
    """K13's TexLanes against the plain version's -> dict(mat_equal,
    mask_equal, frac_far, max_abs) over the slots the mask holds."""
    mat_eq = torch.equal(got.mat.cpu(), want.mat.cpu())
    mask_eq = torch.equal(got.mask.cpu(), want.mask.cpu())
    far, n, worst = 0, 0, 0.0
    for bit, k in ((1, "refl"), (2, "trans"), (4, "urough"), (8, "vrough")):
        sel = (want.mask.cpu() & bit) != 0
        d = torch.abs(getattr(got, k).cpu()[sel] - getattr(want, k).cpu()[sel])
        d = torch.nan_to_num(d, nan=float("inf"))
        far += int((d > TEX_ATOL).sum())
        n += d.numel()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return dict(mat_equal=mat_eq, mask_equal=mask_eq, frac_far=far / max(n, 1),
                max_abs=worst, slots=n)


def agree(res):
    return res["mat_equal"] and res["mask_equal"] and res["frac_far"] <= TEX_FRAC_FAR


# float ops of K13, counted from csrc/texture.cu and rounded: a mix lane's
# hash (~40); a slot's combinator (its amount and blend at four
# wavelengths, ~15); a constant leaf's sigmoid at four wavelengths (~40);
# an image leaf's rgb2spec lookup (the divisions, the search, 7 lerps of 3:
# ~80) and sigmoid (~40), each fetch of it (the weights and the four taps'
# sums, ~30) and a non-uv mapping (the transform, ~20, with acosf / atan2f
# counted as one op each)
TEX_OPS = dict(mix=40, combinator=15, const_leaf=40, image_leaf=120, fetch=30, mapping=20)


def _texel_ids(tex, node, uv, p, duv):
    """Atlas rows (n, 4 or 16) that image_bilerp reads for image leaves
    `node` at uv and p (the 4 taps of each fetch, under footprints 4
    fetches; -1 where a tap is black), as textures._leaf_rgb_or_value maps
    and flips the coordinates."""
    from pbrt_tpu_torch.textures import textures as tx

    imgs = tex.imgs
    st = tx._mapped_uv(tex, node, uv, p)
    st = torch.stack([st[..., 0], 1.0 - st[..., 1]], -1)
    points = [st]
    if duv is not None:
        m = tex.uvmap[node]
        is_uv = (tex.mapkind[node] == tx.MAP_UV)[..., None].to(torch.float32)
        gx = torch.stack([duv[..., 0] * m[..., 0], duv[..., 1] * m[..., 1]], -1) * is_uv
        gy = torch.stack([duv[..., 2] * m[..., 0], duv[..., 3] * m[..., 1]], -1) * is_uv
        qx, qy = 0.25 * gx, 0.25 * gy
        points = [(st + qx) + qy, (st + qx) - qy, (st - qx) + qy, (st - qx) - qy]
    idx = torch.clamp(tex.img[node], min=0).long()
    w, h = imgs.width[idx].long(), imgs.height[idx].long()
    off, wrap = imgs.offset[idx].long(), imgs.wrap[idx]
    ids = []
    for q in points:
        x, y = q[..., 0] * w.to(torch.float32) - 0.5, q[..., 1] * h.to(torch.float32) - 0.5
        xi, yi = torch.floor(x).long(), torch.floor(y).long()
        for cx, cy in ((xi, yi), (xi + 1, yi), (xi, yi + 1), (xi + 1, yi + 1)):
            px, bx = tx._wrap_coord(cx, w, wrap)
            py, by = tx._wrap_coord(cy, h, wrap)
            ids.append(torch.where(bx | by, -1, off + py * w + px))
    return torch.stack(ids, -1)


def _rgb2spec_cells(rgb):
    """Coefficient rows (n, 8) of the rgb2spec cells that the lookup of rgb
    (n, 3) in [0, 1] reads (csrc/texture.cu rgb_to_coefficients); none for
    a uniform rgb, which takes no cell."""
    from pbrt_tpu_torch.spectral import rgb2spec

    res = rgb2spec.RES
    z_nodes, _ = rgb2spec.device_table(rgb.device)
    rgb = rgb[~((rgb[:, 0] == rgb[:, 1]) & (rgb[:, 1] == rgb[:, 2]))]
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    maxc = torch.where(r > g, torch.where(r > b, 0, 2), torch.where(g > b, 1, 2))
    comp = lambda k: torch.gather(rgb, -1, k[:, None])[:, 0]  # noqa: E731
    z = comp(maxc)
    zsafe = torch.clamp(z, min=1e-12)
    xi = torch.clamp((comp((maxc + 1) % 3) * (res - 1) / zsafe).to(torch.int64), max=res - 2)
    yi = torch.clamp((comp((maxc + 2) % 3) * (res - 1) / zsafe).to(torch.int64), max=res - 2)
    zi = torch.clamp(torch.searchsorted(z_nodes, z.contiguous()) - 1, 0, res - 2)
    return torch.stack([((maxc * res + zi + dz) * res + yi + dy) * res + xi + dx
                        for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)], -1)


def tex_work(scene, lanes, mat, out, uv, p, duv=None):
    """(bytes, ops) of one K13 launch on these inputs (`out` its TexLanes,
    duv the footprints or None), each input read once and each output
    written once: every lane its flag and material in, material and mask
    out; a mix lane its p and wo; an evaluated lane its uv, normal and
    wavelengths (and footprints), its p where no mix read it, and the slots
    it writes; the distinct
    texels (12 bytes) that the launch's fetches read and the distinct
    rgb2spec coefficient rows (12 bytes) that its spectral image leaves
    read, with the z nodes; the node and material rows. Ops count every
    lane's work."""
    from pbrt_tpu_torch.scene import builder as bd
    from pbrt_tpu_torch.spectral import rgb2spec
    from pbrt_tpu_torch.textures import textures as tx

    tex = scene.tex
    R = mat.shape[0]
    m_in = torch.clamp(mat, min=0)
    mix = (mat >= 0) & (scene.mat_type[m_in] == bd.MAT_MIX)
    n_mix, n_ev, n_ev_p = int(mix.sum()), int(lanes.sum()), int((lanes & ~mix).sum())
    nbytes = (R * 18 + n_mix * 24 + n_ev * (36 + (16 if duv is not None else 0)) + n_ev_p * 12
              + (tex.type.shape[0] * tx.NODE_F + scene.mat_type.shape[0] * tx.MATT_F) * 4)
    ops = n_mix * TEX_OPS["mix"]
    texels, cells = [], []
    m = torch.clamp(out.mat, min=0)
    for bit, k, spectral in ((1, "refl", True), (2, "trans", True), (4, "urough", False),
                             (8, "vrough", False)):
        sel = lanes & ((out.mask & bit) != 0)
        nbytes += int(sel.sum()) * (16 if spectral else 4)
        node = getattr(scene, f"mat_{k}_tex")[m][sel].long()
        if node.numel() == 0:
            continue
        uv_s, p_s = uv[sel], p[sel]
        duv_s = None if duv is None else duv[sel]
        t = tex.type[node]
        c1, c2, at = tex.child[node, 0].long(), tex.child[node, 1].long(), tex.amount_tex[node]
        leaves = []  # (node, lanes that evaluate it, under footprints)
        if spectral:
            leaf_self = (t == tx.TEX_CONST) | (t == tx.TEX_IMAGE)
            st = tx._mapped_uv(tex, node, uv_s, p_s)
            odd = ((torch.floor(st[:, 0]) + torch.floor(st[:, 1])).to(torch.int32) & 1) == 1
            checker = t == tx.TEX_CHECKER
            two = (t == tx.TEX_MIX) | (t == tx.TEX_DIRMIX)
            leaves += [(node, leaf_self, True), (c1, (t == tx.TEX_SCALE) | two
                                                 | (checker & ~odd), True),
                       (c2, two | (checker & odd), True)]
            amount = (t == tx.TEX_SCALE) | (t == tx.TEX_MIX)
        else:
            leaves += [(node, t != tx.TEX_SCALE, True), (c1, t == tx.TEX_SCALE, True)]
            amount = t == tx.TEX_SCALE
        leaves.append((at, amount & (at >= 0), False))
        ops += int((~((t == tx.TEX_CONST) | (t == tx.TEX_IMAGE))).sum()) * TEX_OPS["combinator"]
        for ln, use, fp in leaves:
            ln = torch.clamp(ln, min=0)
            img = use & (tex.type[ln] == tx.TEX_IMAGE)
            n_img, n_const = int(img.sum()), int((use & ~img).sum())
            fetches = n_img * (4 if fp and duv is not None else 1)
            nonuv = int((img & (tex.mapkind[ln] != tx.MAP_UV)).sum())
            ops += (n_const * TEX_OPS["const_leaf"] + fetches * TEX_OPS["fetch"]
                    + nonuv * TEX_OPS["mapping"]
                    + (n_img * TEX_OPS["image_leaf"] if spectral else 0))
            if n_img == 0:
                continue
            d_i = duv_s[img] if fp and duv_s is not None else None
            texels.append(_texel_ids(tex, ln[img], uv_s[img], p_s[img], d_i).reshape(-1))
            if spectral:
                rgb = tx._leaf_rgb_or_value(tex, ln[img], uv_s[img], p_s[img], d_i)[1]
                cells.append(_rgb2spec_cells(torch.clamp(rgb, 0.0, 1.0)).reshape(-1))
    for ids in (texels, cells):
        if ids:
            u = torch.unique(torch.cat(ids))
            nbytes += int((u >= 0).sum()) * 12
    if cells:
        nbytes += rgb2spec.RES * 4
    return nbytes, ops
