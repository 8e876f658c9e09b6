"""Host-side image loading: PNG / PFM / TGA / EXR -> linear-RGB float numpy.

A copy of pbrt_tpu/textures/image.py (the port imports nothing of the JAX
package, even where a module is numpy only; reference textures/gpu_image.cu,
which wraps lodepng / stb / tinyexr). Pure numpy + zlib decoders. 8-bit
formats are sRGB-decoded to linear like the reference (gpu_image.cu:214-226
SRGBColorEncoding::to_linear); float formats (PFM/EXR) are already linear.

Supported subsets:
  PNG: 8/16-bit, gray/gray+alpha/RGB/RGBA/palette, non-interlaced
  PFM: binary 'PF'/'Pf', either byte order
  TGA: uncompressed (type 2) and RLE (type 10), 24/32-bit
  EXR: scanline, NONE or ZIP(S) compression, half/float channels
"""
import struct
import zlib

import numpy as np


def srgb_to_linear(u8):
    """sRGB decode (reference spectrum_util/color_encoding.cu to_linear)."""
    v = u8.astype(np.float32) / 255.0
    return np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4).astype(np.float32)


def load_image(path):
    """-> (H, W, 3) float32 linear RGB."""
    p = str(path).lower()
    if p.endswith(".png"):
        return load_png(path)
    if p.endswith(".pfm"):
        return load_pfm(path)
    if p.endswith(".tga"):
        return load_tga(path)
    if p.endswith(".exr"):
        return load_exr(path)
    if p.endswith((".jpg", ".jpeg")):
        raise ValueError(f"JPEG not supported (reference doesn't support it either): {path}")
    raise ValueError(f"unknown image format: {path}")


# ----------------------------------------------------------------- PNG


def _png_unfilter(raw, height, stride, bpp):
    """Undo PNG per-scanline filters. raw: bytes of len height*(1+stride)."""
    out = np.zeros((height, stride), np.uint8)
    raw = np.frombuffer(raw, np.uint8).reshape(height, 1 + stride)
    for y in range(height):
        ftype = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        prev = out[y - 1].astype(np.int32) if y > 0 else np.zeros(stride, np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = np.zeros(stride, np.int32)
            # sequential in x but vectorizable per byte-offset chunk; bpp small
            a = np.zeros(stride, np.int32)  # left
            c = np.zeros(stride, np.int32)  # upper-left
            for x in range(stride):
                a_v = cur[x - bpp] if x >= bpp else 0
                c_v = prev[x - bpp] if x >= bpp else 0
                b_v = prev[x]
                if ftype == 1:  # sub
                    v = line[x] + a_v
                elif ftype == 3:  # average
                    v = line[x] + ((a_v + b_v) >> 1)
                else:  # paeth
                    pa = abs(b_v - c_v)
                    pb = abs(a_v - c_v)
                    pc = abs(a_v + b_v - 2 * c_v)
                    pred = a_v if (pa <= pb and pa <= pc) else (b_v if pb <= pc else c_v)
                    v = line[x] + pred
                cur[x] = v & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = cur.astype(np.uint8)
    return out


def load_png(path):
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    palette = None
    trns = None
    w = h = bitdepth = colortype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            w, h, bitdepth, colortype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", chunk)
            if interlace:
                raise ValueError("interlaced PNG not supported")
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(chunk, np.uint8)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
    raw = zlib.decompress(idat)
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colortype]
    if bitdepth == 8:
        bypc = 1
    elif bitdepth == 16:
        bypc = 2
    elif bitdepth in (1, 2, 4) and colortype in (0, 3):
        # sub-byte gray/palette: expand after unfilter
        bypc = 0
    else:
        raise ValueError(f"PNG bitdepth {bitdepth} colortype {colortype} unsupported")

    if bypc:
        bpp = nch * bypc
        stride = w * bpp
        arr = _png_unfilter(raw, h, stride, bpp)
        if bypc == 2:
            arr = arr.reshape(h, w, nch, 2)
            vals = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
            img = vals.astype(np.float32) / 65535.0
            lin = np.where(img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4)
        else:
            arr = arr.reshape(h, w, nch)
            if colortype == 3:
                rgb = palette[arr[..., 0]]
                return srgb_to_linear(rgb)
            lin = srgb_to_linear(arr)
    else:
        # bit-packed
        stride = (w * bitdepth + 7) // 8
        arr = _png_unfilter(raw, h, stride, 1)
        bits = np.unpackbits(arr, axis=1)[:, : w * bitdepth].reshape(h, w, bitdepth)
        weights = (1 << np.arange(bitdepth - 1, -1, -1)).astype(np.uint16)
        vals = (bits * weights).sum(-1)
        if colortype == 3:
            rgb = palette[vals]
            return srgb_to_linear(rgb)
        maxv = (1 << bitdepth) - 1
        g = srgb_to_linear((vals * 255 // maxv).astype(np.uint8))
        return np.repeat(g[..., None], 3, axis=-1)

    if nch == 1:
        return np.repeat(lin, 3, axis=-1).astype(np.float32)
    if nch == 2:
        return np.repeat(lin[..., :1], 3, axis=-1).astype(np.float32)
    return lin[..., :3].astype(np.float32)


# ----------------------------------------------------------------- PFM


def load_pfm(path):
    with open(path, "rb") as fh:
        header = fh.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM")
        dims = fh.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(fh.readline().strip())
        nch = 3 if header == b"PF" else 1
        dtype = "<f4" if scale < 0 else ">f4"
        buf = np.frombuffer(fh.read(w * h * nch * 4), dtype).reshape(h, w, nch)
    img = np.flipud(buf).astype(np.float32)  # PFM rows are bottom-to-top
    if nch == 1:
        img = np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img)


# ----------------------------------------------------------------- TGA


def load_tga(path):
    data = open(path, "rb").read()
    idlen, cmap_type, img_type = data[0], data[1], data[2]
    w, h = struct.unpack("<HH", data[12:16])
    bpp = data[16]
    desc = data[17]
    if cmap_type != 0 or img_type not in (2, 10) or bpp not in (24, 32):
        raise ValueError(f"TGA subset unsupported: type={img_type} bpp={bpp}")
    nch = bpp // 8
    off = 18 + idlen
    npix = w * h
    if img_type == 2:
        pix = np.frombuffer(data[off : off + npix * nch], np.uint8).reshape(npix, nch)
    else:  # RLE
        out = np.empty((npix, nch), np.uint8)
        i, o = off, 0
        while o < npix:
            hdr = data[i]
            i += 1
            count = (hdr & 0x7F) + 1
            if hdr & 0x80:
                out[o : o + count] = np.frombuffer(data[i : i + nch], np.uint8)
                i += nch
            else:
                out[o : o + count] = np.frombuffer(
                    data[i : i + count * nch], np.uint8
                ).reshape(count, nch)
                i += count * nch
            o += count
        pix = out
    img = pix.reshape(h, w, nch)
    if not (desc & 0x20):  # origin at bottom-left -> flip
        img = np.flipud(img)
    bgr = img[..., :3]
    rgb = bgr[..., ::-1]
    return srgb_to_linear(np.ascontiguousarray(rgb))


# ----------------------------------------------------------------- EXR


def _read_exr_attrs(data, pos):
    attrs = {}
    while True:
        end = data.index(b"\x00", pos)
        name = data[pos:end].decode()
        pos = end + 1
        if name == "":
            break
        end = data.index(b"\x00", pos)
        atype = data[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack("<I", data[pos : pos + 4])
        pos += 4
        attrs[name] = (atype, data[pos : pos + size])
        pos += size
    return attrs, pos


def load_exr(path):
    data = open(path, "rb").read()
    if data[:4] != b"\x76\x2f\x31\x01":
        raise ValueError("not an EXR")
    version = struct.unpack("<I", data[4:8])[0]
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    attrs, pos = _read_exr_attrs(data, 8)

    # channels
    chl_raw = attrs["channels"][1]
    channels = []
    cpos = 0
    while chl_raw[cpos] != 0:
        end = chl_raw.index(b"\x00", cpos)
        cname = chl_raw[cpos:end].decode()
        cpos = end + 1
        (ptype,) = struct.unpack("<I", chl_raw[cpos : cpos + 4])
        cpos += 16
        channels.append((cname, ptype))  # 0=uint,1=half,2=float
    channels.sort()  # EXR stores channels alphabetically within a scanline

    (cx0, cy0, cx1, cy1) = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = cx1 - cx0 + 1, cy1 - cy0 + 1
    comp = attrs["compression"][1][0]
    if comp not in (0, 2, 3):  # NONE, ZIPS, ZIP
        raise ValueError(f"EXR compression {comp} unsupported (need NONE/ZIP)")
    lines_per_block = {0: 1, 2: 1, 3: 16}[comp]

    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack(f"<{n_blocks}Q", data[pos : pos + 8 * n_blocks])

    csize = {0: 4, 1: 2, 2: 4}
    cdtype = {0: np.uint32, 1: np.float16, 2: np.float32}
    bytes_per_line = sum(csize[t] for _, t in channels) * w

    planes = {c: np.zeros((h, w), np.float32) for c, _ in channels}
    for off in offsets:
        (y,) = struct.unpack("<i", data[off : off + 4])
        (dsize,) = struct.unpack("<I", data[off + 4 : off + 8])
        block = data[off + 8 : off + 8 + dsize]
        nlines = min(lines_per_block, cy1 - y + 1)
        raw_len = bytes_per_line * nlines
        if comp == 0 or dsize == raw_len:
            # NONE, or a ZIP block stored raw because deflate didn't shrink it
            raw = block
        else:
            raw = zlib.decompress(block)
            if len(raw) == raw_len:
                # EXR ZIP post-process: un-delta then un-interleave
                b = np.frombuffer(raw, np.uint8).astype(np.int16)
                b = (np.cumsum(np.concatenate([b[:1], (b[1:] - 128)])) & 0xFF).astype(np.uint8)
                half = (len(b) + 1) // 2
                out = np.empty(len(b), np.uint8)
                out[0::2] = b[:half]
                out[1::2] = b[half:]
                raw = out.tobytes()
        lpos = 0
        for li in range(nlines):
            for cname, ptype in channels:
                n = w * csize[ptype]
                vals = np.frombuffer(raw[lpos : lpos + n], cdtype[ptype]).astype(np.float32)
                planes[cname][y - cy0 + li] = vals
                lpos += n

    def get(name):
        return planes.get(name)

    r, g, b = get("R"), get("G"), get("B")
    if r is None and get("Y") is not None:
        y = get("Y")
        return np.repeat(y[..., None], 3, axis=-1).astype(np.float32)
    if r is None or g is None or b is None:
        raise ValueError(f"EXR channels {list(planes)} missing RGB")
    return np.stack([r, g, b], axis=-1).astype(np.float32)
