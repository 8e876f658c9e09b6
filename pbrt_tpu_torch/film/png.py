"""Minimal PNG writer (pure python + stdlib zlib).

Replaces the reference's vendored lodepng (src/ext, base/film.cu:57-97).
"""
import struct
import zlib

import numpy as np


def _chunk(tag, data):
    c = tag + data
    return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))


def write_png(path, rgb8):
    """rgb8: (H, W, 3) uint8."""
    rgb8 = np.ascontiguousarray(rgb8, dtype=np.uint8)
    h, w, _ = rgb8.shape
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path):
    """Minimal reader for our own 8-bit RGB PNGs (tests). -> (H, W, 3) u8."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bits, ctype = struct.unpack(">IIBB", body[:10])
            assert bits == 8 and ctype == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    img = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(w * 3, np.int32)
    for y in range(h):
        row = raw[y * stride : (y + 1) * stride]
        ft = row[0]
        cur = np.frombuffer(row[1:], np.uint8).astype(np.int32)
        if ft == 0:
            pass
        elif ft == 1:  # sub
            cur = cur.copy()
            for x in range(3, len(cur)):
                cur[x] = (cur[x] + cur[x - 3]) & 0xFF
        elif ft == 2:  # up
            cur = (cur + prev) & 0xFF
        elif ft == 3:  # average
            cur = cur.copy()
            for x in range(len(cur)):
                left = cur[x - 3] if x >= 3 else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            cur = cur.copy()
            for x in range(len(cur)):
                a = cur[x - 3] if x >= 3 else 0
                b = prev[x]
                c = prev[x - 3] if x >= 3 else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        prev = cur
        img[y] = cur.astype(np.uint8).reshape(w, 3)
    return img
