"""RGB -> sigmoid-polynomial coefficients (Jakob & Hanika 2019).

Counterpart of pbrt_tpu/spectral/rgb2spec.py `load_table`,
`rgb_to_coefficients_np` (host) and `rgb_to_coefficients` (device tensors:
an image texture's texels per lane): the fitted sRGB table ships in
pbrt_tpu_torch/data/rgb2spec_srgb.npz and is loaded, never refit.
"""
import functools
import pathlib

import numpy as np
import torch

RES = 64
_CACHE = pathlib.Path(__file__).resolve().parent.parent / "data" / "rgb2spec_srgb.npz"


@functools.lru_cache(None)
def load_table():
    """(z_nodes (64,), coeffs (3, 64, 64, 64, 3)) float32 numpy."""
    d = np.load(_CACHE)
    return d["z_nodes"], d["coeffs"]


def rgb_to_coefficients_np(rgb):
    """Trilinear table lookup of RGB (..., 3) in [0, inf) -> (..., 3)
    coefficients, with the exact uniform-RGB special case."""
    z_nodes, coeffs = load_table()
    rgb = np.clip(np.asarray(rgb, np.float32), 0.0, None)
    single = rgb.ndim == 1
    rgb = np.atleast_2d(rgb)

    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.where(r > g, np.where(r > b, 0, 2), np.where(g > b, 1, 2))
    z = np.take_along_axis(rgb, maxc[..., None], axis=-1)[..., 0]
    zsafe = np.maximum(z, 1e-12)
    x = np.take_along_axis(rgb, ((maxc + 1) % 3)[..., None], axis=-1)[..., 0] * (RES - 1) / zsafe
    y = np.take_along_axis(rgb, ((maxc + 2) % 3)[..., None], axis=-1)[..., 0] * (RES - 1) / zsafe

    xi = np.minimum(x.astype(np.int32), RES - 2)
    yi = np.minimum(y.astype(np.int32), RES - 2)
    zi = np.clip(np.searchsorted(z_nodes, z, side="left") - 1, 0, RES - 2)
    dx = x - xi
    dy = y - yi
    dz = (z - z_nodes[zi]) / np.maximum(z_nodes[zi + 1] - z_nodes[zi], 1e-12)

    def co(ddx, ddy, ddz):
        return coeffs[maxc, zi + ddz, yi + ddy, xi + ddx]

    def lerp(t, a, bb):
        return (1.0 - t[..., None]) * a + t[..., None] * bb

    c = lerp(
        dz,
        lerp(dy, lerp(dx, co(0, 0, 0), co(1, 0, 0)), lerp(dx, co(0, 1, 0), co(1, 1, 0))),
        lerp(dy, lerp(dx, co(0, 0, 1), co(1, 0, 1)), lerp(dx, co(0, 1, 1), co(1, 1, 1))),
    )
    uniform = (r == g) & (g == b)
    denom = np.sqrt(np.maximum(r * (1.0 - r), 1e-12))
    c_uniform = np.stack([np.zeros_like(r), np.zeros_like(r), (r - 0.5) / denom], axis=-1)
    c_uniform = np.where(
        (r <= 0.0)[..., None],
        np.array([0.0, 0.0, -1e30]),
        np.where((r >= 1.0)[..., None], np.array([0.0, 0.0, 1e30]), c_uniform),
    )
    out = np.where(uniform[..., None], c_uniform, c).astype(np.float32)
    return out[0] if single else out


@functools.lru_cache(None)
def device_table(device):
    """load_table's arrays as float32 tensors on `device`, made once."""
    z_nodes, coeffs = load_table()
    return (torch.as_tensor(np.asarray(z_nodes, np.float32), device=device),
            torch.as_tensor(np.asarray(coeffs, np.float32), device=device).contiguous())


def rgb_to_coefficients(rgb):
    """The torch lookup on device tensors (JAX rgb2spec.py:251
    `rgb_to_coefficients`, reference rgb2spec cu:388-426): RGB (..., 3) in
    [0, inf) -> (..., 3) coefficients, trilinear in the table, with the
    exact uniform-RGB special case."""
    z_nodes, coeffs = device_table(rgb.device)
    rgb = torch.clamp(rgb, min=0.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.where(r > g, torch.where(r > b, 0, 2), torch.where(g > b, 1, 2))

    def comp(k):
        return torch.gather(rgb, -1, k[..., None])[..., 0]

    z = comp(maxc)
    zsafe = torch.clamp(z, min=1e-12)
    x = comp((maxc + 1) % 3) * (RES - 1) / zsafe
    y = comp((maxc + 2) % 3) * (RES - 1) / zsafe
    xi = torch.clamp(x.to(torch.int64), max=RES - 2)
    yi = torch.clamp(y.to(torch.int64), max=RES - 2)
    zi = torch.clamp(torch.searchsorted(z_nodes, z.contiguous()) - 1, 0, RES - 2)
    dx = x - xi.to(torch.float32)
    dy = y - yi.to(torch.float32)
    dz = (z - z_nodes[zi]) / torch.clamp(z_nodes[zi + 1] - z_nodes[zi], min=1e-12)

    def co(ddx, ddy, ddz):
        return coeffs[maxc, zi + ddz, yi + ddy, xi + ddx]

    def lerp(t, a, bb):
        return (1.0 - t[..., None]) * a + t[..., None] * bb

    c = lerp(dz,
             lerp(dy, lerp(dx, co(0, 0, 0), co(1, 0, 0)), lerp(dx, co(0, 1, 0), co(1, 1, 0))),
             lerp(dy, lerp(dx, co(0, 0, 1), co(1, 0, 1)), lerp(dx, co(0, 1, 1), co(1, 1, 1))))
    uniform = (r == g) & (g == b)
    denom = torch.sqrt(torch.clamp(r * (1.0 - r), min=1e-12))
    zero = torch.zeros_like(r)
    c_uniform = torch.stack([zero, zero, (r - 0.5) / denom], dim=-1)
    edge = torch.stack([zero, zero, torch.where(r <= 0.0, -1e30, 1e30)], dim=-1)
    c_uniform = torch.where(((r <= 0.0) | (r >= 1.0))[..., None], edge, c_uniform)
    return torch.where(uniform[..., None], c_uniform, c)
