"""RGB color spaces, sensor conversion and sRGB encoding (counterpart of
pbrt_tpu/spectral/colorspace.py): host numpy for the one-time matrices,
torch for the per-sample device math."""
import functools

import numpy as np
import torch

from pbrt_tpu_torch.spectral import cie, spectra


def xyz_from_xyY(xy, Y=1.0):
    """(reference spectrum_util/xyz.h from_xyY)."""
    x, y = float(xy[0]), float(xy[1])
    if y == 0.0:
        return np.zeros(3)
    return np.array([x * Y / y, Y, (1.0 - x - y) * Y / y])


class ColorSpace:
    """Primaries + whitepoint + conversion matrices (reference
    rgb_color_space.h:10-42)."""

    def __init__(self, r_xy, g_xy, b_xy, illuminant_dense):
        self.r, self.g, self.b = r_xy, g_xy, b_xy
        self.illuminant = np.asarray(illuminant_dense)
        wp = cie.to_xyz(self.illuminant)
        self.w = wp[:2] / wp.sum()
        rgb = np.stack(
            [xyz_from_xyY(r_xy), xyz_from_xyY(g_xy), xyz_from_xyY(b_xy)], axis=1
        )
        c = np.linalg.solve(rgb, wp)
        self.xyz_from_rgb = rgb @ np.diag(c)
        self.rgb_from_xyz = np.linalg.inv(self.xyz_from_rgb)


@functools.lru_cache(None)
def srgb():
    """sRGB with the D6500 whitepoint (reference global_spectra.cu:34-44)."""
    return ColorSpace((0.64, 0.33), (0.3, 0.6), (0.15, 0.06), cie.illum_d65())


# chromatic adaptation (reference spectrum_util/color_encoding.h:94-125)
_LMS_FROM_XYZ = np.array([
    [0.8951, 0.2664, -0.1614],
    [-0.7502, 1.7135, 0.0367],
    [0.0389, -0.0685, 1.0296],
])
_XYZ_FROM_LMS = np.array([
    [0.986993, -0.147054, 0.159963],
    [0.432305, 0.51836, 0.0492912],
    [-0.00852866, 0.0400428, 0.968487],
])


def white_balance_matrix(src_white_xy, dst_white_xy):
    """3x3 XYZ->XYZ matrix adapting src white to dst white."""
    src = _LMS_FROM_XYZ @ xyz_from_xyY(src_white_xy)
    dst = _LMS_FROM_XYZ @ xyz_from_xyY(dst_white_xy)
    return _XYZ_FROM_LMS @ np.diag(dst / np.maximum(src, 1e-12)) @ _LMS_FROM_XYZ


# --------------------------------------------------------------- device math


@functools.lru_cache(None)
def cie_xyz_dense():
    """(3, 471) float32 numpy: the CIE X, Y, Z matching curves."""
    return np.stack([cie.X(), cie.Y(), cie.Z()]).astype(np.float32)


def to_sensor_rgb(L, lam, pdf, cie_xyz):
    """Spectral radiance -> sensor (XYZ) RGB (reference pixel_sensor.h:20-27):
    mean over the 4 wavelengths of X(λ)·L/pdf, etc. The imaging ratio is
    applied once, in film.develop.

    L, lam, pdf: (..., 4); cie_xyz: (3, 471) tensor -> (..., 3)."""
    s = torch.where(pdf != 0.0, L / torch.where(pdf == 0.0, 1.0, pdf), 0.0)
    curves = cie_xyz[:, spectra.lam_bins(lam)]               # (3, ..., 4)
    xyz = torch.mean(curves * s, dim=-1)                     # (3, ...)
    return torch.movedim(xyz, 0, -1)


def apply_matrix(m, rgb):
    """(3,3) color matrix applied to (..., 3)."""
    return rgb @ torch.as_tensor(np.asarray(m), dtype=rgb.dtype, device=rgb.device).T


def srgb_encode(linear):
    """Linear -> sRGB gamma (reference color_encoding.h sRGB curve)."""
    linear = torch.clamp(linear, 0.0, 1.0)
    return torch.where(
        linear <= 0.0031308,
        12.92 * linear,
        1.055 * torch.pow(torch.clamp(linear, min=1e-10), 1.0 / 2.4) - 0.055,
    )
