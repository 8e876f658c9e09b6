"""Pixel reconstruction filters: box and mitchell (counterpart of
pbrt_tpu/filters/filters.py; reference filters/ + filter_sampler.{h,cu}).

The filter sampler's piecewise-constant 2D distribution is tabulated on the
host at scene-compile time (numpy); the device inverts it per lane. Mitchell
goes negative, so the table keeps the signed f while the CDFs are built over
|f|, and the returned weight f/pdf can be negative.
"""
from typing import NamedTuple

import numpy as np
import torch

FILTER_DEFAULT_RADIUS = {"box": 0.5, "mitchell": 2.0}


class FilterTables(NamedTuple):
    radius: np.ndarray     # (2,) f32
    f: np.ndarray          # (ny, nx) signed filter values at cell centers
    cond_cdf: np.ndarray   # (ny, nx+1)
    cond_func: np.ndarray  # (ny, nx) |f|
    cond_int: np.ndarray   # (ny,) row integrals
    marg_cdf: np.ndarray   # (ny+1,)
    marg_int: np.ndarray   # ()
    integral: np.ndarray   # ()


def _mitchell_1d(x, b, c):
    x = np.abs(x)
    y1 = ((12 - 9 * b - 6 * c) * x**3 + (-18 + 12 * b + 6 * c) * x**2 + (6 - 2 * b)) / 6.0
    y2 = ((-b - 6 * c) * x**3 + (6 * b + 30 * c) * x**2 + (-12 * b - 48 * c) * x
          + (8 * b + 24 * c)) / 6.0
    return np.where(x <= 1, y1, np.where(x <= 2, y2, 0.0))


def evaluate_np(kind, p, params):
    """Host filter evaluation at (..., 2) points."""
    rx, ry = params["radius"]
    x, y = p[..., 0], p[..., 1]
    if kind == "box":
        return ((np.abs(x) <= rx) & (np.abs(y) <= ry)).astype(np.float64)
    if kind == "mitchell":
        b, c = params["b"], params["c"]
        return _mitchell_1d(2 * x / rx, b, c) * _mitchell_1d(2 * y / ry, b, c)
    raise ValueError(kind)


def _pc1d_cdf(func_abs, lo, hi):
    """PiecewiseConstant1D CDF build (piecewise_constant_1d.h:27-46)."""
    n = func_abs.shape[-1]
    steps = func_abs * (hi - lo) / n
    cdf = np.concatenate(
        [np.zeros(func_abs.shape[:-1] + (1,)), np.cumsum(steps, axis=-1)], axis=-1
    )
    func_int = cdf[..., -1].copy()
    uniform = np.linspace(0.0, 1.0, n + 1)
    zero = func_int <= 0
    cdf = np.where(
        zero[..., None], np.broadcast_to(uniform, cdf.shape), cdf / np.maximum(func_int, 1e-30)[..., None]
    )
    return cdf, func_int


def build_filter(spec: dict):
    """Host: filter spec dict (from SceneBuilder) -> (kind, params,
    FilterTables of float32 numpy). 32 table cells per unit radius."""
    kind = spec.get("type", "mitchell")
    if kind not in FILTER_DEFAULT_RADIUS:
        raise NotImplementedError(
            f"filter {kind!r}: only box and mitchell are ported so far")
    default_r = FILTER_DEFAULT_RADIUS[kind]
    rx = float(spec.get("xradius") if spec.get("xradius") is not None else default_r)
    ry = float(spec.get("yradius") if spec.get("yradius") is not None else default_r)
    params = {"radius": (rx, ry)}
    if kind == "mitchell":
        params["b"] = float(spec.get("B", 1.0 / 3.0))
        params["c"] = float(spec.get("C", 1.0 / 3.0))

    if kind == "box":
        f = np.ones((1, 1))
        cond_cdf = np.array([[0.0, 1.0]])
        cond_func = np.ones((1, 1))
        cond_int = np.ones((1,))
        marg_cdf = np.array([0.0, 1.0])
        marg_int = 1.0
        integral = 4 * rx * ry
    else:
        nx, ny = max(int(32 * rx), 2), max(int(32 * ry), 2)
        xs = -rx + (np.arange(nx) + 0.5) / nx * (2 * rx)
        ys = -ry + (np.arange(ny) + 0.5) / ny * (2 * ry)
        p = np.stack(np.meshgrid(xs, ys, indexing="xy"), axis=-1)
        f = evaluate_np(kind, p, params)
        cond_func = np.abs(f)
        cond_cdf, cond_int = _pc1d_cdf(cond_func, -rx, rx)
        marg_cdf, marg_int = _pc1d_cdf(cond_int[None], -ry, ry)
        marg_cdf, marg_int = marg_cdf[0], float(marg_int[0])
        integral = rx * ry / 4.0  # mitchell.h get_integral

    f32 = np.float32
    tables = FilterTables(
        radius=np.asarray([rx, ry], f32),
        f=np.asarray(f, f32),
        cond_cdf=np.asarray(cond_cdf, f32),
        cond_func=np.asarray(cond_func, f32),
        cond_int=np.asarray(cond_int, f32),
        marg_cdf=np.asarray(marg_cdf, f32),
        marg_int=np.asarray(marg_int, f32),
        integral=np.asarray(integral, f32),
    )
    return kind, params, tables


# ------------------------------------------------------------------ device


def _pc1d_sample(cdf, func, func_int, u, lo, hi):
    """PiecewiseConstant1D::sample (piecewise_constant_1d.h:54-76).
    cdf: (n+1,) or (R, n+1); func: (n,) or (R, n). Returns (x, pdf, idx)."""
    n = func.shape[-1]
    if cdf.ndim == 1:
        o = torch.searchsorted(cdf, u.contiguous(), right=True) - 1
    else:
        o = torch.sum(cdf <= u[..., None], dim=-1) - 1
    o = torch.clamp(o, 0, n - 1)
    if cdf.ndim > 1:
        c0 = torch.gather(cdf, -1, o[..., None])[..., 0]
        c1 = torch.gather(cdf, -1, o[..., None] + 1)[..., 0]
        fo = torch.gather(func, -1, o[..., None])[..., 0]
    else:
        c0, c1, fo = cdf[o], cdf[o + 1], func[o]
    du = torch.where(c1 - c0 > 0, (u - c0) / torch.clamp(c1 - c0, min=1e-30), 0.0)
    pdf = torch.where(func_int > 0, fo / torch.clamp(func_int, min=1e-30), 0.0)
    x = lo + (o + du) / n * (hi - lo)
    return x, pdf, o


def sample(tables, kind: str, u2):
    """u2 (R,2) in [0,1)^2 -> (offset p (R,2), weight (R,)); tables hold
    device tensors (Scene.filt)."""
    rx, ry = tables.radius[0], tables.radius[1]
    if kind == "box":
        p = torch.stack([(2.0 * u2[..., 0] - 1.0) * rx, (2.0 * u2[..., 1] - 1.0) * ry], -1)
        return p, torch.ones(u2.shape[:-1], device=u2.device)
    if kind != "mitchell":
        raise NotImplementedError(f"filter {kind!r}")
    y, pdf_y, yi = _pc1d_sample(
        tables.marg_cdf, tables.cond_int, tables.marg_int, u2[..., 1], -ry, ry
    )
    row_cdf = tables.cond_cdf[yi]
    row_func = tables.cond_func[yi]
    row_int = tables.cond_int[yi]
    x, pdf_x, xi = _pc1d_sample(row_cdf, row_func, row_int, u2[..., 0], -rx, rx)
    pdf = pdf_x * pdf_y
    f_signed = tables.f[yi, xi]
    w = torch.where(pdf > 0, f_signed / torch.clamp(pdf, min=1e-30), 0.0)
    return torch.stack([x, y], -1), w
