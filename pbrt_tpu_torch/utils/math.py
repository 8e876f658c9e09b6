"""Scalar math helpers shared across the renderer (counterpart of
pbrt_tpu/utils/math.py): constants, the floating-point error bound, and
small torch helpers. The gradient-clipping and custom-derivative wrappers of
the JAX package are not needed by the forward render and are not ported."""
import numpy as np
import torch

INFINITY = float(np.finfo(np.float32).max)  # "no hit" t; finite to keep arithmetic sane
PI = float(np.pi)
INV_PI = float(1.0 / np.pi)
PI_OVER_2 = float(np.pi / 2.0)
PI_OVER_4 = float(np.pi / 4.0)
MACHINE_EPSILON = float(np.finfo(np.float32).eps * 0.5)


def gamma(n):
    """FP rounding error bound: n*eps/(1-n*eps) (reference util/math.h)."""
    return (n * MACHINE_EPSILON) / (1 - n * MACHINE_EPSILON)


def sqr(x):
    return x * x


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_asin(x):
    return torch.arcsin(torch.clamp(x, -1.0, 1.0))


def safe_div(a, b):
    """a/b with 0 where b == 0."""
    return torch.where(b != 0.0, a / torch.where(b == 0.0, 1.0, b), 0.0)


def clamp_mag(b, eps):
    """b pushed away from 0 to at least magnitude eps (sign-preserving;
    exact 0 maps to +eps)."""
    mag = torch.maximum(torch.abs(b), torch.as_tensor(eps, dtype=b.dtype, device=b.device))
    return torch.where(b < 0.0, -mag, mag)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic beta=2 (reference util/sampling.h:310)."""
    f = nf * f_pdf
    g = ng * g_pdf
    f2 = sqr(f)
    return torch.where(torch.isinf(f2), 1.0, safe_div(f2, f2 + sqr(g)))


def smoothstep(x, a, b):
    t = torch.clamp(safe_div(x - a, b - a), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def encode_morton3(x, y, z):
    """Interleave lower 10 bits of x,y,z into a 30-bit morton code (host
    numpy; reference util/math.h:206)."""
    def expand(v):
        v = np.asarray(v, dtype=np.uint32)
        v = (v | (v << 16)) & np.uint32(0x030000FF)
        v = (v | (v << 8)) & np.uint32(0x0300F00F)
        v = (v | (v << 4)) & np.uint32(0x030C30C3)
        v = (v | (v << 2)) & np.uint32(0x09249249)
        return v

    return (expand(z) << 2) | (expand(y) << 1) | expand(x)
