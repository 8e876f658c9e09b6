"""Vector math over (..., 3) tensors (counterpart of
pbrt_tpu/geometry/vecmath.py): points, vectors and normals are all plain
float tensors."""
import torch

from pbrt_tpu_torch.utils.math import safe_sqrt, safe_asin


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v):
    return dot(v, v)


def length(v):
    return safe_sqrt(length_squared(v))


def normalize(v):
    return v / torch.clamp(length(v), min=1e-12)[..., None]


def distance(a, b):
    return length(a - b)


def face_forward(n, v):
    """Flip n to the hemisphere of v (reference euclidean_space/vector3.h)."""
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def coordinate_system(v1):
    """Orthonormal basis around unit v1 (Duff et al. 2017)."""
    z = v1[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = v1[..., 0] * v1[..., 1] * a
    v2 = torch.stack(
        [1.0 + sign * v1[..., 0] ** 2 * a, sign * b, -sign * v1[..., 0]], dim=-1
    )
    v3 = torch.stack([b, sign + v1[..., 1] ** 2 * a, -v1[..., 1]], dim=-1)
    return v2, v3


def gram_schmidt(v, w):
    return v - dot(v, w)[..., None] * w


def angle_between(a, b):
    """Numerically-stable angle between unit vectors."""
    return torch.where(
        dot(a, b) < 0,
        torch.pi - 2.0 * safe_asin(length(a + b) / 2.0),
        2.0 * safe_asin(length(b - a) / 2.0),
    )


def spherical_triangle_area(a, b, c):
    return torch.abs(
        2.0 * torch.arctan2(dot(a, cross(b, c)), 1.0 + dot(a, b) + dot(a, c) + dot(b, c))
    )


def spherical_direction(sin_theta, cos_theta, phi):
    st = torch.clamp(sin_theta, -1.0, 1.0)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                        torch.clamp(cos_theta, -1.0, 1.0)], dim=-1)


def frame_from_z(z):
    """Orthonormal frame with given unit z; returns (x, y, z)."""
    z = normalize(z)
    x, y = coordinate_system(z)
    return x, y, z


def to_local(x, y, z, v):
    return torch.stack([dot(v, x), dot(v, y), dot(v, z)], dim=-1)


def from_local(x, y, z, v):
    return v[..., 0:1] * x + v[..., 1:2] * y + v[..., 2:3] * z
