"""4x4 homogeneous transforms as plain `(4, 4)` float64 numpy arrays.

Counterpart of reference euclidean_space/transform.h (436 LoC):
the scene builder composes these on host with numpy float64 for robustness.
Device code applies the compiled camera matrices in cameras/perspective.py.
"""
import numpy as np


# ---------------------------------------------------------------- host build


def identity():
    return np.eye(4, dtype=np.float64)


def translate(dx, dy, dz):
    m = identity()
    m[:3, 3] = [dx, dy, dz]
    return m


def scale(sx, sy, sz):
    return np.diag([sx, sy, sz, 1.0]).astype(np.float64)


def rotate(angle_deg, ax, ay, az):
    """Rotation about arbitrary axis (reference transform.h `rotate`)."""
    a = np.array([ax, ay, az], dtype=np.float64)
    a /= np.linalg.norm(a)
    s = np.sin(np.deg2rad(angle_deg))
    c = np.cos(np.deg2rad(angle_deg))
    m = identity()
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    return m


def rotate_from_to(src, dst):
    """Rotation taking unit vector src to dst (reference transform.h
    `rotate_from_to`, used by scene_builder.cu:601)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    # pick reflection axis component-wise farthest from both
    refl = np.zeros(3)
    h = np.abs(src) < 0.72
    if h[0] and np.abs(dst[0]) < 0.72:
        refl[0] = 1.0
    elif np.abs(src[1]) < 0.72 and np.abs(dst[1]) < 0.72:
        refl[1] = 1.0
    else:
        refl[2] = 1.0
    u = refl - src
    v = refl - dst
    m = identity()
    for i in range(3):
        for j in range(3):
            m[i, j] = (
                (1.0 if i == j else 0.0)
                - 2.0 / np.dot(u, u) * u[i] * u[j]
                - 2.0 / np.dot(v, v) * v[i] * v[j]
                + 4.0 * np.dot(u, v) / (np.dot(u, u) * np.dot(v, v)) * v[i] * u[j]
            )
    return m


def lookat(eye, look, up):
    """Camera-to-world (reference transform.h `lookat`)."""
    eye = np.asarray(eye, dtype=np.float64)
    look = np.asarray(look, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    d = look - eye
    d /= np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    n = np.linalg.norm(right)
    if n < 1e-12:
        raise ValueError("LookAt: up vector parallel to viewing direction")
    right /= n
    new_up = np.cross(d, right)
    m = identity()
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m


def perspective(fov_deg, znear, zfar):
    """Perspective projection (reference transform.h `perspective`)."""
    m = identity()
    m[2, 2] = zfar / (zfar - znear)
    m[2, 3] = -zfar * znear / (zfar - znear)
    m[3, 2] = 1.0
    m[3, 3] = 0.0
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    return scale(inv_tan, inv_tan, 1.0) @ m


def inverse(m):
    return np.linalg.inv(m)
