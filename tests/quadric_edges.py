"""Clip-edge distance of partial spheres and disks, for the checks that hold
the dense quadric kernel (K4) against its plain version (tests and
chip_smoke.py): the kernel's atan2f and torch.atan2 may round phi apart by
an ulp, so the two may disagree on a hit only where this distance is tiny."""
import torch

from pbrt_tpu_torch.utils.math import INFINITY, PI, clamp_mag, safe_sqrt


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _phi(y, x):
    phi = torch.atan2(y, x)
    return torch.where(phi < 0.0, phi + 2.0 * PI, phi)


def clip_edge_distance(o, d, sph=None, dsk=None):
    """Per ray (R,), the least distance of any candidate hit to a clip edge
    of a partial quadric (intersect.SphereSoA / DiskSoA): |phi - phimax| or
    phi to the 0 / 2 pi seam in radians, and |z - zmin + zeps|,
    |z - zmax - zeps| in units of the radius."""
    best = torch.full((o.shape[0],), INFINITY, device=o.device)

    def phi_edges(phi, phimax):
        return torch.minimum(torch.minimum((phi - phimax).abs(), phi), 2.0 * PI - phi)

    if sph is not None and sph.rot is not None:
        oc = o[:, None, :] - sph.center[None]
        dd = d[:, None, :]
        a, b = _dot3(dd, dd), 2.0 * _dot3(oc, dd)
        c = _dot3(oc, oc) - sph.radius * sph.radius
        sq = safe_sqrt(b * b - 4.0 * a * c)
        q = -0.5 * (b + torch.where(b < 0, -sq, sq))
        for t in (q / clamp_mag(a, 1e-12), c / clamp_mag(q, 1e-12)):
            rel = (o[:, None, :] + t[..., None] * dd) - sph.center[None]
            loc = [sum(rel[..., j] * sph.rot[None, :, j, i] for j in range(3)) for i in range(3)]
            zeps = 1e-4 * sph.radius
            e = torch.minimum(phi_edges(_phi(loc[1], loc[0]), sph.phimax),
                              torch.minimum((loc[2] - sph.zmin + zeps).abs(),
                                            (loc[2] - sph.zmax - zeps).abs()) / sph.radius)
            best = torch.minimum(best, e.amin(dim=1))
    if dsk is not None and dsk.xaxis is not None:
        nrm = dsk.normal[None]
        t = -_dot3(o[:, None, :] - dsk.center[None], nrm) / _dot3(d[:, None, :], nrm)
        rel = (o[:, None, :] + t[..., None] * d[:, None, :]) - dsk.center[None]
        phi = _phi(_dot3(rel, dsk.yaxis[None]), _dot3(rel, dsk.xaxis[None]))
        best = torch.minimum(best, phi_edges(phi, dsk.phimax).amin(dim=1))
    return best
