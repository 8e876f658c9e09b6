"""Rays for the dense triangle sweep (K3, pbrt_tpu_torch/csrc/
dense_intersect.cu) shared by the CPU tests and the gpu tests: rays aimed
through the edges that two triangles of a table share (the diagonals of
the quads), where both triangles are hit at the same t, rays aimed inside
its triangles, and the count of exact ties. Torch only."""
import numpy as np
import torch

from pbrt_tpu_torch.geometry import intersect as ix


def shared_edges(p0, p1, p2):
    """[(i, j, a, b)]: triangles i < j that share the vertices a and b
    (bit-equal), over (T, 3) tables."""
    verts = torch.stack([p0, p1, p2], dim=1).cpu().numpy()
    out = []
    for i in range(len(verts)):
        for j in range(i + 1, len(verts)):
            common = [v for v in verts[i] if any((v == w).all() for w in verts[j])]
            if len(common) == 2:
                out.append((i, j, common[0], common[1]))
    return out


def tie_rays(p0, p1, p2, n, seed):
    """n rays from points inside the table's bounds through points of its
    shared edges: o, d (R, 3) and t_max (R,) of INFINITY, float32, on the
    table's device."""
    edges = shared_edges(p0, p1, p2)
    g = np.random.default_rng(seed)
    pts = torch.cat([p0, p1, p2]).cpu().numpy().astype(np.float64)
    lo, hi = pts.min(0), pts.max(0)
    e = g.integers(0, len(edges), n)
    a = np.array([edges[k][2] for k in e], np.float64)
    b = np.array([edges[k][3] for k in e], np.float64)
    target = a + g.uniform(0.05, 0.95, (n, 1)) * (b - a)
    o = (lo + (hi - lo) * g.uniform(0.1, 0.9, (n, 3))).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dev = p0.device
    return (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            torch.full((n,), ix.INFINITY, device=dev))


def aimed_rays(p0, p1, p2, lo, hi, n, seed):
    """n rays from points of the box [lo, hi] towards points inside random
    triangles of the table (uniform barycentrics): o, d, t_max of
    INFINITY, float32, on the table's device."""
    g = np.random.default_rng(seed)
    k = g.integers(0, p0.shape[0], n)
    u = g.uniform(0.0, 1.0, (n, 2))
    u = np.where(u.sum(1, keepdims=True) > 1.0, 1.0 - u, u)
    v = [p.cpu().numpy().astype(np.float64)[k] for p in (p0, p1, p2)]
    target = v[0] + u[:, :1] * (v[1] - v[0]) + u[:, 1:] * (v[2] - v[0])
    lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
    o = (lo + (hi - lo) * g.uniform(0.05, 0.95, (n, 3))).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dev = p0.device
    return (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            torch.full((n,), ix.INFINITY, device=dev))


def exact_ties(o, d, t_max, p0, p1, p2):
    """(R,) bool: lanes whose nearest t is reached by two or more
    triangles (the plain block's t, bit-equal)."""
    t, hit = ix.intersect_tri_block(o, ix.ray_shear(d), t_max, p0, p1, p2)
    t = torch.where(hit, t, ix.INFINITY)
    t_min = t.min(dim=1, keepdim=True).values
    return ((t == t_min) & hit).sum(dim=1) >= 2
