"""Discrete sampling with alias tables (counterpart of
pbrt_tpu/distribution/distributions.py:19-60; reference
distribution/alias_table.cu): the table is built on the host with Vose's
algorithm in float64 numpy, and a draw is two gathers a lane."""
import numpy as np
import torch


def alias_table_build(values):
    """Vose's O(N) alias table (reference alias_table.cu:9-104):
    weights (N,) -> (q (N,) f32, alias (N,) i32, pdf (N,) f32)."""
    values = np.asarray(values, np.float64).reshape(-1)
    n = values.size
    total = values.sum()
    if total <= 0:
        return (np.ones(n, np.float32), np.arange(n, dtype=np.int32),
                np.full(n, 1.0 / n, np.float32))
    pdf = values / total
    scaled = pdf * n
    q = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        q[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        q[i] = 1.0
        alias[i] = i
    return q.astype(np.float32), alias, pdf.astype(np.float32)


def alias_sample(q, alias, u):
    """u (R,) float32 in [0, 1) -> (idx (R,) int64, u_remapped (R,)): the
    alias draw and its conditional remainder, uniform in [0, 1) given idx.
    q (N,) float32, alias (N,) integer tensors on u's device."""
    n = q.shape[0]
    x = u * n
    i = torch.clamp(torch.floor(x).to(torch.int32), 0, n - 1).long()
    frac = x - i.to(torch.float32)
    qi = q[i]
    accept = frac < qi
    idx = torch.where(accept, i, alias[i].long())
    u2 = torch.where(accept, frac / torch.clamp(qi, min=1e-12),
                     (frac - qi) / torch.clamp(1.0 - qi, min=1e-12))
    return idx, torch.clamp(u2, 0.0, 1.0 - 1e-7)
