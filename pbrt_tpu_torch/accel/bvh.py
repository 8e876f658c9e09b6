"""Wide BVH over the triangle soup: host build and device traversal.

Counterpart of pbrt_tpu/accel/bvh.py (reference accelerator/hlbvh.cu).

Build (host, numpy, scene-compile time): the same binned-SAH binary build,
8-wide collapse and leaf padding as the JAX package, so the `rows` and `src`
tables come out byte-identical. One unified row table of ROW_W float32:
  - internal row i < n_int: 8 x [lo(3) hi(3)] child boxes, then 8 child ids
    as exact small floats (empty slots: inverted box, id -1);
  - leaf row n_int + c: the LEAF_K triangles of chunk c, [p0 p1 p2] each.
An instanced scene has a two-level table (`build_two_level`): a top tree
over its static triangles and its instances' world boxes, instance rows
between the internal and the leaf rows, and one shared bottom tree per
prototype in object space.

Traversal (device): `closest_hit_tris` / `any_hit_tris` launch the CUDA
kernels of csrc/bvh_traverse.cu on CUDA tensors: K1, or K1i on a two-level
table, both csrc/bvh_wide.cuh's loop (persistent warps, whole-row 16-byte
loads, one shared-memory stack entry per pending child; K1i enters an
instance row in the same loop). On CPU tensors they run the kernel's plain
version, a chunked dense watertight sweep over the padded leaf soup (each chunk against
the rays that meet its bounds; per instance over its prototype's rows with
the rays in its object space), which computes the same (t, prim, inst)
function. The TPU's compaction
ladder, dense tail sweep, one-hot child select and PBRT_TPU_BVH_* tuning
knobs are not ported: they existed because masked-dense execution on the TPU
is gated by the worst lane.
"""
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pbrt_tpu_torch.utils.math import INFINITY, encode_morton3, gamma
from pbrt_tpu_torch.geometry import intersect as ix

LEAF_K = 8          # triangles per leaf row
WIDTH = 8           # children per internal row
ROW_W = 72          # max(7 * WIDTH, 9 * LEAF_K) float32 per row
MIN_TRIS_FOR_BVH = 64  # below this the JAX package uses the dense kernel

_SAH_BINS = 16
_SAH_MIN = 17          # ranges smaller than this split at the median instead
_MAX_DEPTH = 48        # beyond this, force median splits (degenerate scenes)


class BvhBuild(NamedTuple):
    """Host-side build result."""

    rows: np.ndarray       # (n_int + n_leaves, ROW_W) f32 unified table
    src: np.ndarray        # (n_leaves*K,) i32: source tri index per padded
                           # leaf-order row, -1 for padding
    n_int: int             # internal row count (leaf chunk c = row n_int+c)
    n_padded: int          # n_leaves * K
    max_depth: int         # deepest internal chain (stack bound)


class Bvh2Build(NamedTuple):
    """Two-level (TLAS + per-prototype BLAS) build result (reference keeps a
    sub-BVH per ObjectBegin definition wrapped in a TransformedPrimitive,
    scene_builder.cu:70-90,809-876 + primitives/transformed_primitive.h:7-33).

    Unified row table layout: [internal | instance | leaf] — row type is a
    range check on the id, so traversal stays one gather per step. Instance
    row: [w2o 3x4 row-major (12) | blas_root id | instance id | 0...].
    """

    rows: np.ndarray       # (n_int + n_inst + n_leaves, ROW_W)
    src: np.ndarray        # (n_leaves*K,) i32 into the CONCATENATED source
                           # soup [static tris | proto0 tris | proto1 ...]
    n_int: int
    n_inst: int
    n_padded: int
    max_depth: int         # top depth + max BLAS depth + restore margin
    iter_bound: int        # safety-loop bound (sum of per-tree bounds)
    leaf_ranges: tuple     # (first, end) leaf rows of the static triangles,
                           # then of each prototype (the plain traversal's sweeps)


def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def _build_binary(tri_lo, tri_hi, cent, order, leaf_k, big_from=None):
    """Binned-SAH binary BVH. Returns (nodes, leaves, root):
    nodes: list of (lo, hi, left, right) with child refs ('n', i)/('l', j)/
    ('i', prim_id); leaves: list of id arrays (each <= leaf_k source ids).

    Ids >= `big_from` are "big" primitives (instances): they always become
    SINGLETON ('i', id) leaves — a range containing one is force-split until
    the instance is alone, so triangle leaf chunks stay homogeneous."""
    nodes = []   # (lo, hi, left_ref, right_ref)
    leaves = []

    # explicit stack of (ids, slot_setter); build root iteratively
    result_root = [None]

    def setter_of(parent_idx, side):
        def set_ref(ref):
            lo, hi, l, r = nodes[parent_idx]
            nodes[parent_idx] = (lo, hi, ref if side == 0 else l,
                                 ref if side == 1 else r)
        return set_ref

    stack = [(order, (lambda ref: result_root.__setitem__(0, ref)), 0)]
    while stack:
        ids, set_ref, depth = stack.pop()
        n = ids.shape[0]
        has_big = big_from is not None and bool(np.any(ids >= big_from))
        if n == 1 and has_big:
            set_ref(("i", int(ids[0])))
            continue
        if n <= leaf_k and not has_big:
            leaves.append(ids)
            set_ref(("l", len(leaves) - 1))
            continue
        if n <= leaf_k and has_big:
            # force-split mixed/instance ranges down to singleton instances
            c_ax = cent[ids]
            axis0 = int(np.argmax(c_ax.max(0) - c_ax.min(0)))
            s = np.argsort(c_ax[:, axis0], kind="stable")
            ids = ids[s]
            mid = max(1, n // 2)
            me = len(nodes)
            lo = tri_lo[ids].min(0).astype(np.float32)
            hi = tri_hi[ids].max(0).astype(np.float32)
            nodes.append((lo, hi, None, None))
            set_ref(("n", me))
            stack.append((ids[:mid], setter_of(me, 0), depth + 1))
            stack.append((ids[mid:], setter_of(me, 1), depth + 1))
            continue

        lo = tri_lo[ids].min(0)
        hi = tri_hi[ids].max(0)
        c = cent[ids]
        clo = c.min(0)
        chi = c.max(0)
        ext = chi - clo
        axis = int(np.argmax(ext))

        split = None
        if n >= _SAH_MIN and depth < _MAX_DEPTH and ext[axis] > 0:
            # ---- binned SAH over ALL THREE centroid axes (the reference
            # bins only along each treelet axis, hlbvh.cu:636-813; sweeping
            # all axes at 16 bins measurably tightens boxes on anisotropic
            # meshes like height fields — fewer node visits per ray)
            best_cost, best_split = np.inf, None
            for ax in range(3):
                if ext[ax] <= 0:
                    continue
                t = (c[:, ax] - clo[ax]) * (_SAH_BINS / ext[ax])
                b = np.minimum(t.astype(np.int32), _SAH_BINS - 1)
                counts = np.bincount(b, minlength=_SAH_BINS)
                sort = np.argsort(b, kind="stable")
                ids_sorted = ids[sort]
                starts = np.zeros(_SAH_BINS, np.int64)
                starts[1:] = np.cumsum(counts)[:-1]
                nonempty = counts > 0
                # reduceat needs strictly valid starts; use nonempty bins
                ne_starts = starts[nonempty]
                blo = np.full((_SAH_BINS, 3), np.inf, np.float64)
                bhi = np.full((_SAH_BINS, 3), -np.inf, np.float64)
                blo[nonempty] = np.minimum.reduceat(
                    tri_lo[ids_sorted], ne_starts, axis=0)
                bhi[nonempty] = np.maximum.reduceat(
                    tri_hi[ids_sorted], ne_starts, axis=0)
                # prefix/suffix bounds + counts over bins
                plo = np.minimum.accumulate(blo, axis=0)
                phi = np.maximum.accumulate(bhi, axis=0)
                slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
                shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
                cl = np.cumsum(counts)
                cr = n - cl
                # split after bin i (i = 0.._SAH_BINS-2)
                costs = np.where(
                    (cl[:-1] > 0) & (cr[:-1] > 0),
                    _surface_area(plo[:-1], phi[:-1]) * cl[:-1]
                    + _surface_area(slo[1:], shi[1:]) * cr[:-1],
                    np.inf,
                )
                bi = int(np.argmin(costs))
                if costs[bi] < best_cost:
                    best_cost = costs[bi]
                    mid = int(cl[bi])
                    best_split = (ids_sorted[:mid], ids_sorted[mid:])
            if best_split is not None:
                split = best_split
        if split is None:
            # median of the current (morton / bin-sorted) order; for tiny or
            # degenerate ranges this is the LBVH topology
            if n >= _SAH_MIN and ext[axis] > 0:
                sort = np.argsort(c[:, axis], kind="stable")
                ids = ids[sort]
            mid = n // 2
            split = (ids[:mid], ids[mid:])

        me = len(nodes)
        nodes.append((lo.astype(np.float32), hi.astype(np.float32), None, None))
        set_ref(("n", me))
        stack.append((split[0], setter_of(me, 0), depth + 1))
        stack.append((split[1], setter_of(me, 1), depth + 1))

    return nodes, leaves, result_root[0]


def _collapse_wide(nodes, leaves, root_ref, tri_lo, tri_hi, width):
    """Collapse the binary tree into width-wide nodes (largest-area slot
    expanded first). Returns (wide, order): wide = list of slot lists, each
    slot = (lo, hi, ref) with ref ('w', wide_idx) or ('l', leaf_idx);
    leaves re-emitted in DFS order for locality via `leaf_order`."""

    def bounds_of(ref):
        if ref[0] == "n":
            lo, hi, _, _ = nodes[ref[1]]
            return lo, hi
        if ref[0] == "i":
            return (tri_lo[ref[1]].astype(np.float32),
                    tri_hi[ref[1]].astype(np.float32))
        ids = leaves[ref[1]]
        return tri_lo[ids].min(0).astype(np.float32), tri_hi[ids].max(0).astype(np.float32)

    wide = []        # slot lists; refs into wide/leaf, patched below
    leaf_order = []  # binary-leaf index per emitted chunk

    def emit(ref):
        """Emit the subtree at `ref` as a wide node; returns ('w', idx),
        ('l', chunk) or ('i', prim_id) (instance pseudo-leaf)."""
        if ref[0] == "i":
            return ref
        if ref[0] == "l":
            leaf_order.append(ref[1])
            return ("l", len(leaf_order) - 1)
        # gather up to `width` slot refs by expanding the largest-area
        # internal slot until full
        slots = [ref]
        while len(slots) < width:
            best, best_area = -1, -1.0
            for i, s in enumerate(slots):
                if s[0] == "n":
                    lo, hi, _, _ = nodes[s[1]]
                    a = float(_surface_area(lo, hi))
                    if a > best_area:
                        best, best_area = i, a
            if best < 0:
                break
            _, _, l, r = nodes[slots[best][1]]
            slots[best: best + 1] = [l, r]
        me = len(wide)
        wide.append(None)
        out = []
        for s in slots:
            lo, hi = bounds_of(s)
            out.append((lo, hi, emit(s)))
        wide[me] = out
        return ("w", me)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        root = emit(root_ref)
    finally:
        sys.setrecursionlimit(old)
    return wide, leaf_order, root


def build_bvh(p0, p1, p2, leaf_k=LEAF_K):
    """Build the SAH wide BVH over triangles (T, 3)x3 -> BvhBuild.

    The caller must reorder all per-triangle scene columns into padded leaf
    order via `src` (src[i] < 0 rows are degenerate never-hit padding).
    """
    T = p0.shape[0]
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    cent = 0.5 * (tri_lo + tri_hi)

    # initial morton order: keeps median-fallback splits spatial and gives
    # bin sorts a good secondary order (reference hlbvh.cu:229)
    lo = cent.min(0)
    extent = np.maximum(cent.max(0) - lo, 1e-30)
    q = np.clip(((cent - lo) / extent) * 1023.0, 0.0, 1023.0).astype(np.uint32)
    codes = encode_morton3(q[:, 0], q[:, 1], q[:, 2])
    order = np.argsort(codes, kind="stable").astype(np.int64)

    nodes, leaves, root_ref = _build_binary(tri_lo, tri_hi, cent, order, leaf_k)
    wide, leaf_order, root = _collapse_wide(
        nodes, leaves, root_ref, tri_lo, tri_hi, WIDTH
    )

    n_leaves = len(leaf_order)
    n_padded = n_leaves * leaf_k
    src = np.full(n_padded, -1, np.int32)
    for chunk, bleaf in enumerate(leaf_order):
        ids = leaves[bleaf]
        src[chunk * leaf_k: chunk * leaf_k + ids.shape[0]] = ids

    row_w = max(6 * WIDTH + WIDTH, 9 * leaf_k)
    BIG = np.float32(3e38)

    if not wide:
        # single-leaf scene: no internal rows
        n_int = 0
        rows = np.zeros((n_leaves, row_w), np.float32)
        max_depth = 1
    else:
        n_int = len(wide)
        rows = np.zeros((n_int + n_leaves, row_w), np.float32)
        # internal rows: 8x [lo hi] + 8 child ids (unified: leaf chunk c ->
        # id n_int + c)
        for i, slots in enumerate(wide):
            r = rows[i]
            r[0: 6 * WIDTH: 6] = BIG      # default: inverted boxes
            r[3: 6 * WIDTH: 6] = -BIG
            r[6 * WIDTH:] = -1.0
            for s, (slo, shi, ref) in enumerate(slots):
                r[s * 6: s * 6 + 3] = slo
                r[s * 6 + 3: s * 6 + 6] = shi
                cid = ref[1] if ref[0] == "w" else n_int + ref[1]
                r[6 * WIDTH + s] = float(cid)
        # depth of the wide tree (stack bound): longest internal chain
        depth = np.ones(n_int, np.int32)
        for i in range(n_int - 1, -1, -1):
            d = 1
            for _, _, ref in wide[i]:
                if ref[0] == "w":
                    d = max(d, 1 + depth[ref[1]])
            depth[i] = d
        max_depth = int(depth[0]) if n_int else 1

    # leaf rows: K triangles, [p0 p1 p2] per triangle; padding rows keep
    # all-zero vertices (degenerate, never pass the watertight test)
    mask = src >= 0
    si = np.maximum(src, 0)
    tri9 = np.concatenate([p0[si], p1[si], p2[si]], axis=1)
    tri9[~mask] = 0.0
    rows[n_int:, : leaf_k * 9] = tri9.reshape(n_leaves, leaf_k * 9)

    return BvhBuild(
        rows=rows, src=src, n_int=n_int, n_padded=n_padded,
        max_depth=max_depth,
    )


def _transform_aabb(lo, hi, m):
    """World AABB of an object-space box under affine m (3,4)."""
    corners = np.array(
        [[lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]],
         [lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]],
         [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]],
         [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]]], np.float64
    )
    w = corners @ m[:, :3].T + m[:, 3]
    return w.min(0), w.max(0)


def build_two_level(static_p, protos, inst_proto, inst_o2w, leaf_k=LEAF_K):
    """TLAS + per-prototype BLAS over shared object-space geometry.

    static_p: (T_s, 3, 3) world-space non-instanced triangles;
    protos: list of (T_p, 3, 3) object-space prototype triangles;
    inst_proto: (I,) prototype index per instance;
    inst_o2w: (I, 3, 4) object->world affine per instance.

    Returns Bvh2Build. `src` indexes the CONCATENATED soup
    [static | protos[0] | protos[1] | ...]; the caller reorders all
    per-triangle columns (built in that concatenated order) through it.
    Replaces the reference's TransformedPrimitive + sub-BVH design
    (scene_builder.cu:809-876) without flattening geometry per instance.
    """
    static_p = np.asarray(static_p, np.float32).reshape(-1, 3, 3)
    T_s = static_p.shape[0]
    I = len(inst_proto)
    inst_proto = np.asarray(inst_proto, np.int64)
    inst_o2w = np.asarray(inst_o2w, np.float64).reshape(I, 3, 4)

    # ---- BLAS per prototype (existing single-level machinery, local ids)
    blas = []
    proto_bounds = []
    for P in protos:
        P = np.asarray(P, np.float32).reshape(-1, 3, 3)
        blas.append(build_bvh(P[:, 0], P[:, 1], P[:, 2], leaf_k))
        lo = P.min(axis=(0, 1))
        hi = P.max(axis=(0, 1))
        proto_bounds.append((lo, hi))

    # ---- top-tree primitive set: static tris + instance world boxes
    s_lo = static_p.min(1)
    s_hi = static_p.max(1)
    i_lo = np.zeros((I, 3))
    i_hi = np.zeros((I, 3))
    for i in range(I):
        lo, hi = proto_bounds[inst_proto[i]]
        i_lo[i], i_hi[i] = _transform_aabb(lo, hi, inst_o2w[i])
    prim_lo = np.concatenate([s_lo, i_lo.astype(np.float32)], 0)
    prim_hi = np.concatenate([s_hi, i_hi.astype(np.float32)], 0)
    cent = 0.5 * (prim_lo + prim_hi)

    lo0 = cent.min(0)
    extent = np.maximum(cent.max(0) - lo0, 1e-30)
    q = np.clip(((cent - lo0) / extent) * 1023.0, 0.0, 1023.0).astype(np.uint32)
    codes = encode_morton3(q[:, 0], q[:, 1], q[:, 2])
    order = np.argsort(codes, kind="stable").astype(np.int64)

    nodes, leaves, root_ref = _build_binary(
        prim_lo, prim_hi, cent, order, leaf_k, big_from=T_s
    )
    wide, leaf_order, root = _collapse_wide(
        nodes, leaves, root_ref, prim_lo, prim_hi, WIDTH
    )
    if root[0] != "w":
        # degenerate top (single chunk / single instance): synthesize a root
        # so row 0 is always an internal row
        lo = prim_lo.min(0).astype(np.float32)
        hi = prim_hi.max(0).astype(np.float32)
        wide = [[(lo, hi, root)]] + wide
        # 'w' refs inside the shifted list must move by one
        wide = [
            [(slo, shi, ("w", r[1] + 1) if r[0] == "w" else r)
             for (slo, shi, r) in slots]
            for slots in wide
        ]
        root = ("w", 0)

    A = len(wide)
    n_top_leaves = len(leaf_order)
    int_off = []
    acc = A
    for b in blas:
        int_off.append(acc)
        acc += b.n_int
    n_int = acc
    L0 = n_int + I                              # first leaf row id
    leaf_off = []
    acc_l = n_top_leaves
    for b in blas:
        leaf_off.append(L0 + acc_l)
        acc_l += b.n_padded // leaf_k
    n_leaves = acc_l
    n_rows = n_int + I + n_leaves
    row_w = max(6 * WIDTH + WIDTH, 9 * leaf_k)
    BIG = np.float32(3e38)
    rows = np.zeros((n_rows, row_w), np.float32)

    # ---- top internal rows
    def top_cid(ref):
        if ref[0] == "w":
            return ref[1]
        if ref[0] == "i":
            return n_int + (ref[1] - T_s)
        return L0 + ref[1]

    for i, slots in enumerate(wide):
        r = rows[i]
        r[0: 6 * WIDTH: 6] = BIG
        r[3: 6 * WIDTH: 6] = -BIG
        r[6 * WIDTH:] = -1.0
        for s, (slo, shi, ref) in enumerate(slots):
            r[s * 6: s * 6 + 3] = slo
            r[s * 6 + 3: s * 6 + 6] = shi
            r[6 * WIDTH + s] = float(top_cid(ref))

    # ---- BLAS rows, ids remapped into the global table
    for p, b in enumerate(blas):
        bi = b.rows[: b.n_int].copy()
        child = bi[:, 6 * WIDTH:]
        is_leaf_c = child >= b.n_int
        child_new = np.where(
            child < 0, -1.0,
            np.where(is_leaf_c, child - b.n_int + leaf_off[p],
                     child + int_off[p]),
        )
        bi[:, 6 * WIDTH:] = child_new
        rows[int_off[p]: int_off[p] + b.n_int] = bi
        nl = b.n_padded // leaf_k
        rows[leaf_off[p]: leaf_off[p] + nl] = b.rows[b.n_int:]

    # ---- instance rows: [w2o 12 | blas root | instance id]
    for i in range(I):
        p = int(inst_proto[i])
        m = np.eye(4)
        m[:3, :4] = inst_o2w[i]
        w2o = np.linalg.inv(m)[:3, :4]
        root_gid = int_off[p] if blas[p].n_int > 0 else leaf_off[p]
        r = rows[n_int + i]
        r[:12] = w2o.reshape(-1).astype(np.float32)
        r[12] = float(root_gid)
        r[13] = float(i)

    # ---- top leaf rows (static tris) + global src
    src = np.full(n_leaves * leaf_k, -1, np.int32)
    for chunk, bleaf in enumerate(leaf_order):
        ids = leaves[bleaf]
        assert np.all(ids < T_s)
        src[chunk * leaf_k: chunk * leaf_k + ids.shape[0]] = ids
    src_off = T_s
    for p, b in enumerate(blas):
        base = (leaf_off[p] - L0) * leaf_k
        bs = b.src
        src[base: base + bs.shape[0]] = np.where(bs >= 0, bs + src_off, -1)
        src_off += int(protos[p].reshape(-1, 3, 3).shape[0])

    mask = src >= 0
    si = np.maximum(src, 0)
    allp = np.concatenate(
        [static_p] + [np.asarray(P, np.float32).reshape(-1, 3, 3) for P in protos],
        axis=0,
    ) if protos else static_p
    tri9 = allp[si].reshape(-1, 9).copy()
    tri9[~mask] = 0.0
    rows[L0:, : leaf_k * 9] = tri9.reshape(n_leaves, leaf_k * 9)

    # depth bound: top chain + restore + deepest BLAS chain
    if wide:
        depth = np.ones(A, np.int32)
        for i in range(A - 1, -1, -1):
            d = 1
            for _, _, ref in wide[i]:
                if ref[0] == "w":
                    d = max(d, 1 + depth[ref[1]])
            depth[i] = d
        top_depth = int(depth[0])
    else:
        top_depth = 1
    max_depth = top_depth + max([b.max_depth for b in blas], default=0) + 2
    iter_bound = 4 * (A + n_top_leaves) + 16
    for i in range(I):
        b = blas[int(inst_proto[i])]
        iter_bound += 4 * (b.n_int + b.n_padded // leaf_k) + 8

    ends = leaf_off[1:] + [L0 + n_leaves]
    return Bvh2Build(
        rows=rows, src=src, n_int=n_int, n_inst=I,
        n_padded=n_leaves * leaf_k, max_depth=max_depth,
        iter_bound=int(iter_bound),
        leaf_ranges=((L0, L0 + n_top_leaves),) + tuple(zip(leaf_off, ends)),
    )


def reorder_pad(build: BvhBuild, a, fill):
    """Reorder a per-triangle column (T, ...) into padded leaf order."""
    a = np.asarray(a)
    out = np.full((build.n_padded,) + a.shape[1:], fill, a.dtype)
    mask = build.src >= 0
    out[mask] = a[build.src[mask]]
    return out


# --------------------------------------------------------------- traversal

# launches of the CUDA traversal kernels (plain ints, added to where they
# launch)
launches = {"bvh_closest_hit": 0, "bvh_any_hit": 0, "bvh_closest_hit_inst": 0,
            "bvh_any_hit_inst": 0, "bvh_refit": 0}
# the wide kernels' stack (csrc/bvh_wide.cuh): WIDTH - 1 entries a level of
# internal rows, at most the shared memory of a block (232,448 bytes) over
# 128 threads of 6-byte entries
WIDE_MAX_STACK = 232448 // (128 * 6)
_OVERFLOW = {}


def _indexed(device):
    """`device` with its index (torch.device("cuda") is the current card),
    so that every spelling of one card finds its counters."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def overflow_counter(device):
    """int32 device tensor: lanes that ran past the kernel's iteration
    bound or stack since the process started (0 for a correct tree)."""
    device = _indexed(device)
    if device not in _OVERFLOW:
        _OVERFLOW[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _OVERFLOW[device]


def _sweep_block(R, device):
    budget = (1 << 25) if device.type == "cuda" else (1 << 21)
    return max(8, budget // max(R, 1))


def _lanes_near_block(blk, o, d, t_hi):
    """Indices of the rays whose segment [0, t_hi] meets the bounds of the
    triangles blk (T, 9), grown by 1e-4 of the scene's scale: a slab test
    that no ray hitting one of them can fail (its rounding is ~1e-7 of the
    same scale). Padding triangles (all-zero, never hit) are left out."""
    v = blk[(blk != 0).any(dim=1)].reshape(-1, 3)
    if v.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=o.device)
    lo, hi = v.amin(dim=0), v.amax(dim=0)
    grow = 1e-4 * (float((hi - lo).max()) + float(torch.maximum(lo.abs(), hi.abs()).max()))
    inv = 1.0 / d                            # +-inf on an axis the ray runs along
    t0, t1 = (lo - grow - o) * inv, (hi + grow - o) * inv
    # fmin/fmax skip the NaN of 0 * inf (the ray on a slab's plane)
    t_near = torch.fmin(t0, t1).amax(dim=1)
    t_far = torch.fmax(t0, t1).amin(dim=1)
    return ((t_near <= t_far) & (t_far >= 0) & (t_near <= t_hi)).nonzero()[:, 0]


def traverse_plain(rows, n_int, o, d, t_max, any_hit=False):
    """Plain version of the traversal kernel: a chunked dense watertight
    sweep over the padded leaf soup rows[n_int:, :72] seen as (P*8, 9)
    triangles (the function JAX's `dense_finish` computes, bvh.py:1010-1047).
    Each chunk tests only the rays that meet its bounds, which skips no hit.
    -> (t (R,), prim (R,) int64 leaf-order index, -1 on a miss); for
    any_hit, prim is 0 where something blocks."""
    soup = rows[n_int:, : LEAF_K * 9].reshape(-1, 9)
    shear = ix.ray_shear(d)
    t_best = t_max.clone()
    prim = torch.full(t_max.shape, -1, dtype=torch.int64, device=o.device)
    TB = _sweep_block(o.shape[0], o.device)
    for s in range(0, soup.shape[0], TB):
        blk = soup[s: s + TB]
        t_hi = t_max if any_hit else t_best
        lanes = _lanes_near_block(blk, o, d, t_hi)
        if lanes.numel() == 0:
            continue
        t, hit = ix.intersect_tri_block(o[lanes], tuple(x[lanes] for x in shear), t_hi[lanes],
                                        blk[:, 0:3], blk[:, 3:6], blk[:, 6:9])
        if any_hit:
            prim[lanes] = torch.where(hit.any(dim=1), 0, prim[lanes])
            continue
        t = torch.where(hit, t, torch.inf)
        best = torch.argmin(t, dim=1)
        tb = torch.gather(t, 1, best[:, None])[:, 0]
        better = tb < t_best[lanes]
        t_best[lanes] = torch.where(better, tb, t_best[lanes])
        prim[lanes] = torch.where(better, s + best, prim[lanes])
    return t_best, prim


# the slab test's widening of a box's far distance (csrc/bvh_ray.cuh
# SLAB_WIDEN): 1 + 2 gamma(3), rounded to float32
_SLAB_WIDEN = float(np.float32(1.0 + 2.0 * gamma(3)))


def safe_inv(d):
    """1 / d with |d| clamped to 1e-30, as the traversal kernels form it
    (csrc/bvh_ray.cuh `safe_inv`): an axis the ray runs along gives
    +-1e30, not inf."""
    return torch.where(d < 0, -1.0, 1.0) / d.abs().clamp(min=1e-30)


def watertight_stages(o, d, t_max, p0, p1, p2):
    """How far the watertight test (csrc/watertight.cuh) of rays against
    triangles goes, with the plain arithmetic of geometry/intersect.py:
    o, d (..., 3), t_max (...) and the vertices (..., 3) broadcast against
    each other. -> (past the edge-sign test, past the det and t-range
    tests), boolean masks of the broadcast shape."""
    kz, sx, sy, sz = ix.ray_shear(d)
    a, b, c = (ix.permute_by_kz(p - o, kz) for p in (p0, p1, p2))
    ax, ay = a[0] + sx * a[2], a[1] + sy * a[2]
    bx, by = b[0] + sx * b[2], b[1] + sy * b[2]
    cx, cy = c[0] + sx * c[2], c[1] + sy * c[2]
    e0, e1, e2 = cx * by - cy * bx, ax * cy - ay * cx, bx * ay - by * ax
    edge = ~(((e0 < 0) | (e1 < 0) | (e2 < 0)) & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    ts = e0 * (sz * a[2]) + e1 * (sz * b[2]) + e2 * (sz * c[2])
    tm = t_max * det
    in_range = torch.where(det < 0, (ts < 0) & (ts > tm), (ts > 0) & (ts < tm))
    return edge, edge & (det != 0) & in_range


def traversal_work(rows, n_int, o, d, t_lim, occluded=None, cost=(1, 1, 1, 1),
                   chunk=1 << 15, per_ray=False, n_inst=0):
    """The work of an oracle traversal of the table (rows, n_int) that knows
    each ray's answer. Closest hit (occluded None): t_lim (R,) is the
    nearest hit's t (traverse_plain's t, which is t_max on a miss); from the
    root the oracle reads each internal row whose box the segment [0, t_lim]
    meets (the kernels' slab test, with tn <= t_lim), once, and tests the 8
    triangles of each leaf row so reached, the range test taken at the float
    after t_lim so that the winner passes it. Any hit: t_lim is t_max, the
    range test taken at it (a hit must lie below t_max), and occluded (R,)
    bool marks the rays something blocks within it (traverse_plain's
    any-hit answer). A blocked ray reads only the internal
    rows on the root path of one leaf that holds a hit within t_max, and
    tests that leaf's triangles in slot order up to its first such hit: of
    all those leaves, the one of least work, weighed by `cost` (per internal
    row read, triangle test, test past the edge-sign exit, past the range
    exit, and on a two-level table instance entry; ties to the lower row,
    then the lower instance). Any other ray reads what a closest-hit ray
    with that t_lim reads. Rays with t_lim <= 0 do nothing.
    A two-level table (n_inst instance rows after the n_int internal rows,
    `build_two_level`): an instance row whose box the segment meets is an
    entry, counted as a fifth sum, and the ray goes on into its prototype's
    root in the instance's object space (object_rays, the kernels' bits);
    every row is read, and every leaf tested, in the space of the instance
    it lies in (a prototype's rows once for each instance entered).
    -> (internal rows read, triangles tested, of those past the edge-sign
    test, past the t-range test; and instance entries on a two-level table),
    the sums the kernels' `stats` report, for the same work whatever
    implements it; per_ray: those counts of each ray, an (R, 4) or (R, 5)
    int64 tensor. Measurement code (chip_smoke.py's bounds of K1, K1a, K1i
    and K1i-a; parallel/scene_shard.py `parts_work`): rays `chunk` at a
    time, breadth first."""
    if occluded is None:
        blocked = torch.zeros_like(t_lim, dtype=torch.bool)
        t_hi = torch.nextafter(t_lim, torch.full_like(t_lim, float("inf")))
    else:
        blocked, t_hi = occluded, t_lim
    leaf0 = n_int + n_inst
    n_sums = 5 if n_inst else 4
    live = (t_lim > 0).nonzero()[:, 0]
    w = torch.tensor(tuple(cost) + (0,) * (5 - len(cost)), dtype=torch.int64, device=o.device)
    per = torch.zeros((o.shape[0], 5), dtype=torch.int64, device=o.device)
    for s in range(0, live.numel(), chunk):
        # the frontier: each element a lane, the row it reads next, the rows
        # read on its way, its instance (-1: the world) and its ray
        lane = live[s: s + chunk]
        node, path = torch.zeros_like(lane), torch.zeros_like(lane)
        iid = torch.full_like(lane, -1)
        oo, dd = o[lane], d[lane]
        leaves = []
        if n_int == 0:                      # one leaf row, the root
            leaves.append((lane, node, path, iid, oo, dd))
            lane = lane[:0]
        while lane.numel():
            per[:, 0].index_add_(0, lane, (~blocked[lane]).long())
            path = path + 1
            row = rows[node]
            box = row[:, : 6 * WIDTH].reshape(-1, WIDTH, 6)
            child = row[:, 6 * WIDTH: 7 * WIDTH].long()
            t0, t1 = ((box[..., :3] - oo[:, None]) * safe_inv(dd)[:, None],
                      (box[..., 3:] - oo[:, None]) * safe_inv(dd)[:, None])
            # fmin/fmax skip NaN as the kernels' fminf/fmaxf do
            tn = torch.fmin(t0, t1).amax(dim=-1).clamp(min=0.0)
            tf = torch.fmax(t0, t1).amin(dim=-1) * _SLAB_WIDEN
            meets = ((child >= 0) & (box[..., 0] <= box[..., 3]) & (tn <= tf) & (tf > 0)
                     & (tn <= t_lim[lane][:, None]))
            el = meets.nonzero()[:, 0]
            c = child[meets]
            nxt = (lane[el], c, path[el], iid[el], oo[el], dd[el])
            enter = (c >= n_int) & (c < leaf0)
            if bool(enter.any()):
                per[:, 4].index_add_(0, nxt[0][enter], (~blocked[nxt[0][enter]]).long())
                m = rows[c[enter]]
                o_i, d_i = object_rays(m[:, :12].contiguous(), nxt[4][enter], nxt[5][enter])
                ent = (nxt[0][enter], m[:, 12].long(), nxt[2][enter], m[:, 13].long(), o_i, d_i)
                nxt = tuple(torch.cat([x[~enter], y]) for x, y in zip(nxt, ent))
            is_leaf = nxt[1] >= leaf0
            leaves.append(tuple(x[is_leaf] for x in nxt))
            lane, node, path, iid, oo, dd = (x[~is_leaf] for x in nxt)
        lane, row, path, iid, oo, dd = (torch.cat(x) for x in zip(*leaves))
        tri = rows[row, : LEAF_K * 9].reshape(-1, LEAF_K, 3, 3)
        edge, rng = watertight_stages(oo[:, None], dd[:, None], t_hi[lane][:, None],
                                      tri[:, :, 0], tri[:, :, 1], tri[:, :, 2])
        free = ~blocked[lane]
        per[:, 1:4].index_add_(0, lane[free], torch.stack(
            [torch.full_like(lane[free], LEAF_K), edge[free].sum(1), rng[free].sum(1)], dim=1))
        # a blocked ray's leaves that hold a hit: the slots up to the first
        hold = ~free & rng.any(dim=1)
        first = rng[hold].int().argmax(dim=1)
        upto = torch.arange(LEAF_K, device=o.device)[None] <= first[:, None]
        work = torch.stack([path[hold], upto.sum(1), (edge[hold] & upto).sum(1),
                            (rng[hold] & upto).sum(1), (iid[hold] >= 0).long()], dim=1)
        key = ((work * w).sum(1) * rows.shape[0] + row[hold]) * (n_inst + 1) + iid[hold] + 1
        lane_h, none = lane[hold], torch.iinfo(torch.int64).max
        least = torch.full((o.shape[0],), none, dtype=torch.int64,
                           device=o.device).scatter_reduce(0, lane_h, key, "amin")
        cheapest = key == least[lane_h]
        per.index_add_(0, lane_h[cheapest], work[cheapest])
        ray = live[s: s + chunk]
        short = blocked[ray] & (least[ray] == none)
        if bool(short.any()):
            raise ValueError(f"traversal_work: {int(short.sum())} occluded rays reach no leaf "
                             "that holds a hit within t_max")
    per = per[:, :n_sums]
    return per if per_ray else tuple(int(x) for x in per.sum(0))


def object_rays(w2o, o, d):
    """Rays o, d (R, 3) in the object space of the affines w2o ((R, 12) or
    (12,), row-major 3x4): o_obj = M[:, :3] o + M[:, 3], d_obj = M[:, :3] d,
    with K1i's rounding (csrc/bvh_ray.cuh `dot_row`): each dot product
    a chain of fused multiply-adds, as XLA emits JAX's einsum on the CPU,
    then the translation added, so the kernel and this agree bit for bit.
    d_obj stays unnormalised, so a hit's t is the same in both spaces."""
    m = w2o.reshape(-1, 3, 4)

    def dot(v):
        a = m[:, :, 0] * v[:, None, 0]
        a = ix.fma_f32(m[:, :, 1], v[:, None, 1], a)
        return ix.fma_f32(m[:, :, 2], v[:, None, 2], a)

    return dot(o) + m[:, :, 3], dot(d)


def traverse_inst_plain(rows, n_int, leaves, o, d, t_max, any_hit=False):
    """Plain version of the two-level kernel (K1i): the chunked sweep of
    traverse_plain over the static triangles' leaf rows leaves[0] with the
    world rays, then for each instance i over its prototype's leaf rows
    leaves[1 + i] with the rays moved into its object space (object_rays),
    keeping strictly nearer winners in that order (each range against the
    rays that meet its bounds, then block by block). `leaves` is the scene's
    SceneMeta.bvh_leaves. -> (t, prim (R,) int64 leaf-order index, -1 on a
    miss; inst (R,) int64 instance of the winner, -1 for a static triangle
    or a miss); for any_hit, prim is 0 where something blocks."""
    L0 = leaves[0][0]
    t_best = t_max.clone()
    prim = torch.full(t_max.shape, -1, dtype=torch.int64, device=o.device)
    inst = torch.full(t_max.shape, -1, dtype=torch.int64, device=o.device)

    def sweep(lo, hi, o_, d_, iid):
        soup = rows[lo:hi, : LEAF_K * 9].reshape(-1, 9)
        # the rays that meet the range's bounds at all (a block's bounds lie
        # inside them, grown less), then block by block among those
        near = _lanes_near_block(soup, o_, d_, t_max if any_hit else t_best)
        if near.numel() == 0:
            return
        o_, d_ = o_[near], d_[near]
        shear = ix.ray_shear(d_)
        TB = _sweep_block(near.numel(), o.device)
        for s in range(0, soup.shape[0], TB):
            blk = soup[s: s + TB]
            t_hi = (t_max if any_hit else t_best)[near]
            lanes = _lanes_near_block(blk, o_, d_, t_hi)
            if lanes.numel() == 0:
                continue
            t, hit = ix.intersect_tri_block(o_[lanes], tuple(x[lanes] for x in shear),
                                            t_hi[lanes], blk[:, 0:3], blk[:, 3:6], blk[:, 6:9])
            g = near[lanes]
            if any_hit:
                prim[g] = torch.where(hit.any(dim=1), 0, prim[g])
                continue
            t = torch.where(hit, t, torch.inf)
            best = torch.argmin(t, dim=1)
            tb = torch.gather(t, 1, best[:, None])[:, 0]
            better = tb < t_best[g]
            t_best[g] = torch.where(better, tb, t_best[g])
            prim[g] = torch.where(better, (lo - L0) * LEAF_K + s + best, prim[g])
            inst[g] = torch.where(better, iid, inst[g])

    sweep(*leaves[0], o, d, -1)
    for i, (lo, hi) in enumerate(leaves[1:]):
        sweep(lo, hi, *object_rays(rows[n_int + i, :12], o, d), i)
    return t_best, prim, inst


def _kernel_lib():
    """The built traversal library, its C functions declared once."""
    from pbrt_tpu_torch import kernels

    lib = kernels.load("bvh_traverse")
    if not hasattr(lib, "declared"):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pbrt_bvh_wide_max_stack.argtypes = []
        lib.pbrt_bvh_wide_max_stack.restype = I
        lib.pbrt_bvh_wide_stack.argtypes = [I]
        lib.pbrt_bvh_wide_stack.restype = I
        lib.pbrt_bvh_traverse.argtypes = [P, I, I, P, P, P, I, P, P, P, I, I, P, P, P]
        lib.pbrt_bvh_traverse.restype = I
        lib.pbrt_bvh_traverse_inst.argtypes = [P, I, I, ctypes.c_longlong, P, P, P, I, P, P, P,
                                               P, I, I, P, ctypes.c_longlong, P, P, P]
        lib.pbrt_bvh_traverse_inst.restype = I
        lib.pbrt_bvh_inst_far_ints.argtypes = [I]
        lib.pbrt_bvh_inst_far_ints.restype = ctypes.c_longlong
        lib.pbrt_bvh_refit.argtypes = [P] * 9 + [I] + [P] * 4
        lib.pbrt_bvh_refit.restype = I
        if (lib.pbrt_bvh_wide_max_stack(), lib.pbrt_bvh_wide_stack(1)) != (WIDE_MAX_STACK,
                                                                            WIDTH - 1):
            raise RuntimeError("bvh_traverse: the library's stack sizes are not WIDE_MAX_STACK "
                               "and WIDTH - 1 entries a level")
        lib.declared = True
    return lib


def _check_launch(rows, n_int, leaf0, o, d, t_max, stats, n_stats, depth):
    """Validate a traversal launch's arguments (leaf0: the first leaf row)
    -> (the library, stack entries a thread): WIDTH - 1 a level of the
    tree's depth, at most WIDE_MAX_STACK (raised before a build), CUDA
    tensors and a 16-byte aligned table."""
    R = o.shape[0]
    dev = o.device
    for name, x, shape in (("o", o, (R, 3)), ("d", d, (R, 3)), ("t_max", t_max, (R,)),
                           ("rows", rows, (rows.shape[0], ROW_W))):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"bvh traversal: {name} must be a contiguous float32 "
                             f"{shape} tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if not 0 <= n_int <= leaf0 < rows.shape[0] or rows.shape[0] >= 1 << 23:
        raise ValueError(f"bvh traversal: n_int {n_int} outside a table of "
                         f"{rows.shape[0]} rows (at most 2^23 rows)")
    if stats is not None and (stats.device != dev or stats.dtype != torch.int64
                              or stats.numel() != n_stats):
        raise ValueError(f"bvh traversal: stats must be an int64 ({n_stats},) tensor on the "
                         "device")
    stack = (WIDTH - 1) * depth
    if stack > WIDE_MAX_STACK:
        raise ValueError(f"BVH depth {depth} needs a stack of {stack} entries; the "
                         f"kernel is compiled for {WIDE_MAX_STACK}")
    if dev.type != "cuda":
        raise ValueError(f"bvh traversal: the kernel takes CUDA tensors, got {dev}")
    if rows.data_ptr() % 16:
        raise ValueError("bvh traversal: rows must start on a 16-byte boundary")
    return _kernel_lib(), stack


def _ticket(dev):
    """The launch's own ray ticket, zeroed on the stream (a memset node
    under graph capture, so every replay starts at ray 0)."""
    return torch.zeros(1, dtype=torch.int32, device=dev)


def traverse_cuda(rows, n_int, depth, o, d, t_max, any_hit=False, stats=None):
    """Launch K1 (csrc/bvh_traverse.cu `pbrt_bvh_traverse`, the kernel of
    csrc/bvh_wide.cuh) on the current stream and count the launch. Same
    contract as traverse_plain; prim is -1 on a miss. `stats`, an optional
    int64 (4,) device tensor, accumulates the internal rows read, the leaf
    triangles tested, and of those the ones past the watertight test's
    edge-sign and t-range exits (csrc/watertight.cuh)."""
    from pbrt_tpu_torch import kernels

    lib, stack = _check_launch(rows, n_int, n_int, o, d, t_max, stats, 4, depth)
    R, dev = o.shape[0], o.device
    t = torch.empty(R, dtype=torch.float32, device=dev)
    prim = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return t, prim.long()
    err = lib.pbrt_bvh_traverse(
        rows.data_ptr(), rows.shape[0], n_int, o.data_ptr(), d.data_ptr(), t_max.data_ptr(), R,
        t.data_ptr(), prim.data_ptr(), overflow_counter(dev).data_ptr(), int(any_hit), stack,
        None if stats is None else stats.data_ptr(), _ticket(dev).data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "bvh_traverse")
    launches["bvh_any_hit" if any_hit else "bvh_closest_hit"] += 1
    return t, prim.long()


def traverse_inst_cuda(rows, n_int, n_inst, depth, iter_bound, o, d, t_max, any_hit=False,
                       stats=None):
    """Launch the two-level kernel (K1i, csrc/bvh_traverse.cu
    `pbrt_bvh_traverse_inst`, csrc/bvh_wide.cuh `inst_wide_kernel`) on the
    current stream and count the launch. Same contract as
    traverse_inst_plain, with prim and inst -1 on a miss; depth and
    iter_bound are the two-level build's max_depth and iter_bound (the
    stack holds WIDTH - 1 entries a level of depth, a depth whose stack does
    not fit raises; the entries that do not fit in shared memory lie in a
    scratch allocated here, of the size pbrt_bvh_inst_far_ints gives).
    `stats`, an optional int64 (5,) device tensor,
    accumulates traverse_cuda's four sums and the instance rows entered."""
    from pbrt_tpu_torch import kernels

    lib, stack = _check_launch(rows, n_int, n_int + n_inst, o, d, t_max, stats, 5, depth)
    R, dev = o.shape[0], o.device
    t = torch.empty(R, dtype=torch.float32, device=dev)
    prim = torch.empty(R, dtype=torch.int32, device=dev)
    inst = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return t, prim.long(), inst.long()
    far_ints = lib.pbrt_bvh_inst_far_ints(stack)
    far = torch.empty(far_ints, dtype=torch.int32, device=dev) if far_ints else None
    err = lib.pbrt_bvh_traverse_inst(
        rows.data_ptr(), n_int, n_inst, iter_bound, o.data_ptr(), d.data_ptr(),
        t_max.data_ptr(), R, t.data_ptr(), prim.data_ptr(), inst.data_ptr(),
        overflow_counter(dev).data_ptr(), int(any_hit), stack,
        None if far is None else far.data_ptr(), far_ints,
        None if stats is None else stats.data_ptr(), _ticket(dev).data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "bvh_traverse_inst")
    launches["bvh_any_hit_inst" if any_hit else "bvh_closest_hit_inst"] += 1
    return t, prim.long(), inst.long()


def _traverse(scene, meta, o, d, t_max, any_hit):
    """-> (t, prim, inst); inst is None on a single-level table."""
    if meta.bvh_ninst:
        if o.is_cuda:
            return traverse_inst_cuda(scene.bvh_rows, meta.bvh_nint, meta.bvh_ninst,
                                      meta.bvh_depth, meta.bvh_iterb, o, d, t_max, any_hit)
        return traverse_inst_plain(scene.bvh_rows, meta.bvh_nint, meta.bvh_leaves, o, d, t_max,
                                   any_hit)
    if o.is_cuda:
        t, prim = traverse_cuda(scene.bvh_rows, meta.bvh_nint, meta.bvh_depth, o, d, t_max,
                                any_hit)
    else:
        t, prim = traverse_plain(scene.bvh_rows, meta.bvh_nint, o, d, t_max, any_hit)
    return t, prim, None


def _refit_ray(w2o, o, d, inst):
    """The rays moved into the object space of each lane's instance inst
    (R,) of the affines w2o (I, 12), bit for bit as the kernels move them
    (object_rays), and left as they are where inst < 0: JAX's `_refit_ray`
    (bvh.py:1170), a `where` over every lane."""
    o_i, d_i = object_rays(w2o[inst.clamp(min=0)], o, d)
    use = (inst >= 0)[:, None]
    return torch.where(use, o_i, o), torch.where(use, d_i, d)


def refit_plain(tri_p0, tri_p1, tri_p2, o, d, t_max, prim, inst=None, w2o=None):
    """The refit of closest hits (JAX bvh.py:1193-1215): the winner's t and
    barycentrics recomputed by the watertight test against triangle `prim`
    (R,) int64 of the (T, 3) vertex columns, -1 for none, with the ray in
    the object space of the winner's instance inst (R,) int64 (-1: none; a
    single-level table passes None) under the affines w2o (I, 12) -> (t
    (R,), prim (R,), barycentrics (R, 3)); a lane without a winner, or whose
    winner the test misses, gets INFINITY, -1 and zeros."""
    if inst is not None:
        o, d = _refit_ray(w2o, o, d, inst)
    found = prim >= 0
    pc = torch.clamp(prim, min=0)
    t_ref, bary, hit_ref = ix.intersect_tri_lanes(o, d, t_max, tri_p0[pc], tri_p1[pc], tri_p2[pc])
    ok = found & hit_ref
    return (torch.where(ok, t_ref, INFINITY), torch.where(ok, prim, -1),
            torch.where(ok[:, None], bary, 0.0))


def refit_cuda(tri_p0, tri_p1, tri_p2, o, d, t_max, prim, inst=None, w2o=None):
    """refit_plain's contract in one launch of csrc/bvh_traverse.cu
    `pbrt_bvh_refit` on the current stream, the same bits; the object rays
    of instanced winners are formed in the kernel."""
    from pbrt_tpu_torch import kernels

    R, dev = o.shape[0], o.device
    T = tri_p0.shape[0]
    checks = [("o", o, (R, 3), torch.float32), ("d", d, (R, 3), torch.float32),
              ("t_max", t_max, (R,), torch.float32), ("prim", prim, (R,), torch.int64),
              ("tri_p0", tri_p0, (T, 3), torch.float32),
              ("tri_p1", tri_p1, (T, 3), torch.float32),
              ("tri_p2", tri_p2, (T, 3), torch.float32)]
    if inst is not None:
        checks += [("inst", inst, (R,), torch.int64),
                   ("w2o", w2o, (w2o.shape[0], 12), torch.float32)]
    for name, x, shape, dtype in checks:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"bvh refit: {name} must be a contiguous {dtype} {shape} tensor "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not o.is_cuda:
        raise ValueError(f"bvh refit: needs CUDA tensors, got them on {dev}")
    t = torch.empty(R, dtype=torch.float32, device=dev)
    prim_out = torch.empty(R, dtype=torch.int64, device=dev)
    b = torch.empty((R, 3), dtype=torch.float32, device=dev)
    err = _kernel_lib().pbrt_bvh_refit(
        tri_p0.data_ptr(), tri_p1.data_ptr(), tri_p2.data_ptr(), o.data_ptr(), d.data_ptr(),
        t_max.data_ptr(), prim.data_ptr(), None if inst is None else inst.data_ptr(),
        None if inst is None else w2o.data_ptr(), R, t.data_ptr(), prim_out.data_ptr(),
        b.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "bvh_refit")
    launches["bvh_refit"] += 1
    return t, prim_out, b


def closest_hit_tris(scene, meta, o, d, t_max):
    """BVH closest hit -> TriHit. t and the barycentrics are recomputed
    against the winning triangle (the refit of bvh.py:1193-1215: refit_cuda
    on CUDA tensors, refit_plain on CPU ones), for an instanced winner in
    its instance's object space (`_refit_ray` bvh.py:1170: the traversal's
    object ray, bit for bit, so the refit meets the winner the traversal
    met; no host sync); prim indexes the leaf-ordered triangle columns, inst
    the instance (None on a single-level table)."""
    _, prim, hin = _traverse(scene, meta, o, d, t_max, any_hit=False)
    refit = refit_cuda if o.is_cuda else refit_plain
    t, prim, b = refit(scene.tri_p0, scene.tri_p1, scene.tri_p2, o, d, t_max, prim, hin,
                       None if hin is None else scene.inst_w2o)
    return ix.TriHit(t=t, prim=prim, b=b, inst=None if hin is None else torch.where(prim >= 0,
                                                                                     hin, -1))


def any_hit_tris(scene, meta, o, d, t_max):
    """BVH shadow query: True where some triangle blocks (R,)."""
    return _traverse(scene, meta, o, d, t_max, any_hit=True)[1] >= 0
