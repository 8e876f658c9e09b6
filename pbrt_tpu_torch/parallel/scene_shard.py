"""Scene (geometry) sharding: the triangle soup split into morton parts, one
wide BVH each, rays replicated (counterpart of pbrt_tpu/parallel/
scene_shard.py).

  * `build_sharded` / `build_scene_shard` (host numpy, the JAX package's
    arithmetic, so every table comes out equal to its arrays bit for bit):
    n_parts spatially coherent chunks (contiguous ranges of the centroids'
    morton order), each with its own SAH BVH, normalized to one common row
    layout: internal rows in [0, B), leaf rows in [B, B + max_leaves).
    Padding rows hold inverted boxes or all-zero triangles that are never
    visited or hit.
  * Each part's box (`part_boxes`: the union of its root row's child
    boxes) and a top level over them (`top_rows`: rows of the same layout,
    a tree of groups of 8 past 8 parts), so the kernels reach a part only
    through its box.
  * A closest-hit query traverses the parts a rank holds, nearest first,
    and keeps the nearest hit (K11a, csrc/scene_shard.cu,
    `closest_hit_parts`); under a process group one all_gather of the (R,
    37) candidate pack [t, record row, p0 p1 p2] and the select kernel
    resolve the winner across ranks. Shadow rays OR over the parts (K11b,
    `any_hit_parts`), then an all_reduce(MAX) over ranks. Rays never migrate
    and geometry never moves.
  * Compute rises (a ray walks each part whose box it meets): the
    memory/compute trade of object-partitioned ray tracing, for scenes whose
    geometry does not fit one card.

Each wrapper launches its kernel on CUDA tensors and runs its plain version
on CPU tensors. Spheres and disks stay replicated, as in the JAX package:
their tables are small at any scene size.
"""
import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from pbrt_tpu_torch.accel import bvh as bvhlib
from pbrt_tpu_torch.utils.math import encode_morton3

REC_W = 27 + 9      # recv row: the 27-float tri_rec row, then p0, p1, p2
PACK_W = 1 + REC_W  # candidate pack row: t, then the recv row

# launches of the kernels (plain ints, added to where each launches)
launches = {"bvh_closest_hit_parts": 0, "bvh_any_hit_parts": 0, "shard_select": 0}

WIDE_MAX_STACK = bvhlib.WIDE_MAX_STACK   # the wide kernels' stack (accel/bvh.py)
BIG = 3e38          # an empty slot's inverted box (build_sharded's padding)


class ShardedGeometry(NamedTuple):
    """Per-part stacked geometry, leading axis = part; every part shares one
    layout: internal rows in [0, n_int), leaf rows in [n_int, n_int +
    max_leaves)."""

    rows: torch.Tensor     # (n_parts, n_int + max_leaves, ROW_W) f32
    src: torch.Tensor      # (n_parts, max_leaves * K) i32 -> original tri id
    n_int: int             # common internal-row boundary
    depth: int             # deepest internal chain over the parts
    leaf_k: int


def build_sharded(p0, p1, p2, n_parts, leaf_k=bvhlib.LEAF_K):
    """Split T triangles into n_parts morton-contiguous chunks and build a
    BVH per chunk, normalized to one common row layout (JAX
    scene_shard.py:47-113)."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    T = p0.shape[0]
    cent = (np.minimum(np.minimum(p0, p1), p2)
            + np.maximum(np.maximum(p0, p1), p2)) * 0.5
    lo = cent.min(0)
    ext = np.maximum(cent.max(0) - lo, 1e-30)
    q = np.clip(((cent - lo) / ext) * 1023.0, 0, 1023.0).astype(np.uint32)
    order = np.argsort(encode_morton3(q[:, 0], q[:, 1], q[:, 2]), kind="stable")

    bounds = np.linspace(0, T, n_parts + 1).astype(np.int64)
    builds = []
    for i in range(n_parts):
        ids = order[bounds[i]:bounds[i + 1]]
        if ids.size == 0:
            ids = order[:1]  # tiny scene: duplicate a triangle
        builds.append((bvhlib.build_bvh(p0[ids], p1[ids], p2[ids], leaf_k=leaf_k), ids))

    # common boundary B >= 1, so a leaf-only chunk (build_bvh gives n_int = 0
    # for a chunk of <= leaf_k triangles) gets a synthesized one-child root:
    # traversal always starts at internal row 0
    B = max(1, max(b.n_int for b, _ in builds))
    max_leaves = max(b.rows.shape[0] - b.n_int for b, _ in builds)
    R_W = builds[0][0].rows.shape[1]
    BIG = np.float32(3e38)
    W = bvhlib.WIDTH

    rows = np.zeros((n_parts, B + max_leaves, R_W), np.float32)
    # padding internal rows: inverted boxes and child -1 (never visited)
    rows[:, :B, 0: 6 * W: 6] = BIG
    rows[:, :B, 3: 6 * W: 6] = -BIG
    rows[:, :B, 6 * W: 7 * W] = -1.0
    srcs = np.full((n_parts, max_leaves * leaf_k), -1, np.int32)
    depth = 1
    for i, (b, ids) in enumerate(builds):
        n_leaves = b.rows.shape[0] - b.n_int
        rows[i, :b.n_int] = b.rows[:b.n_int]
        rows[i, B: B + n_leaves] = b.rows[b.n_int:]
        # leaf child ids shift by the boundary padding
        shift = B - b.n_int
        if shift and b.n_int:
            blk = rows[i, :b.n_int, 6 * W: 7 * W]
            rows[i, :b.n_int, 6 * W: 7 * W] = np.where(blk >= b.n_int, blk + shift, blk)
        if b.n_int == 0:
            # synthesized one-child root: slot 0's box = the chunk's bounds,
            # its child the (shifted) single leaf row
            tri = np.stack([p0[ids], p1[ids], p2[ids]])   # (3, n, 3)
            rows[i, 0, 0:3] = tri.min((0, 1))
            rows[i, 0, 3:6] = tri.max((0, 1))
            rows[i, 0, 6 * W] = float(B)
            depth = max(depth, 2)
        # chunk-local src -> original triangle ids
        srcs[i, :b.n_padded] = np.where(b.src >= 0, ids[np.clip(b.src, 0, ids.size - 1)], -1)
        depth = max(depth, b.max_depth)

    return ShardedGeometry(rows=torch.from_numpy(rows), src=torch.from_numpy(srcs),
                           n_int=int(B), depth=int(depth), leaf_k=int(leaf_k))


class SceneShard(NamedTuple):
    """Per-triangle geometry of a scene split into parts (JAX
    scene_shard.py:163): each part's BVH rows and its hit-record rows, so a
    winning lane's record and vertices arrive with its hit in one row.
    A rank of a sharded render holds its `part_range` only."""

    rows: torch.Tensor   # (n_parts, n_int + max_leaves, ROW_W) f32
    recv: torch.Tensor   # (n_parts, max_leaves * K, 36) f32: tri_rec row
                         # (27 floats), then p0, p1, p2; zeros on padding
    n_int: int
    depth: int
    leaf_k: int
    boxes: torch.Tensor = None   # (n_parts, 6) f32: part_boxes(rows)
    top: torch.Tensor = None     # (n_top, ROW_W) f32: top_rows(boxes)

    def to(self, device):
        """A copy of the shard on `device`."""
        return self._replace(**{k: getattr(self, k).to(device).contiguous()
                                for k in ("rows", "recv", "boxes", "top")
                                if getattr(self, k) is not None})

    def part_range(self, rank, world):
        """Parts [rank * P / world, (rank + 1) * P / world) of rank `rank`."""
        P = self.rows.shape[0]
        if not 0 <= rank < world or P < world:
            raise ValueError(f"scene shard: {P} parts cannot be split over {world} ranks "
                             f"(rank {rank}); each rank needs at least one part")
        return rank * P // world, (rank + 1) * P // world

    def local(self, rank, world):
        """The parts of `part_range(rank, world)` as a shard of their own."""
        lo, hi = self.part_range(rank, world)
        out = self._replace(rows=self.rows[lo:hi], recv=self.recv[lo:hi])
        if self.boxes is None:
            return out
        return out._replace(boxes=self.boxes[lo:hi], top=top_rows(self.boxes[lo:hi]))


def build_scene_shard(scene, n_parts, leaf_k=None):
    """Split a compiled non-instanced scene's triangle soup into n_parts
    morton chunks with per-part BVHs and record tables (host numpy, JAX
    scene_shard.py:185). -> SceneShard on the CPU."""
    leaf_k = leaf_k or bvhlib.LEAF_K
    n_inst = getattr(scene, "inst_w2o", torch.zeros(0)).shape[0]
    if n_inst:
        # the parts hold world-space triangles; a prototype's rows are in its
        # object space (JAX scene_shard.py:186 takes non-instanced scenes)
        raise ValueError("scene sharding takes a non-instanced scene; this one has "
                         f"{n_inst} instances under a two-level BVH")
    if scene.tri_rec.shape[0] == 0:
        raise ValueError("scene sharding needs a BVH scene (at least "
                         f"{bvhlib.MIN_TRIS_FOR_BVH} triangles)")
    p0, p1, p2, rec = (x.detach().cpu().numpy() for x in
                       (scene.tri_p0, scene.tri_p1, scene.tri_p2, scene.tri_rec))
    # drop the single-tree build's padding rows (all-zero triangles)
    live = (np.abs(p0).sum(1) + np.abs(p1).sum(1) + np.abs(p2).sum(1)) > 0
    ids_live = np.nonzero(live)[0]
    g = build_sharded(p0[ids_live], p1[ids_live], p2[ids_live], n_parts, leaf_k=leaf_k)
    src = g.src.numpy()                           # (n_parts, L*K) -> live index
    orig = np.where(src >= 0, ids_live[np.clip(src, 0, ids_live.size - 1)], -1)
    okm = (src >= 0)[..., None]
    safe = np.clip(orig, 0, rec.shape[0] - 1)
    recv = np.where(okm, np.concatenate([rec[safe], p0[safe], p1[safe], p2[safe]], axis=-1),
                    0.0)
    boxes = part_boxes(g.rows)
    return SceneShard(rows=g.rows, recv=torch.from_numpy(recv.astype(np.float32)),
                      n_int=g.n_int, depth=g.depth, leaf_k=g.leaf_k, boxes=boxes,
                      top=top_rows(boxes))


def part_boxes(rows):
    """Each part's box, the union of its root row's non-empty child boxes
    (rows (P, N, ROW_W); a synthesized one-child root's single slot, a
    padding slot's inverted box left out), from the same floats, so it
    bounds the part's tree exactly -> (P, 6) [lo, hi]."""
    W = bvhlib.WIDTH
    box = rows[:, 0, : 6 * W].reshape(-1, W, 6)
    ok = ((rows[:, 0, 6 * W: 7 * W] >= 0) & (box[..., 0] <= box[..., 3]))[..., None]
    return torch.cat([torch.where(ok, box[..., :3], torch.inf).amin(1),
                      torch.where(ok, box[..., 3:], -torch.inf).amax(1)], dim=1)


def _top_sizes(n_parts):
    """Rows of each level of the top level over n_parts parts, from the
    rows over the parts up to the root: one row of 8 slots up to 8 parts,
    groups of 8 past them."""
    sizes = [-(-n_parts // bvhlib.WIDTH)]
    while sizes[-1] > 1:
        sizes.append(-(-sizes[-1] // bvhlib.WIDTH))
    return sizes


def top_levels(n_parts):
    """Levels of the top level over n_parts parts."""
    return len(_top_sizes(n_parts))


def _top_tree(boxes):
    """[(the boxes of a level's rows (G, 6), its rows (G, ROW_W))] from the
    rows over the parts up to the root (G = 1)."""
    W, P, dev = bvhlib.WIDTH, boxes.shape[0], boxes.device
    pad = torch.tensor([BIG] * 3 + [-BIG] * 3, dtype=torch.float32, device=dev)
    ids = torch.arange(P, dtype=torch.float32, device=dev)
    cur, made, out = boxes.float(), 0, []
    while True:
        G = -(-cur.shape[0] // W)
        n_pad = G * W - cur.shape[0]
        bx = torch.cat([cur, pad.expand(n_pad, 6)]).reshape(G, W, 6)
        row = torch.zeros((G, bvhlib.ROW_W), dtype=torch.float32, device=dev)
        row[:, : 6 * W] = bx.reshape(G, 6 * W)
        row[:, 6 * W: 7 * W] = torch.cat([ids, ids.new_full((n_pad,), -1.0)]).reshape(G, W)
        cur = torch.cat([bx[..., :3].amin(1), bx[..., 3:].amax(1)], dim=1)
        out.append((cur, row))
        if G == 1:
            return out
        ids = P + made + torch.arange(G, dtype=torch.float32, device=dev)
        made += G


def top_rows(boxes):
    """The top level over the part boxes (P, 6), in the row layout of the
    parts' internal rows (8 boxes, then 8 child ids as floats): slot k of a
    row holds part k's box (k < P) or the box of top row k - P, the union of
    its slots; one row up to 8 parts, groups of 8 in morton order past them,
    the root last. -> (n_top, ROW_W) float32 on the boxes' device."""
    return torch.cat([row for _, row in _top_tree(boxes)])


def shard_bytes(sh: SceneShard):
    """Geometry bytes of one part (rows and recv)."""
    return sum(int(np.prod(a.shape[1:])) * 4 for a in (sh.rows, sh.recv))


# ----------------------------------------------------------- plain versions

def closest_parts_plain(rows, recv, n_int, o, d, t_max):
    """Plain version of K11a: `bvh.traverse_plain` over each part, then an
    argmin over the parts (the first part wins a tie) and a gather. ->
    pack (R, 37): t (inf on a miss), then the winner's recv row (zeros on a
    miss)."""
    ts, rvs = [], []
    for p in range(rows.shape[0]):
        t, prim = bvhlib.traverse_plain(rows[p], n_int, o, d, t_max)
        found = prim >= 0
        ts.append(torch.where(found, t, torch.inf))
        rvs.append(torch.where(found[:, None], recv[p][prim.clamp(min=0)], 0.0))
    t = torch.stack(ts)
    best = torch.argmin(t, dim=0)
    rr = torch.arange(o.shape[0], device=o.device)
    return torch.cat([t[best, rr][:, None], torch.stack(rvs)[best, rr]], dim=1)


def any_parts_plain(rows, n_int, o, d, t_max):
    """Plain version of K11b: the any-hit sweep of each part, OR-ed -> (R,)
    bool."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for p in range(rows.shape[0]):
        occ |= bvhlib.traverse_plain(rows[p], n_int, o, d, t_max, any_hit=True)[1] >= 0
    return occ


def select_plain(packs):
    """Plain version of the select kernel: packs (W, R, 37) -> (R, 37), the
    row of the first rank with the least t."""
    best = torch.argmin(packs[:, :, 0], dim=0)
    return packs[best, torch.arange(packs.shape[1], device=packs.device)]


def _boxes_meet(boxes, o, d, t_lim):
    """(R, n) bool: the segment [0, t_lim] of each ray meets each box (n, 6)
    by the kernels' slab test (bvh.traversal_work's, tn <= t_lim)."""
    inv = bvhlib.safe_inv(d)[:, None]
    oo = o[:, None]
    t0, t1 = (boxes[None, :, :3] - oo) * inv, (boxes[None, :, 3:] - oo) * inv
    tn = torch.fmin(t0, t1).amax(dim=-1).clamp(min=0.0)
    tf = torch.fmax(t0, t1).amin(dim=-1) * bvhlib._SLAB_WIDEN
    return ((boxes[:, 0] <= boxes[:, 3])[None] & (tn <= tf) & (tf > 0)
            & (tn <= t_lim[:, None]))


def parts_work(rows, n_int, boxes, o, d, t_lim, occluded=None, cost=(1, 1, 1, 1)):
    """The work of an oracle traversal of the parts (rows (P, N, ROW_W),
    part_boxes `boxes`) under their top level that knows each ray's answer:
    bvh.traversal_work's four sums (internal rows read, triangles tested,
    past the edge-sign test, past the t-range test), the top level's rows
    counted as internal rows. Closest hit (occluded None): t_lim (R,) is the
    global answer's t (t_max on a miss); a ray reads the top root, each other
    top row whose box the segment [0, t_lim] meets, and in each part whose
    box it meets what traversal_work of that part reads with that t_lim.
    Any hit: t_lim is t_max and occluded (R,) the plain version's answer; a
    blocked ray pays only the top level's root path and, in the part where
    it weighs least by `cost` (the first part on ties), traversal_work's
    blocked-ray work; any other ray pays as a closest-hit ray with t_lim =
    t_max. Rays with t_lim <= 0 do nothing. -> the four sums; measurement
    code (chip_smoke.py's bounds of K11a and K11b)."""
    R, dev = o.shape[0], o.device
    live = t_lim > 0
    meets = _boxes_meet(boxes, o, d, t_lim) & live[:, None]
    tree = _top_tree(boxes)
    sums = torch.zeros(4, dtype=torch.int64, device=dev)
    blocked = torch.zeros_like(live) if occluded is None else occluded & live
    free = live & ~blocked
    # the top level: the root, then each row below it whose box is met
    sums[0] += free.sum() + blocked.sum() * len(tree)
    for gbox, _ in tree[:-1]:
        sums[0] += (_boxes_meet(gbox, o, d, t_lim) & free[:, None]).sum()
    w = torch.tensor(cost, dtype=torch.int64, device=dev)
    none = torch.iinfo(torch.int64).max
    best = torch.full((R,), none, dtype=torch.int64, device=dev)
    best_work = torch.zeros((R, 4), dtype=torch.int64, device=dev)
    for p in range(rows.shape[0]):
        m = meets[:, p].nonzero()[:, 0]
        if m.numel() == 0:
            continue
        occ_p = None
        if occluded is not None:
            occ_p = bvhlib.traverse_plain(rows[p], n_int, o[m], d[m], t_lim[m],
                                          any_hit=True)[1] >= 0
        work = bvhlib.traversal_work(rows[p], n_int, o[m], d[m], t_lim[m], occ_p, cost,
                                     per_ray=True)
        sums += work[free[m]].sum(0)
        if occ_p is not None:
            lane, wk = m[occ_p], work[occ_p]
            c = (wk * w).sum(1)
            better = c < best[lane]
            best[lane[better]] = c[better]
            best_work[lane[better]] = wk[better]
    if bool((best[blocked] == none).any()):
        raise ValueError("parts_work: an occluded ray reaches no part that holds a hit "
                         "within t_max")
    return tuple(int(x) for x in sums + best_work[blocked].sum(0))


# ------------------------------------------------------------------ kernels

def _lib():
    """The built scene_shard library, its C functions declared once."""
    from pbrt_tpu_torch import kernels

    lib = kernels.load("scene_shard")
    if not hasattr(lib, "declared"):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pbrt_bvh_closest_parts.argtypes = [P, I, I, I, P, I, P, I, P, P, P, I, P, P, I, P,
                                               P, P]
        lib.pbrt_bvh_any_parts.argtypes = [P, I, I, I, P, I, P, P, P, I, P, P, I, P, P, P]
        lib.pbrt_shard_select.argtypes = [P, I, I, P, P]
        for fn in (lib.pbrt_bvh_closest_parts, lib.pbrt_bvh_any_parts, lib.pbrt_shard_select):
            fn.restype = I
        lib.declared = True
    return lib


def _check(what, x, dtype, shape, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} {tuple(shape)} tensor on "
                         f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_parts(what, rows, recv, n_int, depth, top, o, d, t_max, stats):
    """Validate a part traversal's arguments -> the stack entries a thread:
    the wide kernel's for a path through the top level and the deepest
    part's internal rows."""
    R, dev = o.shape[0], o.device
    if rows.dim() != 3 or rows.shape[0] < 1:
        raise ValueError(f"{what}: rows must be (parts, rows, {bvhlib.ROW_W}), "
                         f"got {tuple(rows.shape)}")
    P, N = rows.shape[0], rows.shape[1]
    _check(f"{what}: rows", rows, torch.float32, (P, N, bvhlib.ROW_W), dev)
    if recv is not None:
        _check(f"{what}: recv", recv, torch.float32, (P, recv.shape[1], REC_W), dev)
        if recv.shape[1] < (N - n_int) * bvhlib.LEAF_K:
            raise ValueError(f"{what}: recv holds {recv.shape[1]} rows a part, fewer than "
                             f"the {(N - n_int) * bvhlib.LEAF_K} leaf triangles")
    if top is None:
        raise ValueError(f"{what}: top must be the top level over the {P} parts "
                         "(top_rows), got None")
    _check(f"{what}: top", top, torch.float32, (sum(_top_sizes(P)), bvhlib.ROW_W), dev)
    for name, x, shape in (("o", o, (R, 3)), ("d", d, (R, 3)), ("t_max", t_max, (R,))):
        _check(f"{what}: {name}", x, torch.float32, shape, dev)
    if not 0 <= n_int < N or N >= 1 << 23 or P * N * bvhlib.ROW_W >= 1 << 31:
        raise ValueError(f"{what}: n_int {n_int} outside a part of {N} rows (at most 2^23 "
                         f"rows, 2^31 floats in all)")
    if stats is not None:
        _check(f"{what}: stats", stats, torch.int64, (4,), dev)
    stack = (bvhlib.WIDTH - 1) * (depth + top_levels(P))
    if stack > WIDE_MAX_STACK:
        raise ValueError(f"{what}: BVH depth {depth} under a top level over {P} parts needs "
                         f"a stack of {stack} entries; the kernel is compiled for "
                         f"{WIDE_MAX_STACK}")
    if dev.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {dev}")
    if any(x.data_ptr() % 16 for x in (rows, recv, top) if x is not None):
        raise ValueError(f"{what}: rows, recv and top must start on a 16-byte boundary")
    return stack


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ticket(dev):
    """The launch's own ray ticket, zeroed on the stream (a memset node under
    graph capture, so every replay starts at ray 0), as bvh.traverse_cuda's."""
    return torch.zeros(1, dtype=torch.int32, device=dev).data_ptr()


def closest_parts_cuda(rows, recv, n_int, depth, top, o, d, t_max, stats=None):
    """Launch K11a (csrc/scene_shard.cu `pbrt_bvh_closest_parts`) on the
    current stream and count the launch. Same contract as
    closest_parts_plain; top is top_rows(part_boxes(rows)). `stats`, an
    optional int64 (4,) device tensor, accumulates K1's work sums over the
    traversal (bvh.traverse_cuda), the top level's visits counted as
    internal rows."""
    from pbrt_tpu_torch import kernels

    stack = _check_parts("closest_hit_parts", rows, recv, n_int, depth, top, o, d, t_max,
                         stats)
    R, dev = o.shape[0], o.device
    pack = torch.empty((R, PACK_W), dtype=torch.float32, device=dev)
    if R == 0:
        return pack
    err = _lib().pbrt_bvh_closest_parts(
        rows.data_ptr(), rows.shape[0], rows.shape[1], n_int, top.data_ptr(), top.shape[0],
        recv.data_ptr(), recv.shape[1], o.data_ptr(), d.data_ptr(), t_max.data_ptr(), R,
        pack.data_ptr(), bvhlib.overflow_counter(dev).data_ptr(), stack,
        None if stats is None else stats.data_ptr(), _ticket(dev), _stream(dev))
    kernels.check(err, "bvh_closest_hit_parts")
    launches["bvh_closest_hit_parts"] += 1
    return pack


def any_parts_cuda(rows, n_int, depth, top, o, d, t_max, stats=None):
    """Launch K11b (`pbrt_bvh_any_parts`) and count the launch -> (R,)
    bool, the contract of any_parts_plain; top and stats as
    closest_parts_cuda's."""
    from pbrt_tpu_torch import kernels

    stack = _check_parts("any_hit_parts", rows, None, n_int, depth, top, o, d, t_max, stats)
    R, dev = o.shape[0], o.device
    hit = torch.empty(R, dtype=torch.uint8, device=dev)
    if R == 0:
        return hit.bool()
    err = _lib().pbrt_bvh_any_parts(
        rows.data_ptr(), rows.shape[0], rows.shape[1], n_int, top.data_ptr(), top.shape[0],
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), R, hit.data_ptr(),
        bvhlib.overflow_counter(dev).data_ptr(), stack,
        None if stats is None else stats.data_ptr(), _ticket(dev), _stream(dev))
    kernels.check(err, "bvh_any_hit_parts")
    launches["bvh_any_hit_parts"] += 1
    return hit.bool()


def select_cuda(packs):
    """Launch the select kernel (`pbrt_shard_select`) and count the launch;
    the contract of select_plain."""
    from pbrt_tpu_torch import kernels

    dev = packs.device
    if packs.dim() != 3 or packs.shape[0] < 1:
        raise ValueError(f"shard_select: packs must be (ranks, R, {PACK_W}), "
                         f"got {tuple(packs.shape)}")
    W, R = packs.shape[0], packs.shape[1]
    _check("shard_select: packs", packs, torch.float32, (W, R, PACK_W), dev)
    if dev.type != "cuda":
        raise ValueError(f"shard_select: the kernel takes CUDA tensors, got {dev}")
    out = torch.empty((R, PACK_W), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    err = _lib().pbrt_shard_select(packs.data_ptr(), W, R, out.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "shard_select")
    launches["shard_select"] += 1
    return out


def select(packs):
    """The select kernel on CUDA tensors, its plain version on CPU ones."""
    return select_cuda(packs) if packs.is_cuda else select_plain(packs)


# ------------------------------------------------------------ entry points

def closest_hit_parts(sh: SceneShard, o, d, t_max):
    """Closest hit over the parts `sh` holds (K11a on CUDA tensors, its plain
    version on CPU ones); under a process group, one all_gather of the
    candidate packs and the select kernel resolve the winner across ranks
    (JAX scene_shard.py:226 `closest_hit_local`). -> (t (R,) inf on a miss,
    hit record row (R, 27), p0, p1, p2 (R, 3) of the winning triangle,
    valid (R,))."""
    if o.is_cuda:
        pack = closest_parts_cuda(sh.rows, sh.recv, sh.n_int, sh.depth, sh.top, o, d, t_max)
    else:
        pack = closest_parts_plain(sh.rows, sh.recv, sh.n_int, o, d, t_max)
    if dist.is_initialized():
        gathered = [torch.empty_like(pack) for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, pack)
        pack = select(torch.stack(gathered))
    t = pack[:, 0]
    return (t, pack[:, 1:28], pack[:, 28:31], pack[:, 31:34], pack[:, 34:37],
            torch.isfinite(t))


def any_hit_parts(sh: SceneShard, o, d, t_max):
    """Any hit over the parts `sh` holds (K11b on CUDA tensors, its plain
    version on CPU ones), then all_reduce(MAX) over the ranks of a process
    group (JAX scene_shard.py:256 `any_hit_local`) -> (R,) bool."""
    if o.is_cuda:
        occ = any_parts_cuda(sh.rows, sh.n_int, sh.depth, sh.top, o, d, t_max)
    else:
        occ = any_parts_plain(sh.rows, sh.n_int, o, d, t_max)
    if dist.is_initialized():
        bits = occ.to(torch.uint8)
        dist.all_reduce(bits, op=dist.ReduceOp.MAX)
        occ = bits.bool()
    return occ


def closest_hit_sharded(geom: ShardedGeometry, o, d, t_max):
    """Closest hit over a ShardedGeometry in one process (JAX
    scene_shard.py:116): each part's traversal (K1 on CUDA tensors, its
    plain version on CPU ones), then an argmin over the parts. -> (t (R,),
    prim (R,) int64: the original triangle id, -1 on a miss)."""
    ts, ps = [], []
    for p in range(geom.rows.shape[0]):
        if o.is_cuda:
            t, prim = bvhlib.traverse_cuda(geom.rows[p], geom.n_int, geom.depth, o, d, t_max)
        else:
            t, prim = bvhlib.traverse_plain(geom.rows[p], geom.n_int, o, d, t_max)
        found = prim >= 0
        ts.append(torch.where(found, t, torch.inf))
        ps.append(torch.where(found, geom.src[p].to(o.device).long()[prim.clamp(min=0)], -1))
    t = torch.stack(ts)
    best = torch.argmin(t, dim=0)
    rr = torch.arange(o.shape[0], device=o.device)
    return t[best, rr], torch.stack(ps)[best, rr]
