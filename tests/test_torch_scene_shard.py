"""Scene sharding of the port against the JAX package (8 virtual devices,
tests/conftest.py): the morton split with its per-part BVHs and record
tables must come out equal to JAX's bit for bit; the parts' closest hit
(K11a's plain version) must find JAX's closest_hit_sharded's hits and
winners, the any hit (K11b's) the single tree's occlusions; the select's
plain version takes the first rank's row on ties; the kernel wrappers
reject what the kernels do not take."""
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pbrt_tpu.accel import bvh as jbvh
from pbrt_tpu.parallel import scene_shard as jss
from pbrt_tpu.scene import testscenes as jts
from pbrt_tpu_torch.accel import bvh as tbvh
from pbrt_tpu_torch.accel import dispatch
from pbrt_tpu_torch.parallel import scene_shard as ss
from pbrt_tpu_torch.scene import testscenes as tts
from pbrt_tpu_torch.utils.math import INFINITY

torch.set_num_threads(2)
N_PARTS = 8


def _soup(rng, T):
    base = rng.uniform(-4, 4, (T, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (T, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (T, 3)).astype(np.float32)
    return base, base + e1, base + e2


def _rays(rng, R=512):
    o = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    d = rng.normal(0, 1, (R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _soup_scene(p0, p1, p2, seed):
    """A scene-like record of a triangle soup with a random 27-float hit
    record a triangle, for build_scene_shard."""
    rec = np.random.default_rng(seed).normal(size=(p0.shape[0], 27)).astype(np.float32)
    return SimpleNamespace(tri_p0=torch.from_numpy(p0), tri_p1=torch.from_numpy(p1),
                           tri_p2=torch.from_numpy(p2), tri_rec=torch.from_numpy(rec))


_CACHE = {}


def _soup_case():
    """The 3000-triangle soup, its sharded geometry in both packages and
    JAX's closest_hit_sharded over 8 devices on 512 rays (computed once)."""
    if "soup" not in _CACHE:
        rng = np.random.default_rng(0)
        p0, p1, p2 = _soup(rng, 3000)
        o, d = _rays(rng)
        jg = jss.build_sharded(p0, p1, p2, N_PARTS)
        t_j, prim_j = jss.closest_hit_sharded(jg, jnp.asarray(o), jnp.asarray(d),
                                              jnp.full((o.shape[0],), INFINITY),
                                              devices=jax.devices()[:N_PARTS])
        _CACHE["soup"] = dict(p=(p0, p1, p2), o=o, d=d, jg=jg, t_j=np.asarray(t_j),
                              prim_j=np.asarray(prim_j))
    return _CACHE["soup"]


def _same_geometry(tg, jg):
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_array_equal(tg.src.numpy(), np.asarray(jg.src))
    assert (tg.n_int, tg.depth, tg.leaf_k) == (jg.n_int, jg.depth, jg.leaf_k)


@pytest.mark.parametrize("T", [3000, 68])
def test_build_sharded_equals_jax(T):
    """The 3000-triangle soup, and 68 triangles over 8 parts: chunks of 8
    and 9 triangles, leaf-only (n_int = 0) ones among them, each with a
    synthesized one-child root."""
    p0, p1, p2 = _soup(np.random.default_rng(T), T)
    _same_geometry(ss.build_sharded(p0, p1, p2, N_PARTS),
                   jss.build_sharded(p0, p1, p2, N_PARTS))


def test_build_scene_shard_equals_jax_on_cornell_mesh():
    js, _ = jts.cornell_mesh(res=16, spp=1, levels=3)
    ts_, _ = tts.cornell_mesh(res=16, spp=1, levels=3, device="cpu")
    jsh, tsh = jss.build_scene_shard(js, N_PARTS), ss.build_scene_shard(ts_, N_PARTS)
    np.testing.assert_array_equal(tsh.rows.numpy(), np.asarray(jsh.rows))
    np.testing.assert_array_equal(tsh.recv.numpy(), np.asarray(jsh.recv))
    assert (tsh.n_int, tsh.depth, tsh.leaf_k) == (jsh.n_int.shape[0], jsh.depth.shape[0],
                                                   jsh.leaf_k.shape[0])
    assert ss.shard_bytes(tsh) == jss.shard_bytes(jsh)


def _compare_hits(t, prim, t_j, prim_j):
    """Equal hit sets, t within rtol 1e-5, the same original triangle on >
    99 % of hits and equal t where the winners differ (ties)."""
    hit, hit_j = prim >= 0, prim_j >= 0
    np.testing.assert_array_equal(hit, hit_j)
    np.testing.assert_allclose(t[hit], t_j[hit], rtol=1e-5)
    same = prim == prim_j
    assert same[hit].mean() > 0.99
    ties = hit & ~same
    np.testing.assert_allclose(t[ties], t_j[ties], rtol=1e-6)


def test_closest_hit_sharded_matches_jax():
    c = _soup_case()
    tg = ss.build_sharded(*c["p"], N_PARTS)
    t, prim = ss.closest_hit_sharded(tg, torch.from_numpy(c["o"]), torch.from_numpy(c["d"]),
                                     torch.full((c["o"].shape[0],), INFINITY))
    _compare_hits(t.numpy(), prim.numpy(), c["t_j"], c["prim_j"])


def test_closest_hit_parts_matches_jax():
    """K11a's plain version over a SceneShard of the soup: the winner's
    record row and vertices are those of JAX's winning triangle."""
    c = _soup_case()
    p0, p1, p2 = c["p"]
    scene = _soup_scene(p0, p1, p2, 5)
    sh = ss.build_scene_shard(scene, N_PARTS)
    R = c["o"].shape[0]
    t, rec, q0, q1, q2, valid = ss.closest_hit_parts(
        sh, torch.from_numpy(c["o"]), torch.from_numpy(c["d"]), torch.full((R,), INFINITY))
    assert not torch.isfinite(t[~valid]).any()
    # the winner's original id: the triangle whose vertices the pack carries
    key = {tuple(np.r_[a, b, e]): i for i, (a, b, e) in enumerate(zip(p0, p1, p2))}
    q = torch.cat([q0, q1, q2], dim=1).numpy()
    prim = np.array([key[tuple(row)] if v else -1 for row, v in zip(q, valid.numpy())])
    _compare_hits(t.numpy(), prim, c["t_j"], c["prim_j"])
    ok = prim >= 0
    np.testing.assert_array_equal(rec.numpy()[ok], scene.tri_rec.numpy()[prim[ok]])
    assert not rec[~valid].any() and not q[~valid.numpy()].any()


@pytest.mark.parametrize("T", [3000, 68])
def test_any_hit_parts_matches_single_tree(T):
    """K11b's plain version against JAX's any-hit traversal of one tree over
    the whole soup, on shadow-ray lengths in [0, 12) with masked lanes."""
    rng = np.random.default_rng(T + 1)
    p0, p1, p2 = _soup(rng, T)
    o, d = _rays(rng)
    t_max = rng.uniform(0, 12, o.shape[0]).astype(np.float32)
    t_max[::17] = 0.0
    b = jbvh.build_bvh(p0, p1, p2)
    _, prim, _ = jbvh._traverse(jnp.asarray(b.rows), b.n_int, b.max_depth, jbvh.LEAF_K,
                                jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                any_hit=True)
    sh = ss.build_scene_shard(_soup_scene(p0, p1, p2, 1), N_PARTS)
    occ = ss.any_hit_parts(sh, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(t_max))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(prim) >= 0)
    assert 0 < int(occ.sum()) < o.shape[0]


def test_part_geometry_shrinks():
    """Per-part tables under a quarter of the unsharded ones, over 8 parts:
    the BVH rows of the 8000-triangle soup, and a cornell-mesh shard's rows
    and records against the scene's BVH and triangle tables."""
    p0, p1, p2 = _soup(np.random.default_rng(2), 8000)
    b = tbvh.build_bvh(p0, p1, p2)
    assert ss.build_sharded(p0, p1, p2, N_PARTS).rows.shape[1] < b.rows.shape[0] / 4
    scene, _ = tts.cornell_mesh(res=16, spp=1, levels=4, device="cpu")
    full = sum(x.numel() * 4 for x in (scene.bvh_rows, scene.tri_rec, scene.tri_p0,
                                       scene.tri_p1, scene.tri_p2))
    assert ss.shard_bytes(ss.build_scene_shard(scene, N_PARTS)) < full / 4


def test_part_range_splits_parts_over_ranks():
    sh = ss.SceneShard(rows=torch.zeros((8, 3, 72)), recv=torch.zeros((8, 16, 36)), n_int=1,
                       depth=1, leaf_k=8)
    assert [sh.part_range(r, 3) for r in range(3)] == [(0, 2), (2, 5), (5, 8)]
    assert sh.local(1, 3).rows.shape == (3, 3, 72)
    assert sh.local(2, 4).recv.shape == (2, 16, 36)
    with pytest.raises(ValueError, match="at least one part"):
        sh.part_range(0, 9)


def test_select_plain_takes_the_first_rank_on_ties():
    g = torch.Generator().manual_seed(3)
    packs = torch.randn((4, 64, ss.PACK_W), generator=g)
    packs[:, :, 0] = torch.randint(0, 3, (4, 64), generator=g).float()
    packs[:, ::5, 0] = torch.inf
    out = ss.select_plain(packs)
    for r in range(64):
        t = packs[:, r, 0]
        w = int(np.flatnonzero(t.numpy() == t.min().item())[0])
        assert torch.equal(out[r], packs[w, r])


def test_sharded_dispatch_matches_bvh_route():
    """accel/dispatch.intersect and occluded with Scene.shard set (the parts'
    traversal, the record from the pack) against the BVH route."""
    scene, meta = tts.cornell_mesh(res=16, spp=1, levels=3, device="cpu")
    sharded = scene.with_shard(ss.build_scene_shard(scene, 4))
    assert scene.shard is None and sharded.to("cpu").shard.rows.shape[0] == 4
    g = torch.Generator().manual_seed(7)
    pts = torch.cat([scene.tri_p0, scene.tri_p1, scene.tri_p2])
    lo, hi = pts.min(0).values, pts.max(0).values
    o = lo + (hi - lo) * (0.05 + 0.9 * torch.rand((2048, 3), generator=g))
    d = torch.randn((2048, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.full((2048,), INFINITY)
    t_max[::13] = 0.0
    a, b = dispatch.intersect(scene, meta, o, d, t_max), dispatch.intersect(sharded, meta, o,
                                                                           d, t_max)
    assert bool(a.valid.any())
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    t_sh = torch.rand(2048, generator=g) * 3.0
    assert torch.equal(dispatch.occluded(scene, meta, o, d, t_sh),
                       dispatch.occluded(sharded, meta, o, d, t_sh))


@pytest.mark.parametrize("n_parts,T", [(2, 3000), (4, 3000), (8, 3000), (16, 3000), (8, 68),
                                       (16, 68)])
def test_part_boxes_bound_their_parts(n_parts, T):
    """Each part's box is the union of its root row's non-empty child boxes
    (a leaf-only chunk's synthesized one-child root among them: 68
    triangles over 8 or 16 parts) and bounds every triangle of its part;
    the top level holds the boxes in its rows' slots, the root last (one
    row up to 8 parts, a tree of groups of 8 past them)."""
    p0, p1, p2 = _soup(np.random.default_rng(T + n_parts), T)
    g = ss.build_sharded(p0, p1, p2, n_parts)
    sh = ss.build_scene_shard(_soup_scene(p0, p1, p2, 3), n_parts)
    assert torch.equal(sh.rows, g.rows)
    rows = g.rows.numpy()
    boxes = sh.boxes.numpy()
    assert boxes.shape == (n_parts, 6)
    if T == 68:     # a synthesized root: one live slot, the part's single leaf row
        assert any(((r[0, 48:56] >= 0).sum(), r[0, 48]) == (1, g.n_int) for r in rows)
    tri = np.stack([p0, p1, p2], axis=1)
    for p in range(n_parts):
        slots = rows[p, 0, :48].reshape(8, 6)
        ok = (rows[p, 0, 48:56] >= 0) & (slots[:, 0] <= slots[:, 3])
        np.testing.assert_array_equal(boxes[p], np.r_[slots[ok, :3].min(0), slots[ok, 3:].max(0)])
        ids = g.src.numpy()[p]
        v = tri[ids[ids >= 0]].reshape(-1, 3)
        assert (v >= boxes[p, :3]).all() and (v <= boxes[p, 3:]).all()
    top = sh.top.numpy()
    assert top.shape == (1 if n_parts <= 8 else 1 + -(-n_parts // 8), 72)
    assert ss.top_levels(n_parts) == (1 if n_parts <= 8 else 2)
    # every part in exactly one slot of the rows over the parts, its box there
    child = top[:, 48:56]
    for p in range(n_parts):
        (r, k), = np.argwhere(child == p)
        np.testing.assert_array_equal(top[r, 6 * k: 6 * k + 6], boxes[p])
    root = top[-1]
    live = root[48:56] >= 0
    assert live.sum() == min(n_parts, 8) if n_parts <= 8 else live.sum() == top.shape[0] - 1
    lo, hi = root[:48].reshape(8, 6)[live, :3].min(0), root[:48].reshape(8, 6)[live, 3:].max(0)
    np.testing.assert_array_equal(np.r_[lo, hi], np.r_[boxes[:, :3].min(0), boxes[:, 3:].max(0)])


def test_local_and_to_carry_the_part_boxes():
    """A rank's shard holds its own parts' boxes and a top level over them
    alone; `to` carries both."""
    sh = ss.build_scene_shard(_soup_scene(*_soup(np.random.default_rng(6), 3000), 2), 16)
    for rank, world in ((0, 2), (1, 2), (2, 3), (0, 1)):
        lo, hi = sh.part_range(rank, world)
        loc = sh.local(rank, world)
        assert torch.equal(loc.boxes, sh.boxes[lo:hi])
        assert torch.equal(loc.top, ss.top_rows(sh.boxes[lo:hi]))
        assert loc.rows.shape[0] == loc.boxes.shape[0] == hi - lo
    moved = sh.local(1, 2).to("cpu")
    assert torch.equal(moved.boxes, sh.boxes[8:]) and torch.equal(moved.top, sh.local(1, 2).top)
    assert moved.boxes.is_contiguous() and moved.top.is_contiguous()


def test_wrappers_raise_on_a_stack_that_does_not_fit():
    """The wide kernels' stack holds 7 entries a level of the top level and
    the parts' deepest tree (at most 302). Both wrappers raise before a
    build or launch."""
    sh, o, d, t_max = _parts_args()
    fits = ss.WIDE_MAX_STACK // 7 - ss.top_levels(sh.rows.shape[0])
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ss.closest_parts_cuda(sh.rows, sh.recv, sh.n_int, fits, sh.top, o, d, t_max)
    with pytest.raises(ValueError, match="needs a stack of"):
        ss.closest_parts_cuda(sh.rows, sh.recv, sh.n_int, fits + 1, sh.top, o, d, t_max)
    with pytest.raises(ValueError, match="needs a stack of"):
        ss.any_parts_cuda(sh.rows, sh.n_int, fits + 1, sh.top, o, d, t_max)
    with pytest.raises(ValueError, match="top must be"):
        ss.any_parts_cuda(sh.rows, sh.n_int, sh.depth, None, o, d, t_max)
    with pytest.raises(ValueError, match="top must be"):
        ss.any_parts_cuda(sh.rows, sh.n_int, sh.depth, sh.top[:, :71].contiguous(), o, d,
                          t_max)


def _shifted(rows, n_int, dx):
    """A copy of one part's table moved by dx along x: its boxes' and
    triangles' x columns (an inverted slot stays inverted)."""
    out = rows.clone()
    for s in range(8):
        out[:n_int, 6 * s] += dx
        out[:n_int, 6 * s + 3] += dx
    for k in range(8):
        for j in range(3):
            out[n_int:, 9 * k + 3 * j] += dx
    return out


@pytest.mark.parametrize("any_hit", [False, True])
def test_parts_work_is_traversal_work_of_the_parts_met(any_hit):
    """The oracle behind K11a's and K11b's bounds: over one part it is
    bvh.traversal_work of that part's table on the rays whose segment
    meets its box, plus one top-level row a live ray; a second part that
    no segment meets (the first moved 100 along x, the rays cut at t 10)
    adds nothing."""
    rng = np.random.default_rng(8)
    p0, p1, p2 = _soup(rng, 400)
    g = ss.build_sharded(p0, p1, p2, 1)
    o, d = _rays(rng, 256)
    aim = (p0 + p1 + p2)[rng.integers(0, 400, 128)] / 3 - o[::2]   # half the rays aimed
    d[::2] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_max = torch.full((256,), 10.0)
    t_max[::11] = 0.0
    rows1 = g.rows
    rows2 = torch.stack([g.rows[0], _shifted(g.rows[0], g.n_int, 100.0)])
    boxes1, boxes2 = ss.part_boxes(rows1), ss.part_boxes(rows2)
    assert float(boxes2[1, 0]) > 90.0
    occ, cost = None, (1, 1, 1, 1)
    if any_hit:
        t_lim = t_max.clone()
        t_lim[1::3] *= torch.rand(t_lim[1::3].shape[0], generator=torch.Generator().manual_seed(2))
        occ = ss.any_parts_plain(rows2, g.n_int, o, d, t_lim)
        assert 10 < int(occ.sum()) < 200
        cost = (176, 30, 11, 33)
    else:
        pk = ss.closest_parts_plain(rows2, torch.zeros((2, rows2.shape[1] * 8, 36)), g.n_int,
                                    o, d, t_max)
        t_lim = torch.where(torch.isfinite(pk[:, 0]), pk[:, 0], t_max)
        assert int(torch.isfinite(pk[:, 0]).sum()) > 10
    one = ss.parts_work(rows1, g.n_int, boxes1, o, d, t_lim, occ, cost)
    # a ray whose segment misses the part's box reads the top row alone,
    # where traversal_work reads the part's root
    live = t_lim > 0
    m = (ss._boxes_meet(boxes1, o, d, t_lim)[:, 0] & live).nonzero()[:, 0]
    assert 20 < m.numel() < int(live.sum())
    tw = tbvh.traversal_work(rows1[0], g.n_int, o[m], d[m], t_lim[m],
                             None if occ is None else occ[m], cost)
    assert one == (tw[0] + int(live.sum()),) + tw[1:]
    assert tbvh.traversal_work(rows1[0], g.n_int, o, d, t_lim, occ, cost) == (
        tw[0] + int(live.sum()) - m.numel(),) + tw[1:]
    assert ss.parts_work(rows2, g.n_int, boxes2, o, d, t_lim, occ, cost) == one


def test_traversal_work_per_ray_sums_to_its_totals():
    """bvh.traversal_work's per-ray counts (parts_work takes the cheapest
    part of a blocked ray from them) sum to its four totals."""
    rng = np.random.default_rng(9)
    p0, p1, p2 = _soup(rng, 600)
    b = tbvh.build_bvh(p0, p1, p2)
    rows = torch.from_numpy(b.rows)
    o, d = (torch.from_numpy(x) for x in _rays(rng, 300))
    t_lim = torch.rand(300, generator=torch.Generator().manual_seed(1)) * 8
    t_lim[::7] = 0.0
    occ = tbvh.traverse_plain(rows, b.n_int, o, d, t_lim, any_hit=True)[1] >= 0
    for blocked in (None, occ):
        per = tbvh.traversal_work(rows, b.n_int, o, d, t_lim, blocked, (5, 1, 2, 3), chunk=64,
                                  per_ray=True)
        assert per.shape == (300, 4) and not per[t_lim <= 0].any()
        assert tuple(int(x) for x in per.sum(0)) == tbvh.traversal_work(
            rows, b.n_int, o, d, t_lim, blocked, (5, 1, 2, 3))


def _parts_args():
    sh = ss.build_scene_shard(_soup_scene(*_soup(np.random.default_rng(4), 200), 0), 2)
    o = torch.zeros((16, 3))
    d = torch.nn.functional.normalize(torch.ones((16, 3)), dim=-1)
    return sh, o, d, torch.full((16,), INFINITY)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    """dtype, shape and device checks of K11a, K11b and
    the select, all raised before a build: CPU tensors of the right kind
    raise for their device."""
    sh, o, d, t_max = _parts_args()
    rows, recv, n_int, depth, top = sh.rows, sh.recv, sh.n_int, sh.depth, sh.top
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ss.closest_parts_cuda(rows, recv, n_int, depth, top, o, d, t_max)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ss.any_parts_cuda(rows, n_int, depth, top, o, d, t_max)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ss.select_cuda(torch.zeros((2, 16, ss.PACK_W)))
    with pytest.raises(ValueError, match="o must be"):
        ss.closest_parts_cuda(rows, recv, n_int, depth, top, o.double(), d, t_max)
    with pytest.raises(ValueError, match="t_max must be"):
        ss.any_parts_cuda(rows, n_int, depth, top, o, d, t_max[:8])
    with pytest.raises(ValueError, match="rows must be"):
        ss.closest_parts_cuda(rows[..., :71].contiguous(), recv, n_int, depth, top, o, d, t_max)
    with pytest.raises(ValueError, match="rows must be"):
        ss.any_parts_cuda(rows[0], n_int, depth, top, o, d, t_max)
    with pytest.raises(ValueError, match="recv must be"):
        ss.closest_parts_cuda(rows, recv[..., :35].contiguous(), n_int, depth, top, o, d, t_max)
    with pytest.raises(ValueError, match="fewer than"):
        ss.closest_parts_cuda(rows, recv[:, :8].contiguous(), n_int, depth, top, o, d, t_max)
    with pytest.raises(ValueError, match="n_int"):
        ss.any_parts_cuda(rows, rows.shape[1], depth, top, o, d, t_max)
    with pytest.raises(ValueError, match="stats must be"):
        ss.any_parts_cuda(rows, n_int, depth, top, o, d, t_max, stats=torch.zeros(4))
    with pytest.raises(ValueError, match="packs must be"):
        ss.select_cuda(torch.zeros((2, 16, ss.PACK_W - 1)))
    with pytest.raises(ValueError, match="packs must be"):
        ss.select_cuda(torch.zeros((2, 16, ss.PACK_W), dtype=torch.float64))


def test_scene_sharding_needs_a_bvh_scene():
    scene, _ = tts.cornell(res=8, spp=1, device="cpu")
    with pytest.raises(ValueError, match="BVH scene"):
        ss.build_scene_shard(scene, 2)
