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


def _parts_args():
    sh = ss.build_scene_shard(_soup_scene(*_soup(np.random.default_rng(4), 200), 0), 2)
    o = torch.zeros((16, 3))
    d = torch.nn.functional.normalize(torch.ones((16, 3)), dim=-1)
    return sh, o, d, torch.full((16,), INFINITY)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    """dtype, shape and device checks of K11a, K11b and the select, all
    raised before a build: CPU tensors of the right kind raise for their
    device."""
    sh, o, d, t_max = _parts_args()
    rows, recv, n_int, depth = sh.rows, sh.recv, sh.n_int, sh.depth
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ss.closest_parts_cuda(rows, recv, n_int, depth, o, d, t_max)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ss.any_parts_cuda(rows, n_int, depth, o, d, t_max)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ss.select_cuda(torch.zeros((2, 16, ss.PACK_W)))
    with pytest.raises(ValueError, match="o must be"):
        ss.closest_parts_cuda(rows, recv, n_int, depth, o.double(), d, t_max)
    with pytest.raises(ValueError, match="t_max must be"):
        ss.any_parts_cuda(rows, n_int, depth, o, d, t_max[:8])
    with pytest.raises(ValueError, match="rows must be"):
        ss.closest_parts_cuda(rows[..., :71].contiguous(), recv, n_int, depth, o, d, t_max)
    with pytest.raises(ValueError, match="rows must be"):
        ss.any_parts_cuda(rows[0], n_int, depth, o, d, t_max)
    with pytest.raises(ValueError, match="recv must be"):
        ss.closest_parts_cuda(rows, recv[..., :35].contiguous(), n_int, depth, o, d, t_max)
    with pytest.raises(ValueError, match="fewer than"):
        ss.closest_parts_cuda(rows, recv[:, :8].contiguous(), n_int, depth, o, d, t_max)
    with pytest.raises(ValueError, match="n_int"):
        ss.any_parts_cuda(rows, rows.shape[1], depth, o, d, t_max)
    with pytest.raises(ValueError, match="stats must be"):
        ss.any_parts_cuda(rows, n_int, depth, o, d, t_max, stats=torch.zeros(4))
    with pytest.raises(ValueError, match="packs must be"):
        ss.select_cuda(torch.zeros((2, 16, ss.PACK_W - 1)))
    with pytest.raises(ValueError, match="packs must be"):
        ss.select_cuda(torch.zeros((2, 16, ss.PACK_W), dtype=torch.float64))


def test_scene_sharding_needs_a_bvh_scene():
    scene, _ = tts.cornell(res=8, spp=1, device="cpu")
    with pytest.raises(ValueError, match="BVH scene"):
        ss.build_scene_shard(scene, 2)
