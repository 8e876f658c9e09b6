"""pbrt_tpu_torch BVH traversal (K1/K2 module) vs pbrt_tpu.

On the CPU the traversal wrappers run the kernel's plain version (a dense
watertight sweep over the padded leaf soup). On cornell-mesh levels 3 with
2048 seeded rays (camera rays, random rays from inside the box, and t_max=0
lanes) they must agree with pbrt_tpu.accel.bvh: prim equal except on
verified ties (both triangles hit with |dt| <= 1e-6 t), t and barycentrics
within 1e-5 relative, occlusion equal. The CUDA kernel itself runs only on
the card: tests/test_torch_gpu.py holds it against the plain version there."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pbrt_tpu.accel import bvh as jbvh
from pbrt_tpu.geometry import intersect as jix
from pbrt_tpu.scene import builder as jbd, lexer as jlx, testscenes as jts
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu.utils.math import INFINITY
from pbrt_tpu_torch.accel import bvh as tbvh
from pbrt_tpu_torch.geometry import intersect as tix
from pbrt_tpu_torch.scene import testscenes as tts
from pbrt_tpu_torch.scene.compile import compile_arrays, scene_from_arrays

torch.set_num_threads(2)
R = 2048


@pytest.fixture(scope="module")
def scenes():
    jb = jbd.SceneBuilder()
    jb.parse_tokens(jlx.tokenize(jts.cornell_mesh_pbrt(levels=3)))
    jb.film["xresolution"] = jb.film["yresolution"] = 32
    js, _ = j_compile(jb, spp_override=1)
    arrays, meta = compile_arrays(tts.cornell_mesh_builder(levels=3, res=32), 1)
    ts, tm = scene_from_arrays(arrays, meta, "cpu")
    return js, ts, tm


@pytest.fixture(scope="module")
def rays(scenes):
    js, ts, tm = scenes
    g = np.random.default_rng(42)
    from pbrt_tpu_torch.cameras import perspective
    n_cam = R // 2
    p_film = (g.random((n_cam, 2)) * 32).astype(np.float32)
    cam = perspective.generate_rays(ts, torch.from_numpy(p_film), torch.zeros((n_cam, 2)))
    pts = np.concatenate([np.asarray(js.tri_p0), np.asarray(js.tri_p1)])
    lo, hi = pts.min(0), pts.max(0)
    o_in = (lo + (hi - lo) * (0.05 + 0.9 * g.random((R - n_cam, 3)))).astype(np.float32)
    d_in = g.normal(size=(R - n_cam, 3)).astype(np.float32)
    d_in /= np.linalg.norm(d_in, axis=-1, keepdims=True)
    o = np.concatenate([cam.o.numpy(), o_in])
    d = np.concatenate([cam.d.numpy(), d_in])
    t_max = np.full(R, INFINITY, np.float32)
    t_max[::17] = 0.0
    return o, d, t_max


def _verify_ties(ts, o, d, t_max, p_a, p_b):
    """Lanes where the winners differ must be ties: both hit, equal t."""
    differ = (p_a != p_b) & (p_b >= 0)
    if not differ.any():
        return 0
    ot, dt, tm = (torch.from_numpy(x[differ]) for x in (o, d, t_max))

    def test(p):
        p = torch.from_numpy(p[differ])
        return tix.intersect_tri_lanes(ot, dt, tm, ts.tri_p0[p], ts.tri_p1[p], ts.tri_p2[p])

    ta, _, ha = test(p_a)
    tb, _, hb = test(p_b)
    assert bool((ha & hb).all())
    assert bool(((ta - tb).abs() <= 1e-6 * tb.abs()).all())
    return int(differ.sum())


def test_closest_hit_matches_jax(scenes, rays):
    js, ts, tm = scenes
    o, d, t_max = rays
    hj = jbvh.closest_hit_tris(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    ht = tbvh.closest_hit_tris(ts, tm, torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(t_max))
    pj, pt = np.asarray(hj.prim).astype(np.int64), ht.prim.numpy()
    assert np.array_equal(pj >= 0, pt >= 0)
    assert (pj >= 0).sum() > R // 2
    assert not (pt[::17] >= 0).any()             # t_max = 0 lanes miss
    _verify_ties(ts, o, d, t_max, pt, pj)
    same = (pj == pt) & (pj >= 0)
    np.testing.assert_allclose(ht.t.numpy()[same], np.asarray(hj.t)[same], rtol=1e-5)
    np.testing.assert_allclose(ht.b.numpy()[same], np.asarray(hj.b)[same], rtol=1e-5,
                               atol=1e-5)


def test_any_hit_matches_jax(scenes, rays):
    js, ts, tm = scenes
    o, d, t_max = rays
    ht = tbvh.closest_hit_tris(ts, tm, torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(t_max))
    u = np.random.default_rng(9).random(R).astype(np.float32)
    hit = ht.prim.numpy() >= 0
    t_sh = np.where(hit, np.where(hit, ht.t.numpy(), 0.0) * 2.0 * u, 1e3).astype(np.float32)
    t_sh[::13] = 0.0
    oj = jbvh.any_hit_tris(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_sh))
    ot = tbvh.any_hit_tris(ts, tm, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(t_sh))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert 0 < ot.sum() < R and not ot.numpy()[::13].any()


@pytest.mark.parametrize("T", [70, 333, 20000])
def test_plain_sweep_matches_dense(T):
    """The plain traversal, closest and any hit, against JAX's all-pairs
    intersect_tris_dense and occluded_tris_dense on a random soup (rows built
    by the port's own host BVH build). At 20,000
    triangles the sweep runs several chunks, each against the rays that meet
    its bounds; a sixteenth of the rays run along an axis (zero direction
    components), the slab test's infinite-slope case."""
    g = np.random.default_rng(T)
    base = g.uniform(-10, 10, (T, 3)).astype(np.float32)
    p0, p1, p2 = base, base + g.normal(0, 0.7, (T, 3)).astype(np.float32), \
        base + g.normal(0, 0.7, (T, 3)).astype(np.float32)
    build = tbvh.build_bvh(p0, p1, p2)
    tp = [tbvh.reorder_pad(build, p, 0.0) for p in (p0, p1, p2)]
    o = g.uniform(-15, 15, (512, 3)).astype(np.float32)
    cent = ((p0 + p1 + p2) / 3.0)[g.integers(0, T, 512)]
    d = cent + g.normal(0, 0.3, (512, 3)).astype(np.float32) - o
    for axis in range(3):
        d[axis * 11: axis * 11 + 11, [k for k in range(3) if k != axis]] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(512, INFINITY, np.float32)
    hd = jix.intersect_tris_dense(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                  jix.TriangleSoA(*(jnp.asarray(p) for p in tp)))
    t, prim = tbvh.traverse_plain(torch.from_numpy(build.rows), build.n_int,
                                  torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(t_max))
    pd_ = np.asarray(hd.prim).astype(np.int64)
    np.testing.assert_array_equal(prim.numpy(), pd_)
    hit = pd_ >= 0
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(hd.t)[hit], rtol=1e-6)
    # any hit: shadow segments ending short of, or past, the closest hit
    u = g.random(512).astype(np.float32)
    t_sh = np.where(hit, np.where(hit, t.numpy(), 0.0) * 2.0 * u, 1e3).astype(np.float32)
    t_sh[::13] = 0.0
    occ_d = jix.occluded_tris_dense(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_sh),
                                    jix.TriangleSoA(*(jnp.asarray(p) for p in tp)))
    _, occ = tbvh.traverse_plain(torch.from_numpy(build.rows), build.n_int,
                                 torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(t_sh), any_hit=True)
    np.testing.assert_array_equal(occ.numpy() >= 0, np.asarray(occ_d))
    assert 0 < (occ.numpy() >= 0).sum() < hit.sum()


def test_watertight_lanes_match_jax():
    g = np.random.default_rng(1)
    n = 4096
    o = g.normal(0, 1, (n, 3)).astype(np.float32)
    p = [g.normal(0, 1, (n, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32)
         for _ in range(3)]
    d = (p[0] + p[1] + p[2]) / 3 + g.normal(0, 0.6, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    tj, bj, hj = jix.intersect_tri_lanes(*map(jnp.asarray, (o, d, t_max, *p)))
    tt, bt, ht = tix.intersect_tri_lanes(*map(torch.from_numpy, (o, d, t_max, *p)))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    h = ht.numpy()
    assert 0 < h.sum() < n
    np.testing.assert_allclose(tt.numpy()[h], np.asarray(tj)[h], rtol=1e-6)
    np.testing.assert_allclose(bt.numpy()[h], np.asarray(bj)[h], rtol=1e-5, atol=1e-6)
