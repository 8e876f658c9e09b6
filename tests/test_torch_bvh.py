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


def test_refit_plain_is_the_closest_hit_refit(scenes, rays):
    """refit_plain on the traversal's winners gives closest_hit_tris'
    record bit for bit (the glue its kernel, refit_cuda, replaces on the
    card), misses and masked lanes included; refit_cuda refuses CPU
    tensors."""
    _, ts, tm = scenes
    o, d, t_max = (torch.from_numpy(x) for x in rays)
    ht = tbvh.closest_hit_tris(ts, tm, o, d, t_max)
    _, prim = tbvh.traverse_plain(ts.bvh_rows, tm.bvh_nint, o, d, t_max, False)
    t, p, b = tbvh.refit_plain(ts.tri_p0, ts.tri_p1, ts.tri_p2, o, d, t_max, prim)
    assert torch.equal(p, ht.prim) and torch.equal(t.view(torch.int32), ht.t.view(torch.int32))
    assert torch.equal(b.view(torch.int32), ht.b.view(torch.int32))
    assert bool((p >= 0).any()) and bool((p < 0).any())
    with pytest.raises(ValueError):
        tbvh.refit_cuda(ts.tri_p0, ts.tri_p1, ts.tri_p2, o, d, t_max, prim)


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


def _walk_work(rows, n_int, o, d, t_lim, occluded=None, cost=(1, 1, 1, 1), n_inst=0):
    """A brute-force per-ray walk for traversal_work, in numpy float32 scalar
    arithmetic: from the root, every internal row whose box the segment
    [0, t_lim] meets (the kernels' slab test), and the watertight exit stage
    of each triangle of each leaf reached, at the float after t_lim (any
    hit, `occluded` given: at t_lim). An occluded ray instead takes, of the
    leaves reached that hold a hit within t_lim, the one whose root path and
    slots up to its first hit weigh least by `cost` (ties to the lower row,
    then the lower instance). n_inst: a two-level table, whose instance rows
    a ray enters (a fifth count) with its ray moved into the instance's
    object space (accel/bvh.py object_rays), going on at the prototype's
    root."""
    f32 = np.float32
    widen = f32(1.0 + 2.0 * ((3 * 2.0 ** -24) / (1 - 3 * 2.0 ** -24)))
    counts = [0, 0, 0, 0, 0]
    any_hit = occluded is not None
    occluded = np.zeros(len(o), bool) if occluded is None else occluded
    leaf0 = n_int + n_inst

    def set_up(oi, di):
        """the ray's origin, 1 / d and shear"""
        inv = [f32(-1.0 if x < 0 else 1.0) / f32(max(abs(x), f32(1e-30))) for x in di]
        kz = int(np.argmax(np.abs(di)))
        perm = [(kz + 1) % 3, (kz + 2) % 3, kz]
        dz = di[perm[2]]
        dz = f32(-max(abs(dz), f32(1e-12)) if dz < 0 else max(abs(dz), f32(1e-12)))
        return oi, inv, perm, (-di[perm[0]] / dz, -di[perm[1]] / dz, f32(1.0) / dz)

    for o_w, d_w, tl, blocked in zip(o, d, t_lim, occluded):
        if not tl > 0:
            continue
        t_hi = tl if any_hit else np.nextafter(tl, f32(np.inf))

        def stages(r, ray):
            """[(past the edge-sign test, past the range test)] of the 8 slots"""
            oi, _, perm, (sx, sy, sz) = ray
            out = []
            for k in range(8):
                v = [[rows[r, 9 * k + 3 * j + i] - oi[i] for i in range(3)] for j in range(3)]
                a, b, c = ([p[perm[0]], p[perm[1]], p[perm[2]]] for p in v)
                ax, ay = a[0] + sx * a[2], a[1] + sy * a[2]
                bx, by = b[0] + sx * b[2], b[1] + sy * b[2]
                cx, cy = c[0] + sx * c[2], c[1] + sy * c[2]
                e = (cx * by - cy * bx, ax * cy - ay * cx, bx * ay - by * ax)
                if min(e) < 0 and max(e) > 0:
                    out.append((False, False))
                    continue
                det = e[0] + e[1] + e[2]
                ts = e[0] * (sz * a[2]) + e[1] * (sz * b[2]) + e[2] * (sz * c[2])
                tm = t_hi * det
                out.append((True, bool(det != 0 and ((ts < 0 and ts > tm) if det < 0
                                                      else (ts > 0 and ts < tm)))))
            return out

        reached = []                # (leaf row, internal rows on its root path, ray, instance)
        n_read, n_enter = [0], [0]

        def visit(r, path, ray, inst):
            if r >= leaf0:
                return reached.append((r, path, ray, inst))
            if r >= n_int:          # an instance row: into its object space
                n_enter[0] += 1
                o_i, d_i = (x.numpy()[0] for x in tbvh.object_rays(
                    torch.from_numpy(rows[r, :12].copy()), torch.from_numpy(o_w[None]),
                    torch.from_numpy(d_w[None])))
                return visit(int(rows[r, 12]), path, set_up(o_i, d_i), int(rows[r, 13]))
            oi, inv = ray[0], ray[1]
            n_read[0] += 1
            path += 1
            for s in range(8):
                child = int(rows[r, 48 + s])
                b = rows[r, 6 * s: 6 * s + 6]
                t0 = [(b[i] - oi[i]) * inv[i] for i in range(3)]
                t1 = [(b[3 + i] - oi[i]) * inv[i] for i in range(3)]
                tn = max(max(min(t0[i], t1[i]) for i in range(3)), f32(0.0))
                tf = min(max(t0[i], t1[i]) for i in range(3)) * widen
                if child >= 0 and b[0] <= b[3] and tn <= tf and tf > 0 and tn <= tl:
                    visit(child, path, ray, inst)
        visit(0, 0, set_up(o_w, d_w), -1)
        if not blocked:
            counts[0] += n_read[0]
            counts[4] += n_enter[0]
            for r, _, ray, _ in reached:
                st = stages(r, ray)
                counts[1] += 8
                counts[2] += sum(e for e, _ in st)
                counts[3] += sum(g for _, g in st)
            continue
        best = None
        for r, path, ray, inst in reached:
            st = stages(r, ray)
            if not any(g for _, g in st):
                continue
            k = [g for _, g in st].index(True)
            work = (path, k + 1, sum(e for e, _ in st[: k + 1]), 1, int(inst >= 0))
            key = (sum(c * x for c, x in zip(cost, work)), r, inst)
            if best is None or key < best[0]:
                best = (key, work)
        assert best is not None
        counts = [c + x for c, x in zip(counts, best[1])]
    return tuple(counts[:5 if n_inst else 4])


def _soup68():
    g = np.random.default_rng(68)
    base = g.uniform(-10, 10, (68, 3)).astype(np.float32)
    p = (base, base + g.normal(0, 0.7, (68, 3)).astype(np.float32),
         base + g.normal(0, 0.7, (68, 3)).astype(np.float32))
    b = tbvh.build_bvh(*p)
    return b.rows, b.n_int, (p[0] + p[1] + p[2]) / 3


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("scene", ["cornell-mesh-2", "cornell-mesh-3", "soup68",
                                   "instanced-2-1"])
def test_traversal_work_matches_walk(scene, any_hit):
    """traversal_work (the oracle count behind chip_smoke.py's K1 and K1a
    bounds, and on the instanced cornell box at levels (2, 1), every
    instance shared, K1i's and K1i-a's) against a brute-force per-ray walk,
    with masked lanes and rays along an axis. Closest hit: limits from the
    plain traversal, some cut shorter. Any hit: t_max infinite or cut short,
    the rays the plain traversal finds blocked taking their cheapest hitting
    leaf under chip_smoke.py's op weights, which is less work than reading
    every row to t_max. The four sums (five with instance entries) equal."""
    g = np.random.default_rng(11)
    n_inst, leaves = 0, None
    if scene == "soup68":
        rows, n_int, cent = _soup68()
        o = g.uniform(-15, 15, (96, 3)).astype(np.float32)
        d = cent[g.integers(0, 68, 96)] + g.normal(0, 0.05, (96, 3)).astype(np.float32) - o
    else:
        b = (tts.instanced_cornell_builder((2, 1), 16, 1, "bvh", "box") if scene == "instanced-2-1"
             else tts.cornell_mesh_builder(levels=int(scene[-1]), res=16))
        sc, mt = scene_from_arrays(*compile_arrays(b, 1), "cpu")
        rows, n_int, n_inst, leaves = sc.bvh_rows.numpy(), mt.bvh_nint, mt.bvh_ninst, mt.bvh_leaves
        pts = np.concatenate([sc.tri_p0.numpy(), sc.tri_p1.numpy()])
        lo, hi = pts.min(0), pts.max(0)
        o = (lo + (hi - lo) * (0.05 + 0.9 * g.random((96, 3)))).astype(np.float32)
        d = g.normal(size=(96, 3)).astype(np.float32)
    d[:8, 1:] = 0.0
    d[8:16, :2] = 0.0
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.full(96, INFINITY, np.float32)
    t_max[::9] = 0.0
    rt, ot, dt = (torch.from_numpy(x) for x in (rows, o, d))

    def plain(t, any_hit=False):
        if n_inst:
            return tbvh.traverse_inst_plain(rt, n_int, leaves, ot, dt, torch.from_numpy(t),
                                            any_hit)[:2]
        return tbvh.traverse_plain(rt, n_int, ot, dt, torch.from_numpy(t), any_hit)
    t_cl, prim = plain(t_max)
    assert (prim.numpy() >= 0).sum() > 20
    t_lim = t_cl.numpy().copy()
    cut = g.random(t_lim[1::3].shape[0]).astype(np.float32)
    occluded, cost = None, (1, 1, 1, 1, 1)
    if any_hit:     # t_max: infinite, or cut short of (or past) the closest hit
        t_lim, hit = t_max.copy(), np.flatnonzero(t_cl.numpy() < INFINITY)
        t_lim[hit[1::3]] = t_cl.numpy()[hit[1::3]] * 2 * cut[: hit[1::3].shape[0]]
        occluded = (plain(t_lim, True)[1] >= 0).numpy()
        assert 20 < occluded.sum() < (t_lim > 0).sum()
        cost = (176, 30, 11, 33, 55)   # chip_smoke.py: SLAB_VISIT_OPS, TRI_*_OPS, INST_ENTRY_OPS
    else:           # shorter limits, as another ray's answer
        t_lim[1::3] *= cut
    got = tbvh.traversal_work(rt, n_int, ot, dt, torch.from_numpy(t_lim),
                              None if occluded is None else torch.from_numpy(occluded), cost,
                              chunk=40, n_inst=n_inst)
    want = _walk_work(rows, n_int, o, d, t_lim, occluded, cost, n_inst)
    assert got == want and got[0] >= (t_lim > 0).sum() and got[3] > 0
    assert len(got) == (5 if n_inst else 4) and (not n_inst or got[4] > 0)
    if any_hit:
        full = tbvh.traversal_work(rt, n_int, ot, dt, torch.from_numpy(t_lim), chunk=40,
                                   n_inst=n_inst)
        assert got[0] < full[0] and got[1] < full[1]
