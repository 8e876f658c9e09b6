"""The dense sweeps (K3, K4 and K4a; pbrt_tpu_torch/csrc/
dense_intersect.cu) without a card: the wrappers' launch-shape rules, a
mirror of K3's group reduction and of its staged table, held bit for bit to
the plain versions, the plain versions against pbrt_tpu's on
caustic-glass's own tables, and the occluded dispatch's any-hit sphere
route.

K3 gives a ray a group of G lanes: lane j tests triangles j, j + G, ...,
keeps its best (a candidate replaces it only when strictly nearer, and
brings its barycentrics along), and a butterfly of shuffles takes the
smallest t, ties to the lowest prim. The mirror below runs that order on
the plain block's per-candidate t and barycentrics and must pick
`intersect_tris_dense_plain`'s winner, t and barycentrics bit for bit, also
on rays aimed through the tables' shared edges, where two triangles are hit
at the same t.

Against pbrt_tpu: prim ids and disk indices exact; t, barycentrics and p
to 2e-5 relative (XLA may sum a 3-vector dot product in another order or
fuse a multiply-add), as tests/test_torch_quadrics.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pbrt_tpu.geometry import intersect as jix
from pbrt_tpu.scene.compile import load_scene as j_load
from pbrt_tpu_torch.geometry import intersect as ix
from pbrt_tpu_torch.scene import testscenes as tts
from pbrt_tpu_torch.scene.compile import load_scene
import dense_cases

torch.set_num_threads(2)
CAUSTIC = "scenes/caustic-glass.pbrt"


@pytest.fixture(scope="module")
def tables():
    corn, _ = tts.cornell(res=8, spp=1, device="cpu")
    caus, _ = load_scene(CAUSTIC, device="cpu", spp=1, integrator="path")
    return {name: (s.tri_p0, s.tri_p1, s.tri_p2) for name, s in
            (("cornell", corn), ("caustic-glass", caus))}


def _rays(tris, n, seed):
    """n rays from inside the table's bounds, half of them through its
    shared edges; every 11th lane masked, every 7th short."""
    g = np.random.default_rng(seed)
    pts = torch.cat(tris)
    lo, hi = pts.min(0).values, pts.max(0).values
    o = (lo + (hi - lo) * torch.as_tensor(g.uniform(0.05, 0.95, (n, 3)), dtype=torch.float32))
    d = torch.as_tensor(g.normal(size=(n, 3)), dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.full((n,), ix.INFINITY)
    t_max[::11] = 0.0
    t_max[3::7] = torch.as_tensor(g.uniform(0.0, 2.0, len(t_max[3::7])), dtype=torch.float32)
    o_t, d_t, t_t = dense_cases.tie_rays(*tris, n, seed + 1)
    return tuple(torch.cat([a, b]).contiguous() for a, b in ((o, o_t), (d, d_t), (t_max, t_t)))


def _group_mirror(o, d, t_max, tris, G):
    """K3's answer at group size G, in its order: each lane's strided
    serial sweep, then the butterfly over offsets G/2, ..., 1 taking the
    partner's (t, prim, b) where its t is smaller or equal with a lower
    prim (unsigned: a miss's -1 loses). -> (t, prim, b)."""
    kz, sx, sy, sz = ix.ray_shear(d)
    prep = lambda pv: ix.permute_by_kz(pv[None] - o[:, None], kz[:, None])
    t, bary, hit = ix.watertight_core(*(prep(p) for p in tris), sx[:, None], sy[:, None],
                                      sz[:, None], t_max[:, None])
    hit = hit & (t_max > 0)[:, None]
    R, T = t.shape
    bary = torch.stack(bary, dim=-1)
    lane_t = torch.full((R, G), ix.INFINITY)
    lane_p = torch.full((R, G), -1, dtype=torch.int64)
    lane_b = torch.zeros((R, G, 3))
    for j in range(G):
        for k in range(j, T, G):
            better = hit[:, k] & (t[:, k] < lane_t[:, j])
            lane_t[:, j] = torch.where(better, t[:, k], lane_t[:, j])
            lane_p[:, j] = torch.where(better, k, lane_p[:, j])
            lane_b[:, j] = torch.where(better[:, None], bary[:, k], lane_b[:, j])
    off = G // 2
    while off:
        partner = torch.arange(G) ^ off
        t_o, p_o, b_o = lane_t[:, partner], lane_p[:, partner], lane_b[:, partner]
        u, u_o = lane_p % (1 << 32), p_o % (1 << 32)
        take = (t_o < lane_t) | ((t_o == lane_t) & (u_o < u))
        lane_t = torch.where(take, t_o, lane_t)
        lane_p = torch.where(take, p_o, lane_p)
        lane_b = torch.where(take[..., None], b_o, lane_b)
        off //= 2
    return lane_t[:, 0], lane_p[:, 0], lane_b[:, 0]


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["cornell", "caustic-glass"])
def test_group_reduction_picks_the_serial_winner(tables, name, G):
    tris = tables[name]
    o, d, t_max = _rays(tris, 1500, 17)
    ties = dense_cases.exact_ties(o, d, t_max, *tris)
    assert int(ties.sum()) > 100
    t, prim, b = _group_mirror(o, d, t_max, tris, G)
    want = ix.intersect_tris_dense_plain(o, d, t_max, *tris)
    assert int((want.prim >= 0).sum()) > 1000
    assert torch.equal(prim, want.prim)
    assert torch.equal(t, want.t)
    assert torch.equal(b, want.b)


def test_launch_shape_rules():
    """The mode of K3 and K4a and K3's group size at the waves they run
    (cornell's and caustic-glass BDPT's 2^20 lanes, a BDPT wave's shadow
    rays, caustic-glass-mlt's 8,192 and its 286,720 shadow rays) and at the
    edges: wide from 2^19 rays, and there G = 1; else G a power of two up
    to 8, at most the triangle count (but 1), the launch's lanes under
    2^17 past G = 1."""
    w = ix.dense_wide
    assert w(1 << 20) and w(36700160) and w(1 << 19)
    assert not w(286720) and not w(8192) and not w(9216) and not w((1 << 19) - 1)
    g = ix.dense_tri_group
    assert g(1 << 20, 12) == 1 and g(1 << 20, 4) == 1
    assert g(8192, 4) == 4
    assert g(1, 63) == 8 and g(8192, 1) == 1 and g(8192, 0) == 1 and g(0, 12) == 8
    assert g(8192, 12) == 8                      # 12 is no multiple of 8
    assert g((1 << 16) - 1, 12) == 2 and g(1 << 16, 12) == 1
    for n in (1, 100, 8192, 9216, 20000, 65535, 65536, 1 << 17, 1 << 20):
        for T in (0, 1, 2, 3, 4, 5, 12, 63):
            G = g(n, T)
            assert G in (1, 2, 4, 8) and (G == 1 or (G <= T and n * G < 1 << 17))
            assert G == 1 or not w(n)


def _staged_copies(p0, p1, p2, stride):
    """Plain mirror of K3's staged table (csrc/dense_intersect.cu
    stage_tris), (3, stride) floats: copy kz, row k holds p0[k], p1[k],
    p2[k] each permuted as (v[kz+1], v[kz+2], v[kz]) by index, then 3 zeros;
    the pad after the rows is 0."""
    T = p0.shape[0]
    out = torch.zeros((3, stride))
    for kz in range(3):
        perm = [(kz + 1) % 3, (kz + 2) % 3, kz]
        rows = torch.cat([torch.cat([v[:, perm] for v in (p0, p1, p2)], dim=1),
                          torch.zeros((T, 3))], dim=1)
        out[kz, :12 * T] = rows.reshape(-1)
    return out


def test_staged_copies_mirror_permute_by_kz(tables):
    """K3's staged table: copy kz, row k holds the triangle's vertices
    permuted by kz as `permute_by_kz` does, so a test's translated vertex
    (row - the origin permuted alike) is the BVH test's permute_by_kz(p -
    o), bit for bit; the copies lie 4 (mod 32) floats apart, so one row of
    the three copies meets three disjoint 4-bank windows, and 8 rows of
    one copy (a group of 8) eight."""
    for T, tris in [(t[0].shape[0], t) for t in tables.values()] + [(63, None), (0, None)]:
        if tris is None:
            g = np.random.default_rng(T)
            tris = tuple(torch.as_tensor(g.normal(size=(T, 3)), dtype=torch.float32)
                         for _ in range(3))
        stride = ix.dense_tri_stride(T)
        assert stride % 32 == 4 and stride >= 12 * T and 3 * 4 * stride <= ix.DENSE_SMEM_MAX
        rows = _staged_copies(*tris, stride)
        assert rows.shape == (3, stride) and not rows[:, 12 * T:].any()
        o = torch.as_tensor(np.random.default_rng(1).normal(size=(T, 3)), dtype=torch.float32)
        for kz in range(3):
            kzs = torch.full((T,), kz)
            r = rows[kz, :12 * T].reshape(T, 12)
            assert not r[:, 9:].any()
            po = torch.stack(ix.permute_by_kz(o, kzs), dim=-1)
            for v, p in enumerate(tris):
                want = torch.stack(ix.permute_by_kz(p - o, kzs), dim=-1)
                assert torch.equal(r[:, 3 * v:3 * v + 3] - po, want)
        for k in range(max(T, 1)):
            for j in range(3):
                windows = {((kz * stride + 12 * k + 4 * j) % 32) // 4 for kz in range(3)}
                assert len(windows) == 3
        windows = {((12 * k) % 32) // 4 for k in range(8)}
        assert len(windows) == 8
    assert ix.DENSE_MAX_TRIS >= 63 and 12 * ix.dense_tri_stride(ix.DENSE_MAX_TRIS + 1) > \
        ix.DENSE_SMEM_MAX


def test_caustic_glass_tables_match_jax():
    """caustic-glass's 4 triangles and its disk through the port's plain
    versions against pbrt_tpu's intersect_tris_dense, occluded_tris_dense
    and intersect_disks_dense, on rays from inside the scene, half of them
    through the triangles' shared edge, and rays towards the disk."""
    ja, _ = j_load(CAUSTIC, spp=1, integrator="path")
    sc, _ = load_scene(CAUSTIC, device="cpu", spp=1, integrator="path")
    tris = (sc.tri_p0, sc.tri_p1, sc.tri_p2)
    assert tris[0].shape[0] == 4 and sc.dsk_center.shape[0] == 1
    jtris = jix.TriangleSoA(ja.tri_p0, ja.tri_p1, ja.tri_p2)
    for p, jp in zip(tris, jtris):
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    o, d, t_max = _rays(tris, 2000, 5)
    jo, jd, jt = (jnp.asarray(x.numpy()) for x in (o, d, t_max))
    got = ix.intersect_tris_dense(o, d, t_max, *tris)
    want = jix.intersect_tris_dense(jo, jd, jt, jtris)
    prim = np.asarray(want.prim)
    np.testing.assert_array_equal(got.prim.numpy(), prim)
    hit = prim >= 0
    assert hit.sum() > 1000 and (~hit).sum() > 300
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=2e-5)
    np.testing.assert_allclose(got.b.numpy()[hit], np.asarray(want.b)[hit], rtol=2e-5,
                               atol=2e-5)
    # shadow rays up to twice the closest hit (300 where none)
    t_sh = torch.where(got.t < ix.INFINITY, 2.0 * got.t, 300.0)
    t_sh[::11] = 0.0
    occ = ix.occluded_tris_dense(o, d, t_sh, *tris)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jix.occluded_tris_dense(jo, jd, jnp.asarray(t_sh.numpy()),
                                                        jtris)))
    assert 0 < int(occ.sum()) < o.shape[0]
    # towards points of the disk's plane within 1.3 radii of its center
    g = np.random.default_rng(9)
    c, r = sc.dsk_center.numpy()[0], float(sc.dsk_radius[0])
    nrm = sc.dsk_normal.numpy()[0].astype(np.float64)
    ax = np.cross(nrm, [1.0, 0.0, 0.0] if abs(nrm[0]) < 0.9 else [0.0, 1.0, 0.0])
    ax /= np.linalg.norm(ax)
    ay = np.cross(nrm, ax)
    rho = 1.3 * r * np.sqrt(g.uniform(0.0, 1.0, (3000, 1)))
    phi = g.uniform(0.0, 2 * np.pi, (3000, 1))
    target = c + rho * (np.cos(phi) * ax + np.sin(phi) * ay)
    o_d = o.numpy()[:3000]
    d_d = ((target - o_d) / np.linalg.norm(target - o_d, axis=1, keepdims=True)).astype(
        np.float32)
    t_d = t_max.numpy()[:3000]
    dsk = ix.DiskSoA(sc.dsk_center, sc.dsk_normal, sc.dsk_radius, sc.dsk_inner)
    gt, gi, gp, gn = ix.intersect_disks_dense(torch.as_tensor(o_d), torch.as_tensor(d_d),
                                              torch.as_tensor(t_d), dsk)
    wt, wi, wp, wn = (np.asarray(x) for x in jix.intersect_disks_dense(
        jnp.asarray(o_d), jnp.asarray(d_d), jnp.asarray(t_d),
        jix.DiskSoA(ja.dsk_center, ja.dsk_normal, ja.dsk_radius, ja.dsk_inner)))
    np.testing.assert_array_equal(gi.numpy(), wi)
    hit = wi >= 0
    assert hit.sum() > 500 and (~hit).sum() > 500
    np.testing.assert_allclose(gt.numpy()[hit], wt[hit], rtol=2e-5)
    np.testing.assert_allclose(gp.numpy()[hit], wp[hit], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gn.numpy()[hit], wn[hit], rtol=2e-5, atol=2e-5)


def test_sphere_sweep_modes_and_the_occluded_route(monkeypatch):
    """K4's mode at the waves it runs (wide from 2^19 rays: cornell's,
    testball's and caustic-glass BDPT's 2^20 closest hits and a BDPT wave's
    36,700,160 shadow rays; small: caustic-glass-mlt's 8,192 and 286,720),
    and dispatch.occluded's sphere test through the any-hit entry
    `occluded_spheres_dense`: on CPU tensors its plain version, never the
    CUDA wrapper, the closest-hit sweep not called, and the same bools as the
    closest hit's `idx >= 0` that the dispatch used before (JAX's
    `occluded`)."""
    from pbrt_tpu_torch.accel import dispatch

    for n in (1 << 20, 36700160, 1 << 19):
        assert ix.dense_wide(n)
    for n in (8192, 286720, 9216, (1 << 19) - 1):
        assert not ix.dense_wide(n)
    sc, meta = load_scene(CAUSTIC, device="cpu", spp=1)
    assert sc.sph_center.shape[0] == 2 and sc.tri_p0.shape[0] == 4 and sc.dsk_center.shape[0]
    tris = (sc.tri_p0, sc.tri_p1, sc.tri_p2)
    o, d, t_max = _rays(tris, 3000, 23)
    t_max = torch.where(t_max == ix.INFINITY, 40.0, t_max)
    sph, dsk = dispatch._spheres(sc, meta), dispatch._disks(sc, meta)
    calls = {"any": 0}
    any_plain = ix.occluded_spheres_dense

    def counted(*a, **k):
        calls["any"] += 1
        return any_plain(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a CUDA wrapper reached with CPU tensors")

    monkeypatch.setattr(ix, "occluded_spheres_dense", counted)
    monkeypatch.setattr(ix, "intersect_spheres_dense", refuse)
    monkeypatch.setattr(ix, "dense_spheres_cuda", refuse)
    got = dispatch.occluded(sc, meta, o, d, t_max)
    assert calls["any"] == 1
    sph_hit = ix.intersect_spheres_dense_plain(o, d, t_max, sph)[1] >= 0
    want = (ix.occluded_tris_dense_plain(o, d, t_max, *tris) | sph_hit
            | (ix.intersect_disks_dense_plain(o, d, t_max, dsk)[1] >= 0))
    assert torch.equal(got, want)
    assert torch.equal(any_plain(o, d, t_max, sph), sph_hit)
    assert 100 < int(sph_hit.sum()) < o.shape[0] and int(want.sum()) < o.shape[0]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ix.dense_spheres_cuda(o, d, t_max, sph, any_hit=True)
