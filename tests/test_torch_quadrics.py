"""K3 and K4 plain versions against pbrt_tpu's dense intersectors on the
same numpy-seeded rays: triangles of the cornell box (closest hit and any
hit), and synthetic full and partial spheres and disks with masked lanes
(t_max = 0 and short t_max). The contract is JAX's: (t, idx, p, n), idx -1
on a miss, the lowest index winning ties.

Tolerances: winners and hit/miss must agree exactly, except on lanes within
1e-5 of a clip edge (phi or z), where the two packages' atan2 and summation
orders may round a candidate across the edge; t, p, n and barycentrics to
2e-5 relative (XLA may sum a 3-vector dot product in another order, or fuse
a multiply-add)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pbrt_tpu.geometry import intersect as jix
from pbrt_tpu.scene import testscenes as jts
from pbrt_tpu_torch.geometry import intersect as ix
from pbrt_tpu_torch.scene import testscenes as tts
from quadric_edges import clip_edge_distance

torch.set_num_threads(2)
N_RAYS = 6000


def _rays(seed, n=N_RAYS, lo=-1.0, hi=1.0):
    g = np.random.default_rng(seed)
    o = lo + (hi - lo) * g.uniform(0.05, 0.95, (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 3.4028234663852886e38)
    t_max[::13] = 0.0
    t_max[5::13] = g.uniform(0.0, 0.5 * (hi - lo), len(t_max[5::13]))
    return [np.asarray(x, np.float32) for x in (o, d, t_max)]


def _quadrics(seed, n, partial):
    """n spheres and n disks in [-1, 1]^3, clipped when `partial` (z window,
    phimax < 2 pi, inner radius) -> numpy columns."""
    g = np.random.default_rng(seed)
    rot = np.linalg.qr(g.normal(size=(n, 3, 3)))[0].astype(np.float32)
    rad = g.uniform(0.1, 0.4, n).astype(np.float32)
    sph = dict(center=g.uniform(-0.8, 0.8, (n, 3)), radius=rad)
    if partial:
        sph.update(rot=rot, zmin=-rad * g.uniform(0.2, 1.0, n),
                   zmax=rad * g.uniform(0.2, 1.0, n), phimax=g.uniform(1.0, 2 * np.pi, n))
    nrm = rot[:, 2]
    dsk = dict(center=g.uniform(-0.8, 0.8, (n, 3)), normal=nrm, radius=rad,
               inner=rad * g.uniform(0.0, 0.5, n) if partial else np.zeros(n))
    if partial:
        dsk.update(xaxis=rot[:, 0], yaxis=np.cross(nrm, rot[:, 0]),
                   phimax=g.uniform(1.0, 2 * np.pi, n))
    f32 = lambda v: {k: np.asarray(x, np.float32) for k, x in v.items()}
    return f32(sph), f32(dsk)


def _t(a):
    return torch.as_tensor(a)


@pytest.fixture(scope="module")
def cornell_tris():
    scene, _ = tts.cornell(res=8, spp=1, device="cpu")
    assert scene.bvh_rows.shape[0] == 0 and scene.tri_p0.shape[0] == 12
    return [x.numpy() for x in (scene.tri_p0, scene.tri_p1, scene.tri_p2)]


def test_dense_tris_closest_matches_jax(cornell_tris):
    lo = np.min([p.min(0) for p in cornell_tris], 0)
    hi = np.max([p.max(0) for p in cornell_tris], 0)
    o, d, t_max = _rays(1)
    o = (lo + (hi - lo) * (0.5 + 0.5 * o)).astype(np.float32)
    t_max[5::13] *= 500.0
    got = ix.intersect_tris_dense(_t(o), _t(d), _t(t_max), *map(_t, cornell_tris))
    want = jix.intersect_tris_dense(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                    jix.TriangleSoA(*map(jnp.asarray, cornell_tris)))
    prim = np.asarray(want.prim)
    np.testing.assert_array_equal(got.prim.numpy(), prim)
    hit = prim >= 0
    assert hit.sum() > N_RAYS // 2 and (~hit).sum() > N_RAYS // 20
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=2e-5)
    np.testing.assert_allclose(got.b.numpy()[hit], np.asarray(want.b)[hit], rtol=2e-5,
                               atol=2e-5)
    assert (got.t.numpy()[~hit] == ix.INFINITY).all()


def test_dense_tris_any_hit_matches_jax(cornell_tris):
    lo = np.min([p.min(0) for p in cornell_tris], 0)
    hi = np.max([p.max(0) for p in cornell_tris], 0)
    o, d, t_max = _rays(2)
    o = (lo + (hi - lo) * (0.5 + 0.5 * o)).astype(np.float32)
    finite = t_max < 1e30
    t_max[finite] *= 500.0
    t_max[~finite] = 300.0
    got = ix.occluded_tris_dense(_t(o), _t(d), _t(t_max), *map(_t, cornell_tris))
    want = np.asarray(jix.occluded_tris_dense(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        jix.TriangleSoA(*map(jnp.asarray, cornell_tris))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < N_RAYS


@pytest.mark.parametrize("kind", ["spheres", "disks"])
@pytest.mark.parametrize("partial", [False, True], ids=["full", "partial"])
def test_dense_quadrics_match_jax(kind, partial):
    sph, dsk = _quadrics(3, 16, partial)
    o, d, t_max = _rays(4)
    cols = sph if kind == "spheres" else dsk
    if kind == "spheres":
        got = ix.intersect_spheres_dense(_t(o), _t(d), _t(t_max),
                                         ix.SphereSoA(**{k: _t(v) for k, v in cols.items()}))
        want = jix.intersect_spheres_dense(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            jix.SphereSoA(**{k: jnp.asarray(v) for k, v in cols.items()}))
    else:
        got = ix.intersect_disks_dense(_t(o), _t(d), _t(t_max),
                                       ix.DiskSoA(**{k: _t(v) for k, v in cols.items()}))
        want = jix.intersect_disks_dense(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            jix.DiskSoA(**{k: jnp.asarray(v) for k, v in cols.items()}))
    t, idx, p, n = (x.numpy() for x in got)
    wt, widx, wp, wn = (np.asarray(x) for x in want)
    differ = idx != widx
    if differ.any():
        margin = clip_edge_distance(
            _t(o[differ]), _t(d[differ]),
            ix.SphereSoA(**{k: _t(v) for k, v in sph.items()}) if kind == "spheres" else None,
            ix.DiskSoA(**{k: _t(v) for k, v in dsk.items()}) if kind == "disks" else None)
        assert (margin.numpy() < 1e-5).all(), margin
    assert differ.sum() <= 3
    same = ~differ & (widx >= 0)
    assert same.sum() > 500 and (widx < 0).sum() > 500
    assert (idx[t_max == 0.0] == -1).all()
    np.testing.assert_allclose(t[same], wt[same], rtol=2e-5)
    np.testing.assert_allclose(p[same], wp[same], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(n[same], wn[same], rtol=2e-5, atol=2e-5)
    assert (t[idx < 0] == ix.INFINITY).all()


def test_quadric_tables_match_jax_on_caustic_glass():
    """The dense sweeps over caustic-glass's compiled sphere and disk tables
    (render space) agree with JAX's on camera-like rays."""
    from pbrt_tpu.scene.compile import load_scene as j_load
    from pbrt_tpu_torch.scene.compile import load_scene

    path = "scenes/caustic-glass.pbrt"
    ja, _ = j_load(path, spp=1, integrator="path")
    scene, _ = load_scene(path, device="cpu", spp=1, integrator="path")
    np.testing.assert_array_equal(scene.sph_center.numpy(), np.asarray(ja.sph_center))
    np.testing.assert_array_equal(scene.dsk_normal.numpy(), np.asarray(ja.dsk_normal))
    # rays from around the camera towards points near each quadric
    g = np.random.default_rng(5)
    centers = np.concatenate([scene.sph_center.numpy(), scene.dsk_center.numpy()])
    radii = np.concatenate([scene.sph_radius.numpy(), scene.dsk_radius.numpy()])
    k = g.integers(0, len(centers), N_RAYS)
    jitter = g.normal(size=(N_RAYS, 3))
    target = centers[k] + 1.3 * radii[k, None] * jitter / np.linalg.norm(jitter, axis=1,
                                                                         keepdims=True)
    o = g.uniform(-0.3, 0.3, (N_RAYS, 3)).astype(np.float32)
    d = (target - o) / np.linalg.norm(target - o, axis=1, keepdims=True)
    o, d, t_max = o, d.astype(np.float32), _rays(5)[2]
    for got, want in (
            (ix.intersect_spheres_dense(_t(o), _t(d), _t(t_max),
                                        ix.SphereSoA(scene.sph_center, scene.sph_radius)),
             jix.intersect_spheres_dense(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                         jix.SphereSoA(ja.sph_center, ja.sph_radius))),
            (ix.intersect_disks_dense(_t(o), _t(d), _t(t_max),
                                      ix.DiskSoA(scene.dsk_center, scene.dsk_normal,
                                                 scene.dsk_radius, scene.dsk_inner)),
             jix.intersect_disks_dense(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                       jix.DiskSoA(ja.dsk_center, ja.dsk_normal,
                                                   ja.dsk_radius, ja.dsk_inner)))):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        hit = np.asarray(want[1]) >= 0
        assert hit.sum() > 100
        np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(want[0])[hit], rtol=2e-5)


def test_scene_kernel_tables_pack_the_columns():
    """Scene.sph_table / dsk_table: the dense kernels' rows, packed once per
    scene from the JAX-named columns in the order csrc/dense_intersect.cu
    reads them; with_table packs a bare SoA the same way."""
    from pbrt_tpu_torch.scene.compile import load_scene

    scene, _ = load_scene("scenes/caustic-glass.pbrt", device="cpu", spp=1, integrator="path")
    st, dt = scene.sph_table, scene.dsk_table
    assert scene.sph_table is st and scene.dsk_table is dt
    S, D = scene.sph_center.shape[0], scene.dsk_center.shape[0]
    assert st.shape == (S, ix.SPH_W) and dt.shape == (D, ix.DSK_W) and S > 0 and D > 0
    assert st.dtype == dt.dtype == torch.float32 and st.is_contiguous() and dt.is_contiguous()
    for got, col in ((st[:, 0:3], scene.sph_center), (st[:, 3], scene.sph_radius),
                     (st[:, 4:13], scene.sph_rot.reshape(S, 9)), (st[:, 13], scene.sph_zmin),
                     (st[:, 14], scene.sph_zmax), (st[:, 15], scene.sph_phimax),
                     (dt[:, 0:3], scene.dsk_center), (dt[:, 3:6], scene.dsk_normal),
                     (dt[:, 6], scene.dsk_radius), (dt[:, 7], scene.dsk_inner),
                     (dt[:, 8:11], scene.dsk_xaxis), (dt[:, 11:14], scene.dsk_yaxis),
                     (dt[:, 14], scene.dsk_phimax)):
        assert torch.equal(got, col)
    part = ix.with_table(ix.SphereSoA(scene.sph_center, scene.sph_radius, scene.sph_rot,
                                      scene.sph_zmin, scene.sph_zmax, scene.sph_phimax))
    assert torch.equal(part.table, st)
    full = ix.with_table(ix.DiskSoA(scene.dsk_center, scene.dsk_normal, scene.dsk_radius,
                                    scene.dsk_inner))
    assert full.table.shape == (D, ix.DSK_W) and torch.equal(full.table[:, :8], dt[:, :8])


@pytest.mark.parametrize("kind", ["spheres", "disks"])
def test_quadric_kernel_wrapper_checks_its_table(kind):
    """The K4 wrappers launch only over a packed table and CUDA rays; both
    checks raise before any build."""
    sph, dsk = _quadrics(3, 4, True)
    soa = (ix.SphereSoA(**{k: _t(v) for k, v in sph.items()}) if kind == "spheres"
           else ix.DiskSoA(**{k: _t(v) for k, v in dsk.items()}))
    fn = ix.dense_spheres_cuda if kind == "spheres" else ix.dense_disks_cuda
    o, d, t_max = map(_t, _rays(6, n=8))
    with pytest.raises(ValueError, match="no packed table"):
        fn(o, d, t_max, soa)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fn(o, d, t_max, ix.with_table(soa))
    with pytest.raises(ValueError, match="table must be"):
        fn(o, d, t_max, soa._replace(table=ix.with_table(soa).table[:, :-1]))


def _aimed_rays(centers, radii, seed, n=N_RAYS):
    """n rays from around the origin towards points within 1.3 radii of the
    spheres' centers, with _rays' masked and short lanes."""
    g = np.random.default_rng(seed)
    k = g.integers(0, len(centers), n)
    jitter = g.normal(size=(n, 3))
    target = centers[k] + 1.3 * radii[k, None] * jitter / np.linalg.norm(jitter, axis=1,
                                                                         keepdims=True)
    o = g.uniform(-0.3, 0.3, (n, 3))
    d = (target - o) / np.linalg.norm(target - o, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), _rays(seed + 1, n)[2]


def _scene_spheres(path):
    """(port SphereSoA, JAX SphereSoA) of a scene file's compiled spheres,
    each package's dispatch choosing the clip fields."""
    from pbrt_tpu.accel import dispatch as jdispatch
    from pbrt_tpu.scene.compile import load_scene as j_load
    from pbrt_tpu_torch.accel import dispatch
    from pbrt_tpu_torch.scene.compile import load_scene

    ja, _ = j_load(path, spp=1)
    scene, meta = load_scene(path, device="cpu", spp=1)
    return dispatch._spheres(scene, meta), jdispatch._spheres(ja)


@pytest.mark.parametrize("case", ["caustic-glass", "material-testball", "soup full",
                                  "soup partial"])
def test_occluded_spheres_match_jax(case):
    """K4's any-hit entry, plain version: `occluded_spheres_dense_plain`
    (what the card's ANY_HIT sweep answers) against JAX's
    `intersect_spheres_dense(...)[1] >= 0` (pbrt_tpu/accel/dispatch.py:
    321-322), bool for bool, on caustic-glass's full spheres, the testball's
    partial pedestal sphere (z window) and the full and partial soup, with
    masked and short lanes; and the same bools as the port's closest-hit
    plain version's `idx >= 0`."""
    if case.startswith("soup"):
        sph, _ = _quadrics(3, 16, case == "soup partial")
        soa = ix.SphereSoA(**{k: _t(v) for k, v in sph.items()})
        jsoa = jix.SphereSoA(**{k: jnp.asarray(v) for k, v in sph.items()})
        o, d, t_max = _rays(8)
    else:
        soa, jsoa = _scene_spheres(f"scenes/{case}.pbrt")
        assert (soa.rot is not None) == (case == "material-testball")
        o, d, t_max = _aimed_rays(soa.center.numpy(), soa.radius.numpy(), 9)
    got = ix.occluded_spheres_dense(_t(o), _t(d), _t(t_max), soa)
    assert got.dtype == torch.bool
    want = np.asarray(jix.intersect_spheres_dense(jnp.asarray(o), jnp.asarray(d),
                                                  jnp.asarray(t_max), jsoa)[1]) >= 0
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > N_RAYS // 10 and (~want).sum() > N_RAYS // 10
    assert not got.numpy()[t_max == 0.0].any()
    assert torch.equal(got, ix.intersect_spheres_dense_plain(_t(o), _t(d), _t(t_max), soa)[1]
                       >= 0)
