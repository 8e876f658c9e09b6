"""Object instancing in pbrt_tpu_torch against the JAX package on the CPU:
the builder's directives (ObjectBegin/ObjectEnd/ObjectInstance,
CoordinateSystem/CoordSysTransform) under each instancing mode, the
two-level BVH build (`build_two_level`, byte-identical tables), the
compiled scene, the plain version of the two-level traversal (K1i) against
JAX's `_traverse(..., n_inst=...)`, the instanced hit record of
`dispatch.intersect`, and instanced renders through the path integrator,
BDPT, MLT and the wavefront loop. The scenes are tests/instancing_cases.py's.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import instancing_cases as ic
from test_torch_render import _check, _jax_render
from test_torch_render_bdpt import _jax_bdpt
from pbrt_tpu.accel import bvh as jbvh, dispatch as jdis
from pbrt_tpu.scene import builder as jbd, lexer as jlx
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch.accel import bvh as tbvh, dispatch as tdis
from pbrt_tpu_torch.film import film as filmlib
from pbrt_tpu_torch.integrators import mlt, render as rd
from pbrt_tpu_torch.parallel import scene_shard
from pbrt_tpu_torch.scene import builder as tbd, lexer as tlx
from pbrt_tpu_torch.scene.compile import compile_arrays, compile_scene

torch.set_num_threads(2)

TEXTS = {name: getattr(ic, name) for name in
         ("INSTANCED", "FLATTENED", "MIRROR", "DEF_MATERIAL", "COORD_SYS", "QUADRICS", "OPEN")}
MODES = ("auto", "flatten", "bvh")


def _builders(text, mode, res=None, filt=None):
    """(JAX builder, port builder) of `text` under instancing `mode`."""
    out = []
    for bd_, lx_ in ((jbd, jlx), (tbd, tlx)):
        b = bd_.SceneBuilder()
        b.instancing = mode          # routing happens at ObjectInstance
        b.parse_tokens(lx_.tokenize(text))
        if res:
            b.film["xresolution"] = b.film["yresolution"] = res
        if filt:
            b.filter = {"type": filt}
        out.append(b)
    return out


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_builder_matches_jax(name, mode):
    """Flattened triangles, their materials, the prototypes' columns, the
    instances and the flattened quadrics equal JAX's."""
    jb, tb = _builders(TEXTS[name], mode)
    assert len(tb.tri_p) == len(jb.tri_p)
    if tb.tri_p:
        assert _same(np.stack(tb.tri_p), np.stack(jb.tri_p))
    assert tb.tri_mat == jb.tri_mat and tb.tri_rev == jb.tri_rev
    assert len(tb.protos) == len(jb.protos) and len(tb.instances) == len(jb.instances)
    for tp, jp in zip(tb.protos, jb.protos):
        for key in ("P", "N", "UV", "has_n", "mat", "rev"):
            assert _same(tp[key], jp[key]), key
    for ti, ji in zip(tb.instances, jb.instances):
        assert ti["proto"] == ji["proto"] and ti["swap"] == ji["swap"]
        assert _same(ti["o2w"], ji["o2w"])
    for mine, theirs in ((tb.spheres, jb.spheres), (tb.disks, jb.disks)):
        assert len(mine) == len(theirs)
        for t, j in zip(mine, theirs):
            for key in t:
                assert np.array_equal(np.asarray(t[key]), np.asarray(j[key])), key
    if name == "INSTANCED":
        assert len(tb.instances) == (3 if mode == "bvh" else 0)


def test_instancing_directives():
    """The definition's material stays with its instances, CoordSysTransform
    restores the saved transform, and an area light inside a definition or
    an undefined name raise, as in the JAX package."""
    _, tb = _builders(ic.DEF_MATERIAL, "auto")
    assert all(tb.materials[m].type == tbd.MAT_DIFFUSE for m in tb.tri_mat[1:])
    _, tb = _builders(ic.COORD_SYS, "auto")
    assert abs(np.stack(tb.tri_p[1:]).reshape(-1, 3)[:, 0].mean()) < 1e-6
    for text, err in ((ic.AREA_LIGHT_IN_DEFINITION, "area lights inside ObjectBegin"),
                      (ic.HEAD + 'ObjectInstance "none"', "not defined"),
                      (ic.HEAD + 'CoordSysTransform "none"', "not defined"),
                      (ic.HEAD + "ObjectEnd", "without ObjectBegin")):
        with pytest.raises(ValueError, match=err):
            tbd.SceneBuilder().parse_tokens(tlx.tokenize(text))


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


def _blob(rng, n, center, size):
    """n random small triangles around `center`."""
    c = center + size * (rng.random((n, 1, 3)) * 2 - 1)
    return c + 0.2 * size * rng.normal(size=(n, 3, 3))


def _two_level_inputs(case):
    """(static (T, 3, 3), protos, inst_proto, inst_o2w (I, 3, 4)) of a
    build_two_level case."""
    rng = np.random.default_rng({"two_protos": 1, "rotated_mirrored": 2, "single_instance": 3,
                                 "one_leaf_and_instances": 4}[case])
    protos = [_blob(rng, 120, np.zeros(3), 1.0), _blob(rng, 37, np.zeros(3), 0.5)]
    if case == "single_instance":
        static, protos, n = np.zeros((0, 3, 3)), protos[:1], 1
    elif case == "one_leaf_and_instances":
        static, n = _blob(rng, 5, np.array([0.0, -3.0, 0.0]), 2.0), 3
    else:
        static, n = _blob(rng, 300, np.zeros(3), 6.0), 9
    o2w = np.zeros((n, 3, 4))
    for i in range(n):
        m = _rotation(rng) if case == "rotated_mirrored" else np.eye(3)
        if case == "rotated_mirrored" and i % 3 == 1:
            m = m @ np.diag([-1.0, 1.0, 1.0])
        o2w[i, :, :3] = m * (0.5 + rng.random())
        o2w[i, :, 3] = rng.normal(size=3) * 4.0
    return static, protos, [i % len(protos) for i in range(n)], o2w


@pytest.mark.parametrize("case", ["two_protos", "rotated_mirrored", "single_instance",
                                  "one_leaf_and_instances"])
def test_two_level_build_matches_jax(case):
    """rows and src byte-identical, the same counts and bounds; the leaf
    ranges the plain traversal sweeps cover every leaf row once, each
    prototype's holding the leaves its tree reaches."""
    args = _two_level_inputs(case)
    j = jbvh.build_two_level(*args)
    t = tbvh.build_two_level(*args)
    assert _same(t.rows, j.rows) and _same(t.src, j.src)
    assert (t.n_int, t.n_inst, t.n_padded, t.max_depth, t.iter_bound) == \
        (j.n_int, j.n_inst, j.n_padded, j.max_depth, j.iter_bound)
    spans = t.leaf_ranges
    assert len(spans) == 1 + len(args[1])
    assert spans[0][0] == t.n_int + t.n_inst and spans[-1][1] == t.rows.shape[0]
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for i, p in enumerate(args[2]):
        lo, hi = spans[1 + p]
        reached, todo = set(), [int(t.rows[t.n_int + i, 12])]
        while todo:
            r = todo.pop()
            if r >= t.n_int + t.n_inst:
                reached.add(r)
            else:
                todo += [int(c) for c in t.rows[r, 6 * tbvh.WIDTH: 7 * tbvh.WIDTH] if c >= 0]
        assert reached == set(range(lo, hi))


COMPILED = {"INSTANCED": (ic.INSTANCED, "bvh"), "MIRROR": (ic.MIRROR, "bvh"),
            "OPEN": (ic.OPEN, "bvh"), "QUADRICS": (ic.QUADRICS, "bvh"),
            "cornell-auto": (ic.instanced_cornell_pbrt(2, 1, res=16, spp=1), "auto"),
            "cornell-bvh": (ic.instanced_cornell_pbrt(2, 1, res=16, spp=1), "bvh")}


@pytest.mark.parametrize("name", sorted(COMPILED))
def test_compile_matches_jax(name):
    """Every compiled array equals JAX's SceneArrays field of the same name
    (bvh_rows, tri_rec, inst_w2o, inst_o2w, inst_swap, the scene bounds and
    the ray epsilon among them), and bvh_ninst/bvh_iterb its markers."""
    jb, tb = _builders(*COMPILED[name])
    js, _ = j_compile(jb)
    arrays, meta = compile_arrays(tb)
    for key, v in arrays.items():
        if key not in ("filt", "tex"):
            assert _same(v, getattr(js, key)), key
    assert (meta.bvh_nint, meta.bvh_depth, meta.bvh_ninst, meta.bvh_iterb) == \
        tuple(getattr(js, k).shape[0] for k in ("bvh_nint", "bvh_depth", "bvh_ninst",
                                                  "bvh_iterb"))
    assert (meta.bvh_ninst > 0) == (name not in ("QUADRICS", "cornell-auto"))


def _rays(scene, R, seed):
    """R rays from random points of the scene's bounding box in random
    directions; every 97th lane masked (t_max = 0)."""
    rng = np.random.default_rng(seed)
    c, r = scene.scene_center.numpy(), float(scene.scene_radius)
    o = (c + 0.7 * r * (rng.random((R, 3)) * 2 - 1)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(R, np.float32(3e38))
    t_max[::97] = 0.0
    return o, d, t_max


def _jax_traverse(js, o, d, t_max, any_hit=False):
    out = jbvh._traverse(js.bvh_rows, js.bvh_nint.shape[0], js.bvh_depth.shape[0],
                         jbvh.LEAF_K, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                         any_hit=any_hit, n_inst=js.bvh_ninst.shape[0],
                         iter_bound=js.bvh_iterb.shape[0])
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("name", ["MIRROR", "cornell-bvh"])
def test_plain_traversal_matches_jax(name):
    """On 4,096 random rays the plain two-level traversal finds JAX's hits:
    the same prim and instance on every hit but verified ties (K1's
    criterion: a differing winner hits at a t within 1e-6 relative of the
    other's); t within 1e-6 of the coordinates' magnitude (XLA contracts
    the watertight test's multiply-adds, so t rounds apart by a few ulps of
    the ray origin); any hit equal on shadow rays of random length up to twice the closest
    hit's."""
    jb, tb = _builders(*COMPILED[name])
    js, _ = j_compile(jb)
    ts, tm = compile_scene(tb, device="cpu")
    o, d, t_max = _rays(ts, 4096, 7)
    tj, pj, ij = _jax_traverse(js, o, d, t_max)
    tt, pt, it = (x.numpy() for x in tbvh.traverse_inst_plain(
        ts.bvh_rows, tm.bvh_nint, tm.bvh_leaves, *map(torch.from_numpy, (o, d, t_max))))
    hit = pj >= 0
    assert np.array_equal(hit, pt >= 0) and hit.sum() > 100 and not hit[::97].any()
    assert (it[hit] >= 0).sum() > 50
    scale = np.abs(tj) + np.abs(o).max(axis=1)
    ok_t = np.abs(tt - tj) <= 1e-6 * scale
    differ = hit & ((pt != pj) | (it != ij))
    assert differ.sum() <= 2
    assert np.all(np.abs(tt - tj)[differ] <= 1e-6 * np.abs(tj)[differ] + 1e-6 * scale[differ])
    assert ok_t[hit & ~differ].all()
    u = np.random.default_rng(8).random(4096)
    t_sh = np.where(hit, 2.0 * u * tj, 5.0).astype(np.float32)
    t_sh[::89] = 0.0
    aj = _jax_traverse(js, o, d, t_sh, any_hit=True)[1] >= 0
    at = tbvh.traverse_inst_plain(ts.bvh_rows, tm.bvh_nint, tm.bvh_leaves, torch.from_numpy(o),
                                  torch.from_numpy(d), torch.from_numpy(t_sh), any_hit=True)[1]
    assert np.array_equal(at.numpy() >= 0, aj) and 0 < aj.sum() < hit.sum()


def test_closest_hit_record_keeps_its_bits_without_a_host_sync():
    """closest_hit_tris on the instanced cornell box at levels (3, 2), every
    instance shared: the record formed with the object rays of every lane
    under a `where` (JAX's _refit_ray; on the card inside the refit kernel)
    equals, bit for bit, the record as it was formed before, with the
    object rays of the instanced lanes only (a .nonzero(), so a host sync
    on the card): t, prim, barycentrics and instance."""
    _, tb = _builders(ic.instanced_cornell_pbrt(3, 2, res=16, spp=1), "bvh")
    ts, tm = compile_scene(tb, device="cpu")
    o, d, t_max = map(torch.from_numpy, _rays(ts, 4096, 13))
    th = tbvh.closest_hit_tris(ts, tm, o, d, t_max)
    _, prim, hin = tbvh._traverse(ts, tm, o, d, t_max, any_hit=False)
    lanes = (hin >= 0).nonzero()[:, 0]
    o_r, d_r = o.clone(), d.clone()
    o_r[lanes], d_r[lanes] = tbvh.object_rays(ts.inst_w2o[hin[lanes]], o[lanes], d[lanes])
    t, prim, b = tbvh.refit_plain(ts.tri_p0, ts.tri_p1, ts.tri_p2, o_r, d_r, t_max, prim)
    assert lanes.numel() > 100 and int((prim >= 0).sum()) > 1000
    for got, want in ((th.t, t), (th.prim, prim), (th.b, b),
                      (th.inst, torch.where(prim >= 0, hin, -1))):
        assert torch.equal(got, want)


def test_two_level_wrapper_raises_on_a_stack_that_does_not_fit():
    """K1i's stack holds 7 entries a level of the two-level depth, at most
    bvh.WIDE_MAX_STACK (302): a deeper table raises before a build or a
    launch, and one that fits raises for CPU tensors; the refit's wrapper
    takes instance ids and affines of their own checked shape."""
    _, tb = _builders(*COMPILED["cornell-bvh"])
    ts, tm = compile_scene(tb, device="cpu")
    o, d, t_max = map(torch.from_numpy, _rays(ts, 64, 3))
    args = (ts.bvh_rows, tm.bvh_nint, tm.bvh_ninst)
    fits = tbvh.WIDE_MAX_STACK // (tbvh.WIDTH - 1)
    assert tm.bvh_depth <= fits
    with pytest.raises(ValueError, match="needs a stack of"):
        tbvh.traverse_inst_cuda(*args, fits + 1, tm.bvh_iterb, o, d, t_max)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tbvh.traverse_inst_cuda(*args, fits, tm.bvh_iterb, o, d, t_max)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tbvh.traverse_cuda(ts.bvh_rows, tm.bvh_nint, fits, o, d, t_max)
    prim = torch.zeros(64, dtype=torch.int64)
    with pytest.raises(ValueError, match="w2o must be"):
        tbvh.refit_cuda(ts.tri_p0, ts.tri_p1, ts.tri_p2, o, d, t_max, prim, prim,
                        ts.inst_w2o[:, :9].contiguous())


@pytest.mark.parametrize("name", ["MIRROR", "cornell-bvh"])
def test_intersect_matches_jax(name):
    """dispatch.intersect's record of instanced hits (mapped from object to
    render space, the mirrored instances' shading normals flipped) against
    JAX's: p within 1e-5 of its magnitude (a coordinate rounds at the scale
    of the point's largest), ng, ns and uv within 1e-5, mat and light
    equal, on every lane whose winner agrees."""
    jb, tb = _builders(*COMPILED[name])
    js, _ = j_compile(jb)
    ts, tm = compile_scene(tb, device="cpu")
    o, d, t_max = _rays(ts, 4096, 11)
    t_max[:] = 3e38
    hj = jdis.intersect(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    ht = tdis.intersect(ts, tm, *map(torch.from_numpy, (o, d, t_max)))
    valid = np.asarray(hj.valid)
    assert np.array_equal(ht.valid.numpy(), valid) and valid.sum() > 100
    th = tbvh.closest_hit_tris(ts, tm, *map(torch.from_numpy, (o, d, t_max)))
    assert (th.inst.numpy() >= 0).sum() > 50
    same = valid & (ht.mat.numpy() == np.asarray(hj.mat))
    assert same.sum() >= valid.sum() - 2
    p_j = np.asarray(hj.p)[same]
    assert (np.abs(ht.p.numpy()[same] - p_j).max(1) <= 1e-5 * np.abs(p_j).max(1)).all()
    for f in ("ng", "ns", "uv"):
        np.testing.assert_allclose(getattr(ht, f).numpy()[same], np.asarray(getattr(hj, f))[same],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert np.array_equal(ht.light.numpy()[same], np.asarray(hj.light)[same])


def test_path_render_matches_jax():
    """The instanced cornell box at levels (2, 1), every instance shared
    ("bvh": 52 instances of 2 prototypes), 24^2 x 4, box filter: the
    image under _check against JAX's live render and the honest ray count
    within 1 % of JAX's, as tests/test_torch_render.py holds cornell-mesh
    (XLA rounds t and the hit point apart by ulps, and at a grazing hit an
    ulp ends or extends a path)."""
    text = ic.instanced_cornell_pbrt(2, 1)
    jb, tb = _builders(text, "bvh", res=24, filt="box")
    want, n_jax = _jax_render(jb, 4)
    scene, meta = compile_scene(tb, spp_override=4, device="cpu")
    assert meta.bvh_ninst == 52
    img, stats = rd.render(scene, meta, device="cpu", return_stats=True)
    _check(img.numpy(), want, "instanced cornell")
    n_port = stats["closest"] + stats["shadow"]
    assert abs(n_port - n_jax) <= 0.01 * n_jax, (n_port, n_jax)


@pytest.mark.parametrize("case", ["instanced-auto", "instanced-bvh", "mirror", "cornell"])
def test_instanced_render_matches_flattened(case):
    """The port's two-level render against its render of the same geometry
    flattened: the same ray count and the image within JAX's own bound of
    tests/test_instancing.py (1e-4) on the card scenes; the cornell box at
    levels (2, 1), 20^2 x 2, under _check."""
    text, flat, spp = {"instanced-auto": (ic.INSTANCED, ic.FLATTENED, 2),
                       "instanced-bvh": (ic.INSTANCED, ic.FLATTENED, 2),
                       "mirror": (ic.MIRROR, ic.MIRROR, 4),
                       "cornell": (ic.instanced_cornell_pbrt(2, 1), None, 2)}[case]
    mode = "auto" if case == "instanced-auto" else "bvh"
    res = 20 if case == "cornell" else None
    _, tb = _builders(text, mode, res=res, filt="box")
    _, tf = _builders(flat or text, "flatten", res=res, filt="box")
    (si, mi), (sf, mf) = (compile_scene(b, spp_override=spp, device="cpu") for b in (tb, tf))
    assert (mi.bvh_ninst > 0) == (mode == "bvh") and mf.bvh_ninst == 0
    img_i, st_i = rd.render(si, mi, device="cpu", return_stats=True)
    img_f, st_f = rd.render(sf, mf, device="cpu", return_stats=True)
    assert st_i == st_f and float(img_i.mean()) > 0
    if case == "cornell":
        _check(img_i.numpy(), img_f.numpy(), case)
    else:
        np.testing.assert_allclose(img_i.numpy(), img_f.numpy(), rtol=1e-4, atol=1e-4)


def test_bdpt_render_matches_jax():
    """BDPT on the instanced cornell box at levels (1, 1), max depth 2,
    12^2 x 2: the image under _check against JAX's live BDPT estimate and
    its exact honest ray count."""
    text = ic.instanced_cornell_pbrt(1, 1).replace('"integer maxdepth" [5]',
                                                   '"integer maxdepth" [2]')
    jb, tb = _builders(text, "bvh", res=12, filt="box")
    want, n_jax = _jax_bdpt(jb, 2)
    scene, meta = compile_scene(tb, spp_override=2, device="cpu", integrator_override="bdpt")
    assert meta.bvh_ninst == 52 and meta.max_depth == 2
    img, stats = rd.render(scene, meta, device="cpu", return_stats=True)
    _check(img.numpy(), want, "instanced cornell bdpt")
    assert stats["closest"] + stats["shadow"] == int(n_jax)


def test_wavefront_ray_count_equals_batched(monkeypatch):
    """The open instanced scene (uniform infinite and distant light) takes
    the wavefront loop, here through a pool of 128 lanes; its ray count and
    image equal the batched loop's."""
    _, tb = _builders(ic.OPEN, "bvh", filt="box")
    scene, meta = compile_scene(tb, device="cpu")
    assert meta.open_scene and meta.bvh_ninst == 4
    monkeypatch.setattr(rd, "POOL_LANES", 128)
    img, stats = rd.render(scene, meta, device="cpu", return_stats=True)
    film = filmlib.new_film(meta.resolution, "cpu")
    st_b = {k: int(v) for k, v in rd.render_batched(scene, meta, film).items()}
    assert stats == st_b and stats["closest"] > 0
    img_b = filmlib.develop(film, meta.resolution, out_matrix=meta.film_out_matrix,
                            imaging_ratio=meta.film_imaging_ratio)
    torch.testing.assert_close(img, img_b, rtol=1e-5, atol=1e-6)


def test_mlt_render_matches_flattened():
    """mltpath over the instanced cards (256 chains, 16 passes) against the
    same render of the flattened cards: the chains draw the same PCG32
    streams and see the same geometry, so the images agree but for the
    rounding of the object-space rays."""
    out = []
    for text, mode in ((ic.INSTANCED, "bvh"), (ic.FLATTENED, "flatten")):
        _, tb = _builders(text, mode, filt="box")
        scene, meta = compile_scene(tb, device="cpu", integrator_override="mltpath")
        assert (meta.bvh_ninst > 0) == (mode == "bvh")
        meta.mutations_per_pixel = 16
        out.append(mlt.render_mlt(scene, meta, n_chains=256, n_bootstrap=4096, device="cpu"))
    (img_i, st_i), (img_f, st_f) = out
    assert torch.isfinite(img_i).all() and float(img_i.mean()) > 0
    assert st_i["mutations"] == st_f["mutations"] == 256 * 16
    torch.testing.assert_close(img_i, img_f, rtol=1e-3, atol=1e-4)


def test_scene_sharding_refuses_instanced_scenes():
    _, tb = _builders(ic.INSTANCED, "bvh")
    scene, _ = compile_scene(tb, device="cpu")
    with pytest.raises(ValueError, match="non-instanced"):
        scene_shard.build_scene_shard(scene, 2)
