"""The port's kernels against their plain versions on an NVIDIA GPU. These
tests need the card and skip without one; they import neither jax nor
pbrt_tpu, so they run where only PyTorch is installed:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.accel import bvh
from pbrt_tpu_torch.film import film as filmlib, film_kernel
from pbrt_tpu_torch.geometry import intersect as ix
from pbrt_tpu_torch.integrators import render as rd
from pbrt_tpu_torch.integrators.render import render
from pbrt_tpu_torch.sampling import samplers
from pbrt_tpu_torch.scene import testscenes as ts
from pbrt_tpu_torch.utils.math import INFINITY
from quadric_edges import clip_edge_distance

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rays(scene, n, seed):
    g = torch.Generator().manual_seed(seed)
    pts = torch.cat([scene.tri_p0, scene.tri_p1]).cpu()
    lo, hi = pts.min(0).values, pts.max(0).values
    o = lo + (hi - lo) * (0.05 + 0.9 * torch.rand((n, 3), generator=g))
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.full((n,), INFINITY)
    t_max[::11] = 0.0
    return o, d, t_max


def _check_k1(rows, n_int, depth, o, d, t_max, any_hit):
    """K1 (csrc/bvh_wide.cuh) against its plain version: hit masks equal,
    a differing closest-hit winner a verified tie (both triangles hit at t
    within 1e-6), t equal on the same winner; the overflow counter
    unchanged. -> (K1's t, prim)."""
    ov0 = int(bvh.overflow_counter(o.device).item())
    tk, pk = bvh.traverse_cuda(rows, n_int, depth, o, d, t_max, any_hit)
    tp, pp = bvh.traverse_plain(rows, n_int, o, d, t_max, any_hit)
    assert torch.equal(pk >= 0, pp >= 0)
    assert torch.equal(tk[pp < 0], t_max[pp < 0])
    assert int(bvh.overflow_counter(o.device).item()) == ov0
    if not any_hit:
        soup = rows[n_int:, : bvh.LEAF_K * 9].reshape(-1, 9)
        differ = (pk != pp) & (pp >= 0)
        ts = []
        for p in (pk, pp):          # differing winners must be verified ties
            pc = soup[p[differ]]
            t, _, h = ix.intersect_tri_lanes(o[differ], d[differ], t_max[differ], pc[:, :3],
                                             pc[:, 3:6], pc[:, 6:])
            assert bool(h.all())
            ts.append(t)
        assert torch.allclose(ts[0], ts[1], rtol=1e-6, atol=0.0)
        same = (pk == pp) & (pp >= 0)
        assert torch.equal(tk[same], tp[same])
    return tk, pk


def _k1_case(case, cuda):
    """(rows, n_int, depth, o, d, t_max) of a K1 test case on the card."""
    if case == "deep":
        # 20,000 coincident triangles: no centroid extent, so median splits
        # all the way down (wide depth 10), and every ray that hits one hits
        # all of them at one t
        T = 20000
        p0 = np.zeros((T, 3), np.float32)
        p1 = np.tile(np.float32([1, 0, 0]), (T, 1))
        p2 = np.tile(np.float32([0, 1, 0]), (T, 1))
        b = bvh.build_bvh(p0, p1, p2)
        assert b.max_depth >= 10
        g = np.random.default_rng(4)
        o = np.concatenate([g.uniform(0, 0.5, (4096, 2)), g.uniform(0.5, 2, (4096, 1))], 1)
        d = g.normal(0, 0.2, (4096, 3)) - np.float32([0, 0, 1])
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        rows, n_int, depth = torch.from_numpy(b.rows).to(cuda), b.n_int, b.max_depth
        o, d = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (o, d))
        return rows, n_int, depth, o, d, torch.full((4096,), INFINITY, device=cuda)
    scene, meta = ts.cornell_mesh(res=32, spp=1, levels=4, device=cuda)
    rows, n_int, depth = scene.bvh_rows, meta.bvh_nint, meta.bvh_depth
    n = {"R1": 1, "R33": 33, "R1000": 1000, "large": (1 << 20) + 17}.get(case, 8192)
    if case == "legacy":            # the draw the test made before its cases
        o, d, t_max = (x.to(cuda) for x in _rays(scene, n, 5))
    else:                           # lane 0 (masked by _rays) dropped: R = 1 is live
        o, d, t_max = (x[1:].to(cuda) for x in _rays(scene, n + 1, 5))
    if case == "mixed":             # t_max = 0 on a third of the lanes of every warp
        t_max[::3] = 0.0
    elif case == "axis":            # a zero direction component (safe_inv's 1e30)
        d[: n // 3, 1:] = 0.0
        d[n // 3: 2 * n // 3, :2] = 0.0
        d[2 * n // 3:, ::2] = 0.0
        d = d / d.norm(dim=-1, keepdim=True)
    elif case == "box-face":        # origins on faces of the root's child boxes
        box = rows[0, : 6 * bvh.WIDTH].reshape(bvh.WIDTH, 6)
        box = box[rows[0, 6 * bvh.WIDTH: 7 * bvh.WIDTH] >= 0]
        g = torch.Generator().manual_seed(6)
        k = torch.randint(0, box.shape[0], (n,), generator=g).to(cuda)
        lo, hi = box[k, :3], box[k, 3:]
        o = lo + (hi - lo) * torch.rand((n, 3), generator=g).to(cuda)
        axis = torch.randint(0, 3, (n,), generator=g).to(cuda)
        face = torch.where(torch.rand((n, 1), generator=g).to(cuda) < 0.5, lo, hi)
        o = torch.where(torch.arange(3, device=cuda)[None] == axis[:, None], face, o)
    return rows, n_int, depth, o.contiguous(), d.contiguous(), t_max.contiguous()


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["legacy", "random", "mixed", "axis", "box-face", "R1", "R33",
                                  "R1000", "large", "deep"])
def test_bvh_kernel_matches_plain(cuda, case, any_hit):
    """K1/K1a against the plain sweep: random interior rays of cornell-mesh
    levels 4 with every 11th lane masked (legacy: the 8192 rays the test
    drew before it had cases; random: a draw of 8193 less its first lane);
    t_max = 0 on every third lane; rays along axes; origins on box faces; 1,
    33 and 1000 rays; 2^20 + 17 rays, more than the persistent grid holds at
    once; a tree of depth 10 over coincident triangles."""
    rows, n_int, depth, o, d, t_max = _k1_case(case, cuda)
    if any_hit:
        t_max = torch.where(t_max > 0, torch.rand(o.shape[0], device=cuda) * 400.0, 0.0)
    n0 = bvh.launches["bvh_any_hit" if any_hit else "bvh_closest_hit"]
    _, pk = _check_k1(rows, n_int, depth, o, d, t_max, any_hit)
    assert bvh.launches["bvh_any_hit" if any_hit else "bvh_closest_hit"] == n0 + 1
    assert int((pk >= 0).sum()) >= o.shape[0] // 20


def test_bvh_kernel_graph_replays(cuda):
    """K1 captured in a CUDA graph and replayed three times: the results
    equal the eager launch's every time (each launch zeroes a ray ticket of
    its own, in the graph too); then a replay on one stream beside an eager
    launch on another, both equal to it."""
    rows, n_int, depth, o, d, t_max = _k1_case("mixed", cuda)
    t_e, p_e = bvh.traverse_cuda(rows, n_int, depth, o, d, t_max)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bvh.traverse_cuda(rows, n_int, depth, o, d, t_max)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        t_g, p_g = bvh.traverse_cuda(rows, n_int, depth, o, d, t_max)
    for _ in range(3):
        t_g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(t_g, t_e) and torch.equal(p_g, p_e)
    t_g.zero_()
    side.wait_stream(torch.cuda.current_stream())
    graph.replay()
    with torch.cuda.stream(side):
        t_s, p_s = bvh.traverse_cuda(rows, n_int, depth, o, d, t_max)
    torch.cuda.synchronize()
    assert torch.equal(t_g, t_e) and torch.equal(p_g, p_e)
    assert torch.equal(t_s, t_e) and torch.equal(p_s, p_e)


def test_bvh_kernel_small_stack_counts_overflow(cuda):
    """A stack too small for the tree: the coincident-triangle tree of depth
    10 traversed with the stack of a depth of 1 (7 entries; every child box
    of every row meets a ray that hits, so a second row's visit already
    overflows it): the lanes that run out are counted in the overflow
    counter and the launch does not fault."""
    rows, n_int, depth, o, d, t_max = _k1_case("deep", cuda)
    assert depth >= 10
    ov0 = int(bvh.overflow_counter(o.device).item())
    tk, pk = bvh.traverse_cuda(rows, n_int, 1, o, d, t_max)
    torch.cuda.synchronize()
    n_ov = int(bvh.overflow_counter(o.device).item()) - ov0
    assert 0 < n_ov < o.shape[0]
    assert bool(torch.isfinite(tk).all()) and bool((pk >= -1).all())


def _instanced_cornell(levels, res, spp, device, mode="bvh"):
    from pbrt_tpu_torch.scene.compile import compile_scene

    return compile_scene(ts.instanced_cornell_builder(levels, res, spp, mode, "box"),
                         device=device)


def _inst_differ_ok(scene, o, d, t_max, got, want, stopped=0):
    """K1i's (t, prim, inst) against the plain version's on closest hits: t
    equal on the same winner, and a differing winner a verified tie (a real
    hit, both t within 1e-6 of each other); at most `stopped` lanes (those
    that stopped early on a stack overflow) may instead hold a real hit
    farther than the plain version's, or none. -> lanes that differ."""
    (tk, pk, ik), (tp, pp, ip) = got, want
    same = (pk == pp) & (ik == ip)
    assert torch.equal(tk[same], tp[same])
    differ = ~same
    n = int(differ.sum())
    if n:
        hit = differ & (pk >= 0)
        tr, pr, _ = bvh.refit_plain(scene.tri_p0, scene.tri_p1, scene.tri_p2, o[hit], d[hit],
                                    t_max[hit], pk[hit], ik[hit], scene.inst_w2o)
        assert torch.equal(pr, pk[hit]) and torch.equal(tr, tk[hit])
        assert not bool((hit & (pp < 0)).any())
        both = hit & (pp >= 0)
        rel = (tk[both] - tp[both]).abs() / tp[both].abs()
        off = rel > 1e-6
        assert not bool((off & (tk[both] < tp[both])).any())
        assert int(off.sum()) <= stopped and int(((pk < 0) & (pp >= 0)).sum()) <= stopped
    return n


@pytest.mark.parametrize("levels", [(3, 2), (2, 1)])
@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_inst_kernel_matches_plain(cuda, any_hit, levels):
    """K1i (csrc/bvh_wide.cuh inst_wide_kernel) on the instanced cornell box
    at levels (3, 2) and (2, 1), every instance shared: prim and inst
    bit-exact with the plain version but for verified ties (equal t), t
    bit-exact on the same winner; any hit equal; the same bits again from a
    CUDA graph replayed twice (the ray ticket a memset node). With a stack of
    7 entries (one level) lanes overflow: counted, and never a wrong answer
    (a closest hit that stopped early is a real hit, no nearer; an any hit
    never a false one)."""
    scene, meta = _instanced_cornell(levels, 16, 1, cuda)
    assert meta.bvh_ninst == 52
    o, d, t_max = (x.to(cuda) for x in _rays(scene, 8192, 5))
    if any_hit:
        t_max = torch.where(t_max > 0, torch.rand(8192, device=cuda) * 400.0, 0.0)
    args = (scene.bvh_rows, meta.bvh_nint, meta.bvh_ninst)
    name = "bvh_any_hit_inst" if any_hit else "bvh_closest_hit_inst"
    ov0 = int(bvh.overflow_counter(cuda).item())
    n0 = bvh.launches[name]
    got = bvh.traverse_inst_cuda(*args, meta.bvh_depth, meta.bvh_iterb, o, d, t_max, any_hit)
    want = bvh.traverse_inst_plain(scene.bvh_rows, meta.bvh_nint, meta.bvh_leaves, o, d,
                                   t_max, any_hit)
    assert bvh.launches[name] == n0 + 1
    assert torch.equal(got[1] >= 0, want[1] >= 0) and int((want[1] >= 0).sum()) > 500
    assert int(bvh.overflow_counter(cuda).item()) == ov0
    if not any_hit:
        _inst_differ_ok(scene, o, d, t_max, got, want)
        assert int((want[2] >= 0).sum()) > 100
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got_g = bvh.traverse_inst_cuda(*args, meta.bvh_depth, meta.bvh_iterb, o, d, t_max,
                                       any_hit)
    for _ in range(2):
        for x in got_g:
            x.fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got_g, got))
    small = bvh.traverse_inst_cuda(*args, 1, meta.bvh_iterb, o, d, t_max, any_hit)
    stopped = int(bvh.overflow_counter(cuda).item()) - ov0
    assert stopped > 0
    if any_hit:
        assert not bool(((small[1] >= 0) & (want[1] < 0)).any())
        assert int(((small[1] < 0) & (want[1] >= 0)).sum()) <= stopped
    else:
        _inst_differ_ok(scene, o, d, t_max, small, want, stopped)
    bvh.overflow_counter(cuda).fill_(ov0)


def test_instanced_hit_record_makes_no_host_sync(cuda):
    """closest_hit_tris and any_hit_tris on the instanced cornell box at
    levels (3, 2) run under torch.cuda.set_sync_debug_mode("error") (the
    object rays of the refit are formed in the refit kernel, with no
    .nonzero()), and the record equals the CPU's plain one bit for bit on
    lanes whose winner agrees."""
    scene, meta = _instanced_cornell((3, 2), 16, 1, cuda)
    o, d, t_max = (x.to(cuda) for x in _rays(scene, 8192, 7))
    bvh.traverse_inst_cuda(scene.bvh_rows, meta.bvh_nint, meta.bvh_ninst, meta.bvh_depth,
                           meta.bvh_iterb, o, d, t_max)     # the build, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        th = bvh.closest_hit_tris(scene, meta, o, d, t_max)
        occ = bvh.any_hit_tris(scene, meta, o, d, t_max * 0.5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sc_cpu, mt_cpu = _instanced_cornell((3, 2), 16, 1, "cpu")
    ref = bvh.closest_hit_tris(sc_cpu, mt_cpu, o.cpu(), d.cpu(), t_max.cpu())
    same = (th.prim.cpu() == ref.prim) & (th.inst.cpu() == ref.inst)
    assert int((~same).sum()) <= 2 and int((ref.inst >= 0).sum()) > 100
    assert torch.equal(th.t.cpu()[same], ref.t[same]) and torch.equal(th.b.cpu()[same],
                                                                      ref.b[same])
    occ_ref = bvh.any_hit_tris(sc_cpu, mt_cpu, o.cpu(), d.cpu(), t_max.cpu() * 0.5)
    assert torch.equal(occ.cpu(), occ_ref)


def test_instanced_render_on_card_matches_cpu(cuda):
    """The instanced cornell box at levels (2, 1), 24^2 x 2: K1i (and the
    refit of its winners) launched and K1 not; the card's image against the
    CPU's."""
    scene, meta = _instanced_cornell((2, 1), 24, 2, cuda)
    counts0 = dict(bvh.launches)
    img_gpu, st_gpu = render(scene, meta, return_stats=True)
    img_cpu, st_cpu = render(scene, meta, device="cpu", return_stats=True)
    grew = {k for k in counts0 if bvh.launches[k] > counts0[k]}
    assert grew == {"bvh_closest_hit_inst", "bvh_any_hit_inst", "bvh_refit"}
    assert st_gpu == st_cpu
    img_gpu, img_cpu = img_gpu.cpu().numpy(), img_cpu.numpy()
    err = np.abs(img_gpu - img_cpu)
    assert float((err > 5e-3 + 0.05 * np.abs(img_cpu)).mean()) < 0.005
    assert abs(img_gpu.mean() - img_cpu.mean()) < 0.01 * img_cpu.mean()


def _film_lanes(n, seed, cuda, n_pix=64):
    """n film lanes with NaN lanes, zero pdfs, zero radiance (also over a
    NaN pdf), signed and zero weights, and wavelengths on the CIE table's
    bin edges, on the card."""
    g = torch.Generator().manual_seed(seed)
    pix = torch.randint(0, n_pix, (n,), generator=g)
    L = torch.rand((n, 4), generator=g) * 4.0
    lam = 360.0 + 470.0 * torch.rand((n, 4), generator=g)
    lam[:4] = torch.tensor([359.4, 360.5, 829.5, 830.6])
    pdf = 0.0005 + 0.005 * torch.rand((n, 4), generator=g)
    pdf[::29, 2] = 0.0
    L[::31, 1] = float("nan")
    L[::23, 0] = 0.0
    L[::43, 2] = -0.0
    pdf[::86, 2] = float("nan")
    w = torch.rand(n, generator=g) * 2.0 - 0.4
    w[::3] = 0.0
    return [x.to(cuda) for x in (pix, L, lam, pdf, w)]


def test_film_kernel_matches_plain(cuda):
    """K5's scatter entry (any pixel ids, atomics) against its plain version
    within rtol 1e-5 (the order of the atomic adds), a third of the lanes
    of weight 0 (skipped by the kernel); one launch counted."""
    args = _film_lanes(20000, 3, cuda)
    fk, fp = filmlib.new_film((8, 8), cuda), filmlib.new_film((8, 8), cuda)
    n0 = film_kernel.launches["film_add_scatter"]
    film_kernel.add_samples_cuda(fk.rgb_sum, fk.weight_sum, *args)
    assert film_kernel.launches["film_add_scatter"] == n0 + 1
    film_kernel.add_samples_plain(fp.rgb_sum, fp.weight_sum, *args)
    scale = float(fp.rgb_sum.abs().max())
    assert torch.allclose(fk.rgb_sum, fp.rgb_sum, rtol=1e-5, atol=1e-6 * scale)
    assert torch.allclose(fk.weight_sum, fp.weight_sum, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k", [(4097, 1), (300, 3), (5000, 16), (65536, 16), (256, 4096)])
def test_film_tiled_kernel_bit_exact(cuda, n, k):
    """K5's tiled entry (k replicates of a tile of n distinct pixel ids that
    starts past 0, lane j n + p) against its plain version bit for bit, into
    a film that already holds sums, and the same bits on a second run; one
    launch counted."""
    _, L, lam, pdf, w = _film_lanes(n * k, 7 + k, cuda)
    pix = torch.arange(5, 5 + n, device=cuda)
    base = torch.randn((n + 9, 4), generator=torch.Generator().manual_seed(k)).to(cuda)
    out = []
    for fn in (film_kernel.add_samples_tiled_cuda, film_kernel.add_samples_tiled_cuda,
               film_kernel.add_samples_tiled_plain):
        rgb, ws = base[:, :3].contiguous(), base[:, 3].contiguous()
        n0 = film_kernel.launches["film_add_samples"]
        fn(rgb, ws, pix, L, lam, pdf, w, k)
        assert film_kernel.launches["film_add_samples"] == n0 + (fn is not
                                                              film_kernel.add_samples_tiled_plain)
        out.append((rgb, ws))
    for rgb, ws in out[:2]:
        assert torch.equal(rgb, out[2][0]) and torch.equal(ws, out[2][1])
    assert not torch.equal(out[2][0], base[:, :3])


def test_sampler_streams_bit_exact_on_card(cuda):
    pix = torch.arange(4096) * 7919 % 65536
    smp = torch.arange(4096) % 16
    outs = []
    for dev in ("cpu", cuda):
        r = samplers.start_pixel_sample(pix.to(dev), smp.to(dev))
        r, u2 = samplers.get_2d(r, None, "stratified", 16)
        r, u1 = samplers.get_1d(r, None, "independent", 16)
        outs.append([x.cpu() for x in (r.state, u2, u1)])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_render_on_card_matches_cpu(cuda):
    """cornell-mesh on the card (K1, K5's tiled entry) against the CPU, and
    bit-identical on a second render (no atomics in the film add)."""
    scene, meta = ts.cornell_mesh(res=24, spp=2, levels=3, device=cuda, filter_kind="box")
    counts0 = dict(bvh.launches)
    f0 = film_kernel.launches["film_add_samples"]
    img_gpu = render(scene, meta).cpu().numpy()
    assert np.array_equal(render(scene, meta).cpu().numpy(), img_gpu)
    img_cpu = render(scene, meta, device="cpu").numpy()
    assert all(bvh.launches[k] > counts0[k] for k in ("bvh_closest_hit", "bvh_any_hit"))
    assert film_kernel.launches["film_add_samples"] == f0 + 2
    err = np.abs(img_gpu - img_cpu)
    assert float((err > 5e-3 + 0.05 * np.abs(img_cpu)).mean()) < 0.005
    assert abs(img_gpu.mean() - img_cpu.mean()) < 0.01 * img_cpu.mean()


def quadric_soup(n, seed, device, partial=True):
    """n spheres and n disks in the box [-1, 1]^3, clipped when `partial`
    (z window, phimax < 2 pi, inner radius)."""
    g = np.random.default_rng(seed)
    rot = np.linalg.qr(g.normal(size=(n, 3, 3)))[0]
    rad = g.uniform(0.1, 0.4, n)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    sph = ix.SphereSoA(
        f(g.uniform(-0.8, 0.8, (n, 3))), f(rad),
        *((f(rot), f(-rad * g.uniform(0.2, 1.0, n)), f(rad * g.uniform(0.2, 1.0, n)),
           f(g.uniform(1.0, 2 * np.pi, n))) if partial else ()))
    nrm = rot[:, 2]
    dsk = ix.DiskSoA(
        f(g.uniform(-0.8, 0.8, (n, 3))), f(nrm), f(rad),
        f(rad * g.uniform(0.0, 0.5, n) if partial else np.zeros(n)),
        *((f(rot[:, 0]), f(np.cross(nrm, rot[:, 0])), f(g.uniform(1.0, 2 * np.pi, n)))
          if partial else ()))
    return sph, dsk


def uniform_rays(n, seed, device, scale=1.0):
    g = np.random.default_rng(seed)
    o = g.uniform(-scale, scale, (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, ix.INFINITY)
    t_max[::13] = 0.0
    t_max[5::13] = g.uniform(0.0, 2.0, len(t_max[5::13]))
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device) for x in (o, d, t_max))


def _dense_table(n_tris, device):
    """K3 test tables: cornell's 12 triangles, caustic-glass's 4, the first
    of cornell's, or 63 random triangles in [-1, 1]^3 (the dense route's
    most, accel/bvh.py MIN_TRIS_FOR_BVH - 1); with the bounds of the rays'
    origins (the scene's triangles', the soup's)."""
    from pbrt_tpu_torch.scene.compile import load_scene

    if n_tris == 4:
        sc, _ = load_scene("scenes/caustic-glass.pbrt", device=device, spp=1, integrator="path")
    else:
        sc, _ = ts.cornell(res=16, spp=1, device=device)
    tris = (sc.tri_p0, sc.tri_p1, sc.tri_p2)
    pts = torch.cat(tris)
    if n_tris == 1:
        tris = tuple(x[:1].contiguous() for x in tris)
    elif n_tris == 63:
        g = np.random.default_rng(63)
        c = g.uniform(-1.0, 1.0, (63, 1, 3))
        v = (c + 0.3 * g.normal(size=(63, 3, 3))).astype(np.float32)
        tris = tuple(torch.as_tensor(np.ascontiguousarray(v[:, i]), device=device)
                     for i in range(3))
        pts = torch.cat(tris)
    assert tris[0].shape[0] == n_tris
    return tris, pts.min(0).values, pts.max(0).values


@pytest.mark.parametrize("n_rays", [8192, 20000, 530000])
@pytest.mark.parametrize("n_tris", [1, 4, 12, 63])
@pytest.mark.parametrize("any_hit", [False, True])
def test_dense_tri_kernel_matches_plain(cuda, any_hit, n_tris, n_rays):
    """K3: prim ids, t and barycentrics equal to the plain version bit for bit
    (--fmad=false), ties to the lowest index, at the group size the wrapper
    picks for the wave (dense_tri_group, dense_tri_staged); a quarter of the
    rays aimed inside the table's triangles, and on cornell's and
    caustic-glass's tables a quarter through their shared edges, where two
    triangles are hit at the same t. 530,000 rays take the wide mode
    (dense_wide), with 90 % of the other lanes masked, as in a shadow
    wave."""
    import dense_cases

    tris, lo, hi = _dense_table(n_tris, cuda)
    o, d, t_max = uniform_rays(n_rays, 7, cuda)
    o = (lo + (hi - lo) * (0.5 + 0.45 * o)).contiguous()
    q = n_rays // 4
    o_a, d_a, t_a = dense_cases.aimed_rays(*tris, lo, hi, q, 13)
    o, d, t_max = (torch.cat([x[:-q], y]) for x, y in ((o, o_a), (d, d_a), (t_max, t_a)))
    if n_tris in (4, 12):
        o_t, d_t, t_t = dense_cases.tie_rays(*tris, q, 11)
        o, d, t_max = (torch.cat([x[:-2 * q], y, x[-q:]]) for x, y in ((o, o_t), (d, d_t),
                                                                       (t_max, t_t)))
        assert int(dense_cases.exact_ties(o, d, t_max, *tris).sum()) > q // 20
    if ix.dense_wide(n_rays):
        g = torch.Generator().manual_seed(70)
        masked = (torch.rand(n_rays, generator=g) < 0.9).to(cuda)
        masked[-2 * q:] = False
        t_max = torch.where(masked, 0.0, t_max)
    o, d, t_max = (x.contiguous() for x in (o, d, t_max))
    n0 = ix.launches["dense_tri_any" if any_hit else "dense_tri_closest"]
    k = ix.dense_tris_cuda(o, d, t_max, *tris, any_hit=any_hit)
    assert ix.launches["dense_tri_any" if any_hit else "dense_tri_closest"] == n0 + 1
    if any_hit:
        assert torch.equal(k, ix.occluded_tris_dense_plain(o, d, t_max, *tris))
        return
    p = ix.intersect_tris_dense_plain(o, d, t_max, *tris)
    # a quarter of the rays are aimed inside the table's triangles, unmasked;
    # cornell's 20,000 rays held to the 5,000 hits they were first held to
    floor = max(n_rays // 5, 5000 if (n_tris, n_rays) == (12, 20000) else 0)
    assert torch.equal(k.prim, p.prim) and int((p.prim >= 0).sum()) > floor
    assert torch.equal(k.t, p.t) and torch.equal(k.b, p.b)


def test_dense_tri_wrapper_refuses_a_table_past_its_stage(cuda):
    """K3's wide mode stages at most DENSE_MAX_TRIS triangles; the wrapper
    raises past them on a wide wave, and a small wave (rows through the
    read-only path) sweeps such a table as the plain version does."""
    T = ix.DENSE_MAX_TRIS + 1
    g = np.random.default_rng(5)
    c = g.uniform(-1.0, 1.0, (T, 1, 3))
    v = (c + 0.3 * g.normal(size=(T, 3, 3))).astype(np.float32)
    tris = tuple(torch.as_tensor(np.ascontiguousarray(v[:, i]), device=cuda) for i in range(3))
    o, d, t_max = uniform_rays(1 << 19, 3, cuda)
    assert ix.dense_wide(o.shape[0])
    with pytest.raises(ValueError, match="stages at most"):
        ix.dense_tris_cuda(o, d, t_max, *tris)
    o, d, t_max = (x[:4096].contiguous() for x in (o, d, t_max))
    k = ix.dense_tris_cuda(o, d, t_max, *tris)
    p = ix.intersect_tris_dense_plain(o, d, t_max, *tris)
    assert torch.equal(k.prim, p.prim) and int((p.prim >= 0).sum()) > 2048
    assert torch.equal(k.t, p.t) and torch.equal(k.b, p.b)
    assert torch.equal(ix.dense_tris_cuda(o, d, t_max, *tris, any_hit=True),
                       ix.occluded_tris_dense_plain(o, d, t_max, *tris))


@pytest.mark.parametrize("kind,n_rays", [("spheres", 50000), ("spheres", 8192),
                                          ("spheres", 530000), ("disks", 50000),
                                          ("disks", 8192), ("disks", 530000)])
@pytest.mark.parametrize("partial", [False, True])
def test_dense_quadric_kernels_match_plain(cuda, kind, partial, n_rays):
    """K4: the same winners as the plain version, but for lanes within 1e-5
    of a clip edge (atan2f vs torch.atan2); t, p, n to 1e-6 relative. The
    spheres and disks also at a small wave's 8,192 rays and at 530,000, a
    wide wave (dense_wide: rows staged, a lane's ray read only when live)."""
    sph, dsk = quadric_soup(24, 11, cuda, partial)
    o, d, t_max = uniform_rays(n_rays, 12, cuda)
    soa = ix.with_table(sph if kind == "spheres" else dsk)
    cuda_fn = ix.dense_spheres_cuda if kind == "spheres" else ix.dense_disks_cuda
    plain_fn = ix.intersect_spheres_dense_plain if kind == "spheres" else \
        ix.intersect_disks_dense_plain
    tk, ik, pk, nk = cuda_fn(o, d, t_max, soa)
    tp, ip, pp, np_ = plain_fn(o, d, t_max, soa)
    differ = ik != ip
    if bool(differ.any()):
        margin = clip_edge_distance(o[differ], d[differ],
                                       sph if kind == "spheres" else None,
                                       dsk if kind == "disks" else None)
        assert bool((margin < 1e-5).all()), margin.max()
    same = ~differ & (ip >= 0)
    assert int(same.sum()) > n_rays // 50
    assert torch.allclose(tk[same], tp[same], rtol=1e-6)
    assert torch.allclose(pk[same], pp[same], rtol=1e-6, atol=1e-6)
    assert torch.allclose(nk[same], np_[same], rtol=1e-6, atol=1e-6)
    assert bool((tk[ik < 0] == ix.INFINITY).all())


@pytest.mark.parametrize("n_rays", [8192, 530000])
@pytest.mark.parametrize("n_sph", [2, 24, 150])
@pytest.mark.parametrize("partial", [False, True])
def test_sphere_any_hit_matches_closest_bits(cuda, partial, n_sph, n_rays):
    """K4's any-hit entry (the occluded dispatch's): one bool a lane, the
    closest-hit entry's idx >= 0 bit for bit, on masked lanes (t_max 0), on
    short shadow lengths up to the closest hit and past it, and on partial
    spheres (z window, phimax), in either mode (8,192 rays small, 530,000
    wide) and with more spheres than one staged tile (150 > 64); counted
    as dense_spheres_any."""
    sph, _ = quadric_soup(n_sph, 31, cuda, partial)
    sph = ix.with_table(sph)
    o, d, t_max = uniform_rays(n_rays, 32, cuda)
    t_cl, idx_cl, _, _ = ix.dense_spheres_cuda(o, d, t_max, sph)
    g = torch.Generator().manual_seed(n_sph)
    u = (2.0 * torch.rand(n_rays, generator=g)).to(cuda)
    t_sh = torch.where(idx_cl >= 0, t_cl * u, t_max).contiguous()
    t_sh[::7] = 0.0
    for t in (t_max, t_sh):
        n0 = ix.launches["dense_spheres_any"]
        k = ix.dense_spheres_cuda(o, d, t, sph, any_hit=True)
        assert ix.launches["dense_spheres_any"] == n0 + 1
        idx = ix.dense_spheres_cuda(o, d, t, sph)[1]
        assert k.dtype == torch.bool and k.shape == (n_rays,)
        assert torch.equal(k, idx >= 0)
        assert not bool(k[t <= 0].any())
        assert n_rays // 100 < int(k.sum()) < n_rays
        assert torch.equal(ix.occluded_spheres_dense(o, d, t, sph), k)


@pytest.mark.parametrize("density,left", [(0.02, 10 ** 9), (0.5, 10 ** 9), (0.5, 777),
                                          (0.5, 2), (1.0, 0), (0.3, -3)])
def test_recycle_kernel_matches_cumsum(cuda, density, left):
    """K8 (one launch): rank, work, recycle, in_flight and the device
    counters equal the plain torch.cumsum version bit for bit, on a pool
    that is not a multiple of the tile (4096 lanes) and with next_work
    within 3 of the end of the work or past it; then more calls back to
    back on new masks and the advanced counters, every other one without
    the rank, some with fewer tiles than the one before, and no reset of
    the kernel's scratch in between."""
    g = torch.Generator().manual_seed(int(density * 100) + left % 1000)
    total = 5_000_000
    ck = torch.tensor([total - left, 123], dtype=torch.int64, device=cuda)
    cp = ck.clone()
    for call, R in enumerate((1 << 18) + np.array([1234, 1234, -200000, 1234, -250000, 99])):
        R = int(R)
        in_flight = (torch.rand(R, generator=g) < 0.9).to(cuda)
        finished = in_flight & (torch.rand(R, generator=g) < density).to(cuda)
        n0 = rd.launches["wavefront_recycle"]
        out_k = rd.recycle_cuda(finished, in_flight, ck, total, with_rank=call % 2 == 0)
        assert rd.launches["wavefront_recycle"] == n0 + 1
        out_p = rd.recycle_plain(finished, in_flight, cp, total, with_rank=call % 2 == 0)
        assert (out_k[0] is None) == (call % 2 == 1) == (out_p[0] is None)
        for a, b in zip(out_k, out_p):
            assert a is None or (a.dtype == b.dtype and torch.equal(a, b))
        assert torch.equal(ck, cp)


def test_dense_and_wavefront_renders_on_card(cuda):
    """cornell (dense K3/K4) on the card against the CPU; terrain (n=16)
    through the wavefront loop with a recycling pool against the batched
    loop on the card: the same honest ray count, K8 launched."""
    scene, meta = ts.cornell(res=24, spp=2, device=cuda, filter_kind="box")
    n0 = dict(ix.launches)
    img_gpu = render(scene, meta).cpu().numpy()
    img_cpu = render(scene, meta, device="cpu").numpy()
    assert all(ix.launches[k] > n0[k] for k in ("dense_tri_closest", "dense_tri_any",
                                                 "dense_spheres", "dense_spheres_any"))
    err = np.abs(img_gpu - img_cpu)
    assert float((err > 5e-3 + 0.05 * np.abs(img_cpu)).mean()) < 0.005
    scene, meta = ts.terrain(res=24, spp=4, n=16, device=cuda)
    k0 = rd.launches["wavefront_recycle"]
    f0 = dict(film_kernel.launches)
    old = rd.POOL_LANES
    rd.POOL_LANES = 512
    try:
        img_w, st_w = render(scene, meta, return_stats=True)
    finally:
        rd.POOL_LANES = old
    film_b = rd.filmlib.new_film(meta.resolution, cuda)
    st_b = {k: int(v) for k, v in rd.render_batched(scene, meta, film_b).items()}
    img_b = rd.filmlib.develop(film_b, meta.resolution, meta.film_out_matrix,
                               meta.film_imaging_ratio).cpu().numpy()
    assert rd.launches["wavefront_recycle"] > k0
    assert film_kernel.launches["film_add_scatter"] > f0["film_add_scatter"]
    assert film_kernel.launches["film_add_samples"] == f0["film_add_samples"] + 1  # batched
    assert st_w == st_b
    err = np.abs(img_w.cpu().numpy() - img_b)
    assert float((err > 5e-3 + 0.05 * np.abs(img_b)).mean()) < 0.005


def _layered_lanes(n, seed, device):
    """K7 lanes of tests/layered_cases.py on the card, every 5th masked out."""
    from layered_cases import BXDF_FIELDS, lanes
    from pbrt_tpu_torch.materials import bxdfs, layered

    a = {k: torch.as_tensor(v, device=device) for k, v in lanes(n, seed).items()}

    def bx(tag):
        return bxdfs.BxdfParams(*(a[f"{tag}_{f}"] for f in BXDF_FIELDS))
    p = layered.LayeredParams(bx("top"), bx("bottom"), a["thickness"], a["g"], a["albedo"],
                              10, 1)
    mask = torch.arange(n, device=device) % 5 != 0
    return p, a, mask


@pytest.mark.parametrize("name", ["layered_f", "layered_sample", "layered_pdf"])
def test_layered_kernel_matches_plain(cuda, name):
    """K7 against its plain version on the masked lanes, statistically (its
    transcendentals round apart from torch's, and the walk branches on
    them): valid and flags equal on >= 99.9 % of lanes, each output within
    rtol 1e-4, atol 1e-6 on >= 99.5 %, lane means within 1e-3 relative;
    masked-out lanes get zeros; one launch counted."""
    from layered_cases import CLOSE_FRAC, EQUAL_FRAC, MEAN_RTOL, frac_close
    from pbrt_tpu_torch.materials import layered

    n = 1 << 15
    p, a, mask = _layered_lanes(n, 3, cuda)
    args = (a["wo"], a["uc"], a["u2"]) if name == "layered_sample" else (a["wo"], a["wi"])
    n0 = layered.launches[name]
    steps = torch.zeros(1, dtype=torch.int64, device=cuda)
    out_k = getattr(layered, f"{name}_cuda")(p, *args, mask, steps)
    torch.cuda.synchronize()
    assert layered.launches[name] == n0 + 1
    assert int(steps.item()) > (0 if name == "layered_pdf" else int(mask.sum()))
    out_p = getattr(layered, f"{name}_plain")(p, *args)
    m = mask
    if name == "layered_sample":
        for f in ("valid", "flags"):
            assert float((getattr(out_k, f)[m] == getattr(out_p, f)[m]).float().mean()) >= EQUAL_FRAC
        for f in ("f", "wi", "pdf"):
            assert frac_close(getattr(out_k, f)[m], getattr(out_p, f)[m]) >= CLOSE_FRAC, f
        assert not bool(out_k.valid[~m].any()) and bool((out_k.pdf[~m] == 0).all())

        def est(s):
            return torch.where(s.valid[m][:, None], s.f[m] * s.wi[m][:, 2:3].abs()
                               / s.pdf[m].clamp(min=1e-12)[:, None], 0.0).double().mean()
        k_mean, p_mean = est(out_k), est(out_p)
    else:
        assert frac_close(out_k[m], out_p[m]) >= CLOSE_FRAC
        assert bool((out_k[~m] == 0).all())
        k_mean, p_mean = out_k[m].double().mean(), out_p[m].double().mean()
    assert abs(float(k_mean - p_mean)) <= MEAN_RTOL * abs(float(p_mean))


LAYERED_MASKS = {
    "none": lambda n, g: None,
    "every 5th out": lambda n, g: np.arange(n) % 5 != 0,
    "random 32 %": lambda n, g: g.random(n) < 0.32,
    "all out": lambda n, g: np.zeros(n, bool),
    "all in": lambda n, g: np.ones(n, bool),
}


def _layered_params(arrays, depth, device):
    from layered_cases import BXDF_FIELDS
    from pbrt_tpu_torch.materials import bxdfs, layered

    a = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}

    def bx(tag):
        return bxdfs.BxdfParams(*(a[f"{tag}_{f}"] for f in BXDF_FIELDS))
    return layered.LayeredParams(bx("top"), bx("bottom"), a["thickness"], a["g"], a["albedo"],
                                 depth, 1), a


@pytest.mark.parametrize("depth", [1, 10, 64])
@pytest.mark.parametrize("n", [1, 31, 33, 4097, 1 << 15])
@pytest.mark.parametrize("mask_kind", list(LAYERED_MASKS))
def test_layered_kernels_match_yardstick_bits(cuda, mask_kind, n, depth):
    """layered_f, layered_sample and layered_pdf as redesigned (layered_f and
    layered_sample: the walks that start listed, then stepped 32 a warp)
    against their yardsticks, the kernels as first written
    (csrc/layered_lane.cu): every output bit equal on every lane, inside and
    outside the mask (0 outside it; layered_sample's empty sample), and equal
    step counts, on tests/layered_cases.py's lanes and on its deep medium,
    whose walks run to max_depth."""
    from layered_cases import deep_medium_lanes, lanes
    from pbrt_tpu_torch.materials import layered

    g = np.random.default_rng(n * 131 + depth)
    m = LAYERED_MASKS[mask_kind](n, g)
    mask = None if m is None else torch.as_tensor(m, device=cuda)
    for make in (lanes, deep_medium_lanes):
        p, a = _layered_params(make(n, 7), depth, cuda)
        for name in ("layered_f", "layered_sample", "layered_pdf"):
            args = ((a["wo"], a["uc"], a["u2"]) if name == "layered_sample"
                    else (a["wo"], a["wi"]))
            st_k, st_y = (torch.zeros(1, dtype=torch.int64, device=cuda) for _ in range(2))
            out_k = getattr(layered, f"{name}_cuda")(p, *args, mask, st_k)
            out_y = getattr(layered, f"{name}_lane_cuda")(p, *args, mask, st_y)
            torch.cuda.synchronize()
            for k, y in zip(out_k if name == "layered_sample" else (out_k,),
                            out_y if name == "layered_sample" else (out_y,)):
                assert torch.equal(*((x.view(torch.int32) if x.dtype == torch.float32 else x)
                                     for x in (k, y))), (make.__name__, name)
            assert int(st_k) == int(st_y), (make.__name__, name)
            if mask is not None:
                f = out_k.f if name == "layered_sample" else out_k
                assert bool((f[~mask] == 0).all())


def test_bxdf_trig_matches_library(cuda):
    """csrc/bxdf.cuh's sin_angle and cos_angle, the samplers' sines and
    cosines without the library's reduction for huge arguments, give the bits
    of CUDA's sinf and cosf on every float of magnitude below 105615."""
    from pbrt_tpu_torch.materials import layered

    assert layered.trig_mismatches(cuda) == 0


def test_layered_kernel_graph_replays(cuda):
    """layered_f and layered_pdf captured in one CUDA graph and replayed
    twice: each layered_f launch zeroes its walk count and ticket (a memset
    node), so both replays give the eager launches' bits."""
    from layered_cases import deep_medium_lanes
    from pbrt_tpu_torch.materials import layered

    n = 20000
    p, a = _layered_params(deep_medium_lanes(n, 9), 10, cuda)
    mask = torch.as_tensor(np.random.default_rng(4).random(n) < 0.32, device=cuda)
    f_e = layered.layered_f_cuda(p, a["wo"], a["wi"], mask)
    pdf_e = layered.layered_pdf_cuda(p, a["wo"], a["wi"], mask)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        layered.layered_f_cuda(p, a["wo"], a["wi"], mask)
        layered.layered_pdf_cuda(p, a["wo"], a["wi"], mask)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        f_g = layered.layered_f_cuda(p, a["wo"], a["wi"], mask)
        pdf_g = layered.layered_pdf_cuda(p, a["wo"], a["wi"], mask)
    for _ in range(2):
        f_g.fill_(7.0)
        pdf_g.fill_(7.0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(f_g.view(torch.int32), f_e.view(torch.int32))
        assert torch.equal(pdf_g.view(torch.int32), pdf_e.view(torch.int32))


def test_layered_kernel_in_coated_render(cuda):
    """material-testball at 16^2 x 4 on the card launches K7's three entry
    points, and not their yardsticks; the walks
    seed on float bits, which differ between card and CPU by an ulp, so the
    image is held to the CPU render's mean (1 %)."""
    from pathlib import Path

    from pbrt_tpu_torch.materials import layered
    from pbrt_tpu_torch.scene import builder as bd
    from pbrt_tpu_torch.scene.compile import compile_scene

    b = bd.SceneBuilder().parse_file(str(Path(__file__).parent.parent / "scenes"
                                         / "material-testball.pbrt"))
    b.film["xresolution"] = b.film["yresolution"] = 16
    b.filter = {"type": "box"}
    scene, meta = compile_scene(b, 4, device=cuda)
    n0 = dict(layered.launches)
    img_gpu = render(scene, meta).cpu().numpy()
    assert all(layered.launches[k] > n0[k] for k in ("layered_f", "layered_sample",
                                                     "layered_pdf"))
    assert all(layered.launches[k] == n0[k] for k in ("layered_f_lane", "layered_pdf_lane",
                                                      "layered_sample_lane"))
    img_cpu = render(scene, meta, device="cpu").numpy()
    assert np.isfinite(img_gpu).all()
    assert abs(img_gpu.mean() - img_cpu.mean()) < 0.01 * img_cpu.mean()


@pytest.mark.parametrize("n_lam,reps,n_px", [(7000, 3, 64), (5000, 4, 1), (1037, 7, 4096)],
                         ids=["wave", "one pixel", "odd count"])
def test_splat_kernel_matches_plain(cuda, n_lam, reps, n_px):
    """K5s (csrc/film.cu's splat entry): the strategies' splats over one
    wave's lanes (wavelength row i % n_lam), NaN and zero-pdf lanes, zero
    splats (no atomic), within rtol 1e-5 of the plain version (the order of
    the atomic adds); a wave whose splats all land on one pixel, and a wave
    of lanes and splats that are no multiple of the block (256)."""
    g = torch.Generator().manual_seed(4 + reps)
    n = n_lam * reps
    pix = torch.randint(0, n_px, (n,), generator=g)
    L = torch.rand((n, 4), generator=g) * 4.0
    L[::31, 1] = float("nan")
    lam = 360.0 + 470.0 * torch.rand((n_lam, 4), generator=g)
    pdf = 0.0005 + 0.005 * torch.rand((n_lam, 4), generator=g)
    pdf[::29, 2] = 0.0
    L[::5] = 0.0
    pix, L, lam, pdf = (x.to(cuda) for x in (pix, L, lam, pdf))
    fk, fp = filmlib.new_film((64, 64), cuda), filmlib.new_film((64, 64), cuda)
    n0 = film_kernel.launches["film_add_splats"]
    film_kernel.add_splats_cuda(fk.splat, pix, L, lam, pdf)
    assert film_kernel.launches["film_add_splats"] == n0 + 1
    film_kernel.add_splats_plain(fp.splat, pix, L, lam, pdf)
    scale = float(fp.splat.abs().max())
    assert scale > 0
    assert torch.allclose(fk.splat, fp.splat, rtol=1e-5, atol=1e-6 * scale)
    assert float(fk.rgb_sum.abs().sum()) == 0.0 and float(fk.weight_sum.abs().sum()) == 0.0
    if n_px == 1:
        assert bool((fk.splat[1:] == 0).all())


@pytest.mark.parametrize("name", ["cornell", "caustic-glass", "four lights"])
def test_bdpt_kernel_matches_plain(cuda, name):
    """K12 (both entry points around one occluded dispatch) against its
    plain version on a wave of 24^2 x 2 lanes (tests/bdpt_cases.py: for
    every strategy, its live lanes within rtol 1e-4, atol 1e-6; equal ray
    counts and splat pixels); one launch of each entry point counted, none
    of the yardsticks; then both entry points the same bits as their
    yardsticks (the one-thread-per-lane kernels over the packed copy). The
    four-light scene holds the distant, spot and uniform infinite lights,
    escaped camera rays and the delta-light rule."""
    from pathlib import Path

    from bdpt_cases import (compare, compare_yardstick, four_lights_builder,
                            require_agreement, wave_inputs)
    from pbrt_tpu_torch.integrators import bdpt
    from pbrt_tpu_torch.scene import builder as bd
    from pbrt_tpu_torch.scene.compile import compile_scene

    if name == "cornell":
        b = ts.cornell_builder(24, "box")
    elif name == "four lights":
        b = four_lights_builder(24)
    else:
        b = bd.SceneBuilder().parse_file(str(Path(__file__).parent.parent / "scenes"
                                             / "caustic-glass.pbrt"))
        b.film["xresolution"] = b.film["yresolution"] = 24
    scene, meta = compile_scene(b, 2, device=cuda, integrator_override="bdpt")
    pix = torch.arange(24 * 24, device=cuda).repeat(2)
    sample = torch.arange(2, device=cuda).repeat_interleave(24 * 24)
    n0 = dict(bdpt.launches)
    wave = wave_inputs(scene, meta, pix, sample)
    res = compare(scene, meta, *wave)
    assert {k: bdpt.launches[k] - n0[k] for k in n0} == {
        "bdpt_connect_rays": 1, "bdpt_connect_weight": 1, "bdpt_connect_rays_lane": 0,
        "bdpt_connect_weight_lane": 0}
    require_agreement(res)
    assert res["rays_kernel"] > 0 and res["strategies_live"] > res["strategies"] // 2
    assert compare_yardstick(scene, meta, *wave) == {"rays": True, "weight": True}


@pytest.mark.parametrize("name, res, spp, lanes, depth", [
    ("four lights", 64, 2, 8192, None), ("cornell", 24, 2, 1000, None),
    ("four lights", 24, 2, 1000, 8), ("cornell", 24, 2, 1152, 16),
    ("cornell", 16, 2, 500, 17), ("cornell", 16, 1, 256, 24)],
    ids=["four lights-8192", "cornell-1000", "four lights-1000-depth 8",
         "cornell-1152-depth 16", "cornell-500-depth 17", "cornell-256-depth 24"])
def test_bdpt_kernel_bits_at_tile_edges(cuda, name, res, spp, lanes, depth):
    """K12 at the MLT shape (8192 lanes: 256 tiles of 32), at lane counts
    that are no multiple of the tile (the last tile's lanes past R stage
    zeros, or read lane R - 1, and write nothing), and at each of
    bdpt_connect_weight's routes by max depth: two staged buffers up to
    depth 7 (17 vertex slots), one from depth 8 (19 slots) to 16 (35), the
    vertices read in place from depth 17 (37 slots) on. The same bits as
    its yardsticks, and within tests/bdpt_cases.py's criterion of the plain
    version."""
    from bdpt_cases import compare, compare_yardstick, four_lights_builder, require_agreement, \
        wave_inputs
    from pbrt_tpu_torch.scene.compile import compile_scene

    b = four_lights_builder(res) if name == "four lights" else ts.cornell_builder(res, "box")
    if depth is not None:
        b.integrator["maxdepth"] = depth
    scene, meta = compile_scene(b, spp, device=cuda, integrator_override="bdpt")
    pix = torch.arange(res * res, device=cuda).repeat(spp)[:lanes]
    sample = torch.arange(spp, device=cuda).repeat_interleave(res * res)[:lanes]
    wave = wave_inputs(scene, meta, pix, sample)
    assert wave[2].shape[0] == lanes
    assert len(wave[0]) + len(wave[1]) == 2 * meta.max_depth + 3
    assert compare_yardstick(scene, meta, *wave) == {"rays": True, "weight": True}
    require_agreement(compare(scene, meta, *wave))


def test_bdpt_render_on_card_matches_cpu(cuda):
    """cornell 16^2 x 4 with BDPT: K12 and K5s launched (K12's yardsticks
    not), the image within tests/test_parity.py's criterion of the CPU
    render, ray counts within 0.1 % (an eager op may round apart between
    card and CPU and turn a walk)."""
    from pbrt_tpu_torch.integrators import bdpt
    from pbrt_tpu_torch.scene.compile import compile_scene

    scene, meta = compile_scene(ts.cornell_builder(16, "box"), 4, device=cuda,
                                integrator_override="bdpt")
    n0 = dict(bdpt.launches)
    s0 = film_kernel.launches["film_add_splats"]
    img_gpu, st_gpu = render(scene, meta, return_stats=True)
    assert all(bdpt.launches[k] > n0[k] for k in ("bdpt_connect_rays", "bdpt_connect_weight"))
    assert all(bdpt.launches[k] == n0[k] for k in ("bdpt_connect_rays_lane",
                                                    "bdpt_connect_weight_lane"))
    assert film_kernel.launches["film_add_splats"] > s0
    img_cpu, st_cpu = render(scene, meta, device="cpu", return_stats=True)
    img_gpu, img_cpu = img_gpu.cpu().numpy(), img_cpu.numpy()
    n_gpu, n_cpu = sum(st_gpu.values()), sum(st_cpu.values())
    assert abs(n_gpu - n_cpu) <= 1e-3 * n_cpu
    err = np.abs(img_gpu - img_cpu)
    assert float((err > 5e-3 + 0.05 * np.abs(img_cpu)).mean()) < 0.005
    assert abs(img_gpu.mean() - img_cpu.mean()) < 0.01 * img_cpu.mean()


@pytest.mark.parametrize("D", [66, 67, 160, 376])
def test_mlt_mutate_kernel_matches_plain(cuda, D):
    """K12m-a at 8192 chains and the D of cornell-mesh (mltpath, depth 5),
    caustic-glass (mlt, depth 7) and volumetric MLT (16 + 40 (7 + 2)), and
    67 (the tails of a lane group: lanes idle on the last step): its draws
    and large-step flags bit-exact with chain_uniforms, values within
    tests/mlt_cases.py's MUTATE_ULPS; one launch counted."""
    from mlt_cases import compare_mutate, primary_samples
    from pbrt_tpu_torch.integrators import mlt

    x = torch.from_numpy(primary_samples(8192, D, D)).to(cuda)
    draws = torch.empty((8192, 1 + 2 * D), device=cuda)
    n0 = mlt.launches["mlt_mutate"]
    out = mlt.mutate_cuda(x, 7, 3, draws)
    assert mlt.launches["mlt_mutate"] == n0 + 1
    res = compare_mutate(x, out, draws, mlt.mutate_from_uniforms, mlt.chain_uniforms, 7, 3)
    assert 0 < res["large"] < 8192


@pytest.mark.parametrize("C", [1, 8, 17])
def test_mlt_accept_kernel_matches_plain(cuda, C):
    """K12m-b for one contribution (mltpath), eight (mlt at depth 7) and 17
    (2 C past a warp, more than a lane each): acceptance and chain state
    exact, splat and heat within
    tests/mlt_cases.py's SPLAT_RTOL of the plain version with the stream's
    accept uniforms; one launch counted."""
    from mlt_cases import accept_inputs, compare_accept
    from pbrt_tpu_torch.integrators import mlt

    R, D, n_pix = 8192, 40, 4096
    T = {k: torch.from_numpy(v).to(cuda) for k, v in accept_inputs(R, C, D, n_pix, C).items()}
    cur = mlt.Chains(T["x_cur"], T["pix_cur"], T["rgb_cur"], T["y_cur"])
    prop = mlt.Chains(T["x_prop"], T["pix_prop"], T["rgb_prop"], T["y_prop"])
    n0 = mlt.launches["mlt_accept_splat"]
    res = compare_accept(
        lambda *a: mlt.accept_and_splat_cuda(*a, 5, 9),
        lambda *a: mlt.accept_and_splat_from_uniforms(*a, mlt.accept_uniforms(5, 9, R, cuda)),
        torch.rand((n_pix, 3), device=cuda), torch.rand(n_pix, device=cuda), cur, prop)
    assert mlt.launches["mlt_accept_splat"] == n0 + 1
    assert 0 < res["accepted"] < R


def test_mlt_render_on_card_matches_cpu(cuda):
    """mltpath on cornell 16^2, max depth 3, 512 chains, 4 passes, same seed
    on the card and the CPU: both kernels launched once a pass; acceptances,
    block means and image means under tests/mlt_cases.py's compare_renders
    (the chains share their random numbers and part only where rounding
    flips a decision)."""
    import dataclasses

    from mlt_cases import compare_renders
    from pbrt_tpu_torch.integrators import mlt

    scene, meta = ts.cornell(res=16, spp=1, device=cuda, filter_kind="box",
                             integrator="mltpath")
    meta = dataclasses.replace(meta, max_depth=3, mutations_per_pixel=8)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        acc = []
        n0 = dict(mlt.launches)
        img, _ = mlt.render_mlt(scene, meta, n_chains=512, n_bootstrap=4096, device=dev,
                                on_pass=lambda i, a, acc=acc, dev=dev: acc.append(
                                    (mlt.accept_uniforms(0, i, 512, dev) < a).cpu()))
        if dev.type == "cuda":
            assert all(mlt.launches[k] == n0[k] + 4 for k in n0)
        out[dev.type] = (img.cpu().numpy(), torch.stack(acc))
    (img_g, acc_g), (img_c, acc_c) = out["cuda"], out["cpu"]
    assert np.isfinite(img_g).all()
    compare_renders(img_g, img_c, acc_g, acc_c)


def _pack_ties(pk, ref, o, d, t_max):
    """Rows where the candidate pack pk differs from ref must be verified
    ties: both winners hit (the watertight test on the pack's vertices) at
    t within 1e-6 relative of each other. -> their count."""
    differ = (pk != ref).any(1)
    if bool(differ.any()):
        ts = []
        for pack in (pk[differ], ref[differ]):
            tr, _, ok = ix.intersect_tri_lanes(o[differ], d[differ], t_max[differ],
                                               pack[:, 28:31], pack[:, 31:34], pack[:, 34:37])
            assert bool(ok.all()) and bool(torch.isfinite(pack[:, 0]).all())
            ts += [tr, pack[:, 0]]
        assert float(((ts[0] - ts[2]).abs() / ts[2].abs()).max()) <= 1e-6
        assert float(((ts[1] - ts[3]).abs() / ts[3].abs()).max()) <= 1e-6
    return int(differ.sum())


def test_scene_shard_kernels_match_plain(cuda):
    """K11a's packs, K11b's bits and the select kernel against their plain
    versions: cornell-mesh levels 4 in 1, 2, 4, 8 and 16 parts (16: a top
    level of two levels), interior rays with masked lanes, shadow lengths up
    to the closest hit's twice, 3 stacked packs with planted ties. K11a
    bit-exact with its plain version but for verified ties, K11b bit-exact
    with it; each the same bits again from a CUDA graph replayed twice; one
    launch of each a call on its own launch name."""
    from pbrt_tpu_torch.parallel import scene_shard as ss

    scene, meta = ts.cornell_mesh(res=32, spp=1, levels=4, device=cuda)
    o, d, t_max = (x.to(cuda) for x in _rays(scene, 8192, 9))
    ov0 = int(bvh.overflow_counter(cuda).item())
    for n_parts in (1, 2, 4, 8, 16):
        sh = ss.build_scene_shard(scene, n_parts).to(cuda)
        args = (sh.rows, sh.recv, sh.n_int, sh.depth)
        n0 = dict(ss.launches)
        pk = ss.closest_parts_cuda(*args, sh.top, o, d, t_max)
        _pack_ties(pk, ss.closest_parts_plain(sh.rows, sh.recv, sh.n_int, o, d, t_max), o, d,
                   t_max)
        assert bool(torch.isfinite(pk[:, 0]).any())
        assert bool(torch.isinf(pk[t_max <= 0, 0]).all()) and not pk[t_max <= 0, 1:].any()
        t_sh = torch.where(torch.isfinite(pk[:, 0]),
                           pk[:, 0] * 2.0 * torch.rand(8192, device=cuda), 100.0).contiguous()
        t_sh[::7] = 0.0
        occ = ss.any_parts_cuda(sh.rows, sh.n_int, sh.depth, sh.top, o, d, t_sh)
        assert torch.equal(occ, ss.any_parts_plain(sh.rows, sh.n_int, o, d, t_sh))
        assert 0 < int(occ.sum()) < int((t_sh > 0).sum())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            pk_g = ss.closest_parts_cuda(*args, sh.top, o, d, t_max)
            occ_g = ss.any_parts_cuda(sh.rows, sh.n_int, sh.depth, sh.top, o, d, t_sh)
        for _ in range(2):
            pk_g.zero_()
            occ_g.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(pk_g, pk) and torch.equal(occ_g, occ)
        n1 = {k: n0[k] + (2 if k in ("bvh_closest_hit_parts", "bvh_any_hit_parts") else 1)
              for k in n0 if k != "shard_select"}
        assert {k: ss.launches[k] for k in n1} == n1
    assert int(bvh.overflow_counter(cuda).item()) == ov0
    packs = torch.stack([pk.roll(5 * w, dims=0) for w in range(3)]).contiguous()
    packs[1:, ::4, 0] = packs[0, ::4, 0]
    n_sel = ss.launches["shard_select"]
    assert torch.equal(ss.select_cuda(packs), ss.select_plain(packs))
    assert ss.launches["shard_select"] == n_sel + 1


def test_sharded_render_on_card_matches_cpu(cuda):
    """render(shard_parts=4) of cornell-mesh levels 3 at 48^2 x 4 on the card
    (K11a and K11b, not K1; the refit of K11a's winners) against the same
    sharded render on the CPU."""
    from pbrt_tpu_torch.parallel import scene_shard as ss

    scene, meta = ts.cornell_mesh(res=48, spp=4, levels=3, device=cuda, filter_kind="box")
    n_bvh, n_ss = dict(bvh.launches), dict(ss.launches)
    img_gpu, st_gpu = render(scene, meta, return_stats=True, shard_parts=4)
    assert {k: v for k, v in bvh.launches.items() if k != "bvh_refit"} == {
        k: v for k, v in n_bvh.items() if k != "bvh_refit"}
    assert bvh.launches["bvh_refit"] > n_bvh["bvh_refit"]
    assert ss.launches["bvh_closest_hit_parts"] > n_ss["bvh_closest_hit_parts"]
    assert ss.launches["bvh_any_hit_parts"] > n_ss["bvh_any_hit_parts"]
    img_cpu, st_cpu = render(scene, meta, device="cpu", return_stats=True, shard_parts=4)
    img_gpu, img_cpu = img_gpu.cpu().numpy(), img_cpu.numpy()
    n_gpu, n_cpu = sum(st_gpu.values()), sum(st_cpu.values())
    assert abs(n_gpu - n_cpu) <= 1e-3 * n_cpu
    err = np.abs(img_gpu - img_cpu)
    assert float((err > 5e-3 + 0.05 * np.abs(img_cpu)).mean()) < 0.005
    assert abs(img_gpu.mean() - img_cpu.mean()) < 0.01 * img_cpu.mean()


def _path_parts():
    from pbrt_tpu_torch.integrators import path

    return ((path.rr_cuda, path.shade_cuda, path.coat_cuda, path.resolve_cuda),
            (path.rr_plain, path.shade_plain, path.coat_plain, path.resolve_plain))


@pytest.mark.parametrize("skind", ["independent", "stratified"])
@pytest.mark.parametrize("lanes", [1000, 1 << 16])
def test_path_step_kernels_match_plain(cuda, skind, lanes):
    """K6 (csrc/path_step.cu: path_rr, path_shade and path_bsdf, path_resolve)
    against rr_plain, shade_plain and resolve_plain on tests/path_cases.py's
    synthetic lanes of the four-light scene (dead lanes, RR due and not due,
    every material kind and light type, shadow rays of t_max 0), each part
    on the plain chain's inputs: path_cases' criteria (draws and masks
    bit-exact, float fields close, lane means); path_shade and path_bsdf also
    each alone against its part of shade_plain (shade_light_plain,
    shade_bsdf_plain); one launch each for the chain, one more of each
    shading kernel for the parts alone, no path_coat on a scene without
    coated materials and no yardstick."""
    import path_cases as pc
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.scene.compile import compile_scene

    scene, meta = compile_scene(pc.builder(24, skind, 4), device=cuda)
    state = pc.synthetic_state(scene, meta, lanes, 5)
    n0 = dict(path.launches)
    kern, plain = _path_parts()
    reps, seen = pc.compare_parts(scene, meta, state, skind, 4, kern, plain, pc.shade_parts())
    assert {k: path.launches[k] - n0[k] for k in n0} == dict(
        path_rr=1, path_shade=2, path_bsdf=2, path_coat=0, path_resolve=1, path_shade_lane=0,
        transmit_hop=0, path_shade_vol=0, path_bsdf_vol=0, path_resolve_vol=0)
    assert {"shade.light", "shade.bsdf"} <= set(reps)
    for name, rep in reps.items():
        assert rep.ok(), (name, str(rep))
    assert seen["traced"] < lanes and seen["nee"] > 0
    hit = pc.chain(scene, meta, state, skind, 4, plain)["hit"]
    kinds = scene.mat_type[hit.mat[hit.valid]].unique().tolist()
    assert {0, 1, 2, 3} <= set(kinds) and bool((hit.light >= 0).any())


@pytest.mark.parametrize("case", ["coated", "mlt6", "mlt30", "coated_mlt30"])
@pytest.mark.parametrize("lanes", [1000, 1 << 18])
def test_path_step_kernels_match_plain_coated_and_mlt(cuda, case, lanes):
    """The chain with path_coat and K7 (csrc/layered.cu, launched from the
    step) against the plain parts on path_cases' synthetic lanes of the
    coated scene (COATED_PBRT) and with the MLT kind (vectors of 6 and 30
    dimensions, lanes at dimensions 0 .. D + 8): each part on the plain
    chain's inputs to path_cases' criteria (path_coat on identical inputs,
    lane by lane), and the whole bounce (draws bit-exact, the coated lanes'
    L, beta and prev_pdf on their lane means); K7's launches those of the
    plain step (layered_f, layered_sample once, layered_pdf twice)."""
    import path_cases as pc
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.materials import layered
    from pbrt_tpu_torch.scene.compile import compile_scene

    coated = case.startswith("coated")
    skind, spp = ("mlt", 0) if "mlt" in case else ("independent", 4)
    mlt_d = int(case.rsplit("mlt", 1)[1]) if "mlt" in case else None
    scene, meta = compile_scene(pc.builder(24, "independent", 4, coated=coated), device=cuda)
    state = pc.synthetic_state(scene, meta, lanes, 7, mlt_d=mlt_d)
    kern, plain = _path_parts()
    reps, seen = pc.compare_parts(scene, meta, state, skind, spp, kern, plain, pc.shade_parts())
    for name, rep in reps.items():
        assert rep.ok(), (name, str(rep))
    assert ("coat" in reps) == coated and (seen["coated"] > 0) == coated
    n0, k0 = dict(path.launches), dict(layered.launches)
    rep, n_coated = pc.compare_bounce(scene, meta, state, skind, spp, kern, plain)
    assert rep.ok(), str(rep)
    k7 = {k: layered.launches[k] - k0[k] for k in ("layered_f", "layered_sample", "layered_pdf")}
    assert k7 == ({"layered_f": 2, "layered_sample": 2, "layered_pdf": 4} if coated
                  else dict.fromkeys(k7, 0))
    assert {k: path.launches[k] - n0[k] for k in n0} == dict(
        path_rr=1, path_shade=1, path_bsdf=1, path_coat=int(coated), path_resolve=1,
        path_shade_lane=0, transmit_hop=0, path_shade_vol=0, path_bsdf_vol=0,
        path_resolve_vol=0)


@pytest.mark.parametrize("case", ["independent", "stratified", "coated", "mlt6"])
@pytest.mark.parametrize("lanes", [1000, 1 << 16])
def test_path_shade_kernels_match_yardstick_bits(cuda, case, lanes):
    """path_shade and path_bsdf (shading split at the NEE / BSDF-sample
    boundary) against their yardstick path_shade_lane (shading as first
    written, one kernel) on path_cases' synthetic lanes and their second
    bounce: every output of every lane the same bits (path_cases.shade_bits:
    the next state, the sampler state, the shadow rays and pending term, the
    coated lanes' layer, draws and light sample); both kernels graph-replayed
    twice on the same inputs give those bits again (neither reads what it
    writes)."""
    import path_cases as pc
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.scene.compile import compile_scene

    skind, spp = {"stratified": ("stratified", 4), "mlt6": ("mlt", 0)}.get(
        case, ("independent", 4))
    scene, meta = compile_scene(pc.builder(24, "stratified" if case == "stratified"
                                           else "independent", 4, coated=case == "coated"),
                                device=cuda)
    state = pc.synthetic_state(scene, meta, lanes, 11, mlt_d=6 if case == "mlt6" else None)
    _, plain = _path_parts()
    for _ in range(2):
        c = pc.chain(scene, meta, state, skind, spp, plain)
        args = (scene, meta, c["rr"][0], c["hit"], skind, spp)
        want = path.shade_lane_cuda(*args)
        bits = pc.shade_bits(path.shade_cuda(*args), want)
        assert all(v == 1.0 for v in bits.values()), {k: v for k, v in bits.items() if v != 1.0}
        state = c["out"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        path.shade_cuda(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = path.shade_cuda(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        bits = pc.shade_bits(got, want)
        assert all(v == 1.0 for v in bits.values()), {k: v for k, v in bits.items() if v != 1.0}


def test_path_coat_matches_coat_plain_lane_by_lane(cuda):
    """path_coat against coat_plain on identical inputs (the plain chain's
    state, pending term, coated lanes and K7's answers on the card) at the
    coated scene's camera lanes and their second bounce: floats within
    rtol 1e-4, atol 1e-6 on >= 99.5 % of lanes, masks equal."""
    import path_cases as pc
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.scene.compile import compile_scene

    scene, meta = compile_scene(pc.builder(64, "independent", 4, coated=True), device=cuda)
    state = pc.camera_state(scene, meta)
    _, plain = _path_parts()
    for _ in range(2):
        c = pc.chain(scene, meta, state, "independent", 4, plain)
        st2, _, pending, lanes = c["shade"]
        assert int(lanes.mask.sum()) > 100
        rep = pc.compare_coat((scene, st2, pending, lanes) + c["k7"], path.coat_cuda,
                              path.coat_plain)
        assert rep.ok(), str(rep)
        state = c["out"]


def test_path_step_kernel_wrappers_refuse(cuda):
    """The wrappers raise on CPU tensors, and the MLT kind without the
    sampler's primary-sample vectors; step_route is "cuda" for every scene
    and sampler kind on the card."""
    import path_cases as pc
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.scene.compile import compile_scene

    scene, meta = compile_scene(pc.builder(8, coated=True), device=cuda)
    state = pc.camera_state(scene, meta)
    for skind in path.STEP_SAMPLERS:
        assert path.step_route(cuda, meta, skind) == "cuda"
    with pytest.raises(ValueError):
        path.rr_cuda(meta, state, "mlt", 0)
    with pytest.raises(ValueError):
        path.rr_cuda(meta, pc.to_device(state, "cpu"))
    scene_c, meta_c = compile_scene(pc.builder(8, coated=True), device="cpu")
    c = pc.chain(scene_c, meta_c, pc.camera_state(scene_c, meta_c), "independent", 4,
                 _path_parts()[1])
    st2, _, pending, lanes = c["shade"]
    n0 = dict(path.launches)
    with pytest.raises(ValueError):
        path.coat_cuda(scene_c, st2, pending, lanes, *c["k7"])
    assert path.launches == n0


@pytest.mark.parametrize("skind", ["independent", "stratified"])
def test_path_step_render_on_card_matches_cpu(cuda, skind):
    """The four-light scene (open: the wavefront loop) at 24^2 x 4 through
    render() on the card (the "cuda" route: path_rr, path_shade, path_bsdf
    and path_resolve once an iteration, as often as K8) against the CPU's plain
    step: ray counts within 0.1 %, the image within tests/test_parity.py's
    criterion; through the batched loop (max_depth launches of each a
    wave), the card's film the same bits over two renders."""
    import path_cases as pc
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.scene.compile import compile_scene

    scene, meta = compile_scene(pc.builder(24, skind, 4), device=cuda)
    k6 = ("path_rr", "path_shade", "path_bsdf", "path_resolve")
    n0, k0 = dict(path.launches), rd.launches["wavefront_recycle"]
    img_gpu, st_gpu = render(scene, meta, return_stats=True)
    its = rd.launches["wavefront_recycle"] - k0
    assert its > 0 and {k: path.launches[k] - n0[k] for k in n0} == dict(
        dict.fromkeys(k6, its), path_coat=0, path_shade_lane=0,
        **dict.fromkeys(("transmit_hop", "path_shade_vol", "path_bsdf_vol", "path_resolve_vol"), 0))
    films = [filmlib.new_film(meta.resolution, cuda) for _ in range(2)]
    n0 = dict(path.launches)
    for f in films:
        rd.render_batched(scene, meta, f)
    assert {k: path.launches[k] - n0[k] for k in k6} == dict.fromkeys(k6, 2 * meta.max_depth)
    assert torch.equal(films[0].rgb_sum, films[1].rgb_sum)
    img_cpu, st_cpu = render(scene, meta, device="cpu", return_stats=True)
    img_gpu, img_cpu = img_gpu.cpu().numpy(), img_cpu.numpy()
    n_gpu, n_cpu = sum(st_gpu.values()), sum(st_cpu.values())
    assert abs(n_gpu - n_cpu) <= 1e-3 * n_cpu
    err = np.abs(img_gpu - img_cpu)
    assert float((err > 5e-3 + 0.05 * np.abs(img_cpu)).mean()) < 0.005
    assert abs(img_gpu.mean() - img_cpu.mean()) < 0.01 * img_cpu.mean()


def test_path_step_coated_render_on_card_matches_cpu(cuda):
    """The coated four-light scene (COATED_PBRT) at 32^2 x 8 through render()
    on the card (path_coat and K7 from the step, max_depth a wave) against
    the CPU's plain step: ray counts within 1 %, 8x8 block means within
    tests/test_parity.py's criterion and the image means within 1 % (the
    coated walks are independent estimates where the local directions'
    bits differ)."""
    import path_cases as pc
    from layered_cases import blocks
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.scene.compile import compile_scene

    b = pc.builder(32, "independent", 8, coated=True)
    b.filter = {"type": "box"}
    scene, meta = compile_scene(b, device=cuda)
    n0 = dict(path.launches)
    img_gpu, st_gpu = render(scene, meta, return_stats=True)
    got = {k: path.launches[k] - n0[k] for k in n0}
    assert got["path_coat"] == got["path_rr"] == got["path_shade"] == got["path_bsdf"] > 0, got
    assert got["path_shade_lane"] == 0, got
    img_cpu, st_cpu = render(scene, meta, device="cpu", return_stats=True)
    img_gpu, img_cpu = img_gpu.cpu().numpy(), img_cpu.numpy()
    n_gpu, n_cpu = sum(st_gpu.values()), sum(st_cpu.values())
    assert abs(n_gpu - n_cpu) <= 1e-2 * n_cpu
    bg, bc = blocks(img_gpu, 8), blocks(img_cpu, 8)
    assert float((np.abs(bg - bc) > 5e-3 + 0.05 * np.abs(bc)).mean()) < 0.005
    assert abs(img_gpu.mean() - img_cpu.mean()) < 0.01 * img_cpu.mean()


def test_path_step_mltpath_render_on_card_matches_cpu(cuda):
    """cornell 16^2 with mltpath (1024 chains), its path evaluations on the
    card's CUDA step with the MLT kind (path_rr, path_shade, path_bsdf,
    path_resolve max_depth times an evaluation), against the CPU with one seed:
    tests/mlt_cases.py's criteria (accept decisions, 8x8 block means,
    image mean)."""
    import mlt_cases
    from pbrt_tpu_torch.integrators import mlt, path

    sc, mt = ts.cornell(res=16, spp=1, device=cuda, filter_kind="box", integrator="mltpath")
    mt = dataclasses.replace(mt, mutations_per_pixel=mlt_cases.SMALL_MUTATIONS)
    runs = {}
    for d in (cuda, torch.device("cpu")):
        acc = []
        n0, m0 = dict(path.launches), dict(mlt.launches)
        img, _ = mlt.render_mlt(
            sc, mt, n_chains=mlt_cases.SMALL_CHAINS, n_bootstrap=mlt_cases.SMALL_BOOTSTRAP,
            device=d, on_pass=lambda i, a, acc=acc, d=d: acc.append(
                mlt.accept_uniforms(0, i, mlt_cases.SMALL_CHAINS, d) < a))
        runs[d.type] = (img.cpu().numpy(), torch.stack(acc).cpu(),
                        {k: path.launches[k] - n0[k] for k in n0},
                        mlt.launches["mlt_mutate"] - m0["mlt_mutate"])
    (img_g, acc_g, k6, passes), (img_c, acc_c, k6_cpu, _) = runs["cuda"], runs["cpu"]
    assert passes == acc_g.shape[0] > 0 and not any(k6_cpu.values())
    assert (k6["path_rr"] == k6["path_shade"] == k6["path_bsdf"] == k6["path_resolve"]
            > passes * mt.max_depth)
    assert k6["path_rr"] % mt.max_depth == 0 and k6["path_coat"] == 0
    mlt_cases.compare_renders(img_g, img_c, acc_g, acc_c)


def test_bvh_refit_kernel_matches_plain(cuda):
    """The refit kernel (csrc/bvh_traverse.cu `pbrt_bvh_refit`) against
    refit_plain on cornell-mesh's traversal winners (random interior rays,
    every 11th masked): t, prim and barycentrics bit for bit, one launch;
    closest_hit_tris on the card takes it."""
    scene, meta = ts.cornell_mesh(levels=3, res=32, spp=1, device=cuda)
    o, d, t_max = (x.to(cuda) for x in _rays(scene, 50000, 13))
    _, prim = bvh.traverse_cuda(scene.bvh_rows, meta.bvh_nint, meta.bvh_depth, o, d, t_max)
    n0 = bvh.launches["bvh_refit"]
    got = bvh.refit_cuda(scene.tri_p0, scene.tri_p1, scene.tri_p2, o, d, t_max, prim)
    want = bvh.refit_plain(scene.tri_p0, scene.tri_p1, scene.tri_p2, o, d, t_max, prim)
    assert bvh.launches["bvh_refit"] == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
    assert int((got[1] >= 0).sum()) > 1000
    bvh.closest_hit_tris(scene, meta, o, d, t_max)
    assert bvh.launches["bvh_refit"] == n0 + 2


# ------------------------------------------------------------ media (K6t, K6 and K12 MEDIA)


def _media_scene(name, cuda, integrator="path", res=24, spp=2, max_depth=None):
    """FOG_SPHERE (tests/medium_cases.py; fog behind a material-less
    interface) or volumetric-caustic on the card."""
    import medium_cases as mc
    from pbrt_tpu_torch.scene import builder as bd, lexer as lx
    from pbrt_tpu_torch.scene.compile import compile_scene

    if name == "fog":
        b = bd.SceneBuilder()
        b.parse_tokens(lx.tokenize(mc.fog_text(0.3, 0.6, 0.3)))
    else:
        b = bd.SceneBuilder().parse_file(str(mc.CAUSTIC))
    b.film["xresolution"] = b.film["yresolution"] = res
    if max_depth is not None:
        b.integrator["maxdepth"] = max_depth
    return compile_scene(b, spp, device=cuda, integrator_override=integrator)


def _segments(scene, meta, n, seed, cuda):
    """n transmittance segments of the scene: random points of its bounds to
    random ends of twice its bounds (so that real surfaces block), random media (-1 or a medium) and wavelengths, a tenth done
    from the start, transmittance below 1."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.cat([scene.tri_p0, scene.tri_p1, scene.tri_p2, scene.sph_center]).cpu()
    lo, hi = pts.min(0).values, pts.max(0).values
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    p1 = lo + (hi - lo) * (2.0 * torch.rand((n, 3), generator=g) - 0.5)
    d = (p1 - o) / (p1 - o).norm(dim=-1, keepdim=True)
    medium = torch.randint(-1, scene.med_g.shape[0], (n,), generator=g)
    lam = 360.0 + 470.0 * torch.rand((n, 4), generator=g)
    trans = 0.2 + 0.8 * torch.rand((n, 4), generator=g)
    done = torch.rand(n, generator=g) < 0.1
    t_max = torch.where(done, 0.0, (o - p1).norm(dim=-1) * (1.0 - 1e-3))
    return [x.to(cuda) for x in (o, d, p1, medium, lam, trans, done, t_max)]


@pytest.mark.parametrize("name", ["fog", "caustic"])
def test_transmit_hop_kernel_matches_plain(cuda, name):
    """K6t (csrc/transmit.cu) against transmit_hop_plain hop by hop over the
    closest hits of 2^16 random segments of the scene, the hop loop run to
    MAX_HOPS: every output bit-exact on every lane (the card's torch.exp is
    the kernel's expf); one launch a hop; interfaces crossed and surfaces
    blocking on some lanes."""
    from pbrt_tpu_torch.accel import dispatch
    from pbrt_tpu_torch.integrators import path

    scene, meta = _media_scene(name, cuda)
    o, d, p1, medium, lam, trans, done, t_max = _segments(scene, meta, 1 << 16, 3, cuda)
    n0 = path.launches["transmit_hop"]
    crossed = blocked = 0
    for _ in range(path.MAX_HOPS):
        hit = dispatch.intersect(scene, meta, o, d, t_max)
        want = path.transmit_hop_plain(scene, hit, o, d, p1, medium, lam, trans, done)
        got = path.transmit_hop_cuda(scene, hit, o.clone(), d, p1, medium.clone(), lam,
                                     trans.clone(), done.clone())
        for k, x, y in zip(("o", "medium", "trans", "done", "t_max"), got, want):
            assert torch.equal(x, y), (k, int((x != y).sum()))
        crossed += int((hit.valid & (hit.mat < 0) & ~done).sum())
        blocked += int((hit.valid & (hit.mat >= 0) & ~done).sum())
        o, medium, trans, done, t_max = want
    assert path.launches["transmit_hop"] == n0 + path.MAX_HOPS
    assert blocked > 0 and (crossed > 0 or name == "caustic")


@pytest.mark.parametrize("name", ["fog", "caustic"])
def test_path_step_vol_kernels_match_plain(cuda, name):
    """The VOLUMETRIC K6 kernels (path_shade_vol, path_bsdf_vol,
    path_resolve_vol) and K6t against the plain parts over three bounces of
    the scene's 24^2 x 2 camera lanes (FOG_SPHERE) or 2^16 synthetic lanes in
    and out of the fog (volumetric-caustic), each bounce from the plain
    chain's state: the draws (sampler state and dimension), the masks
    (active, specular, the NEE lanes), the medium and depth bit-exact on
    every lane, the ray counts equal, the float fields to path_cases'
    criteria; each kernel launched once a bounce, K6t MAX_HOPS times, the
    non-volumetric shading kernels not at all."""
    import medium_cases as mc
    import path_cases as pc
    from pbrt_tpu_torch.accel import dispatch
    from pbrt_tpu_torch.integrators import path

    scene, meta = _media_scene(name, cuda)
    assert meta.volumetric
    if name == "fog":
        state = pc.camera_state(scene, meta)
        state = state._replace(medium=torch.full_like(state.smp.dim, -1),
                               trans_pdf=torch.ones_like(state.L))
    else:
        state = mc.synthetic_fog_lanes(scene, meta, 1 << 16, 5)
    scattered = 0
    for bounce in range(3):
        st, t_max = path.rr_plain(meta, state, "independent", 2)
        hit = dispatch.intersect(scene, meta, st.o, st.d, t_max)
        n0 = dict(path.launches)
        kp = path.shade_vol_plain(scene, meta, st, hit, "independent", 2)
        kc = path.shade_vol_cuda(scene, meta, st, hit, "independent", 2)
        (sp, shp, pp, _), (sc, shc, pc_, _) = kp, kc
        rep = pc.Report()
        pc.compare_state(rep, sc, sp, pc.STATE_FLOATS + ("trans_pdf",))
        rep.exact("medium", sc.medium, sp.medium)
        rep.exact("nee", pc_.mask, pp.mask)
        assert rep.ok(), (bounce, str(rep))
        for k in ("smp_state", "smp_dim"):
            x, y = getattr(sc.smp, k[4:]), getattr(sp.smp, k[4:])
            assert torch.equal(x, y), (bounce, k)
        for k in ("active", "specular", "depth", "medium"):
            assert torch.equal(getattr(sc, k), getattr(sp, k)), (bounce, k)
        assert torch.equal(pc_.mask, pp.mask)
        m = pp.mask
        assert torch.equal(shc.medium[m], shp.medium[m]) and torch.equal(pc_.mis[m][:, 1] < 0,
                                                                          pp.mis[m][:, 1] < 0)
        trans = path.transmittance(scene, meta, shp.o, shp.d, shp.p, shp.medium, sp.lam,
                                   shp.t_max)
        rp = path.resolve_vol_plain(sp, pp, trans)
        rc = path.resolve_vol_cuda(sp, pp, trans)
        assert int(rc.n_shadow) == int(rp.n_shadow)
        rep = pc.Report()
        rep.near("L", rc.L, rp.L)
        assert rep.ok(), (bounce, str(rep))
        d = {k: path.launches[k] - n0[k] for k in n0}
        assert d == dict(path_rr=0, path_shade=0, path_bsdf=0, path_coat=0, path_resolve=0,
                         path_shade_lane=0, transmit_hop=path.MAX_HOPS, path_shade_vol=1,
                         path_bsdf_vol=1, path_resolve_vol=1), d
        scattered += int((sp.active & (sp.medium >= 0)).sum())
        state = rp
    assert scattered > 0


def test_path_step_vol_kernels_without_lights_match_plain(cuda):
    """path_shade_vol and path_bsdf_vol on FOG_SPHERE without its light
    against the plain parts over three bounces of 24^2 x 2 camera lanes:
    the lanes that scatter in the fog take the NEE draws with no light to
    pick (the kernel reads no light row); the draws, masks, medium and depth
    bit-exact, the floats to path_cases' criteria, no shadow segments."""
    import medium_cases as mc
    import path_cases as pc
    from pbrt_tpu_torch.accel import dispatch
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.scene import builder as bd, lexer as lx
    from pbrt_tpu_torch.scene.compile import compile_scene

    b = bd.SceneBuilder()
    b.parse_tokens(lx.tokenize(mc.fog_text(0.3, 0.6, 0.3, lights=False)))
    b.film["xresolution"] = b.film["yresolution"] = 24
    scene, meta = compile_scene(b, 2, device=cuda, integrator_override="path")
    assert meta.volumetric and scene.lt_pmf.shape[0] == 0
    state = pc.camera_state(scene, meta)
    state = state._replace(medium=torch.full_like(state.smp.dim, -1),
                           trans_pdf=torch.ones_like(state.L))
    scattered = 0
    for bounce in range(3):
        st, t_max = path.rr_plain(meta, state, "independent", 2)
        hit = dispatch.intersect(scene, meta, st.o, st.d, t_max)
        sp, shp, pp, _ = path.shade_vol_plain(scene, meta, st, hit, "independent", 2)
        sc, shc, pc_, _ = path.shade_vol_cuda(scene, meta, st, hit, "independent", 2)
        assert shp is shc is pp is pc_ is None
        rep = pc.Report()
        pc.compare_state(rep, sc, sp, pc.STATE_FLOATS + ("trans_pdf",))
        assert rep.ok(), (bounce, str(rep))
        assert torch.equal(sc.smp.state, sp.smp.state) and torch.equal(sc.smp.dim, sp.smp.dim)
        for k in ("active", "specular", "depth", "medium"):
            assert torch.equal(getattr(sc, k), getattr(sp, k)), (bounce, k)
        assert float(sc.L.abs().max()) == 0.0
        scattered += int((sp.active & (sp.medium >= 0) & (sp.prev_ns == 0).all(-1)).sum())
        state = sp
    assert scattered > 0


@pytest.mark.parametrize("lanes, depth", [(1000, 7), (8192, 7), (500, 8)],
                         ids=["1000-depth 7", "8192-depth 7", "500-depth 8"])
def test_bdpt_media_kernel_matches_plain(cuda, lanes, depth):
    """K12's MEDIA instantiations on a wave of volumetric-caustic lanes,
    no multiple of the tile but 8192 (the MLT shape), at max depth 7 (two
    staged buffers) and 8 (one): bdpt_connect_rays' segments (origin,
    direction, first hop's t_max, end, start medium) and the attempt count
    bit-exact with connect_segments_plain's; the whole stage with the
    transmittance hop loop against connect_all_plain to tests/bdpt_cases.py's
    criterion; medium vertices in the walks."""
    from bdpt_cases import compare, require_agreement, wave_inputs
    from pbrt_tpu_torch.integrators import bdpt

    scene, meta = _media_scene("caustic", cuda, integrator="bdpt", res=64, spp=2,
                               max_depth=depth)
    pix = torch.arange(64 * 64, device=cuda).repeat(2)[:lanes]
    sample = torch.arange(2, device=cuda).repeat_interleave(64 * 64)[:lanes]
    wave = wave_inputs(scene, meta, pix, sample)
    light_vs, cam_vs, lam, table, samples = wave
    assert any(bool((v.vtype == bdpt.VT_MEDIUM).any()) for v in cam_vs + light_vs)
    st = bdpt.strategy_table(table, cuda)
    ft = bdpt.field_table(cam_vs, light_vs, table, bdpt.contiguous_samples(samples))
    got = bdpt.connect_segments_cuda(scene, ft, st)
    want = bdpt.connect_segments_plain(scene, light_vs, cam_vs, table, samples)
    for k, x, y in zip(("o", "d", "t_max", "attempts", "p", "medium"), got, want[1:]):
        assert torch.equal(x.reshape(-1), y.reshape(-1)), k
    require_agreement(compare(scene, meta, *wave))


def test_volumetric_renders_on_card_match_cpu(cuda):
    """volumetric-caustic at 16^2 through the path integrator (4 spp) and
    BDPT (2 spp), max depth 4, on the card and on the CPU: the VOLUMETRIC
    kernels, K6t and K12's MEDIA instantiations launched; the images on
    4x4 block means to tests/test_parity.py's criterion, ray counts within
    0.1 %."""
    import medium_cases as mc
    from layered_cases import blocks
    from pbrt_tpu_torch.integrators import bdpt, path
    from pbrt_tpu_torch.scene import builder as bd
    from pbrt_tpu_torch.scene.compile import compile_scene
    from test_torch_render import _check

    for integrator, spp in (("path", 4), ("bdpt", 2)):
        b = bd.SceneBuilder().parse_file(str(mc.CAUSTIC))
        b.film["xresolution"] = b.film["yresolution"] = 16
        b.integrator["maxdepth"] = 4
        b.filter = {"type": "box"}
        imgs, counts = [], []
        for dev in (cuda, "cpu"):
            scene, meta = compile_scene(b, spp, device=dev, integrator_override=integrator)
            n0 = dict(path.launches), dict(bdpt.launches)
            img, stats = render(scene, meta, device=dev, return_stats=True)
            imgs.append(img.cpu().numpy())
            counts.append(stats["closest"] + stats["shadow"])
            if dev == cuda:
                assert path.launches["transmit_hop"] > n0[0]["transmit_hop"]
                if integrator == "path":
                    assert path.launches["path_shade_vol"] > n0[0]["path_shade_vol"]
                    assert path.launches["path_shade"] == n0[0]["path_shade"]
                else:
                    assert bdpt.launches["bdpt_connect_weight"] > n0[1]["bdpt_connect_weight"]
        _check(blocks(imgs[0], 4), blocks(imgs[1], 4), f"volumetric-caustic {integrator}")
        assert abs(counts[0] - counts[1]) <= 1e-3 * counts[1], counts



# ------------------------------------------------- K13: textures and mix

def _textured_scene(dev, tmp_path):
    """tests/texture_cases.py's scene (every node type, mapping, wrap mode,
    textured slot and a mix) compiled on `dev`."""
    import texture_cases as tc
    from pbrt_tpu_torch.scene import builder as bd, lexer as lx
    from pbrt_tpu_torch.scene.compile import compile_scene

    b = bd.SceneBuilder()
    b.parse_tokens(lx.tokenize(tc.scene_text(tmp_path)))
    return compile_scene(b, device=dev)


@pytest.mark.parametrize("footprints", [False, True])
@pytest.mark.parametrize("lanes", [1000, 1 << 17])
def test_tex_kernel_matches_plain(cuda, tmp_path, footprints, lanes):
    """K13 (csrc/texture.cu) against eval_lanes_plain on texture_cases'
    synthetic lanes, with footprints and without: materials (mix resolved)
    and slot masks bit for bit, the values within texture_cases' criterion;
    one launch."""
    import texture_cases as tc
    from pbrt_tpu_torch.textures import textures as tx

    scene, meta = _textured_scene(cuda, tmp_path)
    L = tc.synthetic_lanes(scene, lanes, 5, footprints, cuda)
    args = (scene, L["lanes"], L["mat"], L["p"], L["wo"], L["uv"], L["ns"], L["lam"], L["duv"])
    n0 = tx.launches["tex_eval"]
    got = tx.eval_lanes(*args)
    assert tx.launches["tex_eval"] == n0 + 1
    res = tc.compare(got, tx.eval_lanes_plain(*args))
    assert tc.agree(res), res
    assert bool((got.mat != L["mat"]).any()) and res["slots"] > 0


def test_tex_kernel_wrapper_refuses_cpu_tensors(cuda, tmp_path):
    """The kernel's wrapper takes CUDA tensors only: no quiet plain route."""
    import texture_cases as tc
    from pbrt_tpu_torch.textures import textures as tx

    scene, _ = _textured_scene(cuda, tmp_path)
    L = tc.synthetic_lanes(scene, 64, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tx.eval_lanes_cuda(scene, L["lanes"], L["mat"], L["p"], L["wo"], L["uv"], L["ns"],
                           L["lam"])


def test_textured_shading_kernels_match_plain(cuda, tmp_path):
    """K6 on a textured bounce (path_shade and path_bsdf reading K13's
    overrides) against the plain parts (shade_plain with the plain K13) on
    path_cases' synthetic state over texture_cases' scene: path_cases'
    criteria, draws and masks bit-exact; K13 launched by shade_cuda."""
    import path_cases as pc
    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.textures import textures as tx

    scene, meta = _textured_scene(cuda, tmp_path)
    assert meta.textured
    state = pc.synthetic_state(scene, meta, 1 << 16, 9)
    n0 = tx.launches["tex_eval"]
    kern, plain = _path_parts()
    reps, seen = pc.compare_parts(scene, meta, state, "independent", 2, kern, plain,
                                  pc.shade_parts())
    for name, rep in reps.items():
        assert rep.ok(), (name, str(rep))
    assert tx.launches["tex_eval"] > n0 and seen["hits"] > 0


def test_textured_renders_on_card_match_cpu(cuda, tmp_path):
    """The textured cornell-mesh (levels 2) 32^2 x 8 with the path integrator
    (K13 max_depth times a wave) and BDPT (K13 2 max_depth + 1 times a wave,
    once a walk step) on the card against the CPU, ray counts within 1 %:
    with the mix ball made its diffuse ("matte"), tests/test_parity.py's
    criterion per pixel; as it is, on 4x4 block means (the mix hashes the
    bits of the hit point and wo, and a direction the kernels round an ulp
    apart from the plain step's picks the other material, so those paths go
    on independently); the untextured cornell-mesh launches no K13."""
    from layered_cases import blocks
    from pbrt_tpu_torch.scene import builder as bd, lexer as lx
    from pbrt_tpu_torch.scene.compile import compile_scene
    from pbrt_tpu_torch.textures import textures as tx

    text = ts.textured_cornell_mesh_pbrt(levels=2, image_dir=tmp_path, res=32, spp=8)
    mix_ball = '\n  NamedMaterial "ball-mix"'
    assert text.count(mix_ball) == 1
    for mix in (False, True):
        b = bd.SceneBuilder()
        b.parse_tokens(lx.tokenize(text if mix else text.replace(mix_ball,
                                                                 '\n  NamedMaterial "matte"')))
        b.filter = {"type": "box"}
        for integ in ("path", "bdpt"):
            scene, meta = compile_scene(b, device=cuda, integrator_override=integ)
            n0 = tx.launches["tex_eval"]
            img_gpu, st_gpu = render(scene, meta, return_stats=True)
            waves = sum(1 for _ in rd.wave_lanes(32 * 32, meta.spp, "cpu"))
            assert tx.launches["tex_eval"] - n0 == (meta.max_depth if integ == "path" else
                                                     (2 * meta.max_depth + 1) * waves)
            img_cpu, st_cpu = render(scene, meta, device="cpu", return_stats=True)
            img_gpu, img_cpu = img_gpu.cpu().numpy(), img_cpu.numpy()
            n_gpu, n_cpu = sum(st_gpu.values()), sum(st_cpu.values())
            assert abs(n_gpu - n_cpu) <= 1e-2 * n_cpu, (integ, mix)
            a, b_ = (blocks(img_gpu, 4), blocks(img_cpu, 4)) if mix else (img_gpu, img_cpu)
            assert float((np.abs(a - b_) > 5e-3 + 0.05 * np.abs(b_)).mean()) < 0.005, (integ, mix)
            assert abs(img_gpu.mean() - img_cpu.mean()) < 0.01 * img_cpu.mean(), (integ, mix)
    scene, meta = ts.cornell_mesh(res=16, spp=1, levels=2, device=cuda)
    n0 = tx.launches["tex_eval"]
    render(scene, meta)
    assert tx.launches["tex_eval"] == n0


@pytest.mark.parametrize("integrator", ["path", "bdpt", "mltpath", "mlt"])
def test_textured_dense_frames_on_card(cuda, tmp_path, integrator):
    """texture_cases' scene (the dense route) through render() on the card
    with every integrator family: finite and lit; K13 launched by the path
    integrator's bounces (mltpath's evaluations too) and by BDPT's walk
    steps, 2 max_depth + 1 a wave (MLT over BDPT's evaluations too)."""
    import texture_cases as tc
    from pbrt_tpu_torch.integrators import mlt
    from pbrt_tpu_torch.scene import builder as bd, lexer as lx
    from pbrt_tpu_torch.scene.compile import compile_scene
    from pbrt_tpu_torch.textures import textures as tx

    b = bd.SceneBuilder()
    b.parse_tokens(lx.tokenize(tc.scene_text(tmp_path)))
    b.film["xresolution"] = b.film["yresolution"] = 16
    scene, meta = compile_scene(b, device=cuda, integrator_override=integrator)
    assert meta.textured and scene.bvh_rows.shape[0] == 0
    n0 = tx.launches["tex_eval"]
    if integrator.startswith("mlt"):
        meta = dataclasses.replace(meta, mutations_per_pixel=8)
        img = mlt.render_mlt(scene, meta, n_chains=1024, n_bootstrap=4096, device=cuda)[0]
    else:
        img = render(scene, meta)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    launched = tx.launches["tex_eval"] - n0
    assert launched > 0
    if integrator == "bdpt":
        waves = sum(1 for _ in rd.wave_lanes(16 * 16, meta.spp, "cpu"))
        assert launched == (2 * meta.max_depth + 1) * waves, launched
