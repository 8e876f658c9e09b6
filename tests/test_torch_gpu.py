"""The port's kernels against their plain versions on an NVIDIA GPU. These
tests need the card and skip without one; they import neither jax nor
pbrt_tpu, so they run where only PyTorch is installed:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.accel import bvh
from pbrt_tpu_torch.film import film as filmlib, film_kernel
from pbrt_tpu_torch.geometry import intersect as ix
from pbrt_tpu_torch.integrators.render import render
from pbrt_tpu_torch.sampling import samplers
from pbrt_tpu_torch.scene import testscenes as ts
from pbrt_tpu_torch.utils.math import INFINITY

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA and Triton kernels have no CPU mode)")
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


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_kernel_matches_plain(cuda, any_hit):
    scene, meta = ts.cornell_mesh(res=32, spp=1, levels=4, device=cuda)
    o, d, t_max = (x.to(cuda) for x in _rays(scene, 8192, 5))
    if any_hit:
        t_max = torch.where(t_max > 0, torch.rand(8192, device=cuda) * 400.0, 0.0)
    ov0 = int(bvh.overflow_counter(cuda).item())
    tk, pk = bvh.traverse_cuda(scene.bvh_rows, meta.bvh_nint, meta.bvh_depth, o, d, t_max,
                               any_hit)
    tp, pp = bvh.traverse_plain(scene.bvh_rows, meta.bvh_nint, o, d, t_max, any_hit)
    assert torch.equal(pk >= 0, pp >= 0)
    assert int(bvh.overflow_counter(cuda).item()) == ov0
    if not any_hit:
        differ = (pk != pp) & (pp >= 0)
        for p in (pk, pp):          # differing winners must be verified ties
            pc = p[differ]
            t, _, h = ix.intersect_tri_lanes(o[differ], d[differ], t_max[differ],
                                             scene.tri_p0[pc], scene.tri_p1[pc],
                                             scene.tri_p2[pc])
            assert bool(h.all())
        same = (pk == pp) & (pp >= 0)
        assert torch.allclose(tk[same], tp[same], rtol=1e-6)


def test_film_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(3)
    n = 20000
    pix = torch.randint(0, 64, (n,), generator=g)
    L = torch.rand((n, 4), generator=g) * 4.0
    lam = 360.0 + 470.0 * torch.rand((n, 4), generator=g)
    lam[:4] = torch.tensor([359.4, 360.5, 829.5, 830.6])
    pdf = 0.0005 + 0.005 * torch.rand((n, 4), generator=g)
    pdf[::29, 2] = 0.0
    L[::31, 1] = float("nan")
    w = torch.rand(n, generator=g) * 2.0 - 0.4
    args = [x.to(cuda) for x in (pix, L, lam, pdf, w)]
    fk, fp = filmlib.new_film((8, 8), cuda), filmlib.new_film((8, 8), cuda)
    film_kernel.add_samples_triton(fk.rgb_sum, fk.weight_sum, *args)
    film_kernel.add_samples_plain(fp.rgb_sum, fp.weight_sum, *args)
    scale = float(fp.rgb_sum.abs().max())
    assert torch.allclose(fk.rgb_sum, fp.rgb_sum, rtol=1e-5, atol=1e-6 * scale)
    assert torch.allclose(fk.weight_sum, fp.weight_sum, rtol=1e-5, atol=1e-5)


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
    scene, meta = ts.cornell_mesh(res=24, spp=2, levels=3, device=cuda, filter_kind="box")
    counts0 = dict(bvh.launches)
    img_gpu = render(scene, meta).cpu().numpy()
    img_cpu = render(scene, meta, device="cpu").numpy()
    assert all(bvh.launches[k] > counts0[k] for k in counts0)
    err = np.abs(img_gpu - img_cpu)
    assert float((err > 5e-3 + 0.05 * np.abs(img_cpu)).mean()) < 0.005
    assert abs(img_gpu.mean() - img_cpu.mean()) < 0.01 * img_cpu.mean()
