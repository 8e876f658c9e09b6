"""The jump ahead that K12m-a (csrc/mlt.cu) mirrors, on the CPU; torch only.

A chain's lane group draws its stream out of order: lane l of G jumps to
draw 1 + 2 l and then 2 G draws at a time. `strided_chain_uniforms` draws
that way in plain torch and must give chain_uniforms's bits at every lane
count the kernel may take and at D of mltpath (66), a group's tail (67),
mlt at depth 7 (160) and volumetric MLT (16 + 40 (7 + 2) = 376). The jump
table, (A_k, S_k) with state -> A_k state + inc S_k, must reach the state
that pcg32 advance reaches.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.integrators import mlt
from pbrt_tpu_torch.sampling import rng

R = 96


@pytest.mark.parametrize("D", [66, 67, 160, 376])
@pytest.mark.parametrize("G", [16, 32])
def test_strided_chain_uniforms_bit_exact(G, D):
    want = mlt.chain_uniforms(11, 4, R, D)
    got = mlt.strided_chain_uniforms(11, 4, R, D, G)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("k", [0, 1, 2, 63, 64, 321])
def test_jump_matches_advance(k):
    r = np.random.default_rng(k)
    state = torch.from_numpy(r.integers(-2 ** 63, 2 ** 63 - 1, 256, dtype=np.int64))
    inc = torch.from_numpy(r.integers(-2 ** 63, 2 ** 63 - 1, 256, dtype=np.int64)) | 1
    a, s = rng.jump(k)
    got = state * rng.i64(a) + inc * rng.i64(s)
    want = rng.advance(rng.Pcg32(state, inc), torch.full_like(state, k)).state
    assert torch.equal(got, want)
    if k <= 64:                                 # and k single steps
        stepped = state
        for _ in range(k):
            stepped, _ = rng.step(stepped, inc)
        assert torch.equal(got, stepped)


@pytest.mark.parametrize("G", [16, 32])
def test_lane_jumps_are_the_kernels_table(G):
    """Lane l starts 1 + 2 l steps on and steps 2 G at a time."""
    firsts, step = mlt.lane_jumps(G)
    assert firsts == [rng.jump(1 + 2 * lane) for lane in range(G)]
    assert step == rng.jump(2 * G)
    a1, s1 = rng.jump(1)
    assert (a1, s1) == (rng.PCG32_MULT, 1)
