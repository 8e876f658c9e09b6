"""Independent and stratified samplers on per-lane PCG32 streams, bit-exact
with pbrt_tpu/sampling/samplers.py (reference samplers/independent.h:7-38,
samplers/stratified.h:8-70).

A `Sampler` is a record of (R,) int64 lanes: the PCG32 state and increment
plus the (pixel, sample, dimension) counters the stratified variant needs.
The kind is a host string. Masked draws advance only the lanes where the
mask is true, so every lane's stream stays aligned with the reference's
conditional draws.
"""
from typing import NamedTuple

import torch

from pbrt_tpu_torch.sampling import rng as prng

M32 = prng.M32


class Sampler(NamedTuple):
    state: torch.Tensor   # (R,) PCG32 state (u64 in int64)
    inc: torch.Tensor     # (R,) PCG32 stream
    pixel: torch.Tensor   # (R,) u32
    sample: torch.Tensor  # (R,) u32
    dim: torch.Tensor     # (R,) u32


def start_pixel_sample(pixel_idx, sample_idx, dimension=0):
    """pixel_idx, sample_idx: (R,) int -> Sampler lanes
    (set_sequence(hash(pixel)); advance(sample * 65536 + dimension))."""
    px = pixel_idx.long() & M32
    r = prng.from_seed(prng.hash_int(px))
    si = sample_idx.long() & M32
    r = prng.advance(r, (si << 16) + dimension)
    return Sampler(state=r.state, inc=r.inc, pixel=px, sample=si,
                   dim=torch.full_like(px, dimension))


def _masked(s: Sampler, state, dim, mask):
    if mask is None:
        return s._replace(state=state, dim=dim)
    return s._replace(state=torch.where(mask, state, s.state),
                      dim=torch.where(mask, dim, s.dim))


def get_1d(s: Sampler, mask=None, kind="independent", spp=0):
    state, u = prng.uniform_float(s.state, s.inc)
    if kind == "stratified":
        h = prng.hash_2int(s.pixel, s.dim) & M32
        stratum = permutation_element(s.sample, spp, h)
        u = (stratum.to(torch.float32) + u) / spp
    elif kind != "independent":
        raise NotImplementedError(f"sampler kind {kind!r}")
    return _masked(s, state, s.dim + 1, mask), u


def get_2d(s: Sampler, mask=None, kind="independent", spp=0):
    state, u1 = prng.uniform_float(s.state, s.inc)
    state, u2 = prng.uniform_float(state, s.inc)
    if kind == "stratified":
        # one stratum for both axes (stratified.h get_2d)
        sqrt_spp = int(round(spp ** 0.5))
        h = prng.hash_2int(s.pixel, s.dim) & M32
        stratum = permutation_element(s.sample, spp, h)
        x = (stratum % sqrt_spp).to(torch.float32)
        y = (stratum // sqrt_spp).to(torch.float32)
        u1 = (x + u1) / sqrt_spp
        u2 = (y + u2) / sqrt_spp
    elif kind != "independent":
        raise NotImplementedError(f"sampler kind {kind!r}")
    return _masked(s, state, s.dim + 2, mask), torch.stack([u1, u2], dim=-1)


def get_pixel_2d(s: Sampler, mask=None, kind="independent", spp=0):
    return get_2d(s, mask, kind, spp)


def permutation_element(i, l, p):
    """Correlated-shuffle permutation (reference util/permutation.h) with
    the rejection loop unrolled 16 times, as in the JAX package.
    i: (R,) u32 index; l: int; p: (R,) u32 hash."""
    l = int(l)
    w = l - 1
    for shift in [1, 2, 4, 8, 16]:
        w |= w >> shift

    def scramble(i):
        i = i ^ p
        i = (i * 0xE170893D) & M32
        i = i ^ (p >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (p >> 8)
        i = (i * 0x0929EB3F) & M32
        i = i ^ (p >> 23)
        i = i ^ ((i & w) >> 1)
        i = (i * (1 | (p >> 27))) & M32
        i = (i * 0x6935FA69) & M32
        i = i ^ ((i & w) >> 11)
        i = (i * 0x74DCB303) & M32
        i = i ^ ((i & w) >> 2)
        i = (i * 0x9E501CC3) & M32
        i = i ^ ((i & w) >> 2)
        i = (i * 0xC860A3DF) & M32
        i = i & w
        return i ^ (i >> 5)

    done = torch.zeros(i.shape, dtype=torch.bool, device=i.device)
    out = i
    cur = i
    for _ in range(16):
        cur = scramble(cur)
        ok = (cur < l) & ~done
        out = torch.where(ok, cur, out)
        done = done | ok
    return ((out + p) & M32) % l
