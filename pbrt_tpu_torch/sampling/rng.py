"""PCG32, MixBits and MurmurHash64A on native 64-bit integers, bit-exact
with pbrt_tpu/sampling/rng.py (reference util/rng.h:15-68, util/hash.h).

A u64 value lives in an int64 tensor holding the same bits: addition and
multiplication wrap modulo 2^64 exactly as on unsigned integers, and the
right shift, which torch performs arithmetically on int64, is masked to a
logical one in `shr`. A u32 value lives in an int64 tensor in [0, 2^32).
The JAX package's two-limb u32 arithmetic was the TPU's lack of 64-bit
integers and is not ported.
"""
from typing import NamedTuple

import torch

M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def i64(v):
    """Python int (any width) -> the int64 with the same low 64 bits."""
    v &= _M64
    return v - (1 << 64) if v >= (1 << 63) else v


def shr(x, n):
    """Logical right shift of a u64-in-int64 tensor by a static n in 1..63."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def mix_bits(v):
    """SplitMix64 finalizer (reference rng.h:15-22)."""
    v = v ^ shr(v, 31)
    v = v * i64(0x7FB5D329728EA185)
    v = v ^ shr(v, 27)
    v = v * i64(0x81DADEF4BC2DD44D)
    return v ^ shr(v, 33)


# ----------------------------------------------------------------- PCG32

PCG32_MULT = 0x5851F42D4C957F2D
ONE_MINUS_EPSILON_F32 = 0.99999994


class Pcg32(NamedTuple):
    state: torch.Tensor   # (...,) u64 in int64
    inc: torch.Tensor


def step(state, inc):
    """One PCG32 step -> (new state, u32 output in int64)."""
    new_state = state * i64(PCG32_MULT) + inc
    xorshifted = shr(shr(state, 18) ^ state, 27) & M32
    rot = shr(state, 59)
    out = ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & M32
    return new_state, out


def set_sequence(seq, offset):
    """reference rng.h set_sequence(sequenceIndex, offset)."""
    inc = (seq << 1) | 1
    state, _ = step(torch.zeros_like(seq), inc)
    state, _ = step(state + offset, inc)
    return Pcg32(state, inc)


def from_seed(seq):
    """set_sequence(seq, MixBits(seq)) (reference rng.h:44-46)."""
    return set_sequence(seq, mix_bits(seq))


def uniform_float(state, inc):
    """Uniform in [0, 1): u32 * 2^-32 in float32, clamped below 1."""
    state, bits = step(state, inc)
    f = bits.to(torch.float32) * 2.3283064365386963e-10
    return state, torch.clamp(f, max=ONE_MINUS_EPSILON_F32)


def _advance_mults():
    """cur_mult of every round of the pcg32 advance: lane independent."""
    out, m = [], PCG32_MULT
    for _ in range(64):
        out.append(m)
        m = (m * m) & _M64
    return out


_ADV_MULTS = _advance_mults()


def advance(rng: Pcg32, delta):
    """Jump the stream forward by delta (u64 tensor) in 64 rounds (pcg32
    advance). The multiplier chain is lane independent, so it is folded
    into host integers; only the increment chain runs per lane."""
    acc_mult = torch.ones_like(delta)
    acc_plus = torch.zeros_like(delta)
    cur_plus = rng.inc
    for i, cur_mult in enumerate(_ADV_MULTS):
        bit = (shr(delta, i) if i else delta) & 1 == 1
        acc_mult = torch.where(bit, acc_mult * i64(cur_mult), acc_mult)
        acc_plus = torch.where(bit, acc_plus * i64(cur_mult) + cur_plus, acc_plus)
        cur_plus = cur_plus * i64(cur_mult + 1)
    return Pcg32(acc_mult * rng.state + acc_plus, rng.inc)


def jump(k):
    """k PCG32 steps as one affine map -> (A_k, S_k), Python ints: from
    state s the stream reaches A_k s + inc S_k (mod 2^64), A_k = MULT^k and
    S_k = sum of MULT^i over i < k; the same for every stream (csrc/mlt.cu
    `jump`)."""
    a, s = 1, 0
    for _ in range(k):
        a, s = (a * PCG32_MULT) & _M64, (s * PCG32_MULT + 1) & _M64
    return a, s


# ------------------------------------------------------------ MurmurHash64A

_MURMUR_M = 0xC6A4A7935BD1E995


def murmur64a_u32_words(words, seed=0):
    """MurmurHash64A of a little-endian buffer of 4-byte words (reference
    util/hash.h:10-70). `words`: list of u32-in-int64 tensors."""
    m = i64(_MURMUR_M)
    n = len(words)
    h = torch.full_like(words[0], i64(seed ^ ((4 * n * _MURMUR_M) & _M64)))
    i = 0
    while i + 2 <= n:
        k = (words[i + 1] << 32) | words[i]
        k = k * m
        k = k ^ shr(k, 47)
        k = k * m
        h = (h ^ k) * m
        i += 2
    if i < n:
        h = (h ^ words[i]) * m
    h = h ^ shr(h, 47)
    h = h * m
    return h ^ shr(h, 47)


def hash_int(x):
    """pbrt::hash(int) (util/hash.h:73-80)."""
    return murmur64a_u32_words([x])


def hash_2int(x, y):
    """pbrt::hash(int, int)."""
    return murmur64a_u32_words([x, y])
