"""The counter convention of FedZO's flat route, in plain torch int32 ops.

A direction element is a pure function of a client's key words (k0, k1),
the direction index n and the flat parameter index i: the two output words
of Threefry-2x32 (20 rounds) on the counter (n, i) under the key, turned
into one standard normal by Box-Muller on their top 24 bits:

    u1 = (b0 >> 8)·2^-24 + 2^-25,  u2 = (b1 >> 8)·2^-24,
    v_n[i] = sqrt(-2·ln u1)·cos(2π·u2)        (float32 throughout)

Threefry-2x32 is Salmon et al.'s (SC'11) with the key schedule of Random123
(the third key word k0 ^ k1 ^ 0x1BD11BDA, injections every four rounds),
which is also jax's ``threefry2x32``. A key split takes the counter (0, i)
and keeps both words as the i-th key.

The words live in int32 tensors holding uint32 bit patterns: an int32 add
wraps modulo 2^32 as the uint32 add does, and a rotate masks the
arithmetic right shift's sign bits. This is a frozen, independent copy for
the benchmark's reference: it imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TWO_PI_F32 = 6.2831854820251465          # float32(2π), exact in a double
# elements of one chunk of a direction: the int32 state, its rotate
# temporary and the float32 stages stay a few tens of MiB, about the size
# of the card's L2
CHUNK = 1 << 22


def _i32(w: int) -> int:
    """A uint32 word as the int32 with its bit pattern."""
    w &= MASK32
    return w - (1 << 32) if w >= 1 << 31 else w


def _rotl_(x, r, tmp):
    """x ← rotl32(x, r) in place (``tmp`` a scratch tensor like x)."""
    torch.bitwise_left_shift(x, r, out=tmp)
    x.bitwise_right_shift_(32 - r)
    x.bitwise_and_((1 << r) - 1)
    x.bitwise_or_(tmp)


def threefry_words(k0: int, k1: int, c0: int, c1, tmp=None):
    """Both output words of Threefry-2x32 under key (k0, k1) on counters
    (c0, c1): ``c0`` an int, ``c1`` an int32 tensor of uint32 patterns.
    Returns two new int32 tensors shaped like ``c1``."""
    ks = (k0 & MASK32, k1 & MASK32, (k0 ^ k1 ^ PARITY) & MASK32)
    x1 = c1 + _i32(ks[1])
    x0 = torch.full_like(c1, _i32(c0 + ks[0]))
    tmp = torch.empty_like(c1) if tmp is None else tmp
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0.add_(x1)
            _rotl_(x1, r, tmp)
            x1.bitwise_xor_(x0)
        x0.add_(_i32(ks[(i + 1) % 3]))
        x1.add_(_i32(ks[(i + 2) % 3] + i + 1))
    return x0, x1


def split(k0: int, k1: int, num: int):
    """Key i of a split of (k0, k1) into ``num`` keys, as a list of (k0,
    k1) int pairs: both words of Threefry on the counter (0, i)."""
    c1 = torch.arange(num, dtype=torch.int64).to(torch.int32)
    x0, x1 = threefry_words(k0, k1, 0, c1)
    return [(int(a) & MASK32, int(b) & MASK32)
            for a, b in zip(x0.tolist(), x1.tolist())]


def normal_from_words(b0, b1):
    """Box-Muller on two int32 word tensors -> float32 standard normals."""
    u1 = b0.bitwise_right_shift(8).bitwise_and_(0xFFFFFF).to(torch.float32)
    u1.mul_(2.0 ** -24).add_(2.0 ** -25)
    u2 = b1.bitwise_right_shift(8).bitwise_and_(0xFFFFFF).to(torch.float32)
    u2.mul_(2.0 ** -24).mul_(TWO_PI_F32)
    return u1.log_().mul_(-2.0).sqrt_().mul_(u2.cos_())


def direction(k0: int, k1: int, n: int, count: int, *, device,
              out=None, chunk: int = CHUNK):
    """v_n[0:count] of key (k0, k1) as float32 ``[count]`` on ``device``,
    built chunk by chunk into ``out`` (allocated when None)."""
    if out is None:
        out = torch.empty(count, dtype=torch.float32, device=device)
    step = min(chunk, count)
    tmp = torch.empty(step, dtype=torch.int32, device=device)
    for start in range(0, count, step):
        stop = min(start + step, count)
        c1 = torch.arange(start, stop, dtype=torch.int32, device=device)
        b0, b1 = threefry_words(k0, k1, n, c1, tmp[:stop - start])
        out[start:stop] = normal_from_words(b0, b1)
    return out


def sq_norm(v, chunk: int = 1 << 24) -> float:
    """‖v‖² of a float32 vector, each chunk's squares summed in float64."""
    total = torch.zeros((), dtype=torch.float64, device=v.device)
    for start in range(0, v.numel(), chunk):
        part = v[start:start + chunk].double()
        total += torch.dot(part, part)
    return float(total)


def inv_norm(v) -> float:
    """1/‖v‖ of a float32 direction (the sphere estimator's factor)."""
    return 1.0 / (math.sqrt(sq_norm(v)) + 1e-30)
