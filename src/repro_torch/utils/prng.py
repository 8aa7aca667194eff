"""jax-compatible raw Threefry-2x32 keys in PyTorch.

The reference draws every random quantity of a run from one key chain of
raw Threefry keys under ``jax_threefry_partitionable=True``: the per-round
split, the participation permutation, the minibatch rows, the channel draw
and the per-client ZO keys whose words seed the in-kernel directions. This
module reproduces that chain, so a port run from a seed draws the same
integers as the reference:

- ``key(seed)``             -> ``[0, seed]``
- ``split(key, num)``       -> ``[..., num, 2]`` (fold-like split)
- ``fold_in(key, data)``
- ``random_bits(key, shape)`` (32-bit: ``bits1 ^ bits2``)
- ``randint``, ``permutation``, ``uniform``, ``normal``, ``rademacher``,
  ``exponential``

A key is an int64 tensor of shape ``[..., 2]`` holding the two uint32 words
(torch has no uint32 add or shift on the CPU, so every uint32 operation is
an int64 one masked with ``& 0xFFFFFFFF``). Leading dimensions batch keys:
``split`` of ``[M, 2]`` keys gives ``[M, num, 2]``, ``random_bits`` of
``[M, 2]`` keys and ``shape`` gives ``[M, *shape]``.

Integer outputs are bitwise jax's. ``normal`` evaluates XLA's float32
erfinv polynomial, but log1p and the rounding order differ, so a float32
draw agrees within a few ulp; a bfloat16 draw takes one of 128 values (jax
fills the 7 mantissa bits from 8 random bits) and is bitwise jax's.
Keys are host-side control state: they live on the CPU, and the few words a
kernel needs are moved to the card by the caller. The bulk draws
(``random_bits``, ``uniform``, ``normal``) run on the device given by
``device=`` (default: the key's), so a model's init draws its hundreds of
millions of normals on the card; integer results do not depend on the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x):
    return x & MASK32


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, on int64 tensors or Python ints holding
    uint32 values.

    Arguments broadcast against each other; returns the two output words.
    On ints (a single host key's ``split`` or ``fold_in``) it costs no
    tensor operation.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = _u32(c0 + ks[0])
    x1 = _u32(c1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = _u32(x0 + x1)
            x1 = _rotl32(x1, r)
            x1 = x0 ^ x1
        x0 = _u32(x0 + ks[(i + 1) % 3])
        x1 = _u32(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def _one_host_key(k: torch.Tensor) -> bool:
    return k.dim() == 1 and k.device.type == "cpu"


def key(seed: int) -> torch.Tensor:
    """Raw key of ``jax.random.key(seed)`` (threefry): ``[0, seed]``."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64)


def as_key(k) -> torch.Tensor:
    """A key from raw uint32 words (an array, e.g. jax's ``key_data``), as
    int64 ``[..., 2]``."""
    return torch.from_numpy(np.asarray(k).astype(np.uint32).astype(np.int64))


def _words(k, extra_dims: int):
    """The two words of keys ``[..., 2]`` shaped to broadcast against
    ``extra_dims`` trailing sample dimensions."""
    shp = k.shape[:-1] + (1,) * extra_dims
    return k[..., 0].reshape(shp), k[..., 1].reshape(shp)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` under the partitionable (fold-like)
    split: word pair i is ``threefry(k, hi=0, lo=i)``."""
    if _one_host_key(k):
        k0, k1 = k.tolist()
        return torch.tensor([threefry2x32(k0, k1, 0, i) for i in range(num)],
                            dtype=torch.int64).reshape(num, 2)
    k0, k1 = _words(k, 1)
    lo = torch.arange(num, dtype=torch.int64)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``: ``threefry(k, [0, data])``."""
    if _one_host_key(k):
        k0, k1 = k.tolist()
        return torch.tensor(threefry2x32(k0, k1, 0, int(data) & MASK32),
                            dtype=torch.int64)
    x0, x1 = threefry2x32(k[..., 0], k[..., 1], 0, int(data) & MASK32)
    return torch.stack([x0, x1], dim=-1)


def random_bits(k: torch.Tensor, shape, *, device=None) -> torch.Tensor:
    """32-bit ``jax.random.bits``: counters are the row-major iota of
    ``shape`` (high words 0 below 2**32 elements), output ``bits1 ^ bits2``.
    Computed on ``device`` (default: the key's)."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise NotImplementedError("random bits of 2**32 elements or more")
    dev = k.device if device is None else torch.device(device)
    if _one_host_key(k):
        k0, k1 = k.tolist()     # words as ints: no copy to the device
    else:
        k0, k1 = _words(k.to(dev), len(shape))
    lo = torch.arange(size, dtype=torch.int64, device=dev).reshape(shape)
    x0, x1 = threefry2x32(k0, k1, 0, lo)
    return x0 ^ x1


def _mul32(a, b):
    """``a * b mod 2**32`` for uint32 values held in int64 (no overflow)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    return _u32(a_lo * b + (((a_hi * b) & 0xFFFF) << 16))


def randint(k: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` for int32 output.

    ``minval``/``maxval`` are ints or int tensors broadcastable to the
    output ``k.shape[:-1] + shape``. Same double-width modulus as jax:
    two bit draws from ``split(k)``, combined under ``2**32 mod span``.
    """
    shape = tuple(shape)
    ks = split(k, 2)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    minval = torch.as_tensor(minval, dtype=torch.int64)
    maxval = torch.as_tensor(maxval, dtype=torch.int64)
    span = _u32(maxval - minval)
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = (2 ** 16) % span
    mult = _mul32(mult, mult) % span
    off = _u32(_mul32(higher % span, mult) + lower % span) % span
    return (minval + off).to(torch.int32)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: ``ceil(3 ln n / ln(2**32 - 1))``
    stable sorts of ``arange(n)`` on fresh 32-bit keys."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK32)))
    x = torch.arange(n, dtype=torch.int64)
    for _ in range(rounds):
        ks = split(k, 2)
        k, sub = ks[0], ks[1]
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def uniform(k: torch.Tensor, shape, minval=0.0, maxval=1.0, *,
            device=None) -> torch.Tensor:
    """float32 ``jax.random.uniform``: 23 mantissa bits under exponent 0,
    shifted and scaled in float32."""
    bits = random_bits(k, shape, device=device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # the bounds as float32 scalars (a Python scalar reaches the device as
    # a kernel argument; a 0-d tensor would be a copy and a host wait)
    lo, hi = np.float32(minval), np.float32(maxval)
    span, lo = float(hi - lo), float(lo)
    return torch.clamp_min(floats * span + lo, lo)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))
# the bfloat16 constants of jax's draw: nextafter(-1, 0) and sqrt(2), both
# exact in a Python float
_NORMAL_LO_BF16 = -1.0 + 2.0 ** -8
_SQRT2_BF16 = 1.4140625
# Giles' single-precision erfinv coefficients, the polynomial XLA evaluates
# for float32 (w < 5 and w >= 5 branches). torch.erfinv is another
# approximation and lands up to ~90 ulp away from jax; this one within 3.
_ERFINV_LT5 = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_GE5 = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function on (-1, 1), evaluated as XLA does."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    # float32 coefficients as Python scalars: kernel arguments, no copies
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return p * x


def normal(k: torch.Tensor, shape, *, dtype=torch.float32,
           device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape, dtype)``: ``sqrt(2)·erfinv(u)`` with u
    uniform on ``(nextafter(-1, 0), 1)`` in ``dtype``.

    float32: within a few ulp of jax (3 measured on 10^5 draws: log1p and
    rounding order differ from XLA's). bfloat16: bitwise. jax draws 8 bits
    for a dtype of fewer than 8 mantissa bits (the low byte of ``bits1 ^
    bits2``), fills the mantissa with its top 7, and computes in bfloat16:
    u = max(lo, f·bf16(1 − lo) + lo) with ``lo = nextafter(-1, 0)`` =
    -0.99609375 and the span rounded to 2; erfinv in float32 rounded to
    bfloat16 (XLA upcasts it), then the bfloat16 product with bf16(√2). All
    128 values of u agree with jax 0.9.0 (``tests/test_torch_wide.py``)."""
    if dtype == torch.float32:
        u = uniform(k, shape, _NORMAL_LO, 1.0, device=device)
        return erfinv(u) * _SQRT2
    if dtype != torch.bfloat16:
        raise NotImplementedError(f"normal draws in {dtype}: float32 and "
                                  f"bfloat16 are ported")
    bits = random_bits(k, shape, device=device) & 0xFF
    fbits = ((bits >> 1) | 0x3F80).to(torch.int16)
    floats = fbits.view(torch.bfloat16) - 1.0
    # bfloat16 arithmetic with exact bfloat16 scalars (torch rounds each
    # operation to bfloat16, as XLA does here)
    u = torch.clamp_min(floats * 2.0 + _NORMAL_LO_BF16, _NORMAL_LO_BF16)
    return erfinv(u.float()).to(torch.bfloat16) * _SQRT2_BF16


def exponential(k: torch.Tensor, shape, *, device=None) -> torch.Tensor:
    """float32 ``jax.random.exponential``: ``-log1p(-u)`` of a uniform draw.
    ``torch.log1p`` and XLA's may differ by an ulp, so a draw agrees with
    jax's within an ulp (the uniform itself is bitwise)."""
    return -torch.log1p(-uniform(k, shape, device=device))


def rademacher(k: torch.Tensor, shape, *, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """``jax.random.rademacher``: ±1 from ``bernoulli(k, 0.5)``, i.e.
    ``uniform(k, shape) < 0.5`` mapped to ``2·b − 1``. Bitwise jax's."""
    b = (uniform(k, shape, device=device) < 0.5).to(dtype)
    return (2 * b - 1).to(dtype)
