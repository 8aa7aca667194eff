"""jax-compatible raw PRNG keys in PyTorch: Threefry-2x32, rbg and
unsafe_rbg.

The reference draws every random quantity of a run from one key chain:
the per-round split, the participation permutation, the minibatch rows, the
channel draw and the per-client ZO keys whose words seed the in-kernel
directions. This module reproduces that chain for the three key
implementations the reference's ``cfg.prng_impl`` names
(``jax/_src/prng.py``), so a port run from a seed draws the same integers
as the reference:

- ``key(seed, impl)``       -> ``[0, seed]`` (threefry); ``[0, seed, 0,
  seed]`` (rbg, unsafe_rbg: the threefry seed, repeated)
- ``split(key, num, impl)`` -> ``[..., num, words]``
- ``fold_in(key, data, impl)`` and ``fold_in_range(key, n, impl)`` (the
  fold-in vmapped over ``data = 0..n-1``)
- ``random_bits(key, shape, impl)``
- ``randint``, ``permutation``, ``uniform``, ``normal``, ``rademacher``,
  ``exponential``, ``gumbel``, ``categorical`` (the same transforms over
  either generator's bits)

A key is an int64 tensor of shape ``[..., 2]`` (threefry) or ``[..., 4]``
(rbg, unsafe_rbg) holding uint32 words (torch has no uint32 add or shift
on the CPU, so every uint32 operation is an int64 one masked with
``& 0xFFFFFFFF``). The two 4-word impls have keys of one shape, so the impl
is never guessed from a key: every function takes ``impl=`` (an ``Impl``,
its name, or None for threefry; a 4-word key without an impl raises), and
callers resolve it once from ``cfg.prng_impl`` (``resolve``).

**Leading dimensions are vmap axes.** A batch of keys ``[*B, words]``
stands for the reference's key under ``jax.vmap`` (the port writes the
client and scenario axes out as leading dimensions), and the draws follow
jax's batching rules:

- threefry: every draw, split and fold-in is per key;
- rbg and unsafe_rbg bits: ``lax.rng_bit_generator`` under vmap makes ONE
  draw of ``(*B, *shape)`` from the first key of the flattened batch
  (``jax/_src/lax/control_flow/loops.py``, its batching rule; nesting
  composes to this), so row b is the b-th slice of one Philox stream;
- rbg split and fold-in: threefry on each half of the key, per key;
- unsafe_rbg split: every 10th row of ``rbg_bits(key, (10·num, 4))``, a
  bit draw, so a batch of keys splits as one batched draw;
- unsafe_rbg fold-in: the key XOR the last row of ``rbg_bits(
  rbg_seed(data), (10, 4))``; per key for a scalar ``data``, one batched
  draw over the data for ``fold_in_range``.

A key with no leading dimensions is one key. A code path that loops over
rows where the reference vmaps them (the pytree route's clients, a
sweep's per-scenario AirComp noise) takes the rows as ``lanes(keys)``: a
threefry row is its key; an rbg row is a ``Lane``, which draws its bits
as its slice of the batch's one draw.

The rbg bits are XLA's RngBitGenerator (Philox-4x32-10,
``kernels/philox.py``): ``philox_bits`` launches the CUDA kernel for a
draw on the card and runs its plain version on the CPU. Threefry draws are
the torch Threefry chain below (``jax_threefry_partitionable=True``: the
counter of flat index i is ``(i >> 32, i & 0xFFFFFFFF)``, so draws of 2**32
elements or more agree too).

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
from typing import NamedTuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class Impl(NamedTuple):
    """A key implementation: the reference's ``cfg.prng_impl`` name and the
    words of its key."""
    name: str
    words: int


THREEFRY = Impl("threefry2x32", 2)
RBG = Impl("rbg", 4)
UNSAFE_RBG = Impl("unsafe_rbg", 4)
IMPLS = {i.name: i for i in (THREEFRY, RBG, UNSAFE_RBG)}


def resolve(impl=None) -> Impl:
    """The ``Impl`` of a name (``cfg.prng_impl``), an ``Impl`` itself, or
    threefry for None."""
    if impl is None:
        return THREEFRY
    if isinstance(impl, Impl):
        return impl
    try:
        return IMPLS[impl]
    except KeyError:
        raise ValueError(f"unknown prng_impl {impl!r}; known: "
                         f"{sorted(IMPLS)}") from None


class Lane(NamedTuple):
    """Row ``row`` of a batch of ``rows`` rbg keys under the reference's
    vmap, for a loop over the rows. ``key`` is the row's own key and
    ``first`` the batch's first key, each derived alike (per-key work:
    fold-in, the counter words); a bit draw of ``shape`` is words
    ``[row·n, (row+1)·n)`` of ONE draw from ``first`` (n = the shape's
    size), jax's batching rule."""
    key: torch.Tensor
    first: torch.Tensor
    row: int
    rows: int


def lanes(keys: torch.Tensor, impl=None) -> list:
    """The rows of a key batch ``[R, words]`` for a loop that stands for
    the reference's vmap: the keys themselves under threefry (every draw
    is per key), ``Lane`` s under rbg and unsafe_rbg."""
    impl = impl_of(keys, impl)
    flat = keys.reshape(-1, keys.shape[-1])
    if impl is THREEFRY:
        return list(flat)
    return [Lane(flat[r], flat[0], r, flat.shape[0])
            for r in range(flat.shape[0])]


def impl_of(k, impl=None) -> Impl:
    """The impl of keys ``k`` (or a ``Lane``), checked against their word
    count: None means threefry, and a 4-word key must name its impl."""
    if isinstance(k, Lane):
        k = k.key
    if impl is None:
        if k.shape[-1] != 2:
            raise ValueError(
                f"a {k.shape[-1]}-word key needs impl= ('rbg' or "
                f"'unsafe_rbg' keys have the same shape and are never "
                f"told apart by guessing)")
        return THREEFRY
    impl = resolve(impl)
    if k.shape[-1] != impl.words:
        raise ValueError(f"{impl.name} keys have {impl.words} words, got a "
                         f"key of shape {tuple(k.shape)}")
    return impl


def counter_words(k) -> torch.Tensor:
    """Words 0–1 of keys ``[..., 2|4]`` (a ``Lane``: its own key's): what
    the counter-convention kernels (``zo_walk``, ``zo_replay``,
    ``zo_dirnorms``) take of any key, as the reference's ``counter_gen``
    reads ``key_data[..., :2]`` (per key under a vmap)."""
    if isinstance(k, Lane):
        k = k.key
    return k[..., :2].contiguous() if k.shape[-1] != 2 else k


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


def key(seed: int, impl=None) -> torch.Tensor:
    """Raw key of ``jax.random.key(seed, impl=impl)``: ``[0, seed]`` for
    threefry, the same pair twice for rbg and unsafe_rbg."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    half = [0, seed]
    return torch.tensor(half * (resolve(impl).words // 2), dtype=torch.int64)


def as_key(k) -> torch.Tensor:
    """A key from raw uint32 words (an array, e.g. jax's ``key_data``), as
    int64 ``[..., words]``."""
    return torch.from_numpy(np.asarray(k).astype(np.uint32).astype(np.int64))


def _words(k, extra_dims: int):
    """The two words of keys ``[..., 2]`` shaped to broadcast against
    ``extra_dims`` trailing sample dimensions."""
    shp = k.shape[:-1] + (1,) * extra_dims
    return k[..., 0].reshape(shp), k[..., 1].reshape(shp)


def _tf_split(k: torch.Tensor, num: int) -> torch.Tensor:
    """Threefry fold-like split of keys ``[..., 2]``: word pair i is
    ``threefry(k, hi=0, lo=i)``, per key."""
    if _one_host_key(k):
        k0, k1 = k.tolist()
        return torch.tensor([threefry2x32(k0, k1, 0, i) for i in range(num)],
                            dtype=torch.int64).reshape(num, 2)
    k0, k1 = _words(k, 1)
    lo = torch.arange(num, dtype=torch.int64)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)


def _tf_fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    if _one_host_key(k):
        k0, k1 = k.tolist()
        return torch.tensor(threefry2x32(k0, k1, 0, int(data) & MASK32),
                            dtype=torch.int64)
    x0, x1 = threefry2x32(k[..., 0], k[..., 1], 0, int(data) & MASK32)
    return torch.stack([x0, x1], dim=-1)


def _halves(fn, k):
    """``fn`` applied to each threefry half of rbg keys ``[..., 4]``, the
    halves' outputs joined back into 4-word keys."""
    a, b = fn(k[..., :2].contiguous()), fn(k[..., 2:].contiguous())
    return torch.cat([a, b], dim=-1)


def _first_key(k: torch.Tensor):
    """The four words of the first key of a batch, as Python ints: the key
    a batched rbg draw runs from."""
    return tuple(k.reshape(-1, 4)[0].tolist())


def _rbg_stream(k: torch.Tensor, n: int, device) -> torch.Tensor:
    """int32 ``[n]``: the first n words of the Philox stream of the batch's
    first key (the kernel on a card, its plain version on the CPU)."""
    from repro_torch.kernels import ops as kops
    return kops.philox_bits(_first_key(k), n, device=device)


def _rbg_seed_words(data: int):
    return (0, int(data) & MASK32) * 2


def split(k: torch.Tensor, num: int = 2, impl=None) -> torch.Tensor:
    """``jax.random.split(k, num)``: ``[..., num, words]``.

    threefry: the partitionable (fold-like) split, word pair i is
    ``threefry(k, hi=0, lo=i)``; rbg: that split of each half; unsafe_rbg:
    every 10th row of ``rbg_bits(k, (10·num, 4))``, one batched draw for a
    batch of keys."""
    if isinstance(k, Lane):
        raise NotImplementedError("a Lane does not split: split the batch "
                                  "of keys, then take its lanes")
    impl = impl_of(k, impl)
    if impl is THREEFRY:
        return _tf_split(k, num)
    if impl is RBG:
        return _halves(lambda h: _tf_split(h, num), k)
    lead = tuple(k.shape[:-1])
    rows = _rbg_stream(k, math.prod(lead) * 10 * num * 4, "cpu")
    rows = rows.to(torch.int64) & MASK32
    return rows.reshape(lead + (10 * num, 4))[..., ::10, :].contiguous()


def fold_in(k: torch.Tensor, data: int, impl=None) -> torch.Tensor:
    """``jax.random.fold_in(k, data)`` for a scalar ``data``, per key:
    threefry ``threefry(k, [0, data])``; rbg that of each half; unsafe_rbg
    the key XOR the last row of ``rbg_bits(rbg_seed(data), (10, 4))``. A
    ``Lane`` folds its own and its first key alike."""
    if isinstance(k, Lane):
        return k._replace(key=fold_in(k.key, data, impl),
                          first=fold_in(k.first, data, impl))
    impl = impl_of(k, impl)
    if impl is THREEFRY:
        return _tf_fold_in(k, data)
    if impl is RBG:
        return _halves(lambda h: _tf_fold_in(h, data), k)
    from repro_torch.kernels import ops as kops
    row = kops.philox_bits(_rbg_seed_words(data), 40, device="cpu")[-4:]
    return k ^ (row.to(torch.int64) & MASK32)


def fold_in_range(k: torch.Tensor, n: int, impl=None) -> torch.Tensor:
    """``jax.vmap(lambda i: fold_in(k, i))(arange(n))`` as ``[..., n,
    words]`` for keys ``[..., words]``: the fold-in vmapped over its data.
    threefry and rbg fold per key and equal ``split(k, n)`` (both are
    ``threefry(k, (0, i))`` per half); unsafe_rbg's data-batched draw runs
    from ``rbg_seed(0)``: datum i XORs row ``10·i + 9`` of that stream."""
    impl = impl_of(k, impl)
    if impl is not UNSAFE_RBG:
        return split(k, n, impl)
    from repro_torch.kernels import ops as kops
    rows = kops.philox_bits(_rbg_seed_words(0), 40 * n, device="cpu")
    rows = (rows.to(torch.int64) & MASK32).reshape(n, 10, 4)[:, 9]
    return k[..., None, :] ^ rows


def _tf_bits(k: torch.Tensor, shape, dev) -> torch.Tensor:
    size = math.prod(shape)
    if _one_host_key(k):
        k0, k1 = k.tolist()     # words as ints: no copy to the device
    else:
        k0, k1 = _words(k.to(dev), len(shape))
    idx = torch.arange(size, dtype=torch.int64, device=dev).reshape(shape)
    hi = 0 if size <= 2 ** 32 else idx >> 32
    x0, x1 = threefry2x32(k0, k1, hi, idx & MASK32)
    return x0 ^ x1


def _bits(k: torch.Tensor, shape, impl, device) -> torch.Tensor:
    """The 32-bit words of a draw of ``shape`` (with the keys' leading
    dimensions in front): int64 for threefry, int32 bit patterns for rbg
    (the uniform and normal transforms take either)."""
    shape = tuple(shape)
    impl = impl_of(k, impl)
    if isinstance(k, Lane):
        from repro_torch.kernels import ops as kops
        n = math.prod(shape)
        dev = k.key.device if device is None else torch.device(device)
        return kops.philox_bits(_first_key(k.first), n, device=dev,
                                start=k.row * n).reshape(shape)
    dev = k.device if device is None else torch.device(device)
    if impl is THREEFRY:
        return _tf_bits(k, shape, dev)
    lead = tuple(k.shape[:-1])
    return _rbg_stream(k, math.prod(lead + shape), dev).reshape(lead + shape)


def random_bits(k: torch.Tensor, shape, *, impl=None,
                device=None) -> torch.Tensor:
    """32-bit ``jax.random.bits`` as int64 uint32 values ``[*lead, *shape]``
    on ``device`` (default: the key's). threefry: ``bits1 ^ bits2`` of the
    counters ``(i >> 32, i & 0xFFFFFFFF)`` of the row-major flat index i,
    per key; rbg and unsafe_rbg: the Philox words, one batched draw for a
    batch of keys. The 8- and 16-bit widths are the low bits of these
    words (``& 0xFF``, ``& 0xFFFF``) for every impl."""
    b = _bits(k, shape, impl, device)
    return b if b.dtype == torch.int64 else b.to(torch.int64) & MASK32


def threefry_counters(idx):
    """The ``(hi, lo)`` counter words of flat indices ``idx`` (int64): jax's
    ``iota_2x32_shape`` under the partitionable Threefry."""
    return idx >> 32, idx & MASK32


def random_bits_range(k: torch.Tensor, start: int, stop: int, *,
                      impl=None, device=None) -> torch.Tensor:
    """Flat elements ``[start, stop)`` of ``random_bits(k, shape)`` for one
    key and any shape of at least ``stop`` elements (a draw does not
    depend on its shape beyond its flat size), without the elements before
    ``start``: int64 ``[stop - start]``."""
    impl = impl_of(k, impl)
    dev = k.device if device is None else torch.device(device)
    if impl is THREEFRY:
        return random_bits_at(k, torch.arange(start, stop, dtype=torch.int64,
                                              device=dev))
    from repro_torch.kernels import ops as kops
    b = kops.philox_bits(_first_key(k), stop - start, device=dev,
                         start=start)
    return b.to(torch.int64) & MASK32


def random_bits_at(k: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Elements ``idx`` (int64 flat indices, any shape) of the threefry
    ``random_bits(k, shape)`` of a shape holding them: bits1 ^ bits2 of
    the counters ``threefry_counters(idx)``, the partitionable Threefry's
    element map. A shard of a draw takes its own flat indices and is
    bitwise the slice of the whole draw."""
    if impl_of(k) is not THREEFRY:
        raise NotImplementedError("shard-local draws take threefry keys")
    k0, k1 = k.tolist()
    hi, lo = threefry_counters(idx)
    x0, x1 = threefry2x32(k0, k1, hi, lo)
    return x0 ^ x1


def normal_shard(k: torch.Tensor, shape, offset, local_shape, *,
                 dtype=torch.float32, device=None,
                 chunk: int = None) -> torch.Tensor:
    """The block ``[offset, offset + local_shape)`` of ``normal(k, shape,
    dtype=dtype)``, bitwise the slice of the whole draw, drawn from the
    block's own flat indices in chunks of about ``chunk`` elements (default
    ``DRAW_CHUNK``) along its leading dim. On ``meta`` only the shape."""
    local_shape = tuple(int(n) for n in local_shape)
    out = torch.empty(local_shape, dtype=dtype, device=device)
    if out.device.type == "meta" or out.numel() == 0:
        return out
    chunk = DRAW_CHUNK if chunk is None else chunk
    nd = len(local_shape)
    strides = [1] * nd
    for d in range(nd - 2, -1, -1):
        strides[d] = strides[d + 1] * int(shape[d + 1])
    if nd == 0:
        idx = torch.zeros((), dtype=torch.int64, device=out.device)
        return out.copy_(_normal_of_bits(random_bits_at(k, idx), dtype))
    tail = torch.zeros((), dtype=torch.int64, device=out.device)
    for d in range(1, nd):
        r = torch.arange(int(offset[d]), int(offset[d]) + local_shape[d],
                         dtype=torch.int64, device=out.device)
        tail = tail + (r * strides[d]).reshape(
            (-1,) + (1,) * (nd - 1 - d))
    per_row = max(1, math.prod(local_shape[1:]))
    step = max(1, chunk // per_row)
    for a in range(0, local_shape[0], step):
        b = min(a + step, local_shape[0])
        rows = torch.arange(int(offset[0]) + a, int(offset[0]) + b,
                            dtype=torch.int64, device=out.device)
        idx = rows.reshape((-1,) + (1,) * (nd - 1)) * strides[0] + tail
        out[a:b] = _normal_of_bits(random_bits_at(k, idx), dtype)
    return out


def _mul32(a, b):
    """``a * b mod 2**32`` for uint32 values held in int64 (no overflow)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    return _u32(a_lo * b + (((a_hi * b) & 0xFFFF) << 16))


def randint(k: torch.Tensor, shape, minval, maxval, *,
            impl=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` for int32 output.

    ``minval``/``maxval`` are ints or int tensors broadcastable to the
    output ``k.shape[:-1] + shape``. Same double-width modulus as jax:
    two bit draws from ``split(k)``, combined under ``2**32 mod span``.
    """
    shape = tuple(shape)
    ks = split(k, 2, impl)
    higher = random_bits(ks[..., 0, :], shape, impl=impl)
    lower = random_bits(ks[..., 1, :], shape, impl=impl)
    minval = torch.as_tensor(minval, dtype=torch.int64)
    maxval = torch.as_tensor(maxval, dtype=torch.int64)
    span = _u32(maxval - minval)
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = (2 ** 16) % span
    mult = _mul32(mult, mult) % span
    off = _u32(_mul32(higher % span, mult) + lower % span) % span
    return (minval + off).to(torch.int32)


def permutation(k: torch.Tensor, n: int, *, impl=None) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: ``ceil(3 ln n / ln(2**32 - 1))``
    stable sorts of ``arange(n)`` on fresh 32-bit keys; ``[*lead, n]`` for
    keys ``[*lead, words]``."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK32)))
    lead = tuple(k.shape[:-1])
    x = torch.arange(n, dtype=torch.int64).expand(lead + (n,))
    for _ in range(rounds):
        ks = split(k, 2, impl)
        k, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.sort(random_bits(sub, (n,), impl=impl), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def uniform(k: torch.Tensor, shape, minval=0.0, maxval=1.0, *, impl=None,
            device=None) -> torch.Tensor:
    """float32 ``jax.random.uniform``: 23 mantissa bits under exponent 0,
    shifted and scaled in float32."""
    return _uniform_from_bits(_bits(k, shape, impl, device), minval, maxval)


def _uniform_from_bits(bits, minval, maxval):
    fbits = (((bits >> 9) & 0x7FFFFF) | 0x3F800000).to(torch.int32)
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


def _meta(k, shape, dtype, device):
    """A draw on the ``meta`` device: its shape and dtype, no values (an
    init on ``meta`` counts parameters without running the generator)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(getattr(k, "shape", (2,))[:-1])
                           + tuple(shape), dtype=dtype, device="meta")
    return None


def normal(k: torch.Tensor, shape, *, dtype=torch.float32, impl=None,
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
    meta = _meta(k, shape, dtype, device)
    if meta is not None:
        return meta
    return _normal_of_bits(_bits(k, shape, impl, device), dtype)


def _normal_of_bits(bits, dtype):
    """Normals in ``dtype`` (float32 or bfloat16) from 32-bit words."""
    if dtype == torch.float32:
        return _normal_from_bits(bits)
    if dtype != torch.bfloat16:
        raise NotImplementedError(f"normal draws in {dtype}: float32 and "
                                  f"bfloat16 are ported")
    bits = bits & 0xFF
    fbits = ((bits >> 1) | 0x3F80).to(torch.int16)
    floats = fbits.view(torch.bfloat16) - 1.0
    # bfloat16 arithmetic with exact bfloat16 scalars (torch rounds each
    # operation to bfloat16, as XLA does here)
    u = torch.clamp_min(floats * 2.0 + _NORMAL_LO_BF16, _NORMAL_LO_BF16)
    return erfinv(u.float()).to(torch.bfloat16) * _SQRT2_BF16


def _normal_from_bits(bits):
    """float32 normals from 32-bit words: ``sqrt(2)·erfinv(u)``, u uniform
    on ``(nextafter(-1, 0), 1)``."""
    return erfinv(_uniform_from_bits(bits, _NORMAL_LO, 1.0)) * _SQRT2


# Flat elements of one chunk of ``normal_into``. A float32 normal's
# temporaries peak in the Threefry rounds: the int64 counter and its low
# word, the two state words and a rotate's three int64 intermediates are
# live at once, 7 x 8 = 56 bytes an element (the uniform and erfinv stages
# hold float32 and bool tensors, less), plus the chunk's float32 result and
# its transform: about 64 bytes an element. 2**25 elements x 64 bytes = 2
# GiB a chunk, against tens of GiB for a whole expert or embedding leaf
# (DeepSeek-V3's [1, 256, 7168, 2048] expert leaf is 3.76e9 elements).
DRAW_CHUNK = 1 << 25


def normal_into(k: torch.Tensor, out: torch.Tensor, fn=None, *,
                chunk: int = DRAW_CHUNK) -> torch.Tensor:
    """Fill the contiguous ``out`` with ``fn(normal(k, out.shape))`` (float32
    normals, ``fn`` elementwise, identity when None) cast to out's dtype,
    and return it. A threefry host key draws in chunks of ``chunk`` flat
    elements, each written into its slice of ``out``: element i depends on
    counter i alone and every step is elementwise, so the result is bitwise
    the whole draw's, and the temporaries are those of one chunk. On
    ``meta`` it returns ``out`` as it is."""
    if out.device.type == "meta":
        return out
    n = out.numel()
    if n <= chunk or not isinstance(k, torch.Tensor) \
            or not _one_host_key(k) or k.shape[-1] != 2:
        g = normal(k, tuple(out.shape), device=out.device)
        out.copy_(fn(g) if fn is not None else g)
        return out
    flat = out.view(-1)
    k0, k1 = k.tolist()
    for a in range(0, n, chunk):
        idx = torch.arange(a, min(a + chunk, n), dtype=torch.int64,
                           device=out.device)
        hi = 0 if n <= 2 ** 32 else idx >> 32
        x0, x1 = threefry2x32(k0, k1, hi, idx & MASK32)
        del idx
        g = _normal_from_bits(x0 ^ x1)
        del x0, x1
        flat[a:a + g.numel()] = fn(g) if fn is not None else g
    return out


def exponential(k: torch.Tensor, shape, *, impl=None,
                device=None) -> torch.Tensor:
    """float32 ``jax.random.exponential``: ``-log1p(-u)`` of a uniform draw.
    ``torch.log1p`` and XLA's may differ by an ulp, so a draw agrees with
    jax's within an ulp (the uniform itself is bitwise)."""
    return -torch.log1p(-uniform(k, shape, impl=impl, device=device))


def rademacher(k: torch.Tensor, shape, *, dtype=torch.float32, impl=None,
               device=None) -> torch.Tensor:
    """``jax.random.rademacher``: ±1 from ``bernoulli(k, 0.5)``, i.e.
    ``uniform(k, shape) < 0.5`` mapped to ``2·b − 1``. Bitwise jax's."""
    b = (uniform(k, shape, impl=impl, device=device) < 0.5).to(dtype)
    return (2 * b - 1).to(dtype)


_TINY = {torch.float32: float(np.finfo(np.float32).tiny),
         torch.bfloat16: 2.0 ** -126}


def _uniform_bf16(k, shape, minval, maxval, impl, device):
    """bfloat16 ``jax.random.uniform``: 8 random bits (the low byte of the
    32-bit draw), their top 7 as the mantissa under exponent 0, then
    ``f·bf16(max − min) + min`` in bfloat16, floored at ``min``."""
    bits = _bits(k, shape, impl, device) & 0xFF
    fbits = ((bits >> 1) | 0x3F80).to(torch.int16)
    floats = fbits.view(torch.bfloat16) - 1.0
    lo = torch.tensor(minval, dtype=torch.bfloat16)
    span = float(torch.tensor(maxval, dtype=torch.bfloat16) - lo)
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel(k: torch.Tensor, shape, *, dtype=torch.float32, impl=None,
           device=None) -> torch.Tensor:
    """``jax.random.gumbel(k, shape, dtype)`` in its default ``mode="low"``
    (jax 0.9.0): ``-log(-log(u))`` with u uniform on ``[tiny, 1)`` in
    ``dtype``. The uniform is bitwise jax's; the logs are torch's, so a
    float32 draw agrees within a few ulp. A bfloat16 draw rounds each log
    to bfloat16, as XLA does, and is bitwise jax's (all 128 values of u)."""
    if dtype == torch.float32:
        u = uniform(k, shape, _TINY[dtype], 1.0, impl=impl, device=device)
        return -torch.log(-torch.log(u))
    if dtype != torch.bfloat16:
        raise NotImplementedError(f"gumbel draws in {dtype}: float32 and "
                                  f"bfloat16 are ported")
    u = _uniform_bf16(k, shape, _TINY[dtype], 1.0, impl, device)
    return -torch.log(-torch.log(u))


def categorical(k: torch.Tensor, logits: torch.Tensor, *, axis=-1,
                impl=None) -> torch.Tensor:
    """``jax.random.categorical(k, logits, axis)`` with replacement (the
    Gumbel-max trick): ``argmax(gumbel(k, logits.shape) + logits, axis)``,
    the Gumbel draw in the logits' dtype on their device. int64 indices of
    shape ``logits.shape`` without ``axis``."""
    g = gumbel(k, tuple(logits.shape), dtype=logits.dtype, impl=impl,
               device=logits.device)
    return torch.argmax(g + logits, dim=axis)
