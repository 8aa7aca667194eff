"""The port's rbg and unsafe_rbg keys, its Philox bits and the Threefry
counters of large draws, against jax itself.

- ``philox_bits_plain`` (the CPU twin of the CUDA ``philox_bits`` kernel)
  is bitwise ``lax.rng_bit_generator``: random keys, ragged sizes, the
  128-bit counter carry, widths 8, 16 and 32, and slices of a stream.
- ``seed``, ``split``, ``fold_in``, bits, randint and permutation of both
  4-word impls are bitwise jax's; normal and uniform within the ulp
  tolerance of ``tests/test_torch_prng.py``.
- The vmap batching rule: a vmapped rbg draw is one draw of ``(batch,
  *shape)`` from the first key; a vmapped unsafe_rbg split is a batched
  draw, an rbg split is per key; a fold-in vmapped over its data is a
  batched draw under unsafe_rbg.
- The Threefry counters of 2**32 elements and beyond (jax's
  ``iota_2x32_shape``), checked by counter arithmetic, never by
  materializing 2**32 elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax._src import prng as jprng

import repro  # noqa: F401  (sets jax_threefry_partitionable, as runs do)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.philox import philox_bits_plain
from repro_torch.utils import prng

IMPLS = ("rbg", "unsafe_rbg")
# float32 normals: erfinv's log1p and rounding order differ from XLA's
NORMAL_ULPS = 4


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _u32(t):
    return t.numpy().astype(np.int64) & 0xFFFFFFFF


def _rand_words(seed, n=4):
    return [int(w) for w in np.random.default_rng(seed).integers(
        0, 2 ** 32, n, dtype=np.uint64)]


# ---------------------------------------------------------------------------
# Philox bits


@pytest.mark.parametrize("words", [
    [0, 0, 0, 0], [1, 2, 3, 4], _rand_words(0), _rand_words(1),
    # the low 64 counter bits wrap within the first blocks
    [5, 7, 0xFFFFFFFE, 0xFFFFFFFF], [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF,
                                     0xFFFFFFFF]])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 11), (64,)])
def test_philox_bits_bitwise_rng_bit_generator(words, shape):
    k = jnp.asarray(np.array(words, np.uint32))
    _, ref = lax.rng_bit_generator(k, shape, dtype=jnp.uint32)
    out = philox_bits_plain(words, int(np.prod(shape)))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref).ravel().astype(np.int64),
                                  _u32(out))


def test_philox_known_answer():
    """Random123's known answer for the all-zero key and counter."""
    out = _u32(philox_bits_plain([0, 0, 0, 0], 4))
    assert [hex(int(v)) for v in out] == ["0x6627e8d5", "0xe169c58d",
                                          "0xbc57ac4c", "0x9b00dbd8"]


@pytest.mark.parametrize("dtype,mask", [(jnp.uint8, 0xFF),
                                        (jnp.uint16, 0xFFFF)])
def test_philox_narrow_widths_are_low_bits(dtype, mask):
    words = _rand_words(5)
    k = jnp.asarray(np.array(words, np.uint32))
    _, ref = lax.rng_bit_generator(k, (3, 7), dtype=dtype)
    np.testing.assert_array_equal(
        np.asarray(ref).ravel().astype(np.int64),
        _u32(philox_bits_plain(words, 21)) & mask)


@pytest.mark.parametrize("start,n", [(0, 9), (1, 6), (3, 13), (8, 4),
                                     (4 * 2 ** 20 + 2, 5)])
def test_philox_stream_slices(start, n):
    """A slice of the stream, from any word, is that slice of the whole
    stream (the wrapper's ``start`` on the CPU)."""
    words = _rand_words(9)
    whole = philox_bits_plain(words, start + n)
    np.testing.assert_array_equal(
        _u32(whole[start:]), _u32(kops.philox_bits(words, n, start=start)))


# ---------------------------------------------------------------------------
# the rbg and unsafe_rbg key functions


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 + 5])
def test_seed_split_fold_in_bitwise(impl, seed):
    k, kt = jax.random.key(seed, impl=impl), prng.key(seed, impl)
    np.testing.assert_array_equal(_kd(k), kt.numpy())
    for num in (1, 2, 5):
        np.testing.assert_array_equal(_kd(jax.random.split(k, num)),
                                      prng.split(kt, num, impl).numpy())
    for data in (0, 1, 7, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            _kd(jax.random.fold_in(k, data)),
            prng.fold_in(kt, data, impl).numpy())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", [(1,), (17,), (3, 5), (2, 3, 4)])
def test_bits_bitwise(impl, shape):
    k = jax.random.key(21, impl=impl)
    ref = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    out = prng.random_bits(prng.key(21, impl), shape, impl=impl)
    np.testing.assert_array_equal(ref, out.numpy())
    for dt, mask in ((jnp.uint8, 0xFF), (jnp.uint16, 0xFFFF)):
        ref = np.asarray(jax.random.bits(k, shape, dt)).astype(np.int64)
        np.testing.assert_array_equal(ref, out.numpy() & mask)


@pytest.mark.parametrize("impl", IMPLS)
def test_randint_permutation_bitwise(impl):
    k, kt = jax.random.key(8, impl=impl), prng.key(8, impl)
    for lo, hi in ((0, 37), (-3, 1000), (0, 2 ** 20 + 7)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(k, (4, 6), lo, hi)),
            prng.randint(kt, (4, 6), lo, hi, impl=impl).numpy())
    for n in (1, 10, 1000):
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(k, n)),
            prng.permutation(kt, n, impl=impl).numpy())


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(a - b)))


@pytest.mark.parametrize("impl", IMPLS)
def test_uniform_normal_rademacher(impl):
    k, kt = jax.random.key(4, impl=impl), prng.key(4, impl)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(k, (5000,))),
        prng.uniform(kt, (5000,), impl=impl).numpy())
    assert _ulps(jax.random.normal(k, (5000,)),
                 prng.normal(kt, (5000,), impl=impl).numpy()) <= NORMAL_ULPS
    np.testing.assert_array_equal(
        np.asarray(jax.random.normal(k, (999,), jnp.bfloat16)
                   .astype(jnp.float32)),
        prng.normal(kt, (999,), dtype=torch.bfloat16, impl=impl)
        .float().numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.rademacher(k, (300,), jnp.float32)),
        prng.rademacher(kt, (300,), impl=impl).numpy())


def test_impl_is_never_guessed():
    """A 4-word key without its impl raises; so does a key whose word count
    is not its impl's."""
    with pytest.raises(ValueError, match="needs impl"):
        prng.split(prng.key(0, "rbg"), 2)
    with pytest.raises(ValueError, match="4 words"):
        prng.random_bits(prng.key(0), (3,), impl="unsafe_rbg")
    with pytest.raises(ValueError, match="unknown prng_impl"):
        prng.resolve("philox")
    assert prng.resolve(None) is prng.THREEFRY
    assert prng.resolve("rbg") is prng.RBG


# ---------------------------------------------------------------------------
# the vmap batching rule


@pytest.mark.parametrize("impl", IMPLS)
def test_vmapped_bits_are_one_draw_from_the_first_key(impl):
    ks = jax.random.split(jax.random.key(0, impl=impl), 3)
    ref = jax.vmap(lambda k: jax.random.bits(k, (4,), jnp.uint32))(ks)
    np.testing.assert_array_equal(
        np.asarray(ref), np.asarray(jax.random.bits(ks[0], (3, 4))))
    kt = prng.as_key(jax.random.key_data(ks))
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  prng.random_bits(kt, (4,),
                                                   impl=impl).numpy())
    # nested vmaps compose to one draw over the flattened batch
    kk = jax.random.split(jax.random.key(2, impl=impl), 6).reshape(2, 3)
    ref = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (5,))))(kk)
    out = prng.normal(prng.as_key(jax.random.key_data(kk)), (5,), impl=impl)
    assert out.shape == (2, 3, 5)
    assert _ulps(ref, out.numpy()) <= NORMAL_ULPS


@pytest.mark.parametrize("impl", IMPLS)
def test_vmapped_split_randint_permutation(impl):
    """unsafe_rbg's split is a bit draw (batched under vmap); rbg's is
    threefry per key; randint and permutation inherit both."""
    ks = jax.random.split(jax.random.key(5, impl=impl), 4)
    kt = prng.as_key(jax.random.key_data(ks))
    np.testing.assert_array_equal(
        _kd(jax.vmap(lambda k: jax.random.split(k, 3))(ks)),
        prng.split(kt, 3, impl).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, (2, 3), 0, 10))(ks)),
        prng.randint(kt, (2, 3), 0, 10, impl=impl).numpy())
    bounds = jnp.asarray([3, 50, 7, 1000])
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k, n: jax.random.randint(
            k, (2, 3), 0, n))(ks, bounds)),
        prng.randint(kt, (2, 3), 0, torch.tensor([3, 50, 7, 1000])
                     .reshape(4, 1, 1), impl=impl).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 20))(ks)),
        prng.permutation(kt, 20, impl=impl).numpy())
    # fold-in with a constant datum is per key under both impls
    np.testing.assert_array_equal(
        _kd(jax.vmap(lambda k: jax.random.fold_in(k, 9))(ks)),
        prng.fold_in(kt, 9, impl).numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_fold_in_vmapped_over_data(impl):
    """``vmap(lambda n: fold_in(k, n))(arange(b2))``, the wide route's
    ``tree`` convention, for one key and for a vmapped batch of keys."""
    k = jax.random.key(3, impl=impl)
    ref = jax.vmap(lambda n: jax.random.fold_in(k, n))(jnp.arange(6))
    out = prng.fold_in_range(prng.key(3, impl), 6, impl)
    np.testing.assert_array_equal(_kd(ref), out.numpy())
    ks = jax.random.split(k, 3)
    ref = jax.vmap(lambda kk: jax.vmap(
        lambda n: jax.random.fold_in(kk, n))(jnp.arange(6)))(ks)
    out = prng.fold_in_range(prng.as_key(jax.random.key_data(ks)), 6, impl)
    np.testing.assert_array_equal(_kd(ref), out.numpy())


# ---------------------------------------------------------------------------
# Threefry counters beyond 2**32 elements


def test_threefry_counters_past_two_to_the_32():
    """The counter of flat index i is (i >> 32, i & 0xFFFFFFFF): jax's
    ``iota_2x32_shape`` on small shapes, and the formula at 2**32 − 1,
    2**32 and 2**32 + 5."""
    hi, lo = jprng.iota_2x32_shape((3, 5, 7))
    hit, lot = prng.threefry_counters(torch.arange(105).reshape(3, 5, 7))
    np.testing.assert_array_equal(np.asarray(hi), hit.numpy())
    np.testing.assert_array_equal(np.asarray(lo), lot.numpy())
    idx = torch.tensor([2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 3 * 2 ** 32 + 7])
    hit, lot = prng.threefry_counters(idx)
    assert hit.tolist() == [0, 1, 1, 3]
    assert lot.tolist() == [2 ** 32 - 1, 0, 5, 7]


def test_bits_of_a_slice_match_jax():
    """``random_bits_range`` is a slice of the whole draw (jax on small
    shapes, both key families), and past 2**32 it runs the high counter
    word: the bits at 2**32 + j are Threefry of (1, j)."""
    for impl in ("threefry2x32",) + IMPLS:
        k = jax.random.key(13, impl=impl)
        whole = np.asarray(jax.random.bits(k, (6, 7))).ravel()
        kt = prng.key(13, impl)
        np.testing.assert_array_equal(
            whole[5:29].astype(np.int64),
            prng.random_bits_range(kt, 5, 29, impl=impl).numpy())
    kt = prng.key(13)
    out = prng.random_bits_range(kt, 2 ** 32 - 2, 2 ** 32 + 3)
    k0, k1 = kt.tolist()
    want = [a ^ b for a, b in (
        prng.threefry2x32(k0, k1, i >> 32, i & 0xFFFFFFFF)
        for i in range(2 ** 32 - 2, 2 ** 32 + 3))]
    assert out.tolist() == want
    # the high word matters: the counter (1, j) is not (0, j)
    assert out[2].item() != prng.random_bits_range(kt, 0, 1)[0].item()
