"""The port's jax-compatible Threefry key chain against jax itself.

Integer outputs (keys, bits, randint, permutation) must be bitwise jax's:
every client draw, minibatch row and direction of a port run is keyed on
them. ``normal`` goes through erfinv and is held to a few ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable, as runs do)
from repro_torch.utils import prng


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 + 5])
def test_key_and_split_bitwise(seed):
    k, kt = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(_kd(k), kt.numpy())
    for num in (2, 5, 7):
        np.testing.assert_array_equal(_kd(jax.random.split(k, num)),
                                      prng.split(kt, num).numpy())
    # batched keys [M, 2] -> [M, num, 2], as the round splits client keys
    ks = jax.random.split(k, 3)
    nested = jax.vmap(lambda kk: jax.random.split(kk, 4))(ks)
    np.testing.assert_array_equal(_kd(nested),
                                  prng.split(prng.split(kt, 3), 4).numpy())


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 32 - 1])
def test_fold_in_bitwise(data):
    k = jax.random.key(3)
    np.testing.assert_array_equal(_kd(jax.random.fold_in(k, data)),
                                  prng.fold_in(prng.key(3), data).numpy())


@pytest.mark.parametrize("shape", [(1,), (17,), (3, 5), (2, 3, 4)])
def test_random_bits_bitwise(shape):
    k = jax.random.key(21)
    ref = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(ref, prng.random_bits(prng.key(21),
                                                        shape).numpy())


@pytest.mark.parametrize("lo,hi", [(0, 37), (0, 1), (5, 6), (-3, 1000),
                                   (0, 2 ** 20 + 7), (4, 4)])
def test_randint_bitwise(lo, hi):
    k = jax.random.key(8)
    ref = np.asarray(jax.random.randint(k, (4, 6), lo, hi))
    np.testing.assert_array_equal(ref, prng.randint(prng.key(8), (4, 6), lo,
                                                    hi).numpy())


def test_randint_per_client_bound_bitwise():
    """The store's draw: one key and one upper bound per client."""
    k = jax.random.key(9)
    sizes = np.array([5, 17, 40, 1], np.int32)
    ks = jax.random.split(k, 4)
    ref = jax.vmap(lambda kk, n: jax.random.randint(kk, (2, 3), 0, n))(
        ks, jnp.asarray(sizes))
    got = prng.randint(prng.split(prng.key(9), 4), (2, 3), 0,
                       torch.from_numpy(sizes).long().reshape(4, 1, 1))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("n", [1, 6, 50, 1000, 1700])
def test_permutation_bitwise(n):
    """1700 > 1,625 takes two sort rounds."""
    k = jax.random.key(13)
    np.testing.assert_array_equal(np.asarray(jax.random.permutation(k, n)),
                                  prng.permutation(prng.key(13), n).numpy())


def test_uniform_and_normal_against_jax():
    k = jax.random.key(4)
    # the normal path's range has span 2.0, so the scale is exact: bitwise
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = np.asarray(jax.random.uniform(k, (4096,), jnp.float32, lo, 1.0))
    np.testing.assert_array_equal(u, prng.uniform(prng.key(4), (4096,), lo,
                                                  1.0).numpy())
    # another span: XLA fuses floats·span + lo into one FMA, the port rounds
    # twice, so 1 ulp (measured: 14.7% of draws differ, by 1 ulp)
    u = np.asarray(jax.random.uniform(k, (4096,), jnp.float32, -0.5, 2.0))
    got = prng.uniform(prng.key(4), (4096,), -0.5, 2.0).numpy()
    assert (np.abs(u - got) <= np.spacing(np.abs(u))).all()
    ref = np.asarray(jax.random.normal(k, (20000,), jnp.float32))
    got = prng.normal(prng.key(4), (20000,)).numpy()
    # erfinv: the port evaluates XLA's polynomial, but log1p and the
    # rounding order differ; 3 ulp was the worst seen on 10^5 draws
    ulps = np.abs(ref - got) / np.spacing(np.abs(ref))
    assert ulps.max() <= 4, ulps.max()
