"""The port's kernel wrappers (plain versions on the CPU) against the JAX
package's Pallas kernels, run as its own tests run them: interpret mode.

Each case feeds the same numpy inputs (made from a seed) to
``repro.kernels.ops`` row by row and to ``repro_torch.kernels.ops`` as one
``[M, N]`` batch. Tolerances:

- Threefry bits and the ``sign`` kind: bitwise (±1 directions make every
  product exact, so even an FMA in XLA cannot round differently);
- the ``normal`` kind: within 4 ulp of the magnitude of the summed terms
  (Box-Muller's log/cos/sqrt are other implementations; 3 ulp seen);
- the reductions: relative 1e-5 (another summation order).

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py`` and by ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.kernels import ops as jops
from repro.kernels import zo_axpy as jza
from repro_torch.kernels import ops as tops
from repro_torch.kernels import zo_axpy as tza
from repro_torch.utils import prng

BR = 4                       # 4 rows x 128 lanes = 512-element blocks
M = 3


def _inputs(seed, n, b2=4):
    rs = np.random.default_rng(seed)
    x = rs.normal(0, 1, (M, n)).astype(np.float32)
    keys = rs.integers(0, 2 ** 32, (M, 2), dtype=np.uint64).astype(np.uint32)
    ab = rs.normal(0, 1, (M, 2)).astype(np.float32)
    coeffs = rs.normal(0, 1, (M, b2)).astype(np.float32)
    return x, keys, ab, coeffs


def _within_ulp(got, want, scale, n_ulp=4):
    err = np.abs(got - want) / np.spacing(np.abs(scale).astype(np.float32))
    assert err.max() <= n_ulp, err.max()


def _dirs(kind, keys, n, count):
    """The port's v_n[:count] for each row, as numpy [M, count]."""
    k = torch.from_numpy(keys.astype(np.int64))
    return tza.counter_gen(kind, k[:, :1], k[:, 1:], n,
                           torch.arange(count)).numpy()


def test_threefry_bits_bitwise():
    rs = np.random.default_rng(0)
    k = rs.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    c = rs.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64).astype(np.uint32)
    want = jza.threefry2x32(jnp.uint32(k[0]), jnp.uint32(k[1]),
                            jnp.asarray(c[0]), jnp.asarray(c[1]))
    got = prng.threefry2x32(int(k[0]), int(k[1]),
                            torch.from_numpy(c[0].astype(np.int64)),
                            torch.from_numpy(c[1].astype(np.int64)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())


@pytest.mark.parametrize("kind", ["normal", "sign"])
def test_counter_direction_matches_reference(kind):
    key2 = jax.random.key_data(jax.random.key(77))
    want = np.asarray(jza.counter_direction_flat(key2, 5, 3000, kind=kind,
                                                 start=100))
    got = tza.counter_direction_flat(prng.as_key(key2), 5, 3000, kind=kind,
                                     start=100).numpy()
    if kind == "sign":
        np.testing.assert_array_equal(want, got)
    else:
        _within_ulp(got, want, want)


@pytest.mark.parametrize("kind", ["normal", "sign"])
@pytest.mark.parametrize("n", [3 * BR * 128, 700])
def test_zo_walk_matches_reference(kind, n):
    x, keys, ab, _ = _inputs(1, n)
    nn = (2, 3)
    got = tops.zo_walk(torch.from_numpy(x), prng.as_key(keys), nn,
                       torch.from_numpy(ab), kind=kind).numpy()
    for m in range(M):
        want = np.asarray(jops.zo_walk(jnp.asarray(x[m]), jnp.asarray(keys[m]),
                                       jnp.asarray(nn), jnp.asarray(ab[m]),
                                       kind=kind, block_rows=BR))
        if kind == "sign":
            np.testing.assert_array_equal(want, got[m])
        else:
            gp, gn = (_dirs(kind, keys, j, n)[m] for j in nn)
            scale = (np.abs(x[m]) + np.abs(ab[m, 0] * gp)
                     + np.abs(ab[m, 1] * gn))
            _within_ulp(got[m], want, scale)


@pytest.mark.parametrize("kind", ["normal", "sign"])
@pytest.mark.parametrize("n", [2 * BR * 128, 700])
def test_zo_replay_matches_reference(kind, n):
    x, keys, _, coeffs = _inputs(2, n, b2=5)
    got = tops.zo_replay(torch.from_numpy(x), prng.as_key(keys),
                         torch.from_numpy(coeffs), kind=kind).numpy()
    for m in range(M):
        want = np.asarray(jops.zo_replay(
            jnp.asarray(x[m]), jnp.asarray(keys[m]), jnp.asarray(coeffs[m]),
            kind=kind, block_rows=BR))
        if kind == "sign":
            np.testing.assert_array_equal(want, got[m])
        else:
            scale = np.abs(x[m]) + sum(
                np.abs(coeffs[m, j] * _dirs(kind, keys, j, n)[m])
                for j in range(coeffs.shape[1]))
            _within_ulp(got[m], want, scale)


@pytest.mark.parametrize("kind", ["normal", "sign"])
@pytest.mark.parametrize("d", [100, 1300])
def test_zo_dirnorms_matches_reference(kind, d):
    _, keys, _, _ = _inputs(3, 8)
    got = tops.zo_dirnorms(prng.as_key(keys), d, b2=6, kind=kind,
                           block_rows=BR).numpy()
    for m in range(M):
        want = np.asarray(jops.zo_dirnorms(jnp.asarray(keys[m]), d, b2=6,
                                           kind=kind, block_rows=BR))
        np.testing.assert_allclose(got[m], want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind", ["normal", "sign"])
@pytest.mark.parametrize("d", [100, 1300, 7850])
def test_zo_dirnorms_kernel_order_matches_reference(kind, d):
    """The CUDA norms kernel's summation order (``zo_dirnorms_kernel_order``,
    which the card tests hold the kernel to bit for bit) against the Pallas
    kernel: the reductions' relative 1e-5."""
    _, keys, _, _ = _inputs(3, 8)
    got = tza.zo_dirnorms_kernel_order(prng.as_key(keys), d, b2=6,
                                       kind=kind).numpy()
    for m in range(M):
        want = np.asarray(jops.zo_dirnorms(jnp.asarray(keys[m]), d, b2=6,
                                           kind=kind, block_rows=BR))
        np.testing.assert_allclose(got[m], want, rtol=1e-5, atol=0)


# 10 chunks of 1,024 and a ragged 5; 301 chunks, so some of the finish's 256
# threads sum two partials
@pytest.mark.parametrize("kind", ["normal", "sign"])
@pytest.mark.parametrize("d", [10 * 1024 + 5, 300 * 1024 + 7])
def test_zo_dirnorms_kernel_order_matches_a_float64_sum(kind, d):
    """Over several chunks and a ragged edge the kernel's order sums the
    same squares as float64 does, to float32 rounding (reading: 1.1e-7;
    the sign kind exactly, below 2^24)."""
    _, keys, _, _ = _inputs(5, 8)
    k = prng.as_key(keys)
    per, chunks = tza.dirnorm_geometry(d, M * 2)
    assert (per, chunks) == (4, -(-d // 1024))
    got = tza.zo_dirnorms_kernel_order(k, d, b2=2, kind=kind)
    idx = torch.arange(d)
    want = torch.stack([torch.square(tza.counter_gen(
        kind, k[:, :1], k[:, 1:], n, idx).double()).sum(1) for n in range(2)],
        dim=1)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=1e-6 if kind == "normal" else 0, atol=0)


def test_dirnorm_geometry_at_the_main_path_shapes():
    """64 evaluations a thread at the Qwen2-0.5B step's width (M 1, b2 8),
    4 at the softmax round's (M 10, b2 20) and the cnn's."""
    assert tza.dirnorm_geometry(494_032_768, 8) == (64, 30_154)
    assert tza.dirnorm_geometry(7_850, 200) == (4, 8)
    assert tza.dirnorm_geometry(9_074, 200) == (4, 9)
    assert tza.dirnorm_geometry(2_000_000, 8) == (32, 245)


@pytest.mark.parametrize("n,d", [(2 * BR * 128, 700), (700, 650)])
def test_aircomp_reduce_matches_reference(n, d):
    rs = np.random.default_rng(4)
    deltas = (rs.normal(0, 1e-3, (M, n))).astype(np.float32)
    scale = rs.uniform(0, 1, M).astype(np.float32)
    mean, sq = tops.aircomp_reduce(torch.from_numpy(deltas),
                                   torch.from_numpy(scale), d, block_rows=BR)
    wmean, wsq = jops.aircomp_reduce(jnp.asarray(deltas), jnp.asarray(scale),
                                     d, block_rows=BR)
    _within_ulp(mean.numpy(), np.asarray(wmean),
                np.abs(scale[:, None] * deltas).sum(0))
    np.testing.assert_allclose(sq.numpy(), np.asarray(wsq), rtol=1e-5, atol=0)


def test_cpu_tensors_take_the_plain_version_without_counting():
    tops.reset_launches()
    x = torch.zeros((2, 300))
    keys = prng.split(prng.key(0), 2)
    tops.zo_walk(x, keys, (0, 1), torch.ones((2, 2)))
    tops.zo_replay(x, keys, torch.ones((2, 3)))
    tops.zo_dirnorms(keys, 300, b2=3)
    tops.aircomp_reduce(x, torch.ones(2), 300)
    assert all(v == 0 for v in tops.LAUNCHES.values()), tops.LAUNCHES


def test_other_devices_raise_instead_of_falling_back():
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.zo_walk(x, torch.zeros((2, 2), dtype=torch.int64,
                                    device="meta"), (0, 1),
                     torch.zeros((2, 2), device="meta"))
    with pytest.raises(ValueError, match="unknown counter direction kind"):
        tops.zo_replay(torch.zeros((1, 8)), prng.split(prng.key(0), 1),
                       torch.ones((1, 2)), kind="coordinate")
