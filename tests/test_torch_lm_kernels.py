"""The plain versions of the port's RMSNorm and flash-attention kernels
against the JAX package, live in the same process.

Each plain version is what the port's wrapper runs on a CPU tensor and what
``chip_smoke.py`` holds the CUDA kernel against on the card, so these tests
tie the CUDA kernels to the reference through it. The reference side runs
the Pallas kernels in interpret mode (``repro.kernels.ops.rmsnorm`` /
``attention(interpret=True)``) and their jnp twins (``norm_fwd``,
``chunked_attention``). Inputs are numpy normals from a seed. Neither side
is bitwise the other (torch and XLA sum a row or a dot product in other
orders); each tolerance stands beside its measured reading.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.kernels import ops as jops
from repro.models.layers import chunked_attention, norm_fwd
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trn


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _bf16_ulps(got, want):
    """max |got - want| in bf16 spacings at |want| (float32 tensors)."""
    _, e = torch.frexp(want.abs().clamp_min(1e-30))
    return float(((got - want).abs() / torch.ldexp(torch.ones_like(want),
                                                    e - 8)).max())


@pytest.mark.parametrize("shape", [(512, 896), (7, 5, 64), (3, 100), (1, 32)])
def test_rmsnorm_plain_matches_pallas_and_norm_fwd(shape):
    x = _normal(0, *shape) * 3
    sc = 1 + 0.1 * _normal(1, shape[-1])
    got = trn.rmsnorm_plain(torch.from_numpy(x), torch.from_numpy(sc),
                            eps=1e-6).numpy()
    pallas = np.asarray(jops.rmsnorm(x, sc, eps=1e-6, interpret=True))
    jnp_twin = np.asarray(norm_fwd({"scale": jnp.asarray(sc)}, x))
    # reading: 3.5e-7 relative (an ulp of rsqrt or of the mean square)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, jnp_twin, rtol=1e-6, atol=0)


def test_rmsnorm_plain_bf16_within_one_ulp_of_reference():
    x, sc = _normal(2, 64, 896), 1 + 0.1 * _normal(3, 896)
    got = trn.rmsnorm_plain(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(sc).bfloat16())
    want = norm_fwd({"scale": jnp.asarray(sc, jnp.bfloat16)},
                    jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # both round a float32 result to bf16: at most one bf16 ulp apart
    # (reading: 0, bitwise)
    assert _bf16_ulps(got.float(),
                      torch.from_numpy(np.asarray(want, np.float32))) <= 1


ATTN_CASES = [
    # b, s, hq, hkv, d, causal, window
    (2, 16, 4, 2, 32, True, 0),       # the smoke model, G = 2
    (1, 128, 14, 2, 64, True, 0),     # Qwen2-0.5B heads, G = 7
    (1, 100, 14, 2, 64, True, 0),     # ragged S
    (2, 128, 4, 2, 32, True, 32),     # sliding window
    (1, 200, 4, 1, 32, True, 48),     # window across ragged K/V tiles
    (1, 100, 4, 2, 32, False, 0),     # non-causal, ragged
    (1, 128, 4, 4, 32, False, 0),     # non-causal, no GQA
]


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", ATTN_CASES)
def test_flash_plain_matches_reference(b, s, hq, hkv, d, causal, window):
    q, k, v = (_normal(i, b, s, h, d) for i, h in ((4, hq), (5, hkv),
                                                   (6, hkv)))
    got = tfa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    window=window).numpy()
    twin = np.asarray(chunked_attention(q, k, v, causal=causal,
                                        window=window))
    # readings over the cases: up to 6.0e-7 against chunked_attention and
    # 4.8e-7 against the Pallas kernel (softmax-weighted means of unit
    # normals, |out| < 3.2)
    np.testing.assert_allclose(got, twin, rtol=0, atol=2e-6)
    if causal or s % 128 == 0:
        # the reference wrapper pads to 128 and cannot mask a padded
        # non-causal K; the port's kernel masks its own ragged edge
        pallas = np.asarray(jops.attention(q, k, v, causal=causal,
                                           window=window, interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=0, atol=2e-6)


def test_flash_plain_bf16_within_one_ulp_of_reference():
    q, k, v = (_normal(i, 1, 64, h, 32) for i, h in ((7, 4), (8, 2),
                                                     (9, 2)))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = tfa.flash_attention_plain(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = torch.from_numpy(np.asarray(
        chunked_attention(jq, jk, jv, causal=True), np.float32))
    top = float(want.abs().max())
    # bf16 spacing taken no finer than at 1e-5·max|out| (the float32
    # reordering decides the rounding of outputs below that); reading: 1,
    # on one element of 8192
    err = (got.float() - want).abs()
    _, e = torch.frexp(want.abs().clamp_min(1e-5 * top))
    assert float((err / torch.ldexp(torch.ones_like(want), e - 8)).max()) \
        <= 1


def test_flash_block_size_is_not_visible():
    """Blocks of 64 (the CUDA tile) and of 16 keys give the same result to
    float32 rounding: the online softmax is exact up to reassociation
    (reading: 4.8e-7)."""
    q, k, v = (torch.from_numpy(_normal(i, 2, 100, h, 32))
               for i, h in ((10, 4), (11, 2), (12, 2)))
    a = tfa.flash_attention_plain(q, k, v, causal=True)
    b = tfa.flash_attention_plain(q, k, v, causal=True, block_k=16)
    torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On a CPU tensor the wrappers ARE the plain versions, and they launch
    (and count) nothing."""
    tops.reset_launches()
    x = torch.from_numpy(_normal(13, 6, 64))
    sc = torch.from_numpy(1 + 0.1 * _normal(14, 64))
    assert torch.equal(tops.rmsnorm(x, sc), trn.rmsnorm_plain(x, sc))
    q, k, v = (torch.from_numpy(_normal(i, 1, 20, h, 32))
               for i, h in ((15, 4), (16, 2), (17, 2)))
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        assert torch.equal(
            tops.attention(q, k, v, causal=causal, window=window),
            tfa.flash_attention_plain(q, k, v, causal=causal, window=window))
    assert tops.LAUNCHES["rmsnorm"] == 0 == tops.LAUNCHES["flash_attention"]
