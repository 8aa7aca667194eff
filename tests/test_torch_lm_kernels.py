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


def _pieces(x, n):
    """x (float32) as the sum of n bf16 pieces: bf16(x), bf16(x − x₀), …
    (each difference exact in float32), as float32 tensors."""
    out = []
    for _ in range(n):
        h = x.bfloat16().float()
        out.append(h)
        x = x - h
    return out


def _flash_bf16_emulation(q, k, v, *, causal, window, kstep=16):
    """The arithmetic of the CUDA kernel's bfloat16 body
    (``csrc/flash_attention.cu:flash_fwd_bf16``), in torch on the CPU: q
    scaled in float32 and taken as one bf16 piece when the scale is a power
    of two (exact) or three; scores in float32 from the pieces' products,
    each 16-wide k-step of the tensor-core product summed apart (smallest
    piece first) and then added; the kernel's 64-key tiles and
    online-softmax update; p as three bf16 pieces for P·V, each 16-key
    k-step summed apart and added; float32 l from p itself."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = np.float32(1.0 / np.sqrt(D))
    nq = 1 if np.frexp(scale)[0] == 0.5 else 3
    qs = _pieces((q.float() * scale).reshape(B, Sq, Hkv, G, D)
                 .permute(0, 2, 3, 1, 4), nq)
    bk = tfa.BLOCK_K
    n_blk = -(-Sk // bk)
    pad = n_blk * bk - Sk
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
              .permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    q_pos = torch.arange(Sq)[:, None]
    m = torch.full((B, Hkv, G, Sq), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, G, Sq, D)
    for j in range(n_blk):
        lo = j * bk
        kt = kf[..., lo:lo + bk, :].transpose(-1, -2)
        s = torch.zeros(B, Hkv, G, Sq, bk)
        for d0 in range(0, D, kstep):
            # a k-step's products, smallest piece first, then one add
            t = 0
            for qp in qs[::-1]:
                t = t + qp[..., d0:d0 + kstep] @ kt[..., d0:d0 + kstep, :]
            s = s + t
        k_pos = torch.arange(lo, lo + bk)[None, :]
        mask = k_pos < Sk
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window:
            mask = mask & (q_pos - k_pos < window)
        s = torch.where(mask, s, tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None]
        pp = _pieces(p, 3)
        for k0 in range(0, bk, kstep):
            t = 0
            for x in pp[::-1]:
                t = t + x[..., k0:k0 + kstep] \
                    @ vf[..., lo + k0:lo + k0 + kstep, :]
            acc = acc + t
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).bfloat16()


def _attention_f64(q, k, v, *, causal, window):
    """softmax(q kᵀ / √D + mask) v in float64 (GQA by head repetition)."""
    Sq, Hq, D = q.shape[1:]
    Sk, Hkv = k.shape[1], k.shape[2]
    kk, vv = (t.double().repeat_interleave(Hq // Hkv, 2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() / np.sqrt(D), kk)
    q_pos, k_pos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, -np.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv).float()


def _ulps_floored(got, want):
    """The card tests' bf16 metric: max |got − want| in bf16 spacings at
    |want|, the spacing taken no finer than at 1e-5·max|want|."""
    top = float(want.abs().max())
    _, e = torch.frexp(want.abs().clamp_min(1e-5 * top))
    return float(((got.float() - want).abs()
                  / torch.ldexp(torch.ones_like(want), e - 8)).max())


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", ATTN_CASES)
def test_flash_bf16_tensor_core_design(b, s, hq, hkv, d, causal, window):
    """The bf16 kernel's arithmetic (q and p as bf16 pieces on the tensor
    cores, float32 accumulation) against ``flash_attention_plain`` and the
    reference's ``chunked_attention`` on bf16 inputs, within the card
    tests' 1 bf16 ulp. Near zero that ulp is about a float32 ulp of
    max|out|, so a reference's own float32 rounding can exceed it: each is
    first measured against a float64 evaluation, and where it lies r > 1
    ulp from it (one case: non-causal over 128 keys, plain 2.6, chunked
    1.9) the emulation is held within 1 + r (triangle inequality). The
    emulation itself is held within 1 ulp of the float64 values in every
    case (readings 0.50–0.59)."""
    q, k, v = (torch.from_numpy(_normal(i, b, s, h, d)).bfloat16()
               for i, h in ((4, hq), (5, hkv), (6, hkv)))
    got = _flash_bf16_emulation(q, k, v, causal=causal, window=window)
    truth = _attention_f64(q, k, v, causal=causal, window=window)
    assert _ulps_floored(got, truth) <= 1
    plain = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    chunked = torch.from_numpy(np.asarray(
        chunked_attention(jq, jk, jv, causal=causal, window=window),
        np.float32))
    for want in (plain.float(), chunked):
        r = _ulps_floored(want.bfloat16(), truth)
        assert _ulps_floored(got, want) <= (1 if r <= 1 else 1 + r)


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", ATTN_CASES)
def test_flash_f32_row_order_matches_reference(b, s, hq, hkv, d, causal,
                                               window):
    """The float32 kernel's summation order (``flash_f32_row_order``, which
    the card test holds the kernel to bit for bit) computes the reference's
    attention: within the tolerance of ``flash_attention_plain`` against
    ``chunked_attention`` (readings: 6.6e-7 and 6.9e-7)."""
    from test_torch_cuda import flash_f32_row_order

    q, k, v = (_normal(i, b, s, h, d) for i, h in ((4, hq), (5, hkv),
                                                   (6, hkv)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_f32_row_order(tq, tk, tv, causal=causal, window=window)
    plain = tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      window=window)
    twin = np.asarray(chunked_attention(q, k, v, causal=causal,
                                        window=window))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), twin, rtol=0, atol=2e-6)


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
