"""DeepSeek's Multi-head Latent Attention in the port against a live JAX
run: the flash attention wrapper with a value head dim apart from the
query's (``ops.attention`` against the reference's ``chunked_attention``
with its ``scale=`` and its Pallas kernel in interpret mode), and
``init_mla``, ``mla_fwd``, ``mla_prefill`` (full width and ring) and the
absorbed-form ``mla_decode``.

Both packages start from the same weights (``utils/convert.to_torch``) at
``deepseek-v3-671b-smoke`` size (q_lora 32, kv_lora 16, nope 16, rope 8,
v 16: attention at head dims (24, 16)). Floats are float32 within 1e-5 of
the largest magnitude (torch and XLA sum in other orders; readings of a
few 1e-7 stand beside each check).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models.layers import chunked_attention
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.utils import convert, prng
from repro_torch.utils.flatparams import _leaves

ARCH = "deepseek-v3-671b-smoke"
B, S = 2, 16
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _qkv(shape_q, dk, dv, seed):
    rng = np.random.default_rng(seed)
    b, s, hq, hkv = shape_q
    q = rng.standard_normal((b, s, hq, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dv)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dk,dv,heads", [(24, 16, (4, 2)), (192, 128, (2, 2))])
@pytest.mark.parametrize("window", [0, 16])
def test_attention_with_its_own_value_head_dim(dk, dv, heads, window):
    """``ops.attention`` (the plain version here) at MLA's head-dim pairs
    and explicit scale 1/√(nope + rope), against the reference's
    ``chunked_attention(scale=)`` (what its model calls) and its Pallas
    kernel in interpret mode: ``[B, S, Hq, Dv]`` out, within 1e-5 of the
    largest (readings up to 1.9e-7 and 3.7e-7)."""
    q, k, v = _qkv((2, 64) + heads, dk, dv, seed=dk + window)
    scale = float(1.0 / np.sqrt(dk))
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, scale=scale)
    pallas = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, window=window, scale=scale,
                            block_q=32, block_k=32, interpret=True)
    ops.reset_launches()
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, window=window,
                        scale=scale)
    assert ops.LAUNCHES["flash_attention"] == 0   # the plain version
    assert got.shape == (2, 64, heads[0], dv)
    _close(got, want)
    _close(got, pallas)
    # the default scale is 1/√D of q and k
    dflt = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=True, window=window)
    assert torch.equal(dflt, got)


def _mla(seed=4):
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    jp = jax.device_get(jattn.init_mla(jax.random.key(seed), jcfg,
                                       jnp.float32))
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, convert.to_torch(jp), x


def test_init_mla_matches_the_reference():
    """Paths, shapes and values from the same key (the normals within a
    few float32 ulp of each leaf's largest weight)."""
    jcfg, tcfg, jp, _, _ = _mla()
    tp = tattn.init_mla(prng.key(4), tcfg, torch.float32)
    jl, _ = jax.tree_util.tree_flatten_with_path(jp)
    tl = _leaves(tp)
    assert ["/".join(k.key for k in p) for p, _ in jl] == \
        ["/".join(p) for p, _ in tl]
    for (_, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        _close(t, j, 1e-6)


@pytest.mark.parametrize("window", [0, 8])
def test_mla_fwd_matches_the_reference(window):
    """The decompressed train/prefill form and its latent (c_kv normed from
    a strided slice, k_rope rotated) on shared weights."""
    jcfg, tcfg, jp, tp, x = _mla()
    jo, jlat = jattn.mla_fwd(jp, jcfg, jnp.asarray(x), window=window)
    to, tlat = tattn.mla_fwd(tp, tcfg, torch.from_numpy(x), window=window)
    m = tcfg.mla
    assert tlat.shape == (B, S, m.kv_lora_rank + m.qk_rope_dim)
    _close(to, jo)
    _close(tlat, jlat)


@pytest.mark.parametrize("width", [S + 4, 12])
def test_mla_prefill_and_decode_match_the_reference(width):
    """Prefill at width >= S (slots [0, S)) and as a ring (width 12 < S:
    ``roll(last width, S % width)``), then 4 absorbed-form decode steps
    (slot ``pos % W`` written in place; the second run with a window of
    8): outputs and the latent cache."""
    jcfg, tcfg, jp, tp, x = _mla()
    jo, jc = jattn.mla_prefill(jp, jcfg, jnp.asarray(x), width)
    to, tc = tattn.mla_prefill(tp, tcfg, torch.from_numpy(x), width)
    _close(to, jo)
    _close(tc["latent"], jc["latent"])
    window = 0 if width > S else 8
    rng = np.random.default_rng(9)
    for i in range(4):
        xt = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        jo, jc = jattn.mla_decode(jp, jcfg, jnp.asarray(xt), jc,
                                  jnp.asarray(S + i, jnp.int32),
                                  window=window)
        lat = tc["latent"]
        to, tc = tattn.mla_decode(tp, tcfg, torch.from_numpy(xt), tc,
                                  torch.tensor(S + i), window=window)
        assert tc["latent"] is lat          # written in place
        _close(to, jo)
        _close(tc["latent"], jc["latent"])
    zero = tattn.init_mla_cache(tcfg, B, width, torch.float32)
    assert tuple(zero["latent"].shape) == \
        jattn.init_mla_cache(jcfg, B, width, jnp.float32)["latent"].shape
