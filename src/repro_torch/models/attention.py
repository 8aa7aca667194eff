"""GQA/MQA self-attention of the dense transformer (train forward).

Counterpart of ``repro/models/attention.py:31-76``: ``init_attention``,
``_qkv`` and ``attention_fwd`` with grouped kv heads, ``qkv_bias``,
``qk_norm``, RoPE and the sliding window. The attention itself goes through
``kernels/ops.attention`` on the reference's ``[B, S, H, D]`` layout: the
CUDA flash kernel on the card, its plain blocked version on the CPU (the
reference uses ``chunked_attention``, the jnp twin of its Pallas kernel).

``attention_fwd_batched`` is the same forward per client of a cohort
(weights ``[M, ...]``, x ``[M, B, S, d]``): q, k and v come from batched
GEMMs, and the attention is ONE kernel call over the ``[M·B, S, H, D]``
rows. The kernel treats each batch row on its own, so its output is bit
for bit that of M separate calls, and the launch count does not depend on
M.

Decode caches, MLA and cross-attention are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init, init_norm,
                                       norm_fwd, norm_fwd_batched,
                                       rope_angles)
from repro_torch.utils import prng


def init_attention(rng, cfg, dtype, *, device="cpu"):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ks = prng.split(rng, 4)
    p = {"wq": dense_init(ks[0], d, hq * hd, dtype, device=device),
         "wk": dense_init(ks[1], d, hkv * hd, dtype, device=device),
         "wv": dense_init(ks[2], d, hkv * hd, dtype, device=device),
         "wo": dense_init(ks[3], hq * hd, d, dtype, device=device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, "rmsnorm", dtype, device=device)
        p["k_norm"] = init_norm(hd, "rmsnorm", dtype, device=device)
    return p


def _qkv(p, cfg, x):
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, hq, hd)
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        q = norm_fwd(p["q_norm"], q)
        k = norm_fwd(p["k_norm"], k)
    return q, k, v


def attention_fwd(p, cfg, x):
    """Full-sequence causal attention (the train forward). x [B, S, d]."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = ops.attention(q, k, v, causal=True, window=cfg.sliding_window)
    return out.reshape(B, S, -1) @ p["wo"]


def _qkv_batched(p, cfg, x):
    """q ``[M·B, S, Hq, D]``, k/v ``[M·B, S, Hkv, D]`` from x ``[M, B, S,
    d]`` and ``[M, ...]`` weights."""
    M, B, S, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xt = x.reshape(M, B * S, d)
    q = xt @ p["wq"]
    k = xt @ p["wk"]
    v = xt @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"][:, None]
        k = k + p["bk"][:, None]
        v = v + p["bv"][:, None]
    q = q.reshape(M, B, S, hq, hd)
    k = k.reshape(M, B, S, hkv, hd)
    v = v.reshape(M, B, S, hkv, hd)
    if cfg.qk_norm:
        q = norm_fwd_batched(p["q_norm"], q)
        k = norm_fwd_batched(p["k_norm"], k)
    return (q.reshape(M * B, S, hq, hd), k.reshape(M * B, S, hkv, hd),
            v.reshape(M * B, S, hkv, hd))


def attention_fwd_batched(p, cfg, x):
    """``attention_fwd`` per client: x ``[M, B, S, d]``, weights ``[M,
    ...]`` -> ``[M, B, S, d]``, with one attention launch."""
    M, B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv_batched(p, cfg, x)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = ops.attention(q, k, v, causal=True, window=cfg.sliding_window)
    return (out.reshape(M, B * S, -1) @ p["wo"]).reshape(M, B, S, -1)
