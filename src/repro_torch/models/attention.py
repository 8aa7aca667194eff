"""GQA/MQA self-attention of the dense transformer: the train forward,
prefill and one-token decode against a ring KV cache.

Counterpart of ``repro/models/attention.py:31-131``: ``init_attention``,
``_qkv`` and ``attention_fwd`` with grouped kv heads, ``qkv_bias``,
``qk_norm``, RoPE and the sliding window; ``init_kv_cache``,
``attention_prefill`` and ``attention_decode``. The attention itself goes through
``kernels/ops.attention`` on the reference's ``[B, S, H, D]`` layout: the
CUDA flash kernel on the card, its plain blocked version on the CPU (the
reference uses ``chunked_attention``, the jnp twin of its Pallas kernel).

``attention_fwd_batched`` is the same forward per client of a cohort
(weights ``[M, ...]``, x ``[M, B, S, d]``): q, k and v come from batched
GEMMs, and the attention is ONE kernel call over the ``[M·B, S, H, D]``
rows. The kernel treats each batch row on its own, so its output is bit
for bit that of M separate calls, and the launch count does not depend on
M.

Decode caches are ring buffers of width W, ``{"k": [B, W, Hkv, D], "v":
[B, W, Hkv, D]}`` in the model's dtype: W = S is the ordinary full cache,
W < S the sliding ring whose slot for position p is ``p % W``. Prefill runs
its full-sequence attention through ``ops.attention`` (the flash kernel on
the card) and lays the last W keys and values out in the ring; decode
writes slot ``pos % W`` IN PLACE (the reference returns a new cache, which
XLA updates in place when the caller donates it) and attends over the valid
slots with ``layers.decode_attention`` (plain torch in float32, as the
reference's plain jnp). ``pos`` is a 0-d int tensor on the cache's device,
so a decode step never waits for the host.

MLA and cross-attention are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
import torch.nn.functional as F

from repro_torch.models.layers import (apply_rope, decode_attention,
                                       dense_init, init_norm, norm_fwd,
                                       norm_fwd_batched, rope_angles)
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


def init_kv_cache(cfg, batch, width, dtype, *, device="cpu"):
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, width, hkv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, width, hkv, hd), dtype=dtype,
                             device=device)}


def attention_prefill(p, cfg, x, width):
    """Prefill: the full causal attention (the config's sliding window) and
    the cache of the last ``width`` keys and values: slots ``[0, S)`` when
    width >= S, else the ring layout ``roll(last width, S % width)``."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    positions = torch.arange(S, device=x.device)[None, :]
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = ops.attention(q, k, v, causal=True, window=cfg.sliding_window)
    out = out.reshape(B, S, -1) @ p["wo"]
    if width >= S:  # straight copy into slots [0, S)
        pad = (0, 0, 0, 0, 0, width - S)
        cache = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    else:  # ring layout: slot = pos % width for the last `width` positions
        shift = S % width
        cache = {"k": torch.roll(k[:, -width:], shift, dims=1),
                 "v": torch.roll(v[:, -width:], shift, dims=1)}
    return out, cache


def attention_decode(p, cfg, x, cache, pos, *, window=0):
    """One-token decode. x [B, 1, d]; ``pos`` the absolute position, a 0-d
    int tensor on x's device. Writes slot ``pos % W`` of ``cache`` in place
    and returns (out [B, 1, d], cache)."""
    B = x.shape[0]
    W = cache["k"].shape[1]
    q, k, v = _qkv(p, cfg, x)
    cos, sin = rope_angles(pos[None, None], cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    slot = torch.remainder(pos, W).reshape(1)
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    idx = torch.arange(W, device=x.device)
    valid = (idx <= pos) | (pos >= W)
    if window:
        w = min(window, W)
        # the ring holds the last W positions; keep the last `w`
        age = torch.remainder(slot - idx, W)
        valid = valid & (age < w)
    out = decode_attention(q, cache["k"], cache["v"],
                           valid[None, :].expand(B, W))
    return out.reshape(B, 1, -1) @ p["wo"], cache


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
