"""Self-attention of the decoder stacks: GQA/MQA attention and DeepSeek's
Multi-head Latent Attention (MLA), each with its train forward, prefill
and one-token decode against a ring cache.

Counterpart of ``repro/models/attention.py:31-131, 165-269``: GQA
(``init_attention``, ``_qkv``, ``attention_fwd`` with grouped kv heads,
``qkv_bias``, ``qk_norm``, RoPE and the sliding window; ``init_kv_cache``,
``attention_prefill``, ``attention_decode``) and MLA (``init_mla``,
``_mla_q``, ``mla_fwd``, ``init_mla_cache``, ``mla_prefill``,
``mla_decode``). The full-sequence attention goes through
``kernels/ops.attention`` on the reference's ``[B, S, H, D]`` layout: the
CUDA flash kernel on the card, its plain blocked version on the CPU (the
reference uses ``chunked_attention``, the jnp twin of its Pallas kernel).
MLA's is the kernel's unequal pair: q and k of head dim nope + rope (192
at DeepSeek-V3's width), v of ``v_head_dim`` (128), at the explicit scale
1/√(nope + rope).

``attention_fwd_batched`` is the GQA forward per client of a cohort
(weights ``[M, ...]``, x ``[M, B, S, d]``): q, k and v come from batched
GEMMs, and the attention is ONE kernel call over the ``[M·B, S, H, D]``
rows. The kernel treats each batch row on its own, so its output is bit
for bit that of M separate calls, and the launch count does not depend on
M. ``mla_fwd_batched`` is MLA's: the latents' RMSNorms and the attention
one launch each for the cohort. ``cross_kv_batched``, ``cross_q_batched``
and ``cross_attention_fwd_batched`` are the cross-attention's: the k and q
norms one launch each under ``[M, hd]`` group scales, the attention one
non-causal launch with the cohort folded into the batch axis.

Decode caches are ring buffers of width W: ``{"k": [B, W, Hkv, D], "v":
[B, W, Hkv, D]}`` for GQA, ``{"latent": [B, W, kv_lora + rope]}`` (the
compressed c_kv ++ k_rope) for MLA, in the model's dtype. W = S is the
ordinary full cache, W < S the sliding ring whose slot for position p is
``p % W``. Prefill lays the last W positions out in the ring; decode
writes slot ``pos % W`` IN PLACE (the reference returns a new cache, which
XLA updates in place when the caller donates it) and attends over the
valid slots: GQA with ``layers.decode_attention``, MLA in the absorbed
form (``wk_b`` folded into q, ``wv_b`` applied after the softmax), both
plain torch in float32 as the reference's plain jnp. ``pos`` is a 0-d int
tensor on the cache's device, so a decode step never waits for the host.

MLA's ``c_kv`` is the first ``kv_lora`` columns of each ``[kv_lora +
rope]`` row (a strided view); it is made contiguous before the RMSNorm,
whose kernel takes contiguous rows.

Cross-attention (``init_cross_attention``, ``cross_kv``,
``cross_attention_fwd``; reference ``attention.py:134-160``): K and V of
the memory with ``n_heads`` heads, q and k RMS-normed over the head dim
(kernel launches whatever ``cfg.norm`` is), and the attention the flash
kernel without a causal mask over Sk ≠ Sq (the memory's length). One-token
decode attends with the same kernel at Sq = 1 over the cached cross K/V
(the reference's ``chunked_attention``, the jnp twin of its Pallas
kernel). ``attention_fwd(causal=False)`` is the enc-dec encoder's
bidirectional self-attention.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (NEG_INF, apply_rope,
                                       decode_attention, dense_init,
                                       init_norm, norm_fwd, norm_fwd_batched,
                                       rope_angles)
from repro_torch.utils import prng
from repro_torch.utils.shardutil import (is_dtensor, merge_last, reduced,
                                         split_last, whole)


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
    if cfg.qkv_bias:   # (a bias is added to whole sums)
        q, k, v = (reduced(t) + p[b] for t, b in ((q, "bq"), (k, "bk"),
                                                  (v, "bv")))
    q = split_last(q, (B, S, hq, hd))
    k = split_last(k, (B, S, hkv, hd))
    v = split_last(v, (B, S, hkv, hd))
    if cfg.qk_norm:
        q = norm_fwd(p["q_norm"], q)
        k = norm_fwd(p["k_norm"], k)
    return q, k, v


def attention_fwd(p, cfg, x, *, causal=True):
    """Full-sequence attention (the train forward; ``causal=False``: the
    bidirectional encoder, which drops the window as the reference does).
    x [B, S, d]."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = ops.attention(q, k, v, causal=causal,
                        window=cfg.sliding_window if causal else 0)
    return merge_last(out) @ p["wo"]


def init_kv_cache(cfg, batch, width, dtype, *, device="cpu"):
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, width, hkv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, width, hkv, hd), dtype=dtype,
                             device=device)}


def _pad_seq(t, width):
    """``t [B, S, ...]`` zero-padded along S to ``width`` rows: a
    concatenation with zeros, whose rule every DTensor release has. A
    DTensor's partial sums are reduced first (a cache holds its sums)."""
    t = reduced(t)
    return torch.cat([t, t.new_zeros((t.shape[0], width - t.shape[1])
                                     + tuple(t.shape[2:]))], dim=1)


def _write_slot(cache, slot, new):
    """``cache [B, W, ...]``'s slot ``slot`` (a ``[1]`` tensor) set to
    ``new [B, 1, ...]`` in place. A DTensor cache (its W dim may be
    sharded: context parallelism) takes an elementwise select over the
    whole ring, which keeps its layout; a plain one an ``index_copy_``."""
    new = new.to(cache.dtype)
    if not is_dtensor(cache):
        cache.index_copy_(1, slot, new)
        return
    if any(p.is_partial() for p in cache.placements):
        raise ValueError(f"a decode cache laid out {cache.placements}: "
                         f"reduce its partial sums first")
    from torch.distributed.tensor import Replicate
    # new laid out as the cache, whole along the ring's W dim
    want = [Replicate() if p.is_shard(1) else p for p in cache.placements]
    if tuple(new.placements) != tuple(want):
        new = new.redistribute(new.device_mesh, want)
    W = cache.shape[1]
    hit = torch.arange(W, device=cache.device) == slot
    hit = hit.reshape((1, W) + (1,) * (cache.ndim - 2))
    cache.copy_(torch.where(hit, new, cache))


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
    out = merge_last(out) @ p["wo"]
    if width >= S:  # straight copy into slots [0, S)
        cache = {"k": _pad_seq(k, width), "v": _pad_seq(v, width)}
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
    _write_slot(cache["k"], slot, k)
    _write_slot(cache["v"], slot, v)
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


def attention_fwd_batched(p, cfg, x, *, causal=True):
    """``attention_fwd`` per client: x ``[M, B, S, d]``, weights ``[M,
    ...]`` -> ``[M, B, S, d]``, with one attention launch (``causal=False``:
    the enc-dec encoder, without the window)."""
    M, B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv_batched(p, cfg, x)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = ops.attention(q, k, v, causal=causal,
                        window=cfg.sliding_window if causal else 0)
    return (out.reshape(M, B * S, -1) @ p["wo"]).reshape(M, B, S, -1)


# ---------------------------------------------------------------------------
# Cross-attention (the VLM's image layers; the enc-dec decoder)


def init_cross_attention(rng, cfg, dtype, kv_dim=None, *, device="cpu"):
    d, hq, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    kv_dim = kv_dim or d
    ks = prng.split(rng, 4)
    return {"wq": dense_init(ks[0], d, hq * hd, dtype, device=device),
            "wk": dense_init(ks[1], kv_dim, hq * hd, dtype, device=device),
            "wv": dense_init(ks[2], kv_dim, hq * hd, dtype, device=device),
            "wo": dense_init(ks[3], hq * hd, d, dtype, device=device),
            "q_norm": init_norm(hd, "rmsnorm", dtype, device=device),
            "k_norm": init_norm(hd, "rmsnorm", dtype, device=device)}


def cross_kv(p, cfg, memory):
    """Cross K/V of the encoder or vision memory ``[B, Sm, kv_dim]``:
    ``n_heads`` heads each (no grouping), k RMS-normed over the head dim
    (a kernel launch whatever ``cfg.norm`` is), v not."""
    B, Sm, _ = memory.shape
    hq, hd = cfg.n_heads, cfg.head_dim
    k = norm_fwd(p["k_norm"], split_last(memory @ p["wk"], (B, Sm, hq, hd)))
    v = split_last(memory @ p["wv"], (B, Sm, hq, hd))
    return {"k": k, "v": v}


def cross_q(p, cfg, x):
    """The RMS-normed cross queries ``[B, S, Hq, hd]`` of x ``[B, S, d]``."""
    B, S, _ = x.shape
    return norm_fwd(p["q_norm"], split_last(
        x @ p["wq"], (B, S, cfg.n_heads, cfg.head_dim)))


def cross_attend(p, q, k, v):
    """Non-causal attention of q ``[B, S, Hq, hd]`` over the memory's k, v
    ``[B, Sm, Hq, hd]`` (one kernel launch, Sq ≠ Sk) and the output
    projection -> ``[B, S, d]``."""
    B, S = q.shape[:2]
    out = ops.attention(q, k, v, causal=False)
    return merge_last(out) @ p["wo"]


def cross_attention_fwd(p, cfg, x, kv):
    """x ``[B, S, d]`` attends over the precomputed cross K/V (no
    causality, no window)."""
    return cross_attend(p, cross_q(p, cfg, x), kv["k"], kv["v"])


def cross_kv_batched(p, cfg, memory):
    """``cross_kv`` per client: memory ``[M, B, Sm, kv_dim]``, weights
    ``[M, ...]`` -> k, v ``[M·B, Sm, Hq, hd]``; the k norm is one launch
    over the cohort, client m's rows under its own ``[M, hd]`` scale."""
    M, B, Sm, _ = memory.shape
    hq, hd = cfg.n_heads, cfg.head_dim
    mt = memory.reshape(M, B * Sm, -1)
    k = norm_fwd_batched(p["k_norm"], (mt @ p["wk"]).reshape(
        M, B, Sm, hq, hd))
    v = mt @ p["wv"]
    return {"k": k.reshape(M * B, Sm, hq, hd),
            "v": v.reshape(M * B, Sm, hq, hd)}


def cross_q_batched(p, cfg, x):
    """``cross_q`` per client: x ``[M, B, S, d]`` -> ``[M·B, S, Hq, hd]``,
    one q-norm launch over the cohort."""
    M, B, S, d = x.shape
    hq, hd = cfg.n_heads, cfg.head_dim
    q = (x.reshape(M, B * S, d) @ p["wq"]).reshape(M, B, S, hq, hd)
    return norm_fwd_batched(p["q_norm"], q).reshape(M * B, S, hq, hd)


def cross_attention_fwd_batched(p, cfg, x, kv):
    """``cross_attention_fwd`` per client: x ``[M, B, S, d]`` over the
    cohort's cross K/V (``cross_kv_batched``) -> ``[M, B, S, d]``, one
    non-causal attention launch over the ``[M·B]`` rows."""
    M, B, S, _ = x.shape
    out = ops.attention(cross_q_batched(p, cfg, x), kv["k"], kv["v"],
                        causal=False)
    return (out.reshape(M, B * S, -1) @ p["wo"]).reshape(M, B, S, -1)


# ---------------------------------------------------------------------------
# DeepSeek Multi-head Latent Attention


def init_mla(rng, cfg, dtype, *, device="cpu"):
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    ks = prng.split(rng, 6)
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": dense_init(ks[0], d, m.q_lora_rank, dtype, device=device),
        "q_norm": init_norm(m.q_lora_rank, "rmsnorm", dtype, device=device),
        "wq_b": dense_init(ks[1], m.q_lora_rank, h * qk_dim, dtype,
                           device=device),
        "wkv_a": dense_init(ks[2], d, m.kv_lora_rank + m.qk_rope_dim, dtype,
                            device=device),
        "kv_norm": init_norm(m.kv_lora_rank, "rmsnorm", dtype, device=device),
        "wk_b": dense_init(ks[3], m.kv_lora_rank, h * m.qk_nope_dim, dtype,
                           device=device),
        "wv_b": dense_init(ks[4], m.kv_lora_rank, h * m.v_head_dim, dtype,
                           device=device),
        "wo": dense_init(ks[5], h * m.v_head_dim, d, dtype, device=device),
    }


def _mla_scale(m):
    return float(1.0 / np.sqrt(m.qk_nope_dim + m.qk_rope_dim))


def _mla_q(p, cfg, x, positions):
    m, h = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    q = norm_fwd(p["q_norm"], x @ p["wq_a"]) @ p["wq_b"]
    q = split_last(q, (B, S, h, m.qk_nope_dim + m.qk_rope_dim))
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    cos, sin = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_kv(p, cfg, x, positions):
    """(c_kv [B, S, kv_lora] normed, k_rope [B, S, 1, rope] rotated)."""
    m = cfg.mla
    kv = x @ p["wkv_a"]
    c_kv = norm_fwd(p["kv_norm"], kv[..., :m.kv_lora_rank].contiguous())
    cos, sin = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], cos, sin)
    return c_kv, k_rope


def mla_fwd(p, cfg, x, *, window=0):
    """Train/prefill MLA in decompressed form: one attention launch at
    head dims (nope + rope, v_head_dim). Returns (out, latent [B, S,
    kv_lora + rope])."""
    m, h = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_kv(p, cfg, x, positions)  # 1 shared rope head
    k_nope = split_last(c_kv @ p["wk_b"], (B, S, h, m.qk_nope_dim))
    v = split_last(c_kv @ p["wv_b"], (B, S, h, m.v_head_dim))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, h, m.qk_rope_dim)], dim=-1)
    out = ops.attention(q, k, v, causal=True, window=window,
                        scale=_mla_scale(m))
    out = merge_last(out) @ p["wo"]
    latent = torch.cat([c_kv, k_rope[:, :, 0]], dim=-1)
    return out, latent


def mla_fwd_batched(p, cfg, x):
    """``mla_fwd`` per client: x ``[M, B, S, d]``, weights ``[M, ...]`` ->
    ``[M, B, S, d]``. The q and kv latents' RMSNorms are one launch each
    over the cohort (each client's rows under its own ``[M, D]`` scale),
    and the attention one launch over the ``[M·B]`` rows at (nope + rope,
    v_head_dim) and the scale 1/√(nope + rope)."""
    m, h = cfg.mla, cfg.n_heads
    M, B, S, d = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    cos, sin = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)
    xt = x.reshape(M, B * S, d)
    q = norm_fwd_batched(p["q_norm"], xt @ p["wq_a"]) @ p["wq_b"]
    q = q.reshape(M * B, S, h, m.qk_nope_dim + m.qk_rope_dim)
    q_rope = apply_rope(q[..., m.qk_nope_dim:], cos, sin)
    kv = xt @ p["wkv_a"]
    c_kv = norm_fwd_batched(p["kv_norm"],
                            kv[..., :m.kv_lora_rank].contiguous())
    k_rope = apply_rope(kv[..., m.kv_lora_rank:].reshape(
        M * B, S, 1, m.qk_rope_dim), cos, sin)   # 1 shared rope head
    k_nope = (c_kv @ p["wk_b"]).reshape(M * B, S, h, m.qk_nope_dim)
    v = (c_kv @ p["wv_b"]).reshape(M * B, S, h, m.v_head_dim)
    q = torch.cat([q[..., :m.qk_nope_dim], q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(M * B, S, h, m.qk_rope_dim)],
                  dim=-1)
    out = ops.attention(q, k, v, causal=True, scale=_mla_scale(m))
    return (out.reshape(M, B * S, -1) @ p["wo"]).reshape(M, B, S, -1)


def init_mla_cache(cfg, batch, width, dtype, *, device="cpu"):
    m = cfg.mla
    return {"latent": torch.zeros((batch, width,
                                   m.kv_lora_rank + m.qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_prefill(p, cfg, x, width):
    """Prefill: ``mla_fwd`` and the latent cache of the last ``width``
    positions (slots ``[0, S)`` when width >= S, else the ring layout)."""
    S = x.shape[1]
    out, latent = mla_fwd(p, cfg, x)
    if width >= S:
        latent = _pad_seq(latent, width)
    else:
        latent = torch.roll(latent[:, -width:], S % width, dims=1)
    return out, {"latent": latent}


def mla_decode(p, cfg, x, cache, pos, *, window=0):
    """Absorbed-form one-token decode against the latent cache only. x [B,
    1, d]; ``pos`` a 0-d int tensor on x's device. Writes slot ``pos % W``
    of ``cache["latent"]`` in place and returns (out [B, 1, d], cache)."""
    m, h = cfg.mla, cfg.n_heads
    B = x.shape[0]
    latent = cache["latent"]
    W = latent.shape[1]
    q_nope, q_rope = _mla_q(p, cfg, x, pos[None, None])
    c_kv, k_rope = _mla_kv(p, cfg, x, pos[None, None])
    new_latent = torch.cat([c_kv, k_rope[:, :, 0]], dim=-1)
    slot = torch.remainder(pos, W).reshape(1)
    _write_slot(latent, slot, new_latent)
    lat = whole(latent, 2)      # a sharded latent dim is gathered to slice
    c_cache = lat[..., :m.kv_lora_rank].to(torch.float32)   # [B, W, r]
    r_cache = lat[..., m.kv_lora_rank:].to(torch.float32)   # [B, W, rope]
    # absorb W_k^b into q: q_eff[b,h,r] = sum_n q_nope[b,h,n] * wk_b[r, h, n]
    wk_b = p["wk_b"].reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_eff = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].to(torch.float32),
                         wk_b.to(torch.float32))
    s = torch.einsum("bhr,bwr->bhw", q_eff, c_cache)
    s = s + torch.einsum("bhr,bwr->bhw", q_rope[:, 0].to(torch.float32),
                         r_cache)
    idx = torch.arange(W, device=x.device)
    valid = (idx <= pos) | (pos >= W)
    if window:
        age = torch.remainder(slot - idx, W)
        valid = valid & (age < min(window, W))
    s = torch.where(valid[None, None], s * _mla_scale(m), NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out_c = torch.einsum("bhw,bwr->bhr", pr, c_cache)
    wv_b = p["wv_b"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhr,rhv->bhv", out_c, wv_b.to(torch.float32))
    out = out.reshape(B, 1, h * m.v_head_dim).to(x.dtype) @ p["wo"]
    return out, cache
