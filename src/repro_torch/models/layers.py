"""Shared building blocks of the dense transformer: init helpers, norms,
RoPE, MLPs, embeddings and the token cross-entropy.

Counterpart of ``repro/models/layers.py:22-175``. Everything is functional:
``init_*`` builds a params dict, ``*_fwd`` applies it, and parameters are
plain nested dicts in the reference's layouts (``[d_in, d_out]`` dense
weights), so the flat index of every scalar is the reference's.

The ``*_batched`` forms take a leading client axis ``[M, ...]`` on the
weights and the activations (the reference's per-client functions under
``jax.vmap``, as the flat FedZO round maps the loss over its M clients):
the dense products are batched ``torch.matmul`` calls, and the RMSNorm is
one kernel launch whatever M is, each client's rows under its own scale.

Weights are drawn from the jax-compatible key chain (``utils/prng.py``) on
the device given, so an init from a seed is the reference's within a few
float32 ulp (the normals' erfinv). RMSNorm goes through ``kernels/ops.py``
(the CUDA kernel on the card, its plain version on the CPU); layernorm has
no TPU kernel and stays plain torch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.utils import prng

# ---------------------------------------------------------------------------
# init helpers


def dense_init(rng, d_in, d_out, dtype, scale=None, *, device="cpu"):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = prng.normal(rng, (d_in, d_out), device=device) * scale
    return w.to(dtype)


def init_norm(d, kind="rmsnorm", dtype=torch.float32, *, device="cpu"):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_fwd(p, x, kind="rmsnorm", eps=1e-6):
    if kind == "layernorm":
        xf = x.to(torch.float32)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].to(torch.float32) \
            + p["bias"].to(torch.float32)
        return out.to(x.dtype)
    return ops.rmsnorm(x, p["scale"], eps=eps)


def norm_fwd_batched(p, x, kind="rmsnorm", eps=1e-6):
    """``norm_fwd`` per client: x ``[M, ..., d]``, ``p`` leaves ``[M, d]``.
    RMSNorm is one launch over all M·… rows, client m's rows scaled by its
    own row of ``p["scale"]``."""
    if kind == "layernorm":
        bcast = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        return norm_fwd({k: v.reshape(bcast) for k, v in p.items()}, x, kind,
                        eps)
    return ops.rmsnorm(x, p["scale"], eps=eps)


# ---------------------------------------------------------------------------
# RoPE


def rope_angles(positions, head_dim, theta):
    """positions [*, S] -> (cos, sin) [*, S, head_dim/2] in fp32."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [B, S, H, D]; cos/sin [B?, S, D/2] broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos.unsqueeze(-2).to(torch.float32)
    s = sin.unsqueeze(-2).to(torch.float32)
    x1f, x2f = x1.to(torch.float32), x2.to(torch.float32)
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP


def init_mlp(rng, d_model, d_ff, act, dtype, *, device="cpu"):
    ks = prng.split(rng, 3)
    if act in ("swiglu", "geglu"):
        return {"w_gate": dense_init(ks[0], d_model, d_ff, dtype,
                                     device=device),
                "w_up": dense_init(ks[1], d_model, d_ff, dtype,
                                   device=device),
                "w_down": dense_init(ks[2], d_ff, d_model, dtype,
                                     device=device)}
    return {"w_up": dense_init(ks[0], d_model, d_ff, dtype, device=device),
            "w_down": dense_init(ks[1], d_ff, d_model, dtype, device=device)}


def _act(h, act):
    if act == "relu_sq":
        return torch.square(F.relu(h))
    if act in ("gelu", "geglu"):
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(h, approximate="tanh")
    if act in ("silu", "swiglu"):
        return F.silu(h)
    raise KeyError(act)


def mlp_fwd(p, x, act):
    if act in ("swiglu", "geglu"):
        h = _act(x @ p["w_gate"], act) * (x @ p["w_up"])
    else:
        h = _act(x @ p["w_up"], act)
    return h @ p["w_down"]


def mlp_fwd_batched(p, x, act):
    """``mlp_fwd`` per client: x ``[M, ..., d]``, weights ``[M, d_in,
    d_out]``; each product one batched GEMM over ``[M, T, d]`` rows."""
    M, d = x.shape[0], x.shape[-1]
    out = mlp_fwd(p, x.reshape(M, -1, d), act)
    return out.reshape(x.shape[:-1] + out.shape[-1:])


# ---------------------------------------------------------------------------
# Embedding / unembedding


VOCAB_PAD = 32  # the reference pads vocab rows so the table shards evenly
NEG_INF = -1e30


def padded_vocab(vocab):
    return vocab + (-vocab) % VOCAB_PAD


def init_embed(rng, vocab, d_model, dtype, tie, *, device="cpu"):
    """Embedding (+ unembedding) with the vocab dim padded to a multiple of
    VOCAB_PAD; padded logit columns are masked in ``unembed_fwd``."""
    vp = padded_vocab(vocab)
    ks = prng.split(rng, 2)
    p = {"tok": dense_init(ks[0], vp, d_model, dtype, scale=0.02,
                           device=device)}
    if not tie:
        p["unembed"] = dense_init(ks[1], d_model, vp, dtype, device=device)
    return p


def embed_fwd(p, tokens):
    """Token embedding lookup with ``jnp.take(table, tokens, axis=0)``'s
    semantics: a negative id counts from the end of the table, and an id
    outside ``[-rows, rows)`` gives a row of NaN. One gather from a clamped
    index, then a mask: no branch on the ids' values."""
    table = p["tok"]
    valid, idx = _take_index(tokens, table.shape[0])
    return torch.where(valid[..., None], table[idx], float("nan"))


def _take_index(tokens, rows):
    """(valid, row index) of ``jnp.take`` on a table of ``rows`` rows."""
    ids = tokens.to(torch.int64)
    valid = (ids >= -rows) & (ids < rows)
    idx = torch.where(ids < 0, ids + rows, ids).clamp(0, rows - 1)
    return valid, idx


def embed_fwd_batched(p, tokens):
    """``embed_fwd`` per client: table ``[M, V, d]`` (a view is read in
    place), tokens ``[M, ...]``; client m's ids index its own table."""
    table = p["tok"]
    M, rows = table.shape[:2]
    valid, idx = _take_index(tokens, rows)
    m = torch.arange(M, device=table.device).reshape(
        (M,) + (1,) * (tokens.dim() - 1))
    return torch.where(valid[..., None], table[m, idx], float("nan"))


def unembed_fwd(p, x, tie, vocab=None):
    """Logits in param dtype; padded vocab columns masked to a large
    negative so the softmax ignores them. Client-batched as it stands: x
    ``[M, T, d]`` against ``[M, ...]`` weights is one batched product (the
    tied unembedding with each client's ``embed[m]ᵀ``)."""
    w = p["tok"].transpose(-1, -2) if tie else p["unembed"]
    logits = x @ w
    vp = logits.shape[-1]
    if vocab is not None and vocab != vp:
        v_iota = torch.arange(vp, device=logits.device)
        logits = torch.where(v_iota < vocab, logits,
                             torch.tensor(NEG_INF, dtype=logits.dtype,
                                          device=logits.device))
    return logits


def unembed_fwd_batched(p, x, tie, vocab=None):
    """``unembed_fwd`` per client: x ``[M, ..., d]`` -> ``[M, ..., V]``."""
    M, d = x.shape[0], x.shape[-1]
    logits = unembed_fwd(p, x.reshape(M, -1, d), tie, vocab)
    return logits.reshape(x.shape[:-1] + logits.shape[-1:])


def softmax_xent(logits, labels):
    """Mean token cross-entropy; logits [.., V] (any float), labels int [..].

    The label logit is gathered: bitwise the reference's masked sum
    (``where(iota == label, lf, 0)`` summed), whose only nonzero term it is.
    """
    return torch.mean(_token_xent(logits, labels))


def softmax_xent_batched(logits, labels):
    """``softmax_xent`` per client: logits ``[M, .., V]``, labels ``[M, ..]``
    -> ``[M]`` means."""
    return torch.mean(_token_xent(logits, labels).reshape(
        labels.shape[0], -1), dim=1)


def _token_xent(logits, labels):
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(lf - m[..., None]), dim=-1))
    ll = torch.gather(lf, -1, labels.to(torch.int64)[..., None])[..., 0]
    return lse - ll
