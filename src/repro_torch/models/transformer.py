"""Decoder-only transformer assembly, dense family.

Counterpart of ``repro/models/transformer.py:39-179``. Layers are stacked:
one nested dict whose leaves carry a leading ``[L]`` axis, each layer drawn
from its own ``fold_in(rng, i)`` key, so the parameter tree, its flat order
and its init are the reference's. The reference scans the stack with
``jax.lax.scan``; here ``_scan_blocks`` is a Python loop over layer slices
(views, no copies), because every layer launches the RMSNorm and attention
kernels through ctypes.

``loss_fn_batched`` is ``loss_fn`` per client of a cohort, the reference's
loss under ``jax.vmap`` as the flat round maps it: every leaf carries a
leading ``[M]`` client axis (what ``unflatten`` of the ``[M, n_pad]``
buffer gives, views into it), the batch leaves ``[M, B, S]``, and it
returns ``[M]`` losses. A layer is the slice ``leaf[:, i]`` (a view), the
dense products are batched GEMMs, and each RMSNorm and attention is one
kernel launch over the whole cohort: 2L + 1 RMSNorms and L attentions per
forward, whatever M is.

FedZO never calls a gradient: the forward is all the train step needs.
MoE, MLA, MTP, ssm and hybrid stacks are not ported and raise.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_fwd, embed_fwd_batched,
                                       init_embed, init_mlp, init_norm,
                                       mlp_fwd, mlp_fwd_batched, norm_fwd,
                                       norm_fwd_batched, softmax_xent,
                                       softmax_xent_batched, unembed_fwd,
                                       unembed_fwd_batched)
from repro_torch.utils import prng

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg):
    return _DTYPES[cfg.dtype]


def check_dense(cfg):
    """Reject every architecture the port cannot build as asked."""
    unported = [name for name, on in (
        (f"family={cfg.family!r}", cfg.family != "dense"),
        ("MoE (n_experts)", bool(cfg.n_experts)),
        ("MLA", cfg.mla is not None), ("MTP", cfg.mtp))
        if on]
    if unported:
        raise NotImplementedError(f"{cfg.name}: {', '.join(unported)} not "
                                  f"ported; the port runs the dense family")


# ---------------------------------------------------------------------------
# per-layer init


def init_block(rng, cfg, dtype, *, device="cpu"):
    ks = prng.split(rng, 4)
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
            "norm2": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
            "attn": attn.init_attention(ks[0], cfg, dtype, device=device),
            "mlp": init_mlp(ks[2], cfg.d_model, cfg.d_ff, cfg.act, dtype,
                            device=device)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stack_init(rng, n, init_fn):
    return _stack([init_fn(prng.fold_in(rng, i)) for i in range(n)])


def init_params(rng, cfg, *, device="cpu"):
    check_dense(cfg)
    dtype = _dtype(cfg)
    ks = prng.split(rng, 6)
    return {"embed": init_embed(ks[0], cfg.vocab, cfg.d_model, dtype,
                                cfg.tie_embeddings, device=device),
            "final_norm": init_norm(cfg.d_model, cfg.norm, dtype,
                                    device=device),
            "blocks": _stack_init(ks[1], cfg.n_layers,
                                  lambda k: init_block(k, cfg, dtype,
                                                       device=device))}


# ---------------------------------------------------------------------------
# block forward (full sequence)


def block_fwd(p, cfg, h):
    """Pre-norm block on h [B, S, d]."""
    hn = norm_fwd(p["norm1"], h, cfg.norm)
    h = h + attn.attention_fwd(p["attn"], cfg, hn)
    hn = norm_fwd(p["norm2"], h, cfg.norm)
    return h + mlp_fwd(p["mlp"], hn, cfg.act)


def _layer(stacked, i):
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def _scan_blocks(stacked, cfg, h):
    for i in range(cfg.n_layers):
        h = block_fwd(_layer(stacked, i), cfg, h)
    return h


def backbone(params, cfg, h):
    """Embeddings already applied; h [B, S, d] -> h_normed."""
    h = _scan_blocks(params["blocks"], cfg, h)
    return norm_fwd(params["final_norm"], h, cfg.norm)


def _embed_scale(h, cfg):
    if cfg.d_model >= 1024:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                             device=h.device)  # gemma-style scale
    return h


def loss_fn(params, batch, cfg):
    """Mean next-token cross entropy: FedZO's F(x, ξ)."""
    tokens, labels = batch["tokens"], batch["labels"]
    h = _embed_scale(embed_fwd(params["embed"], tokens), cfg)
    hf = backbone(params, cfg, h)
    logits = unembed_fwd(params["embed"], hf, cfg.tie_embeddings, cfg.vocab)
    return softmax_xent(logits, labels)


# ---------------------------------------------------------------------------
# client-batched forward (the flat round's cohort)


def block_fwd_batched(p, cfg, h):
    """``block_fwd`` per client: h ``[M, B, S, d]``, leaves ``[M, ...]``."""
    hn = norm_fwd_batched(p["norm1"], h, cfg.norm)
    h = h + attn.attention_fwd_batched(p["attn"], cfg, hn)
    hn = norm_fwd_batched(p["norm2"], h, cfg.norm)
    return h + mlp_fwd_batched(p["mlp"], hn, cfg.act)


def _layer_batched(stacked, i):
    if isinstance(stacked, dict):
        return {k: _layer_batched(v, i) for k, v in stacked.items()}
    return stacked[:, i]


def backbone_batched(params, cfg, h):
    for i in range(cfg.n_layers):
        h = block_fwd_batched(_layer_batched(params["blocks"], i), cfg, h)
    return norm_fwd_batched(params["final_norm"], h, cfg.norm)


def loss_fn_batched(params, batch, cfg):
    """``loss_fn`` per client: ``[M, ...]`` leaves and batch leaves ``[M,
    B, S]`` -> ``[M]`` losses."""
    tokens, labels = batch["tokens"], batch["labels"]
    h = _embed_scale(embed_fwd_batched(params["embed"], tokens), cfg)
    hf = backbone_batched(params, cfg, h)
    logits = unembed_fwd_batched(params["embed"], hf, cfg.tie_embeddings,
                                 cfg.vocab)
    return softmax_xent_batched(logits, labels)
