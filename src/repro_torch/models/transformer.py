"""Decoder-only transformer assembly, dense family.

Counterpart of ``repro/models/transformer.py:39-179, 229-388``. Layers are stacked:
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

The classifier head (``init_classifier``, ``classifier_logits``,
``classifier_loss``, ``classifier_accuracy``) is the neural FedZO
workload's transformer track: images cut into patch tokens, the LM's
stacked blocks, mean-pooled into a linear head. Its client-batched form
(``classifier_logits_batched``, ``classifier_loss_batched``) takes leaves
``[M', ...]`` against a batch ``[M, ...]`` with M' = r·M (r = 1 on the flat
round, b2 on the wide route, whose r perturbed copies of a client share
its batch), and runs each RMSNorm and attention as one launch.

Serving (``init_cache``, ``prefill``, ``decode_step``) runs the same
per-layer loop: prefill returns the last token's logits ``[B, V]`` and a
cache ``{"blocks": {"k", "v"}}`` stacked over layers (``[L, B, W, Hkv,
D]``); a decode step takes one token per row and a 0-d position tensor,
and writes each layer's slot of that cache in place.

FedZO never calls a gradient: the forward is all the train step needs.
MoE, MLA, MTP, ssm and hybrid stacks are not ported and raise.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_fwd,
                                       embed_fwd_batched, init_embed,
                                       init_mlp, init_norm,
                                       mlp_fwd, mlp_fwd_batched, norm_fwd,
                                       norm_fwd_batched, softmax_xent,
                                       softmax_xent_batched, unembed_fwd,
                                       unembed_fwd_batched)
from repro_torch.models.simple import mean_xent, mean_xent_batched
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
        # gemma-style scale, rounded to h's dtype: a Python scalar holding
        # that value computes as a 0-d tensor would, with no host wait
        h = h * float(torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype))
    return h


def loss_fn(params, batch, cfg, n_groups=1):
    """Mean next-token cross entropy: FedZO's F(x, ξ). ``n_groups > 1``
    returns the ``[G]`` per-group means (the pod round's silos)."""
    tokens, labels = batch["tokens"], batch["labels"]
    h = _embed_scale(embed_fwd(params["embed"], tokens), cfg)
    hf = backbone(params, cfg, h)
    logits = unembed_fwd(params["embed"], hf, cfg.tie_embeddings, cfg.vocab)
    return softmax_xent(logits, labels, n_groups)


# ---------------------------------------------------------------------------
# prefill / decode with caches


def init_cache(cfg, batch, width, *, device="cpu"):
    """Zeroed decode cache, stacked over layers: ``{"blocks": {"k", "v"}}``
    with leaves ``[L, B, W, Hkv, D]`` in the model's dtype."""
    check_dense(cfg)
    c = attn.init_kv_cache(cfg, batch, width, _dtype(cfg), device=device)
    return {"blocks": {k: v.expand((cfg.n_layers,) + tuple(v.shape))
                       .contiguous() for k, v in c.items()}}


def block_prefill(p, cfg, h, width):
    """Full-sequence block forward that also returns its decode cache."""
    hn = norm_fwd(p["norm1"], h, cfg.norm)
    o, cache = attn.attention_prefill(p["attn"], cfg, hn, width)
    h = h + o
    hn = norm_fwd(p["norm2"], h, cfg.norm)
    return h + mlp_fwd(p["mlp"], hn, cfg.act), cache


def block_decode(p, cfg, h, cache, pos, *, window=0):
    """One-token block forward; writes ``cache``'s slot in place."""
    hn = norm_fwd(p["norm1"], h, cfg.norm)
    o, cache = attn.attention_decode(p["attn"], cfg, hn, cache, pos,
                                     window=window or cfg.sliding_window)
    h = h + o
    hn = norm_fwd(p["norm2"], h, cfg.norm)
    return h + mlp_fwd(p["mlp"], hn, cfg.act), cache


def prefill(params, tokens, cfg, width):
    """tokens [B, S] -> (last-token logits [B, V], cache of width
    ``width``)."""
    check_dense(cfg)
    h = _embed_scale(embed_fwd(params["embed"], tokens), cfg)
    caches = []
    for i in range(cfg.n_layers):
        h, c = block_prefill(_layer(params["blocks"], i), cfg, h, width)
        caches.append(c)
    hf = norm_fwd(params["final_norm"], h, cfg.norm)
    logits = unembed_fwd(params["embed"], hf[:, -1:], cfg.tie_embeddings,
                         cfg.vocab)
    return logits[:, 0], {"blocks": _stack(caches)}


def decode_step(params, token, cache, pos, cfg, window=0):
    """token [B, 1] int; ``pos`` the absolute position (a 0-d int tensor on
    the parameters' device; an int is moved there) -> (logits [B, V],
    cache), the cache updated in place."""
    check_dense(cfg)
    h = _embed_scale(embed_fwd(params["embed"], token), cfg)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=h.device)
    blocks = cache["blocks"]
    for i in range(cfg.n_layers):
        h, _ = block_decode(_layer(params["blocks"], i), cfg, h,
                            _layer(blocks, i), pos, window=window)
    hf = norm_fwd(params["final_norm"], h, cfg.norm)
    logits = unembed_fwd(params["embed"], hf, cfg.tie_embeddings, cfg.vocab)
    return logits[:, 0], cache


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
    B, S]`` -> ``[M]`` losses. Leaves ``[r·M, ...]`` (the wide route's r
    perturbed copies of each client) take client m's tokens for rows m·r …
    m·r + r − 1 (the token ids are repeated, the weights read in place)."""
    tokens, labels = batch["tokens"], batch["labels"]
    r = params["final_norm"]["scale"].shape[0] // tokens.shape[0]
    if r > 1:
        tokens, labels = (t.repeat_interleave(r, 0) for t in (tokens, labels))
    h = _embed_scale(embed_fwd_batched(params["embed"], tokens), cfg)
    hf = backbone_batched(params, cfg, h)
    logits = unembed_fwd_batched(params["embed"], hf, cfg.tie_embeddings,
                                 cfg.vocab)
    return softmax_xent_batched(logits, labels)


# ---------------------------------------------------------------------------
# tiny classifier head (the neural workload's transformer track)


def init_classifier(rng, cfg, *, n_patches, patch_dim, n_classes,
                    device="cpu"):
    """Patch embedding, a zero positional table, cfg.n_layers stacked
    blocks, the final norm and the head, from ``split(rng, 3)`` as the
    reference draws them."""
    check_dense(cfg)
    dtype = _dtype(cfg)
    ks = prng.split(rng, 3)
    return {"patch": dense_init(ks[0], patch_dim, cfg.d_model, dtype,
                                device=device),
            "pos": torch.zeros((n_patches, cfg.d_model), dtype=dtype,
                               device=device),
            "blocks": _stack_init(ks[1], cfg.n_layers,
                                  lambda k: init_block(k, cfg, dtype,
                                                       device=device)),
            "final_norm": init_norm(cfg.d_model, cfg.norm, dtype,
                                    device=device),
            "head": dense_init(ks[2], cfg.d_model, n_classes, dtype,
                               device=device)}


def classifier_logits(params, cfg, x):
    """x ``[B, n_patches·patch_dim]`` (or ``[B, n_patches, patch_dim]``) ->
    logits ``[B, n_classes]``."""
    n_p = params["pos"].shape[0]
    h = x.reshape(x.shape[0], n_p, -1).to(_dtype(cfg))
    h = h @ params["patch"] + params["pos"]
    h = _scan_blocks(params["blocks"], cfg, h)
    h = norm_fwd(params["final_norm"], h, cfg.norm)
    return torch.mean(h, dim=1) @ params["head"]


def classifier_loss(params, batch, cfg):
    return mean_xent(classifier_logits(params, cfg, batch["x"]), batch["y"])


def classifier_accuracy(params, batch, cfg):
    pred = torch.argmax(classifier_logits(params, cfg, batch["x"]), dim=-1)
    return torch.mean((pred == batch["y"].to(torch.int64)).to(torch.float32))


def classifier_logits_batched(params, cfg, x):
    """``classifier_logits`` per parameter row: leaves ``[M', ...]``, x
    ``[M, B, ...]`` with M' = r·M (rows m·r … m·r + r − 1 read x[m]) ->
    ``[M', B, n_classes]``. The patch product is one batched GEMM of x[m]
    against the r copies' weights side by side, so x is read as it is."""
    Mp, n_p, d = params["pos"].shape
    M, B = x.shape[:2]
    r = Mp // M
    xt = x.reshape(M, B * n_p, -1).to(_dtype(cfg))
    w = params["patch"]                                  # [M', pd, d]
    if r > 1:
        w = w.reshape(M, r, -1, d).permute(0, 2, 1, 3).reshape(M, -1, r * d)
    h = (xt @ w).reshape(M, B, n_p, r, d).permute(0, 3, 1, 2, 4)
    h = h.reshape(Mp, B, n_p, d) + params["pos"][:, None]
    for i in range(cfg.n_layers):
        h = block_fwd_batched(_layer_batched(params["blocks"], i), cfg, h)
    h = norm_fwd_batched(params["final_norm"], h, cfg.norm)
    return torch.mean(h, dim=2) @ params["head"]


def classifier_loss_batched(params, batch, cfg):
    """``classifier_loss`` per parameter row -> ``[M']`` losses (batch
    leaves ``[M, B, ...]``, M' = r·M as in ``classifier_logits_batched``)."""
    return mean_xent_batched(
        classifier_logits_batched(params, cfg, batch["x"]), batch["y"])
