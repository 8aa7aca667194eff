"""Encoder-decoder backbone (SeamlessM4T style): a bidirectional encoder
over stubbed audio-frame embeddings and a causal decoder with a
cross-attention in every layer.

Counterpart of ``repro/models/encdec.py:19-155``. The audio frontend (mel
spectrogram and conv codec) is the reference's stub: the batch carries
frame embeddings ``src_embeds`` ``[B, n_frames, d_model]``. The tree is
the reference's: ``embed``, ``enc_blocks`` and ``dec_blocks`` stacked over
their layers (``transformer._stack_init``, layer i from ``fold_in(rng,
i)``), ``enc_norm`` and ``final_norm``. The reference scans each stack;
here a Python loop runs over layer slices (views).

Kernels: each encoder layer's self-attention is one non-causal flash
launch over the source frames; each decoder layer launches its causal
self-attention, the cross K norm (``cross_kv``) and the cross q norm
(RMSNorm over the head dim, whatever ``cfg.norm`` is) and the non-causal
cross-attention over the memory. The block norms follow ``cfg.norm``
(seamless-m4t-large-v2: layernorm, plain torch). A prefill of an L-layer
decoder over an E-layer encoder thus makes E + 2L attention and 2L RMSNorm
launches (+ the block norms under rmsnorm); a decode step L cross
attentions at Sq = 1 and L q norms (its self-attention is the plain
``layers.decode_attention``, as the reference's).

``loss_fn_batched`` is ``loss_fn`` per client of a cohort (the reference's
loss under ``jax.vmap``, as the flat and wide FedZO rounds map it): leaves
``[M, ...]``, batch leaves ``[M, B, ...]``, ``[M]`` losses. The products
are batched GEMMs; each attention, cross k norm and cross q norm is one
launch over the cohort (the norms under ``[M, hd]`` group scales), so a
forward makes E + 2L attention and 2L RMSNorm launches whatever M is.

Serving: ``prefill`` encodes the source once and returns the last token's
logits and the cache ``{"self": {"k", "v"} [L, B, W, Hkv, hd], "cross_k",
"cross_v" [L, B, n_frames, Hq, hd]}``: the self ring cache and each
layer's cross K/V, written once. ``decode_step`` reads the cross K/V and
writes the self cache's slot in place.
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
from repro_torch.models.transformer import (_dtype, _layer, _layer_batched,
                                            _stack, _stack_init,
                                            check_family, repeat_rows)
from repro_torch.utils import prng
from repro_torch.utils.shardutil import constrain_batch, on_mesh


def init_enc_block(rng, cfg, dtype, *, device="cpu"):
    ks = prng.split(rng, 2)
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
            "norm2": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
            "attn": attn.init_attention(ks[0], cfg, dtype, device=device),
            "mlp": init_mlp(ks[1], cfg.d_model, cfg.d_ff, cfg.act, dtype,
                            device=device)}


def init_dec_block(rng, cfg, dtype, *, device="cpu"):
    ks = prng.split(rng, 3)
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
            "norm2": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
            "norm3": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
            "attn": attn.init_attention(ks[0], cfg, dtype, device=device),
            "xattn": attn.init_cross_attention(ks[1], cfg, dtype,
                                               device=device),
            "mlp": init_mlp(ks[2], cfg.d_model, cfg.d_ff, cfg.act, dtype,
                            device=device)}


def init_params(rng, cfg, *, device="cpu"):
    check_family(cfg)
    dtype = _dtype(cfg)
    ks = prng.split(rng, 4)
    return {
        "embed": init_embed(ks[0], cfg.vocab, cfg.d_model, dtype,
                            cfg.tie_embeddings, device=device),
        "enc_blocks": _stack_init(ks[1], cfg.encoder_layers, lambda k:
                                  init_enc_block(k, cfg, dtype,
                                                 device=device)),
        "dec_blocks": _stack_init(ks[2], cfg.n_layers, lambda k:
                                  init_dec_block(k, cfg, dtype,
                                                 device=device)),
        "enc_norm": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
    }


def param_specs(cfg):
    """The parameter tree on the ``meta`` device: the paths, shapes and
    dtypes of ``init_params`` with no allocation and no draw (the
    reference's ``jax.eval_shape`` of its init; the dry-run's input)."""
    return init_params(prng.key(0), cfg, device="meta")


def encode(params, cfg, src_embeds, mesh=None):
    """The bidirectional encoder over frame embeddings ``[B, S_src, d]``."""
    h = constrain_batch(src_embeds, mesh)
    for i in range(cfg.encoder_layers):
        lp = _layer(params["enc_blocks"], i)
        hn = norm_fwd(lp["norm1"], h, cfg.norm)
        h = h + attn.attention_fwd(lp["attn"], cfg, hn, causal=False)
        hn = norm_fwd(lp["norm2"], h, cfg.norm)
        h = h + mlp_fwd(lp["mlp"], hn, cfg.act)
    return norm_fwd(params["enc_norm"], h, cfg.norm)


def _dec_block(lp, cfg, h, memory_kv):
    hn = norm_fwd(lp["norm1"], h, cfg.norm)
    h = h + attn.attention_fwd(lp["attn"], cfg, hn)
    hn = norm_fwd(lp["norm2"], h, cfg.norm)
    h = h + attn.cross_attention_fwd(lp["xattn"], cfg, hn, memory_kv)
    hn = norm_fwd(lp["norm3"], h, cfg.norm)
    return h + mlp_fwd(lp["mlp"], hn, cfg.act)


def loss_fn(params, batch, cfg, n_groups=1, *, mesh=None):
    """Mean next-token cross entropy of the decoder over the encoded
    ``src_embeds`` (``[G]`` group means with ``n_groups > 1``); with a
    ``mesh``, on DTensors (``transformer.loss_fn``)."""
    with on_mesh(mesh):
        return _loss_fn(params, batch, cfg, n_groups, mesh)


def _loss_fn(params, batch, cfg, n_groups, mesh):
    memory = encode(params, cfg, batch["src_embeds"], mesh)
    h = constrain_batch(embed_fwd(params["embed"], batch["tokens"]), mesh)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_blocks"], i)
        h = _dec_block(lp, cfg, h, attn.cross_kv(lp["xattn"], cfg, memory))
    hf = norm_fwd(params["final_norm"], h, cfg.norm)
    logits = unembed_fwd(params["embed"], hf, cfg.tie_embeddings, cfg.vocab)
    return softmax_xent(logits, batch["labels"], n_groups)


# ---------------------------------------------------------------------------
# client-batched forward (the flat round's cohort)


def encode_batched(params, cfg, src_embeds):
    """``encode`` per client: leaves ``[M, ...]``, src_embeds ``[M, B,
    S_src, d]``; each layer's attention one non-causal launch over the
    ``[M·B]`` rows."""
    h = src_embeds
    for i in range(cfg.encoder_layers):
        lp = _layer_batched(params["enc_blocks"], i)
        hn = norm_fwd_batched(lp["norm1"], h, cfg.norm)
        h = h + attn.attention_fwd_batched(lp["attn"], cfg, hn, causal=False)
        hn = norm_fwd_batched(lp["norm2"], h, cfg.norm)
        h = h + mlp_fwd_batched(lp["mlp"], hn, cfg.act)
    return norm_fwd_batched(params["enc_norm"], h, cfg.norm)


def _dec_block_batched(lp, cfg, h, memory_kv):
    hn = norm_fwd_batched(lp["norm1"], h, cfg.norm)
    h = h + attn.attention_fwd_batched(lp["attn"], cfg, hn)
    hn = norm_fwd_batched(lp["norm2"], h, cfg.norm)
    h = h + attn.cross_attention_fwd_batched(lp["xattn"], cfg, hn, memory_kv)
    hn = norm_fwd_batched(lp["norm3"], h, cfg.norm)
    return h + mlp_fwd_batched(lp["mlp"], hn, cfg.act)


def loss_fn_batched(params, batch, cfg):
    """``loss_fn`` per client: leaves ``[M', ...]``, batch leaves ``[M, B,
    ...]`` -> ``[M']`` losses. M' = r·M on the wide route: rows m·r … m·r +
    r − 1 take client m's tokens and frames, and the encoder runs once per
    row, whose weights are its own. Per forward E + 2L attention and 2L
    RMSNorm launches (the cross k and q norms; + the block norms under
    rmsnorm), whatever M is."""
    check_family(cfg)
    r = params["final_norm"]["scale"].shape[0] // batch["tokens"].shape[0]
    tokens, labels, src = (repeat_rows(batch[k], r) for k in (
        "tokens", "labels", "src_embeds"))
    memory = encode_batched(params, cfg, src)
    h = embed_fwd_batched(params["embed"], tokens)
    for i in range(cfg.n_layers):
        lp = _layer_batched(params["dec_blocks"], i)
        h = _dec_block_batched(lp, cfg, h, attn.cross_kv_batched(
            lp["xattn"], cfg, memory))
    hf = norm_fwd_batched(params["final_norm"], h, cfg.norm)
    logits = unembed_fwd_batched(params["embed"], hf, cfg.tie_embeddings,
                                 cfg.vocab)
    return softmax_xent_batched(logits, labels)


# ---------------------------------------------------------------------------
# prefill / decode


def init_cache(cfg, batch, width, *, device="cpu"):
    """The zeroed decode cache: ``{"self": {"k", "v"}}`` ``[L, B, W, Hkv,
    hd]`` and ``"cross_k"``, ``"cross_v"`` ``[L, B, n_frames, Hq, hd]``, in
    the model's dtype."""
    check_family(cfg)
    dtype, L = _dtype(cfg), cfg.n_layers
    kv = attn.init_kv_cache(cfg, batch, width, dtype, device=device)
    xkv = (L, batch, cfg.n_frontend_tokens, cfg.n_heads, cfg.head_dim)
    return {"self": {k: v.expand((L,) + tuple(v.shape)).contiguous()
                     for k, v in kv.items()},
            "cross_k": torch.zeros(xkv, dtype=dtype, device=device),
            "cross_v": torch.zeros(xkv, dtype=dtype, device=device)}


def prefill(params, tokens, src_embeds, cfg, width, *, mesh=None):
    """Encode the source and prefill the decoder's self and cross caches:
    tokens ``[B, S]``, src_embeds ``[B, S_src, d]`` -> (last-token logits
    ``[B, V]``, cache)."""
    check_family(cfg)
    with on_mesh(mesh):
        return _prefill(params, tokens, src_embeds, cfg, width, mesh)


def _prefill(params, tokens, src_embeds, cfg, width, mesh):
    memory = encode(params, cfg, src_embeds, mesh)
    h = constrain_batch(embed_fwd(params["embed"], tokens), mesh)
    selfs, xk, xv = [], [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_blocks"], i)
        kv = attn.cross_kv(lp["xattn"], cfg, memory)
        hn = norm_fwd(lp["norm1"], h, cfg.norm)
        o, c = attn.attention_prefill(lp["attn"], cfg, hn, width)
        h = h + o
        hn = norm_fwd(lp["norm2"], h, cfg.norm)
        h = h + attn.cross_attention_fwd(lp["xattn"], cfg, hn, kv)
        hn = norm_fwd(lp["norm3"], h, cfg.norm)
        h = h + mlp_fwd(lp["mlp"], hn, cfg.act)
        selfs.append(c)
        xk.append(kv["k"])
        xv.append(kv["v"])
    hf = norm_fwd(params["final_norm"], h, cfg.norm)
    logits = unembed_fwd(params["embed"], hf[:, -1:], cfg.tie_embeddings,
                         cfg.vocab)
    return logits[:, 0], {"self": _stack(selfs), "cross_k": torch.stack(xk),
                          "cross_v": torch.stack(xv)}


def decode_step(params, token, cache, pos, cfg, window=0, *, mesh=None):
    """token ``[B, 1]``; ``pos`` a 0-d int tensor on the parameters' device
    (an int is moved there) -> (logits ``[B, V]``, cache), the self cache's
    slot written in place. The cross-attention is the flash kernel at Sq =
    1 over the cached cross K/V."""
    check_family(cfg)
    with on_mesh(mesh):
        return _decode_step(params, token, cache, pos, cfg, window)


def _decode_step(params, token, cache, pos, cfg, window):
    h = embed_fwd(params["embed"], token)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=h.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_blocks"], i)
        hn = norm_fwd(lp["norm1"], h, cfg.norm)
        o, _ = attn.attention_decode(lp["attn"], cfg, hn,
                                     _layer(cache["self"], i), pos,
                                     window=window)
        h = h + o
        hn = norm_fwd(lp["norm2"], h, cfg.norm)
        q = attn.cross_q(lp["xattn"], cfg, hn)
        h = h + attn.cross_attend(lp["xattn"], q, cache["cross_k"][i],
                                  cache["cross_v"][i])
        hn = norm_fwd(lp["norm3"], h, cfg.norm)
        h = h + mlp_fwd(lp["mlp"], hn, cfg.act)
    hf = norm_fwd(params["final_norm"], h, cfg.norm)
    logits = unembed_fwd(params["embed"], hf, cfg.tie_embeddings, cfg.vocab)
    return logits[:, 0], cache
