"""VLM backbone (Llama-3.2-Vision style): a self-attention decoder with
interleaved gated cross-attention layers over stubbed vision embeddings.

Counterpart of ``repro/models/vlm.py:21-174``. G groups, each of
``cross_attn_every - 1`` self layers (the decoder-only dense block,
``transformer.block_fwd``) and one gated cross layer. The vision frontend
(ViT and projector) is the reference's stub: the batch carries
post-projector patch embeddings ``vision_embeds`` ``[B, n_img, d_model]``.
The tree is the reference's: ``self_blocks`` stacked ``[G, n_self, ...]``
(a group of n_self layers from its own ``fold_in`` key, G times),
``cross_blocks`` ``[G, ...]`` with the float32 0-d gates ``gate_attn`` and
``gate_mlp`` (zero at init, so ``tanh(gate) = 0`` and the cross layers add
nothing until trained), ``embed`` and ``final_norm``. The reference scans
the groups and, inside, the self layers; here two Python loops run over
slices (views).

The token embedding is scaled by ``d_model ** 0.5`` rounded to h's dtype,
always (the reference's ``h * jnp.asarray(d ** 0.5, h.dtype)``; not the
decoder-only ``_embed_scale``, which scales only from d_model 1,024).

Kernels: per self layer two RMSNorms and, in a full-sequence forward, one
causal flash attention; per cross layer its two block norms, the cross K
norm and q norm, and one non-causal flash attention over the n_img
patches (Sq = 1 in decode). The cross K/V is computed once per cross
layer and forward (the reference's prefill computes it twice, for the
cache and inside ``cross_block_fwd``: the same values).

``loss_fn_batched`` is ``loss_fn`` per client of a cohort (the reference's
loss under ``jax.vmap``, as the flat and wide FedZO rounds map it): leaves
``[M, ...]`` (the gates ``[M]``: each client's ``tanh(gate)`` scales its
own rows), batch leaves ``[M, B, ...]``, ``[M]`` losses. The self layers
are ``transformer.block_fwd_batched``; every RMSNorm and attention is one
launch over the cohort.

Serving: the cache is ``{"self": {"k", "v"} [G, n_self, B, W, Hkv, hd],
"cross_k", "cross_v" [G, B, n_img, Hq, hd]}``; prefill writes the cross
K/V once, decode reads it and writes the self cache's slot in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed_fwd, embed_fwd_batched,
                                       init_embed, init_mlp, init_norm,
                                       mlp_fwd, mlp_fwd_batched, norm_fwd,
                                       norm_fwd_batched, softmax_xent,
                                       softmax_xent_batched, unembed_fwd,
                                       unembed_fwd_batched)
from repro_torch.utils import prng
from repro_torch.utils.shardutil import constrain_batch, on_mesh


def _n_groups(cfg):
    if cfg.n_layers % cfg.cross_attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of cross_attn_every "
                         f"{cfg.cross_attn_every}")
    return cfg.n_layers // cfg.cross_attn_every


def init_cross_block(rng, cfg, dtype, *, device="cpu"):
    ks = prng.split(rng, 3)
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
            "norm2": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
            "xattn": attn.init_cross_attention(ks[0], cfg, dtype,
                                               device=device),
            "mlp": init_mlp(ks[1], cfg.d_model, cfg.d_ff, cfg.act, dtype,
                            device=device),
            "gate_attn": torch.zeros((), dtype=torch.float32, device=device),
            "gate_mlp": torch.zeros((), dtype=torch.float32, device=device)}


def init_params(rng, cfg, *, device="cpu"):
    """The reference's tree; ``self_blocks`` ``[G, n_self, ...]`` is
    allocated once and filled group by group (one group's ``[n_self,
    ...]`` stack lives beside it while it is drawn)."""
    tfm.check_family(cfg)
    dtype = tfm._dtype(cfg)
    G, n_self = _n_groups(cfg), cfg.cross_attn_every - 1
    ks = prng.split(rng, 4)

    def group(k):
        return tfm._stack_init(k, n_self, lambda kk: tfm.init_block(
            kk, cfg, dtype, device=device))

    return {
        "embed": init_embed(ks[0], cfg.vocab, cfg.d_model, dtype,
                            cfg.tie_embeddings, device=device),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
        "self_blocks": tfm._stack_init(ks[1], G, group),
        "cross_blocks": tfm._stack_init(ks[2], G, lambda k: init_cross_block(
            k, cfg, dtype, device=device)),
    }


def param_specs(cfg):
    """The parameter tree on the ``meta`` device: the paths, shapes and
    dtypes of ``init_params`` with no allocation and no draw (the
    reference's ``jax.eval_shape`` of its init; the dry-run's input)."""
    return init_params(prng.key(0), cfg, device="meta")


def _gate(g, h):
    """tanh of a float32 gate, cast to h's dtype (the carry's)."""
    return torch.tanh(g).to(h.dtype)


def _embed_scale(h, cfg):
    # d_model ** 0.5 rounded to h's dtype, as a Python scalar (no host wait)
    return h * float(torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype))


def _embed(params, tokens, cfg):
    return _embed_scale(embed_fwd(params["embed"], tokens), cfg)


def cross_block_fwd(p, cfg, h, kv):
    """The gated cross layer on h ``[B, S, d]`` over the vision memory's
    cross K/V ``kv`` (``attention.cross_kv``)."""
    hn = norm_fwd(p["norm1"], h, cfg.norm)
    h = h + _gate(p["gate_attn"], h) * attn.cross_attention_fwd(
        p["xattn"], cfg, hn, kv)
    hn = norm_fwd(p["norm2"], h, cfg.norm)
    return h + _gate(p["gate_mlp"], h) * mlp_fwd(p["mlp"], hn, cfg.act)


def backbone(params, cfg, h, vision, mesh=None):
    """Embeddings applied; h ``[B, S, d]`` over vision ``[B, n_img, d]`` ->
    the normed hidden states."""
    n_self = cfg.cross_attn_every - 1
    for g in range(_n_groups(cfg)):
        selfs = tfm._layer(params["self_blocks"], g)
        for i in range(n_self):
            h, _ = tfm.block_fwd(tfm._layer(selfs, i), cfg, h, mesh=mesh)
        cross = tfm._layer(params["cross_blocks"], g)
        h = cross_block_fwd(cross, cfg, h,
                            attn.cross_kv(cross["xattn"], cfg, vision))
        h = constrain_batch(h, mesh)
    return norm_fwd(params["final_norm"], h, cfg.norm)


def loss_fn(params, batch, cfg, n_groups=1, *, mesh=None):
    """Mean next-token cross entropy over ``vision_embeds`` (``[G]`` group
    means with ``n_groups > 1``); with a ``mesh``, on DTensors
    (``transformer.loss_fn``)."""
    with on_mesh(mesh):
        return _loss_fn(params, batch, cfg, n_groups, mesh)


def _loss_fn(params, batch, cfg, n_groups, mesh):
    h = constrain_batch(_embed(params, batch["tokens"], cfg), mesh)
    hf = backbone(params, cfg, h, batch["vision_embeds"], mesh)
    logits = unembed_fwd(params["embed"], hf, cfg.tie_embeddings, cfg.vocab)
    return softmax_xent(logits, batch["labels"], n_groups)


# ---------------------------------------------------------------------------
# client-batched forward (the flat round's cohort)


def _gate_batched(g, h):
    """Each client's tanh of its float32 gate (``g`` ``[M]``), cast to h's
    dtype and shaped to broadcast over that client's rows of h ``[M,
    ...]``."""
    return torch.tanh(g).to(h.dtype).reshape((-1,) + (1,) * (h.dim() - 1))


def cross_block_fwd_batched(p, cfg, h, kv):
    """``cross_block_fwd`` per client: h ``[M, B, S, d]``, leaves ``[M,
    ...]`` (the gates ``[M]``), over the cohort's cross K/V
    (``attention.cross_kv_batched``)."""
    hn = norm_fwd_batched(p["norm1"], h, cfg.norm)
    h = h + _gate_batched(p["gate_attn"], h) * \
        attn.cross_attention_fwd_batched(p["xattn"], cfg, hn, kv)
    hn = norm_fwd_batched(p["norm2"], h, cfg.norm)
    return h + _gate_batched(p["gate_mlp"], h) * mlp_fwd_batched(
        p["mlp"], hn, cfg.act)


def backbone_batched(params, cfg, h, vision):
    """``backbone`` per client: h ``[M, B, S, d]`` over vision ``[M, B,
    n_img, d]``, leaves ``[M, ...]`` -> the normed hidden states; the self
    layers are ``transformer.block_fwd_batched``."""
    n_self = cfg.cross_attn_every - 1
    for g in range(_n_groups(cfg)):
        selfs = tfm._layer_batched(params["self_blocks"], g)
        for i in range(n_self):
            h, _ = tfm.block_fwd_batched(tfm._layer_batched(selfs, i), cfg,
                                         h)
        cross = tfm._layer_batched(params["cross_blocks"], g)
        h = cross_block_fwd_batched(cross, cfg, h, attn.cross_kv_batched(
            cross["xattn"], cfg, vision))
    return norm_fwd_batched(params["final_norm"], h, cfg.norm)


def loss_fn_batched(params, batch, cfg):
    """``loss_fn`` per client: leaves ``[M', ...]``, batch leaves ``[M, B,
    ...]`` -> ``[M']`` losses (M' = r·M on the wide route: rows m·r … m·r +
    r − 1 take client m's tokens and patches). Per forward L attention and
    2L + 2G + 1 RMSNorm launches (the block norms, each cross layer's k
    and q norms, the final norm), whatever M is."""
    tfm.check_family(cfg)
    r = params["final_norm"]["scale"].shape[0] // batch["tokens"].shape[0]
    tokens, labels, vision = (tfm.repeat_rows(batch[k], r) for k in (
        "tokens", "labels", "vision_embeds"))
    h = _embed_scale(embed_fwd_batched(params["embed"], tokens), cfg)
    hf = backbone_batched(params, cfg, h, vision)
    logits = unembed_fwd_batched(params["embed"], hf, cfg.tie_embeddings,
                                 cfg.vocab)
    return softmax_xent_batched(logits, labels)


# ---------------------------------------------------------------------------
# prefill / decode


def init_cache(cfg, batch, width, *, device="cpu"):
    """The zeroed decode cache: ``{"self": {"k", "v"}}`` ``[G, n_self, B,
    W, Hkv, hd]`` and ``"cross_k"``, ``"cross_v"`` ``[G, B, n_img, Hq,
    hd]``, in the model's dtype."""
    tfm.check_family(cfg)
    dtype = tfm._dtype(cfg)
    G, n_self = _n_groups(cfg), cfg.cross_attn_every - 1
    kv = attn.init_kv_cache(cfg, batch, width, dtype, device=device)
    xkv = (G, batch, cfg.n_frontend_tokens, cfg.n_heads, cfg.head_dim)
    return {"self": {k: v.expand((G, n_self) + tuple(v.shape)).contiguous()
                     for k, v in kv.items()},
            "cross_k": torch.zeros(xkv, dtype=dtype, device=device),
            "cross_v": torch.zeros(xkv, dtype=dtype, device=device)}


def prefill(params, tokens, vision, cfg, width, *, mesh=None):
    """tokens ``[B, S]``, vision ``[B, n_img, d]`` -> (last-token logits
    ``[B, V]``, cache of self width ``width``)."""
    tfm.check_family(cfg)
    with on_mesh(mesh):
        return _prefill(params, tokens, vision, cfg, width)


def _prefill(params, tokens, vision, cfg, width):
    h = _embed(params, tokens, cfg)
    n_self = cfg.cross_attn_every - 1
    selfs_c, xk, xv = [], [], []
    for g in range(_n_groups(cfg)):
        selfs = tfm._layer(params["self_blocks"], g)
        caches = []
        for i in range(n_self):
            h, c = tfm.block_prefill(tfm._layer(selfs, i), cfg, h, width)
            caches.append(c)
        cross = tfm._layer(params["cross_blocks"], g)
        kv = attn.cross_kv(cross["xattn"], cfg, vision)
        h = cross_block_fwd(cross, cfg, h, kv)
        selfs_c.append(tfm._stack(caches))
        xk.append(kv["k"])
        xv.append(kv["v"])
    hf = norm_fwd(params["final_norm"], h, cfg.norm)
    logits = unembed_fwd(params["embed"], hf[:, -1:], cfg.tie_embeddings,
                         cfg.vocab)
    return logits[:, 0], {"self": tfm._stack(selfs_c),
                          "cross_k": torch.stack(xk),
                          "cross_v": torch.stack(xv)}


def decode_step(params, token, cache, pos, cfg, window=0, *, mesh=None):
    """token ``[B, 1]``; ``pos`` a 0-d int tensor on the parameters' device
    (an int is moved there) -> (logits ``[B, V]``, cache), each self
    layer's slot written in place; the cross layers attend with the flash
    kernel at Sq = 1 over the cached cross K/V."""
    tfm.check_family(cfg)
    with on_mesh(mesh):
        return _decode_step(params, token, cache, pos, cfg, window)


def _decode_step(params, token, cache, pos, cfg, window):
    h = _embed(params, token, cfg)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=h.device)
    n_self = cfg.cross_attn_every - 1
    for g in range(_n_groups(cfg)):
        selfs = tfm._layer(params["self_blocks"], g)
        self_c = tfm._layer(cache["self"], g)
        for i in range(n_self):
            h, _ = tfm.block_decode(tfm._layer(selfs, i), cfg, h,
                                    tfm._layer(self_c, i), pos,
                                    window=window)
        cross = tfm._layer(params["cross_blocks"], g)
        hn = norm_fwd(cross["norm1"], h, cfg.norm)
        q = attn.cross_q(cross["xattn"], cfg, hn)
        h = h + _gate(cross["gate_attn"], h) * attn.cross_attend(
            cross["xattn"], q, cache["cross_k"][g], cache["cross_v"][g])
        hn = norm_fwd(cross["norm2"], h, cfg.norm)
        h = h + _gate(cross["gate_mlp"], h) * mlp_fwd(cross["mlp"], hn,
                                                      cfg.act)
    hf = norm_fwd(params["final_norm"], h, cfg.norm)
    logits = unembed_fwd(params["embed"], hf, cfg.tie_embeddings, cfg.vocab)
    return logits[:, 0], cache
