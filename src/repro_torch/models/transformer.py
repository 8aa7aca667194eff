"""Decoder-only transformer assembly: the dense, moe (MoE layers, MLA,
MTP), ssm (rwkv6) and hybrid (attention beside a Mamba branch) families.

Counterpart of ``repro/models/transformer.py:39-179, 229-388``. Layers are
stacked: one nested dict whose leaves carry a leading ``[L]`` axis, each
layer drawn from its own ``fold_in(rng, i)`` key, so the parameter tree,
its flat order and its init are the reference's. A moe config has two
stacked groups, ``dense_blocks`` (its ``n_dense_layers`` leading dense
layers; None when there are none, as in the reference's tree, and skipped
by every tree walk) and ``moe_blocks``; a dense config one, ``blocks``.
MTP adds ``mtp_block`` and ``mtp_norm``. The stacked leaves are allocated
once and filled layer by layer (``_stack_init``), and every normal draw is
chunked into its output (``prng.normal_into``), so an init holds the
weights once: qwen3-moe-30b-a3b's 56.89 GiB of bfloat16 fit one card. The
reference scans each stack with ``jax.lax.scan``; here ``_scan_blocks`` is
a Python loop over layer slices (views, no copies), because every layer
launches the RMSNorm and attention kernels through ctypes.

``block_fwd`` returns (h, aux): the MoE layer's load-balance loss, None
for a dense layer (the reference's zero). ``loss_fn`` adds the layers' aux
and, under MTP, 0.3 times the cross entropy of the MTP block on ``hf +
emb_next`` (the scaled embedding shifted by one token) against the labels
shifted by one.

An ssm layer (``family="ssm"``) is the rwkv6 time mix and channel mix
(``models/ssm.py``, layernorms, no attention and no kernel); a hybrid
layer runs the attention (under the config's sliding window) and a Mamba
branch on the same normed input and averages them, ``0.5·(o + o2)``.

``loss_fn_batched`` is ``loss_fn`` per client of a cohort, the reference's
loss under ``jax.vmap`` as the flat round maps it, for the dense, moe,
ssm and hybrid families: every leaf carries a leading ``[M]`` client axis (what
``unflatten`` of the ``[M, n_pad]`` buffer gives, views into it), the
batch leaves ``[M, B, S]``, and it returns ``[M]`` losses. A layer is the
slice ``leaf[:, i]`` (a view), the dense products are batched GEMMs, and
each RMSNorm and attention is one kernel launch over the whole cohort:
2L + 1 RMSNorms (4L + 1 under qk_norm or MLA) and L attentions per
forward, whatever M is. A MoE layer routes each client's tokens with its
own router (``moe.moe_fwd_batched``), MLA runs per client
(``attention.mla_fwd_batched``), and each row adds its own aux and MTP
term. An ssm layer runs the batched RWKV time and channel mix
(``ssm.rwkv_tmix_fwd_batched``, ``rwkv_cmix_fwd_batched``: batched GEMMs,
the WKV chunk loop once over the M·B rows; no kernel), a hybrid layer its
attention as one launch over the cohort beside the batched Mamba branch
(``ssm.mamba_fwd_batched``).

The classifier head (``init_classifier``, ``classifier_logits``,
``classifier_loss``, ``classifier_accuracy``) is the neural FedZO
workload's transformer track: images cut into patch tokens, the LM's
stacked blocks, mean-pooled into a linear head. Its client-batched form
(``classifier_logits_batched``, ``classifier_loss_batched``) takes leaves
``[M', ...]`` against a batch ``[M, ...]`` with M' = r·M (r = 1 on the flat
round, b2 on the wide route, whose r perturbed copies of a client share
its batch), and runs each RMSNorm and attention as one launch.

Serving (``init_cache``, ``prefill``, ``decode_step``) runs the same
per-layer loop over each group: prefill returns the last token's logits
``[B, V]`` and a cache stacked over each group's layers, ``{"blocks":
{"k", "v"}}`` (``[L, B, W, Hkv, D]``) for a dense config, ``{"dense": …,
"moe": …}`` for a moe one (None for an empty group; ``{"latent"}`` leaves
``[L, B, W, kv_lora + rope]`` under MLA; an ssm layer's WKV state and
token shifts, a hybrid layer's ring and SSM state, ``init_cache``); a
decode step takes one token per row and a 0-d position tensor, and writes
each layer's slot (and state) of that cache in place.

FedZO never calls a gradient: the forward is all the train step needs.
The encdec and vlm families are ``models/encdec.py`` and ``models/vlm.py``
(``check_decoder`` rejects them here; the vlm's self layers are this
module's ``init_block``, ``block_fwd``, ``block_prefill`` and
``block_decode``, its nested ``[G, n_self, ...]`` stack ``_stack_init`` of
``_stack_init``); their cohort losses are those modules' ``loss_fn_batched``
over this module's ``_layer_batched`` and ``block_fwd_batched``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (dense_init, embed_fwd,
                                       embed_fwd_batched, init_embed,
                                       init_mlp, init_norm,
                                       mlp_fwd, mlp_fwd_batched, norm_fwd,
                                       norm_fwd_batched, softmax_xent,
                                       softmax_xent_batched, unembed_fwd,
                                       unembed_fwd_batched)
from repro_torch.models.moe import init_moe, moe_fwd, moe_fwd_batched
from repro_torch.models.simple import mean_xent, mean_xent_batched
from repro_torch.utils import prng
from repro_torch.utils.shardutil import (constrain, constrain_batch, dp_axes,
                                         on_mesh)
from repro_torch.utils.tree import tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DECODER_FAMILIES = ("dense", "moe", "ssm", "hybrid")
FAMILIES = DECODER_FAMILIES + ("encdec", "vlm")


def _dtype(cfg):
    return _DTYPES[cfg.dtype]


def check_family(cfg):
    """Reject a family the port does not build: all ten reference
    architectures' families (dense, moe with MoE layers, MLA and MTP, ssm,
    hybrid, encdec, vlm) are ported."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family={cfg.family!r} not "
                                  f"ported; the port runs the {FAMILIES} "
                                  f"families")


def check_decoder(cfg):
    """This module's whole-model functions assemble the decoder-only
    families; encdec and vlm models are ``models/encdec.py`` and
    ``models/vlm.py`` (``models/api.build`` picks the module)."""
    check_family(cfg)
    if cfg.family not in DECODER_FAMILIES:
        raise ValueError(f"{cfg.name}: the {cfg.family} family is built by "
                         f"models/{cfg.family}.py (models/api.build), not "
                         f"by the decoder-only assembly")


def _groups(cfg):
    """(params key, cache key, moe_layer, depth) of each stacked group, in
    the order the forward runs them."""
    if cfg.n_experts:
        return (("dense_blocks", "dense", False, cfg.n_dense_layers),
                ("moe_blocks", "moe", True,
                 cfg.n_layers - cfg.n_dense_layers))
    return (("blocks", "blocks", False, cfg.n_layers),)


# ---------------------------------------------------------------------------
# per-layer init


def init_block(rng, cfg, dtype, *, moe_layer=False, device="cpu"):
    ks = prng.split(rng, 4)
    p = {"norm1": init_norm(cfg.d_model, cfg.norm, dtype, device=device),
         "norm2": init_norm(cfg.d_model, cfg.norm, dtype, device=device)}
    if cfg.family == "ssm":  # rwkv6: time mix and channel mix only
        p["tmix"] = ssm.init_rwkv_tmix(ks[0], cfg, dtype, device=device)
        p["cmix"] = ssm.init_rwkv_cmix(ks[1], cfg, dtype, device=device)
        return p
    if cfg.mla is not None:
        p["attn"] = attn.init_mla(ks[0], cfg, dtype, device=device)
    else:
        p["attn"] = attn.init_attention(ks[0], cfg, dtype, device=device)
    if cfg.family == "hybrid":
        p["mamba"] = ssm.init_mamba(ks[1], cfg, dtype, device=device)
    if moe_layer:
        p["moe"] = init_moe(ks[2], cfg, dtype, device=device)
    else:
        p["mlp"] = init_mlp(ks[2], cfg.d_model, cfg.d_ff, cfg.act, dtype,
                            device=device)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _fill(stacked, i, layer):
    """Copy ``layer``'s leaves into slice i of the stacked leaves."""
    for k, v in layer.items():
        if isinstance(v, dict):
            _fill(stacked[k], i, v)
        else:
            stacked[k][i].copy_(v)


def _stack_init(rng, n, init_fn):
    """``n`` layers on a leading axis, layer i from ``fold_in(rng, i)``:
    bitwise ``_stack`` of the layers, without holding them twice. Each
    stacked leaf is allocated once and layer i copied into its slice as
    soon as it is drawn, so one layer lives beside the stack; a stack of
    one is a view of its layer's leaves. None for n = 0 (an empty group)."""
    if n == 0:
        return None
    layer = init_fn(prng.fold_in(rng, 0))
    if n == 1:
        return tree_map(lambda x: x[None], layer)
    stacked = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), layer)
    for i in range(n):
        if i:
            layer = init_fn(prng.fold_in(rng, i))
        _fill(stacked, i, layer)
        layer = None
    return stacked


def init_params(rng, cfg, *, device="cpu"):
    check_decoder(cfg)
    dtype = _dtype(cfg)
    ks = prng.split(rng, 6)
    p = {"embed": init_embed(ks[0], cfg.vocab, cfg.d_model, dtype,
                             cfg.tie_embeddings, device=device),
         "final_norm": init_norm(cfg.d_model, cfg.norm, dtype,
                                 device=device)}
    for key, (name, _, moe_layer, n) in zip((ks[1], ks[2]), _groups(cfg)):
        p[name] = _stack_init(key, n, lambda k, moe_layer=moe_layer:
                              init_block(k, cfg, dtype, moe_layer=moe_layer,
                                         device=device))
    if cfg.mtp:
        p["mtp_block"] = init_block(ks[3], cfg, dtype, device=device)
        p["mtp_norm"] = init_norm(cfg.d_model, cfg.norm, dtype,
                                  device=device)
    return p


def param_specs(cfg):
    """The parameter tree on the ``meta`` device: the paths, shapes and
    dtypes of ``init_params`` with no allocation and no draw (the
    reference's ``jax.eval_shape`` of its init; the dry-run's input)."""
    return init_params(prng.key(0), cfg, device="meta")


# ---------------------------------------------------------------------------
# block forward (full sequence)


def _rwkv_block(p, cfg, h):
    """The rwkv6 block on h [B, S, d] -> (h, its decode cache): the time
    mix on the first norm, the channel mix on the second, each with its
    token shift from a zero row."""
    hn = norm_fwd(p["norm1"], h, cfg.norm)
    o, (s, last) = ssm.rwkv_tmix_fwd(p["tmix"], cfg, hn)
    h = h + o
    hn = norm_fwd(p["norm2"], h, cfg.norm)
    B, _, d = hn.shape
    prev = torch.cat([hn.new_zeros((B, 1, d)), hn[:, :-1]], dim=1)
    h = h + ssm.rwkv_cmix_fwd(p["cmix"], hn, prev)
    return h, {"s": s, "ts_att": last, "ts_ffn": hn[:, -1]}


def block_fwd(p, cfg, h, *, moe_layer=False, mesh=None):
    """Pre-norm block on h [B, S, d]. Returns (h, aux): the MoE layer's
    load-balance loss, None for any other layer."""
    h = constrain_batch(h, mesh)
    if cfg.family == "ssm":
        return _rwkv_block(p, cfg, h)[0], None
    hn = norm_fwd(p["norm1"], h, cfg.norm)
    if cfg.mla is not None:
        o, _ = attn.mla_fwd(p["attn"], cfg, hn)
    else:
        o = attn.attention_fwd(p["attn"], cfg, hn)
    if cfg.family == "hybrid":  # the parallel Mamba branch, averaged
        o = 0.5 * (o + ssm.mamba_fwd(p["mamba"], cfg, hn)[0])
    h = h + o
    hn = norm_fwd(p["norm2"], h, cfg.norm)
    if moe_layer:
        o, aux = moe_fwd(p["moe"], cfg, hn, mesh=mesh)
        return h + o, aux
    return h + mlp_fwd(p["mlp"], hn, cfg.act), None


def _layer(stacked, i):
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def _add_aux(total, a):
    return a if total is None else (total if a is None else total + a)


def _scan_blocks(stacked, cfg, h, n, *, moe_layer=False, mesh=None):
    """The ``n`` stacked layers in turn -> (h, the sum of their aux in
    layer order, or None)."""
    aux = None
    for i in range(n):
        h, a = block_fwd(_layer(stacked, i), cfg, h, moe_layer=moe_layer,
                         mesh=mesh)
        aux = _add_aux(aux, a)
    return h, aux


def backbone(params, cfg, h, *, mesh=None):
    """Embeddings already applied; h [B, S, d] -> (h_normed, aux)."""
    aux = None
    for name, _, moe_layer, n in _groups(cfg):
        h, a = _scan_blocks(params.get(name), cfg, h, n, moe_layer=moe_layer,
                            mesh=mesh)
        aux = _add_aux(aux, a)
    return norm_fwd(params["final_norm"], h, cfg.norm), aux


def _embed_scale(h, cfg):
    if cfg.d_model >= 1024:
        # gemma-style scale, rounded to h's dtype: a Python scalar holding
        # that value computes as a 0-d tensor would, with no host wait
        h = h * float(torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype))
    return h


def logits_constraint(logits, mesh):
    """The vocab-parallel logits: batch over the data axes, vocab over
    ``model``."""
    if mesh is None:
        return logits
    return constrain(logits, mesh, dp_axes(mesh),
                     *([None] * (logits.ndim - 2)), "model")


def loss_fn(params, batch, cfg, n_groups=1, *, mesh=None):
    """Mean next-token cross entropy (+ the MoE aux, + 0.3 x the MTP
    block's): FedZO's F(x, ξ). ``n_groups > 1`` returns the ``[G]``
    per-group means (the pod round's silos). With a ``mesh``, params and
    batch are DTensors on it (``launch/sharding.py``) and so is the loss."""
    with on_mesh(mesh):
        return _loss_fn(params, batch, cfg, n_groups, mesh)


def _loss_fn(params, batch, cfg, n_groups, mesh):
    tokens, labels = batch["tokens"], batch["labels"]
    h = embed_fwd(params["embed"], tokens)
    h = _embed_scale(constrain_batch(h, mesh), cfg)
    hf, aux = backbone(params, cfg, h, mesh=mesh)
    logits = unembed_fwd(params["embed"], hf, cfg.tie_embeddings, cfg.vocab)
    logits = logits_constraint(logits, mesh)
    loss = softmax_xent(logits, labels, n_groups)
    if cfg.mtp:
        # multi-token prediction: one extra block predicts token t+2 from
        # (h_t, embed(token_{t+1})), DeepSeek-V3 style, depth 1
        emb_next = torch.cat([h[:, 1:], h[:, -1:]], dim=1)
        h2 = norm_fwd(params["mtp_norm"], hf + emb_next, cfg.norm)
        h2, _ = block_fwd(params["mtp_block"], cfg, h2, mesh=mesh)
        # the block's partial sums reduced first: a partial input would
        # gather the vocab-parallel unembedding and give every rank the
        # whole vocab (GSPMD lays it out so by itself)
        h2 = constrain_batch(h2, mesh)
        logits2 = unembed_fwd(params["embed"], h2, cfg.tie_embeddings,
                              cfg.vocab)
        labels2 = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        loss = loss + 0.3 * softmax_xent(logits2, labels2, n_groups)
    return loss if aux is None else loss + aux


# ---------------------------------------------------------------------------
# prefill / decode with caches


def _layer_cache(cfg, batch, width, dtype, device):
    if cfg.family == "ssm":  # the WKV state and both token shifts
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        return {"s": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                                 device=device),
                "ts_att": torch.zeros((batch, d), dtype=dtype,
                                      device=device),
                "ts_ffn": torch.zeros((batch, d), dtype=dtype,
                                      device=device)}
    if cfg.mla is not None:
        c = attn.init_mla_cache(cfg, batch, width, dtype, device=device)
    else:
        c = attn.init_kv_cache(cfg, batch, width, dtype, device=device)
    if cfg.family == "hybrid":  # the ring KV cache and the SSM state
        c["s"] = torch.zeros((batch, cfg.d_model, cfg.ssm_state),
                             dtype=torch.float32, device=device)
    return c


def init_cache(cfg, batch, width, *, device="cpu"):
    """Zeroed decode cache stacked over each group's layers:
    ``{"blocks": {"k", "v"}}`` (``[L, B, W, Hkv, D]``, the model's dtype)
    for a dense config, ``{"dense": …, "moe": …}`` for a moe one (None for
    an empty group); ``{"latent"}`` leaves under MLA; a hybrid layer adds
    the float32 SSM state ``"s"`` ``[L, B, d, n]``; an ssm layer holds only
    ``"s"`` ``[L, B, H, hd, hd]`` (float32) and the token shifts
    ``"ts_att"``, ``"ts_ffn"`` ``[L, B, d]``, whatever the width."""
    check_decoder(cfg)
    c = _layer_cache(cfg, batch, width, _dtype(cfg), device)
    return {ckey: None if n == 0 else
            {k: v.expand((n,) + tuple(v.shape)).contiguous()
             for k, v in c.items()}
            for _, ckey, _, n in _groups(cfg)}


def block_prefill(p, cfg, h, width, *, moe_layer=False, mesh=None):
    """Full-sequence block forward that also returns its decode cache."""
    h = constrain_batch(h, mesh)
    if cfg.family == "ssm":
        return _rwkv_block(p, cfg, h)
    hn = norm_fwd(p["norm1"], h, cfg.norm)
    if cfg.mla is not None:
        o, cache = attn.mla_prefill(p["attn"], cfg, hn, width)
    else:
        o, cache = attn.attention_prefill(p["attn"], cfg, hn, width)
    if cfg.family == "hybrid":
        o2, cache["s"] = ssm.mamba_fwd(p["mamba"], cfg, hn)
        o = 0.5 * (o + o2)
    h = h + o
    hn = norm_fwd(p["norm2"], h, cfg.norm)
    if moe_layer:
        o, _ = moe_fwd(p["moe"], cfg, hn, mesh=mesh)
    else:
        o = mlp_fwd(p["mlp"], hn, cfg.act)
    return h + o, cache


def block_decode(p, cfg, h, cache, pos, *, moe_layer=False, window=0,
                 mesh=None):
    """One-token block forward; writes ``cache``'s slot (and an ssm or
    hybrid layer's state and token shifts) in place."""
    h = constrain_batch(h, mesh)
    if cfg.family == "ssm":
        hn = norm_fwd(p["norm1"], h, cfg.norm)
        o, (s, last) = ssm.rwkv_tmix_step(p["tmix"], cfg, hn, cache["s"],
                                          cache["ts_att"])
        h = h + o
        hn = norm_fwd(p["norm2"], h, cfg.norm)
        h = h + ssm.rwkv_cmix_fwd(p["cmix"], hn, cache["ts_ffn"][:, None])
        cache["s"].copy_(s)
        cache["ts_att"].copy_(last)
        cache["ts_ffn"].copy_(hn[:, 0])
        return h, cache
    hn = norm_fwd(p["norm1"], h, cfg.norm)
    if cfg.mla is not None:
        o, cache = attn.mla_decode(p["attn"], cfg, hn, cache, pos,
                                   window=window)
    else:
        o, cache = attn.attention_decode(p["attn"], cfg, hn, cache, pos,
                                         window=window or cfg.sliding_window)
    if cfg.family == "hybrid":
        o2, s = ssm.mamba_step(p["mamba"], cfg, hn, cache["s"])
        cache["s"].copy_(s)
        o = 0.5 * (o + o2)
    h = h + o
    hn = norm_fwd(p["norm2"], h, cfg.norm)
    if moe_layer:
        o, _ = moe_fwd(p["moe"], cfg, hn, mesh=mesh)
    else:
        o = mlp_fwd(p["mlp"], hn, cfg.act)
    return h + o, cache


def prefill(params, tokens, cfg, width, *, mesh=None):
    """tokens [B, S] -> (last-token logits [B, V], cache of width
    ``width``)."""
    check_decoder(cfg)
    with on_mesh(mesh):
        return _prefill(params, tokens, cfg, width, mesh)


def _as_cache_slice(c, ckey, n, mesh, cfg):
    """Layer cache ``c`` laid out as its slice of the stacked cache's
    ``launch/sharding.cache_shardings`` (each spec less its layer axis), as
    the reference's compiler lays a scan's output out by the step's output
    shardings: the layers' caches never stand whole beside their stack.
    ``c`` itself without a multi-axis mesh."""
    if mesh is None or getattr(mesh, "device_mesh", None) is None:
        return c
    from types import SimpleNamespace
    from repro_torch.launch.sharding import cache_shardings
    csh = cache_shardings({ckey: {k: SimpleNamespace(shape=(n,) + tuple(
        v.shape)) for k, v in c.items()}}, mesh, cfg)[ckey]
    return {k: constrain(v, mesh, *csh[k].spec[1:]) for k, v in c.items()}


def _prefill(params, tokens, cfg, width, mesh):
    h = embed_fwd(params["embed"], tokens)
    h = _embed_scale(constrain_batch(h, mesh), cfg)
    cache = {}
    for name, ckey, moe_layer, n in _groups(cfg):
        caches = []
        for i in range(n):
            h, c = block_prefill(_layer(params[name], i), cfg, h, width,
                                 moe_layer=moe_layer, mesh=mesh)
            caches.append(_as_cache_slice(c, ckey, n, mesh, cfg))
        cache[ckey] = _stack(caches) if caches else None
    hf = norm_fwd(params["final_norm"], h, cfg.norm)
    logits = unembed_fwd(params["embed"], hf[:, -1:], cfg.tie_embeddings,
                         cfg.vocab)
    return logits[:, 0], cache


def decode_step(params, token, cache, pos, cfg, window=0, *, mesh=None):
    """token [B, 1] int; ``pos`` the absolute position (a 0-d int tensor on
    the parameters' device; an int is moved there) -> (logits [B, V],
    cache), the cache updated in place."""
    check_decoder(cfg)
    with on_mesh(mesh):
        return _decode_step(params, token, cache, pos, cfg, window, mesh)


def _decode_step(params, token, cache, pos, cfg, window, mesh):
    h = embed_fwd(params["embed"], token)
    h = _embed_scale(constrain_batch(h, mesh), cfg)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=h.device)
    for name, ckey, moe_layer, n in _groups(cfg):
        for i in range(n):
            h, _ = block_decode(_layer(params[name], i), cfg, h,
                                _layer(cache[ckey], i), pos,
                                moe_layer=moe_layer, window=window,
                                mesh=mesh)
    hf = norm_fwd(params["final_norm"], h, cfg.norm)
    logits = unembed_fwd(params["embed"], hf, cfg.tie_embeddings, cfg.vocab)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# client-batched forward (the flat round's cohort)


def _rwkv_block_batched(p, cfg, h):
    """``_rwkv_block`` per client (the train forward): each client row's
    token shifts start from a zero row."""
    hn = norm_fwd_batched(p["norm1"], h, cfg.norm)
    h = h + ssm.rwkv_tmix_fwd_batched(p["tmix"], cfg, hn)
    hn = norm_fwd_batched(p["norm2"], h, cfg.norm)
    M, B, _, d = hn.shape
    prev = torch.cat([hn.new_zeros((M, B, 1, d)), hn[:, :, :-1]], dim=2)
    return h + ssm.rwkv_cmix_fwd_batched(p["cmix"], hn, prev)


def block_fwd_batched(p, cfg, h, *, moe_layer=False):
    """``block_fwd`` per client: h ``[M, B, S, d]``, leaves ``[M, ...]`` ->
    (h, aux ``[M]`` of a MoE layer, else None). A hybrid layer's attention
    is one launch over the ``[M·B]`` rows (under the sliding window)
    beside the batched Mamba branch."""
    if cfg.family == "ssm":
        return _rwkv_block_batched(p, cfg, h), None
    hn = norm_fwd_batched(p["norm1"], h, cfg.norm)
    if cfg.mla is not None:
        o = attn.mla_fwd_batched(p["attn"], cfg, hn)
    else:
        o = attn.attention_fwd_batched(p["attn"], cfg, hn)
    if cfg.family == "hybrid":
        o = 0.5 * (o + ssm.mamba_fwd_batched(p["mamba"], cfg, hn))
    h = h + o
    hn = norm_fwd_batched(p["norm2"], h, cfg.norm)
    if moe_layer:
        o, aux = moe_fwd_batched(p["moe"], cfg, hn)
        return h + o, aux
    return h + mlp_fwd_batched(p["mlp"], hn, cfg.act), None


def _layer_batched(stacked, i):
    if isinstance(stacked, dict):
        return {k: _layer_batched(v, i) for k, v in stacked.items()}
    return stacked[:, i]


def backbone_batched(params, cfg, h):
    """``backbone`` per client -> (h_normed ``[M, B, S, d]``, aux ``[M]``
    or None), each stacked group's layers in turn."""
    aux = None
    for name, _, moe_layer, n in _groups(cfg):
        for i in range(n):
            h, a = block_fwd_batched(_layer_batched(params[name], i), cfg,
                                     h, moe_layer=moe_layer)
            aux = _add_aux(aux, a)
    return norm_fwd_batched(params["final_norm"], h, cfg.norm), aux


def repeat_rows(x, r):
    """A batch leaf ``[M, ...]`` for ``[r·M]`` parameter rows (the wide
    route's r perturbed copies of each client): row m·r + j is client m's."""
    return x.repeat_interleave(r, 0) if r > 1 else x


def loss_fn_batched(params, batch, cfg):
    """``loss_fn`` per client: ``[M, ...]`` leaves and batch leaves ``[M,
    B, S]`` -> ``[M]`` losses, each row's MoE aux and MTP term its own.
    Leaves ``[r·M, ...]`` (the wide route's r perturbed copies of each
    client) take client m's tokens for rows m·r … m·r + r − 1 (the token
    ids are repeated, the weights read in place). The decoder-only
    families; the encdec and vlm families' are ``encdec.loss_fn_batched``
    and ``vlm.loss_fn_batched``."""
    check_decoder(cfg)
    r = params["final_norm"]["scale"].shape[0] // batch["tokens"].shape[0]
    tokens, labels = (repeat_rows(batch[k], r) for k in ("tokens", "labels"))
    h = _embed_scale(embed_fwd_batched(params["embed"], tokens), cfg)
    hf, aux = backbone_batched(params, cfg, h)
    logits = unembed_fwd_batched(params["embed"], hf, cfg.tie_embeddings,
                                 cfg.vocab)
    loss = softmax_xent_batched(logits, labels)
    if cfg.mtp:
        emb_next = torch.cat([h[:, :, 1:], h[:, :, -1:]], dim=2)
        h2 = norm_fwd_batched(params["mtp_norm"], hf + emb_next, cfg.norm)
        h2, _ = block_fwd_batched(params["mtp_block"], cfg, h2)
        logits2 = unembed_fwd_batched(params["embed"], h2,
                                      cfg.tie_embeddings, cfg.vocab)
        labels2 = torch.cat([labels[:, :, 1:], labels[:, :, -1:]], dim=2)
        loss = loss + 0.3 * softmax_xent_batched(logits2, labels2)
    return loss if aux is None else loss + aux


# ---------------------------------------------------------------------------
# tiny classifier head (the neural workload's transformer track)


def init_classifier(rng, cfg, *, n_patches, patch_dim, n_classes,
                    device="cpu"):
    """Patch embedding, a zero positional table, cfg.n_layers stacked
    blocks, the final norm and the head, from ``split(rng, 3)`` as the
    reference draws them."""
    check_decoder(cfg)
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
    h, _ = _scan_blocks(params["blocks"], cfg, h, cfg.n_layers)
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
        h, _ = block_fwd_batched(_layer_batched(params["blocks"], i), cfg, h)
    h = norm_fwd_batched(params["final_norm"], h, cfg.norm)
    return torch.mean(h, dim=2) @ params["head"]


def classifier_loss_batched(params, batch, cfg):
    """``classifier_loss`` per parameter row -> ``[M']`` losses (batch
    leaves ``[M, B, ...]``, M' = r·M as in ``classifier_logits_batched``)."""
    return mean_xent_batched(
        classifier_logits_batched(params, cfg, batch["x"]), batch["y"])
