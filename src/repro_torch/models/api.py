"""Unified model API over all ten reference architectures' families.

Counterpart of ``repro/models/api.py:25-125``: ``build(cfg)`` returns a
``Model`` bundle of functions,

  init(rng, device="cuda") -> params    (nested dict, reference layout)
  param_specs() -> params on ``meta``   (paths, shapes, dtypes; no memory)
  loss(params, batch, n_groups=1, mesh=None) -> scalar (what FedZO
                                         queries; [G] group means with
                                         n_groups > 1)
  loss_batched(params, batch) -> [M]    (``loss`` per client of a cohort:
                                         leaves and batch with a leading
                                         ``[M]`` client axis; every
                                         family)
  prefill(params, batch, width, mesh=None) -> (logits [B, V], cache)
  decode(params, batch, cache, pos, window=0, mesh=None) -> (logits, cache)

With a ``mesh`` (``launch/mesh.py``) the params, batch and cache are
DTensors on it, laid out by ``launch/sharding.py``, and so are the
results: the reference's sharded forwards (``mesh=`` in
``repro/models/api.py``).
  init_cache(batch_size, width, device="cuda") -> zeroed cache
  batch_shapes(shape_cfg) -> {name: (shape, dtype)}

``loss`` carries ``loss_batched`` as its attribute ``batched``, so the flat,
AirComp and wide FedZO rounds (``core/fedzo.batched_loss``) run the cohort
through it, every RMSNorm and attention one launch over the cohort, and
never reach ``torch.func.vmap``.

LM batches are ``{"tokens": [B, S], "labels": [B, S]}`` integer tensors on
the parameters' device; a decode batch's ``tokens`` is ``[B, 1]`` and
``pos`` a 0-d int tensor (the decode cache is written in place). The
dense, moe (``qwen3-moe-30b-a3b``, ``deepseek-v3-671b`` with MLA and MTP),
ssm (``rwkv6-7b``) and hybrid (``hymba-1.5b``) families build through the
decoder-only ``transformer`` functions. The encdec family
(``seamless-m4t-large-v2``, ``models/encdec.py``) adds ``src_embeds``
``[B, n_frontend_tokens, d_model]`` to a train or prefill batch, the vlm
family (``llama-3.2-vision-90b``, ``models/vlm.py``) ``vision_embeds``
to every batch shape, as the reference's: the stubbed modality frontends,
in the model's dtype; their cohort loss is ``encdec.loss_fn_batched`` and
``vlm.loss_fn_batched``. Decode reads only the tokens (the cross K/V is
cached). ``make_batch`` draws a batch bitwise the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, transformer, vlm
from repro_torch.utils import prng


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    param_specs: Callable
    loss: Callable
    loss_batched: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    batch_shapes: Callable


def _lm_batch_shapes(cfg, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": ((B, S), torch.int32),
                "labels": ((B, S), torch.int32)}
    if shape.kind == "prefill":
        return {"tokens": ((B, S), torch.int32)}
    return {"tokens": ((B, 1), torch.int32)}  # decode


# the modality frontend stub of each family with one: its batch key
_FRONTEND = {"encdec": "src_embeds", "vlm": "vision_embeds"}


def build(cfg: ModelConfig) -> Model:
    transformer.check_family(cfg)
    frontend = _FRONTEND.get(cfg.family)
    if frontend is None:
        return _decoder_model(cfg)
    mod = {"encdec": encdec, "vlm": vlm}[cfg.family]
    dtype = transformer._dtype(cfg)

    def loss(p, b, n_groups=1, mesh=None):
        return mod.loss_fn(p, b, cfg, n_groups, mesh=mesh)

    def loss_batched(p, b):
        return mod.loss_fn_batched(p, b, cfg)

    def batch_shapes(shape):
        d = _lm_batch_shapes(cfg, shape)
        # an encdec decode runs off the cached cross K/V alone; the vlm
        # keeps its patches in every shape, as the reference's
        if shape.kind != "decode" or cfg.family == "vlm":
            d[frontend] = ((shape.global_batch, cfg.n_frontend_tokens,
                            cfg.d_model), dtype)
        return d

    loss.batched = loss_batched
    return Model(
        cfg=cfg,
        init=lambda rng, device="cuda": mod.init_params(
            rng, cfg, device=resolve_device(device)),
        param_specs=lambda: mod.param_specs(cfg),
        loss=loss,
        loss_batched=loss_batched,
        prefill=lambda p, b, width, mesh=None: mod.prefill(
            p, b["tokens"], b[frontend], cfg, width, mesh=mesh),
        decode=lambda p, b, cache, pos, window=0, mesh=None: mod.decode_step(
            p, b["tokens"], cache, pos, cfg, window, mesh=mesh),
        init_cache=lambda batch, width, device="cuda": mod.init_cache(
            cfg, batch, width, device=resolve_device(device)),
        batch_shapes=batch_shapes,
    )


def _decoder_model(cfg: ModelConfig) -> Model:
    def loss(p, b, n_groups=1, mesh=None):
        return transformer.loss_fn(p, b, cfg, n_groups, mesh=mesh)

    def loss_batched(p, b):
        return transformer.loss_fn_batched(p, b, cfg)

    loss.batched = loss_batched
    return Model(
        cfg=cfg,
        init=lambda rng, device="cuda": transformer.init_params(
            rng, cfg, device=resolve_device(device)),
        param_specs=lambda: transformer.param_specs(cfg),
        loss=loss,
        loss_batched=loss_batched,
        prefill=lambda p, b, width, mesh=None: transformer.prefill(
            p, b["tokens"], cfg, width, mesh=mesh),
        decode=lambda p, b, cache, pos, window=0, mesh=None:
            transformer.decode_step(p, b["tokens"], cache, pos, cfg, window,
                                    mesh=mesh),
        init_cache=lambda batch, width, device="cuda": transformer.init_cache(
            cfg, batch, width, device=resolve_device(device)),
        batch_shapes=lambda shape: _lm_batch_shapes(cfg, shape),
    )


def make_batch(model: Model, shape: ShapeConfig, rng, *, device="cuda"):
    """A random batch matching ``batch_shapes``, bitwise the reference's
    ``make_batch``: input i of the sorted names from ``fold_in(rng, i)``,
    integers by ``randint(0, vocab)``, floats by ``normal``."""
    dev = resolve_device(device)
    out = {}
    for i, (name, (shp, dt)) in enumerate(
            sorted(model.batch_shapes(shape).items())):
        k = prng.fold_in(rng, i)
        if dt.is_floating_point:
            out[name] = prng.normal(k, shp, dtype=dt, device=dev)
        else:
            out[name] = prng.randint(k, shp, 0, model.cfg.vocab).to(
                device=dev, dtype=dt)
    return out


def decode_width(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """KV-cache width of a decode shape: the full length up to 64K, the
    sliding window beyond (``long_500k``)."""
    if shape.seq_len > 65_536:
        return min(cfg.long_context_window, shape.seq_len)
    return shape.seq_len
