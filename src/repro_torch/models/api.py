"""Unified model API: the dense, moe, ssm and hybrid families.

Counterpart of ``repro/models/api.py:25-125``: ``build(cfg)`` returns a
``Model`` bundle of functions,

  init(rng, device="cuda") -> params    (nested dict, reference layout)
  loss(params, batch, n_groups=1) -> scalar (what FedZO queries; [G] group
                                         means with n_groups > 1)
  loss_batched(params, batch) -> [M]    (``loss`` per client of a cohort:
                                         leaves and batch with a leading
                                         ``[M]`` client axis; dense and
                                         moe families, ssm and hybrid
                                         raise)
  prefill(params, batch, width) -> (logits [B, V], cache)
  decode(params, batch, cache, pos, window=0) -> (logits [B, V], cache)
  init_cache(batch_size, width, device="cuda") -> zeroed cache
  batch_shapes(shape_cfg) -> {name: (shape, dtype)}

``loss`` carries ``loss_batched`` as its attribute ``batched``, so the flat
FedZO round (``core/fedzo.batched_loss``) runs the cohort through it.

LM batches are ``{"tokens": [B, S], "labels": [B, S]}`` integer tensors on
the parameters' device; a decode batch's ``tokens`` is ``[B, 1]`` and
``pos`` a 0-d int tensor (the decode cache is written in place,
``models/transformer.py``). ``make_batch`` draws a batch bitwise the
reference's. The moe family (``qwen3-moe-30b-a3b``, ``deepseek-v3-671b``
with MLA and MTP), the ssm family (``rwkv6-7b``) and the hybrid family
(``hymba-1.5b``) build through the same ``transformer`` functions. The moe
family's cohort loss routes each client's tokens with its own router, so
flat and wide rounds run on it; the ssm and hybrid families' cohort loss
is not ported, so ``loss_batched`` (and with it ``fedzo.batched_loss``)
raises ``NotImplementedError`` for them before any forward runs, while
their ``loss``, prefill, decode and train step run. The encdec and vlm
families raise at ``build``, and with them their prefill and decode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.utils import prng


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
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


def build(cfg: ModelConfig) -> Model:
    transformer.check_family(cfg)

    def loss(p, b, n_groups=1):
        return transformer.loss_fn(p, b, cfg, n_groups)

    def loss_batched(p, b):
        return transformer.loss_fn_batched(p, b, cfg)

    loss.batched = loss_batched
    return Model(
        cfg=cfg,
        init=lambda rng, device="cuda": transformer.init_params(
            rng, cfg, device=resolve_device(device)),
        loss=loss,
        loss_batched=loss_batched,
        prefill=lambda p, b, width: transformer.prefill(
            p, b["tokens"], cfg, width),
        decode=lambda p, b, cache, pos, window=0: transformer.decode_step(
            p, b["tokens"], cache, pos, cfg, window),
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
