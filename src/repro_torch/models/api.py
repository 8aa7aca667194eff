"""Unified model API, dense family.

Counterpart of ``repro/models/api.py:93-106``: ``build(cfg)`` returns a
``Model`` bundle of functions,

  init(rng, device="cuda") -> params    (nested dict, reference layout)
  loss(params, batch) -> scalar         (what FedZO queries)
  loss_batched(params, batch) -> [M]    (``loss`` per client of a cohort:
                                         leaves and batch with a leading
                                         ``[M]`` client axis)

``loss`` carries ``loss_batched`` as its attribute ``batched``, so the flat
FedZO round (``core/fedzo.batched_loss``) runs the cohort through it.

LM batches are ``{"tokens": [B, S], "labels": [B, S]}`` integer tensors on
the parameters' device. ``prefill`` and ``decode`` raise until serving is
ported; families other than dense raise at ``build``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    loss_batched: Callable
    prefill: Callable
    decode: Callable


def _not_ported(what):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{what} is not ported")
    return fn


def build(cfg: ModelConfig) -> Model:
    transformer.check_dense(cfg)

    def loss(p, b):
        return transformer.loss_fn(p, b, cfg)

    def loss_batched(p, b):
        return transformer.loss_fn_batched(p, b, cfg)

    loss.batched = loss_batched
    return Model(
        cfg=cfg,
        init=lambda rng, device="cuda": transformer.init_params(
            rng, cfg, device=resolve_device(device)),
        loss=loss,
        loss_batched=loss_batched,
        prefill=_not_ported("prefill"),
        decode=_not_ported("decode"),
    )
