"""Optimizers of the first-order baselines: SGD with momentum, Adam, and a
cosine learning-rate schedule.

Counterpart of ``repro/optim/sgd.py``: tree ops on dicts of tensors, in the
reference's arithmetic order. FedZO itself is optimizer-free; FedAvg's
local steps and the training CLI's ``--algo fedavg --opt sgd|adam`` use
these. The updates are plain torch ops (no kernel).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.utils.tree import tree_axpy_plain, tree_map, tree_zeros_like


class SGDState(NamedTuple):
    momentum: object


def sgd_init(params, momentum=0.0):
    return SGDState(tree_zeros_like(params) if momentum else None)


def sgd_apply(params, grads, state: SGDState, *, lr, momentum=0.0):
    if momentum and state.momentum is not None:
        m = tree_map(lambda mo, g: momentum * mo + g, state.momentum, grads)
        return tree_axpy_plain(-lr, m, params), SGDState(m)
    return tree_axpy_plain(-lr, grads, params), state


class AdamState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor     # int32 step count (CPU)


def adam_init(params):
    return AdamState(tree_zeros_like(params), tree_zeros_like(params),
                     torch.zeros((), dtype=torch.int32))


def adam_apply(params, grads, state: AdamState, *, lr, b1=0.9, b2=0.999,
               eps=1e-8):
    """One Adam step with bias correction from the float32 step count."""
    c = state.count + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g * g, state.nu, grads)
    cf = c.to(torch.float32)
    s1, s2 = 1 - b1 ** cf, 1 - b2 ** cf
    upd = tree_map(lambda m, n: (m / s1) / (torch.sqrt(n / s2) + eps), mu, nu)
    return tree_axpy_plain(-lr, upd, params), AdamState(mu, nu, c)


def cosine_lr(step, *, base_lr, total_steps, warmup=0):
    """float32 cosine decay from ``base_lr`` to 0 over ``total_steps``,
    after a linear warm-up of ``warmup`` steps."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = (torch.clamp(step / max(warmup, 1), max=1.0) if warmup else 1.0)
    t = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0, 1)
    return base_lr * warm * 0.5 * (1 + torch.cos(math.pi * t))
