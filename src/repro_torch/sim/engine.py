"""Multi-round federation engine (fedzo strategy, pytree and flat routes).

Counterpart of ``repro/sim/engine.py:84-180, 297-477``. The reference runs
a whole experiment as one compiled ``lax.scan``; here a Python loop runs the
rounds eagerly on the device and keeps the same key chain, metrics and
evaluation schedule:

    key, k_part, k_batch, k_zo, k_chan = split(key, 5)      # per round

``k_part`` draws the M-of-N participants, ``k_batch`` their minibatches,
``k_zo`` the M per-client ZO keys (``split(k_zo, M)``, as the fedzo
strategy does), ``k_chan`` the channel realization. The chain starts at
``key(cfg.seed)``, so a run is reproducible from its config and draws the
reference's clients, rows and directions. ``eval_fn`` runs on the round's
new parameters after every round t with ``t % eval_every == 0``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import aircomp, fedzo
from repro_torch.sim.store import (ClientStore, sample_batches,
                                   sample_participants)
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_zeros_like


def split_round_keys(key):
    """(next_carry_key, k_participation, k_batches, k_zo, k_channel)."""
    ks = prng.split(key, 5)
    return ks[0], ks[1], ks[2], ks[3], ks[4]


def experiment_key(cfg: FedZOConfig):
    """Round-0 carry key of an experiment (threefry only)."""
    if cfg.prng_impl != "threefry2x32":
        raise NotImplementedError(f"prng_impl={cfg.prng_impl!r} is not "
                                  f"ported; only threefry2x32")
    return prng.key(cfg.seed)


def has_momentum(cfg: FedZOConfig) -> bool:
    return cfg.server_momentum > 0


def make_round_step(loss_fn, cfg: FedZOConfig) -> Callable:
    """One communication round of the fedzo strategy:
    ``step(params, momentum, key, store) -> (params', momentum', key',
    metrics)``."""
    if cfg.strategy != "fedzo":
        raise NotImplementedError(f"strategy {cfg.strategy!r} is not ported")
    fedzo.check_route(cfg)

    def step(params, momentum, key, store: ClientStore):
        key, k_part, k_batch, k_zo, k_chan = split_round_keys(key)
        idx = sample_participants(k_part, store.n_clients,
                                  cfg.n_participating)
        batches = sample_batches(store, idx, k_batch, cfg.local_iters,
                                 cfg.b1)
        wkw = ({"weights": aircomp.size_weights(store.sizes[idx])}
               if cfg.weight_by_size else {})
        rngs = prng.split(k_zo, cfg.n_participating)
        if has_momentum(cfg):
            params, metrics, momentum = fedzo.round_simulated(
                loss_fn, params, batches, rngs, cfg, channel_rng=k_chan,
                momentum=momentum, **wkw)
        else:
            params, metrics = fedzo.round_simulated(
                loss_fn, params, batches, rngs, cfg, channel_rng=k_chan,
                **wkw)
        return params, momentum, key, metrics

    return step


@dataclass
class ExperimentResult:
    """One engine run: final ``params`` (and ``momentum``), the carry
    ``key``, ``metrics`` (dict of ``[rounds]`` tensors, one entry per round)
    and ``evals`` (dict of ``[n_evals]`` tensors, one per round in
    ``eval_rounds``)."""
    params: Any
    momentum: Any
    key: Any
    metrics: dict
    evals: dict
    rounds: int
    eval_rounds: np.ndarray


def run_experiment(loss_fn, params, store: ClientStore, cfg: FedZOConfig,
                   rounds: int, *, eval_fn=None, eval_every: int = 0,
                   key=None, momentum=None) -> ExperimentResult:
    """Run ``rounds`` FedZO rounds. ``eval_fn(params) -> dict of scalars``
    runs after round t when ``t % eval_every == 0``. Passing a result's
    ``params``, ``key`` and ``momentum`` back in continues the run."""
    step = make_round_step(loss_fn, cfg)
    if key is None:
        key = experiment_key(cfg)
    if momentum is None and has_momentum(cfg):
        momentum = tree_zeros_like(params)
    do_eval = eval_fn is not None and eval_every > 0
    mets: dict = {}
    evs: dict = {}
    for t in range(rounds):
        params, momentum, key, metrics = step(params, momentum, key, store)
        for k, v in metrics.items():
            mets.setdefault(k, []).append(v.to(torch.float32))
        if do_eval and t % eval_every == 0:
            for k, v in eval_fn(params).items():
                evs.setdefault(k, []).append(v.to(torch.float32))
    return ExperimentResult(
        params=params, momentum=momentum, key=key,
        metrics={k: torch.stack(v) for k, v in mets.items()},
        evals={k: torch.stack(v) for k, v in evs.items()}, rounds=rounds,
        eval_rounds=(np.arange(0, rounds, eval_every) if do_eval
                     else np.arange(0)))
