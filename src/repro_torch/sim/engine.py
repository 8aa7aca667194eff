"""Multi-round federation engine: every registered strategy on the
pytree, flat and wide routes.

Counterpart of ``repro/sim/engine.py:84-180, 297-477, 836-881``. The
reference runs a whole experiment as one compiled ``lax.scan``; here a
Python loop runs the rounds eagerly on the device and keeps the same key
chain, metrics and evaluation schedule:

    key, k_part, k_batch, k_zo, k_chan = split(key, 5)      # per round

``k_part`` draws the M-of-N participants, ``k_batch`` their minibatches,
``k_zo`` the M per-client ZO keys (``split(k_zo, M)`` inside the
strategy), ``k_chan`` the channel realization. The chain starts at
``key(cfg.seed)``, so a run is reproducible from its config and draws the
reference's clients, rows and directions. The algorithm comes from the
strategy registry (``core/strategy.py``: ``strategy=`` a name or an
``AlgoStrategy``, the deprecated ``algo=`` string, else ``cfg.strategy``);
the stateful strategies' carry (``zstate``) rides along with the params,
momentum and key. ``eval_fn`` runs on the round's new parameters after
every round t with ``t % eval_every == 0``. Faults and the wireless
channel model (the reference's 6- and 7-way key splits) are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import aircomp, fedzo
from repro_torch.core import strategy as strategy_mod
from repro_torch.obs.ledger import CommsLedger
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


def make_round_step(loss_fn, cfg: FedZOConfig, *, algo: Optional[str] = None,
                    strategy=None, round_fn=None) -> Callable:
    """One communication round of the resolved strategy:
    ``step((params, momentum, key, zstate), store) -> ((params',
    momentum', key', zstate'), metrics)``. ``round_fn`` replaces
    ``fedzo.round_simulated`` (only for strategies without hooks)."""
    strat = strategy_mod.resolve(strategy, algo, cfg)
    strat.validate(cfg)
    if round_fn is not None and not strat.supports_round_fn:
        raise ValueError(
            f"strategy {strat.name!r} wraps the local phase with loss/state "
            f"hooks that a custom round_fn (the sharded round) cannot carry "
            f"— run it through the default fedzo round")
    if cfg.channel_model is not None:
        raise NotImplementedError("the wireless channel model is not ported")
    if strat.name != "fedavg":
        fedzo.check_route(cfg)

    def step(state, store: ClientStore):
        params, momentum, key, zstate = state
        key, k_part, k_batch, k_zo, k_chan = split_round_keys(key)
        idx = sample_participants(k_part, store.n_clients,
                                  cfg.n_participating)
        batches = sample_batches(store, idx, k_batch, cfg.local_iters,
                                 cfg.b1)
        wkw = ({"weights": aircomp.size_weights(store.sizes[idx])}
               if cfg.weight_by_size else {})
        params, metrics, momentum, zstate = strat.run_round(
            loss_fn, params, batches, k_zo, cfg, channel_rng=k_chan,
            momentum=momentum, zstate=zstate, idx=idx, round_fn=round_fn,
            **wkw)
        return (params, momentum, key, zstate), metrics

    return step


@dataclass
class ExperimentResult:
    """One engine run: final ``params`` (and ``momentum``), the carry
    ``key``, ``metrics`` (dict of ``[rounds]`` tensors, one entry per round)
    and ``evals`` (dict of ``[n_evals]`` tensors, one per round in
    ``eval_rounds``); ``strategy`` the algorithm's name and
    ``strategy_state`` its final carry (the stacked per-client controls or
    duals and the server's for scaffold and feddyn); ``ledger`` the run's
    ``obs.CommsLedger``."""
    params: Any
    momentum: Any
    key: Any
    metrics: dict
    evals: dict
    rounds: int
    eval_rounds: np.ndarray
    strategy: str = "fedzo"
    strategy_state: Any = None
    ledger: Any = None

    def history(self, *, start_round: int = 0) -> list:
        """Per-round history rows (see the module-level ``history``)."""
        return history(self, start_round=start_round)


def run_experiment(loss_fn, params, store: ClientStore, cfg: FedZOConfig,
                   rounds: int, *, algo: Optional[str] = None, strategy=None,
                   eval_fn=None, eval_every: int = 0, key=None,
                   momentum=None, zstate=None, round_fn=None
                   ) -> ExperimentResult:
    """Run ``rounds`` rounds of the resolved strategy (``strategy=`` a name
    or instance, the deprecated ``algo=``, else ``cfg.strategy``).
    ``eval_fn(params) -> dict of scalars`` runs after round t when ``t %
    eval_every == 0``. The stateful strategies' state starts from
    ``init_state`` unless ``zstate`` is given; passing a result's
    ``params``, ``key``, ``momentum`` and ``strategy_state`` back in
    continues the run."""
    strat = strategy_mod.resolve(strategy, algo, cfg)
    step = make_round_step(loss_fn, cfg, strategy=strat, round_fn=round_fn)
    if key is None:
        key = experiment_key(cfg)
    if momentum is None and strat.has_momentum(cfg):
        momentum = tree_zeros_like(params)
    if zstate is None:
        zstate = strat.init_state(params, cfg, store.n_clients)
    ledger = CommsLedger.from_run(cfg, params)
    do_eval = eval_fn is not None and eval_every > 0
    mets: dict = {}
    evs: dict = {}
    state = (params, momentum, key, zstate)
    for t in range(rounds):
        state, metrics = step(state, store)
        for k, v in metrics.items():
            mets.setdefault(k, []).append(torch.as_tensor(v).to(
                torch.float32))
        if do_eval and t % eval_every == 0:
            for k, v in eval_fn(state[0]).items():
                evs.setdefault(k, []).append(v.to(torch.float32))
    params, momentum, key, zstate = state
    return ExperimentResult(
        params=params, momentum=momentum, key=key,
        metrics={k: torch.stack(v) for k, v in mets.items()},
        evals={k: torch.stack(v) for k, v in evs.items()}, rounds=rounds,
        eval_rounds=(np.arange(0, rounds, eval_every) if do_eval
                     else np.arange(0)),
        strategy=strat.name, strategy_state=zstate, ledger=ledger)


def history(result: ExperimentResult, *, start_round: int = 0) -> list:
    """``FedServer``-style per-round rows of an engine result: ``round``
    (offset by ``start_round``), the run's ``strategy`` name, the round's
    metrics and, on eval rounds, the evals, as Python floats; then the
    ledger's byte columns."""
    mets = {k: v.cpu().tolist() for k, v in result.metrics.items()}
    evals = {k: v.cpu().tolist() for k, v in result.evals.items()}
    ev_by_round = {int(t): {k: float(v[i]) for k, v in evals.items()}
                   for i, t in enumerate(result.eval_rounds)}
    out = []
    for t in range(result.rounds):
        row = {"round": start_round + t, "strategy": result.strategy}
        row.update({k: float(v[t]) for k, v in mets.items()})
        row.update(ev_by_round.get(t, {}))
        out.append(row)
    if result.ledger is not None:
        result.ledger.annotate(out)
    return out
