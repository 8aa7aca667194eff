"""Federated orchestration: the server loop driving Algorithm 1 end to end.

Counterpart of ``repro/fed/server.py:39-372``. ``FedServer`` owns the
global model, samples M of N clients per round (uniform, per the paper)
and runs the round of its strategy. Two drivers share the class:

- **Host loop**: numpy client sampling and minibatch draws
  (``data/synthetic.sample_local_batches``), a 3-way key split per round,
  and the fedzo or fedavg round on the batches moved to the parameters'
  device.
- **Store path** (``store=ClientStore``): every round is the engine's round
  step (``sim/engine.make_round_step``), so ``run_round`` and ``run`` walk
  the engine's key chain and trajectory; all five strategies run there.
  ``run(driver="scan")`` maps to the engine's round loop
  (``sim.run_experiment``), the counterpart of the reference's one
  compiled scan.

On the store path the server also carries the engine's fault chain
(``faults=FaultModel``) and wireless chain (``cfg.channel_model``), as the
reference does; both need a store (the reference's ValueErrors otherwise).
``run_round`` can guard against divergence (non-finite metrics, evals or
parameters): the round is rolled back, the lr backed off, a ``rollback``
event row recorded, and after ``max_retries`` consecutive failures
``DivergenceError`` is raised. Every history row carries the comms
ledger's byte (and energy) columns (``obs/ledger.py``) and, on the
host-driven rounds, ``round_ms``. A ``tracer`` (``obs.Tracer``) records an
``eval`` span per host-driven eval and the engine's compile and execute
spans on ``run(driver="scan")``.

``run_seed_compressed_round`` is the digital uplink (``core/seedcomm.py``):
each client ships (key, coefficients), the server replays them.

A store that is not a ``ClientStore`` (the reference's tiered
``HostStore``) raises ``NotImplementedError``: the tiered store is not
ported.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import aircomp, estimator, fedavg, fedzo, seedcomm
from repro_torch.core import strategy as strategy_mod
from repro_torch.data.synthetic import sample_local_batches
from repro_torch.obs.ledger import CommsLedger
from repro_torch.sim import channel as channel_lib
from repro_torch.sim import engine as sim_engine
from repro_torch.sim.faults import DivergenceError, FaultModel
from repro_torch.sim.store import ClientStore
from repro_torch.utils import prng
from repro_torch.utils.tree import (tree_add, tree_bytes, tree_leaves,
                                    tree_stack, tree_zeros_like)


@dataclass
class FedServer:
    loss_fn: Callable            # loss(params, batch) -> scalar
    params: object               # global model x^t (dict on the run's device)
    clients: Optional[list]      # list of {"x": ..., "y": ...} numpy datasets
    cfg: FedZOConfig
    # algorithm: ``strategy`` (registry name or AlgoStrategy) wins, then the
    # legacy ``algo`` string, then cfg.strategy; after init ``self.algo``
    # holds the resolved name
    algo: Optional[str] = None
    strategy: Optional[object] = None
    eval_fn: Optional[Callable] = None   # host-side eval -> dict of floats
    history: list = field(default_factory=list)
    store: Optional[object] = None       # sim.ClientStore -> engine driver
    jit_eval: Optional[Callable] = None  # eval -> dict of tensors, per round
    eval_every: int = 1                  # engine eval cadence (rounds)
    faults: Optional[FaultModel] = None  # fault injection (store path)
    divergence_guard: bool = False       # roll back non-finite rounds
    max_retries: int = 3                 # lr-backoff retries before failing
    lr_backoff: float = 0.5              # lr multiplier per rollback
    tracer: Optional[object] = None      # obs.Tracer: eval/compile spans

    def __post_init__(self):
        if self.clients is None and self.store is None:
            raise ValueError("FedServer needs client datasets: pass "
                             "clients=[...] and/or store=ClientStore")
        if self.store is not None and not isinstance(self.store,
                                                     ClientStore):
            raise NotImplementedError(
                "store= takes a ClientStore; the tiered HostStore "
                "(sim/tiered.py) is not ported")
        if self.faults is not None and self.store is None:
            raise ValueError("fault injection runs inside the round step "
                             "— construct the FedServer with a "
                             "store=ClientStore")
        if self.cfg.channel_model is not None and self.store is None:
            raise ValueError("cfg.channel_model (the correlated wireless "
                             "scenario) advances inside the round step — "
                             "construct the FedServer with a "
                             "store=ClientStore")
        n = (len(self.clients) if self.clients is not None
             else self.store.n_clients)
        if n != self.cfg.n_devices:
            raise ValueError(
                f"cfg.n_devices={self.cfg.n_devices} but {n} client "
                f"datasets were provided — the federation size N must "
                f"match the config (did you partition with a different "
                f"n_clients?)")
        if self.cfg.n_participating > n:
            raise ValueError(
                f"cfg.n_participating={self.cfg.n_participating} exceeds "
                f"the federation size N={n}")
        sel = (self.strategy if self.strategy is not None
               else (self.algo or self.cfg.strategy))
        self._strategy = (strategy_mod.get(sel) if isinstance(sel, str)
                          else sel)
        self.algo = self._strategy.name
        self._strategy.validate(self.cfg)
        if self.store is None and self._strategy.name not in ("fedzo",
                                                              "fedavg"):
            raise ValueError(
                f"strategy {self._strategy.name!r} needs the engine round "
                f"step (its state/loss hooks live there) — construct the "
                f"FedServer with a store=ClientStore")
        self._device = estimator._device(self.params)
        self._np_rng = np.random.default_rng(self.cfg.seed)
        self._momentum = None
        self._retries = 0
        # successful-round counter: rollback rows land in the history too
        # and must not shift round numbers
        self._round_idx = 0
        if self._strategy.has_momentum(self.cfg):
            self._momentum = tree_zeros_like(self.params)
        self._fstate = (self.faults.init_state(n)
                        if self.faults is not None else None)
        self._zstate = self._strategy.init_state(self.params, self.cfg, n)
        # one byte model per server (the lr never enters it, so rollbacks
        # do not invalidate it)
        self._ledger = CommsLedger.from_run(self.cfg, self.params,
                                            channel=self.cfg.channel_model)
        self._key = (sim_engine.experiment_key(self.cfg)
                     if self.store is not None else prng.key(self.cfg.seed))
        # the wireless chain starts from the fold-in key, as run_experiment
        # does, so the host-driven and engine trajectories share it
        cm = self.cfg.channel_model
        self._cstate = (cm.init_state(n, channel_lib.init_key(self._key))
                        if cm is not None else None)
        self._build_round_fns()

    def _build_round_fns(self):
        """(Re)build the store path's round step for the current
        ``self.cfg``: at init and after a rollback bakes a backed-off lr
        into the config (the host loop reads ``self.cfg`` each round)."""
        if self.store is not None:
            self._sim_step = sim_engine.make_round_step(
                self.loss_fn, self.cfg, strategy=self._strategy,
                faults=self.faults)

    # -- client sampling (host loop) -----------------------------------------
    def sample_clients(self):
        n = len(self.clients)
        return self._np_rng.choice(n, size=min(self.cfg.n_participating, n),
                                   replace=False)

    def _stack_batches(self, chosen):
        per = [sample_local_batches(self.clients[i], self._np_rng,
                                    self.cfg.local_iters, self.cfg.b1)
               for i in chosen]
        return {k: torch.from_numpy(np.stack([p[k] for p in per])).to(
            self._device) for k in per[0]}

    # -- round ---------------------------------------------------------------
    def _step_once(self):
        """Advance one round (the engine's step on the store path, else the
        host loop) and return its metrics as Python floats."""
        if self.store is not None:
            state, metrics = self._sim_step(
                (self.params, self._momentum, self._key, self._fstate,
                 self._cstate, self._zstate), self.store)
            (self.params, self._momentum, self._key, self._fstate,
             self._cstate, self._zstate) = state
        else:
            chosen = self.sample_clients()
            batches = self._stack_batches(chosen)
            wkw = {}
            if self.cfg.weight_by_size:
                sizes = torch.tensor([len(next(iter(self.clients[i].values())))
                                      for i in chosen], dtype=torch.float32)
                wkw["weights"] = aircomp.size_weights(sizes)
            ks = prng.split(self._key, 3)
            self._key, kr, kc = ks[0], ks[1], ks[2]
            if self.algo == "fedzo":
                rngs = prng.split(kr, len(chosen))
                out = fedzo.round_simulated(
                    self.loss_fn, self.params, batches, rngs, self.cfg,
                    channel_rng=kc, momentum=self._momentum, **wkw)
                self.params, metrics = out[0], out[1]
                if self._momentum is not None:
                    self._momentum = out[2]
            else:
                self.params, metrics = fedavg.round_simulated(
                    self.loss_fn, self.params, batches, self.cfg,
                    channel_rng=kc, **wkw)
        return {k: float(v) for k, v in metrics.items()}

    def _diverged(self, metrics: dict) -> bool:
        if any(not math.isfinite(v) for v in metrics.values()
               if isinstance(v, float)):
            return True
        return not all(bool(torch.isfinite(leaf).all())
                       for leaf in tree_leaves(self.params))

    def _eval(self):
        if self.eval_fn is not None:
            return self.eval_fn
        if self.jit_eval is not None:
            return lambda p: {k: float(v)
                              for k, v in self.jit_eval(p).items()}
        return None

    def run_round(self, t: Optional[int] = None):
        """Run one round (numbered ``t``, default the successful-round
        counter). With ``divergence_guard`` a round whose metrics, eval or
        params come back non-finite is rolled back: the pre-round state is
        restored, the lr scaled by ``lr_backoff``, a ``{"round": t,
        "event": "rollback", ...}`` row recorded and the round retried, at
        most ``max_retries`` consecutive times, then ``DivergenceError``."""
        if t is None:
            t = self._round_idx
        ev = self._eval()
        while True:
            snap = (self.params, self._momentum, self._key, self._fstate,
                    self._cstate, self._zstate)
            t_start = time.perf_counter()
            metrics = self._step_once()
            metrics["round"] = t
            if ev:
                if self.tracer is not None:
                    with self.tracer.span("eval", round=t):
                        metrics.update(ev(self.params))
                else:
                    metrics.update(ev(self.params))
            if not self.divergence_guard or not self._diverged(metrics):
                # host wall-clock of the surviving attempt (the round, its
                # device sync and the eval)
                metrics["round_ms"] = (time.perf_counter() - t_start) * 1e3
                break
            (self.params, self._momentum, self._key, self._fstate,
             self._cstate, self._zstate) = snap
            self._retries += 1
            if self._retries > self.max_retries:
                raise DivergenceError(t, self.max_retries, self.cfg.lr)
            self.cfg = replace(self.cfg, lr=self.cfg.lr * self.lr_backoff)
            self._build_round_fns()
            self.history.append({"round": t, "event": "rollback",
                                 "retry": self._retries, "lr": self.cfg.lr})
        self._retries = 0
        self._round_idx = t + 1
        self._ledger.annotate([metrics])
        self.history.append(metrics)
        return metrics

    def run(self, rounds: int, log_every: int = 0, log_fn=print,
            driver: str = "auto"):
        """Run ``rounds`` rounds. ``driver``: "scan" runs the engine's round
        loop (``sim.run_experiment``; needs a store, and takes ``jit_eval``,
        not the host ``eval_fn``), "host" the per-round ``run_round``,
        "auto" the engine whenever it can."""
        use_engine = driver == "scan" or (
            driver == "auto" and self.store is not None
            and self.eval_fn is None)

        def log(i, m):
            if log_every and i % log_every == 0:
                log_fn({k: (round(v, 5) if isinstance(v, float) else v)
                        for k, v in m.items()})

        if use_engine:
            if self.store is None:
                raise ValueError("driver='scan' needs store=ClientStore")
            for i, m in enumerate(self._run_scanned(rounds)):
                log(i, m)
        else:
            for i in range(rounds):
                log(i, self.run_round())
        return self.history

    def _run_scanned(self, rounds: int):
        res = sim_engine.run_experiment(
            self.loss_fn, self.params, self.store, self.cfg, rounds,
            strategy=self._strategy, eval_fn=self.jit_eval,
            eval_every=self.eval_every if self.jit_eval is not None else 0,
            key=self._key, momentum=self._momentum, zstate=self._zstate,
            faults=self.faults, fault_state=self._fstate,
            channel_state=self._cstate, tracer=self.tracer)
        (self.params, self._momentum, self._key, self._fstate, self._cstate,
         self._zstate) = (res.params, res.momentum, res.key,
                          res.fault_state, res.channel_state,
                          res.strategy_state)
        if self.divergence_guard and self._diverged(
                {k: float(v[-1]) for k, v in res.metrics.items()}):
            raise DivergenceError(
                self._round_idx + rounds, 0, self.cfg.lr,
                detail="driver='scan' keeps no per-round snapshots; use "
                       "driver='host' for rollback recovery")
        hist = sim_engine.history(res, start_round=self._round_idx)
        self._round_idx += rounds
        self.history.extend(hist)
        return hist


def run_seed_compressed_round(loss_fn, params, clients_batches, rngs, cfg):
    """The digital-uplink round: each client ships (key, coeffs), the
    server replays them. The M local phases run as one cohort
    (``fedzo.cohort_phase``: on the flat route one ``[M, n_pad]`` buffer),
    the M wire messages are one stacked bundle
    (``seedcomm.compress_stacked``) and the replay is one
    ``seedcomm.aggregate``. ``clients_batches``: a list of per-client batch
    dicts or one stacked dict (leaves ``[M, H, ...]``); ``rngs``: a list of
    raw keys or ``[M, 2]``. Returns (params', wire bytes, dense bytes)."""
    if isinstance(clients_batches, (list, tuple)):
        clients_batches = tree_stack(list(clients_batches))
    if isinstance(rngs, (list, tuple)):
        rngs = torch.stack(list(rngs))
    res = fedzo.cohort_phase(loss_fn, params, clients_batches, rngs, cfg)
    M = res.coeffs.shape[0]
    msgs = seedcomm.compress_stacked(rngs, res.coeffs, cfg)
    delta = seedcomm.aggregate(msgs, params, cfg)
    return (tree_add(params, delta), seedcomm.wire_bytes(msgs),
            tree_bytes(params) * M)
