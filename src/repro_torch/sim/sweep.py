"""Scenario sweeps: the paper's experiment grids.

Counterpart of ``repro/sim/sweep.py``. Sec. V sweeps {H, M, b2, SNR} over
many rounds. The fields of a scenario fall in two kinds, as in the
reference:

- **static** fields (``local_iters``, ``n_participating``, ``b2``, the
  AirComp and scheduling flags, ``batch_directions``, the strategy, a
  ``channel_model``…) change shapes or the round's program;
- **dynamic** fields (``snr_db``, ``lr``, ``mu``, ``h_min``, and the seed)
  change only numbers (``DYNAMIC_FIELDS``).

``run_sweep`` groups the scenarios by their static signature, as the
reference does; where the reference then runs a group as one vmapped
compiled program, the port runs each of the group's scenarios as its own
``engine.run_experiment`` in one loop, so a scenario's record is bitwise
its own single run. The records and the long-format CSV (scenario, round,
metric, value) are the reference's. ``store`` takes either tier: a
tiered ``HostStore`` materializes as a resident store, bitwise
``build_store``.
"""
from __future__ import annotations

import dataclasses
import itertools
from contextlib import nullcontext
from typing import Optional, Sequence

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import estimator
from repro_torch.core import strategy as strategy_mod
from repro_torch.sim import engine, tiered
from repro_torch.sim.store import ClientStore

# fields that only change numbers (everything else is static; the strategy
# selectors cfg.strategy, prox_mu and dyn_alpha change the round and are
# static)
DYNAMIC_FIELDS = ("snr_db", "lr", "mu", "h_min")


def scenario_grid(**axes) -> list:
    """Cartesian product of config-override axes into scenario dicts:
    ``scenario_grid(local_iters=(1, 5), snr_db=(-5.0, 0.0))`` → 4 dicts."""
    names = list(axes)
    return [dict(zip(names, combo))
            for combo in itertools.product(*(axes[n] for n in names))]


def _freeze(key, value):
    """Hashable form of one static override (the static signature keys the
    groups): sequences become tuples; anything else unhashable raises,
    naming the field."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(key, v) for v in value)
    try:
        hash(value)
    except TypeError:
        raise TypeError(
            f"scenario field {key!r} has an unhashable static value of "
            f"type {type(value).__name__} — static overrides group "
            f"compiles by value, so pass a hashable (lists are "
            f"normalized to tuples automatically)") from None
    return value


def _split(scenario: dict):
    dyn = {k: v for k, v in scenario.items() if k in DYNAMIC_FIELDS
           or k == "seed"}
    static = tuple(sorted((k, _freeze(k, v)) for k, v in scenario.items()
                          if k not in dyn))
    return static, dyn


def run_sweep(loss_fn, params, store: ClientStore, base_cfg: FedZOConfig,
              scenarios: Sequence[dict], rounds: int, *,
              algo: Optional[str] = None, strategy=None, eval_fn=None,
              eval_every: int = 0, ring_size: int = 0,
              out_csv: Optional[str] = None, tracer=None) -> list:
    """Run every scenario (dicts of ``FedZOConfig`` overrides) for
    ``rounds`` rounds from ``params``, grouped by static signature.

    The algorithm resolves per group: an explicit ``strategy=`` (or the
    deprecated ``algo=``) applies to every scenario, else each group's
    ``cfg.strategy``. ``tracer=`` records the compile span (the kernels'
    build, once) and one ``execute`` span per group.

    Returns one record per scenario, in group order: ``{"scenario": dict,
    "strategy": name, "metrics": {name: [ring] np.ndarray}, "evals":
    {name: [n_evals] np.ndarray}, "eval_rounds": np.ndarray}``.
    """
    # either tier plugs in; the rounds read a resident store, so a tiered
    # HostStore materializes (bitwise build_store) on the params' device
    store = tiered.resolve_store(store, tier="resident",
                                 device=estimator._device(params))
    groups: dict = {}
    for s in scenarios:
        static, dyn = _split(s)
        groups.setdefault(static, []).append((s, dyn))

    records = []
    for static, members in groups.items():
        cfg = dataclasses.replace(base_cfg, **dict(static))
        strat = strategy_mod.resolve(strategy, algo, cfg)
        if strat.has_momentum(cfg):
            raise ValueError("sweeps keep the carry momentum-free; run "
                             "momentum configs through run_experiment")
        if tracer is not None:
            engine._compile_span(tracer, params)
        with (tracer.span("execute", group=str(dict(static)),
                          scenarios=len(members))
              if tracer is not None else nullcontext()):
            for scenario, dyn in members:
                res = engine.run_experiment(
                    loss_fn, params, store,
                    dataclasses.replace(cfg, **dyn), rounds, strategy=strat,
                    eval_fn=eval_fn, eval_every=eval_every,
                    ring_size=ring_size)
                # names in sorted order, as jax hands back a dict
                records.append({
                    "scenario": dict(scenario),
                    "strategy": strat.name,
                    "metrics": {k: res.metrics[k].cpu().numpy()
                                for k in sorted(res.metrics)},
                    "evals": {k: res.evals[k].cpu().numpy()
                              for k in sorted(res.evals)},
                    "eval_rounds": res.eval_rounds,
                })

    if out_csv:
        save_csv(records, out_csv, rounds=rounds, ring_size=ring_size)
    return records


def save_csv(records, path, *, rounds: int, ring_size: int = 0) -> None:
    """Long-format curves: ``scenario,round,metric,value``; the scenario
    tag always carries ``strategy=``."""
    ring = min(rounds, ring_size) if ring_size else rounds
    start = rounds - ring
    with open(path, "w") as f:
        f.write("scenario,round,metric,value\n")
        for rec in records:
            items = dict(rec["scenario"])
            items.setdefault("strategy", rec.get("strategy", "fedzo"))
            tag = ";".join(f"{k}={v}" for k, v in sorted(items.items()))
            for name, arr in rec["metrics"].items():
                for t in range(start, rounds):
                    f.write(f"{tag},{t},{name},{float(arr[t % ring])}\n")
            for name, arr in rec["evals"].items():
                for i, t in enumerate(rec["eval_rounds"]):
                    f.write(f"{tag},{t},{name},{float(arr[i])}\n")
