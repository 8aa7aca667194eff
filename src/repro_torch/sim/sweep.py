"""Scenario sweeps: the paper's experiment grids, one batched round loop
per static group.

Counterpart of ``repro/sim/sweep.py``. Sec. V sweeps {H, M, b2, SNR} over
many rounds. The fields of a scenario fall in two kinds, as in the
reference:

- **static** fields (``local_iters``, ``n_participating``, ``b2``, the
  AirComp and scheduling flags, ``batch_directions``, the strategy, a
  ``channel_model``…) change shapes or the round's program;
- **dynamic** fields (``snr_db``, ``lr``, ``mu``, ``h_min``, and the seed)
  change only numbers (``DYNAMIC_FIELDS``).

``run_sweep`` groups the scenarios by their static signature and runs each
group as ONE round loop over an ``[S, M]`` cohort, the counterpart of the
reference's ``jax.jit(jax.vmap(one))`` over the group's S scenarios:

- the carry keys are ``[S, words]`` and every draw of the round is the
  reference's draw under its scenario vmap (``utils/prng.py``: per key for
  threefry; for rbg and unsafe_rbg one batched draw from the first
  scenario's key, which is why a scenario's rbg record is not its single
  run's, in the reference and here alike);
- the dynamic fields are ``[S]`` values: lr and μ per row of the cohort
  buffer (``fedzo.RowHyper``), ``h_min`` per row of the scheduling draw,
  the SNR per scenario's aggregation;
- on the flat and wide routes the S·M clients' local phases run as one
  ``[S·M, n_pad]`` cohort (``fedzo.cohort_rows``: one batched loss forward
  per iterate over S·M·b2 points on the wide route); the pytree route runs
  its S·M clients one after another (``fedzo.tree_rows``), each drawing
  as its row of the vmap;
- each scenario aggregates its own M deltas (``fedzo.aggregate``): with
  AirComp that is one ``aircomp_reduce`` and one ``zo_walk`` launch per
  scenario and round;
- a ``channel_model`` (a static field) keeps one wireless chain per
  scenario, advanced per scenario from its row of the round's channel
  keys (``prng.lanes``).

The batched loop runs every built-in strategy: for fedprox, feddyn and
scaffold each scenario's loss wrap adds its per-row term to its rows of
one cohort forward, and each scenario keeps its own client state, delta
transform and server step; FedAvg runs the S·M rows' SGD phases side by
side. A strategy of another class runs scenario by scenario through
``engine.run_experiment`` under threefry keys, whose per-key draws make
that the vmapped program's records, and raises under rbg keys. Momentum
is rejected, as in the reference. The
records and the long-format CSV (scenario, round, metric, value) are the
reference's. ``store`` takes either tier: a tiered ``HostStore``
materializes as a resident store, bitwise ``build_store``.
"""
from __future__ import annotations

import dataclasses
import itertools
from contextlib import nullcontext
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import aircomp, estimator, fedavg, fedzo
from repro_torch.core import strategy as strategy_mod
from repro_torch.sim import channel as channel_lib
from repro_torch.sim import engine, tiered
from repro_torch.sim.channel import RoundChannel
from repro_torch.sim.store import (ClientStore, sample_batches,
                                   sample_participants)
from repro_torch.utils import prng
from repro_torch.utils.flatparams import flatten
from repro_torch.utils.tree import tree_add, tree_map, tree_stack, tree_sub

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
    ``rounds`` rounds from ``params``, one batched round loop per static
    group (``batched_group``).

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
    eval_rounds = (np.arange(0, rounds, eval_every)
                   if (eval_fn is not None and eval_every > 0)
                   else np.arange(0))
    for static, members in groups.items():
        cfg = dataclasses.replace(base_cfg, **dict(static))
        strat = strategy_mod.resolve(strategy, algo, cfg)
        if strat.has_momentum(cfg):
            raise ValueError("sweeps keep the carry momentum-free; run "
                             "momentum configs through run_experiment")
        if tracer is not None:
            engine._compile_span(tracer, params)
        dyns = [{**{f: getattr(base_cfg, f) for f in DYNAMIC_FIELDS},
                 "seed": base_cfg.seed, **d} for _, d in members]
        with (tracer.span("execute", group=str(dict(static)),
                          scenarios=len(members))
              if tracer is not None else nullcontext()):
            if batchable(cfg, strat):
                runs = batched_group(loss_fn, params, store, cfg, dyns,
                                     rounds, strategy=strat,
                                     eval_fn=eval_fn, eval_every=eval_every,
                                     ring_size=ring_size)
            else:
                runs = _scenario_by_scenario(
                    loss_fn, params, store, cfg, strat, dyns, rounds,
                    eval_fn=eval_fn, eval_every=eval_every,
                    ring_size=ring_size)
        for (scenario, _), (ring, ebuf) in zip(members, runs):
            # names in sorted order, as jax hands back a dict
            records.append({
                "scenario": dict(scenario),
                "strategy": strat.name,
                "metrics": {k: ring[k].cpu().numpy() for k in sorted(ring)},
                "evals": {k: ebuf[k].cpu().numpy() for k in sorted(ebuf)},
                "eval_rounds": eval_rounds,
            })

    if out_csv:
        save_csv(records, out_csv, rounds=rounds, ring_size=ring_size)
    return records


# the strategies whose rounds the batched loop runs through their hooks
_BATCHED = (strategy_mod.AlgoStrategy, strategy_mod.FedAvgStrategy,
            strategy_mod.ZOFedProx, strategy_mod.ZOFedDyn,
            strategy_mod.ZOScaffold)


def batchable(cfg: FedZOConfig, strat) -> bool:
    """Whether a group runs as one batched round loop: a built-in strategy
    (fedzo, fedprox, feddyn, scaffold, fedavg), whose hooks the loop
    calls. A strategy of another class runs scenario by scenario."""
    return type(strat) in _BATCHED


def _scenario_by_scenario(loss_fn, params, store, cfg, strat, dyns, rounds,
                          **kw) -> list:
    """A group of a strategy the batched loop does not know, one
    ``run_experiment`` per scenario: the vmapped program's records under
    threefry keys (drawn per key), not under rbg keys (drawn from the
    first scenario's key), which raise."""
    if prng.resolve(cfg.prng_impl) is not prng.THREEFRY:
        raise NotImplementedError(
            f"a sweep group with strategy {strat.name!r} of class "
            f"{type(strat).__name__} under prng_impl={cfg.prng_impl!r}: "
            f"the batched loop runs the built-in strategies only")
    out = []
    for dyn in dyns:
        res = engine.run_experiment(
            loss_fn, params, store, dataclasses.replace(cfg, **dyn), rounds,
            strategy=strat, **kw)
        out.append((res.metrics, res.evals))
    return out


def _record(buf: dict, k, v, size: int, slot: int):
    v = torch.as_tensor(v)
    if k not in buf:
        buf[k] = torch.zeros((size,), dtype=v.dtype, device=v.device)
    buf[k][slot] = v


def _group_loss(loss_fn, wraps):
    """The cohort loss of S scenarios' ``[S·R']`` rows (scenario s's rows
    ``[s·R', (s+1)·R')``): ONE batched forward of ``loss_fn`` over all
    rows, then each scenario's wrapped loss adds its per-row term
    (``add_rows``: the anchor and state of its own round) to its rows. A
    cohort-only loss: it carries ``.batched`` alone."""
    base = fedzo.batched_loss(loss_fn)

    def batched(p, b):
        losses = base(p, b)
        n = losses.shape[0] // len(wraps)
        return torch.cat([w.add_rows(losses[s * n:(s + 1) * n], tree_map(
            lambda v: v[s * n:(s + 1) * n], p)) for s, w in enumerate(wraps)])

    return SimpleNamespace(batched=batched)


def batched_group(loss_fn, params, store: ClientStore, cfg: FedZOConfig,
                  dyns: Sequence[dict], rounds: int, *, strategy=None,
                  eval_fn=None, eval_every: int = 0,
                  ring_size: int = 0) -> list:
    """S scenarios of one static group as one round loop over an ``[S,
    M]`` cohort. ``dyns`` holds each scenario's dynamic fields and seed;
    ``strategy`` (a ``batchable`` one; None: fedzo) each scenario's
    algorithm. Returns ``[(metrics ring, evals)]``, one per scenario, as
    ``engine.run_experiment`` fills them.

    A hooked ZO strategy builds its hooks per scenario from that
    scenario's parameters, config and state (``HookedZO.hooks``): its
    loss wrap's per-row term on the scenario's rows of the one cohort loss
    (``_group_loss``; per row on the pytree route), its delta transform on
    the scenario's ``[M, ...]`` deltas and gathered state, its server step
    after the scenario's aggregate. Each scenario keeps its own ``[N,
    ...]`` client state. FedAvg runs the S·M rows' SGD phases as one
    cohort (``fedavg.cohort_rows``, the lr per row) and aggregates each
    scenario's stacked delta tree."""
    strat = strategy if strategy is not None else strategy_mod.get("fedzo")
    impl = prng.resolve(cfg.prng_impl)
    S, M = len(dyns), cfg.n_participating
    H, b1 = cfg.local_iters, cfg.b1
    dev = estimator._device(params)
    cfgs = [dataclasses.replace(cfg, **d) for d in dyns]
    vals = {f: np.array([d[f] for d in dyns], np.float64)
            for f in DYNAMIC_FIELDS}
    h_min = torch.tensor(vals["h_min"].astype(np.float32))[:, None]
    hyper = fedzo.RowHyper(lr=np.repeat(vals["lr"], M),
                           mu=np.repeat(vals["mu"], M))
    key = torch.stack([prng.key(d["seed"], impl) for d in dyns])  # [S, w]
    cm = cfg.channel_model
    if cm is not None:
        # each scenario's chain from its fold-in key, as run_experiment;
        # the stationary draw is the scenario vmap's batched draw
        cstates = [cm.init_state(store.n_clients, k, impl) for k in
                   prng.lanes(channel_lib.init_key(key, impl), impl)]
    first_order = isinstance(strat, strategy_mod.FedAvgStrategy)
    hooked = (isinstance(strat, strategy_mod.HookedZO)
              and strat.active(cfg))
    zs = [strat.init_state(params, c, store.n_clients) for c in cfgs]
    wide = (cfg.flat_params or cfg.batch_directions) and not first_order
    spec, br = (fedzo.cohort_geometry(params, cfg) if wide
                else (None, None))
    ps = [params] * S
    ring_alloc = min(rounds, ring_size) if ring_size else rounds
    do_eval = eval_fn is not None and eval_every > 0
    n_evals = (rounds + eval_every - 1) // eval_every if do_eval else 0
    rings, ebufs = [{} for _ in range(S)], [{} for _ in range(S)]
    for t in range(rounds):
        key, k_part, k_batch, k_zo, k_chan, _, k_chanm = \
            engine.split_round_keys(key, channel=cm is not None, impl=impl)
        idx = sample_participants(k_part, store.n_clients, M, impl)  # [S, M]
        batches = sample_batches(store, idx, k_batch, H, b1, impl)
        rows_batches = tree_map(
            lambda v: v.reshape((S * M,) + v.shape[2:]), batches)
        client_rngs = prng.split(k_zo, M, impl)               # [S, M, w]
        channel = None
        if cm is not None:
            chans = []
            for s, k in enumerate(prng.lanes(k_chanm, impl)):
                cstates[s], rc = cm.step(
                    k, cstates[s], idx[s], h_min=cfgs[s].h_min,
                    schedule=cfg.channel_schedule, impl=impl)
                chans.append(rc)
            channel = RoundChannel(model=cm,
                                   h=torch.stack([c.h for c in chans]),
                                   mask=torch.stack([c.mask for c in chans]))
        mask, noise = fedzo.round_schedule(cfg, k_chan, channel, M, dev,
                                           impl, h_min=h_min)
        noise = prng.lanes(noise, impl)                       # per scenario
        cohorts = ([strat._gather(zs[s], idx[s]) for s in range(S)]
                   if hooked and strat.stateful else [None] * S)
        hooks = ([strat.hooks(ps[s], cfgs[s], zs[s]) for s in range(S)]
                 if hooked else [(None, None)] * S)
        if first_order:
            p_rows = tree_map(lambda *v: torch.stack(v).repeat_interleave(
                M, dim=0), *ps)
            p_fin, losses = fedavg.cohort_rows(loss_fn, p_rows, rows_batches,
                                               cfg, lr=hyper.lr)
            d_rows = tree_sub(p_fin, p_rows)
            deltas = [tree_map(lambda v: v[s * M:(s + 1) * M], d_rows)
                      for s in range(S)]
        elif wide:
            lf = loss_fn
            if hooks[0][0] is not None:
                lf = _group_loss(loss_fn, [w(loss_fn, c) for (w, _), c in
                                           zip(hooks, cohorts)])
            buf0 = torch.stack([flatten(p, spec) for p in ps])
            bufs = buf0.repeat_interleave(M, dim=0)           # [S·M, n]
            buf, _, losses = fedzo.cohort_rows(
                lf, bufs, spec, br, rows_batches,
                client_rngs.reshape(S * M, -1), cfg, like=params,
                impl=impl, hyper=hyper)
            deltas = (buf - bufs).reshape(S, M, -1)
        else:
            lfs = []
            for r in range(S * M):   # row r: client r % M of scenario r // M
                wrap, c = hooks[r // M][0], cohorts[r // M]
                lfs.append(loss_fn if wrap is None else wrap(
                    loss_fn, None if c is None else tree_map(
                        lambda v: v[r % M], c)))
            rows, _, losses = fedzo.tree_rows(
                lfs, [ps[r // M] for r in range(S * M)], rows_batches,
                client_rngs.reshape(S * M, -1),
                [cfgs[r // M] for r in range(S * M)], impl)
            deltas = [tree_stack(rows[s * M:(s + 1) * M]) for s in range(S)]
        losses = losses.reshape(S, M, H)
        for s in range(S):
            d_s, new_cohort = deltas[s], cohorts[s]
            state_fn = hooks[s][1]
            if state_fn is not None:
                d_s, new_cohort = state_fn(d_s, cohorts[s], spec)
            w = (aircomp.size_weights(store.sizes[idx[s]])
                 if cfg.weight_by_size else None)
            agg, stats = fedzo.aggregate(
                d_s, spec, br, cfgs[s], noise_rng=noise[s],
                mask=None if mask is None else mask[s], weights=w,
                impl=impl, dev=dev)
            p_new = tree_add(ps[s], agg)
            if hooked:
                p_new, zs[s] = strat.server_step(
                    ps[s], p_new, cfgs[s], zs[s], idx[s], cohorts[s],
                    new_cohort)
            ps[s] = p_new
            metrics = {"mean_local_loss": torch.mean(losses[s]),
                       **({} if first_order else
                          {"first_loss": torch.mean(losses[s][:, 0])}),
                       **stats}
            for k, v in metrics.items():
                _record(rings[s], k, v, ring_alloc, t % ring_alloc)
            if do_eval and t % eval_every == 0:
                for k, v in eval_fn(ps[s]).items():
                    _record(ebufs[s], k, v, n_evals, t // eval_every)
    return list(zip(rings, ebufs))


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
