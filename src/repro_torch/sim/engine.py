"""Multi-round federation engine: every registered strategy on the
pytree, flat and wide routes, under faults and the wireless scenario, with
durable checkpointed runs.

Counterpart of ``repro/sim/engine.py:84-180, 251-415, 477-881``. The
reference runs a whole experiment as one compiled ``lax.scan``; here a
Python loop runs the rounds eagerly on the device and keeps the same key
chain, metrics ring and evaluation schedule:

    key, k_part, k_batch, k_zo, k_chan = split(key, 5)      # per round

``k_part`` draws the M-of-N participants, ``k_batch`` their minibatches,
``k_zo`` the M per-client ZO keys, ``k_chan`` the i.i.d. channel
realization. A ``FaultModel`` widens the split to 6 (``k_fault``: the
availability, straggler and corruption draws) and a ``cfg.channel_model``
once more (``k_chanm``, last: the wireless chain), exactly as the reference
(``split_round_keys``); runs without either keep the 5-way chain. The
chain starts at ``key(cfg.seed, cfg.prng_impl)`` (threefry, rbg or
unsafe_rbg), so a run draws the reference's clients,
rows, directions and faults. The algorithm comes from the strategy
registry (``core/strategy.py``); the carry is ``(params, momentum, key,
fstate, cstate, zstate)``: the fault chain's ``[N]`` states, the channel's
``[N]`` fading and batteries (both on the CPU with the keys) and the
stateful strategies' state.

Metrics land in a ``[ring_alloc]`` ring per metric on the device (slot
``t % ring_alloc``), evaluations in an ``[n_evals]`` buffer; neither costs
a host sync. ``tap_every=k`` with a ``sink`` streams every k-th round's
metrics (one sync each); ``tracer=`` records ``compile`` (the kernels'
one-time CUDA build), ``execute`` or per-``segment`` spans.

Durability: ``checkpoint_every=k`` with ``checkpoint_dir`` runs the same
rounds in k-round segments with one host sync and one atomic snapshot of
the whole carry per segment (``checkpoint.save_run_state``, the
reference's layout). A killed run resumes bitwise (``resume=True``); a
segment whose carry comes back non-finite rolls back to the last snapshot
with the lr scaled by ``lr_backoff``, at most ``max_retries`` times, then
raises ``DivergenceError``. Runs with a checkpoint dir or a file-backed
sink write a run manifest.

A ``sim.tiered.HostStore`` (the population in host memory) goes to the
tiered runner (``tiered.run_tiered_experiment``): its rounds are
``make_cohort_round_step`` over staged cohorts, run by ``stream_core``
through the same round loop, bitwise the resident run. The sharded round
(``sim/shard.py``) plugs in as ``round_fn``, every rank running this loop.
"""
from __future__ import annotations

import dataclasses
import warnings
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import aircomp, estimator, fedzo
from repro_torch.core import strategy as strategy_mod
from repro_torch.obs import manifest as obs_manifest
from repro_torch.obs.ledger import CommsLedger
from repro_torch.obs.taps import RoundTap
from repro_torch.sim import channel as channel_lib
from repro_torch.sim.faults import DivergenceError, FaultModel
from repro_torch.sim.channel import RoundChannel
from repro_torch.sim.store import (ClientStore, CohortBatch, sample_batches,
                                   sample_cohort_batches, sample_participants)
from repro_torch.utils import prng
from repro_torch.utils.flatparams import _leaves
from repro_torch.utils.tree import tree_zeros_like


def round_keys(key, impl=None):
    """(next_carry_key, k_participation, k_batches, k_zo, k_channel)."""
    ks = prng.split(key, 5, impl)
    return ks[0], ks[1], ks[2], ks[3], ks[4]


def split_round_keys(key, *, faults: bool = False, channel: bool = False,
                     impl=None):
    """The per-round split, widened by the optional processes: ``(key',
    k_part, k_batch, k_zo, k_chan, k_fault, k_chanm)``, ``k_fault`` /
    ``k_chanm`` None when faults / the channel model are off. The fault
    stream comes first, the channel stream last; a run without either keeps
    the 5-way chain, a faults-only run the 6-way one. Keys ``[S, words]``
    (the scenarios of a batched sweep) split to ``[S, ...]`` streams."""
    n = 5 + int(faults) + int(channel)
    ks = prng.split(key, n, impl)
    k_fault = ks[..., 5, :] if faults else None
    k_chanm = ks[..., 5 + int(faults), :] if channel else None
    return (ks[..., 0, :], ks[..., 1, :], ks[..., 2, :], ks[..., 3, :],
            ks[..., 4, :], k_fault, k_chanm)


def experiment_key(cfg: FedZOConfig):
    """Round-0 carry key of an experiment, ``jax.random.key(cfg.seed,
    impl=cfg.prng_impl)``: threefry ``[2]``, rbg or unsafe_rbg ``[4]``."""
    return prng.key(cfg.seed, cfg.prng_impl)


def _step_strategy(strategy, algo, cfg: FedZOConfig, round_fn):
    """The round step's strategy, resolved and checked against the config
    and a custom ``round_fn``."""
    strat = strategy_mod.resolve(strategy, algo, cfg)
    strat.validate(cfg)
    if round_fn is not None and not strat.supports_round_fn:
        raise ValueError(
            f"strategy {strat.name!r} wraps the local phase with loss/state "
            f"hooks that a custom round_fn (the sharded round) cannot carry "
            f"— run it through the default fedzo round")
    if strat.name != "fedavg":
        fedzo.check_route(cfg)
    return strat


def make_round_step(loss_fn, cfg: FedZOConfig, *, algo: Optional[str] = None,
                    strategy=None, round_fn=None,
                    faults: Optional[FaultModel] = None) -> Callable:
    """One communication round of the resolved strategy:
    ``step((params, momentum, key, fstate, cstate, zstate), store) ->
    ((params', momentum', key', fstate', cstate', zstate'), metrics)``.
    ``fstate`` is the fault chain (with ``faults``), ``cstate`` the
    wireless chain of ``cfg.channel_model``, ``zstate`` the strategy's
    carry; each None when unused. ``round_fn`` replaces
    ``fedzo.round_simulated`` (only for strategies without hooks)."""
    strat = _step_strategy(strategy, algo, cfg, round_fn)
    channel = cfg.channel_model
    impl = prng.resolve(cfg.prng_impl)

    def step(state, store: ClientStore):
        params, momentum, key, fstate, cstate, zstate = state
        key, k_part, k_batch, k_zo, k_chan, k_fault, k_chanm = \
            split_round_keys(key, faults=faults is not None,
                             channel=channel is not None, impl=impl)
        idx = sample_participants(k_part, store.n_clients,
                                  cfg.n_participating, impl)
        batches = sample_batches(store, idx, k_batch, cfg.local_iters,
                                 cfg.b1, impl)
        wkw = ({"weights": aircomp.size_weights(store.sizes[idx])}
               if cfg.weight_by_size else {})
        if faults is not None:
            fstate, wkw["faults"] = faults.step(k_fault, fstate, idx, impl)
        if channel is not None:
            cstate, wkw["channel"] = channel.step(
                k_chanm, cstate, idx, h_min=cfg.h_min,
                schedule=cfg.channel_schedule, impl=impl)
        params, metrics, momentum, zstate = strat.run_round(
            loss_fn, params, batches, k_zo, cfg, channel_rng=k_chan,
            momentum=momentum, zstate=zstate, idx=idx, round_fn=round_fn,
            impl=impl, **wkw)
        return (params, momentum, key, fstate, cstate, zstate), metrics

    return step


def make_cohort_round_step(loss_fn, cfg: FedZOConfig, *,
                           algo: Optional[str] = None, strategy=None,
                           round_fn=None,
                           faults: Optional[FaultModel] = None) -> Callable:
    """One round as a function of a staged cohort instead of a resident
    store: ``step((params, momentum, key, zstate), CohortBatch) ->
    ((params', momentum', key', zstate'), metrics)``. The tiered twin of
    ``make_round_step``, bitwise equal to it:

    - the same per-round split, with ``k_part`` and ``k_chanm`` left
      unconsumed (the host ``CohortStream`` spent its replicas choosing the
      staged clients and advancing the wireless chain);
    - minibatches from ``sample_cohort_batches`` over the staged rows and
      true sizes, the resident draws and gathers;
    - faults from ``FaultModel.realize`` on the host-replayed availability
      slice, the channel as the host-replayed ``RoundChannel``;
    - ``zstate`` cohort-shaped (``{"client": [M, ...], "server": ...}``)
      and ``idx = arange(M)``, so the stateful strategies' gather and
      scatter are identity permutations; the ``[N]`` master stays on the
      host.
    """
    strat = _step_strategy(strategy, algo, cfg, round_fn)
    channel = cfg.channel_model
    impl = prng.resolve(cfg.prng_impl)

    def step(state, cohort: CohortBatch):
        params, momentum, key, zstate = state
        key, _k_part, k_batch, k_zo, k_chan, k_fault, _k_chanm = \
            split_round_keys(key, faults=faults is not None,
                             channel=channel is not None, impl=impl)
        batches = sample_cohort_batches(cohort.data, cohort.sizes, k_batch,
                                        cfg.local_iters, cfg.b1, impl)
        wkw = ({"weights": aircomp.size_weights(cohort.sizes)}
               if cfg.weight_by_size else {})
        if faults is not None:
            wkw["faults"] = faults.realize(k_fault, cohort.avail, impl)
        if channel is not None:
            wkw["channel"] = RoundChannel(model=channel, h=cohort.chan_h,
                                          mask=cohort.chan_mask)
        idx = torch.arange(cohort.sizes.shape[0], dtype=torch.int64)
        params, metrics, momentum, zstate = strat.run_round(
            loss_fn, params, batches, k_zo, cfg, channel_rng=k_chan,
            momentum=momentum, zstate=zstate, idx=idx, round_fn=round_fn,
            impl=impl, **wkw)
        return (params, momentum, key, zstate), metrics

    return step


@dataclass
class ExperimentResult:
    """One engine run: final ``params`` (and ``momentum``), the carry
    ``key``, ``metrics`` (dict of ``[ring_size]`` rings, slot ``round %
    ring_size``) and ``evals`` (dict of ``[n_evals]`` tensors, one per
    round in ``eval_rounds``); ``fault_state`` and ``channel_state`` the
    final fault and wireless chains; ``events`` the host-side rows
    (divergence rollbacks); ``strategy`` the algorithm's name and
    ``strategy_state`` its final carry; ``ledger`` the run's
    ``obs.CommsLedger`` and ``manifest`` the run manifest written (None
    when the run had nowhere to write one). Tiered runs also fill
    ``staging`` (round -> ``{"bucket_id", "staged_bytes"}``, merged into
    ``history()`` rows) and ``prefetch`` (the stream's stall and byte
    accounting)."""
    params: Any
    momentum: Any
    key: Any
    metrics: dict
    evals: dict
    rounds: int
    ring_size: int
    eval_rounds: np.ndarray
    fault_state: Any = None
    channel_state: Any = None
    events: list = field(default_factory=list)
    strategy: str = "fedzo"
    strategy_state: Any = None
    ledger: Any = None
    manifest: Any = None
    staging: Any = None
    prefetch: Any = None

    def recorded_rounds(self) -> np.ndarray:
        """Round numbers still present in the ring, oldest to newest."""
        start = max(0, self.rounds - self.ring_size)
        return np.arange(start, self.rounds)

    def history(self, *, start_round: int = 0) -> list:
        """Per-round history rows (see the module-level ``history``)."""
        return history(self, start_round=start_round)


def _run_rounds(step, state, ring, ebuf, t0, t1, store, *, ring_alloc,
                n_evals, eval_fn=None, eval_every=0, tap=None):
    """Rounds ``[t0, t1)``: ring-buffer each round's metrics (slot ``t %
    ring_alloc``), emit the tap's rounds, evaluate every ``eval_every``
    rounds into ``ebuf`` (slot ``t // eval_every``). The buffers are
    allocated on their first write, with the metric's dtype and device.
    ``store`` is every round's input (a ``ClientStore``), or a list of one
    input a round (the tiered segment's staged cohorts, round t at
    ``t - t0``): one loop for both tiers."""
    for t in range(t0, t1):
        x = store[t - t0] if isinstance(store, list) else store
        state, metrics = step(state, x)
        slot = t % ring_alloc
        for k, v in metrics.items():
            v = torch.as_tensor(v)
            if k not in ring:
                ring[k] = torch.zeros((ring_alloc,), dtype=v.dtype,
                                      device=v.device)
            ring[k][slot] = v
        if tap is not None and t % tap.every == 0:
            tap.emit(t, metrics)
        if eval_fn is not None and eval_every > 0 and t % eval_every == 0:
            for k, v in eval_fn(state[0]).items():
                v = torch.as_tensor(v)
                if k not in ebuf:
                    ebuf[k] = torch.zeros((n_evals,), dtype=v.dtype,
                                          device=v.device)
                ebuf[k][t // eval_every] = v
    return state


def _compile_span(tracer, params):
    """The run's ``compile`` span: the one-time CUDA build of the kernels
    on a card (nothing to build on the CPU), recorded once per tracer."""
    dev = estimator._device(params)

    def build():
        if dev.type == "cuda":
            from repro_torch.kernels import build as kbuild
            kbuild.load()

    tracer.compile_once(("kernels", dev.type), build)


def stream_core(loss_fn, params, cfg: FedZOConfig, key, momentum, *,
                strategy=None, zstate=None, xs: CohortBatch, t0: int,
                total_rounds: int, ring, ebuf, eval_fn=None,
                eval_every: int = 0, ring_size: int = 0, round_fn=None,
                faults: Optional[FaultModel] = None, tap=None):
    """One tiered segment: ``make_cohort_round_step`` over the staged
    cohort stream ``xs`` (a ``CohortBatch`` whose fields carry a leading
    ``[S]`` rounds axis), as global rounds ``[t0, t0 + S)`` of a
    ``total_rounds``-round run. The ring and eval buffers are sized and
    slotted against the total and threaded through, and the loop is the
    resident runner's ``_run_rounds``, so the two tiers cannot drift.
    Returns ``(params, momentum, key, zstate, ring, ebuf)``."""
    strat = strategy_mod.resolve(strategy, None, cfg)
    seg = xs.sizes.shape[0]
    ring_alloc = min(total_rounds, ring_size) if ring_size else total_rounds
    do_eval = eval_fn is not None and eval_every > 0
    n_evals = ((total_rounds + eval_every - 1) // eval_every if do_eval
               else 0)
    step = make_cohort_round_step(loss_fn, cfg, strategy=strat,
                                  round_fn=round_fn, faults=faults)

    def at(v, j):
        return None if v is None else v[j]

    rounds = [CohortBatch(data={k: v[j] for k, v in xs.data.items()},
                          sizes=xs.sizes[j], avail=at(xs.avail, j),
                          chan_h=at(xs.chan_h, j),
                          chan_mask=at(xs.chan_mask, j))
              for j in range(seg)]
    state = _run_rounds(step, (params, momentum, key, zstate), ring, ebuf,
                        t0, t0 + seg, rounds, ring_alloc=ring_alloc,
                        n_evals=n_evals, eval_fn=eval_fn,
                        eval_every=eval_every, tap=tap)
    params, momentum, key, zstate = state
    return params, momentum, key, zstate, ring, ebuf


def make_experiment_fn(loss_fn, cfg: FedZOConfig, rounds: int, *,
                       algo: Optional[str] = None, strategy=None,
                       eval_fn=None, eval_every: int = 0,
                       ring_size: int = 0, round_fn=None,
                       faults: Optional[FaultModel] = None,
                       donate: bool = True, tap=None) -> Callable:
    """The whole experiment as one function, built once (the reference's
    ``make_experiment_fn``, ``repro/sim/engine.py:451``):
    ``fn(params, momentum, key, fstate, cstate, zstate, store) ->
    (params', momentum', key', fstate', cstate', zstate', metrics_ring,
    evals)``, ``rounds`` round steps of the resolved strategy with the
    metrics ring-buffered and ``eval_fn`` every ``eval_every`` rounds. Pass
    ``momentum=None`` when ``cfg.server_momentum`` is 0, ``fstate=None``
    without ``faults``, ``cstate=None`` without ``cfg.channel_model`` and
    ``zstate=None`` for the stateless strategies. ``tap`` attaches an
    ``obs.RoundTap``. Nothing is compiled, so ``donate`` changes nothing:
    the rounds build new tensors and never write the caller's."""
    del donate
    strat = strategy_mod.resolve(strategy, algo, cfg)
    step = make_round_step(loss_fn, cfg, strategy=strat, round_fn=round_fn,
                           faults=faults)
    do_eval = eval_fn is not None and eval_every > 0
    kw = dict(ring_alloc=min(rounds, ring_size) if ring_size else rounds,
              n_evals=(rounds + eval_every - 1) // eval_every if do_eval
              else 0, eval_fn=eval_fn, eval_every=eval_every, tap=tap)

    def fn(params, momentum, key, fstate, cstate, zstate, store):
        ring, ebuf = {}, {}
        state = _run_rounds(step, (params, momentum, key, fstate, cstate,
                                   zstate), ring, ebuf, 0, rounds, store,
                            **kw)
        return (*state, ring, ebuf)

    return fn


def run_experiment(loss_fn, params, store: ClientStore, cfg: FedZOConfig,
                   rounds: int, *, algo: Optional[str] = None, strategy=None,
                   eval_fn=None, eval_every: int = 0, ring_size: int = 0,
                   key=None, momentum=None, zstate=None, round_fn=None,
                   faults: Optional[FaultModel] = None, fault_state=None,
                   channel_state=None, checkpoint_every: int = 0, checkpoint_dir=None,
                   resume: bool = False, max_segments=None,
                   segment_callback=None, max_retries: int = 3,
                   lr_backoff: float = 0.5, sink=None,
                   tap_every: Optional[int] = None,
                   tracer=None, stream_segment: int = 8,
                   prefetch: bool = True) -> ExperimentResult:
    """Run ``rounds`` rounds of the resolved strategy (``strategy=`` a name
    or instance, the deprecated ``algo=``, else ``cfg.strategy``).

    ``eval_fn(params) -> dict of scalars`` runs after round t when ``t %
    eval_every == 0``; ``ring_size`` bounds the metrics ring (0 keeps every
    round). ``faults`` attaches a ``sim.faults.FaultModel`` and
    ``cfg.channel_model`` the wireless scenario. The fault chain, the
    wireless chain and the stateful strategies' state start from their
    ``init_state`` unless ``fault_state``, ``channel_state`` or ``zstate``
    is given: passing a result's ``params``, ``key``, ``momentum``,
    ``fault_state``, ``channel_state`` and ``strategy_state`` back in
    continues the run.

    ``checkpoint_every=k`` (with ``checkpoint_dir``) switches to the
    durable segment runner: the same rounds in k-round segments, one host
    sync and one atomic snapshot per segment, bitwise the single-shot run;
    ``resume=True`` continues from the latest snapshot in the directory
    (fresh when there is none); a non-finite segment rolls back with the
    lr scaled by ``lr_backoff``, at most ``max_retries`` times, then
    ``DivergenceError``. ``max_segments`` bounds the segments of this call;
    ``segment_callback(round, total)`` fires after every snapshot.

    ``sink=`` with ``tap_every=k`` streams every k-th round's metrics;
    ``tracer=`` (an ``obs.Tracer``) records the compile and execute (or
    segment) spans and, with its ``profile_dir``, a torch.profiler trace.
    Every result carries ``result.ledger``; runs with a checkpoint dir or a
    file-backed sink also write a run manifest beside their artifacts.

    A ``sim.tiered.HostStore`` goes to the tiered runner
    (``tiered.run_tiered_experiment``): the same contract and, bitwise,
    the same trajectory, with the population in host memory.
    ``stream_segment`` and ``prefetch`` tune that tier's staging only; the
    resident runner ignores them, as it does ``zstate``, ``fault_state``
    and ``channel_state`` on the tiered one.
    """
    if not isinstance(store, ClientStore):
        from repro_torch.sim import tiered
        if isinstance(store, tiered.HostStore):
            return tiered.run_tiered_experiment(
                loss_fn, params, store, cfg, rounds, algo=algo,
                strategy=strategy, eval_fn=eval_fn, eval_every=eval_every,
                ring_size=ring_size, key=key, momentum=momentum,
                round_fn=round_fn, faults=faults,
                checkpoint_every=checkpoint_every,
                checkpoint_dir=checkpoint_dir, resume=resume,
                max_segments=max_segments,
                segment_callback=segment_callback,
                max_retries=max_retries, lr_backoff=lr_backoff, sink=sink,
                tap_every=tap_every, tracer=tracer,
                stream_segment=stream_segment, prefetch=prefetch)
        raise TypeError(f"store must be a ClientStore or HostStore, got "
                        f"{type(store).__name__}")
    strat = strategy_mod.resolve(strategy, algo, cfg)
    if key is None:
        key = experiment_key(cfg)
    if momentum is None and strat.has_momentum(cfg):
        momentum = tree_zeros_like(params)
    if zstate is None:
        zstate = strat.init_state(params, cfg, store.n_clients)
    fstate = fault_state
    if fstate is None and faults is not None:
        fstate = faults.init_state(store.n_clients)
    channel = cfg.channel_model
    # the chain's round-0 key is folded off the experiment key (never a
    # split of the round chain), so channel-off runs keep their key usage
    cstate = channel_state
    if cstate is None and channel is not None:
        impl = prng.resolve(cfg.prng_impl)
        cstate = channel.init_state(store.n_clients,
                                    channel_lib.init_key(key, impl), impl)
    tap = None
    if tap_every is not None:
        if sink is None:
            raise ValueError("tap_every=k needs a sink= to stream into")
        tap = RoundTap(sink, tap_every)
    ledger = CommsLedger.from_run(cfg, params, channel=channel)
    if checkpoint_every > 0:
        return _run_checkpointed(
            loss_fn, params, store, cfg, rounds, strategy=strat,
            eval_fn=eval_fn, eval_every=eval_every, ring_size=ring_size,
            key=key, momentum=momentum, round_fn=round_fn, faults=faults,
            fstate=fstate, cstate=cstate, zstate=zstate,
            checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir, resume=resume,
            max_segments=max_segments, segment_callback=segment_callback,
            max_retries=max_retries, lr_backoff=lr_backoff, tap=tap,
            tracer=tracer, ledger=ledger)
    fn = make_experiment_fn(loss_fn, cfg, rounds, strategy=strat,
                            eval_fn=eval_fn, eval_every=eval_every,
                            ring_size=ring_size, round_fn=round_fn,
                            faults=faults, tap=tap)
    do_eval = eval_fn is not None and eval_every > 0
    ring_alloc = min(rounds, ring_size) if ring_size else rounds
    args = (params, momentum, key, fstate, cstate, zstate, store)
    if tracer is not None:
        with tracer.profile():
            _compile_span(tracer, params)
            with tracer.span("execute", rounds=rounds):
                out = fn(*args)
    else:
        out = fn(*args)
    params, momentum, key, fstate, cstate, zstate, ring, ebuf = out
    result = ExperimentResult(
        params=params, momentum=momentum, key=key, metrics=ring, evals=ebuf,
        rounds=rounds, ring_size=ring_alloc,
        eval_rounds=(np.arange(0, rounds, eval_every) if do_eval
                     else np.arange(0)),
        fault_state=fstate, channel_state=cstate, strategy=strat.name,
        strategy_state=zstate, ledger=ledger)
    sink_path = getattr(sink, "path", None)
    if sink_path:
        result.manifest = obs_manifest.build_manifest(
            cfg, strategy=strat.name, rounds=rounds,
            n_clients=store.n_clients, ledger=ledger, faults=faults,
            channel=channel, events=result.events,
            extra={"tap_every": tap.every} if tap is not None else None)
        obs_manifest.write_manifest(f"{sink_path}.manifest.json",
                                    result.manifest)
    return result


def _key_words(key) -> np.ndarray:
    """A raw key's two words as uint32 (the reference's ``key_data``)."""
    return key.cpu().numpy().astype(np.uint32)


def _carry_to_state(params, momentum, key, fstate, cstate, zstate, ring,
                    ebuf) -> dict:
    """The durable form of the carry: one tree of host arrays in the
    reference's layout (the key as its uint32 words; a None part adds no
    leaves). Reading it is the segment's one host sync."""
    def host(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(host(v) for v in tree)
        return tree.detach().cpu()

    return {"params": host(params), "momentum": host(momentum),
            "key": _key_words(key), "fstate": host(fstate),
            "cstate": host(cstate), "zstate": host(zstate),
            "ring": host(ring), "ebuf": host(ebuf)}


def _like(params, momentum, fstate, cstate, zstate, ring, ebuf) -> dict:
    """The restore target of a snapshot: the carry's structure, each leaf
    on the device and in the dtype the run holds it (the key as int64
    words on the CPU)."""
    return {"params": params, "momentum": momentum,
            "key": torch.zeros(2, dtype=torch.int64), "fstate": fstate,
            "cstate": cstate, "zstate": zstate, "ring": ring, "ebuf": ebuf}


def _buffers_from(snapshot, name, device) -> dict:
    """Zero buffers named and shaped as a snapshot's ring or eval buffer
    (the port allocates its buffers on their first write, so a restore
    takes their names from the file)."""
    from repro_torch.checkpoint import checkpoint as ckpt
    return {k: torch.zeros(v.shape, dtype=torch.from_numpy(v[:0]).dtype,
                           device=device)
            for k, v in ckpt.snapshot_entries(snapshot, name).items()}


def _restore(snapshot, like_parts, device):
    """(carry parts, meta) of a snapshot, restored like ``like_parts``
    ``(params, momentum, fstate, cstate, zstate)``."""
    from repro_torch.checkpoint import checkpoint as ckpt
    like = _like(*like_parts, _buffers_from(snapshot, "ring", device),
                 _buffers_from(snapshot, "ebuf", device))
    state, meta = ckpt.restore_run_state(snapshot, like)
    return (state["params"], state["momentum"], state["key"],
            state["fstate"], state["cstate"], state["zstate"], state["ring"],
            state["ebuf"]), meta


def _finite_state(state: dict, rounds_done, ring_alloc, eval_every,
                  do_eval) -> bool:
    """Divergence check on a fetched carry: every parameter and every
    metric and eval cell the rounds in ``rounds_done`` wrote is finite."""
    for _, leaf in _leaves(state["params"]):
        if not bool(torch.isfinite(leaf).all()):
            return False
    slots = np.unique([t % ring_alloc for t in rounds_done])
    for v in state["ring"].values():
        if v.is_floating_point() and not bool(
                torch.isfinite(v[slots]).all()):
            return False
    if do_eval:
        eslots = np.unique([t // eval_every for t in rounds_done
                            if t % eval_every == 0])
        for v in state["ebuf"].values():
            if eslots.size and v.is_floating_point() and not bool(
                    torch.isfinite(v[eslots]).all()):
                return False
    return True


def _run_checkpointed(loss_fn, params, store, cfg, rounds, *, strategy,
                      eval_fn, eval_every, ring_size, key, momentum,
                      round_fn, faults, fstate, cstate, zstate,
                      checkpoint_every, checkpoint_dir, resume,
                      max_segments, segment_callback, max_retries,
                      lr_backoff, tap=None, tracer=None,
                      ledger=None) -> ExperimentResult:
    """The durable segment loop of ``run_experiment(...,
    checkpoint_every=k)``:

    - **Bitwise**: segments run the global round indices into buffers
      sized for the whole run, so the chunked run writes the cells (and
      walks the key chain) of the single-shot run; the fault, channel and
      strategy carries ride the snapshot.
    - **Durable**: the round-0 anchor, then the whole carry after every
      segment (``checkpoint.save_run_state``); ``resume=True`` continues
      from the latest snapshot.
    - **Recovery**: a non-finite segment rolls back to the last snapshot,
      scales the lr by ``lr_backoff`` and retries, at most
      ``max_retries`` times, then ``DivergenceError``; each rollback
      appends a ``{"round", "event": "rollback", ...}`` row to the events
      (and the snapshot meta, so a resumed run keeps the log).
    """
    from repro_torch.checkpoint import checkpoint as ckpt

    strat = strategy
    if checkpoint_dir is None:
        raise ValueError("checkpoint_every > 0 requires checkpoint_dir")
    do_eval = eval_fn is not None and eval_every > 0
    ring_alloc = min(rounds, ring_size) if ring_size else rounds
    n_evals = (rounds + eval_every - 1) // eval_every if do_eval else 0
    orig_hash = ckpt.config_hash(cfg)
    device = estimator._device(params)
    like_parts = (params, momentum, fstate, cstate, zstate)

    ring, ebuf = {}, {}
    t, events, cur_lr = 0, [], cfg.lr
    if resume:
        snap = ckpt.latest_run_state(checkpoint_dir)
        if snap is not None:
            carry, meta = _restore(snap, like_parts, device)
            if meta.get("config_hash") not in (None, orig_hash):
                warnings.warn(
                    f"resuming from a snapshot of a DIFFERENT config "
                    f"(hash {meta.get('config_hash')} != {orig_hash}) — "
                    f"the continued trajectory will not match either run")
            t = int(meta["round"])
            events = list(meta.get("events", []))
            cur_lr = float(meta.get("lr", cfg.lr))
            params, momentum, key, fstate, cstate, zstate, ring, ebuf = carry

    def checkpoint_meta():
        return {"round": t, "rounds_total": rounds, "algo": strat.name,
                "strategy": strat.name, "config_hash": orig_hash,
                "lr": cur_lr, "events": events}

    def write_run_manifest():
        man = obs_manifest.build_manifest(
            cfg, strategy=strat.name, rounds=rounds,
            n_clients=store.n_clients, ledger=ledger, faults=faults,
            channel=cfg.channel_model, events=events,
            extra={"checkpoint_every": checkpoint_every, "lr": cur_lr,
                   "rounds_done": t,
                   "tap_every": tap.every if tap is not None else None})
        obs_manifest.write_manifest(checkpoint_dir, man)
        return man

    if t == 0:
        # the round-0 anchor: the rollback target of a first-segment
        # divergence
        ckpt.save_run_state(
            checkpoint_dir, _carry_to_state(params, momentum, key, fstate,
                                            cstate, zstate, ring, ebuf),
            round_idx=0, meta=checkpoint_meta())
    write_run_manifest()   # provisional: rewritten with the final events

    steps: dict = {}

    def round_step():
        if cur_lr not in steps:
            run_cfg = (cfg if cur_lr == cfg.lr
                       else dataclasses.replace(cfg, lr=cur_lr))
            steps[cur_lr] = make_round_step(loss_fn, run_cfg, strategy=strat,
                                            round_fn=round_fn, faults=faults)
        return steps[cur_lr]

    kw = dict(ring_alloc=ring_alloc, n_evals=n_evals, eval_fn=eval_fn,
              eval_every=eval_every, tap=tap)
    retries, segments_done = 0, 0
    with (tracer.profile() if tracer is not None else nullcontext()):
        if tracer is not None:
            _compile_span(tracer, params)
        while t < rounds:
            chunk = min(checkpoint_every, rounds - t)
            carry = (params, momentum, key, fstate, cstate, zstate)
            with (tracer.span("segment", t0=t, chunk=chunk)
                  if tracer is not None else nullcontext()):
                carry = _run_rounds(round_step(), carry, ring, ebuf, t,
                                    t + chunk, store, **kw)
                # the segment's one host sync: the whole carry to the host
                state = _carry_to_state(*carry, ring, ebuf)
            t_next = t + chunk
            if not _finite_state(state, range(t, t_next), ring_alloc,
                                 eval_every, do_eval):
                retries += 1
                if retries > max_retries:
                    raise DivergenceError(t_next, max_retries, cur_lr)
                cur_lr *= lr_backoff
                events.append({"round": t_next, "event": "rollback",
                               "from_round": t, "retry": retries,
                               "lr": cur_lr})
                (params, momentum, key, fstate, cstate, zstate, ring,
                 ebuf), _ = _restore(ckpt.latest_run_state(checkpoint_dir),
                                     like_parts, device)
                continue
            retries = 0
            params, momentum, key, fstate, cstate, zstate = carry
            t = t_next
            ckpt.save_run_state(checkpoint_dir, state, round_idx=t,
                                meta=checkpoint_meta())
            segments_done += 1
            if segment_callback is not None:
                segment_callback(t, rounds)
            if max_segments is not None and segments_done >= max_segments:
                break

    manifest = write_run_manifest()   # final: the whole event stream
    return ExperimentResult(
        params=params, momentum=momentum, key=key, metrics=ring, evals=ebuf,
        rounds=t, ring_size=ring_alloc,
        eval_rounds=np.arange(0, t, eval_every) if do_eval else np.arange(0),
        fault_state=fstate, channel_state=cstate, events=list(events),
        strategy=strat.name, strategy_state=zstate, ledger=ledger,
        manifest=manifest)


def history(result: ExperimentResult, *, start_round: int = 0) -> list:
    """``FedServer``-style per-round rows of an engine result: ``round``
    (offset by ``start_round``), the run's ``strategy`` name, the round's
    metrics and, on eval rounds, the evals, as Python floats. Eval rounds
    evicted from a small ring still surface as eval-only rows; event rows
    (rollbacks) interleave by round, before the round's retried row; then
    the ledger's byte (and energy) columns and, on a tiered run, each
    round's ``bucket_id`` and ``staged_bytes``."""
    mets = {k: v.cpu().tolist() for k, v in result.metrics.items()}
    evals = {k: v.cpu().tolist() for k, v in result.evals.items()}
    ev_by_round = {int(t): {k: float(v[i]) for k, v in evals.items()}
                   for i, t in enumerate(result.eval_rounds)}
    ring_start = max(0, result.rounds - result.ring_size)
    out = []
    for t in sorted(ev_by_round):
        if t < ring_start:                  # evicted from the ring
            out.append({"round": start_round + t,
                        "strategy": result.strategy, **ev_by_round[t]})
    for t in result.recorded_rounds():
        t = int(t)
        row = {"round": start_round + t, "strategy": result.strategy}
        slot = t % result.ring_size
        row.update({k: float(v[slot]) for k, v in mets.items()})
        row.update(ev_by_round.get(t, {}))
        out.append(row)
    if result.events:
        out.extend({**e, "round": start_round + int(e["round"])}
                   for e in result.events)
        out.sort(key=lambda r: (r["round"], "event" not in r))
    if result.ledger is not None:
        result.ledger.annotate(out, staging=result.staging,
                               start_round=start_round)
    return out
