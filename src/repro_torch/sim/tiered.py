"""Tiered client store: the population in host memory, the sampled cohort
streamed to the device.

Counterpart of ``repro/sim/tiered.py:1-752``. The resident ``ClientStore``
holds all N clients on the device, padded to the largest client: at the
paper's partial participation (M of N = 10⁵–10⁶ clients a round) that is
the whole device for data that a round reads M rows of. Here the
population stays on the host and only the in-flight cohorts reach the
device:

- ``HostStore``: all N clients in host numpy arrays (or memory-mapped
  ``.npy`` files), in K padding groups: clients are binned by row count at
  the size quantiles and each bucket is stacked at its own capacity.
- ``CohortStream``: replays the engine's per-round key chain on the host
  (``engine.split_round_keys`` and the ``sample_participants``
  permutation), so it knows round t's cohort before the device reaches
  round t. A fault run also advances the ``[N]`` availability chain
  (``FaultModel.advance``), a ``cfg.channel_model`` run the whole wireless
  chain (``ChannelModel.step``); only their ``[M]`` slices are staged.
- ``run_tiered_experiment``: the runner. One worker thread gathers the
  next segment's cohorts with numpy into one of two pinned host buffers
  and copies it to the card on a copy stream while the main thread runs
  the current segment (``engine.stream_core``, the resident round loop);
  checkpoints, divergence rollback, taps, spans, the ledger and the
  manifest as the resident runner has them.

Every value a round reads is derived as the resident round derives it, and
the host replica consumes exactly the key streams the round leaves
unconsumed, so a ``HostStore`` run is bitwise the ``ClientStore`` run of
the same config, also under faults, the channel, SCAFFOLD or FedDyn state,
chunking and kill-and-resume. The stateful strategies' ``[N]`` client
masters stay in host memory (CPU tensors); each round gathers the cohort's
rows to the device and scatters them back. Snapshots keep the resident
engine's npz leaf layout, so either tier resumes the other's snapshot, and
``save``/``load`` keep the reference's files (``hoststore.json``,
``bucketN__leaf.npy``), so a population saved by one package loads in the
other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import estimator
from repro_torch.core import strategy as strategy_mod
from repro_torch.obs import manifest as obs_manifest
from repro_torch.obs.ledger import CommsLedger
from repro_torch.obs.taps import RoundTap
from repro_torch.sim import channel as channel_lib
from repro_torch.sim import engine
from repro_torch.sim.faults import DivergenceError, FaultModel
from repro_torch.sim.store import (ClientStore, CohortBatch, build_store,
                                   client_sizes, sample_participants,
                                   stack_padded)
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_map, tree_zeros_like


# -- bucketed host population -------------------------------------------------

@dataclass
class Bucket:
    """One padding group: the clients whose row counts fall at or under
    this bucket's capacity (and over the previous bucket's), stacked
    ``[n_b, cap, ...]`` at the bucket's own capacity."""
    ids: np.ndarray   # [n_b] int64 global client ids, ascending
    cap: int          # padded row capacity of this bucket
    data: dict        # {leaf name: [n_b, cap, ...] host array (maybe mmap)}


def bucket_caps(sizes, n_buckets: int) -> list:
    """Bucket capacities: the population's size quantiles (``higher``, so
    every cap is a real client size and the last is the largest),
    deduplicated ascending. A uniform population is one bucket."""
    qs = np.quantile(np.asarray(sizes),
                     np.linspace(0.0, 1.0, int(n_buckets) + 1)[1:],
                     method="higher")
    return sorted({int(q) for q in qs})


@dataclass
class HostStore:
    """All N clients in host memory in K padding groups, with the index
    maps the stream needs: ``sizes`` ``[N]`` true row counts,
    ``bucket_of`` ``[N]`` bucket index, ``row_of`` ``[N]`` row within the
    bucket."""
    buckets: list
    sizes: np.ndarray
    bucket_of: np.ndarray
    row_of: np.ndarray

    @property
    def n_clients(self) -> int:
        return int(self.sizes.shape[0])

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def capacity(self) -> int:
        return max(b.cap for b in self.buckets)

    @property
    def names(self) -> list:
        """Leaf names in sorted order (the reference's leaf order)."""
        return sorted(self.buckets[0].data)

    @property
    def nbytes(self) -> int:
        """Host bytes of the bucketed population (data leaves only)."""
        return int(sum(l.nbytes for b in self.buckets
                       for l in b.data.values()))

    def client(self, i: int) -> dict:
        """Client i's unpadded rows (views: no copy off a memory map)."""
        b = self.buckets[int(self.bucket_of[i])]
        r, n = int(self.row_of[i]), int(self.sizes[i])
        return {k: l[r, :n] for k, l in b.data.items()}

    # -- staging -------------------------------------------------------------
    def stage(self, idx_rounds, *, alloc=None) -> tuple:
        """Gather a segment's cohorts: ``idx_rounds`` ``[S, M]`` client ids
        -> (data ``{name: [S, M, cap, ...]}``, sizes ``[S, M]`` int32,
        meta). ``cap`` is the largest bucket capacity present in the
        segment. ``alloc(name, shape, dtype)`` supplies each leaf's output
        array (the runner's pinned buffers); by default fresh arrays. The
        pad region is zero. ``meta``: the cap, each round's dominating
        ``bucket_ids`` ``[S]`` and the staged byte counts."""
        idx = np.asarray(idx_rounds, np.int64)
        s, m = idx.shape
        b_of = self.bucket_of[idx]                       # [S, M]
        rows = self.row_of[idx]                          # [S, M]
        present = np.unique(b_of)
        cap = max(self.buckets[int(b)].cap for b in present)
        sel = {int(b): np.nonzero(b_of == b) for b in present}
        out_leaves, nbytes = {}, 0
        for name in self.names:
            head = self.buckets[int(present[0])].data[name]
            shape = (s, m, cap) + head.shape[2:]
            out = (alloc(name, shape, head.dtype) if alloc is not None
                   else np.empty(shape, head.dtype))
            out.fill(0)
            for b, (i0, i1) in sel.items():
                bk = self.buckets[b]
                out[i0, i1, :bk.cap] = bk.data[name][rows[i0, i1]]
            nbytes += out.nbytes
            out_leaves[name] = out
        sizes = self.sizes[idx].astype(np.int32)
        nbytes += sizes.nbytes
        meta = {"cap": int(cap),
                "bucket_ids": b_of.max(axis=1),
                "bytes": int(nbytes),
                "round_bytes": int(nbytes // max(1, s))}
        return out_leaves, sizes, meta

    # -- tier conversion -----------------------------------------------------
    def to_resident(self, *, device="cuda") -> ClientStore:
        """The resident tier on ``device``: bitwise ``build_store`` over the
        same clients (each bucket's zero-padded rows land in a zeroed
        buffer at the global capacity)."""
        device = resolve_device(device)
        cap = int(self.sizes.max())
        n = self.n_clients
        data = {}
        for name in self.names:
            head = self.buckets[0].data[name]
            out = np.zeros((n, cap) + head.shape[2:], head.dtype)
            for b in self.buckets:
                out[b.ids, :b.cap] = b.data[name]
            data[name] = torch.from_numpy(out).to(device)
        return ClientStore(data=data,
                           sizes=torch.from_numpy(
                               self.sizes.astype(np.int32)))

    # -- durability ----------------------------------------------------------
    def save(self, path: str) -> str:
        """Persist the population in the reference's layout: one ``.npy``
        a bucket and leaf (``bucket{i}__{name}.npy``, what ``load(...,
        mmap=True)`` maps), the index arrays and ``hoststore.json``."""
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "sizes.npy"), self.sizes)
        np.save(os.path.join(path, "bucket_of.npy"), self.bucket_of)
        np.save(os.path.join(path, "row_of.npy"), self.row_of)
        names = self.names
        for bi, b in enumerate(self.buckets):
            np.save(os.path.join(path, f"bucket{bi}_ids.npy"), b.ids)
            for name in names:
                np.save(os.path.join(path, f"bucket{bi}__{name}.npy"),
                        np.asarray(b.data[name]))
        with open(os.path.join(path, "hoststore.json"), "w") as f:
            json.dump({"version": 1, "leaves": names,
                       "caps": [b.cap for b in self.buckets]}, f, indent=1)
        return path

    @classmethod
    def load(cls, path: str, *, mmap: bool = True) -> "HostStore":
        """Reopen a saved population. ``mmap=True`` maps every data leaf,
        so loading reads the index arrays only and ``stage()`` reads just
        the sampled rows off disk."""
        with open(os.path.join(path, "hoststore.json")) as f:
            man = json.load(f)
        nested = [n for n in man["leaves"] if "/" in n]
        if nested:
            raise ValueError(f"the port's client datasets are flat dicts; "
                             f"{path} holds nested leaves {nested}")
        mode = "r" if mmap else None
        buckets = []
        for bi, cap in enumerate(man["caps"]):
            ids = np.load(os.path.join(path, f"bucket{bi}_ids.npy"))
            data = {n: np.load(os.path.join(path, f"bucket{bi}__{n}.npy"),
                               mmap_mode=mode) for n in man["leaves"]}
            buckets.append(Bucket(ids=ids, cap=int(cap), data=data))
        return cls(buckets=buckets,
                   sizes=np.load(os.path.join(path, "sizes.npy")),
                   bucket_of=np.load(os.path.join(path, "bucket_of.npy")),
                   row_of=np.load(os.path.join(path, "row_of.npy")))


def build_host_store(clients, n_buckets: int = 4) -> HostStore:
    """Bucket a list of per-client dataset dicts into a ``HostStore``.
    Each client lands in the smallest bucket whose capacity covers its row
    count and keeps its rows exactly once; each bucket and leaf is one
    preallocated buffer (``stack_padded``)."""
    sizes = np.asarray(client_sizes(clients), np.int64)
    caps = bucket_caps(sizes, n_buckets)
    assign = np.searchsorted(caps, sizes, side="left")
    n = sizes.shape[0]
    bucket_of = np.zeros(n, np.int64)
    row_of = np.zeros(n, np.int64)
    buckets = []
    for ci, cap in enumerate(caps):
        ids = np.nonzero(assign == ci)[0]
        if ids.size == 0:      # deduplication can orphan a quantile
            continue
        bucket_of[ids] = len(buckets)
        row_of[ids] = np.arange(ids.size)
        data = {k: stack_padded([clients[int(i)][k] for i in ids], cap)
                for k in clients[0]}
        buckets.append(Bucket(ids=ids, cap=int(cap), data=data))
    return HostStore(buckets=buckets, sizes=sizes, bucket_of=bucket_of,
                     row_of=row_of)


def resolve_store(store, *, tier: str = "auto", device="cuda"):
    """The one seam through which drivers take either tier.
    ``tier="resident"`` returns a ``ClientStore`` (a ``HostStore``
    materializes on ``device`` through ``to_resident()``, bitwise
    ``build_store``); ``tier="host"`` builds or keeps the host tier;
    ``"auto"`` keeps the tier passed, and a list of client datasets builds
    the resident one."""
    if isinstance(store, ClientStore):
        return store
    if isinstance(store, HostStore):
        return (store.to_resident(device=device) if tier == "resident"
                else store)
    if isinstance(store, (list, tuple)):
        return (build_host_store(list(store)) if tier == "host"
                else build_store(list(store), device=device))
    raise TypeError(f"not a client store or client list: "
                    f"{type(store).__name__}")


# -- host key-chain replay ----------------------------------------------------

class CohortStream:
    """Host replica of the engine's per-round key chain. Each
    ``next_round()`` makes the round's split (``engine.split_round_keys``)
    and consumes the streams the cohort round leaves unconsumed:
    ``k_part`` draws the participants, the availability substream of
    ``k_fault`` advances the ``[N]`` fault chain, ``k_chanm`` advances the
    whole wireless chain (its ``step`` is pure in key, state and ids, so
    the replay is the round's own derivation). The stream's key stays in
    lockstep with the run's carry key, so staging can run any distance
    ahead of the device."""

    def __init__(self, store: HostStore, cfg: FedZOConfig, key, *,
                 faults: Optional[FaultModel] = None, fstate=None,
                 cstate=None):
        self.store, self.cfg = store, cfg
        self.key = key
        self.faults = faults
        self.fstate = fstate
        self.channel = cfg.channel_model
        self.cstate = cstate

    def next_round(self) -> tuple:
        """Advance one round: ``(idx [M] int64 numpy, avail [M] bool |
        None, chan_h [M] complex64 | None, chan_mask [M] bool | None)``,
        the last three CPU tensors."""
        impl = prng.resolve(self.cfg.prng_impl)
        self.key, k_part, _kb, _kz, _kc, k_fault, k_chanm = \
            engine.split_round_keys(self.key,
                                    faults=self.faults is not None,
                                    channel=self.channel is not None,
                                    impl=impl)
        idx = sample_participants(k_part, self.store.n_clients,
                                  self.cfg.n_participating, impl)
        avail = chan_h = chan_mask = None
        if self.faults is not None:
            k_avail = prng.split(k_fault, 3, impl)[0]
            self.fstate = self.faults.advance(k_avail, self.fstate, impl)
            avail = self.fstate[idx]
        if self.channel is not None:
            self.cstate, rchan = self.channel.step(
                k_chanm, self.cstate, idx, h_min=self.cfg.h_min,
                schedule=self.cfg.channel_schedule, impl=impl)
            chan_h, chan_mask = rchan.h, rchan.mask
        return idx.numpy(), avail, chan_h, chan_mask

    def plan(self, n: int) -> tuple:
        """Replay ``n`` rounds ahead: ``(idx [n, M], avail [n, M] | None,
        chan_h [n, M] | None, chan_mask [n, M] | None)``."""
        drawn = [self.next_round() for _ in range(n)]
        idx = np.stack([d[0] for d in drawn])

        def stack(j):
            return (torch.stack([d[j] for d in drawn])
                    if drawn[0][j] is not None else None)

        return idx, stack(1), stack(2), stack(3)


class _Ready:
    """Future-shaped wrapper for the prefetch-off path."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class _Stager:
    """Moves staged segments to the run's device.

    On a card: two pinned host buffers per leaf, used in turn. A segment is
    gathered with numpy into one of them, copied to the card with
    ``non_blocking`` on a dedicated copy stream, and an event is recorded
    after the copy; a buffer is refilled only after the event of the copy
    out of it has completed. The consumer makes the compute stream wait on
    the event (no host wait) and records the compute stream on the staged
    tensors, so the caching allocator keeps them until the segment's
    kernels are done. A failure to pin or copy raises. On the CPU the
    stage is a plain gather into fresh arrays."""

    def __init__(self, store: HostStore, device: torch.device):
        self.store, self.device = store, device
        self.cuda = device.type == "cuda"
        self.stage_s = 0.0
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device=device)
            self.slots = [{"bufs": {}, "views": {}, "done": None}
                          for _ in range(2)]
            self.turn = 0

    @staticmethod
    def _pinned(slot):
        """``HostStore.stage``'s ``alloc`` over one slot's pinned buffers
        (grown when a segment needs more); the torch views are kept for
        the copy."""
        def alloc(name, shape, dtype):
            numel = int(np.prod(shape))
            buf = slot["bufs"].get(name)
            if buf is None or buf.numel() < numel:
                buf = torch.empty(
                    numel, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                    pin_memory=True)
                slot["bufs"][name] = buf
            view = buf[:numel].view(shape)
            slot["views"][name] = view
            return view.numpy()
        return alloc

    def stage(self, idx, avail, chan_h, chan_mask) -> tuple:
        """(CohortBatch with ``[S, ...]`` fields, staging meta, the copy's
        event or None). Runs on the worker thread when prefetching."""
        t0 = time.perf_counter()
        if not self.cuda:
            data, sizes, meta = self.store.stage(idx)
            dev = {k: torch.from_numpy(v) for k, v in data.items()}
            ev = None
        else:
            slot = self.slots[self.turn]
            self.turn ^= 1
            if slot["done"] is not None:
                slot["done"].synchronize()
            data, sizes, meta = self.store.stage(idx,
                                                 alloc=self._pinned(slot))
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.copy_stream):
                dev = {k: slot["views"][k].to(self.device,
                                              non_blocking=True)
                       for k in data}
                ev = torch.cuda.Event()
                ev.record(self.copy_stream)
            slot["done"] = ev
        self.stage_s += time.perf_counter() - t0
        xb = CohortBatch(data=dev, sizes=torch.from_numpy(sizes),
                         avail=avail, chan_h=chan_h, chan_mask=chan_mask)
        return xb, meta, ev

    def ready(self, xb: CohortBatch, ev) -> None:
        """Order the compute stream after the segment's copy."""
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for v in xb.data.values():
                v.record_stream(cur)


# -- the tiered experiment runner ---------------------------------------------

def run_tiered_experiment(loss_fn, params, store: HostStore,
                          cfg: FedZOConfig, rounds: int, *,
                          algo: Optional[str] = None, strategy=None,
                          eval_fn=None, eval_every: int = 0,
                          ring_size: int = 0, key=None, momentum=None,
                          round_fn=None,
                          faults: Optional[FaultModel] = None,
                          checkpoint_every: int = 0, checkpoint_dir=None,
                          resume: bool = False, max_segments=None,
                          segment_callback=None, max_retries: int = 3,
                          lr_backoff: float = 0.5, sink=None,
                          tap_every: Optional[int] = None, tracer=None,
                          stream_segment: int = 8,
                          prefetch: bool = True) -> engine.ExperimentResult:
    """``run_experiment`` over a host-resident population: the resident
    runner's contract and, bitwise, its trajectory on the equivalent
    ``ClientStore`` (checkpoints, divergence rollback with lr backoff,
    taps, tracer spans, the ledger and the manifest included), with only
    the in-flight segment's cohorts and one prefetched segment on the
    device (``params`` fixes the device).

    - The ``CohortStream`` plans ``stream_segment`` rounds ahead on the
      main thread; one worker thread stages the next segment while the
      main thread runs the current one (``prefetch=False`` stages in line,
      for measurement).
    - Stateful strategies force ``stream_segment=1``: their ``[N]`` client
      master is read and written every round. The fault chain needs no
      clamp: the stream replays it forward.
    - ``result.staging`` holds each round's dominating bucket id and
      staged bytes (merged into ``history()`` rows); ``result.prefetch``
      the stall accounting: ``stall_s`` (the main loop blocked on the
      staging future, the cold first segment excluded), ``stall_pct`` (of
      the wall time), ``stage_s`` (staging's own seconds, on the worker
      when prefetching), ``staged_bytes``, ``host_bytes`` and
      ``device_segment_bytes_max``.
    """
    from repro_torch.checkpoint import checkpoint as ckpt

    strat = strategy_mod.resolve(strategy, algo, cfg)
    strat.validate(cfg)
    device = estimator._device(params)
    if key is None:
        key = engine.experiment_key(cfg)
    if momentum is None and strat.has_momentum(cfg):
        momentum = tree_zeros_like(params)
    n_clients = store.n_clients
    do_eval = eval_fn is not None and eval_every > 0
    tap = None
    if tap_every is not None:
        if sink is None:
            raise ValueError("tap_every=k needs a sink= to stream into")
        tap = RoundTap(sink, tap_every)
    channel = cfg.channel_model
    ledger = CommsLedger.from_run(cfg, params, channel=channel)
    if checkpoint_every > 0 and checkpoint_dir is None:
        raise ValueError("checkpoint_every > 0 requires checkpoint_dir")

    # the host-resident [N] halves of the carry
    fstate = faults.init_state(n_clients) if faults is not None else None
    impl = prng.resolve(cfg.prng_impl)
    cstate = (channel.init_state(n_clients, channel_lib.init_key(key, impl),
                                 impl)
              if channel is not None else None)
    z_template = strat.init_state(params, cfg, 1)
    stateful = z_template is not None
    if stateful:
        client_master = tree_map(
            lambda l: torch.zeros((n_clients,) + tuple(l.shape[1:]),
                                  dtype=l.dtype), z_template["client"])
        z_server = z_template["server"]
        seg_len = 1
    else:
        client_master, z_server = None, None
        seg_len = max(1, int(stream_segment))

    ring_alloc = min(rounds, ring_size) if ring_size else rounds
    ring, ebuf = {}, {}
    t, events, cur_lr = 0, [], cfg.lr
    orig_hash = ckpt.config_hash(cfg)

    def zstate():
        return ({"client": client_master, "server": z_server}
                if stateful else None)

    def pack_state():
        # the resident engine's leaf layout: the host halves fill the
        # fstate/cstate/zstate keys, so the tiers' snapshots interchange
        return engine._carry_to_state(params, momentum, key, fstate, cstate,
                                      zstate(), ring, ebuf)

    def restore(snap):
        carry, meta = engine._restore(
            snap, (params, momentum, fstate, cstate, zstate()), device)
        return _unpack_state(carry, stateful), meta

    if checkpoint_every > 0 and resume:
        snap = ckpt.latest_run_state(checkpoint_dir)
        if snap is not None:
            carry, meta = restore(snap)
            if meta.get("config_hash") not in (None, orig_hash):
                warnings.warn(
                    f"resuming from a snapshot of a DIFFERENT config "
                    f"(hash {meta.get('config_hash')} != {orig_hash}) — "
                    f"the continued trajectory will not match either run")
            t = int(meta["round"])
            events = list(meta.get("events", []))
            cur_lr = float(meta.get("lr", cfg.lr))
            (params, momentum, key, fstate, cstate, client_master, z_server,
             ring, ebuf) = carry

    stream = CohortStream(store, cfg, key, faults=faults, fstate=fstate,
                          cstate=cstate)

    def checkpoint_meta():
        return {"round": t, "rounds_total": rounds, "algo": strat.name,
                "strategy": strat.name, "config_hash": orig_hash,
                "lr": cur_lr, "events": events}

    def tiered_block():
        return obs_manifest.tiered_block(store, stream_segment=seg_len,
                                         prefetch=prefetch)

    def write_run_manifest():
        man = obs_manifest.build_manifest(
            cfg, strategy=strat.name, rounds=rounds, n_clients=n_clients,
            ledger=ledger, faults=faults, channel=channel, events=events,
            extra={"checkpoint_every": checkpoint_every, "lr": cur_lr,
                   "rounds_done": t,
                   "tap_every": tap.every if tap is not None else None,
                   **tiered_block()})
        obs_manifest.write_manifest(checkpoint_dir, man)
        return man

    if checkpoint_every > 0:
        if t == 0:
            ckpt.save_run_state(checkpoint_dir, pack_state(), round_idx=0,
                                meta=checkpoint_meta())
        write_run_manifest()

    stager = _Stager(store, device)
    pool = ThreadPoolExecutor(max_workers=1) if prefetch else None

    def submit(start):
        end = min(start + seg_len, rounds)
        if checkpoint_every > 0:
            end = min(end,
                      (start // checkpoint_every + 1) * checkpoint_every)
        plan = stream.plan(end - start)
        fut = (pool.submit(stager.stage, *plan) if pool is not None
               else _Ready(stager.stage(*plan)))
        # the chains as of round `end`: the stream's race ahead with the
        # prefetch, a snapshot must not
        return fut, plan[0], end, stream.fstate, stream.cstate

    staging_rows: dict = {}
    stats = {"stall_s": 0.0, "wall_s": 0.0, "stall_pct": 0.0,
             "stage_s": 0.0, "staged_bytes": 0, "host_bytes": store.nbytes,
             "device_segment_bytes_max": 0, "stream_segment": seg_len,
             "n_buckets": store.n_buckets}
    retries, segments_done, last_ckpt = 0, 0, t
    cold = True
    wall0 = time.perf_counter()
    try:
        with (tracer.profile() if tracer is not None else nullcontext()):
            if tracer is not None:
                engine._compile_span(tracer, params)
            pending = submit(t) if t < rounds else None
            while t < rounds:
                fut, idx, end, seg_fstate, seg_cstate = pending
                w0 = time.perf_counter()
                xs, smeta, ev = fut.result()
                waited = time.perf_counter() - w0
                if cold:
                    cold = False    # nothing to overlap the first wait with
                else:
                    stats["stall_s"] += waited
                # a segment that ends the call (max_segments) prefetches
                # nothing: its plan would be replayed again on resume
                last = (checkpoint_every > 0 and max_segments is not None
                        and segments_done + 1 >= max_segments
                        and (end % checkpoint_every == 0 or end >= rounds))
                if end < rounds and not last:
                    pending = submit(end)
                stager.ready(xs, ev)
                seg = end - t
                zc = None
                if stateful:
                    rows = torch.from_numpy(idx[0])
                    zc = {"client": tree_map(lambda a: a[rows].to(device),
                                             client_master),
                          "server": z_server}
                run_cfg = (cfg if cur_lr == cfg.lr
                           else dataclasses.replace(cfg, lr=cur_lr))
                with (tracer.span("tiered_segment", t0=t, chunk=seg,
                                  bucket_cap=smeta["cap"])
                      if tracer is not None else nullcontext()):
                    params, momentum, key, zc_out, ring, ebuf = \
                        engine.stream_core(
                            loss_fn, params, run_cfg, key, momentum,
                            strategy=strat, zstate=zc, xs=xs, t0=t,
                            total_rounds=rounds, ring=ring, ebuf=ebuf,
                            eval_fn=eval_fn, eval_every=eval_every,
                            ring_size=ring_size, round_fn=round_fn,
                            faults=faults, tap=tap)
                fstate, cstate = seg_fstate, seg_cstate
                if stateful:
                    tree_map(lambda a, v: a.index_copy_(0, rows, v.cpu()),
                             client_master, zc_out["client"])
                    z_server = zc_out["server"]
                for j in range(seg):
                    staging_rows[t + j] = {
                        "bucket_id": int(smeta["bucket_ids"][j]),
                        "staged_bytes": int(smeta["round_bytes"])}
                stats["staged_bytes"] += int(smeta["bytes"])
                stats["device_segment_bytes_max"] = max(
                    stats["device_segment_bytes_max"], int(smeta["bytes"]))
                t = end
                if checkpoint_every > 0 and \
                        (t % checkpoint_every == 0 or t >= rounds):
                    state = pack_state()    # the segment's one host sync
                    if not engine._finite_state(state, range(last_ckpt, t),
                                                ring_alloc, eval_every,
                                                do_eval):
                        retries += 1
                        if retries > max_retries:
                            raise DivergenceError(t, max_retries, cur_lr)
                        cur_lr *= lr_backoff
                        events.append({"round": t, "event": "rollback",
                                       "from_round": last_ckpt,
                                       "retry": retries, "lr": cur_lr})
                        (params, momentum, key, fstate, cstate,
                         client_master, z_server, ring, ebuf), gm = \
                            restore(ckpt.latest_run_state(checkpoint_dir))
                        t = int(gm["round"])
                        last_ckpt = t
                        stream = CohortStream(store, cfg, key,
                                              faults=faults, fstate=fstate,
                                              cstate=cstate)
                        pending = submit(t)
                        cold = True
                        continue
                    retries = 0
                    ckpt.save_run_state(checkpoint_dir, state, round_idx=t,
                                        meta=checkpoint_meta())
                    last_ckpt = t
                    segments_done += 1
                    if segment_callback is not None:
                        segment_callback(t, rounds)
                    if max_segments is not None and \
                            segments_done >= max_segments:
                        break
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - wall0
    stats["wall_s"] = wall
    stats["stage_s"] = stager.stage_s
    stats["stall_pct"] = 100.0 * stats["stall_s"] / wall if wall > 0 else 0.0

    manifest = write_run_manifest() if checkpoint_every > 0 else None
    result = engine.ExperimentResult(
        params=params, momentum=momentum, key=key, metrics=ring,
        evals=ebuf, rounds=t, ring_size=ring_alloc,
        eval_rounds=(np.arange(0, t, eval_every) if do_eval
                     else np.arange(0)),
        fault_state=fstate, channel_state=cstate, events=list(events),
        strategy=strat.name, strategy_state=zstate(), ledger=ledger,
        manifest=manifest, staging=staging_rows, prefetch=stats)
    sink_path = getattr(sink, "path", None)
    if sink_path:
        result.manifest = obs_manifest.build_manifest(
            cfg, strategy=strat.name, rounds=rounds, n_clients=n_clients,
            ledger=ledger, faults=faults, channel=channel,
            events=result.events,
            extra={**({"tap_every": tap.every} if tap is not None else {}),
                   **tiered_block()})
        obs_manifest.write_manifest(f"{sink_path}.manifest.json",
                                    result.manifest)
    return result


def _unpack_state(carry: tuple, stateful: bool) -> tuple:
    """Split a restored carry ``(params, momentum, key, fstate, cstate,
    zstate, ring, ebuf)`` into the tiered one: the ``[N]`` client master
    (host tensors, written in place every round) apart from the server
    state."""
    params, momentum, key, fstate, cstate, zstate, ring, ebuf = carry
    client_master = zstate["client"] if stateful else None
    z_server = zstate["server"] if stateful else None
    return (params, momentum, key, fstate, cstate, client_master, z_server,
            ring, ebuf)
