"""One run of one cell: set-up, the measured window, the trace, the check.

**The timed path.** Each round is ``repro_torch.core.fedzo.
round_simulated(loss, params, batches, keys, cfg, channel_rng=...)`` on
the flat-buffer route with the sphere estimator, the cohort's forwards
through the model's client-batched loss; the server weights carry over
from round to round.

**Set-up** (``setup_s``, from process start): torch and the card, the
model's functions, the weights, every round's tokens and keys, and round
0, which warms every shape the window uses (and loads the kernels, built
on the first run in a checkout). Round 0 is also the round the check
follows: the loss the round is handed notes what each cohort forward
returned and the point it was evaluated at, at the check's sample of
indices, and after the round the harness reads the parameters' change
per leaf and at that sample.

**The window** runs whole rounds from round 1 until ``seconds`` have
passed, and ends at the end of the last round, after ``synchronize()``:
``round_ms`` is its length over its rounds. With ``trace`` the window runs
under ``torch.profiler`` and the per-layer metrics are read from it.

**The check** runs after the window, once the peak memory has been read
and the program's state freed (``check.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch

from fedbench import inputs
from fedbench import devtrace as ftrace
from fedbench.reference import threefry


@dataclasses.dataclass
class Record:
    """What the program produced in the rounds the check follows."""
    losses: object = None        # float64 [H·(b2 + 1), M]: round 0's forwards
    points: object = None        # [H·(b2 + 1), M, K]: their points sampled
                                 # (on the host)
    next_base: object = None     # [M]: round 1's first forward
    change_norms: list = None    # ‖x1 − x0‖ per leaf
    change_sample: object = None  # (x1 − x0) at the sample, float64


class RecordingLoss:
    """The model's loss as the round queries it. While ``calls`` is a
    list, each cohort forward's ``[M]`` losses are appended to it, and
    while ``points`` is one, the point the forward read, sampled."""

    def __init__(self, model, gather):
        self.model = model
        self.gather = gather
        self.calls = None
        self.points = None

    def __call__(self, params, batch):
        return self.model.loss(params, batch)

    def batched(self, params, batch):
        out = self.model.loss_batched(params, batch)
        if self.calls is not None:
            if self.points is not None:
                # to the host at once: the record adds nothing to the peak
                self.points.append(self.gather(params).cpu())
            self.calls.append(out)
        return out

    def start(self, points=False):
        self.calls, self.points = [], ([] if points else None)

    def stop(self):
        self.calls = self.points = None


def sampler(shapes, idx):
    """``gather(tree)``: the leaves' elements at the sorted flat indices
    ``idx``, ``[..., K]`` (leading dimensions of the leaves kept)."""
    picks, off = [], 0
    for path, shape in shapes:
        n = math.prod(shape)
        sel = idx[(idx >= off) & (idx < off + n)] - off
        picks.append(sel)
        off += n

    def gather(tree):
        parts = []
        for (path, leaf), sel, (_, shape) in zip(inputs.leaves(tree), picks,
                                                 shapes):
            lead = leaf.shape[:leaf.dim() - len(shape)]
            parts.append(leaf.reshape(lead + (-1,))[..., sel])
        return torch.cat(parts, dim=-1)

    return gather


def model_config(cfg):
    from repro_torch.configs.base import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def fed_config(traffic):
    from repro_torch.configs.base import FedZOConfig
    M = traffic["clients"]
    air = traffic["aggregation"] == "aircomp"
    return FedZOConfig(
        n_devices=M, n_participating=M, local_iters=traffic["local_iters"],
        lr=traffic["lr"], mu=traffic["mu"], b1=traffic["rows"],
        b2=traffic["directions"], estimator="sphere",
        flat_params=True, aircomp=air,
        snr_db=traffic.get("snr_db", 0.0), h_min=traffic.get("h_min", 0.8),
        channel_schedule=traffic.get("channel_schedule", False))


def check_layout(model, shapes):
    """The program's parameter tree must be the layout the benchmark
    draws and the reference reads."""
    from repro_torch.utils.flatparams import flat_spec
    spec = flat_spec(model.param_specs())
    got = [(tuple(p), tuple(s)) for p, s in zip(spec.paths, spec.shapes)]
    if got != [(tuple(p), tuple(s)) for p, s in shapes]:
        raise ValueError("the program's parameter layout is not the "
                         "configuration's: " + str(got[:4]))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _leaf_change_norms(new, old):
    return [math.sqrt(threefry.sq_norm((a - b).reshape(-1)))
            for (_, a), (_, b) in zip(inputs.leaves(new), inputs.leaves(old))]


@dataclasses.dataclass
class Outcome:
    setup_s: float
    setup_parts: dict            # seconds of each set-up step
    window_s: float
    rounds: int
    failed: int
    peak_bytes: int
    record: Record
    window: object = None        # devtrace.Window of a traced run
    breakdown: dict = None
    held: dict = None            # what the check needs of the inputs


def run(cell, seed, seconds, trace, *, device="cuda", t0=None,
        round_fn=None):
    """Set-up, window and (with ``trace``) the profile of one run."""
    from repro_torch.core import fedzo
    from repro_torch.models import api
    t0 = time.perf_counter() if t0 is None else t0
    round_fn = round_fn or fedzo.round_simulated
    fam, cfg, tr = cell.family, cell.cfg, cell.traffic
    fam.set_tf32(False)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    parts = {"start": time.perf_counter() - t0}

    def mark(name):
        _sync(device)
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    model = api.build(model_config(cfg))
    w = inputs.Weights(fam, cfg, seed, device)
    check_layout(model, w.shapes)
    mark("weights")
    tokens, labels = inputs.token_pool(tr, cfg["vocab"], seed, device)
    ckeys, chkeys = inputs.key_pool(tr, seed)
    idx = inputs.sample_index(w.d, seed).to(device)
    mark("tokens_keys")
    fcfg = fed_config(tr)
    air = tr["aggregation"] == "aircomp"
    pool = inputs.ROUNDS_POOL
    gather = sampler(w.shapes, idx)
    loss = RecordingLoss(model, gather)

    def call(params, r):
        i = r % pool
        return round_fn(loss, params,
                        {"tokens": tokens[i], "labels": labels[i]},
                        ckeys[i], fcfg,
                        channel_rng=chkeys[i] if air else None)

    loss.start(points=True)
    new, _ = call(w.tree, 0)
    mark("round0")
    rec = Record(losses=torch.stack(loss.calls).double().cpu(),
                 points=torch.stack(loss.points),
                 change_norms=_leaf_change_norms(new, w.tree),
                 change_sample=(gather(new) - gather(w.tree)).double())
    loss.start()
    params = new
    del w, new
    mark("record")
    setup_s = time.perf_counter() - t0

    prof = ftrace.profiler() if trace else contextlib.nullcontext()
    mets = []
    with prof:
        with torch.profiler.record_function(ftrace.WINDOW_SPAN):
            _sync(device)
            start = time.perf_counter()
            r = 1
            while True:
                with torch.profiler.record_function("fedbench.round"):
                    params, met = call(params, r)
                mets.append(met["mean_local_loss"])
                if r == 1:
                    rec.next_base = loss.calls[0]
                    loss.stop()
                r += 1
                if time.perf_counter() - start >= seconds:
                    break
            _sync(device)
            window_s = time.perf_counter() - start
    rounds = r - 1
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int((~torch.isfinite(torch.stack(mets))).sum())
    rec.next_base = rec.next_base.double().cpu()
    held = {"batches": [(tokens[0].clone(), labels[0].clone()),
                        (tokens[1].clone(), labels[1].clone())],
            "client_keys": ckeys[0].clone(), "channel_key": chkeys[0].clone(),
            "idx": idx}
    del params, met, mets, tokens, labels
    out = Outcome(setup_s=setup_s, setup_parts=parts, window_s=window_s,
                  rounds=rounds, failed=failed, peak_bytes=peak, record=rec,
                  held=held)
    if trace:
        out.window, out.breakdown = ftrace.reduce(prof, window_s, rounds,
                                                  fam, cfg, tr)
        del prof
    if cuda:
        torch.cuda.empty_cache()
    return out
