"""The port's observability layer (``obs/sinks.py``, ``taps.py``,
``trace.py``, ``manifest.py``, the ledger's ring-limited rows) and the
engine's use of it, beside the reference.

Bitwise in the port: a tapped run's parameters, key and metrics equal the
untapped run's, the streamed rows equal ``history()``'s, a ring-limited
run's rows its full run's. The manifest carries the reference's key set,
with ``torch_version`` and ``cuda_version`` where the reference writes
``jax_version``. Sizes: softmax 24×4 on 6 clients, M = 3, H = 2, b1 = 8,
b2 = 4.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import obs as jobs
from repro.configs.base import FedZOConfig as JConfig
from repro.sim import faults as jfaults
from repro.workloads import neural as jneural
from repro_torch import obs
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import FedZOConfig
from repro_torch.fed.server import FedServer
from repro_torch.sim import engine as tengine
from repro_torch.sim.faults import FaultModel
from repro_torch.sim.sweep import run_sweep, scenario_grid
from repro_torch.workloads import neural as tneural

TASK = dict(n_train=320, n_test=96, n_clients=6, n_features=24, n_classes=4,
            alpha=0.5)
BASE = dict(n_devices=6, n_participating=3, local_iters=2, b1=8, b2=4,
            lr=5e-2, mu=1e-3, seed=11, flat_params=True, flat_block_rows=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the port's CPU path is many small ops, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def task():
    tt = tneural.make_task("softmax", device="cpu", **TASK)
    return tt, tneural.params_init(tt, 11)


def _run(task, rounds, **kw):
    tt, p0 = task
    return tengine.run_experiment(tt.loss, p0, tt.store, FedZOConfig(**BASE),
                                  rounds, **kw)


def _bitequal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# sinks


def test_jsonl_sink_roundtrip(tmp_path):
    """Rows written to a ``JsonlSink`` read back equal, one JSON object a
    line; the reference's reader reads the port's file."""
    path = os.path.join(tmp_path, "rows.jsonl")
    rows = [{"round": 0, "loss": 1.5, "ok": True},
            {"round": 1, "loss": float(np.float32(0.1)), "ok": False}]
    with obs.JsonlSink(path) as sink:
        for r in rows:
            sink.write(r)
    assert obs.read_jsonl(path) == rows == jobs.read_jsonl(path)
    with open(path) as f:
        for line in f:
            json.loads(line)


def test_memory_null_multi_csv_sinks(tmp_path):
    """A ``MultiSink`` fans rows out to a memory, a null and a CSV sink;
    the CSV's header is the first row's keys, as the reference's."""
    mem, null = obs.MemorySink(), obs.NullSink()
    paths = [os.path.join(tmp_path, f"{p}.csv") for p in ("t", "j")]
    multi = obs.MultiSink(mem, null, obs.CsvSink(paths[0]))
    jcsv = jobs.CsvSink(paths[1])
    for r in ({"round": 0, "loss": 2.0}, {"round": 1, "loss": 0.1}):
        multi.write(r)
        jcsv.write(r)
    multi.close()
    jcsv.close()
    assert [r["round"] for r in mem.rows] == [0, 1] and null.count == 2
    assert open(paths[0]).read() == open(paths[1]).read()


# ---------------------------------------------------------------------------
# taps


def test_taps_do_not_perturb_and_rows_match_history(task, tmp_path):
    """``tap_every=2`` over 8 rounds: parameters, key and metrics bitwise
    the untapped run's; the streamed rows are rounds 0, 2, 4, 6 and equal
    ``history()``'s values; the manifest beside the file carries the
    config hash and the cadence."""
    base = _run(task, 8)
    path = os.path.join(tmp_path, "live.jsonl")
    sink = obs.JsonlSink(path)
    tapped = _run(task, 8, sink=sink, tap_every=2)
    sink.close()
    _bitequal(base.params, tapped.params)
    _bitequal(base.metrics, tapped.metrics)
    assert torch.equal(base.key, tapped.key)
    rows = obs.read_jsonl(path)
    assert [r["round"] for r in rows] == [0, 2, 4, 6]
    hist = {r["round"]: r for r in tengine.history(tapped)}
    for row in rows:
        for k, v in row.items():
            assert v == hist[row["round"]][k], k
    man = obs.read_manifest(f"{path}.manifest.json")
    assert man["config_hash"] == ckpt.config_hash(FedZOConfig(**BASE))
    assert man["tap_every"] == 2 and man["comms"]["mode"] == "dense"


def test_tap_requires_sink(task):
    """``tap_every`` without a sink and a cadence below 1 raise the
    reference's ValueErrors."""
    with pytest.raises(ValueError, match="sink"):
        _run(task, 2, tap_every=1)
    with pytest.raises(ValueError, match="tap_every"):
        obs.RoundTap(obs.NullSink(), 0)


def test_ring_limited_rows_equal_full_rows(task):
    """A ring of 3 over 8 rounds keeps rounds 5–7, whose rows (ledger
    columns included) equal the full run's; evicted eval rounds stay as
    eval-only rows."""
    tt, _ = task
    ev = dict(eval_fn=tneural.task_eval(tt, 96), eval_every=2)
    full = _run(task, 8, **ev)
    ringed = _run(task, 8, ring_size=3, **ev)
    assert ringed.ring_size == 3
    assert ringed.recorded_rounds().tolist() == [5, 6, 7]
    h_full = {r["round"]: r for r in full.history()}
    rows = ringed.history()
    assert [r["round"] for r in rows] == [0, 2, 4, 5, 6, 7]
    for row in rows:
        want = h_full[row["round"]]
        assert row == (want if "mean_local_loss" in row else {
            k: want[k] for k in row})


# ---------------------------------------------------------------------------
# spans


def test_spans_nest():
    """Depth, parent, totals and the report's ``k=v`` meta."""
    tr = obs.Tracer()
    with tr.span("outer"):
        with tr.span("inner", tag=1):
            pass
        with tr.span("inner2"):
            pass
    outer, inner, inner2 = tr.spans
    assert (outer.depth, inner.depth, inner2.depth) == (0, 1, 1)
    assert inner.parent == 0 and inner2.parent == 0
    assert outer.duration >= inner.duration
    assert tr.totals()["inner"]["count"] == 1
    assert "tag=1" in tr.report() and tr.total("inner2") >= 0.0


def test_compile_once_execute_and_segment_spans(task, tmp_path):
    """Two traced runs record one ``compile`` span (the kernels' one-time
    build) and two ``execute`` spans, bitwise the untraced run; a
    checkpointed run records a ``segment`` span per segment at the
    global round indices, its manifest's config hash equals the
    snapshot sidecar's, and a ``profile_dir`` leaves a torch.profiler
    trace."""
    tr = obs.Tracer()
    r1 = _run(task, 3, tracer=tr)
    r2 = _run(task, 3, tracer=tr)
    assert len(tr.named("compile")) == 1 and len(tr.named("execute")) == 2
    assert tr.named("compile")[0].duration > 0
    _bitequal(r1.params, r2.params)
    _bitequal(_run(task, 3).params, r1.params)
    tr = obs.Tracer(profile_dir=str(tmp_path / "prof"))
    ck = str(tmp_path / "ck")
    res = _run(task, 4, tracer=tr, checkpoint_every=2, checkpoint_dir=ck)
    assert [s.meta["t0"] for s in tr.named("segment")] == [0, 2]
    assert len(tr.named("compile")) == 1
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    man = obs.read_manifest(ck)
    assert man["config_hash"] == ckpt.read_sidecar(
        ckpt.latest_run_state(ck))["config_hash"]
    assert man["rounds_done"] == 4 == res.manifest["rounds_done"]


def test_sweep_tracer_one_execute_per_static_group(task):
    """A sweep over two static groups records one compile span and one
    execute span per group."""
    tt, p0 = task
    tr = obs.Tracer()
    recs = run_sweep(tt.loss, p0, tt.store, FedZOConfig(**BASE),
                     scenario_grid(local_iters=(1, 2), lr=(1e-2, 5e-3)), 2,
                     tracer=tr)
    assert len(recs) == 4
    assert len(tr.named("compile")) == 1 and len(tr.named("execute")) == 2


# ---------------------------------------------------------------------------
# manifest and FedServer


def test_manifest_keys_and_roundtrip(task, tmp_path):
    """``build_manifest`` has the reference's keys (torch and CUDA
    versions in place of jax's), the same config hash, fault and ledger
    blocks, and round-trips through ``write_manifest``."""
    tt, p0 = task
    jt = jneural.make_task("softmax", **TASK)
    kw = dict(strategy="fedzo", rounds=5, n_clients=6,
              events=[{"round": 2, "event": "rollback"}])
    jman = jobs.build_manifest(
        JConfig(**BASE), ledger=jobs.CommsLedger.from_run(
            JConfig(**BASE), jax.device_get(jneural.params_init(jt, 11))),
        faults=jfaults.FaultModel(p_fail=0.1, p_recover=0.5), **kw)
    man = obs.build_manifest(
        FedZOConfig(**BASE), ledger=obs.CommsLedger.from_run(
            FedZOConfig(**BASE), p0),
        faults=FaultModel(p_fail=0.1, p_recover=0.5), **kw)
    assert set(man) == (set(jman) - {"jax_version"}) | {"torch_version",
                                                        "cuda_version"}
    assert set(man["topology"]) == set(jman["topology"])
    for k in ("config_hash", "config", "faults", "comms", "events",
              "strategy", "rounds", "n_clients"):
        assert json.loads(json.dumps(man[k], default=str)) == \
            json.loads(json.dumps(jman[k], default=str)), k
    back = obs.read_manifest(obs.write_manifest(str(tmp_path), man))
    assert back["faults"]["stationary_up"] == pytest.approx(0.5 / 0.6)
    assert back["events"][0]["event"] == "rollback" and "git_sha" in back


def test_fedserver_with_a_tracer(task):
    """``FedServer(tracer=...)``: the engine driver records one compile
    and one execute span and matches the host-driven rounds' rows; the
    host driver records an ``eval`` span per round."""
    tt, p0 = task
    cfg = FedZOConfig(**BASE)
    host = FedServer(tt.loss, p0, tt.clients, cfg, store=tt.store)
    for t in range(2):
        host.run_round(t)
    tr = obs.Tracer()
    scanned = FedServer(tt.loss, p0, tt.clients, cfg, store=tt.store,
                        tracer=tr)
    scanned.run(2)
    assert len(tr.named("compile")) == 1 and len(tr.named("execute")) == 1
    for hrow, srow in zip(host.history, scanned.history):
        assert hrow["round"] == srow["round"] and hrow["round_ms"] > 0
        assert hrow["mean_local_loss"] == srow["mean_local_loss"]
    tr = obs.Tracer()
    ev = tneural.task_eval(tt, 96)
    srv = FedServer(tt.loss, p0, tt.clients, cfg, store=tt.store,
                    tracer=tr, eval_fn=lambda p: {
                        k: float(v) for k, v in ev(p).items()})
    srv.run(2, driver="host")
    assert [s.meta["round"] for s in tr.named("eval")] == [0, 1]
