"""The tiered client store in the port (``repro_torch.sim.tiered``) against
the resident store and against the reference.

Within the port everything is bitwise: a ``HostStore`` run equals the
``ClientStore`` run of the same config (plain, size-weighted, flat
AirComp, faulted, wireless channel, SCAFFOLD, FedDyn), at any
``stream_segment``, with prefetch on or off, checkpointed, and killed and
resumed; snapshots cross between the tiers both ways. Against the
reference: the ``CohortStream`` (cohorts, availability, channel draws,
chains, key) bitwise for 6 rounds; a tiered run within the ZO trajectory
tolerance 1e-3 of ``repro.sim.run_tiered_experiment`` (masks equal); a
reference snapshot resumes in the port's tiered runner; a population saved
by either package loads bitwise in the other. Sizes: softmax 24×4 on 16
ragged clients of 10–59 rows, M = 5, H = 2, b1 = 8, b2 = 4.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sim as jsim
from repro.configs.base import FedZOConfig as JConfig
from repro.data.synthetic import make_classification
from repro.models.simple import softmax_init as jsoftmax_init
from repro.models.simple import softmax_loss as jsoftmax_loss
from repro.sim import channel as jchannel
from repro.sim.tiered import CohortStream as JStream
from repro_torch import sim
from repro_torch.configs.base import FedZOConfig
from repro_torch.fed.server import FedServer
from repro_torch.models.simple import (softmax_accuracy, softmax_init,
                                       softmax_loss)
from repro_torch.obs import MemorySink
from repro_torch.sim import channel as channel_lib
from repro_torch.sim.tiered import CohortStream, bucket_caps

from _hyp import hypothesis, st

hypothesis.settings.register_profile(
    "torch_tiered", deadline=None, max_examples=10,
    suppress_health_check=list(hypothesis.HealthCheck))

BASE = dict(n_devices=16, n_participating=5, local_iters=2, lr=1e-2,
            mu=1e-3, b1=8, b2=4, seed=3)
FAULTS = dict(p_fail=0.25, p_recover=0.5, deadline=2.0, p_corrupt=0.1)
CHANNEL = dict(rho=0.8, battery=3.0, tx_cost=1.0)
CHAN_CFG = dict(channel_schedule=True, h_min=0.3)
# the ZO trajectory tolerance (tests/test_torch_strategy.py): a loss ulp
# moves a coefficient by d·ulp/mu
ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the port's CPU path is many small ops, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ragged_clients(n_clients=16, lo=10, hi=60, seed=0):
    """Uneven client sizes, so the buckets differ."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, size=n_clients)
    x, y = make_classification(int(sizes.sum()), 24, 4, seed=seed)
    clients, off = [], 0
    for s in sizes:
        clients.append({"x": x[off:off + s], "y": y[off:off + s]})
        off += s
    return clients


CLIENTS = _ragged_clients()


def _eval_fn():
    x, y = make_classification(64, 24, 4, seed=9)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    return lambda p: {"acc": softmax_accuracy(p, batch)}


def _p0():
    return softmax_init(24, 4, device="cpu")


def _cfg(channel=False, **kw):
    cm = sim.ChannelModel(**CHANNEL) if channel else None
    return FedZOConfig(**{**BASE, **(CHAN_CFG if channel else {}), **kw},
                       channel_model=cm)


def _jcfg(channel=False, **kw):
    cm = jchannel.ChannelModel(**CHANNEL) if channel else None
    return JConfig(**{**BASE, **(CHAN_CFG if channel else {}), **kw},
                   channel_model=cm)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _np(v.cpu() if isinstance(v, torch.Tensor)
                                  else v)
    return out


def _trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _results_equal(a, b):
    """Bitwise: params, key, metrics ring, evals, the fault and channel
    chains and the strategy state."""
    for x, y in ((a.params, b.params), (a.metrics, b.metrics),
                 (a.evals, b.evals)):
        _trees_equal(x, y)
    assert torch.equal(a.key, b.key)
    for x, y in ((a.fault_state, b.fault_state),
                 (a.channel_state, b.channel_state)):
        assert (x is None) == (y is None)
        if x is not None:
            for u, v in zip(x if isinstance(x, tuple) else (x,),
                            y if isinstance(y, tuple) else (y,)):
                assert torch.equal(u, v)
    assert (a.strategy_state is None) == (b.strategy_state is None)
    if a.strategy_state is not None:
        _trees_equal(a.strategy_state, b.strategy_state)


def _host(n_buckets=3):
    host = sim.build_host_store(CLIENTS, n_buckets=n_buckets)
    assert host.n_buckets > 1, "the ragged fixture must give > 1 bucket"
    return host


# ---------------------------------------------------------------------------
# the host key-chain replay


@pytest.mark.parametrize("channel", [False, True], ids=["nochan", "chan"])
@pytest.mark.parametrize("faults", [False, True], ids=["nofault", "fault"])
def test_stream_is_bitwise_the_reference_stream(faults, channel):
    """Six rounds of cohorts, availability slices, cohort fading and
    transmit masks, then the key, the fault chain and the channel chain:
    each bitwise the reference's ``CohortStream``; the key is also the
    port's resident run's carry key after those rounds."""
    cfg, jcfg = _cfg(channel), _jcfg(channel)
    host = _host()
    jhost = jsim.build_host_store(CLIENTS, n_buckets=3)
    key, jkey = sim.experiment_key(cfg), jsim.experiment_key(jcfg)
    fm = sim.FaultModel(p_fail=0.3, p_recover=0.5) if faults else None
    jfm = jsim.FaultModel(p_fail=0.3, p_recover=0.5) if faults else None
    cs = jcs = None
    if channel:
        cs = cfg.channel_model.init_state(16, channel_lib.init_key(key))
        jcs = jcfg.channel_model.init_state(16, jchannel.init_key(jkey))
    stream = CohortStream(host, cfg, key, faults=fm, cstate=cs,
                          fstate=fm.init_state(16) if faults else None)
    jstream = JStream(jhost, jcfg, jkey, faults=jfm, cstate=jcs,
                      fstate=jfm.init_state(16) if faults else None)
    got, want = stream.plan(6), jstream.plan(6)
    assert got[0].shape == (6, 5)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_array_equal(stream.key.numpy(),
                                  np.asarray(jax.random.key_data(
                                      jstream.key)))
    if faults:
        np.testing.assert_array_equal(stream.fstate.numpy(),
                                      np.asarray(jstream.fstate))
    if channel:
        for a, b in zip(stream.cstate, jstream.cstate):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    res = sim.run_experiment(softmax_loss, _p0(),
                             sim.build_store(CLIENTS, device="cpu"), cfg, 6,
                             faults=fm)
    assert torch.equal(res.key, stream.key)


# ---------------------------------------------------------------------------
# the equivalence matrix: tiered ≡ resident, bitwise


MATRIX = {
    "plain": ({}, False),
    "weighted": ({"weight_by_size": True}, False),
    "flat_aircomp": ({"flat_params": True, "flat_block_rows": 4,
                      "aircomp": True, "snr_db": 5.0,
                      "channel_schedule": True}, False),
    "faults": ({}, True),
    "channel_faults": ({"channel": True}, True),
    "scaffold": ({"strategy": "scaffold"}, False),
    "feddyn": ({"strategy": "feddyn", "dyn_alpha": 0.01}, False),
}


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_tiered_matches_resident_bitwise(name):
    kw, faults = MATRIX[name]
    cfg = _cfg(**kw)
    fm = sim.FaultModel(**FAULTS) if faults else None
    ev = _eval_fn()
    res = sim.run_experiment(softmax_loss, _p0(),
                             sim.build_store(CLIENTS, device="cpu"), cfg, 5,
                             faults=fm, eval_fn=ev, eval_every=2)
    tier = sim.run_experiment(softmax_loss, _p0(), _host(), cfg, 5,
                              faults=fm, eval_fn=ev, eval_every=2)
    _results_equal(res, tier)
    assert tier.prefetch["staged_bytes"] > 0 and len(tier.staging) == 5
    assert tier.prefetch["stream_segment"] == (
        1 if name in ("scaffold", "feddyn") else 8)


@pytest.mark.parametrize("name", ["plain", "flat_aircomp", "channel_faults"])
def test_tiered_matches_reference_tiered(name):
    """The port's tiered run against ``repro.sim.run_tiered_experiment``
    on the same population and config: weights, losses and evals within
    1e-3, the surviving-client counts equal, the fault and channel chains
    bitwise."""
    kw, faults = MATRIX[name]
    cfg, jcfg = _cfg(**kw), _jcfg(**kw)
    fm = sim.FaultModel(**FAULTS) if faults else None
    jfm = jsim.FaultModel(**FAULTS) if faults else None
    x, y = make_classification(64, 24, 4, seed=9)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    from repro.models.simple import softmax_accuracy as jacc
    jres = jsim.run_tiered_experiment(
        jsoftmax_loss, jsoftmax_init(None, 24, 4),
        jsim.build_host_store(CLIENTS, n_buckets=3), jcfg, 5, faults=jfm,
        eval_fn=lambda p: {"acc": jacc(p, jb)}, eval_every=2, donate=False)
    tres = sim.run_experiment(softmax_loss, _p0(), _host(), cfg, 5,
                              faults=fm, eval_fn=_eval_fn(), eval_every=2)
    jm = jax.device_get(jres.metrics)
    assert sorted(jm) == sorted(tres.metrics)
    for k, v in jm.items():
        got = tres.metrics[k].numpy()
        if k in ("m_effective", "m_corrupt"):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(tres.evals["acc"].numpy(),
                               np.asarray(jres.evals["acc"]), atol=2 / 64)
    jp = _flat(jax.device_get(jres.params))
    tp = _flat(tres.params)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    if faults:
        np.testing.assert_array_equal(tres.fault_state.numpy(),
                                      np.asarray(jres.fault_state))
    if cfg.channel_model is not None:
        for a, b in zip(tres.channel_state, jres.channel_state):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tres.staging == {t: {"bucket_id": int(r["bucket_id"]),
                                "staged_bytes": int(r["staged_bytes"])}
                            for t, r in jres.staging.items()}


# ---------------------------------------------------------------------------
# segments, checkpoints, kill-and-resume


def test_stream_segments_equal_single_shot(tmp_path):
    """``stream_segment`` 1, 3 and 8 (prefetch on and off) and 3-round
    checkpoint segments land on the single-shot run's bits."""
    host, cfg, ev = _host(), _cfg(), _eval_fn()
    one = sim.run_tiered_experiment(softmax_loss, _p0(), host, cfg, 7,
                                    eval_fn=ev, eval_every=3,
                                    stream_segment=7)
    for seg, pf in ((1, True), (3, False), (8, True)):
        got = sim.run_tiered_experiment(softmax_loss, _p0(), host, cfg, 7,
                                        eval_fn=ev, eval_every=3,
                                        stream_segment=seg, prefetch=pf)
        _results_equal(one, got)
        assert got.prefetch["stream_segment"] == seg
    ck = sim.run_experiment(softmax_loss, _p0(), host, cfg, 7, eval_fn=ev,
                            eval_every=3, checkpoint_every=3,
                            checkpoint_dir=str(tmp_path / "ck"))
    _results_equal(one, ck)
    assert ck.manifest["tiered"] == {"n_buckets": host.n_buckets,
                                     "stream_segment": 8,
                                     "host_bytes": host.nbytes,
                                     "prefetch": True}


@pytest.mark.parametrize("name", ["channel_faults", "scaffold"])
def test_tiered_kill_and_resume_bitwise(name, tmp_path):
    """Killed after one 2-round segment and resumed in a fresh call: the
    single-shot bits, the host-side chains and client masters included."""
    kw, faults = MATRIX[name]
    cfg, host = _cfg(**kw), _host()
    fm = sim.FaultModel(**FAULTS) if faults else None
    single = sim.run_experiment(softmax_loss, _p0(), host, cfg, 6,
                                faults=fm)
    d = str(tmp_path / "ck")
    part = sim.run_experiment(softmax_loss, _p0(), host, cfg, 6, faults=fm,
                              checkpoint_every=2, checkpoint_dir=d,
                              max_segments=1)
    assert part.rounds == 2
    resumed = sim.run_experiment(softmax_loss, _p0(), host, cfg, 6,
                                 faults=fm, checkpoint_every=2,
                                 checkpoint_dir=d, resume=True)
    assert resumed.rounds == 6
    _results_equal(single, resumed)


@pytest.mark.parametrize("direction", ["resident_to_tiered",
                                       "tiered_to_resident"])
def test_snapshots_cross_between_tiers(direction, tmp_path):
    """A snapshot of one tier resumes on the other (the same npz leaf
    layout) and lands on the single-shot bits, SCAFFOLD's client master
    included."""
    cfg, host = _cfg(strategy="scaffold"), _host()
    store = sim.build_store(CLIENTS, device="cpu")
    first, second = ((store, host) if direction == "resident_to_tiered"
                     else (host, store))
    single = sim.run_experiment(softmax_loss, _p0(), store, cfg, 6)
    d = str(tmp_path / "ck")
    sim.run_experiment(softmax_loss, _p0(), first, cfg, 6,
                       checkpoint_every=2, checkpoint_dir=d, max_segments=1)
    resumed = sim.run_experiment(softmax_loss, _p0(), second, cfg, 6,
                                 checkpoint_every=2, checkpoint_dir=d,
                                 resume=True)
    _results_equal(single, resumed)


def test_reference_snapshot_resumes_on_port_tiered(tmp_path):
    """The reference's tiered runner does 2 of 6 rounds (faults and the
    channel on) and leaves its snapshot; the port's tiered runner resumes
    it: the chains bitwise the reference's single-shot run's, the masks
    equal, weights and losses within 1e-3."""
    kw, _ = MATRIX["channel_faults"]
    cfg, jcfg = _cfg(**kw), _jcfg(**kw)
    jfm = jsim.FaultModel(**FAULTS)
    jhost = jsim.build_host_store(CLIENTS, n_buckets=3)
    d = str(tmp_path)
    jsim.run_experiment(jsoftmax_loss, jsoftmax_init(None, 24, 4), jhost,
                        jcfg, 6, faults=jfm, checkpoint_every=2,
                        checkpoint_dir=d, max_segments=1, donate=False)
    jone = jsim.run_experiment(jsoftmax_loss, jsoftmax_init(None, 24, 4),
                               jhost, jcfg, 6, faults=jfm, donate=False)
    tres = sim.run_experiment(softmax_loss, _p0(), _host(), cfg, 6,
                              faults=sim.FaultModel(**FAULTS),
                              checkpoint_every=2, checkpoint_dir=d,
                              resume=True)
    assert tres.rounds == 6
    np.testing.assert_array_equal(tres.fault_state.numpy(),
                                  np.asarray(jone.fault_state))
    for a, b in zip(tres.channel_state, jone.channel_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k, v in jax.device_get(jone.metrics).items():
        got = tres.metrics[k].numpy()
        if k in ("m_effective", "m_corrupt"):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=0, atol=ATOL, err_msg=k)
    jp, tp = _flat(jax.device_get(jone.params)), _flat(tres.params)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=ATOL,
                                   err_msg=k)


def test_tiered_divergence_rolls_back_as_resident(tmp_path):
    """A loss that overflows at lr 1e6 (the reference's divergence drill)
    diverges in the first segment: the tiered runner rolls back with the
    lr backed off exactly as the resident runner does (the same event rows
    and final bits)."""
    def loss(p, b):
        return torch.exp(torch.sum(torch.square(p["x"] - 0.1)))

    cfg = _cfg(lr=1e6)
    kw = dict(checkpoint_every=2, max_retries=3, lr_backoff=1e-8)
    runs = [sim.run_experiment(loss, {"x": torch.zeros(4)}, store, cfg, 4,
                               checkpoint_dir=str(tmp_path / name), **kw)
            for name, store in (("r", sim.build_store(CLIENTS,
                                                      device="cpu")),
                                ("t", _host()))]
    assert [e["event"] for e in runs[1].events] == ["rollback"]
    assert runs[1].events == runs[0].events
    _results_equal(*runs)


# ---------------------------------------------------------------------------
# the host store: files, buckets, sampling


def test_hoststore_save_load_mmap_roundtrip(tmp_path):
    host = _host()
    d = host.save(str(tmp_path / "pop"))
    back = sim.HostStore.load(d, mmap=True)
    assert back.n_buckets == host.n_buckets
    assert all(isinstance(l, np.memmap)
               for b in back.buckets for l in b.data.values())
    for i, c in enumerate(CLIENTS):
        _trees_equal(back.client(i), c)
    idx = np.asarray([[0, 3, 7], [2, 2, 9]])
    _trees_equal(host.stage(idx)[0], back.stage(idx)[0])
    with open(f"{d}/hoststore.json") as f:
        assert json.load(f)["leaves"] == ["x", "y"]


def test_populations_cross_between_packages(tmp_path):
    """A population the reference saved loads bitwise in the port, and
    one the port saved loads bitwise in the reference; both stage the
    reference's bytes."""
    jhost = jsim.build_host_store(CLIENTS, n_buckets=3)
    tback = sim.HostStore.load(jhost.save(str(tmp_path / "j")))
    jback = jsim.HostStore.load(_host().save(str(tmp_path / "t")))
    for a, b in ((tback, jhost), (_host(), jback)):
        for name in ("sizes", "bucket_of", "row_of"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name))
        for ba, bb in zip(a.buckets, b.buckets):
            assert ba.cap == bb.cap
            np.testing.assert_array_equal(ba.ids, bb.ids)
            _trees_equal(ba.data, bb.data)
    idx = np.asarray([[0, 3, 7, 11, 15], [2, 2, 9, 1, 4]])
    got, gsizes, gmeta = tback.stage(idx)
    want, wsizes, wmeta = jhost.stage(idx)
    _trees_equal(got, want)
    np.testing.assert_array_equal(gsizes, wsizes)
    assert (gmeta["cap"], gmeta["bytes"], gmeta["round_bytes"]) == (
        wmeta["cap"], wmeta["bytes"], wmeta["round_bytes"])
    np.testing.assert_array_equal(gmeta["bucket_ids"], wmeta["bucket_ids"])


@hypothesis.settings(hypothesis.settings.get_profile("torch_tiered"))
@hypothesis.given(st.integers(2, 40), st.integers(1, 6), st.integers(0, 50))
def test_bucketing_partitions_population(n_clients, n_buckets, seed):
    """Every client lands in exactly one bucket, keeps its rows exactly
    once and in order, and fits its bucket; the caps are the reference's
    quantiles and the last is the largest client."""
    clients = _ragged_clients(n_clients=n_clients, lo=3, hi=30, seed=seed)
    host = sim.build_host_store(clients, n_buckets=n_buckets)
    caps = [b.cap for b in host.buckets]
    assert caps == sorted(set(caps))
    all_ids = np.concatenate([b.ids for b in host.buckets])
    np.testing.assert_array_equal(np.sort(all_ids), np.arange(n_clients))
    for i, c in enumerate(clients):
        assert host.sizes[i] <= host.buckets[int(host.bucket_of[i])].cap
        _trees_equal(host.client(i), c)
    assert caps[-1] == int(host.sizes.max()) == host.capacity
    assert set(caps) == set(bucket_caps(host.sizes, n_buckets))
    jhost = jsim.build_host_store(clients, n_buckets=n_buckets)
    assert caps == [b.cap for b in jhost.buckets]


@hypothesis.settings(hypothesis.settings.get_profile("torch_tiered"))
@hypothesis.given(st.integers(1, 5), st.integers(0, 40))
def test_bucket_count_never_changes_sampling(n_buckets, seed):
    """The minibatch rows drawn from a bucket-padded staged cohort are
    bitwise the resident store's on the same key, for any bucket count."""
    clients = _ragged_clients(n_clients=10, lo=4, hi=40, seed=seed)
    store = sim.build_store(clients, device="cpu")
    host = sim.build_host_store(clients, n_buckets=n_buckets)
    k_part, k_batch = sim.round_keys(torch.tensor([0, seed]))[1:3]
    idx = sim.sample_participants(k_part, 10, 4)
    want = sim.sample_batches(store, idx, k_batch, 3, 4)
    data, sizes, _ = host.stage(idx.numpy()[None, :])
    got = sim.sample_cohort_batches(
        {k: torch.from_numpy(v[0]) for k, v in data.items()},
        torch.from_numpy(sizes[0]), k_batch, 3, 4)
    _trees_equal(want, got)


# ---------------------------------------------------------------------------
# the seams: history, resolve_store, FedServer, sweeps, stateful clamp


def test_history_rows_carry_staging_columns():
    host, cfg = _host(), _cfg()
    tier = sim.run_experiment(softmax_loss, _p0(), host, cfg, 4)
    rows = [r for r in tier.history() if "mean_local_loss" in r]
    assert len(rows) == 4
    for r in rows:
        assert r["staged_bytes"] > 0 and "wire_bytes" in r
        assert 0 <= r["bucket_id"] < host.n_buckets
    shifted = tier.history(start_round=10)
    assert [r["staged_bytes"] for r in shifted] == \
        [r["staged_bytes"] for r in rows]
    res = sim.run_experiment(softmax_loss, _p0(),
                             sim.build_store(CLIENTS, device="cpu"), cfg, 4)
    for r in res.history():
        assert "staged_bytes" not in r and "bucket_id" not in r


def test_resolve_store_seam():
    store = sim.build_store(CLIENTS, device="cpu")
    host = _host(2)
    assert sim.resolve_store(store) is store
    assert sim.resolve_store(host, tier="auto") is host
    res = sim.resolve_store(host, tier="resident", device="cpu")
    assert isinstance(res, sim.ClientStore)
    _trees_equal(res.data, store.data)
    assert torch.equal(res.sizes, store.sizes)
    assert isinstance(sim.resolve_store(CLIENTS, tier="host"),
                      sim.HostStore)
    with pytest.raises(TypeError, match="not a client store"):
        sim.resolve_store({"not": "a store"})
    with pytest.raises(TypeError, match="ClientStore or HostStore"):
        sim.run_experiment(softmax_loss, _p0(), object(), _cfg(), 1)


def test_fedserver_and_sweep_take_a_host_store(tmp_path):
    """``FedServer`` and ``run_sweep`` take a ``HostStore``: bitwise the
    same rounds and records as with the resident store."""
    cfg = _cfg(strategy="scaffold")
    runs = []
    for store in (sim.build_store(CLIENTS, device="cpu"), _host()):
        srv = FedServer(softmax_loss, _p0(), CLIENTS, cfg, store=store)
        srv.run(2)
        recs = sim.run_sweep(softmax_loss, _p0(), store, _cfg(),
                             sim.scenario_grid(lr=(1e-2, 2e-2)), 2)
        runs.append((srv.params, recs))
    _trees_equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        _trees_equal(a["metrics"], b["metrics"])


def test_stateful_strategy_forces_segment_one_and_sinks():
    """SCAFFOLD's ``[N]`` master is read and written every round, so the
    stream runs one-round segments whatever was asked; taps stream every
    round's metrics and the client master stays in host memory."""
    sink = MemorySink()
    tier = sim.run_tiered_experiment(softmax_loss, _p0(), _host(2),
                                     _cfg(strategy="scaffold"), 3,
                                     stream_segment=8, sink=sink,
                                     tap_every=1)
    assert tier.prefetch["stream_segment"] == 1
    assert tier.prefetch["staged_bytes"] > 0
    assert [r["round"] for r in sink.rows] == [0, 1, 2]
    assert tier.strategy_state["client"]["w"].shape == (16, 24, 4)
    assert tier.strategy_state["client"]["w"].device.type == "cpu"


def test_cohort_batch_optional_fields_default_none():
    cb = sim.CohortBatch(data={"x": torch.zeros(2, 3)},
                         sizes=torch.ones(2, dtype=torch.int32))
    assert cb.avail is None and cb.chan_h is None and cb.chan_mask is None
