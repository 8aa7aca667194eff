"""``FedServer`` in the port (``fed/server.py``) against the reference's:
the host loop (numpy client sampling, the 3-way key split, the fedzo and
fedavg rounds) and the store path (the engine's round step) for every
strategy, through ``run_round`` and ``run(driver=...)``; the divergence
guard's rollback rows and ``DivergenceError``; the comms ledger columns;
and the routes that are not ported.

Round numbers and the integer ledger columns (bytes, ``m_effective``) are
equal; losses, evals and weights are within the ZO trajectory tolerance
1e-3 of ``tests/test_torch_slice.py`` (a one-ulp loss difference moves a
coefficient by d·ulp/μ ≈ 0.012; readings stand beside each test); a test
accuracy within one of its 96 rows (a row whose margin is below the
weights' drift can flip). Sizes: softmax 24×4 on 6 clients, M = 3, H = 2,
b1 = 8, b2 = 4, 2 rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sim as jsim
from repro.configs.base import FedZOConfig as JConfig
from repro.fed.server import FedServer as JServer
from repro.obs.ledger import CommsLedger as JLedger
from repro.workloads import neural as jneural
from repro_torch.configs.base import FedZOConfig
from repro_torch.data.synthetic import make_classification, noniid_shards
from repro_torch.fed.server import FedServer
from repro_torch.obs.ledger import CommsLedger
from repro_torch.sim import build_store
from repro_torch.sim.faults import DivergenceError
from repro_torch.utils import convert
from repro_torch.workloads import neural as tneural

TASK = dict(n_train=320, n_test=96, n_clients=6, n_features=24, n_classes=4,
            alpha=0.5)
BASE = dict(n_devices=6, n_participating=3, local_iters=2, b1=8, b2=4,
            lr=5e-2, mu=1e-3, seed=11, prox_mu=0.1, dyn_alpha=0.01)
ATOL = 1e-3
ACC_ATOL = 1 / 96 + 1e-6
INTS = ("round", "m_effective", "wire_bytes", "dense_bytes",
        "downlink_bytes", "wire_bytes_total", "downlink_bytes_total",
        "wire_bytes_effective")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the port's CPU path is many small ops, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _servers(store, **kw):
    jt = jneural.make_task("softmax", **TASK)
    tt = tneural.make_task("softmax", device="cpu", **TASK)
    p0 = jax.device_get(jneural.params_init(jt, 11))
    cfg = dict(BASE, **kw.pop("cfg", {}))
    jev = lambda p: {k: float(v) for k, v in  # noqa: E731
                     jneural.task_eval(jt, 96)(p).items()}
    tev = lambda p: {k: float(v) for k, v in  # noqa: E731
                     tneural.task_eval(tt, 96)(p).items()}
    evals = kw.pop("evals", True)
    js = JServer(jt.loss, jax.tree.map(jnp.asarray, p0), jt.clients,
                 JConfig(**cfg), store=jt.store if store else None,
                 eval_fn=jev if evals else None, **kw)
    ts = FedServer(tt.loss, convert.to_torch(p0), tt.clients,
                   FedZOConfig(**cfg), store=tt.store if store else None,
                   eval_fn=tev if evals else None, **kw)
    return js, ts


def _same_history(jh, th):
    assert len(jh) == len(th)
    for jr, tr in zip(jh, th):
        assert sorted(tr) == sorted(jr)
        for k, v in jr.items():
            if k in INTS or k in ("event", "retry", "strategy"):
                assert tr[k] == v, k
            elif k == "test_acc":
                assert abs(tr[k] - v) <= ACC_ATOL, k
            elif k not in ("round_ms", "lr"):
                assert abs(tr[k] - v) <= ATOL + 1e-3 * abs(v), k
        assert tr["compression_ratio"] == jr["compression_ratio"]


def _same_params(js, ts, atol=ATOL):
    j, t = _flat(jax.device_get(js.params)), _flat(ts.params)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("algo,kw", [
    ("fedzo", dict(weight_by_size=True)),
    ("fedzo", dict(flat_params=True, flat_block_rows=4, aircomp=True,
                   channel_schedule=True, snr_db=5.0)),
    ("fedzo", dict(server_momentum=0.5, direction_conv="counter")),
    ("fedavg", dict(weight_by_size=True)),
    ("fedzo", dict(delta_compression="seed"))])
def test_host_loop_matches_reference(algo, kw):
    """Two host-loop rounds (numpy sampling, the 3-way key split) with the
    host ``eval_fn``: the same history rows (round numbers, ledger columns,
    ``m_effective`` exactly; losses and evals within 1e-3, readings up to
    2.6e-4), weights within 1e-3 (readings up to 1.2e-4; fedavg within
    1e-6, reading 7.5e-9)."""
    js, ts = _servers(False, algo=algo, cfg=kw)
    assert ts.algo == js.algo == algo
    js.run(2)
    ts.run(2)
    _same_history(js.history, ts.history)
    assert all(r["round_ms"] > 0 for r in ts.history)
    _same_params(js, ts, 1e-6 if algo == "fedavg" else ATOL)


@pytest.mark.parametrize("name", ["fedzo", "fedavg", "fedprox", "feddyn",
                                  "scaffold"])
def test_store_path_matches_reference(name):
    """Every strategy on the store path, two ``run_round`` calls (the
    engine's round step, the host eval): the reference's history rows and
    weights within 1e-3 (readings up to 1.6e-4; fedavg within 1e-6, reading
    7.5e-9), FedDyn's and SCAFFOLD's state carried between the calls."""
    js, ts = _servers(True, strategy=name, cfg=dict(weight_by_size=True))
    for _ in range(2):
        js.run_round()
        ts.run_round()
    _same_history(js.history, ts.history)
    _same_params(js, ts, 1e-6 if name == "fedavg" else ATOL)
    assert (ts._zstate is None) == (js._zstate is None)


@pytest.mark.parametrize("name", ["fedzo", "scaffold"])
def test_scan_driver_matches_reference(name):
    """``run(driver="scan")``: the engine's round loop with the per-round
    ``jit_eval``, continuing from a host-driven round; rows carry the
    strategy's name and the ledger columns, numbered on from the host
    round (readings up to 9.8e-5)."""
    js, ts = _servers(True, strategy=name, evals=False,
                      cfg=dict(flat_params=True, flat_block_rows=4))
    js.jit_eval = jneural.task_eval(jneural.make_task("softmax", **TASK), 96)
    ts.jit_eval = tneural.task_eval(
        tneural.make_task("softmax", device="cpu", **TASK), 96)
    js._jit_eval = jax.jit(js.jit_eval)
    for srv in (js, ts):
        srv.run_round()
        srv.run(2, driver="scan")
    _same_history(js.history, ts.history)
    assert [r["round"] for r in ts.history] == [0, 1, 2]
    assert [r.get("strategy") for r in ts.history[1:]] == [name, name]
    _same_params(js, ts)


def _explosive(pkg_jax):
    """A loss that overflows to inf within one local phase at a large lr
    (the reference's ``tests/test_faults.py`` trigger)."""
    x, y = make_classification(320, 4, 2, seed=1)
    clients = noniid_shards(x, y, 8)
    if pkg_jax:
        def loss(p, batch):
            del batch
            return jnp.exp(jnp.sum(jnp.square(p["x"] - 0.1)))
        return loss, {"x": jnp.zeros((4,), jnp.float32)}, clients, \
            jsim.build_store(clients)

    def loss(p, batch):
        del batch
        return torch.exp(torch.sum(torch.square(p["x"] - 0.1)))
    return loss, {"x": torch.zeros(4)}, clients, build_store(clients,
                                                             device="cpu")


@pytest.mark.parametrize("store", [False, True], ids=["host", "store"])
def test_divergence_rolls_back_then_raises(store):
    """At lr 1e6 the first round diverges: with a backoff of 1e-8 it is
    rolled back once (a ``rollback`` row before the round's row, the round
    numbers unshifted) and the run goes on finite, as in the reference;
    with a backoff of 1.0 two rollbacks end in ``DivergenceError`` at round
    0."""
    cfg = dict(n_devices=8, n_participating=4, local_iters=2, lr=1e6,
               mu=1e-3, b1=8, b2=4, seed=3)
    hist = {}
    for pkg in ("jax", "torch"):
        loss, p0, clients, st = _explosive(pkg == "jax")
        srv = (JServer if pkg == "jax" else FedServer)(
            loss, p0, clients, (JConfig if pkg == "jax" else FedZOConfig)(
                **cfg), store=st if store else None, divergence_guard=True,
            max_retries=3, lr_backoff=1e-8)
        srv.run(3, driver="host")
        hist[pkg] = srv.history
    events = [(r["round"], r.get("event")) for r in hist["torch"]]
    assert events == [(r["round"], r.get("event")) for r in hist["jax"]]
    assert events[0] == (0, "rollback") and len(events) == 4
    assert [r["round"] for r in hist["torch"] if "event" not in r] \
        == [0, 1, 2]
    assert all(np.isfinite(r["mean_local_loss"]) for r in hist["torch"]
               if "event" not in r)
    loss, p0, clients, st = _explosive(False)
    srv = FedServer(loss, p0, clients, FedZOConfig(**cfg),
                    store=st if store else None, divergence_guard=True,
                    max_retries=2, lr_backoff=1.0)
    with pytest.raises(DivergenceError) as ei:
        srv.run(3, driver="host")
    assert ei.value.round == 0 and ei.value.retries == 2
    assert sum(r.get("event") == "rollback" for r in srv.history) == 2


def test_ledger_matches_reference():
    """The byte model of each wire format: the reference's fields."""
    jt = jneural.make_task("softmax", **TASK)
    p0 = jax.device_get(jneural.params_init(jt, 11))
    for kw in ({}, dict(aircomp=True), dict(delta_compression="seed")):
        j = JLedger.from_run(JConfig(**BASE, **kw), p0)
        t = CommsLedger.from_run(FedZOConfig(**BASE, **kw),
                                 convert.to_torch(p0))
        assert (t.m, t.uplink_client_bytes, t.downlink_client_bytes,
                t.dense_client_bytes, t.mode) == (
            j.m, j.uplink_client_bytes, j.downlink_client_bytes,
            j.dense_client_bytes, j.mode)
        assert t.compression_ratio() == j.compression_ratio()
        rows = [{"round": 4, "mean_local_loss": 1.0, "m_effective": 2.0},
                {"round": 4, "event": "rollback"}, {"round": 5}]
        assert t.annotate([dict(r) for r in rows]) == \
            j.annotate([dict(r) for r in rows])


def test_unported_routes_raise():
    """A store that is neither tier raises the reference's ``TypeError``
    (``resolve_store``), and a tiered ``HostStore`` runs: it materializes
    bitwise as the resident store, so its rounds are the store path's.
    Fault injection and the wireless
    channel model build on the store path and raise the reference's
    ValueErrors without a store; a tracer builds on either driver; the
    reference's own checks stay ValueErrors."""
    from repro_torch.obs import Tracer
    from repro_torch.sim import ChannelModel, FaultModel
    tt = tneural.make_task("softmax", device="cpu", **TASK)
    p0 = tneural.params_init(tt, 11)
    cfg = FedZOConfig(**BASE)
    with pytest.raises(TypeError, match="not a client store"):
        FedServer(tt.loss, p0, tt.clients, cfg, store=object())
    from repro_torch.sim import build_host_store
    host = FedServer(tt.loss, p0, tt.clients, cfg,
                     store=build_host_store(tt.clients, n_buckets=3))
    resident = FedServer(tt.loss, p0, tt.clients, cfg, store=tt.store)
    for k in tt.store.data:
        assert torch.equal(host.store.data[k], tt.store.data[k])
    host.run(2)
    resident.run(2)
    for k in p0:
        assert torch.equal(host.params[k], resident.params[k])
    cm_cfg = FedZOConfig(**BASE, channel_model=ChannelModel(rho=0.5))
    for kw, match in ((dict(faults=FaultModel(p_fail=0.1)), "fault"),
                      (dict(cfg=cm_cfg), "channel_model")):
        kw = {"cfg": cfg, **kw}
        with pytest.raises(ValueError, match=match):
            FedServer(tt.loss, p0, tt.clients, **kw)
        assert FedServer(tt.loss, p0, tt.clients, store=tt.store,
                         **kw)._sim_step is not None
    for store in (None, tt.store):
        assert FedServer(tt.loss, p0, tt.clients, cfg, store=store,
                         tracer=Tracer()).tracer is not None
    with pytest.raises(ValueError, match="needs the engine round step"):
        FedServer(tt.loss, p0, tt.clients, cfg, strategy="scaffold")
    with pytest.raises(ValueError, match="n_devices"):
        FedServer(tt.loss, p0, tt.clients[:5], cfg)
    with pytest.raises(ValueError, match="client datasets"):
        FedServer(tt.loss, p0, None, cfg)
    with pytest.raises(ValueError, match="needs store"):
        FedServer(tt.loss, p0, tt.clients, cfg).run(1, driver="scan")
