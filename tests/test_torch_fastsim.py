"""``sim.fast_sim_config`` runs (the wide ``block`` route under rbg and
unsafe_rbg keys) against the reference's ``run_experiment``, live.

At the golden size (8 softmax clients, M = 4, H = 2, b1 = 8, b2 = 4), with
and without AirComp, under both 4-word impls:

- the integer streams are bitwise the reference's: the key chain,
  participants, minibatch rows and the vmapped client keys; the direction
  blocks, drawn as one batched Philox draw from the first client's key,
  within the normal draw's ulp tolerance;
- the trajectories (metrics, evals, parameters) within the port's stated
  tolerance (``tests/test_torch_slice.py``: 1e-3 here, a loss ulp moves a
  coefficient by d·ulp/μ);
- ``FedServer`` (both store drivers) and the tiered store are bitwise the
  port's resident run;
- the pytree route under the same keys (its client loop drawing as rows
  of the reference's client vmap) against the reference.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable, as runs do)
from repro import sim as jsim
from repro.core import estimator as jest
from repro.utils.flatparams import flat_spec as jflat_spec
from repro.workloads import neural as jneural
from repro_torch import sim as tsim
from repro_torch.core import estimator as test_
from repro_torch.fed.server import FedServer
from repro_torch.sim import engine as tengine
from repro_torch.sim import store as tstore
from repro_torch.utils import convert, prng
from repro_torch.utils.flatparams import flat_spec
from repro_torch.workloads import neural as tneural

TASK = dict(n_train=320, n_test=96, n_clients=8, n_features=24, n_classes=4,
            alpha=0.5)
CFG = dict(n_participating=4, local_iters=2, b1=8, b2=4, lr=5e-2, mu=1e-3,
           seed=11)
ROUNDS = 4
ATOL, RTOL = 1e-3, 1e-4
NORMAL_ULPS = 4
CASES = [(impl, air) for impl in ("rbg", "unsafe_rbg")
         for air in (False, True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tasks():
    return (jneural.make_task("softmax", **TASK),
            tneural.make_task("softmax", device="cpu", **TASK))


def _cfgs(jt, tt, impl, aircomp):
    """The fast strategy with ``impl`` in place of its unsafe_rbg."""
    kw = dict(CFG, aircomp=aircomp)
    jcfg = dataclasses.replace(
        jsim.fast_sim_config(jneural.default_config(jt, **kw)),
        prng_impl=impl)
    tcfg = dataclasses.replace(
        tsim.fast_sim_config(tneural.default_config(tt, **kw)),
        prng_impl=impl)
    assert (tcfg.batch_directions, tcfg.direction_conv) == (True, "block")
    return jcfg, tcfg


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_fast_sim_config_is_the_references():
    from repro.configs.base import FedZOConfig as JConfig
    from repro_torch.configs.base import FedZOConfig as TConfig
    j = dataclasses.asdict(jsim.fast_sim_config(JConfig(lr=0.3, b2=7)))
    t = dataclasses.asdict(tsim.fast_sim_config(TConfig(lr=0.3, b2=7)))
    assert j == t
    assert t["prng_impl"] == "unsafe_rbg"


@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
def test_round_draws_bitwise(tasks, impl):
    """Key chain, participants, minibatch rows, the client keys of the
    reference's vmapped split, and each iterate's direction block."""
    jt, tt = tasks
    jcfg, tcfg = _cfgs(jt, tt, impl, True)
    m, h, b1, b2 = tcfg.n_participating, tcfg.local_iters, tcfg.b1, tcfg.b2
    jkey, tkey = jsim.experiment_key(jcfg), tengine.experiment_key(tcfg)
    p0 = jneural.params_init(jt, jcfg.seed)
    jspec = jflat_spec(p0, block=128)
    tspec = flat_spec(convert.to_torch(jax.device_get(p0)), block=128)
    for _ in range(2):
        jkey, jp, jb, jz, jc = jsim.engine.round_keys(jkey)
        tkey, tp, tb, tz, tc = tengine.round_keys(tkey, impl)
        for a, b in ((jkey, tkey), (jp, tp), (jb, tb), (jz, tz), (jc, tc)):
            np.testing.assert_array_equal(_kd(a), b.numpy())
        jidx = jsim.sample_participants(jp, jt.store.n_clients, m)
        tidx = tstore.sample_participants(tp, tt.store.n_clients, m, impl)
        np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
        jbatch = jsim.sample_batches(jt.store, jidx, jb, h, b1)
        tbatch = tstore.sample_batches(tt.store, tidx, tb, h, b1, impl)
        for k in jbatch:
            np.testing.assert_array_equal(np.asarray(jbatch[k]),
                                          tbatch[k].numpy())
        jzk = jax.vmap(lambda r: jax.random.split(r, h))(
            jax.random.split(jz, m))
        tzk = prng.split(prng.split(tz, m, impl), h, impl)
        np.testing.assert_array_equal(_kd(jzk), tzk.numpy())
        jv, jinv = jax.vmap(lambda k: jest.direction_block(
            k, jspec, b2, kind="sphere", conv="block"))(jzk[:, 0])
        tv, tinv = test_.direction_block(tzk[:, 0], tspec, b2,
                                         kind="sphere", conv="block",
                                         impl=impl)
        a = np.asarray(jv, np.float32).view(np.int32).astype(np.int64)
        b = tv.numpy().view(np.int32).astype(np.int64)
        assert np.max(np.abs(a - b)) <= NORMAL_ULPS
        np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-6)


def _reference_run(jt, jcfg, p0, rounds=ROUNDS):
    return jsim.run_experiment(jt.loss, p0, jt.store, jcfg, rounds,
                               eval_fn=jneural.task_eval(jt, TASK["n_test"]),
                               eval_every=2, donate=False)


def _close(tres, jres):
    jm, je = jax.device_get(jres.metrics), jax.device_get(jres.evals)
    assert sorted(jm) == sorted(tres.metrics)
    if "m_effective" in jm:
        np.testing.assert_array_equal(np.asarray(jm["m_effective"]),
                                      tres.metrics["m_effective"].numpy())
    for k in jm:
        np.testing.assert_allclose(tres.metrics[k].numpy(), np.asarray(jm[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(tres.evals["test_loss"].numpy(),
                               np.asarray(je["test_loss"]), rtol=RTOL,
                               atol=ATOL)
    jp, tp = jax.device_get(jres.params), convert.to_numpy(tres.params)
    for k in jp:
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("impl,aircomp", CASES)
def test_fast_sim_run_matches_reference(tasks, impl, aircomp):
    jt, tt = tasks
    jcfg, tcfg = _cfgs(jt, tt, impl, aircomp)
    p0 = jneural.params_init(jt, jcfg.seed)
    jres = _reference_run(jt, jcfg, p0)
    tres = tneural.run(tt, tcfg, ROUNDS, eval_every=2,
                       eval_rows=TASK["n_test"],
                       params=convert.to_torch(jax.device_get(p0)))
    _close(tres, jres)
    np.testing.assert_array_equal(_kd(jres.key), tres.key.numpy())


def _trees_equal(a, b):
    a, b = convert.to_numpy(a), convert.to_numpy(b)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
def test_fedserver_and_tiered_bitwise_resident(tasks, impl):
    """``FedServer`` on the store (``run_round`` and the scanned driver)
    and the tiered store are bitwise the port's resident AirComp run."""
    _, tt = tasks
    _, tcfg = _cfgs(*tasks, impl, True)
    p0 = tneural.params_init(tt, tcfg.seed)
    res = tengine.run_experiment(tt.loss, p0, tt.store, tcfg, ROUNDS)
    for driver in ("host", "scan"):
        srv = FedServer(tt.loss, p0, None, tcfg, store=tt.store)
        srv.run(ROUNDS, driver=driver)
        _trees_equal(srv.params, res.params)
        np.testing.assert_array_equal(srv._key.numpy(), res.key.numpy())
        np.testing.assert_array_equal(
            [r["mean_local_loss"] for r in srv.history],
            res.metrics["mean_local_loss"].numpy())
    host = tsim.build_host_store(tt.clients, n_buckets=3)
    tier = tsim.run_experiment(tt.loss, p0, host, tcfg, ROUNDS,
                               stream_segment=3)
    _trees_equal(tier.params, res.params)
    for k in res.metrics:
        np.testing.assert_array_equal(tier.metrics[k].numpy(),
                                      res.metrics[k].numpy(), err_msg=k)


def test_fedserver_scanned_matches_reference_fedserver(tasks):
    """The scanned driver under ``fast_sim_config`` and AirComp against
    the reference ``FedServer``'s: history rows within the tolerance."""
    from repro.fed.server import FedServer as JServer
    jt, tt = tasks
    jcfg, tcfg = _cfgs(jt, tt, "unsafe_rbg", True)
    p0 = jneural.params_init(jt, jcfg.seed)
    js = JServer(jt.loss, p0, None, jcfg, store=jt.store)
    js.run(ROUNDS, driver="scan")
    ts = FedServer(tt.loss, convert.to_torch(jax.device_get(p0)), None, tcfg,
                   store=tt.store)
    ts.run(ROUNDS, driver="scan")
    assert len(js.history) == len(ts.history) == ROUNDS
    for jr, tr in zip(js.history, ts.history):
        assert sorted(jr) == sorted(tr)
        for k, v in jr.items():
            if isinstance(v, str):
                assert tr[k] == v
            else:
                np.testing.assert_allclose(tr[k], v, rtol=RTOL, atol=ATOL,
                                           err_msg=k)


@pytest.mark.parametrize("impl,aircomp,conv", [
    ("unsafe_rbg", False, "tree"), ("unsafe_rbg", True, "tree"),
    ("rbg", False, "tree"), ("unsafe_rbg", False, "counter")])
def test_pytree_route_under_rbg_matches_reference(tasks, impl, aircomp,
                                                  conv):
    """The pytree route under 4-word keys: its client loop draws each
    client's per-leaf directions as its slice of the reference's one
    batched draw (``prng.lanes``); the counter convention reads each
    client's own key words. Against the reference within the tolerance."""
    jt, tt = tasks
    kw = dict(CFG, aircomp=aircomp, prng_impl=impl, direction_conv=conv)
    jcfg = jneural.default_config(jt, **kw)
    tcfg = tneural.default_config(tt, **kw)
    p0 = jneural.params_init(jt, jcfg.seed)
    jres = _reference_run(jt, jcfg, p0, rounds=2)
    tres = tneural.run(tt, tcfg, 2, eval_every=2, eval_rows=TASK["n_test"],
                       params=convert.to_torch(jax.device_get(p0)))
    _close(tres, jres)
