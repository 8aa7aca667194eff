"""The batched scenario sweep (``sim.run_sweep``: one round loop over an
``[S, M]`` cohort per static group) against the reference's vmapped
sweep, live.

A ``{seed} × {snr_db}`` grid with AirComp on 8 softmax clients (M = 4,
H = 2, b2 = 4), every scenario's records held to the reference sweep's
within the trajectory tolerance of ``tests/test_torch_slice.py``:

- under threefry (the wide and flat routes), where the vmapped draws are
  per key, so the records also equal the port's own single runs;
- under unsafe_rbg and rbg (``fast_sim_config``), where the reference's
  vmap makes every bit draw one batched draw from the first scenario's
  key: scenarios after the first are NOT their single runs, in the
  reference and in the port alike, and seeds ≥ 1 are checked too.

Plus: the dynamic fields lr, μ and h_min reach their rows; the launch count
of the batched AirComp aggregation (one ``aircomp_reduce`` and one
``zo_walk`` per scenario and round, counted on the CPU as the dispatch
reaches the plain version); fedprox, feddyn, scaffold and fedavg groups
under rbg and unsafe_rbg keys as one batched loop, every scenario against
the reference sweep; the groups the batched loop does not cover.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable, as runs do)
from repro import sim as jsim
from repro.workloads import neural as jneural
from repro_torch import sim as tsim
from repro_torch.kernels import ops as kops
from repro_torch.utils import convert
from repro_torch.workloads import neural as tneural

TASK = dict(n_train=320, n_test=64, n_clients=8, n_features=24, n_classes=4,
            alpha=0.5)
CFG = dict(n_participating=4, local_iters=2, b1=8, b2=4, lr=5e-2, mu=1e-3,
           seed=11, aircomp=True)
ROUNDS = 3
# the AirComp trajectory tolerance of tests/test_torch_slice.py: the Eq.-17
# noise scales with delta_max and passes its drift on (worst readings here:
# delta_max 1.3e-3, mean_local_loss 1.1e-4, test_loss 7.5e-5)
ATOL, RTOL = 2e-3, 1e-4
GRID = dict(seed=(0, 1, 2), snr_db=(0.0, 20.0))


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


def _cfgs(jt, tt, route, impl):
    kw = dict(CFG, **({"flat_params": True, "flat_block_rows": 4}
                      if route == "flat" else {}),
              **({"local_iters": 1} if route == "pytree" else {}))
    jcfg = jneural.default_config(jt, **kw)
    tcfg = tneural.default_config(tt, **kw)
    if route == "wide":
        jcfg, tcfg = jsim.fast_sim_config(jcfg), tsim.fast_sim_config(tcfg)
    return (dataclasses.replace(jcfg, prng_impl=impl),
            dataclasses.replace(tcfg, prng_impl=impl))


def _sweeps(tasks, route, impl, grid=GRID):
    jt, tt = tasks
    jcfg, tcfg = _cfgs(jt, tt, route, impl)
    p0 = jneural.params_init(jt, 0)
    scen = jsim.scenario_grid(**grid)
    jrecs = jsim.run_sweep(jt.loss, p0, jt.store, jcfg, scen, ROUNDS,
                           eval_fn=jneural.task_eval(jt, TASK["n_test"]),
                           eval_every=2)
    trecs = tsim.run_sweep(tt.loss, convert.to_torch(jax.device_get(p0)),
                           tt.store, tcfg, scen, ROUNDS,
                           eval_fn=tneural.task_eval(tt, TASK["n_test"]),
                           eval_every=2)
    return jrecs, trecs, tcfg, p0


def _records_close(trec, jrec, exact_m=True):
    assert trec["scenario"] == jrec["scenario"]
    assert sorted(trec["metrics"]) == sorted(jrec["metrics"])
    if exact_m:
        np.testing.assert_array_equal(trec["metrics"]["m_effective"],
                                      np.asarray(jrec["metrics"]
                                                 ["m_effective"]))
    for k, v in jrec["metrics"].items():
        np.testing.assert_allclose(trec["metrics"][k], np.asarray(v),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{trec['scenario']} {k}")
    np.testing.assert_array_equal(trec["eval_rounds"], jrec["eval_rounds"])
    assert sorted(trec["evals"]) == sorted(jrec["evals"])
    for k in ("test_loss",) if jrec["evals"] else ():
        np.testing.assert_allclose(trec["evals"][k],
                                   np.asarray(jrec["evals"][k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("route", ["wide", "flat"])
def test_threefry_sweep_matches_reference_and_single_runs(tasks, route):
    jrecs, trecs, tcfg, p0 = _sweeps(tasks, route, "threefry2x32")
    assert len(trecs) == len(jrecs) == 6
    for t, j in zip(trecs, jrecs):
        _records_close(t, j)
    # under threefry a record is its scenario's own run
    _, tt = tasks
    sc = trecs[-1]["scenario"]
    one = tneural.run(tt, dataclasses.replace(tcfg, **sc), ROUNDS,
                      eval_every=2, eval_rows=TASK["n_test"],
                      params=convert.to_torch(jax.device_get(p0)))
    for k, v in one.metrics.items():
        np.testing.assert_allclose(trecs[-1]["metrics"][k], v.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("route,impl", [("wide", "unsafe_rbg"),
                                        ("wide", "rbg"),
                                        ("pytree", "unsafe_rbg")])
def test_rbg_sweep_matches_reference_every_scenario(tasks, route, impl):
    """Every scenario, seeds ≥ 1 included, is the reference sweep's record
    (on the pytree route the S·M clients' loop and the per-scenario
    AirComp noise draw as rows of the vmap); and a seed-1 scenario is not
    its single run (the batched draw runs from scenario 0's key)."""
    jrecs, trecs, tcfg, p0 = _sweeps(tasks, route, impl)
    for t, j in zip(trecs, jrecs):
        _records_close(t, j)
    _, tt = tasks
    sc = trecs[2]["scenario"]
    assert sc["seed"] == 1
    one = tneural.run(tt, dataclasses.replace(tcfg, **sc), ROUNDS,
                      eval_every=0, params=convert.to_torch(
                          jax.device_get(p0)))
    assert not np.allclose(trecs[2]["metrics"]["mean_local_loss"],
                           one.metrics["mean_local_loss"].numpy(),
                           rtol=0, atol=1e-6)


def test_dynamic_fields_reach_their_rows(tasks):
    """lr, μ and h_min per scenario (with channel scheduling), under
    unsafe_rbg on the wide route, against the reference sweep."""
    jt, tt = tasks
    grid = dict(lr=(5e-2, 1e-2), mu=(1e-3, 5e-3), h_min=(0.2, 0.6))
    jcfg, tcfg = _cfgs(jt, tt, "wide", "unsafe_rbg")
    jcfg = dataclasses.replace(jcfg, channel_schedule=True)
    tcfg = dataclasses.replace(tcfg, channel_schedule=True)
    p0 = jneural.params_init(jt, 0)
    scen = jsim.scenario_grid(**grid)
    jrecs = jsim.run_sweep(jt.loss, p0, jt.store, jcfg, scen, ROUNDS)
    trecs = tsim.run_sweep(tt.loss, convert.to_torch(jax.device_get(p0)),
                           tt.store, tcfg, scen, ROUNDS)
    assert len(trecs) == 8
    for t, j in zip(trecs, jrecs):
        _records_close(t, j)
    effs = {r["scenario"]["h_min"]: r["metrics"]["m_effective"].sum()
            for r in trecs}
    assert effs[0.2] > effs[0.6]


@pytest.mark.parametrize("impl", ["threefry2x32", "unsafe_rbg"])
def test_channel_model_sweep_matches_reference(tasks, impl):
    """A wireless scenario (a static ``ChannelModel``, energy-gated, with
    channel scheduling) sweeps as one batched group: each scenario's chain
    starts from its fold-in key and advances from its row of the round's
    channel keys; every record against the reference sweep's."""
    from repro.sim import channel as jchannel
    from repro_torch.sim import channel as tchannel
    jt, tt = tasks
    jcfg, tcfg = _cfgs(jt, tt, "wide", impl)
    cm = dict(rho=0.8, battery=2.0, tx_cost=1.0)
    jcfg = dataclasses.replace(jcfg, channel_schedule=True, h_min=0.3,
                               channel_model=jchannel.ChannelModel(**cm))
    tcfg = dataclasses.replace(tcfg, channel_schedule=True, h_min=0.3,
                               channel_model=tchannel.ChannelModel(**cm))
    p0 = jneural.params_init(jt, 0)
    scen = jsim.scenario_grid(seed=(0, 1), snr_db=(0.0, 20.0))
    jrecs = jsim.run_sweep(jt.loss, p0, jt.store, jcfg, scen, ROUNDS)
    trecs = tsim.run_sweep(tt.loss, convert.to_torch(jax.device_get(p0)),
                           tt.store, tcfg, scen, ROUNDS)
    for t, j in zip(trecs, jrecs):
        _records_close(t, j)
    # the batteries gate: some round transmits fewer than M
    assert min(r["metrics"]["m_effective"].min() for r in trecs) < 4


def test_aircomp_launches_once_per_scenario_and_round(tasks):
    """The batched group aggregates each scenario on its own: S·R
    ``aircomp_reduce`` and S·R ``zo_walk`` dispatches, and no other ZO
    kernel on the wide route (the directions are Philox draws on the
    host's CPU here, one ``philox_bits`` call per iterate)."""
    _, tt = tasks
    _, tcfg = _cfgs(*tasks, "wide", "unsafe_rbg")
    counted = {"aircomp_reduce": 0, "zo_walk": 0, "philox_bits": 0}
    orig = {k: getattr(kops, k) for k in counted}

    def counting(name):
        def f(*a, **kw):
            counted[name] += 1
            return orig[name](*a, **kw)
        return f

    scen = tsim.scenario_grid(**GRID)
    try:
        for k in counted:
            setattr(kops, k, counting(k))
        tsim.run_sweep(tt.loss, tneural.params_init(tt, 0), tt.store, tcfg,
                       scen, ROUNDS)
    finally:
        for k, f in orig.items():
            setattr(kops, k, f)
    S = len(scen)
    assert counted["aircomp_reduce"] == S * ROUNDS
    assert counted["zo_walk"] == S * ROUNDS
    # per round: H direction blocks, and the host's integer draws
    assert counted["philox_bits"] >= tcfg.local_iters * ROUNDS


# each strategy on both routes, and each route under both rbg impls
STRATEGY_CASES = [("fedprox", "wide", "unsafe_rbg"),
                  ("fedprox", "flat", "rbg"),
                  ("feddyn", "wide", "rbg"),
                  ("feddyn", "flat", "unsafe_rbg"),
                  ("scaffold", "wide", "unsafe_rbg"),
                  ("scaffold", "flat", "rbg"),
                  ("fedavg", "wide", "rbg"),
                  ("fedavg", "flat", "unsafe_rbg")]
STRATEGY_KW = {"fedprox": dict(prox_mu=0.1), "feddyn": dict(dyn_alpha=0.05),
               "scaffold": {}, "fedavg": dict(lr=0.1)}


@pytest.mark.parametrize("strategy,route,impl", STRATEGY_CASES)
def test_strategy_sweep_matches_reference_under_rbg(tasks, strategy, route,
                                                    impl):
    """A hooked or stateful strategy's group under rbg keys runs as ONE
    batched loop over the ``[S·M]`` cohort (each scenario's loss wrap on
    its own rows of one cohort forward, its own client state, delta
    transform and server step; FedAvg's S·M SGD phases side by side, the
    lr per row), and every scenario's records, over ``{seed} × {lr}``,
    are the reference sweep's (``jax.vmap`` over the scenarios, its rbg
    draws one batched draw); integer records bitwise. Worst readings over
    the cases: delta_max 2.21e-3 on 2.53 (feddyn, flat, the third round;
    its first round 5.3e-4, FedZO's own first round at lr 5e-2 3.7e-4: a
    loss ulp's d·ulp/μ carried through the rounds), 8e-4 in every other
    case; losses 1.5e-4; FedAvg 3e-8."""
    jt, tt = tasks
    jcfg, tcfg = _cfgs(jt, tt, route, impl)
    kw = dict(strategy=strategy, **STRATEGY_KW[strategy])
    jcfg = dataclasses.replace(jcfg, **kw)
    tcfg = dataclasses.replace(tcfg, **kw)
    p0 = jneural.params_init(jt, 0)
    scen = jsim.scenario_grid(seed=(0, 1), lr=(tcfg.lr, 0.4 * tcfg.lr))
    jrecs = jsim.run_sweep(jt.loss, p0, jt.store, jcfg, scen, ROUNDS)
    trecs = tsim.run_sweep(tt.loss, convert.to_torch(jax.device_get(p0)),
                           tt.store, tcfg, scen, ROUNDS)
    assert len(trecs) == 4
    for t, j in zip(trecs, jrecs):
        assert t["strategy"] == j["strategy"] == strategy
        _records_close(t, j)


def test_unbatched_groups(tasks):
    """A strategy with hooks runs as the batched loop: under threefry its
    records are its single runs bitwise (on the CPU), and under rbg keys
    it runs (it raised before that was ported); a strategy of a class the
    batched loop does not know runs scenario by scenario under threefry
    and raises under rbg keys; momentum is rejected."""
    from repro_torch.core import strategy as tstrategy
    _, tt = tasks
    _, tcfg = _cfgs(*tasks, "wide", "threefry2x32")
    p0 = tneural.params_init(tt, 0)
    scen = [{"seed": 0}, {"seed": 1}]
    pcfg = dataclasses.replace(tcfg, strategy="fedprox", prox_mu=0.1)
    recs = tsim.run_sweep(tt.loss, p0, tt.store, pcfg, scen, 2)
    one = tsim.run_experiment(tt.loss, p0, tt.store,
                              dataclasses.replace(pcfg, seed=1), 2)
    np.testing.assert_array_equal(recs[1]["metrics"]["mean_local_loss"],
                                  one.metrics["mean_local_loss"].numpy())
    rbg = dataclasses.replace(pcfg, prng_impl="unsafe_rbg")
    assert tsim.sweep.batchable(rbg, tstrategy.get("fedprox"))
    assert len(tsim.run_sweep(tt.loss, p0, tt.store, rbg, scen, 1)) == 2

    class Custom(tstrategy.ZOFedProx):
        name = "custom"

    assert not tsim.sweep.batchable(pcfg, Custom())

    custom = tsim.run_sweep(tt.loss, p0, tt.store, pcfg, scen, 2,
                            strategy=Custom())
    np.testing.assert_array_equal(custom[1]["metrics"]["mean_local_loss"],
                                  one.metrics["mean_local_loss"].numpy())
    with pytest.raises(NotImplementedError, match="custom"):
        tsim.run_sweep(tt.loss, p0, tt.store, rbg, scen, 1,
                       strategy=Custom())
    with pytest.raises(ValueError, match="momentum-free"):
        tsim.run_sweep(tt.loss, p0, tt.store,
                       dataclasses.replace(tcfg, server_momentum=0.9),
                       scen, 1)
