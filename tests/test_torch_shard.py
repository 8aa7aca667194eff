"""The port's sharded client fan-out (``sim/shard.py``, ``launch/mesh.py``)
and cross-silo pod round (``core/fedzo.make_pod_round_step``,
``make_delta_agg_step``) against the port's own unsharded round and
against a live JAX run.

- On a one-rank mesh the sharded round is the unsharded round bitwise, by
  construction (the reference's invariant, ``repro/sim/shard.py:11-14``):
  every aggregation branch, faults and momentum.
- Two gloo ranks, spawned on the CPU, run ``neural.run(mesh=)`` against
  the reference's 2-device host mesh (``run_subprocess(...,
  n_devices=2)``), under threefry and unsafe_rbg keys. Only the order of
  the cross-rank sum and the torch-vs-XLA float32 rounding differ, so the
  runs agree within the slices' 1e-3 (``tests/test_torch_slice.py``).
  Under unsafe_rbg a rank draws its clients' directions from the first
  key of its own shard in both packages, so the two-rank run is not the
  one-rank run.
- The pod step at ``qwen2-0.5b-smoke`` against the reference's, whose step
  reads only ``mesh.shape["pod"]`` and so runs here with a stand-in mesh
  and ``n_groups=2``; and over two spawned gloo ranks, one pod each.
"""
import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_config as jget_config
from repro.configs.base import FedZOConfig as JConfig
from repro.core import fedzo as jfedzo
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro import sim as jsim
from repro.workloads import neural as jneural
from repro_torch import sim
from repro_torch.configs import get_config
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedzo
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api
from repro_torch.sim.faults import FaultModel, RoundFaults
from repro_torch.utils import convert, prng
from repro_torch.workloads import neural
from tests.conftest import run_subprocess

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_ranks  # noqa: E402

TASK = dict(n_train=300, n_test=64, n_clients=6, n_features=24, n_classes=4)
BASE = dict(n_devices=6, n_participating=4, local_iters=2, b1=8, b2=4,
            lr=5e-3, mu=1e-3, flat_block_rows=4, weight_by_size=True)
TOL = 1e-3
SMOKE = "qwen2-0.5b-smoke"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _task():
    return neural.make_task("softmax", device="cpu", **TASK)


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


CASES = {
    "flat": dict(flat_params=True, weight_by_size=False),
    "wide": dict(batch_directions=True, weight_by_size=False),
    "mask": dict(flat_params=True, weight_by_size=False,
                 channel_schedule=True),
    "weights": dict(flat_params=True),
    "aircomp": dict(flat_params=True, aircomp=True, channel_schedule=True,
                    snr_db=5.0),
    "faults": dict(flat_params=True),
    "faults_aircomp": dict(flat_params=True, aircomp=True, snr_db=5.0),
    "momentum": dict(flat_params=True, server_momentum=0.9),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_rank_round_is_round_simulated_bitwise(case):
    task = _task()
    cfg = FedZOConfig(**{**BASE, **CASES[case]})
    M, H = cfg.n_participating, cfg.local_iters
    idx = torch.tensor([0, 2, 3, 5])
    batches = sim.sample_batches(task.store, idx, prng.key(7), H, cfg.b1)
    rngs = prng.split(prng.key(1), M)
    kw = dict(channel_rng=prng.key(2))
    if cfg.weight_by_size:
        from repro_torch.core.aircomp import size_weights
        kw["weights"] = size_weights(task.store.sizes[idx])
    if case.startswith("faults"):
        kw["faults"] = RoundFaults(
            model=FaultModel(p_corrupt=0.5),
            mask=torch.tensor([True, False, True, True]),
            corrupt=torch.tensor([False, False, True, False]))
    p0 = neural.params_init(task)
    mom = ({k: torch.zeros_like(v) for k, v in p0.items()}
           if cfg.server_momentum else None)
    rf = sim.make_sharded_round(task.loss, cfg,
                                sim.make_clients_mesh(device="cpu"))
    want = fedzo.round_simulated(task.loss, p0, batches, rngs, cfg,
                                 momentum=mom, **kw)
    got = rf(task.loss, p0, batches, rngs, cfg, momentum=mom, **kw)
    assert len(got) == len(want)
    assert _equal(got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    assert _equal(got[1], want[1]), (got[1], want[1])
    if mom is not None:
        assert _equal(got[2], want[2])
    if case.startswith("faults"):
        assert float(got[1]["m_effective"]) == 2.0    # one down, one NaN
        assert float(got[1]["m_corrupt"]) == 1.0


def test_one_rank_engine_run_is_the_unsharded_run_bitwise():
    """``neural.run(mesh=)`` through the engine, faults on: the sharded
    ``round_fn`` in every round."""
    task = _task()
    cfg = FedZOConfig(**{**BASE, "flat_params": True, "aircomp": True,
                         "channel_schedule": True})
    faults = FaultModel(p_fail=0.2, p_recover=0.5, p_corrupt=0.2)
    a = neural.run(task, cfg, 3, eval_every=0, faults=faults)
    b = neural.run(task, cfg, 3, eval_every=0, faults=faults,
                   mesh=sim.make_clients_mesh(device="cpu"))
    assert _equal(a.params, b.params)
    assert _equal(a.metrics, b.metrics)


def _jax_run(cfg_kw, mesh):
    jt = jneural.make_task("softmax", **TASK)
    res = jneural.run(jt, JConfig(**cfg_kw), 3, eval_every=0, mesh=mesh)
    return {k: np.asarray(v) for k, v in res.params.items()}


@pytest.mark.parametrize("kind", ["flat", "aircomp"])
def test_neural_run_mesh_matches_reference(kind):
    cfg_kw = {**BASE, **({"aircomp": True, "channel_schedule": True}
                         if kind == "aircomp" else {"flat_params": True}),
              "flat_params": True}
    want = _jax_run(cfg_kw, jsim.make_clients_mesh())
    got = neural.run(_task(), FedZOConfig(**cfg_kw), 3, eval_every=0,
                     mesh=sim.make_clients_mesh(device="cpu"))
    for k, w in want.items():
        np.testing.assert_allclose(got.params[k].numpy(), w, rtol=1e-4,
                                   atol=TOL)


_REF_TWO_DEVICES = """
import json, jax, numpy as np
import repro
from repro import sim
from repro.configs.base import FedZOConfig
from repro.workloads import neural
assert len(jax.devices()) == 2
task = neural.make_task("softmax", **{task})
out = []
for kw in {cfgs}:
    res = neural.run(task, FedZOConfig(**kw), 3, eval_every=0,
                     mesh=sim.make_clients_mesh())
    out.append({{k: np.asarray(v).tolist() for k, v in res.params.items()}})
print("RESULT" + json.dumps(out))
"""


def test_two_gloo_ranks_match_reference_two_device_mesh(tmp_path):
    cfgs = [{**BASE, "flat_params": True, "prng_impl": impl}
            for impl in ("threefry2x32", "unsafe_rbg")]
    out = str(tmp_path / "ranks.pt")
    tmesh.run_ranks(_torch_ranks.sharded_run, 2, backend="gloo",
                    init_dir=str(tmp_path), args=(out, TASK, cfgs, 3),
                    timeout=180)
    got = torch.load(out)
    stdout = run_subprocess(_REF_TWO_DEVICES.format(task=TASK, cfgs=cfgs),
                            n_devices=2, timeout=300)
    want = json.loads(stdout.split("RESULT", 1)[1])
    one_rank = [neural.run(_task(), FedZOConfig(**kw), 3, eval_every=0)
                for kw in cfgs]
    for kw, g, w, one in zip(cfgs, got, want, one_rank):
        for k in w:
            np.testing.assert_allclose(g["params"][k].numpy(),
                                       np.asarray(w[k], np.float32),
                                       rtol=1e-4, atol=TOL, err_msg=str(kw))
        gap = max(float((g["params"][k] - one.params[k]).abs().max())
                  for k in w)
        if kw["prng_impl"] == "threefry2x32":
            # per-key draws: the cross-rank sum's order and the half-size
            # batched forwards differ (reading 7.9e-6)
            assert gap <= TOL / 10, gap
        else:
            # the second rank's clients draw from its own first key
            # (reading 3.7e-2)
            assert gap > 10 * TOL, gap


def test_sharded_round_raises_the_reference_errors():
    task = _task()
    mesh1 = sim.make_clients_mesh(device="cpu")
    with pytest.raises(ValueError, match="flat"):
        sim.make_sharded_round(task.loss, FedZOConfig(**BASE), mesh1)
    cfg = FedZOConfig(**{**BASE, "flat_params": True})
    # a 3-rank mesh (its group is never reached: the checks come first)
    mesh3 = tmesh.Mesh(("clients",), {"clients": 3}, 0, object(),
                       torch.device("cpu"))
    with pytest.raises(ValueError, match="divide evenly"):
        sim.make_sharded_round(task.loss, cfg, mesh3, store=task.store)
    with pytest.raises(ValueError, match="exceeds the store's population"):
        sim.make_sharded_round(
            task.loss, dataclasses.replace(cfg, n_participating=9), mesh1,
            store=task.store)
    rf = sim.make_sharded_round(task.loss, cfg, mesh3)
    batches = sim.sample_batches(task.store, torch.arange(4), prng.key(7),
                                 cfg.local_iters, cfg.b1)
    rngs = prng.split(prng.key(1), 4)
    with pytest.raises(ValueError, match="divide evenly"):
        rf(task.loss, neural.params_init(task), batches, rngs, cfg)
    rf1 = sim.make_sharded_round(task.loss, cfg, mesh1)
    with pytest.raises(ValueError, match="binds loss_fn and cfg"):
        rf1(task.loss, neural.params_init(task), batches, rngs,
            dataclasses.replace(cfg, snr_db=-3.0))
    with pytest.raises(ValueError, match="binds loss_fn and cfg"):
        rf1(lambda p, b: task.loss(p, b), neural.params_init(task), batches,
            rngs, cfg)
    # the port's own: a multi-member mesh must come with a process group
    with pytest.raises(ValueError, match="process group"):
        sim.make_clients_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        sim.make_sharded_round(task.loss, cfg, tmesh.Mesh(
            ("clients",), {"clients": 2}, 0, None, torch.device("cpu")))
    assert tmesh.data_axes(tmesh.make_pod_mesh(2, device="cpu")) == ("pod",)
    assert mesh1.shape["clients"] == 1 and mesh1.axis_names == ("clients",)


# ---------------------------------------------------------------------------
# the cross-silo pod round


def _pod_inputs():
    jp = jax.device_get(japi.build(jget_config(SMOKE)).init(
        jax.random.key(0)))
    toks = jsyn.lm_token_stream(20_000, 512, seed=0)
    b = jsyn.lm_batches(toks, 4, 16, np.random.default_rng(0))
    return jp, b


@pytest.mark.parametrize("route", ["flat", "pytree"])
def test_pod_step_matches_reference(route):
    kw = dict(lr=1e-3, mu=1e-2, b2=2, flat_params=route == "flat")
    jm, tm = japi.build(jget_config(SMOKE)), api.build(get_config(SMOKE))
    jp, b = _pod_inputs()
    jstep = jax.jit(jfedzo.make_pod_round_step(
        lambda p, bb: jm.loss(p, bb, n_groups=2), JConfig(**kw),
        types.SimpleNamespace(shape={"pod": 2})))
    want_p, want_m = jstep(jp, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.key(5))
    tstep = fedzo.make_pod_round_step(
        lambda p, bb: tm.loss(p, bb, n_groups=2), FedZOConfig(**kw),
        tmesh.make_pod_mesh(2, device="cpu"))
    tp0 = convert.to_torch(jp)
    got_p, got_m = tstep(tp0, {k: torch.from_numpy(v) for k, v in b.items()},
                         prng.key(5))
    # the per-pod losses are one forward on shared weights (a few ulps)
    np.testing.assert_allclose(got_m["per_pod_loss"].numpy(),
                               np.asarray(want_m["per_pod_loss"]), rtol=2e-6)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=2e-6)
    # coefficients carry d·ulp/μ per loss ulp (17 here, test_torch_lm.py)
    np.testing.assert_allclose(float(got_m["coeff_pod_spread"]),
                               float(want_m["coeff_pod_spread"]), rtol=3e-2)
    worst, moved = 0.0, 0.0
    flat_w = jax.tree.leaves(jax.device_get(want_p))
    flat_g = [v for _, v in _leaves(got_p)]
    flat_0 = jax.tree.leaves(jp)
    for w, g, w0 in zip(flat_w, flat_g, flat_0):
        worst = max(worst, float(np.abs(g.numpy() - np.asarray(w)).max()))
        moved = max(moved, float(np.abs(np.asarray(w) - w0).max()))
    # readings: flat 9.7e-5, pytree 2.1e-4, against updates of 2.3e-3 and
    # 4.1e-3 (b2 = 2 directions average little of the coefficients' loss
    # ulps away); a zero or one-sided update cannot pass
    assert worst <= 6e-4, worst
    assert moved >= 3 * 6e-4, moved


def _leaves(tree):
    from repro_torch.utils.flatparams import _leaves as leaves
    return leaves(tree)


def test_pod_step_over_two_gloo_ranks_is_the_one_process_step(tmp_path):
    """One pod per rank: each rank's loss is its own silo's, and the
    coefficient pack is the all-reduce. Against the one-process step on
    the two silos' rows (the same grouped losses): the all-reduced pack is
    exact (zeros added), so the steps agree to the forwards' rounding."""
    jp, b = _pod_inputs()
    tp = convert.to_torch(jp)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    silos = [{k: v[2 * r:2 * r + 2] for k, v in tb.items()} for r in (0, 1)]
    cfg_kw = dict(lr=1e-3, mu=1e-2, b2=2, flat_params=True)
    out = str(tmp_path / "pod.pt")
    tmesh.run_ranks(_torch_ranks.pod_run, 2, backend="gloo",
                    init_dir=str(tmp_path),
                    args=(out, tp, silos, cfg_kw, prng.key(5)), timeout=180)
    got = torch.load(out)
    tm = api.build(get_config(SMOKE))
    want_p, want_m = fedzo.make_pod_round_step(
        lambda p, bb: tm.loss(p, bb, n_groups=2), FedZOConfig(**cfg_kw),
        tmesh.make_pod_mesh(2, device="cpu"))(tp, tb, prng.key(5))
    np.testing.assert_allclose(got["metrics"]["per_pod_loss"].numpy(),
                               want_m["per_pod_loss"].numpy(), rtol=2e-6)
    for (_, g), (_, w) in zip(_leaves(got["params"]), _leaves(want_p)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=6e-4)


def test_delta_agg_step_matches_reference():
    deltas = {"w": np.stack([np.full((64,), 1.0, np.float32),
                             np.full((64,), 3.0, np.float32)]),
              "b": np.stack([np.arange(8, dtype=np.float32),
                             -np.arange(8, dtype=np.float32)])}
    td = convert.to_torch(deltas)
    for air in (False, True):
        jcfg = JConfig(aircomp=air, snr_db=30.0)
        want = jax.jit(jfedzo.make_delta_agg_step(jcfg, 2))(
            {k: jnp.asarray(v) for k, v in deltas.items()},
            jax.random.key(0))
        got = fedzo.make_delta_agg_step(FedZOConfig(aircomp=air,
                                                    snr_db=30.0), 2)(
            td, prng.key(0))
        for k in deltas:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        fedzo.make_delta_agg_step(FedZOConfig(), 2)(td, prng.key(0))["w"],
        np.full((64,), 2.0, np.float32))
