"""The port's whole flat FedZO slice against a live JAX run of the same
config: the golden configs ``softmax_flat`` and ``softmax_aircomp``
(``tests/golden/regen.py``) and a 3-round SmallCNN flat config, both
packages started from the same weights.

Integer draws (participants, minibatch rows, channel masks, ZO keys) are
equal. Floats are held to a tolerance derived from the ZO coefficient
(``tests/test_torch_flat.py``): a one-ulp loss difference between torch and
XLA moves a coefficient by d·ulp/μ ≈ 0.012 (d ≈ 100, μ = 1e-3) and the
parameters by lr·0.012·|v| per iterate, and the trajectories then drift
apart like two runs of one algorithm under float32 rounding. Each config
has its own absolute limit (relative 1e-4 throughout), about three times
the worst |port − JAX| measured on the CPU over its metrics, evals and
final parameters; the readings stand beside each limit.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sim as jsim
from repro.core import aircomp as jair
from repro.workloads import neural as jneural
from repro_torch.core import aircomp as tair
from repro_torch.sim import engine as tengine
from repro_torch.sim import store as tstore
from repro_torch.utils import convert, prng
from repro_torch.workloads import neural as tneural

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from golden.regen import _BASE_CFG, _CNN_TASK, GOLDEN  # noqa: E402

CONFIGS = {
    "softmax_flat": GOLDEN["softmax_flat"],
    "softmax_aircomp": GOLDEN["softmax_aircomp"],
    "cnn_flat": dict(task=_CNN_TASK,
                     cfg={**_BASE_CFG, "lr": 2e-2, "flat_params": True,
                          "flat_block_rows": 4}, rounds=3),
}
RTOL = 1e-4
ATOL = {
    # worst reading: params w 1.5e-4, first_loss 1.0e-4
    "softmax_flat": 5e-4,
    # worst reading: delta_max 9.5e-4, test_loss 5.3e-4, params w 3.8e-4;
    # the Eq.-17 noise scales with delta_max and so passes the drift on
    "softmax_aircomp": 2e-3,
    # worst reading: params c2 6.7e-4, w 6.0e-4
    "cnn_flat": 2e-3,
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path is thousands of small tensor ops. One intra-op
    thread runs them as fast, and leaves the other test workers' cores
    alone: eight threads per op wait on each other when the cores are
    shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tasks(name):
    spec = CONFIGS[name]
    kw = dict(spec["task"])
    tname = kw.pop("name")
    jt = jneural.make_task(tname, **kw)
    tt = tneural.make_task(tname, device="cpu", **kw)
    return spec, jt, tt


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_round_draws_are_bitwise_equal(name):
    """Participants, minibatch rows and data, client ZO keys and channel
    masks of every round, from the same key chain."""
    spec, jt, tt = _tasks(name)
    jcfg = jneural.default_config(jt, **spec["cfg"])
    m, h, b1 = jcfg.n_participating, jcfg.local_iters, jcfg.b1
    jkey, tkey = jsim.experiment_key(jcfg), tengine.experiment_key(jcfg)
    for _ in range(spec["rounds"]):
        jkey, jp, jb, jz, jc = jsim.engine.round_keys(jkey)
        tkey, tp, tb, tz, tc = tengine.round_keys(tkey)
        for a, b in ((jkey, tkey), (jz, tz), (jc, tc)):
            np.testing.assert_array_equal(
                np.asarray(jax.random.key_data(a)).astype(np.int64),
                b.numpy())
        jidx = jsim.sample_participants(jp, jt.store.n_clients, m)
        tidx = tstore.sample_participants(tp, tt.store.n_clients, m)
        np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
        jbatch = jsim.sample_batches(jt.store, jidx, jb, h, b1)
        tbatch = tstore.sample_batches(tt.store, tidx, tb, h, b1)
        for k in jbatch:
            np.testing.assert_array_equal(np.asarray(jbatch[k]),
                                          tbatch[k].numpy())
        ksched = jax.random.split(jc)[0]
        _, jmask = jair.schedule_by_channel(ksched, m, jcfg.h_min)
        _, tmask = tair.schedule_by_channel(
            prng.split(tc, 2)[0], m, jcfg.h_min)
        np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
        jzk = jax.vmap(lambda r: jax.random.split(r, h))(
            jax.random.split(jz, m))
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jzk)).astype(np.int64),
            prng.split(prng.split(tz, m), h).numpy())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slice_matches_reference_live(name):
    spec, jt, tt = _tasks(name)
    atol = ATOL[name]
    jcfg = jneural.default_config(jt, **spec["cfg"])
    tcfg = tneural.default_config(tt, **spec["cfg"])
    p0 = jneural.params_init(jt, jcfg.seed)
    n_test = spec["task"]["n_test"]
    jres = jsim.run_experiment(jt.loss, p0, jt.store, jcfg, spec["rounds"],
                               eval_fn=jneural.task_eval(jt, n_test),
                               eval_every=2, donate=False)
    tres = tneural.run(tt, tcfg, spec["rounds"], eval_every=2,
                       eval_rows=n_test,
                       params=convert.to_torch(jax.device_get(p0)))
    jm, je = jax.device_get(jres.metrics), jax.device_get(jres.evals)
    assert sorted(jm) == sorted(tres.metrics)
    np.testing.assert_array_equal(np.asarray(jm["m_effective"]),
                                  tres.metrics["m_effective"].numpy())
    for k in jm:
        np.testing.assert_allclose(tres.metrics[k].numpy(), np.asarray(jm[k]),
                                   rtol=RTOL, atol=atol, err_msg=k)
    np.testing.assert_array_equal(jres.eval_rounds, tres.eval_rounds)
    np.testing.assert_allclose(tres.evals["test_loss"].numpy(),
                               np.asarray(je["test_loss"]), rtol=RTOL,
                               atol=atol)
    # accuracy: a near-tied prediction may flip under one ulp of a logit;
    # allow one test row
    np.testing.assert_allclose(tres.evals["test_acc"].numpy(),
                               np.asarray(je["test_acc"]), rtol=0,
                               atol=1.5 / n_test)
    jp, tp = jax.device_get(jres.params), convert.to_numpy(tres.params)
    for k in jp:
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=RTOL,
                                   atol=atol, err_msg=k)


def test_main_path_full_width_one_round_matches_reference():
    """One round of the card's main path (softmax 784x10 on 50 clients,
    FedZOConfig defaults: M=10, H=5, b1=25, b2=20; the default 512-row
    geometry, n_pad = 65,536) on the CPU. Measured: |Δparams| 1.3e-5,
    |Δmean_local_loss| 7.3e-6; the limit is 5e-5. From the zero init the
    update is the whole of the parameters, max |w| 1.1e-2 and max |b|
    1.9e-3: each leaf must reach ten times the limit, so a kernel that left
    the parameters in place could not pass."""
    atol = 5e-5
    from repro.configs.base import FedZOConfig as JConfig
    from repro_torch.configs.base import FedZOConfig as TConfig
    kw = dict(n_features=784, n_classes=10, n_clients=50)
    cfg = dict(flat_params=True, weight_by_size=True)
    jt = jneural.make_task("softmax", **kw)
    tt = tneural.make_task("softmax", device="cpu", **kw)
    jres = jsim.run_experiment(jt.loss, jneural.params_init(jt), jt.store,
                               JConfig(**cfg), 1, donate=False)
    tres = tneural.run(tt, TConfig(**cfg), 1, eval_every=0)
    jm = jax.device_get(jres.metrics)
    for k in jm:
        np.testing.assert_allclose(tres.metrics[k].numpy(), np.asarray(jm[k]),
                                   rtol=RTOL, atol=atol, err_msg=k)
    jp, tp = jax.device_get(jres.params), convert.to_numpy(tres.params)
    for k in jp:
        assert np.abs(np.asarray(jp[k])).max() >= 10 * atol, k
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=RTOL,
                                   atol=atol, err_msg=k)


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tneural.make_task("softmax", n_train=40, n_test=8, n_clients=2,
                          n_features=4, n_classes=2)
    from repro_torch.models import simple as tsimple
    clients = [{"x": np.zeros((3, 2), np.float32),
                "y": np.zeros(3, np.int32)}]
    for call in (lambda: tstore.build_store(clients),
                 lambda: tsimple.softmax_init(4, 2),
                 lambda: tsimple.smallcnn_init(prng.key(0), (8, 8, 1), 2,
                                               2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_unported_routes_raise():
    """The routes the port does not have raise; the wide-only conventions
    without ``batch_directions`` and flat coordinate directions raise the
    reference's ValueError. Every registered strategy, a seed-compressed
    config and a wireless channel model (with and without faults) build a
    round step (they are ported); an unknown strategy raises the
    reference's ValueError."""
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.sim import ChannelModel, FaultModel
    for kw in (dict(direction_conv="surrogate"),
               dict(direction_conv="channel"),
               dict(flat_params=True, estimator="coordinate")):
        with pytest.raises((NotImplementedError, ValueError)):
            tengine.make_round_step(lambda p, b: 0.0, FedZOConfig(**kw))
    cm = ChannelModel(rho=0.5, battery=2.0)
    assert callable(tengine.make_round_step(
        lambda p, b: 0.0, FedZOConfig(channel_model=cm)))
    assert callable(tengine.make_round_step(
        lambda p, b: 0.0, FedZOConfig(channel_model=cm, flat_params=True),
        faults=FaultModel(p_fail=0.1)))
    for kw in (dict(delta_compression="seed"),
               dict(batch_directions=True, delta_compression="seed")):
        assert callable(tengine.make_round_step(lambda p, b: 0.0,
                                                FedZOConfig(**kw)))
    for algo in ("fedzo", "fedavg", "fedprox", "feddyn", "scaffold"):
        assert callable(tengine.make_round_step(lambda p, b: 0.0, FedZOConfig(
            flat_params=True, strategy=algo)))
    with pytest.raises(ValueError, match="unknown strategy"):
        tengine.make_round_step(lambda p, b: 0.0, FedZOConfig(
            flat_params=True, strategy="fedsgd"))
    for impl in ("rbg", "unsafe_rbg"):
        with pytest.raises(NotImplementedError, match="prng_impl"):
            tengine.experiment_key(FedZOConfig(prng_impl=impl))


def test_port_imports_neither_jax_nor_the_reference():
    """Import every module of the port with jax and repro made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 15
