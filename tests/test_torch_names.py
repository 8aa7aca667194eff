"""The public names the port adds beside the reference's: each against its
reference counterpart, live.

- ``workloads.neural.run_sweep`` (reference ``neural.py:193``);
- ``core.estimator.estimate`` and ``two_point_estimate`` (reference
  ``estimator.py:346-358``);
- ``sim.engine.make_experiment_fn`` (reference ``engine.py:451``), which
  ``FedServer``'s scanned driver calls, as the reference's does;
- ``kernels/ref.py``: the reference's oracle names, bound to the plain
  versions the CUDA kernels are held against.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable, as runs do)
from repro import sim as jsim
from repro.core import estimator as jest
from repro.kernels import ref as jref
from repro.workloads import neural as jneural
from repro_torch import sim as tsim
from repro_torch.core import estimator as test_
from repro_torch.fed import server as tserver
from repro_torch.kernels import flash_attention, rmsnorm, zo_aircomp
from repro_torch.kernels import ref as tref
from repro_torch.kernels import zo_axpy
from repro_torch.sim import engine as tengine
from repro_torch.utils import convert, prng
from repro_torch.workloads import neural as tneural

TASK = dict(n_train=240, n_test=48, n_clients=6, n_features=16, n_classes=3,
            alpha=0.5)
CFG = dict(n_participating=3, local_iters=2, b1=8, b2=4, lr=5e-2, mu=1e-3,
           seed=5, flat_params=True, flat_block_rows=4)
ATOL, RTOL = 1e-3, 1e-4


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


def test_kernels_ref_names_are_the_plain_versions():
    ref_names = sorted(n for n, f in vars(jref).items()
                       if n.endswith("_ref") and inspect.isfunction(f))
    assert sorted(tref.__all__) == ref_names
    assert tref.axpy2_ref is zo_axpy.zo_axpy2_plain
    assert tref.axpy_ref is zo_axpy.zo_axpy_plain
    assert tref.zo_walk_ref is zo_axpy.zo_walk_plain
    assert tref.zo_replay_ref is zo_axpy.zo_replay_plain
    assert tref.zo_dirnorms_ref is zo_axpy.zo_dirnorms_plain
    assert tref.aircomp_reduce_ref is zo_aircomp.aircomp_reduce_plain
    assert tref.rmsnorm_ref is rmsnorm.rmsnorm_plain
    assert tref.attention_ref is flash_attention.flash_attention_plain


def _quad():
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(5, 3)).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(np.float32)}
    target = {k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p.items()}

    def jloss(params, batch):
        return sum(jnp.sum((params[k] - target[k]) ** 2) for k in params) \
            * batch["s"]

    def tloss(params, batch):
        return sum(torch.sum((params[k] - torch.from_numpy(target[k])) ** 2)
                   for k in params) * batch["s"]

    return p, jloss, tloss


@pytest.mark.parametrize("kind", ["sphere", "gaussian", "rademacher"])
def test_estimate_and_two_point_estimate(kind):
    """The same directions (bitwise keys, normals within ulps) and
    coefficients: a loss ulp moves a coefficient by d·ulp/μ, so the loss
    is scaled near 1 and μ is 1e-2 (readings within 3e-4)."""
    p, jloss, tloss = _quad()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    key = jax.random.key(3)
    for jfn, tfn, kw in (
            (jest.estimate, test_.estimate, dict(b2=6)),
            (jest.two_point_estimate, test_.two_point_estimate, {})):
        jg = jfn(jloss, jp, {"s": jnp.float32(0.05)}, key, mu=1e-2,
                 kind=kind, **kw)
        tg = tfn(tloss, tp, {"s": torch.tensor(0.05)}, prng.key(3),
                 mu=1e-2, kind=kind, **kw)
        for k in p:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-3, atol=1e-3, err_msg=k)


def test_neural_run_sweep_matches_reference(tasks, tmp_path):
    jt, tt = tasks
    scen = [{"seed": 0, "lr": 5e-2}, {"seed": 1, "lr": 2e-2}]
    jcfg = jneural.default_config(jt, **CFG)
    tcfg = tneural.default_config(tt, **CFG)
    jrecs = jneural.run_sweep(jt, jcfg, scen, 2, eval_every=1, eval_rows=48,
                              out_csv=str(tmp_path / "j.csv"))
    trecs = tneural.run_sweep(tt, tcfg, scen, 2, eval_every=1, eval_rows=48,
                              out_csv=str(tmp_path / "t.csv"))
    for t, j in zip(trecs, jrecs):
        assert t["scenario"] == j["scenario"]
        for k, v in j["metrics"].items():
            np.testing.assert_allclose(t["metrics"][k], np.asarray(v),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(t["evals"]["test_loss"],
                                   np.asarray(j["evals"]["test_loss"]),
                                   rtol=RTOL, atol=ATOL)
    rows = [ln.rsplit(",", 1)[0] for ln in
            (tmp_path / "t.csv").read_text().splitlines()]
    jrows = [ln.rsplit(",", 1)[0] for ln in
             (tmp_path / "j.csv").read_text().splitlines()]
    assert rows == jrows


def test_make_experiment_fn_matches_reference(tasks):
    """The function's eight outputs against the reference's compiled one,
    and ``FedServer(..., store=).run(driver="scan")`` calling it."""
    jt, tt = tasks
    jcfg = jneural.default_config(jt, **CFG)
    tcfg = tneural.default_config(tt, **CFG)
    p0 = jneural.params_init(jt, jcfg.seed)
    jfn = jsim.make_experiment_fn(jt.loss, jcfg, 3, donate=False)
    tfn = tsim.make_experiment_fn(tt.loss, tcfg, 3)
    jout = jfn(p0, None, jsim.experiment_key(jcfg), None, None, None,
               jt.store)
    tout = tfn(convert.to_torch(jax.device_get(p0)), None,
               tengine.experiment_key(tcfg), None, None, None, tt.store)
    assert len(jout) == len(tout) == 8
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jout[2])).astype(np.int64),
        tout[2].numpy())
    for k, v in jax.device_get(jout[6]).items():
        np.testing.assert_allclose(tout[6][k].numpy(), np.asarray(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k, v in jax.device_get(jout[0]).items():
        np.testing.assert_allclose(tout[0][k].numpy(), np.asarray(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)

    calls = []
    orig = tengine.make_experiment_fn

    def spy(*a, **kw):
        calls.append(a[2])
        return orig(*a, **kw)

    tengine.make_experiment_fn = spy
    try:
        srv = tserver.FedServer(tt.loss, tneural.params_init(tt, tcfg.seed),
                                None, tcfg, store=tt.store)
        srv.run(3, driver="scan")
        srv.run(3, driver="scan")       # cached per round count
    finally:
        tengine.make_experiment_fn = orig
    assert calls == [3]
    assert len(srv.history) == 6
