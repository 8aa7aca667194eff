"""The port's pytree FedZO route and training CLI against live JAX runs.

- The golden configs ``softmax_counter`` (8 rounds) and ``cnn_counter`` (6
  rounds) of ``tests/golden/regen.py``, which run the reference's pytree
  route with the counter direction convention, plus the same softmax task
  on the tree convention (per-leaf keys, 3 rounds) and one pytree AirComp
  round with channel scheduling, each through both engines from the same
  weights.
- The cross-silo train step on qwen2-0.5b-smoke on the pytree route
  (``FedZOConfig()``'s default), 3 steps against JAX's jitted step.
- Both training CLIs, 2 steps each, and their checkpoints read across.

Integer draws are bitwise (the per-leaf direction keys are checked here;
participants, rows and client keys in ``tests/test_torch_slice.py``).
Floats carry a limit per config: a one-ulp loss difference between torch
and XLA moves a coefficient by scale·ulp/μ (d·1.2e-7/1e-3 = 0.012 at the
softmax task's d = 100) and the parameters by lr·0.012·|v| per iterate, and
the trajectories then drift like two runs of one algorithm under float32
rounding. Each limit stands about three times above the worst |port − JAX|
read on the CPU over that config's metrics, evals and final parameters
(relative 1e-4 throughout); the readings stand beside the limits.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sim as jsim
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.configs.base import FedZOConfig as JConfig
from repro.core import fedzo as jfedzo
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.workloads import neural as jneural
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedzo
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import api
from repro_torch.utils import convert, prng
from repro_torch.workloads import neural as tneural

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from golden.regen import _BASE_CFG, _SOFTMAX_TASK, GOLDEN  # noqa: E402

CONFIGS = {
    "softmax_counter": GOLDEN["softmax_counter"],
    "cnn_counter": GOLDEN["cnn_counter"],
    "softmax_tree": dict(task=_SOFTMAX_TASK,
                         cfg={**_BASE_CFG, "direction_conv": "tree"},
                         rounds=3),
    "softmax_aircomp_pytree": dict(
        task=_SOFTMAX_TASK, cfg={**_BASE_CFG, "aircomp": True,
                                 "snr_db": 5.0, "channel_schedule": True},
        rounds=1),
}
RTOL = 1e-4
ATOL = {
    # worst reading: params w 1.2e-4, b 8.4e-5, first_loss 5.3e-5
    "softmax_counter": 5e-4,
    # worst reading: params c2 8.9e-4, w 7.6e-4, first_loss 4.3e-4
    "cnn_counter": 3e-3,
    # worst reading: params w 1.1e-4, mean_local_loss 6.7e-5
    "softmax_tree": 5e-4,
    # worst reading: delta_max 2.6e-4, params w 1.1e-4; the Eq.-17 noise
    # scales with delta_max and so passes the drift on
    "softmax_aircomp_pytree": 1e-3,
}
SMOKE = "qwen2-0.5b-smoke"


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
    return (spec, jneural.make_task(tname, **kw),
            tneural.make_task(tname, device="cpu", **kw))


def test_tree_direction_keys_are_bitwise_equal():
    """A client's iterate keys split(rng, H) and the per-leaf direction
    keys fold_in(fold_in(key, n), i) of the tree convention."""
    rng = jax.random.split(jax.random.key(11), 3)[1]
    trng = prng.split(prng.key(11), 3)[1]
    for h, (jk, tk) in enumerate(zip(jax.random.split(rng, 2),
                                     prng.split(trng, 2))):
        for n in range(4):
            for i in range(2):
                want = jax.random.key_data(jax.random.fold_in(
                    jax.random.fold_in(jk, n), i))
                got = prng.fold_in(prng.fold_in(tk, n), i)
                np.testing.assert_array_equal(
                    np.asarray(want).astype(np.int64), got.numpy())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pytree_route_matches_reference_live(name):
    spec, jt, tt = _tasks(name)
    atol = ATOL[name]
    jcfg = jneural.default_config(jt, **spec["cfg"])
    tcfg = tneural.default_config(tt, **spec["cfg"])
    assert not tcfg.flat_params
    p0 = jneural.params_init(jt, jcfg.seed)
    n_test = spec["task"]["n_test"]
    jres = jsim.run_experiment(jt.loss, p0, jt.store, jcfg, spec["rounds"],
                               eval_fn=jneural.task_eval(jt, n_test),
                               eval_every=2, donate=False)
    ops.reset_launches()
    tres = tneural.run(tt, tcfg, spec["rounds"], eval_every=2,
                       eval_rows=n_test,
                       params=convert.to_torch(jax.device_get(p0)))
    assert all(v == 0 for v in ops.LAUNCHES.values())   # plain versions
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
    moved = 0.0
    for k in jp:
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=RTOL,
                                   atol=atol, err_msg=k)
        moved = max(moved, float(np.abs(np.asarray(jp[k])
                                        - np.asarray(p0[k])).max()))
    assert moved >= 10 * atol      # the limit is not vacuous


@pytest.mark.parametrize("flat", [False, True])
def test_local_phase_matches_reference(flat):
    """One client's H = 3 iterates (``local_phase``) on either route, from
    the same weights, batches and key: coefficients within 8 loss ulps of
    d/μ each (d = 100, as in ``tests/test_torch_tree.py``; reading 2); the
    first loss within 2 ulp (reading 1), the later ones within 2e-4 and
    the weights within 1e-3 (readings 4.8e-5 and 2.5e-4: the iterates
    carry the coefficients' ulps, lr = 5e-2), while the weights move by
    0.11 (asserted >= 10x the limit)."""
    rs = np.random.default_rng(3)
    params = {"w": rs.normal(0, 0.1, (24, 4)).astype(np.float32),
              "b": rs.normal(0, 0.1, (4,)).astype(np.float32)}
    batches = {"x": rs.normal(0, 1, (3, 16, 24)).astype(np.float32),
               "y": rs.integers(0, 4, (3, 16)).astype(np.int32)}
    kw = dict(local_iters=3, b2=4, lr=5e-2, mu=1e-3, direction_conv="counter",
              flat_params=flat, flat_block_rows=4)

    def jloss(p, b):
        logits = b["x"] @ p["w"] + p["b"]
        return jnp.mean(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
            logits, b["y"][:, None], -1)[:, 0])

    def tloss(p, b):
        logits = b["x"] @ p["w"] + p["b"]
        return torch.mean(torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, b["y"].long()[:, None])[:, 0])

    want = jfedzo.local_phase(jloss, jax.tree.map(jnp.asarray, params),
                              jax.tree.map(jnp.asarray, batches),
                              jax.random.key(5), JConfig(**kw))
    got = fedzo.local_phase(tloss, convert.to_torch(params),
                            convert.to_torch(batches), prng.key(5),
                            FedZOConfig(**kw))
    ulp = float(np.spacing(np.float32(np.max(np.asarray(want.losses)))))
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs),
                               rtol=0, atol=8 * 100 * ulp / 1e-3)
    assert abs(float(got.losses[0]) - float(want.losses[0])) <= 2 * ulp
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=0, atol=2e-4)
    moved = 0.0
    for k in params:
        np.testing.assert_allclose(got.params[k].numpy(),
                                   np.asarray(want.params[k]), rtol=0,
                                   atol=1e-3)
        moved = max(moved, float(np.abs(np.asarray(want.params[k])
                                        - params[k]).max()))
    assert moved >= 10 * 1e-3


def _path_names(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(k.key for k in path), np.asarray(leaf))
            for path, leaf in leaves]


def _get(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def test_pytree_train_step_matches_jax_three_steps():
    """qwen2-0.5b-smoke (d = 361,600), batch 2 x seq 16, b2 = 4, on the
    pytree route with the tree convention (the launcher's estimator), μ =
    1e-2 and lr = 1e-3 (a loss ulp then moves a coefficient by 17 against
    coefficients of thousands; at the launcher's μ = 1e-3 it would be 172),
    from the same weights, keys and batches. Each perturbation and update
    is one zo_axpy per leaf: 2·b2·14 calls per step, here the plain
    versions."""
    kw = dict(lr=1e-3, mu=1e-2, b2=4, estimator="sphere")
    jm, tm = japi.build(jget_config(SMOKE)), api.build(get_config(SMOKE))
    jstep = jax.jit(jfedzo.make_train_step(lambda p, b: jm.loss(p, b),
                                           JConfig(**kw)))
    tstep = fedzo.make_train_step(tm.loss, FedZOConfig(**kw))
    jp0 = jax.device_get(jm.init(jax.random.key(0)))
    jp, tp = jp0, convert.to_torch(jp0)
    jkey, tkey = jax.random.key(1), prng.key(1)
    toks = jsyn.lm_token_stream(20_000, 512, seed=0)
    rng = np.random.default_rng(0)
    losses, norms = [], []
    for _ in range(3):
        b = jsyn.lm_batches(toks, 2, 16, rng)
        jkey, jsub = jax.random.split(jkey)
        ks = prng.split(tkey, 2)
        tkey, tsub = ks[0], ks[1]
        jp, jmet = jstep(jp, {k: jnp.asarray(v) for k, v in b.items()}, jsub)
        tp, tmet = tstep(tp, {k: torch.from_numpy(v) for k, v in b.items()},
                         tsub)
        losses.append((float(jmet["loss"]), float(tmet["loss"])))
        norms.append((float(jmet["coeff_norm"]), float(tmet["coeff_norm"])))
    # readings: step 1's loss 1 ulp apart (one forward on shared weights);
    # later losses 5.5e-5 and 1.3e-5 apart (the parameter drift)
    assert abs(losses[0][0] - losses[0][1]) <= 8 * np.spacing(
        np.float32(losses[0][0]))
    for j, t in losses:
        assert abs(j - t) <= 5e-4
    # coefficient norms: a few loss ulps of 17 each against norms of
    # thousands (readings: relative 7.8e-3, 1.2e-2, 1.9e-3)
    for j, t in norms:
        assert abs(j - t) <= 3e-2 * j
    # parameters: reading 3.2e-4 after step 3 while the updates move a
    # weight by up to 1.9e-2 (asserted >= 10x the limit)
    worst, moved = 0.0, 0.0
    init = dict(_path_names(jp0))
    for name, want in _path_names(jax.device_get(jp)):
        worst = max(worst, float(np.abs(_get(tp, name).numpy()
                                        - want).max()))
        moved = max(moved, float(np.abs(want - init[name]).max()))
    assert worst <= 1e-3
    assert moved >= 10 * 1e-3


def test_training_clis_agree_and_read_each_others_checkpoints(
        tmp_path, monkeypatch, capsys):
    """``repro.launch.train`` and ``repro_torch.launch.train --device cpu``
    with the same flags, 2 steps of qwen2-0.5b-smoke at the launcher's
    defaults (μ = 1e-3, lr = 1e-4, b2 = 8): the same printed lines up to
    the losses, histories within 1e-4 (readings: 1 ulp at step 1, 1.6e-5
    at step 2) and final weights within 5e-4 (reading 1.2e-4). Each
    package then resumes from the other's final checkpoint, one step."""
    common = ["--steps", "2", "--log-every", "1"]
    monkeypatch.setattr(sys, "argv",
                        ["train", *common, "--out", str(tmp_path / "j")])
    jtrain.main()
    jout = capsys.readouterr().out.splitlines()
    res = ttrain.main([*common, "--device", "cpu", "--out",
                       str(tmp_path / "t")])
    tout = capsys.readouterr().out.splitlines()
    assert jout[0] == tout[0]       # arch, size, algo, lr, b2
    assert [ln.split()[:2] for ln in jout[1:]] == \
        [ln.split()[:2] for ln in tout[1:]]
    jhist = __import__("json").load(open(tmp_path / "j" / "history.json"))
    thist = __import__("json").load(open(tmp_path / "t" / "history.json"))
    assert thist["arch"] == jhist["arch"] and thist["algo"] == "fedzo"
    assert thist["loss"] == res.history
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=0,
                               atol=1e-4)
    assert len(res.step_ms) == 2 and all(
        r == {k: 0 for k in ops.LAUNCHES} for r in res.launches)
    jfinal = np.load(tmp_path / "j" / "final" / "params.npz")
    tfinal = np.load(tmp_path / "t" / "final" / "params.npz")
    assert sorted(jfinal.files) == sorted(tfinal.files)
    assert max(float(np.abs(jfinal[k] - tfinal[k]).max())
               for k in jfinal.files) <= 5e-4

    # the port resumes from the reference's checkpoint, and the reverse
    res = ttrain.main(["--steps", "1", "--log-every", "1", "--device",
                       "cpu", "--resume", str(tmp_path / "j" / "final")])
    out = capsys.readouterr().out
    assert "@ step 2" in out and "step     2" in out
    assert np.isfinite(res.history).all()
    like = japi.build(jget_config(SMOKE)).init(jax.random.key(0))
    restored, step = jckpt.restore(str(tmp_path / "t" / "final"), like)
    assert step == 2
    for name, want in _path_names(jax.device_get(restored)):
        np.testing.assert_array_equal(
            want, tfinal["".join(f"['{k}']" for k in name.split("/"))])
    back, step = tckpt.restore(str(tmp_path / "t" / "final"), res.params)
    assert step == 2


def test_cli_rejects_first_order_training(monkeypatch):
    """First-order training runs (``tests/test_torch_fedavg.py``); the CLI
    rejects the algorithms and optimizers it does not have, as the
    reference's argument parser does."""
    for argv in (["--algo", "fedprox"], ["--algo", "fedavg", "--opt",
                                         "lamb"]):
        with pytest.raises(SystemExit):
            ttrain.main([*argv, "--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["train", *argv])
        with pytest.raises(SystemExit):
            jtrain.main()
