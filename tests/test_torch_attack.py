"""The paper's federated black-box attack (Sec. V-A) in the port:
``models/simple.py``'s CIFAR-shaped CNN and CW objective,
``workloads/attack.py`` and the scenario sweep (``sim/sweep.py``), against
the live reference.

The forward pieces (``cnn_logits``, ``cw_attack_loss``,
``attack_success``) on the reference's trained classifier, converted,
agree within float32 reordering (relative 1e-5 on logits and losses; the
success rate exactly). Attack runs through the engine start from the
reference's classifier and shards and stay within the ZO trajectory
tolerance of ``tests/test_torch_strategy.py`` (losses and evals within
1e-3; the perturbation, which moves by only about 1.4e-3, within 1e-4:
readings beside the limits).
The port's own ``make_task`` trains its classifier with torch autograd on
the reference's row draws: its clean accuracy lies within 5 points of the
reference's. A sweep record is bitwise its scenario's single run; the CSV
has the reference's rows and columns. Sizes: 400 training images, 96
attack images on 5 uneven clients, M = 3, H = 2, b1 = 8, b2 = 4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.models import simple as jsimple
from repro.workloads import attack as jattack
from repro_torch.models import simple as tsimple
from repro_torch.sim import build_store
from repro_torch.utils import convert
from repro_torch.workloads import attack as tattack

ATTACK_KW = dict(n_train=400, n_attack=96, n_clients=5, train_steps=60)
RUN = dict(local_iters=2, b2=4, b1=8, n_participating=3, seed=7)
# losses and evals within the trajectory tolerance 1e-3 (readings 3e-6);
# the perturbation moves by about 1.4e-3 in 3 rounds at lr 1e-3, so it is
# held to PERT_ATOL = 1e-4 (readings: pytree 2.8e-5, flat 3.3e-5) and must
# move at least ten times that
ATOL = 1e-3
PERT_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the port's CPU path is many small ops, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tasks():
    """The reference's task and the port's task built from it: the same
    classifier (converted), shards and evaluation images."""
    jt = jattack.make_task(**ATTACK_KW)
    tt = tattack.AttackTask(
        classifier=convert.to_torch(jax.device_get(jt.classifier)),
        clients=jt.clients, store=build_store(jt.clients, device="cpu"),
        eval_batch=convert.to_torch(jax.device_get(jt.eval_batch)),
        clean_accuracy=jt.clean_accuracy)
    return jt, tt


def test_forward_pieces_match_reference(tasks):
    """Logits of the clean images, the CW loss and the success rate of a
    random perturbation, the training loss: the reference's within
    float32 reordering."""
    jt, tt = tasks
    rng = np.random.default_rng(3)
    pert = rng.normal(0, 0.5, (tattack.D,)).astype(np.float32)
    jb = jax.device_get(jt.eval_batch)
    np.testing.assert_allclose(
        tsimple.cnn_logits(tt.classifier, tt.eval_batch["x"]).numpy(),
        np.asarray(jsimple.cnn_logits(jt.classifier, jb["x"])), rtol=1e-5,
        atol=1e-5)
    for c in (0.3, 1.0):
        np.testing.assert_allclose(
            float(tsimple.cw_attack_loss(torch.from_numpy(pert),
                                         tt.eval_batch, tt.classifier, c=c)),
            float(jsimple.cw_attack_loss(pert, jb, jt.classifier, c=c)),
            rtol=1e-5)
    assert float(tsimple.attack_success(torch.from_numpy(pert),
                                        tt.eval_batch, tt.classifier)) == \
        float(jsimple.attack_success(pert, jb, jt.classifier))
    np.testing.assert_allclose(
        float(tsimple.cnn_loss(tt.classifier, tt.eval_batch)),
        float(jsimple.cnn_loss(jt.classifier, jb)), rtol=1e-5)


@pytest.mark.parametrize("route", ["pytree", "flat"])
def test_attack_run_matches_reference(tasks, route):
    """3 rounds of the attack with the in-run eval every round: the
    perturbation, the losses and the eval curve within the tolerance
    above, the success rate within one image of the 96."""
    jt, tt = tasks
    over = dict(RUN, **(dict(flat_params=True, flat_block_rows=4)
                        if route == "flat" else {}))
    jres = jattack.run(jt, jattack.default_config(jt, **over), 3,
                       eval_every=1, donate=False)
    tres = tattack.run(tt, tattack.default_config(tt, **over), 3,
                       eval_every=1)
    np.testing.assert_allclose(tres.params["x"].numpy(),
                               np.asarray(jres.params["x"]), rtol=0,
                               atol=PERT_ATOL)
    assert np.abs(tres.params["x"].numpy()).max() > 10 * PERT_ATOL
    jm, je = jax.device_get(jres.metrics), jax.device_get(jres.evals)
    np.testing.assert_allclose(tres.metrics["mean_local_loss"].numpy(),
                               jm["mean_local_loss"], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tres.metrics["m_effective"].numpy(),
                                  jm["m_effective"])
    np.testing.assert_allclose(tres.evals["eval_cw_loss"].numpy(),
                               je["eval_cw_loss"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(tres.evals["attack_success"].numpy(),
                               je["attack_success"], rtol=0,
                               atol=1 / 96 + 1e-6)
    assert [r["round"] for r in tres.history()] == [0, 1, 2]


def test_make_task_trains_like_the_reference(tasks):
    """The port's ``make_task`` (torch autograd, the reference's row
    draws, 60 SGD steps): the same shard sizes where the correct sets
    agree, and a clean accuracy within 5 points of the reference's."""
    jt, _ = tasks
    own = tattack.make_task(**ATTACK_KW, device="cpu")
    assert abs(own.clean_accuracy - jt.clean_accuracy) <= 0.05
    assert own.store.n_clients == 5
    assert sum(len(c["y"]) for c in own.clients) == ATTACK_KW["n_attack"]
    assert own.eval_batch["x"].shape == (96, 32, 32, 3)


def test_sweep_records_equal_single_runs_and_csv(tasks, tmp_path):
    """``attack.run_sweep`` over SNR {0, 20} dB × seeds {0, 1}: each
    record is bitwise its scenario's own ``attack.run``; the CSV has the
    reference sweep's rows (scenario, round, metric) in its order; the
    noisier scenarios report the larger AirComp noise."""
    jt, tt = tasks
    kw = dict(snr_dbs=(0.0, 20.0), seeds=(0, 1), rounds=2, eval_every=1)
    out = tmp_path / "t.csv"
    recs = tattack.run_sweep(tt, tattack.default_config(tt, **RUN),
                             out_csv=str(out), **kw)
    assert [r["scenario"] for r in recs] == [
        {"snr_db": s, "seed": k} for s in (0.0, 20.0) for k in (0, 1)]
    base = dataclasses.replace(tattack.default_config(tt, **RUN),
                               aircomp=True)
    one = tattack.run(tt, dataclasses.replace(base, snr_db=20.0, seed=1), 2,
                      eval_every=1)
    for k, v in one.metrics.items():
        np.testing.assert_array_equal(recs[3]["metrics"][k], v.numpy(),
                                      err_msg=k)
    for k, v in one.evals.items():
        np.testing.assert_array_equal(recs[3]["evals"][k], v.numpy(),
                                      err_msg=k)
    jout = tmp_path / "j.csv"
    jattack.run_sweep(jt, jattack.default_config(jt, **RUN),
                      out_csv=str(jout), **kw)
    rows = [ln.rsplit(",", 1)[0] for ln in out.read_text().splitlines()]
    jrows = [ln.rsplit(",", 1)[0] for ln in jout.read_text().splitlines()]
    assert rows == jrows and rows[0] == "scenario,round,metric"
    lo = np.mean([r["metrics"]["aircomp_noise_std"].mean() for r in recs
                  if r["scenario"]["snr_db"] == 0.0])
    hi = np.mean([r["metrics"]["aircomp_noise_std"].mean() for r in recs
                  if r["scenario"]["snr_db"] == 20.0])
    assert lo > hi > 0


def test_sweep_scenarios_differ_by_snr(tasks):
    """The dynamic SNR field reaches the channel: -10 dB reports more
    AirComp noise than 20 dB (the reference's sweep check, on the
    attack's shards)."""
    _, tt = tasks
    from repro_torch.sim.sweep import run_sweep
    base = tattack.default_config(tt, **RUN, aircomp=True)
    recs = run_sweep(tattack.attack_loss(tt), tattack.pert_init("cpu"),
                     tt.store, base, [{"snr_db": -10.0}, {"snr_db": 20.0}],
                     2)
    lo = recs[0]["metrics"]["aircomp_noise_std"].mean()
    hi = recs[1]["metrics"]["aircomp_noise_std"].mean()
    assert lo > hi > 0
