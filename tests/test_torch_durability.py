"""Durable checkpointed runs in the port (``checkpoint.save_run_state``
and friends, the engine's segment runner) against the reference.

Within the port everything is bitwise: k-round segments ≡ the single-shot
run, and a run killed after a segment and resumed ≡ the single-shot run,
with faults, the wireless channel and SCAFFOLD's state in the carry. A
snapshot the reference wrote (its npz names, the key as two uint32 words,
its metrics ring) resumes in the port, and the continuation lies within
the ZO trajectory tolerance 1e-3 of the reference's own single-shot run
(``tests/test_torch_strategy.py``). Divergence rolls back with the lr
backed off and ends in ``DivergenceError``, with the reference's event
rows. Sizes: softmax 24×4 on 6 clients, M = 3, H = 2, b1 = 8, b2 = 4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sim as jsim
from repro.configs.base import FedZOConfig as JConfig
from repro.data.synthetic import make_classification, noniid_shards
from repro.sim import channel as jchannel
from repro.sim import faults as jfaults
from repro.workloads import neural as jneural
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import FedZOConfig
from repro_torch.sim import build_store
from repro_torch.sim import engine as tengine
from repro_torch.sim.channel import ChannelModel
from repro_torch.sim.faults import DivergenceError, FaultModel
from repro_torch.utils import convert
from repro_torch.workloads import neural as tneural

TASK = dict(n_train=320, n_test=96, n_clients=6, n_features=24, n_classes=4,
            alpha=0.5)
BASE = dict(n_devices=6, n_participating=3, local_iters=2, b1=8, b2=4,
            lr=5e-2, mu=1e-3, seed=11)
FAULTS = dict(p_fail=0.2, p_recover=0.5, p_corrupt=0.2)
CHANNEL = dict(rho=0.8, battery=4.0, tx_cost=1.0)
CASES = {
    "flat_faults_channel": (dict(flat_params=True, flat_block_rows=4,
                                 channel_schedule=True, h_min=0.3,
                                 channel=True), True, "fedzo"),
    "pytree_scaffold": (dict(direction_conv="counter"), False, "scaffold"),
    "flat_aircomp_eval": (dict(flat_params=True, flat_block_rows=4,
                               aircomp=True, snr_db=5.0), False, "fedzo"),
}
ATOL = 1e-3


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
    jt = jneural.make_task("softmax", **TASK)
    tt = tneural.make_task("softmax", device="cpu", **TASK)
    return jt, tt, jax.device_get(jneural.params_init(jt, 11))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _bitequal_results(a, b):
    for x, y in ((a.params, b.params), (a.metrics, b.metrics),
                 (a.evals, b.evals)):
        fx, fy = _flat(x), _flat(y)
        assert sorted(fx) == sorted(fy)
        for k in fx:
            np.testing.assert_array_equal(fx[k], fy[k], err_msg=k)
    for x, y in ((a.fault_state, b.fault_state),
                 (a.channel_state, b.channel_state)):
        assert (x is None) == (y is None)
        if x is not None:
            for u, v in zip(x if isinstance(x, tuple) else (x,),
                            y if isinstance(y, tuple) else (y,)):
                assert torch.equal(u, v)
    if a.strategy_state is not None:
        fx, fy = _flat(a.strategy_state), _flat(b.strategy_state)
        for k in fx:
            np.testing.assert_array_equal(fx[k], fy[k], err_msg=k)
    assert torch.equal(a.key, b.key)


def _cfg(case):
    kw, faults, name = CASES[case]
    kw = dict(kw)
    cm = ChannelModel(**CHANNEL) if kw.pop("channel", False) else None
    return FedZOConfig(**BASE, **kw, channel_model=cm), (
        FaultModel(**FAULTS) if faults else None), name


def _run(tasks, case, rounds, **kw):
    _, tt, p0 = tasks
    cfg, faults, name = _cfg(case)
    ev = (dict(eval_fn=tneural.task_eval(tt, 96), eval_every=2)
          if case == "flat_aircomp_eval" else {})
    return tengine.run_experiment(tt.loss, convert.to_torch(p0), tt.store,
                                  cfg, rounds, strategy=name, faults=faults,
                                  **ev, **kw)


# ---------------------------------------------------------------------------
# the snapshot files


def test_save_run_state_pointer_and_retention(tmp_path):
    """Five saves keep the newest three, ``LATEST`` names the last, and
    the round, meta and arrays (a tuple, None parts, the key's words) read
    back."""
    d = str(tmp_path)
    state = {"params": {"w": torch.arange(4.0)}, "momentum": None,
             "key": np.array([1, 2], np.uint32),
             "cstate": (torch.ones(3, 2, dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int32))}
    for r in range(5):
        ckpt.save_run_state(d, state, round_idx=r, meta={"lr": 0.1 * r})
    assert ckpt._snapshots(d) == ["round_00000002", "round_00000003",
                                  "round_00000004"]
    latest = ckpt.latest_run_state(d)
    assert latest.endswith("round_00000004")
    with np.load(os.path.join(latest, "state.npz")) as z:
        assert sorted(z.files) == ["['cstate'][0]", "['cstate'][1]",
                                   "['key']", "['params']['w']"]
        assert z["['key']"].dtype == np.uint32
    like = {"params": {"w": torch.zeros(4)}, "momentum": None,
            "key": torch.zeros(2, dtype=torch.int64),
            "cstate": (torch.zeros(3, 2, dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32))}
    back, meta = ckpt.restore_run_state(latest, like)
    assert meta["round"] == 4 and meta["lr"] == pytest.approx(0.4)
    assert torch.equal(back["params"]["w"], torch.arange(4.0))
    assert back["key"].tolist() == [1, 2] and back["momentum"] is None
    assert torch.equal(back["cstate"][0], state["cstate"][0])
    assert ckpt.read_sidecar(latest)["meta"]["round"] == 4


def test_stale_tmp_debris_and_latest_fallback(tmp_path):
    """A killed writer's ``*.tmp.*`` directory is ignored and swept by the
    next save; without a ``LATEST`` pointer the highest complete round is
    the latest; an empty directory has none."""
    d = str(tmp_path)
    assert ckpt.latest_run_state(d) is None
    state = {"params": {"w": torch.zeros(2)}}
    ckpt.save_run_state(d, state, round_idx=1)
    os.makedirs(os.path.join(d, "round_00000009.tmp.123"))
    assert ckpt.latest_run_state(d).endswith("round_00000001")
    ckpt.save_run_state(d, state, round_idx=2)
    assert not any(".tmp" in e for e in os.listdir(d))
    os.remove(os.path.join(d, "LATEST"))
    assert ckpt.latest_run_state(d).endswith("round_00000002")


# ---------------------------------------------------------------------------
# chunked, killed and resumed runs


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_and_resumed_equal_single_shot(tasks, case, tmp_path):
    """6 rounds in 2-round segments ≡ the single-shot run; killed after 2
    segments (``max_segments=2``) and resumed ≡ the single-shot run; both
    bitwise in parameters, metrics, evals, key and the fault, channel and
    strategy carries."""
    one = _run(tasks, case, 6)
    chunked = _run(tasks, case, 6, checkpoint_every=2,
                   checkpoint_dir=str(tmp_path / "a"))
    _bitequal_results(one, chunked)
    d = str(tmp_path / "b")
    part = _run(tasks, case, 6, checkpoint_every=2, checkpoint_dir=d,
                max_segments=2)
    assert part.rounds == 4
    resumed = _run(tasks, case, 6, checkpoint_every=2, checkpoint_dir=d,
                   resume=True)
    assert resumed.rounds == 6
    _bitequal_results(one, resumed)
    assert [r["round"] for r in resumed.history()] == list(range(6))


def test_reference_snapshot_resumes_in_the_port(tasks, tmp_path):
    """The reference runs 2 of 6 rounds (faults and channel on) and
    leaves its snapshot; the port resumes it and finishes the run: the
    fault and channel states bitwise the reference's single-shot run's,
    ``m_effective`` and ``m_corrupt`` equal, weights and losses within
    1e-3."""
    jt, tt, p0 = tasks
    kw = dict(BASE, flat_params=True, flat_block_rows=4,
              channel_schedule=True, h_min=0.3)
    jcfg = JConfig(**kw, channel_model=jchannel.ChannelModel(**CHANNEL))
    jf = jfaults.FaultModel(**FAULTS)
    d = str(tmp_path)
    jsim.run_experiment(jt.loss, p0, jt.store, jcfg, 6, donate=False,
                        faults=jf, checkpoint_every=2, checkpoint_dir=d,
                        max_segments=1)
    jone = jsim.run_experiment(jt.loss, p0, jt.store, jcfg, 6, donate=False,
                               faults=jf)
    tres = tengine.run_experiment(
        tt.loss, convert.to_torch(p0), tt.store,
        FedZOConfig(**kw, channel_model=ChannelModel(**CHANNEL)), 6,
        faults=FaultModel(**FAULTS), checkpoint_every=2, checkpoint_dir=d,
        resume=True)
    assert tres.rounds == 6
    np.testing.assert_array_equal(tres.fault_state.numpy(),
                                  np.asarray(jone.fault_state))
    for a, b in zip(tres.channel_state, jone.channel_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jm = jax.device_get(jone.metrics)
    assert sorted(jm) == sorted(tres.metrics)
    for k, v in jm.items():
        got = tres.metrics[k].numpy()
        if k in ("m_effective", "m_corrupt"):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=0, atol=ATOL, err_msg=k)
    jp, tp = _flat(jax.device_get(jone.params)), _flat(tres.params)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=ATOL,
                                   err_msg=k)


def _explosive(pkg_jax):
    """A loss that overflows at lr 1e6 within one local phase and descends
    at a small lr (the reference's divergence trigger)."""
    x, y = make_classification(320, 4, 2, seed=1)
    clients = noniid_shards(x, y, 8)
    if pkg_jax:
        return (lambda p, b: jnp.exp(jnp.sum(jnp.square(p["x"] - 0.1))),
                {"x": jnp.zeros((4,), jnp.float32)}, jsim.build_store(clients))
    return (lambda p, b: torch.exp(torch.sum(torch.square(p["x"] - 0.1))),
            {"x": torch.zeros(4)}, build_store(clients, device="cpu"))


def test_rollback_and_exhaustion_with_events(tmp_path):
    """lr 1e6: the first segment diverges, rolls back to the round-0
    anchor with lr·1e-8 and the run finishes finite, with the reference's
    event rows; with a backoff of 1 the retries run out in
    ``DivergenceError`` at round 2."""
    cfg = dict(n_devices=8, n_participating=4, local_iters=2, lr=1e6,
               mu=1e-3, b1=8, b2=4, seed=3)
    loss, p0, st = _explosive(True)
    jres = jsim.run_experiment(loss, p0, st, JConfig(**cfg), 4,
                               checkpoint_every=2, donate=False,
                               checkpoint_dir=str(tmp_path / "j"),
                               max_retries=3, lr_backoff=1e-8)
    loss, p0, st = _explosive(False)
    tres = tengine.run_experiment(loss, p0, st, FedZOConfig(**cfg), 4,
                                  checkpoint_every=2,
                                  checkpoint_dir=str(tmp_path / "t"),
                                  max_retries=3, lr_backoff=1e-8)
    assert tres.rounds == 4
    assert tres.events == jres.events
    assert [e["event"] for e in tres.events] == ["rollback"]
    assert np.isfinite(tres.params["x"].numpy()).all()
    hist = tres.history()
    assert [(h["round"], h.get("event")) for h in hist] == \
        [(h["round"], h.get("event")) for h in jsim.history(jres)]
    assert tres.manifest["events"] == tres.events
    with pytest.raises(DivergenceError) as ei:
        tengine.run_experiment(loss, p0, st, FedZOConfig(**cfg), 4,
                               checkpoint_every=2,
                               checkpoint_dir=str(tmp_path / "x"),
                               max_retries=2, lr_backoff=1.0)
    assert ei.value.retries == 2 and ei.value.round == 2


def test_resume_under_different_config_warns(tasks, tmp_path):
    """Resuming a snapshot of another config warns (the config hash of
    the sidecar); resuming a finished run is a no-op."""
    d = str(tmp_path)
    _run(tasks, "flat_aircomp_eval", 2, checkpoint_every=2, checkpoint_dir=d)
    done = _run(tasks, "flat_aircomp_eval", 2, checkpoint_every=2,
                checkpoint_dir=d, resume=True)
    assert done.rounds == 2
    _, tt, p0 = tasks
    cfg, _, _ = _cfg("flat_aircomp_eval")
    with pytest.warns(UserWarning, match="DIFFERENT config"):
        tengine.run_experiment(
            tt.loss, convert.to_torch(p0), tt.store,
            FedZOConfig(**{**BASE, "lr": 1e-2}, flat_params=True,
                        flat_block_rows=4, aircomp=True, snr_db=5.0), 2,
            checkpoint_every=2, checkpoint_dir=d, resume=True,
            eval_fn=tneural.task_eval(tt, 96), eval_every=2)
    assert cfg.lr == BASE["lr"]


def test_checkpoint_every_requires_dir(tasks):
    """``checkpoint_every`` without ``checkpoint_dir``: the reference's
    ValueError."""
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _run(tasks, "flat_aircomp_eval", 2, checkpoint_every=1)
