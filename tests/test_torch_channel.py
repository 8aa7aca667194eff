"""The wireless scenario in the port (``sim/channel.py``, the widened key
chain and the energy columns) against the live reference.

The chain is integer fixed point (Q.14 fading, Q.12 coefficients, Q.16
batteries, an exact integer |h|² against the h_min threshold), so
everything it decides is held bitwise: ``init_key``, the CN(0, 1)
innovation, the ρ = 0 advance as the i.i.d. draw, a 10-round ρ > 0 chain,
``step``'s masks and battery debits, the 5/6/7-way round key layouts, and
the fault and channel states of engine runs. Engine runs under the channel
are held to the reference within the ZO trajectory tolerance 1e-3 of
``tests/test_torch_strategy.py``; their ``m_effective`` (and so the energy
column) is equal. Sizes: softmax 24×4 on 6 clients, M = 3, H = 2, b1 = 8,
b2 = 4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import hypothesis, st
import repro  # noqa: F401
from repro import sim as jsim
from repro.configs.base import FedZOConfig as JConfig
from repro.sim import channel as jchannel
from repro.sim import engine as jengine
from repro.sim import faults as jfaults
from repro.workloads import neural as jneural
from repro_torch.configs.base import FedZOConfig
from repro_torch.sim import channel as tchannel
from repro_torch.sim import engine as tengine
from repro_torch.sim.channel import ChannelModel
from repro_torch.sim.faults import FaultModel
from repro_torch.utils import convert, prng
from repro_torch.workloads import neural as tneural

hypothesis.settings.register_profile(
    "torch_channel", deadline=None, max_examples=10,
    suppress_health_check=list(hypothesis.HealthCheck))

TASK = dict(n_train=320, n_test=96, n_clients=6, n_features=24, n_classes=4,
            alpha=0.5)
BASE = dict(n_devices=6, n_participating=3, local_iters=2, b1=8, b2=4,
            lr=5e-2, mu=1e-3, seed=11, channel_schedule=True, h_min=0.3)
ATOL = 1e-3
NORMS, NORM_RTOL = ("delta_max", "aircomp_noise_std"), 5e-3


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


def _same_state(t_state, j_state):
    for a, b in zip(t_state, j_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _models(**kw):
    return jchannel.ChannelModel(**kw), ChannelModel(**kw)


# ---------------------------------------------------------------------------
# the chain, bitwise


@hypothesis.settings(hypothesis.settings.get_profile("torch_channel"))
@hypothesis.given(st.integers(0, 10_000), st.integers(1, 40))
def test_init_key_and_innovation_bitwise(seed, n):
    """``init_key`` folds the reference's salt; the Irwin–Hall innovation
    (24 words per component, integer sum and shifts) is the reference's
    int32 ``[n, 2]``; ρ = 0 advances to that draw itself."""
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(
        tchannel.init_key(tk).numpy(),
        np.asarray(jax.random.key_data(jchannel.init_key(jk))))
    jm, tm = _models(rho=0.0)
    w = tm._innovation(tk, n)
    assert w.dtype == torch.int32
    np.testing.assert_array_equal(w.numpy(),
                                  np.asarray(jm._innovation(jk, n)))
    h = tm._innovation(prng.key(seed + 1), n)
    assert torch.equal(tm.advance(tk, h), w)


@pytest.mark.parametrize("rho", [0.3, 0.9])
def test_ten_round_chain_bitwise(rho):
    """10 rounds of ``step`` on N = 10 with M = 4, scheduling and battery
    gating: the fading and battery states, the cohort fading and the
    transmit masks equal the reference's every round."""
    jm, tm = _models(rho=rho, battery=3.0, tx_cost=1.0)
    js = jm.init_state(10, jchannel.init_key(jax.random.key(4)))
    ts = tm.init_state(10, tchannel.init_key(prng.key(4)))
    _same_state(ts, js)
    idx = np.array([2, 9, 0, 5])
    masked = 0
    for t in range(10):
        jk, tk = jax.random.key(50 + t), prng.key(50 + t)
        js, jrc = jm.step(jk, js, jnp.asarray(idx), h_min=0.6, schedule=True)
        ts, trc = tm.step(tk, ts, torch.tensor(idx), h_min=0.6,
                          schedule=True)
        _same_state(ts, js)
        np.testing.assert_array_equal(trc.mask.numpy(), np.asarray(jrc.mask))
        np.testing.assert_array_equal(trc.h.numpy(), np.asarray(jrc.h))
        masked += 4 - int(trc.mask.sum())
    assert 0 < masked < 40
    np.testing.assert_array_equal(tchannel.battery(ts).numpy(),
                                  np.asarray(jchannel.battery(js)))
    np.testing.assert_array_equal(tchannel.fading(ts).numpy(),
                                  np.asarray(jchannel.fading(js)))


def test_step_masks_and_battery_debits():
    """Scheduled ∧ charged clients pay ``tx_cost``, the others keep their
    charge, drained clients are masked out (the reference's drill, both
    packages side by side)."""
    jm, tm = _models(rho=0.0, battery=1.5, tx_cost=1.0)
    js = jm.init_state(6, jchannel.init_key(jax.random.key(0)))
    ts = tm.init_state(6, tchannel.init_key(prng.key(0)))
    idx = [0, 2, 4]
    for t, want in ((1, [True] * 3), (2, [False] * 3)):
        js, jrc = jm.step(jax.random.key(t), js, jnp.asarray(idx), h_min=0.3,
                          schedule=False)
        ts, trc = tm.step(prng.key(t), ts, torch.tensor(idx), h_min=0.3,
                          schedule=False)
        _same_state(ts, js)
        assert trc.mask.tolist() == want == np.asarray(jrc.mask).tolist()
    batt = tchannel.battery(ts).numpy()
    np.testing.assert_array_equal(batt, [0.5, 1.5, 0.5, 1.5, 0.5, 1.5])
    assert float(trc.m_transmitting) == 0.0


def test_validation_and_describe():
    """The reference's ValueErrors and derived fields."""
    for kw in (dict(rho=1.0), dict(rho=-0.1), dict(tx_cost=0.0),
               dict(battery=4e4)):
        with pytest.raises(ValueError):
            ChannelModel(**kw)
    with pytest.raises(ValueError):
        ChannelModel.from_doppler(-1.0)
    assert ChannelModel.from_doppler(0.01).rho == \
        jchannel.ChannelModel.from_doppler(0.01).rho
    for kw in (dict(rho=0.37), dict(rho=0.9, battery=2.0, tx_cost=0.5)):
        jm, tm = _models(**kw)
        assert tm.describe() == jm.describe()
        assert tm.gated == jm.gated


def test_round_key_layouts_bitwise():
    """``split_round_keys``: the 5-way chain without faults or channel,
    6-way with faults, 6- or 7-way with the channel stream last; every
    key the reference's."""
    jk, tk = jax.random.key(9), prng.key(9)
    for faults, channel in ((False, False), (True, False), (False, True),
                            (True, True)):
        jks = jengine.split_round_keys(jk, faults=faults, channel=channel)
        tks = tengine.split_round_keys(tk, faults=faults, channel=channel)
        for a, b in zip(jks, tks):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(
                    b.numpy(), np.asarray(jax.random.key_data(a)))
    base = tengine.round_keys(tk)
    for a, b in zip(base, tengine.split_round_keys(tk)[:5]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine under the channel, against the reference


def _runs(tasks, rounds, *, faults=None, **kw):
    jt, tt, p0 = tasks
    cm = kw.pop("channel_model")
    cfg = {**BASE, **kw}
    jres = jsim.run_experiment(
        jt.loss, p0, jt.store,
        JConfig(**cfg, channel_model=jchannel.ChannelModel(**cm)), rounds,
        donate=False,
        faults=jfaults.FaultModel(**faults) if faults else None)
    tres = tengine.run_experiment(
        tt.loss, convert.to_torch(p0), tt.store,
        FedZOConfig(**cfg, channel_model=ChannelModel(**cm)), rounds,
        faults=FaultModel(**faults) if faults else None)
    return jres, tres


def _close(jres, tres):
    jm = jax.device_get(jres.metrics)
    assert sorted(jm) == sorted(tres.metrics)
    for k, v in jm.items():
        got = tres.metrics[k].numpy()
        if k in ("m_effective", "m_corrupt"):
            np.testing.assert_array_equal(got, v, err_msg=k)
        elif k in NORMS:
            np.testing.assert_allclose(got, v, rtol=NORM_RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=0, atol=ATOL, err_msg=k)
    jp, tp = _flat(jax.device_get(jres.params)), _flat(tres.params)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    _same_state(tres.channel_state, jres.channel_state)


@pytest.mark.parametrize("route", ["flat_aircomp", "pytree"])
def test_engine_with_channel_matches_reference(tasks, route):
    """5 rounds under a correlated, energy-gated channel: the chain's
    final state bitwise, ``m_effective`` equal every round, the weights
    and losses within 1e-3."""
    over = (dict(flat_params=True, flat_block_rows=4, aircomp=True,
                 snr_db=5.0) if route == "flat_aircomp"
            else dict(direction_conv="counter", weight_by_size=True))
    jres, tres = _runs(tasks, 5, channel_model=dict(
        rho=0.85, battery=2.0, tx_cost=1.0), **over)
    _close(jres, tres)
    assert tres.metrics["m_effective"].min() < 3


def test_faults_compose_with_channel(tasks):
    """Faults and the channel together (the 7-way chain): both final
    states bitwise, the surviving counts equal, weights within 1e-3."""
    jres, tres = _runs(
        tasks, 5, faults=dict(p_fail=0.2, p_recover=0.5, p_corrupt=0.2),
        channel_model=dict(rho=0.6, battery=5.0, tx_cost=1.0),
        flat_params=True, flat_block_rows=4)
    _close(jres, tres)
    np.testing.assert_array_equal(tres.fault_state.numpy(),
                                  np.asarray(jres.fault_state))


def test_energy_ledger_columns(tasks):
    """The ledger prices each effective transmission at ``tx_cost``: the
    history rows' ``energy_spent`` equal the reference's, the ledger's
    manifest block its; an ungated model adds no column."""
    jres, tres = _runs(tasks, 3, channel_model=dict(
        rho=0.5, battery=5.0, tx_cost=2.0), flat_params=True,
        flat_block_rows=4)
    jrows, trows = jsim.history(jres), tengine.history(tres)
    assert [r["energy_spent"] for r in trows] == \
        [r["energy_spent"] for r in jrows]
    assert all(r["energy_spent"] == 2.0 * r["m_effective"] for r in trows)
    assert tres.ledger.manifest() == jres.ledger.manifest()
    jres, tres = _runs(tasks, 1, channel_model=dict(rho=0.5),
                       flat_params=True, flat_block_rows=4)
    assert "energy_spent" not in tengine.history(tres)[0]
