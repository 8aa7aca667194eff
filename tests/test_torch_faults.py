"""Fault injection in the port (``sim/faults.py`` and the ``faults=`` hook
of every round) against the live reference.

Bitwise where the arithmetic is integer or exact: the availability chain
and the corruption draws (Threefry words, float32 compares of bitwise
uniforms); the straggler masks (the exponential latencies agree within an
ulp, ``torch.log1p`` against XLA's; no latency of these seeds lies within
an ulp of its deadline); scrubbed rows (exact zeros, poisoned rows filled,
the pad-residue row rejected by its norm over all ``n_pad`` columns);
poisoned ≡ masked on every route. A guarded row norm is a float32 sum in
another order than XLA's, so a ``guard_norm`` compare could flip within
ulps of the threshold; the tests keep every norm far from it. Faulted
engine runs are held to the reference within the ZO trajectory tolerance
1e-3 of ``tests/test_torch_strategy.py`` (a one-ulp loss difference moves
a coefficient by d·ulp/μ ≈ 0.012), with the same masks. Sizes: softmax
24×4 on 6 clients, M = 3, H = 2, b1 = 8, b2 = 4.
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
from repro.core import fedavg as jfedavg
from repro.fed.server import FedServer as JServer
from repro.sim import faults as jfaults
from repro.workloads import neural as jneural
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedavg, fedzo
from repro_torch.fed.server import FedServer
from repro_torch.sim import engine as tengine
from repro_torch.sim.faults import FaultModel, RoundFaults
from repro_torch.sim.store import sample_batches, sample_participants
from repro_torch.utils import convert, prng
from repro_torch.workloads import neural as tneural

hypothesis.settings.register_profile(
    "torch_faults", deadline=None, max_examples=8,
    suppress_health_check=list(hypothesis.HealthCheck))

TASK = dict(n_train=320, n_test=96, n_clients=6, n_features=24, n_classes=4,
            alpha=0.5)
BASE = dict(n_devices=6, n_participating=3, local_iters=2, b1=8, b2=4,
            lr=5e-2, mu=1e-3, seed=11)
ROUTES = {"pytree": dict(direction_conv="counter"),
          "flat": dict(flat_params=True, flat_block_rows=4),
          "wide": dict(batch_directions=True, direction_conv="block"),
          "aircomp": dict(flat_params=True, flat_block_rows=4, aircomp=True,
                          snr_db=10.0)}
FAULTS = dict(p_fail=0.3, p_recover=0.5, deadline=1.5, straggler_mean=1.0,
              p_corrupt=0.3, corrupt_mode="nan")
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


def _bitequal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _round_inputs(tt, p0, cfg, seed=5):
    """(params, batches, rngs) of one round of the port, from a seed."""
    ks = prng.split(prng.key(seed), 3)
    idx = sample_participants(ks[0], tt.store.n_clients, cfg.n_participating)
    batches = sample_batches(tt.store, idx, ks[1], cfg.local_iters, cfg.b1)
    return convert.to_torch(p0), batches, prng.split(ks[2], cfg.n_participating)


def _rf(model, mask, corrupt):
    return RoundFaults(model=model, mask=torch.tensor(mask),
                       corrupt=torch.tensor(corrupt))


# ---------------------------------------------------------------------------
# the chain and the draws


def test_availability_chain_and_draws_bitwise():
    """``advance`` and ``step`` over 12 rounds of N = 10 clients: the [N]
    chain, the [M] availability ∧ deadline masks and the corruption flags
    equal the reference's, and ``realize`` draws ``step``'s tail."""
    jm, tm = jfaults.FaultModel(**FAULTS), FaultModel(**FAULTS)
    js, ts = jm.init_state(10), tm.init_state(10)
    idx = np.array([7, 1, 4, 9])
    flips = 0
    for t in range(12):
        jk, tk = jax.random.key(100 + t), prng.key(100 + t)
        js, jr = jm.step(jk, js, jnp.asarray(idx))
        ts, tr = tm.step(tk, ts, torch.tensor(idx))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
        np.testing.assert_array_equal(tr.corrupt.numpy(),
                                      np.asarray(jr.corrupt))
        flips += int((tr.mask.numpy() != ts.numpy()[idx]).sum())
        re = tm.realize(tk, ts[idx])
        np.testing.assert_array_equal(re.mask.numpy(), tr.mask.numpy())
        np.testing.assert_array_equal(re.corrupt.numpy(), tr.corrupt.numpy())
    assert flips > 0          # the deadline masked some up clients
    assert float(tr.n_corrupt) == float(jr.n_corrupt)


@hypothesis.settings(hypothesis.settings.get_profile("torch_faults"))
@hypothesis.given(st.floats(0.05, 0.95), st.floats(0.05, 0.95))
def test_gilbert_elliott_hits_stationary_distribution(p_fail, p_recover):
    """Long-run availability of the port's chain converges to π_up =
    p_recover / (p_fail + p_recover) (the reference's property, 200
    rounds of 1,000 clients)."""
    model = FaultModel(p_fail=p_fail, p_recover=p_recover)
    state, fracs = model.init_state(1000), []
    for k in prng.split(prng.key(7), 200):
        state, _ = model.step(k, state, torch.arange(1))
        fracs.append(float(state.float().mean()))
    assert abs(np.mean(fracs[100:]) - model.stationary_up) < 0.05


# ---------------------------------------------------------------------------
# the scrub


@pytest.mark.parametrize("mode", ["nan", "inf", "scale"])
def test_scrub_rows_bitwise(mode):
    """``scrub`` on a [4, 256] matrix whose valid length is 200: row 1
    poisoned, row 2 unavailable, row 3 small over [0, 200) but with walk
    residue in the pad that takes its norm over all 256 columns beyond
    ``guard_norm``. Rows and the ok mask equal the reference's bit for
    bit; ``scrub_tree`` does the same on the rows as a stacked tree."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.1, (4, 256)).astype(np.float32)
    x[3, 200:] = 50.0
    assert np.sqrt((x[3, :200] ** 2).sum()) < 5.0 < np.sqrt((x[3] ** 2).sum())
    mask, corrupt = [True, True, False, True], [False, True, False, False]
    kw = dict(p_corrupt=0.5, corrupt_mode=mode, corrupt_scale=1e12,
              guard_norm=5.0)
    jm, tm = jfaults.FaultModel(**kw), FaultModel(**kw)
    jd, jok = jm.scrub(jnp.asarray(x), jnp.asarray(mask),
                       jnp.asarray(corrupt))
    td, tok = tm.scrub(torch.from_numpy(x.copy()), torch.tensor(mask),
                       torch.tensor(corrupt))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tok.tolist() == [True, False, False, False]
    tree = {"a": x[:, :56], "b": {"c": x[:, 56:].reshape(4, 25, 8)}}
    jt, jokt = jm.scrub_tree(jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(mask), jnp.asarray(corrupt))
    tt, tokt = tm.scrub_tree(convert.to_torch(tree), torch.tensor(mask),
                             torch.tensor(corrupt))
    np.testing.assert_array_equal(tokt.numpy(), np.asarray(jokt))
    _bitequal(tt, jax.device_get(jt))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_nan_client_bitequal_to_masked_client(tasks, route):
    """One all-NaN upload with the guard on gives finite parameters, bit
    for bit those of the same round with that client masked, on every
    route; ``m_effective`` = M − 1, ``m_corrupt`` = 1."""
    _, tt, p0 = tasks
    cfg = FedZOConfig(**BASE, **ROUTES[route])
    params, batches, rngs = _round_inputs(tt, p0, cfg)
    chan = prng.key(9) if cfg.aircomp else None
    out = {}
    for name, rf in (
            ("nan", _rf(FaultModel(p_corrupt=0.5), [True] * 3,
                        [False, True, False])),
            ("masked", _rf(FaultModel(), [True, False, True], [False] * 3))):
        out[name] = fedzo.round_simulated(tt.loss, params, batches, rngs,
                                          cfg, channel_rng=chan, faults=rf)
    (p_nan, m_nan), (p_mask, m_mask) = out["nan"], out["masked"]
    assert all(np.isfinite(v).all() for v in _flat(p_nan).values())
    _bitequal(p_nan, p_mask)
    assert float(m_nan["m_effective"]) == float(m_mask["m_effective"]) == 2.0
    assert float(m_nan["m_corrupt"]) == 1.0
    if cfg.aircomp:
        assert float(m_nan["delta_max"]) == float(m_mask["delta_max"])


@pytest.mark.parametrize("route", ["pytree", "flat", "aircomp"])
def test_guard_off_propagates_poison(tasks, route):
    """guard=False: the same NaN upload reaches the parameters (through
    the masked mean, or ``aircomp_reduce`` and the Δ_max max)."""
    _, tt, p0 = tasks
    cfg = FedZOConfig(**BASE, **ROUTES[route])
    params, batches, rngs = _round_inputs(tt, p0, cfg)
    rf = _rf(FaultModel(p_corrupt=0.5, guard=False), [True] * 3,
             [False, True, False])
    p_bad, _ = fedzo.round_simulated(
        tt.loss, params, batches, rngs, cfg,
        channel_rng=prng.key(9) if cfg.aircomp else None, faults=rf)
    assert any(not np.isfinite(v).all() for v in _flat(p_bad).values())


def test_guard_norm_masks_exploded_delta(tasks):
    """guard_norm masks a finite but exploded (scaled) upload exactly like
    a masked client."""
    _, tt, p0 = tasks
    cfg = FedZOConfig(**BASE, **ROUTES["flat"])
    params, batches, rngs = _round_inputs(tt, p0, cfg)
    rf = _rf(FaultModel(p_corrupt=0.5, corrupt_mode="scale",
                        corrupt_scale=1e12, guard_norm=1e3),
             [True] * 3, [False, False, True])
    p_new, m = fedzo.round_simulated(tt.loss, params, batches, rngs, cfg,
                                     faults=rf)
    p_mask, _ = fedzo.round_simulated(
        tt.loss, params, batches, rngs, cfg,
        faults=_rf(FaultModel(), [True, True, False], [False] * 3))
    _bitequal(p_new, p_mask)
    assert float(m["m_effective"]) == 2.0


@pytest.mark.parametrize("route", ["pytree", "flat"])
def test_all_faulted_round_is_zero_update(tasks, route):
    """Every client down: the clamped divisor gives a zero update (the
    parameters bitwise unchanged) and ``m_effective`` 0."""
    _, tt, p0 = tasks
    cfg = FedZOConfig(**BASE, **ROUTES[route])
    params, batches, rngs = _round_inputs(tt, p0, cfg)
    p_new, m = fedzo.round_simulated(
        tt.loss, params, batches, rngs, cfg,
        faults=_rf(FaultModel(), [False] * 3, [False] * 3))
    _bitequal(p_new, params)
    assert float(m["m_effective"]) == 0.0


# ---------------------------------------------------------------------------
# the engine, FedServer and FedAvg under faults against the reference


@pytest.mark.parametrize("route,name", [("flat", "fedzo"),
                                        ("pytree", "fedzo"),
                                        ("flat", "scaffold"),
                                        ("pytree", "scaffold")])
def test_engine_with_faults_matches_reference(tasks, route, name):
    """4 rounds under dropout, stragglers and NaN uploads: the fault chain
    bitwise, ``m_effective`` and ``m_corrupt`` equal every round, the
    parameters and losses within 1e-3 of the reference."""
    jt, tt, p0 = tasks
    kw = {**BASE, **ROUTES[route], "weight_by_size": True}
    jres = jsim.run_experiment(jt.loss, p0, jt.store, JConfig(**kw), 4,
                               strategy=name, donate=False,
                               faults=jfaults.FaultModel(**FAULTS))
    tres = tengine.run_experiment(tt.loss, convert.to_torch(p0), tt.store,
                                  FedZOConfig(**kw), 4, strategy=name,
                                  faults=FaultModel(**FAULTS))
    np.testing.assert_array_equal(tres.fault_state.numpy(),
                                  np.asarray(jres.fault_state))
    jm = jax.device_get(jres.metrics)
    assert sorted(jm) == sorted(tres.metrics)
    for k in ("m_effective", "m_corrupt"):
        np.testing.assert_array_equal(tres.metrics[k].numpy(), jm[k])
    assert jm["m_corrupt"].sum() > 0 and jm["m_effective"].min() < 3
    np.testing.assert_allclose(tres.metrics["mean_local_loss"].numpy(),
                               jm["mean_local_loss"], rtol=0, atol=ATOL)
    jp, tp = _flat(jax.device_get(jres.params)), _flat(tres.params)
    for k in jp:
        assert np.isfinite(tp[k]).all()
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=ATOL,
                                   err_msg=k)


def test_fedserver_store_path_equals_engine_under_faults(tasks):
    """``FedServer`` on the store path under faults: three host-driven
    ``run_round`` calls are bitwise ``run(3)`` through the engine, and
    their rows carry the reference's ``m_effective``/``m_corrupt``."""
    jt, tt, p0 = tasks
    cfg = FedZOConfig(**BASE, **ROUTES["flat"])
    host = FedServer(tt.loss, convert.to_torch(p0), tt.clients, cfg,
                     store=tt.store, faults=FaultModel(**FAULTS))
    for t in range(3):
        host.run_round(t)
    scanned = FedServer(tt.loss, convert.to_torch(p0), tt.clients, cfg,
                        store=tt.store, faults=FaultModel(**FAULTS))
    scanned.run(3)
    _bitequal(host.params, scanned.params)
    jsrv = JServer(jt.loss, jax.tree.map(jnp.asarray, p0), jt.clients,
                   JConfig(**BASE, **ROUTES["flat"]), store=jt.store,
                   faults=jfaults.FaultModel(**FAULTS))
    jsrv.run(3)
    for hr, sr, jr in zip(host.history, scanned.history, jsrv.history):
        assert hr["mean_local_loss"] == sr["mean_local_loss"]
        for k in ("m_effective", "m_corrupt"):
            assert hr[k] == sr[k] == jr[k], k


def test_fedavg_under_faults_matches_reference(tasks):
    """The FedAvg round with a poisoned and an unavailable client: the
    reference's surviving count, poison count and weights (within 1e-6:
    no ZO coefficient, float32 reordering only)."""
    jt, tt, p0 = tasks
    cfg = FedZOConfig(**BASE)
    params, batches, _ = _round_inputs(tt, p0, cfg)
    mask, corrupt = [True, True, False], [True, False, False]
    jb = jax.tree.map(lambda v: jnp.asarray(v.numpy()), batches)
    jp, jmet = jfedavg.round_simulated(
        jt.loss, jax.tree.map(jnp.asarray, p0), jb, JConfig(**BASE),
        faults=jfaults.RoundFaults(
            jfaults.FaultModel(p_corrupt=0.5), jnp.asarray(mask),
            jnp.asarray(corrupt)))
    tp, tmet = fedavg.round_simulated(
        tt.loss, params, batches, cfg,
        faults=_rf(FaultModel(p_corrupt=0.5), mask, corrupt))
    assert float(tmet["m_effective"]) == float(jmet["m_effective"]) == 1.0
    assert float(tmet["m_corrupt"]) == float(jmet["m_corrupt"]) == 1.0
    jf, tf = _flat(jax.device_get(jp)), _flat(tp)
    for k in jf:
        np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_fault_model_validation(tasks):
    """The reference's ValueErrors: a bad corrupt mode, a probability out
    of [0, 1], faults without a store."""
    _, tt, p0 = tasks
    with pytest.raises(ValueError, match="corrupt_mode"):
        FaultModel(corrupt_mode="garbage")
    with pytest.raises(ValueError, match="p_fail"):
        FaultModel(p_fail=1.5)
    with pytest.raises(ValueError, match="store"):
        FedServer(tt.loss, convert.to_torch(p0), tt.clients,
                  FedZOConfig(**BASE), faults=FaultModel())
    assert FaultModel(p_fail=0.1, p_recover=0.5).describe()[
        "stationary_up"] == pytest.approx(0.5 / 0.6)
