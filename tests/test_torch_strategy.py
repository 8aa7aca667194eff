"""The port's strategy layer (``core/strategy.py``) against a live JAX run:
every registered strategy through the engine on the pytree, flat and wide
routes (and with AirComp), in parameters, metrics and strategy state; the
``prox_mu=0`` and ``dyn_alpha=0`` reductions bitwise the port's fedzo
round; the reference's ValueErrors; the history rows; and the wrapped
loss staying batched on the LM's and the transformer track's cohorts.

Sizes are the golden fixtures' (``tests/golden/regen.py``: softmax 24×4 on
6 clients, M = 3, H = 2, b1 = 8, b2 = 4, lr 5e-2, 3 rounds) with
size-weighted aggregation. Tolerances, as in ``tests/test_torch_slice.py``:
a one-ulp loss difference between torch and XLA moves a ZO coefficient by
d·ulp/μ ≈ 0.012 and the trajectories drift apart like two float32 runs of
one algorithm; weights within 1e-3 (readings up to 6.9e-4 with AirComp,
2.5e-4 without). The strategy states are held in the units of a delta,
within the same 1e-3: SCAFFOLD's controls are the deltas divided by lr·H =
0.1 (held as lr·H·c; readings up to 2.1e-4), FedDyn's duals the deltas
times α = 0.01 (held as h/α; readings up to 3.5e-4). FedAvg has no ZO
coefficient: its weights agree within 1e-6 (reading 2e-8).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sim as jsim
from repro.configs import get_config as jget_config
from repro.configs.base import FedZOConfig as JConfig
from repro.core import strategy as jstrategy
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.workloads import neural as jneural
from repro_torch.configs import get_config
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedzo
from repro_torch.core import strategy
from repro_torch.models import api
from repro_torch.sim import engine as tengine
from repro_torch.utils import convert, prng
from repro_torch.workloads import neural as tneural

TASK = dict(n_train=320, n_test=96, n_clients=6, n_features=24, n_classes=4,
            alpha=0.5)
BASE = dict(n_participating=3, local_iters=2, b1=8, b2=4, lr=5e-2, mu=1e-3,
            seed=11, weight_by_size=True, prox_mu=0.1, dyn_alpha=0.01)
ROUTES = {"pytree": dict(direction_conv="counter"),
          "flat": dict(flat_params=True, flat_block_rows=4),
          "wide": dict(batch_directions=True, direction_conv="block"),
          "flat_air": dict(flat_params=True, flat_block_rows=4, aircomp=True,
                           channel_schedule=True, snr_db=5.0)}
ROUNDS = 3
ATOL = 1e-3
NORMS, NORM_RTOL = ("delta_max", "aircomp_noise_std"), 5e-3
CASES = [(s, r) for s in ("fedzo", "fedprox", "feddyn", "scaffold")
         for r in ("pytree", "flat", "wide")] + [
    ("fedprox", "flat_air"), ("scaffold", "flat_air"), ("feddyn", "flat_air"),
    ("fedavg", "pytree"), ("fedavg", "flat_air")]
LEDGER_INTS = ("wire_bytes", "dense_bytes", "downlink_bytes",
               "wire_bytes_total", "downlink_bytes_total",
               "wire_bytes_effective")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the port's CPU path is many small ops, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tasks():
    return (jneural.make_task("softmax", **TASK),
            tneural.make_task("softmax", device="cpu", **TASK))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _runs(name, route, rounds=ROUNDS, **over):
    jt, tt = _tasks()
    kw = {**BASE, **ROUTES[route], **over}
    jcfg = jneural.default_config(jt, **kw)
    tcfg = tneural.default_config(tt, **kw)
    p0 = jneural.params_init(jt, jcfg.seed)
    jres = jsim.run_experiment(jt.loss, p0, jt.store, jcfg, rounds,
                               strategy=name, donate=False)
    tres = tengine.run_experiment(tt.loss, convert.to_torch(
        jax.device_get(p0)), tt.store, tcfg, rounds, strategy=name)
    return jres, tres, tcfg


@pytest.mark.parametrize("name,route", CASES)
def test_strategy_matches_reference(name, route):
    jres, tres, cfg = _runs(name, route)
    assert tres.strategy == jres.strategy == name
    jp, tp = _flat(jax.device_get(jres.params)), _flat(tres.params)
    atol = 1e-6 if name == "fedavg" else ATOL
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=atol,
                                   err_msg=k)
    jm = jax.device_get(jres.metrics)
    assert sorted(jm) == sorted(tres.metrics)
    for k, v in jm.items():
        got = tres.metrics[k].numpy()
        if k == "m_effective":
            np.testing.assert_array_equal(got, np.asarray(v))
        elif k in NORMS:
            np.testing.assert_allclose(got, np.asarray(v), rtol=NORM_RTOL)
        else:
            np.testing.assert_allclose(got, np.asarray(v), rtol=0,
                                       atol=ATOL, err_msg=k)
    if jres.strategy_state is None:
        assert tres.strategy_state is None
        return
    js = _flat(jax.device_get(jres.strategy_state))
    ts = _flat(tres.strategy_state)
    assert sorted(js) == sorted(ts)
    # both states in the units of a delta: c = −Δ/(lr·H), h = −α·ΣΔ
    unit = (cfg.lr * cfg.local_iters if name == "scaffold"
            else 1.0 / cfg.dyn_alpha)
    moved = max(np.abs(v).max() for v in js.values())
    assert moved * unit >= 10 * ATOL      # the state is not all zeros
    for k in js:
        np.testing.assert_allclose(unit * ts[k], unit * js[k], rtol=0,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name,route", [("feddyn", "flat_air"),
                                        ("fedavg", "pytree"),
                                        ("scaffold", "wide")])
def test_history_rows_match_reference(name, route):
    """The engine's history rows: the same round numbers, the strategy's
    name on every row, and the reference's integer ledger columns."""
    jres, tres, _ = _runs(name, route, rounds=2)
    jrows, trows = jsim.history(jres), tengine.history(tres)
    assert [r["round"] for r in trows] == [r["round"] for r in jrows]
    assert {r["strategy"] for r in trows} == {name}
    assert tres.history() == trows
    for jr, tr in zip(jrows, trows):
        for k in LEDGER_INTS:
            assert (k in tr) == (k in jr), k
            if k in jr:
                assert tr[k] == jr[k], k
        assert tr["compression_ratio"] == jr["compression_ratio"]


@pytest.mark.parametrize("route", ["pytree", "flat", "wide", "flat_air"])
@pytest.mark.parametrize("name,off", [("fedprox", dict(prox_mu=0.0)),
                                      ("feddyn", dict(dyn_alpha=0.0))])
def test_zero_strength_is_bitwise_fedzo(name, off, route):
    """``prox_mu=0`` and ``dyn_alpha=0`` elide the hooks: the run is the
    port's fedzo run bit for bit, and FedDyn keeps no state."""
    _, tt = _tasks()
    cfg = tneural.default_config(tt, **{**BASE, **ROUTES[route], **off})
    p0 = tneural.params_init(tt, cfg.seed)
    got = tengine.run_experiment(tt.loss, p0, tt.store, cfg, 2,
                                 strategy=name)
    want = tengine.run_experiment(tt.loss, p0, tt.store, cfg, 2,
                                  strategy="fedzo")
    assert got.strategy_state is None
    for k, v in _flat(want.params).items():
        np.testing.assert_array_equal(_flat(got.params)[k], v)
    for k, v in want.metrics.items():
        assert torch.equal(got.metrics[k], v), k


def test_reference_value_errors():
    """The stateful strategies reject server momentum; hook strategies
    reject a custom round_fn; an unknown name raises; the deprecated
    ``algo=`` warns; each as in the reference."""
    loss = lambda p, b: 0.0  # noqa: E731
    for name in ("feddyn", "scaffold"):
        for pkg, mrs, cfg in (
                (strategy, tengine.make_round_step,
                 FedZOConfig(server_momentum=0.9)),
                (jstrategy, jsim.make_round_step,
                 JConfig(server_momentum=0.9))):
            with pytest.raises(ValueError, match="server_momentum"):
                mrs(loss, cfg, strategy=name)
    for name in ("fedprox", "feddyn", "scaffold"):
        with pytest.raises(ValueError, match="round_fn"):
            tengine.make_round_step(loss, FedZOConfig(), strategy=name,
                                    round_fn=fedzo.round_simulated)
    tengine.make_round_step(loss, FedZOConfig(), strategy="fedzo",
                            round_fn=fedzo.round_simulated)
    with pytest.raises(ValueError, match="unknown strategy"):
        strategy.get("fedsgd")
    assert sorted(strategy.STRATEGIES) == sorted(jstrategy.STRATEGIES)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert strategy.resolve(algo="scaffold").name == "scaffold"
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert strategy.resolve(cfg=FedZOConfig(strategy="feddyn")).name \
        == "feddyn"
    assert strategy.resolve("fedavg", algo="fedzo").name == "fedavg"


SMOKE = "qwen2-0.5b-smoke"


def _lm_batches(seed, m, h, b=2, s=16):
    toks = jsyn.lm_token_stream(20_000, 512, seed=seed)
    rng = np.random.default_rng(seed)
    bs = [jsyn.lm_batches(toks, b, s, rng) for _ in range(m * h)]
    return {k: np.stack([x[k] for x in bs]).reshape((m, h, b, s))
            for k in ("tokens", "labels")}


def _no_vmap(monkeypatch):
    def no_vmap(*a, **k):
        raise AssertionError("torch.func.vmap reached")

    monkeypatch.setattr(torch.func, "vmap", no_vmap)


def test_fedprox_lm_flat_round_stays_batched(monkeypatch):
    """ZO-FedProx's flat round on qwen2-0.5b-smoke (M = 3, H = 2, b2 = 4,
    μ = 1e-2, lr = 1e-3, prox_mu 0.1) with ``torch.func.vmap`` made to
    raise: the wrapped loss runs the cohort through the model's batched
    form plus the per-row proximal terms. Against the reference's round
    from the same weights, batches and keys: weights within the flat LM
    round's 6e-4 (``tests/test_torch_flat_lm.py``; reading 1.4e-4). The
    mean local loss carries the proximal term (about 0.04 of it here),
    which moves by prox_mu·⟨Δ, δ⟩ for weight differences δ: within 1e-3
    (reading 3.9e-4; 2.9e-5 at prox_mu 0; the wrapped cohort loss itself
    is within 1 ulp of the reference's ``jax.vmap`` of it)."""
    _no_vmap(monkeypatch)
    kw = dict(n_participating=3, local_iters=2, lr=1e-3, mu=1e-2, b2=4,
              flat_params=True, prox_mu=0.1)
    jm, tm = japi.build(jget_config(SMOKE)), api.build(get_config(SMOKE))
    p0 = jax.device_get(jm.init(jax.random.key(0)))
    batch = _lm_batches(5, 3, 2)
    k = jax.random.key(6)
    jp, jmet, _, _ = jstrategy.get("fedprox").run_round(
        jm.loss, jax.tree.map(jnp.asarray, p0),
        jax.tree.map(jnp.asarray, batch), k, JConfig(**kw))
    tp, tmet, _, _ = strategy.get("fedprox").run_round(
        tm.loss, convert.to_torch(p0), convert.to_torch(batch),
        prng.as_key(jax.random.key_data(k)), FedZOConfig(**kw))
    jf, tf = _flat(jax.device_get(jp)), _flat(tp)
    worst = max(float(np.abs(tf[n] - jf[n]).max()) for n in jf)
    moved = max(float(np.abs(jf[n] - _flat(p0)[n]).max()) for n in jf)
    assert worst <= 6e-4 and moved >= 10 * 6e-4
    assert abs(float(tmet["mean_local_loss"])
               - float(jmet["mean_local_loss"])) <= 1e-3


TRACK = dict(n_train=180, n_test=48, n_clients=6, n_features=24,
             n_classes=4, n_patches=4, d_model=16, d_ff=32, n_heads=2)


@pytest.mark.parametrize("name,route", [("fedprox", "flat"),
                                        ("feddyn", "wide")])
def test_track_strategy_round_stays_batched(monkeypatch, name, route):
    """The transformer track (its test size, head dim 8) under a wrapped
    strategy with ``torch.func.vmap`` made to raise: the flat round's
    cohort and the wide round's M·b2 perturbed copies (FedDyn's duals
    repeated b2 times along the row axis) both run through the classifier's
    batched loss. Two rounds against the reference within the trajectory
    tolerance 1e-3 (readings up to 3e-4)."""
    kw = dict(n_participating=3, local_iters=2, b1=6, b2=3, lr=2e-2,
              mu=1e-3, seed=7, prox_mu=0.1, dyn_alpha=0.01,
              **{k: v for k, v in ROUTES[route].items()
                 if k != "flat_block_rows"})
    jt = jneural.make_task("transformer", **TRACK)
    tt = tneural.make_task("transformer", device="cpu", **TRACK)
    jcfg = jneural.default_config(jt, **kw)
    p0 = jneural.params_init(jt, jcfg.seed)
    jres = jsim.run_experiment(jt.loss, p0, jt.store, jcfg, 2,
                               strategy=name, donate=False)
    _no_vmap(monkeypatch)
    tres = tengine.run_experiment(
        tt.loss, convert.to_torch(jax.device_get(p0)), tt.store,
        tneural.default_config(tt, **kw), 2, strategy=name)
    jp, tp = _flat(jax.device_get(jres.params)), _flat(tres.params)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    if name == "feddyn":
        js = _flat(jax.device_get(jres.strategy_state))
        ts = _flat(tres.strategy_state)
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=ATOL,
                                       err_msg=k)
