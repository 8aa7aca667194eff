"""Seed-compressed uplinks (``core/seedcomm.py``), the seed-compressed
round (``fed/server.run_seed_compressed_round``) and the zeroth-order
baselines (``core/baselines.py``) in the port against a live JAX run.

Wire bytes are integers and equal the reference's. A replayed delta
regenerates the same directions from the same key words (the counter
convention's Box-Muller and the tree convention's normals agree with
XLA's within a few float32 ulps) and sums them in the same order, so a
replay agrees with the reference's within relative 1e-5 of its largest
entry (each reading stands beside its limit). Sizes: softmax 24×4 (d =
100) on 6 clients, H = 2, b2 = 4, ``flat_block_rows=4``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sim as jsim
from repro.configs.base import FedZOConfig as JConfig
from repro.core import baselines as jbase
from repro.core import fedzo as jfedzo
from repro.core import seedcomm as jseed
from repro.fed import server as jserver
from repro.workloads import neural as jneural
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import baselines as tbase
from repro_torch.core import fedzo, seedcomm
from repro_torch.fed import server as tserver
from repro_torch.obs.ledger import CommsLedger
from repro_torch.utils import convert, prng
from repro_torch.workloads import neural as tneural

TASK = dict(n_train=320, n_test=96, n_clients=6, n_features=24, n_classes=4,
            alpha=0.5)
BASE = dict(n_participating=3, local_iters=2, b1=8, b2=4, lr=5e-2, mu=1e-3,
            seed=11)
ROUTES = {"tree": dict(direction_conv="tree"),
          "counter": dict(direction_conv="counter"),
          "flat": dict(flat_params=True, flat_block_rows=4),
          "wide_tree": dict(batch_directions=True, direction_conv="tree")}
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the port's CPU path is many small ops, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _close(got, want, rtol=RTOL):
    """Each leaf within ``rtol`` of the largest |entry| of the whole tree;
    returns the worst relative difference."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    scale = max(np.abs(v).max() for v in w.values())
    worst = max(np.abs(g[k] - w[k]).max() for k in w) / scale
    assert worst <= rtol, worst
    return worst


def _params():
    jt = jneural.make_task("softmax", **TASK)
    return jax.device_get(jneural.params_init(jt, 11))


def _msgs(m, h=2, b2=4, seed=0):
    rs = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.key(seed + 1), m)
    coeffs = rs.standard_normal((m, h, b2)).astype(np.float32) * 50
    return keys, coeffs


def _tkeys(jkeys):
    return prng.as_key(jax.random.key_data(jkeys))


@pytest.mark.parametrize("h,b2", [(2, 4), (5, 20), (1, 1)])
def test_wire_bytes_match_reference(h, b2):
    """One message and a stacked bundle: the reference's byte counts, 8
    bytes for the key (two uint32 words, not the int64 tensor's 16), and
    ``wire_bytes_model``'s 8 + 4·H·b2 + 4, which the ledger charges."""
    cfg = dict(BASE, local_iters=h, b2=b2)
    keys, coeffs = _msgs(3, h, b2)
    jb = jseed.wire_bytes(jseed.compress(keys[0], jnp.asarray(coeffs[0]),
                                         JConfig(**cfg)))
    tb = seedcomm.wire_bytes(seedcomm.compress(
        _tkeys(keys)[0], torch.from_numpy(coeffs[0]), FedZOConfig(**cfg)))
    assert tb == jb == seedcomm.wire_bytes_model(FedZOConfig(**cfg)) \
        == 8 + 4 * h * b2 + 4
    jbs = jseed.wire_bytes(jseed.compress_stacked(
        keys, jnp.asarray(coeffs), JConfig(**cfg)))
    tbs = seedcomm.wire_bytes(seedcomm.compress_stacked(
        _tkeys(keys), torch.from_numpy(coeffs), FedZOConfig(**cfg)))
    assert tbs == jbs == 3 * tb
    led = CommsLedger.from_run(FedZOConfig(**cfg, delta_compression="seed"),
                               convert.to_torch(_params()))
    assert led.mode == "seed" and led.uplink_client_bytes == tb


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_reconstruct_delta_matches_reference(route):
    """One message replayed on each route: within relative 1e-5 (readings
    1.1e-7 on every route)."""
    cfg = dict(BASE, **ROUTES[route])
    p0 = _params()
    keys, coeffs = _msgs(1)
    want = jseed.reconstruct_delta(
        jseed.compress(keys[0], jnp.asarray(coeffs[0]), JConfig(**cfg)),
        jax.tree.map(jnp.asarray, p0), JConfig(**cfg))
    got = seedcomm.reconstruct_delta(
        seedcomm.compress(_tkeys(keys)[0], torch.from_numpy(coeffs[0]),
                          FedZOConfig(**cfg)),
        convert.to_torch(p0), FedZOConfig(**cfg))
    _close(got, jax.device_get(want))


@pytest.mark.parametrize("stacked", [False, True], ids=["list", "bundle"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_aggregate_matches_reference(route, stacked):
    """The mean of M = 3 replayed deltas, from a list of messages or one
    stacked bundle: within relative 1e-5 of the reference's (readings up to
    1.5e-7); the list and the bundle give the same bits; and the mean of
    the three ``reconstruct_delta`` replays within M·H = 6 ulps of M times
    the largest entry (another summation order: each of the M·H additions
    rounds once, on partial sums up to M times the mean; reading 4 ulps of
    the largest entry)."""
    cfg = dict(BASE, **ROUTES[route])
    jcfg, tcfg = JConfig(**cfg), FedZOConfig(**cfg)
    p0 = _params()
    keys, coeffs = _msgs(3, seed=4)
    tkeys = _tkeys(keys)
    if stacked:
        jm = jseed.compress_stacked(keys, jnp.asarray(coeffs), jcfg)
        tm = seedcomm.compress_stacked(tkeys, torch.from_numpy(coeffs), tcfg)
    else:
        jm = [jseed.compress(keys[i], jnp.asarray(coeffs[i]), jcfg)
              for i in range(3)]
        tm = [seedcomm.compress(tkeys[i], torch.from_numpy(coeffs[i]), tcfg)
              for i in range(3)]
    want = jseed.aggregate(jm, jax.tree.map(jnp.asarray, p0), jcfg)
    got = seedcomm.aggregate(tm, convert.to_torch(p0), tcfg)
    _close(got, jax.device_get(want))
    other = seedcomm.aggregate(
        [seedcomm.compress(tkeys[i], torch.from_numpy(coeffs[i]), tcfg)
         for i in range(3)] if stacked else
        seedcomm.compress_stacked(tkeys, torch.from_numpy(coeffs), tcfg),
        convert.to_torch(p0), tcfg)
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(_flat(other)[k], v)
    each = [seedcomm.reconstruct_delta(
        seedcomm.compress(tkeys[i], torch.from_numpy(coeffs[i]), tcfg),
        convert.to_torch(p0), tcfg) for i in range(3)]
    mean = {k: sum(_flat(e)[k] for e in each) / 3 for k in _flat(got)}
    scale = max(np.abs(v).max() for v in mean.values())
    for k, v in _flat(got).items():
        np.testing.assert_allclose(
            v, mean[k], rtol=0, atol=6 * np.spacing(np.float32(3 * scale)))


def test_replay_rejections():
    """Block-convention coefficients are not replayable, and a key that is
    not the two-word Threefry key is not wire format: the reference's
    ValueErrors."""
    p0 = convert.to_torch(_params())
    keys, coeffs = _msgs(2)
    block = FedZOConfig(**BASE, batch_directions=True,
                        direction_conv="block")
    msg = seedcomm.compress(_tkeys(keys)[0], torch.from_numpy(coeffs[0]),
                            FedZOConfig(**BASE))
    for fn in (lambda: seedcomm.reconstruct_delta(msg, p0, block),
               lambda: seedcomm.aggregate([msg], p0, block)):
        with pytest.raises(ValueError, match="not seed-replayable"):
            fn()
    with pytest.raises(ValueError, match="8-byte threefry key"):
        seedcomm.compress(torch.zeros(4, dtype=torch.int64),
                          torch.from_numpy(coeffs[0]), FedZOConfig(**BASE))
    with pytest.raises(ValueError, match="not seed-replayable"):
        jseed.aggregate([jseed.compress(keys[0], jnp.asarray(coeffs[0]),
                                        JConfig(**BASE))],
                        _params(), JConfig(**BASE, batch_directions=True,
                                           direction_conv="block"))


def _round_inputs(h=2):
    jt = jneural.make_task("softmax", **TASK)
    idx = jsim.sample_participants(jax.random.key(3), 6, 3)
    batches = jax.device_get(jsim.sample_batches(
        jt.store, idx, jax.random.key(4), h, 8))
    return jt, batches, jax.random.split(jax.random.key(9), 3)


@pytest.mark.parametrize("route", ["tree", "counter", "flat", "wide_tree"])
def test_seed_compressed_round_matches_reference(route):
    """``run_seed_compressed_round``: the same wire and dense bytes as the
    reference, the new weights within 1e-3 of the reference's (the ZO
    trajectory tolerance of ``tests/test_torch_slice.py``; readings up to
    7.6e-5), and within H + 2 = 4 ulps of each leaf's largest weight of
    the port's own dense round (``fedzo.round_simulated`` on the same
    batches and keys and so the same coefficients and updates: the dense
    route rounds each weight once per iterate, the replay sums the updates
    first, and both round the mean and the final add once; readings up to
    3 ulps)."""
    cfg = dict(BASE, **ROUTES[route])
    jt, batches, keys = _round_inputs()
    p0 = _params()
    jp, jw, jd = jserver.run_seed_compressed_round(
        jt.loss, jax.tree.map(jnp.asarray, p0),
        jax.tree.map(jnp.asarray, batches), keys, JConfig(**cfg))
    tt = tneural.make_task("softmax", device="cpu", **TASK)
    tp, tw, td = tserver.run_seed_compressed_round(
        tt.loss, convert.to_torch(p0), convert.to_torch(batches),
        _tkeys(keys), FedZOConfig(**cfg))
    assert (tw, td) == (jw, jd) == (3 * (8 + 4 * 2 * 4 + 4), 3 * 100 * 4)
    g, w = _flat(tp), _flat(jax.device_get(jp))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    dense, _ = fedzo.round_simulated(
        tt.loss, convert.to_torch(p0), convert.to_torch(batches),
        _tkeys(keys), FedZOConfig(**cfg))
    for k, v in _flat(dense).items():
        np.testing.assert_allclose(g[k], v, rtol=0,
                                   atol=(2 + 2) * np.spacing(np.abs(v)).max(),
                                   err_msg=k)


@pytest.mark.parametrize("route", ["tree", "flat", "wide_tree"])
def test_seed_config_runs_the_dense_round(route):
    """``delta_compression="seed"`` is read only by the ledger and the seed
    path of ``FedServer``: the round of such a config is the dense round
    bit for bit, in the port as in the reference."""
    tt = tneural.make_task("softmax", device="cpu", **TASK)
    _, batches, keys = _round_inputs()
    out = {}
    for comp in ("dense", "seed"):
        cfg = FedZOConfig(**BASE, **ROUTES[route], delta_compression=comp)
        out[comp] = fedzo.round_simulated(
            tt.loss, convert.to_torch(_params()), convert.to_torch(batches),
            _tkeys(keys), cfg)
    for k, v in _flat(out["dense"][0]).items():
        np.testing.assert_array_equal(_flat(out["seed"][0])[k], v)
    for k, v in out["dense"][1].items():
        assert torch.equal(out["seed"][1][k], v)
    res = tneural.run(tt, tneural.default_config(
        tt, **BASE, **ROUTES[route], delta_compression="seed"), 1,
        eval_every=0)
    assert res.ledger.mode == "seed"


@pytest.mark.parametrize("conv", ["tree", "counter"])
def test_baselines_match_reference(conv):
    """ZO-SGD, ZONE-S and a DZOPA iteration over 3 agents, on both
    direction conventions, from the same weights, batches and keys: within
    the ZO trajectory tolerance 1e-3 (readings up to 6.1e-5 after one step
    of each)."""
    jt, batches, keys = _round_inputs(h=1)
    tt = tneural.make_task("softmax", device="cpu", **TASK)
    p0 = _params()
    b0 = jax.tree.map(lambda v: v[0, 0], batches)
    kw = dict(lr=5e-2, mu=1e-3, b2=4, kind="sphere", conv=conv)
    jp, jl = jbase.zo_sgd_step(jt.loss, jax.tree.map(jnp.asarray, p0),
                               jax.tree.map(jnp.asarray, b0), keys[0], **kw)
    tp, tl = tbase.zo_sgd_step(tt.loss, convert.to_torch(p0),
                               convert.to_torch(b0), _tkeys(keys)[0], **kw)
    _check_baseline(tp, jp, tl, jl)
    kz = dict(kw, rho=50.0)
    del kz["lr"]
    jp, jl = jbase.zone_s_round(jt.loss, jax.tree.map(jnp.asarray, p0),
                                jax.tree.map(jnp.asarray, b0), keys[1], **kz)
    tp, tl = tbase.zone_s_round(tt.loss, convert.to_torch(p0),
                                convert.to_torch(b0), _tkeys(keys)[1], **kz)
    _check_baseline(tp, jp, tl, jl)
    cfg = dict(BASE, direction_conv=conv)
    stack = jax.tree.map(lambda v: np.stack([v] * 3), p0)
    bs = jax.tree.map(lambda v: v[:, 0], batches)
    jp, jl = jbase.dzopa_round(jt.loss, jax.tree.map(jnp.asarray, stack),
                               jax.tree.map(jnp.asarray, bs), keys,
                               JConfig(**cfg))
    tp, tl = tbase.dzopa_round(tt.loss, convert.to_torch(stack),
                               convert.to_torch(bs), _tkeys(keys),
                               FedZOConfig(**cfg))
    _check_baseline(tp, jp, tl, jl)


def _check_baseline(tp, jp, tl, jl):
    g, w = _flat(tp), _flat(jax.device_get(jp))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    assert abs(float(tl) - float(jl)) <= 8 * np.spacing(
        np.float32(float(jl)))
