"""The port's flat-buffer layer against the JAX package: FlatParams order and
geometry, one flat local iterate, the AirComp aggregation, one round.

Where a loss enters, the two packages cannot agree bitwise: torch and XLA
sum a matmul and a logsumexp in other orders, so a float32 loss may differ
by an ulp, and the ZO coefficient c = scale·(L(x+μv) − L(x))/μ multiplies
that ulp by scale/μ (1e5 for the sphere estimator at d = 100, μ = 1e-3:
measured coefficient differences are exact multiples of scale·ulp(L)/μ).
The tolerances below are derived from that at each assertion.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs.base import FedZOConfig as JConfig
from repro.core import aircomp as jair
from repro.core import fedzo as jfedzo
from repro.models import simple as jsimple
from repro.utils import flatparams as jflat
from repro_torch.configs.base import FedZOConfig as TConfig
from repro_torch.core import aircomp as tair
from repro_torch.core import fedzo as tfedzo
from repro_torch.models import simple as tsimple
from repro_torch.utils import convert, prng
from repro_torch.utils import flatparams as tflat

BR = 4


def _cnn_params(seed=0):
    p = jsimple.smallcnn_init(jax.random.key(seed), (12, 12, 1), 4, 4)
    return jax.tree.map(np.asarray, p)


def _softmax_params(seed=0, f=24, c=4):
    rs = np.random.default_rng(seed)
    return {"w": rs.normal(0, 0.1, (f, c)).astype(np.float32),
            "b": rs.normal(0, 0.1, (c,)).astype(np.float32)}


@pytest.mark.parametrize("block_rows", [0, BR])
@pytest.mark.parametrize("which", ["softmax", "cnn"])
def test_flat_spec_order_geometry_and_buffer(which, block_rows):
    params = _softmax_params() if which == "softmax" else _cnn_params()
    jspec, _ = jflat.flat_geometry(params, block_rows)
    tparams = convert.to_torch(params)
    tspec, _ = tflat.flat_geometry(tparams, block_rows)
    # jax's sorted-key leaf order: softmax is b then w
    assert tspec.names == tuple(sorted(params))
    assert (tspec.offsets, tspec.sizes, tspec.d, tspec.n_pad) == \
        (jspec.offsets, jspec.sizes, jspec.d, jspec.n_pad)
    assert tspec.n_pad % ((block_rows or 512) * 128) == 0
    buf = tflat.flatten(tparams, tspec)
    np.testing.assert_array_equal(
        np.asarray(jflat.flatten(jax.tree.map(jnp.asarray, params), jspec)),
        buf.numpy())
    back = tflat.unflatten(buf, tspec)
    for k in params:
        np.testing.assert_array_equal(back[k].numpy(), params[k])
    batched = tflat.unflatten(torch.stack([buf, 2 * buf]), tspec)
    for k in params:
        assert batched[k].shape == (2,) + params[k].shape
        np.testing.assert_array_equal(batched[k][1].numpy(), 2 * params[k])


def test_smallcnn_init_and_forward_match_reference():
    """Same seed, same key chain: the init agrees within the normal draw's
    ulps; the forward (HWIO/NHWC permuted to torch's layouts) within the
    float32 rounding of the convolutions."""
    want = _cnn_params(3)
    got = tsimple.smallcnn_init(prng.key(3), (12, 12, 1), 4, 4)
    for k in want:
        err = np.abs(got[k].numpy() - want[k]) / np.spacing(
            np.maximum(np.abs(want[k]), np.float32(1e-30)))
        assert err.max() <= 4, (k, err.max())
    x = np.random.default_rng(0).uniform(0, 1, (5, 12, 12, 1)).astype(
        np.float32)
    jl = np.asarray(jsimple.smallcnn_logits(jax.tree.map(jnp.asarray, want),
                                            jnp.asarray(x)))
    tl = tsimple.smallcnn_logits(convert.to_torch(want),
                                 torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)


_ITER_CASES = [dict(estimator="sphere"), dict(estimator="rademacher"),
               dict(estimator="gaussian"),
               dict(estimator="sphere", central=True)]


@pytest.mark.parametrize("over", _ITER_CASES,
                         ids=lambda o: "-".join(f"{v}" for v in o.values()))
def test_flat_local_iterate_matches_reference(over):
    rs = np.random.default_rng(1)
    f, c, b, m = 24, 4, 8, 3
    params = _softmax_params(1, f, c)
    x = rs.normal(0, 1, (m, b, f)).astype(np.float32)
    y = rs.integers(0, c, (m, b)).astype(np.int32)
    kw = dict(b2=4, lr=5e-2, mu=1e-3, flat_params=True, flat_block_rows=BR,
              **over)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jspec, jbr = jflat.flat_geometry(params, BR)
    tspec, tbr = tflat.flat_geometry(convert.to_torch(params), BR)
    keys = jax.random.split(jax.random.key(5), m)
    want = []
    for i in range(m):
        buf = jflat.flatten(jax.tree.map(jnp.asarray, params), jspec)
        out = jfedzo.flat_local_iterate(
            jsimple.softmax_loss, buf, jspec,
            {"x": jnp.asarray(x[i]), "y": jnp.asarray(y[i])}, keys[i], jcfg,
            block_rows=jbr)
        want.append([np.asarray(o) for o in out])
    tbuf = tflat.flatten(convert.to_torch(params), tspec)
    got = tfedzo.flat_local_iterate(
        tfedzo.batched_loss(tsimple.softmax_loss),
        tbuf.expand(m, tspec.n_pad).contiguous(), tspec,
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        prng.as_key(jax.random.key_data(keys)), tcfg, block_rows=tbr)
    got = [o.numpy() for o in got]
    scale = float(tspec.d) if over["estimator"] == "sphere" else 1.0
    mu = kw["mu"] * (2 if over.get("central") else 1)
    for i in range(m):
        wbuf, wc, wbase = want[i]
        gbuf, gc, gbase = got[0][i], got[1][i], got[2][i]
        ulp_l = np.spacing(np.float32(np.abs(wbase) + 1.0))
        # the base loss: torch's and XLA's summation orders, 2 ulp
        assert abs(gbase - wbase) <= 2 * ulp_l
        # each coefficient: its two losses may each move by 2 ulp
        c_tol = 4 * scale * ulp_l / mu
        np.testing.assert_allclose(gc, wc, rtol=0, atol=c_tol)
        # the update lr/b2·Σ_n c_n·inv_n·v_n moves by at most lr·c_tol·
        # max|inv·v| (each direction element |v| < 6 for Box-Muller's
        # 24-bit u1, inv = 1/‖v‖ for sphere, 1 otherwise), plus rounding
        inv = 1 / np.sqrt(scale) if over["estimator"] == "sphere" else 1.0
        buf_tol = kw["lr"] * c_tol * 6 * inv * 2 + 4 * np.spacing(
            np.float32(np.abs(wbuf).max()))
        np.testing.assert_allclose(gbuf, wbuf, rtol=0, atol=buf_tol)


def test_channel_schedule_mask_and_weights_match_reference():
    for seed in range(40):
        k = jax.random.key(seed)
        jh, jm = jair.schedule_by_channel(k, 10, 0.8)
        th, tm = tair.schedule_by_channel(prng.key(seed), 10, 0.8)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6)
    sizes = np.array([5, 17, 40, 3, 3], np.int32)
    w = np.asarray(jair.size_weights(jnp.asarray(sizes)))
    np.testing.assert_array_equal(
        w, tair.size_weights(torch.from_numpy(sizes)).numpy())
    w = np.array(w)
    mask = np.array([True, False, True, True, False])
    for weights in (None, w):
        want = jair.mask_stats(jnp.asarray(mask), 5,
                               None if weights is None else jnp.asarray(w))
        got = tair.mask_stats(torch.from_numpy(mask), 5,
                              None if weights is None else torch.tensor(w))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_aircomp_aggregate_flat_matches_reference(masked):
    rs = np.random.default_rng(2)
    m, n, d = 4, 2 * BR * 128, 700
    deltas = rs.normal(0, 1e-2, (m, n)).astype(np.float32)
    mask = np.array([True, False, True, True]) if masked else None
    w = rs.uniform(0.5, 1.5, m).astype(np.float32) if masked else None
    k = jax.random.key(9)
    want, wstats = jair.aircomp_aggregate_flat(
        jnp.asarray(deltas), k, snr_db=5.0, h_min=0.8, d=d,
        mask=None if mask is None else jnp.asarray(mask),
        weights=None if w is None else jnp.asarray(w), block_rows=BR)
    got, gstats = tair.aircomp_aggregate_flat(
        torch.from_numpy(deltas), prng.as_key(jax.random.key_data(k)),
        snr_db=5.0, h_min=0.8, d=d,
        mask=None if mask is None else torch.from_numpy(mask),
        weights=None if w is None else torch.from_numpy(w), block_rows=BR)
    assert float(gstats["m_effective"]) == float(wstats["m_effective"])
    for key in ("delta_max", "aircomp_noise_std"):
        np.testing.assert_allclose(float(gstats[key]), float(wstats[key]),
                                   rtol=1e-5)
    # mean + noise_std·g: 4 ulp of the summed terms (g is a normal direction)
    noise = float(wstats["aircomp_noise_std"]) * 6
    mag = np.abs(deltas).sum(0) + noise
    err = np.abs(got.numpy() - np.asarray(want)) / np.spacing(
        mag.astype(np.float32))
    assert err.max() <= 4, err.max()


_ROUND_CASES = {
    # server momentum over a size-weighted mean
    "momentum_weighted": dict(server_momentum=0.9),
    # AirComp without scheduling: the channel key seeds the noise directly
    "aircomp_unscheduled": dict(aircomp=True, snr_db=5.0),
}


@pytest.mark.parametrize("case", sorted(_ROUND_CASES))
def test_round_matches_reference(case):
    over = _ROUND_CASES[case]
    rs = np.random.default_rng(3)
    f, c, b1, m, h = 24, 4, 8, 3, 2
    params = _softmax_params(3, f, c)
    x = rs.normal(0, 1, (m, h, b1, f)).astype(np.float32)
    y = rs.integers(0, c, (m, h, b1)).astype(np.int32)
    weights = np.array([0.5, 1.25, 1.25], np.float32)
    kw = dict(n_participating=m, local_iters=h, b2=4, lr=5e-2, mu=1e-3,
              flat_params=True, flat_block_rows=BR, **over)
    keys = jax.random.split(jax.random.key(6), m)
    kchan = jax.random.key(7)
    mom0 = ({k: np.full_like(v, 0.01) for k, v in params.items()}
            if "server_momentum" in over else None)
    jout = jfedzo.round_simulated(
        jsimple.softmax_loss, jax.tree.map(jnp.asarray, params),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, keys, JConfig(**kw),
        channel_rng=kchan,
        momentum=None if mom0 is None else jax.tree.map(jnp.asarray, mom0),
        weights=jnp.asarray(weights))
    tout = tfedzo.round_simulated(
        tsimple.softmax_loss, convert.to_torch(params),
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        prng.as_key(jax.random.key_data(keys)), TConfig(**kw),
        channel_rng=prng.as_key(jax.random.key_data(kchan)),
        momentum=None if mom0 is None else convert.to_torch(mom0),
        weights=torch.from_numpy(weights))
    jp, jm, tp, tm = jout[0], jout[1], tout[0], tout[1]
    assert sorted(tm) == sorted(jm)
    assert float(tm["m_effective"]) == float(jm["m_effective"])
    # one-ulp loss differences through scale/μ = 1e5 (module docstring):
    # measured < 2e-4 on the parameters after one round at lr 5e-2
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-3)
        if mom0 is not None:
            np.testing.assert_allclose(tout[2][k].numpy(),
                                       np.asarray(jout[2][k]), rtol=0,
                                       atol=1e-3)
    # the first iterate's losses are taken at the same parameters: ulps;
    # later ones after updates that differ as above
    np.testing.assert_allclose(float(tm["first_loss"]),
                               float(jm["first_loss"]), rtol=1e-6)
    for k in set(jm) - {"first_loss", "m_effective"}:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3,
                                   atol=1e-3, err_msg=k)
