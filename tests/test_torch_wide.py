"""The batched-direction ("wide") local phase and the bfloat16 tree-convention
draws of the port, against a live JAX run on the CPU.

- ``estimator.direction_block`` for the ``block``, ``tree`` and ``channel``
  conventions and every estimator kind: rademacher bitwise, normals within
  ``prng.normal``'s 4 ulp, the sphere factors within a relative 1e-6 (the
  norm sums in another order).
- ``round_simulated`` and ``local_phase`` with ``batch_directions=True`` on
  the softmax, cnn and transformer tracks at the reference's test sizes
  (``tests/test_neural.py``), for ``block``, ``tree``, ``channel`` and
  ``surrogate``, one-sided and central, and with AirComp: weights within
  the ZO trajectory tolerance 1e-3 (a loss ulp moves a coefficient by
  scale·ulp/μ, and a weight by lr/b2 of that per iterate).
- The port's wide phase under ``tree`` walks the loop estimator's
  directions, as the reference's ``test_wide_phase_matches_loop_on_cnn``.
- ``jax.random.normal(key, shape, jnp.bfloat16)`` bitwise, and a pytree
  round with bfloat16 directions within 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sim as jsim
from repro.configs.base import FedZOConfig as JConfig
from repro.core import estimator as jest
from repro.core import fedzo as jfedzo
from repro.utils import flatparams as jflat
from repro.workloads import neural as jneural
from repro_torch.configs.base import FedZOConfig as TConfig
from repro_torch.core import estimator as test_
from repro_torch.core import fedzo as tfedzo
from repro_torch.utils import convert, prng
from repro_torch.sim.store import sample_batches
from repro_torch.utils import flatparams as tflat
from repro_torch.workloads import neural as tneural

TASK_KW = {
    "softmax": dict(n_train=240, n_test=64, n_clients=6, n_features=24,
                    n_classes=4),
    "cnn": dict(n_train=180, n_test=48, n_clients=6, n_classes=4,
                image_shape=(10, 10, 1), width=4),
    "transformer": dict(n_train=180, n_test=48, n_clients=6, n_features=24,
                        n_classes=4, n_patches=4, d_model=16, d_ff=32,
                        n_heads=2),
}
CFG = dict(n_participating=3, local_iters=2, b1=6, b2=3, lr=2e-2, mu=1e-3,
           seed=7, weight_by_size=False, batch_directions=True)
ATOL = 1e-3
M = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the port's CPU path is many small ops, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tasks(name):
    return (jneural.make_task(name, **TASK_KW[name]),
            tneural.make_task(name, device="cpu", **TASK_KW[name]))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _tkey(k):
    return prng.as_key(jax.random.key_data(k))


def _close(got, want, atol=ATOL, rtol=1e-4):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# direction blocks


def _ulps(got, want):
    return (np.abs(got - want) / np.spacing(np.abs(want).astype(
        np.float32))).max()


@pytest.mark.parametrize("kind", ["sphere", "gaussian", "rademacher"])
@pytest.mark.parametrize("conv", ["block", "tree", "channel"])
def test_direction_block_matches_reference(conv, kind):
    """Three clients' keys at once against three reference calls, over a
    nested tree whose d = 226 is not a multiple of the 128-lane pad."""
    rs = np.random.default_rng(0)
    params = {"w": rs.normal(size=(24, 4)).astype(np.float32),
              "b": rs.normal(size=(4,)).astype(np.float32),
              "c": {"z": rs.normal(size=(5, 7, 3, 1)).astype(np.float32),
                    "a": rs.normal(size=(21,)).astype(np.float32)}}
    jspec = jflat.flat_spec(jax.tree.map(jnp.asarray, params), block=128)
    tparams = convert.to_torch(params)
    tspec = tflat.flat_spec(tparams, block=128)
    assert (tspec.d, tspec.n_pad) == (jspec.d, jspec.n_pad) == (226, 256)
    keys = jax.random.split(jax.random.key(4), M)
    want = [jest.direction_block(k, jspec, 5, kind=kind, conv=conv,
                                 like=params) for k in keys]
    wv = np.stack([np.asarray(v) for v, _ in want])
    wi = np.stack([np.asarray(i) for _, i in want])
    gv, gi = test_.direction_block(_tkey(keys), tspec, 5, kind=kind,
                                   conv=conv, like=tparams)
    assert gv.shape == (M, 5, 256) and gi.shape == (M, 5)
    if kind == "rademacher" and conv != "channel":
        np.testing.assert_array_equal(gv.numpy(), wv)
    else:
        assert _ulps(gv.numpy(), wv) <= 4
    np.testing.assert_allclose(gi.numpy(), wi, rtol=1e-6, atol=0)
    if conv == "tree":
        np.testing.assert_array_equal(gv[..., 226:].numpy(), 0)
    # one key gives the unbatched block
    v1, i1 = test_.direction_block(_tkey(keys[1]), tspec, 5, kind=kind,
                                   conv=conv, like=tparams)
    assert torch.equal(v1, gv[1]) and torch.equal(i1, gi[1])


# ---------------------------------------------------------------------------
# wide rounds and local phases


def _round_inputs(jt, cfg):
    batches = jsim.sample_batches(jt.store, jnp.arange(M), jax.random.key(5),
                                  cfg.local_iters, cfg.b1)
    rngs = jax.random.split(jax.random.key(6), M)
    tb = {k: torch.from_numpy(np.asarray(v))
          for k, v in jax.device_get(batches).items()}
    return batches, rngs, tb, _tkey(rngs)


ROUND_CASES = [(task, conv, central)
               for task in ("softmax", "cnn", "transformer")
               for conv in ("block", "tree", "channel", "surrogate")
               for central in (False, True)]


@pytest.mark.parametrize("task,conv,central", ROUND_CASES)
def test_wide_round_matches_reference(task, conv, central):
    """One ``round_simulated`` on the wide route (M = 3, H = 2, b2 = 3)
    from the same weights, batches and keys: new weights and the losses
    within 1e-3 (the second iterate's losses are taken at weights that
    drifted; readings up to 1.1e-4)."""
    jt, tt = _tasks(task)
    kw = dict(CFG, direction_conv=conv, central=central)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    p0 = jax.device_get(jneural.params_init(jt, 7))
    batches, rngs, tb, trngs = _round_inputs(jt, jcfg)
    jnew, jm = jax.jit(lambda p, b, r: jfedzo.round_simulated(
        jt.loss, p, b, r, jcfg))(p0, batches, rngs)
    tnew, tm = tfedzo.round_simulated(tt.loss, convert.to_torch(p0), tb,
                                      trngs, tcfg)
    _close(convert.to_numpy(tnew), jax.device_get(jnew))
    for k in ("mean_local_loss", "first_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("task", ["softmax", "cnn", "transformer"])
def test_wide_aircomp_round_matches_reference(task):
    """The wide route with AirComp and channel scheduling: the deltas are
    kept on the kernel geometry (``n_pad`` a multiple of 4·128 here) for
    ``aircomp_reduce``; the mask equal, weights within 1e-3, delta_max and
    the noise std within a relative 5e-3 (a norm over weights that each
    drift by up to 1e-3)."""
    jt, tt = _tasks(task)
    kw = dict(CFG, direction_conv="block", aircomp=True, snr_db=5.0,
              channel_schedule=True, flat_block_rows=4)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    p0 = jax.device_get(jneural.params_init(jt, 7))
    batches, rngs, tb, trngs = _round_inputs(jt, jcfg)
    kc = jax.random.key(9)
    jnew, jm = jax.jit(lambda p, b, r, c: jfedzo.round_simulated(
        jt.loss, p, b, r, jcfg, channel_rng=c))(p0, batches, rngs, kc)
    tnew, tm = tfedzo.round_simulated(tt.loss, convert.to_torch(p0), tb,
                                      trngs, tcfg, channel_rng=_tkey(kc))
    _close(convert.to_numpy(tnew), jax.device_get(jnew))
    assert float(tm["m_effective"]) == float(jm["m_effective"])
    for k in ("delta_max", "aircomp_noise_std"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=5e-3,
                                   err_msg=k)


@pytest.mark.parametrize("central", [False, True])
@pytest.mark.parametrize("conv", ["block", "tree", "channel", "surrogate"])
@pytest.mark.parametrize("task", ["softmax", "cnn", "transformer"])
def test_wide_local_phase_matches_reference(task, conv, central):
    """One client's H = 2 wide iterates: weights and base losses within
    1e-3 (the first loss is taken at the shared weights and is within an
    ulp), and every coefficient within 8 of its loss ulps in its
    units (scale·ulp(L)/μ) plus a relative 1e-3 (the second iterate starts
    from weights that drifted by the first's)."""
    jt, tt = _tasks(task)
    kw = dict(CFG, direction_conv=conv, central=central)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    p0 = jax.device_get(jneural.params_init(jt, 7))
    batches, rngs, tb, trngs = _round_inputs(jt, jcfg)
    one = jax.tree.map(lambda v: v[0], batches)
    want = jax.jit(lambda p, b, r: jfedzo.local_phase(jt.loss, p, b, r,
                                                      jcfg))(p0, one,
                                                             rngs[0])
    got = tfedzo.local_phase(tt.loss, convert.to_torch(p0),
                             {k: v[0] for k, v in tb.items()}, trngs[0],
                             tcfg)
    _close(convert.to_numpy(got.params), jax.device_get(want.params))
    wl = np.asarray(want.losses)
    np.testing.assert_allclose(got.losses.numpy(), wl, rtol=0, atol=ATOL)
    assert abs(float(got.losses[0]) - wl[0]) <= 2 * np.spacing(wl[0])
    d = sum(v.size for v in _leaves(p0).values())
    scale = 1.0 if conv == "channel" else float(d)
    mu = CFG["mu"] * (2 if central else 1)
    c_tol = 8 * scale * np.spacing(np.float32(np.abs(wl).max())) / mu
    wc = np.asarray(want.coeffs)
    assert got.coeffs.shape == wc.shape
    np.testing.assert_allclose(got.coeffs.numpy(), wc, rtol=1e-3,
                               atol=c_tol)


def test_wide_phase_matches_loop_on_cnn():
    """In the port itself: under ``tree`` the wide phase walks the loop
    estimator's directions. The first iterate starts from the same weights:
    equal base losses, and every coefficient within three loss ulps in its
    units, d·ulp(L)/μ (reading: two; the wide point (μ·inv)·g and the
    loop's μ·(inv·g) round differently, as in the reference, and one ulp
    of L(x + μv) is a whole step of the coefficient; the forwards
    themselves agree bitwise).
    Then one round agrees with the pytree route's within the reference
    test's limits for the weights (atol 1e-4, rtol 1e-3), and the mean
    local loss within a relative 1e-4 (reading 4.6e-5: the second iterate
    starts from weights moved by those coefficient steps)."""
    _, tt = _tasks("cnn")
    cfg_loop = tneural.default_config(tt, **dict(CFG,
                                                 batch_directions=False))
    cfg_wide = tneural.default_config(tt, **CFG)
    assert cfg_wide.direction_conv == "tree"
    p0 = tneural.params_init(tt, 7)
    batches = sample_batches(tt.store, torch.arange(M), prng.key(5),
                             cfg_loop.local_iters, cfg_loop.b1)
    rngs = prng.split(prng.key(6), M)
    one = {k: v[0] for k, v in batches.items()}
    r_l = tfedzo.local_phase(tt.loss, p0, one, rngs[0], cfg_loop)
    r_w = tfedzo.local_phase(tt.loss, p0, one, rngs[0], cfg_wide)
    assert float(r_w.losses[0]) == float(r_l.losses[0])
    d = sum(v.numel() for v in p0.values())
    step = d * np.spacing(np.float32(r_l.losses[0])) / CFG["mu"]
    np.testing.assert_allclose(r_w.coeffs[0].numpy(), r_l.coeffs[0].numpy(),
                               rtol=0, atol=3 * step)
    p_l, m_l = tfedzo.round_simulated(tt.loss, p0, batches, rngs, cfg_loop)
    p_w, m_w = tfedzo.round_simulated(tt.loss, p0, batches, rngs, cfg_wide)
    np.testing.assert_allclose(float(m_w["mean_local_loss"]),
                               float(m_l["mean_local_loss"]), rtol=1e-4)
    _close(convert.to_numpy(p_w), convert.to_numpy(p_l), atol=1e-4,
           rtol=1e-3)


def test_wide_route_value_errors_match_reference():
    """The reference's ValueErrors, case by case: the wide-only conventions
    without ``batch_directions``, coordinate directions on the wide route,
    an unknown block convention, and ``tree`` blocks without the tree."""
    jt, tt = _tasks("softmax")
    p0 = jax.device_get(jneural.params_init(jt, 7))
    batches, rngs, tb, trngs = _round_inputs(jt, JConfig(**CFG))
    tp = convert.to_torch(p0)
    for kw in (dict(batch_directions=False, direction_conv="surrogate"),
               dict(batch_directions=False, direction_conv="channel"),
               dict(estimator="coordinate")):
        cfg = dict(CFG, **kw)
        with pytest.raises(ValueError) as jerr:
            jfedzo.round_simulated(jt.loss, p0, batches, rngs,
                                   JConfig(**cfg))
        with pytest.raises(ValueError) as terr:
            tfedzo.round_simulated(tt.loss, tp, tb, trngs, TConfig(**cfg))
        assert str(terr.value) == str(jerr.value)
    jspec = jflat.flat_spec(p0, block=128)
    tspec = tflat.flat_spec(tp, block=128)
    for kw in (dict(conv="nope"), dict(conv="tree"),
               dict(kind="coordinate")):
        with pytest.raises(ValueError) as jerr:
            jest.direction_block(rngs[0], jspec, 3, **kw)
        with pytest.raises(ValueError) as terr:
            test_.direction_block(trngs[0], tspec, 3, **kw)
        assert str(terr.value) == str(jerr.value)


def test_train_step_ignores_batch_directions_as_the_reference_does():
    """``make_train_step`` is one pytree iterate whatever
    ``batch_directions`` says (the reference's ``local_iterate`` never reads
    it): the step with it on is the step with it off, bit for bit."""
    _, tt = _tasks("softmax")
    p0 = tneural.params_init(tt, 7)
    batch = {k: v[:6] for k, v in tt.test.items()}
    outs = [tfedzo.make_train_step(tt.loss, TConfig(
        b2=3, mu=1e-3, lr=2e-2, batch_directions=on))(p0, batch,
                                                      prng.key(3))
            for on in (False, True)]
    for k in p0:
        assert torch.equal(outs[0][0][k], outs[1][0][k])
    assert torch.equal(outs[0][1]["loss"], outs[1][1]["loss"])


# ---------------------------------------------------------------------------
# bfloat16 normals on the tree convention


@pytest.mark.parametrize("seed,shape", [(3, (1000, 37)), (9, (7,)),
                                        (1, (129, 3, 5)), (2, (1,)),
                                        (5, (33, 65))])
def test_bfloat16_normal_is_bitwise_jax(seed, shape):
    """``jax.random.normal(k, shape, jnp.bfloat16)`` bit for bit over
    ragged shapes, and for a batch of keys (the wide route's draw) against
    ``jax.vmap``. A bfloat16 draw takes one of 128 values (7 mantissa bits
    from 8 random bits): the larger shapes reach all of them."""
    k = jax.random.key(seed)
    want = np.asarray(jax.random.normal(k, shape, jnp.bfloat16)).view(
        np.uint16)
    got = prng.normal(_tkey(k), shape, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), want)
    if np.prod(shape) >= 10_000:
        assert len(np.unique(want)) == 128
    keys = jax.random.split(k, 3)
    want = np.asarray(jax.vmap(lambda kk: jax.random.normal(
        kk, shape, jnp.bfloat16))(keys)).view(np.uint16)
    got = prng.normal(_tkey(keys), shape, dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("kind", ["sphere", "gaussian"])
@pytest.mark.parametrize("task", ["softmax", "transformer"])
def test_bfloat16_pytree_round_matches_reference(task, kind):
    """Two rounds of the pytree route with ``direction_dtype="bfloat16"``
    on the tree convention, from the same weights: within 1e-3. The port
    draws the directions bitwise and moves by bf16(μ)·v as the reference
    does; inside its compiled round XLA keeps some bfloat16 products in
    float32 (the sphere's g before the norm), which the port rounds: the
    directions then differ by a bfloat16 ulp in some elements, well inside
    the trajectory tolerance."""
    jt, tt = _tasks(task)
    kw = dict(CFG, batch_directions=False, estimator=kind,
              direction_dtype="bfloat16")
    jcfg, tcfg = jneural.default_config(jt, **kw), \
        tneural.default_config(tt, **kw)
    p0 = jneural.params_init(jt, jcfg.seed)
    jres = jsim.run_experiment(jt.loss, p0, jt.store, jcfg, 2, donate=False)
    tres = tneural.run(tt, tcfg, 2, eval_every=0,
                       params=convert.to_torch(jax.device_get(p0)))
    _close(convert.to_numpy(tres.params), jax.device_get(jres.params))
    np.testing.assert_allclose(tres.metrics["mean_local_loss"].numpy(),
                               np.asarray(jres.metrics["mean_local_loss"]),
                               rtol=0, atol=ATOL)
