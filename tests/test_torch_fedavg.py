"""First-order training in the port against a live JAX run: FedAvg's
``local_phase``, ``round_simulated`` and ``make_train_step``
(``core/fedavg.py``), the optimizers (``optim/sgd.py``), the gradients of
the two forward kernels' ``autograd.Function``s (``kernels/ops.py``), and
the training CLI's ``--algo fedavg --opt sgd|adam``.

The reference differentiates its jnp math with ``jax.grad``; the port
differentiates through autograd, the RMSNorm and attention calls through
their plain versions (on the CPU the forward is the plain version too, so
the wrappers' gradients are bitwise autograd of the plain version here).
No ZO coefficient amplifies the rounding: first-order trajectories agree
to float32 reordering, so the tolerances are relative 1e-5 or a few ulps
of the weights (each stands beside its reading). Sizes: softmax 24×4, the
SmallCNN 12×12×1 width 4 and the transformer track at its test size (6
clients, M = 3, H = 2, b1 = 8); qwen2-0.5b-smoke at batch 2 × seq 16.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sim as jsim
from repro.configs import get_config as jget_config
from repro.configs.base import FedZOConfig as JConfig
from repro.core import fedavg as jfedavg
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.optim import sgd as jsgd
from repro.workloads import neural as jneural
from repro_torch.configs import get_config
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedavg
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.launch import train as ttrain
from repro_torch.models import api
from repro_torch.optim import sgd
from repro_torch.utils import convert, prng
from repro_torch.workloads import neural as tneural

TASKS = {
    "softmax": dict(n_train=320, n_test=96, n_clients=6, n_features=24,
                    n_classes=4, alpha=0.5),
    "cnn": dict(n_train=240, n_test=64, n_clients=6, n_classes=4,
                image_shape=(12, 12, 1), width=4),
    "transformer": dict(n_train=180, n_test=48, n_clients=6, n_features=24,
                        n_classes=4, n_patches=4, d_model=16, d_ff=32,
                        n_heads=2),
}
ROUND = dict(n_participating=3, local_iters=2, b1=8, lr=5e-2, seed=11,
             snr_db=5.0)
SMOKE = "qwen2-0.5b-smoke"


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
            out[prefix + k] = (v.detach().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _close(got, want, rtol, atol=0.0):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _setup(name):
    jt = jneural.make_task(name, **TASKS[name])
    tt = tneural.make_task(name, device="cpu", **TASKS[name])
    cfg = jneural.default_config(jt, **ROUND)
    p0 = jax.device_get(jneural.params_init(jt, cfg.seed))
    idx = jsim.sample_participants(jax.random.key(3), 6, 3)
    batches = jax.device_get(jsim.sample_batches(
        jt.store, idx, jax.random.key(4), cfg.local_iters, cfg.b1))
    return jt, tt, p0, batches


def _no_grad_left(tree):
    return not any(v.requires_grad for v in _flat_t(tree))


def _flat_t(tree):
    for v in tree.values():
        yield from (_flat_t(v) if isinstance(v, dict) else [v])


@pytest.mark.parametrize("name", sorted(TASKS))
def test_local_phase_matches_reference(name):
    """One client's H = 2 SGD steps: weights within relative 1e-5 plus 1e-7
    (largest absolute differences 3.7e-9 softmax, 1.5e-8 CNN, 6.0e-8
    track), losses within 1e-6 relative (readings 0 to 1 ulp)."""
    jt, tt, p0, batches = _setup(name)
    cfg = dict(ROUND)
    b0 = jax.tree.map(lambda v: v[0], batches)
    jp, jl = jfedavg.local_phase(jt.loss, jax.tree.map(jnp.asarray, p0),
                                 jax.tree.map(jnp.asarray, b0),
                                 JConfig(**cfg))
    tp, tl = fedavg.local_phase(tt.loss, convert.to_torch(p0),
                                convert.to_torch(b0), FedZOConfig(**cfg))
    _close(tp, jax.device_get(jp), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    assert _no_grad_left(tp)


@pytest.mark.parametrize("air,weighted", [(False, False), (False, True),
                                          (True, True)],
                         ids=["mean", "weighted", "aircomp"])
@pytest.mark.parametrize("name", sorted(TASKS))
def test_round_matches_reference(name, air, weighted):
    """One FedAvg round over M = 3 clients from the same weights, batches
    and channel key: the plain (1/M)·Σ mean, the size-weighted mean, and
    AirComp with channel scheduling (5 dB; the Eq.-17 noise comes from the
    same key and scales with Δ_max). Weights within relative 1e-5 plus
    1e-6 (largest absolute differences 3.7e-9 to 6.0e-8 on every task
    and aggregation), the metrics within relative 1e-5 (readings up to
    2.2e-7, Δ_max), m_effective exactly."""
    jt, tt, p0, batches = _setup(name)
    kw = dict(ROUND, aircomp=air, channel_schedule=air)
    w = np.asarray([1.3, 0.6, 1.1], np.float32) if weighted else None
    kc = jax.random.key(5)
    jp, jm = jfedavg.round_simulated(
        jt.loss, jax.tree.map(jnp.asarray, p0),
        jax.tree.map(jnp.asarray, batches), JConfig(**kw), channel_rng=kc,
        weights=None if w is None else jnp.asarray(w))
    tp, tm = fedavg.round_simulated(
        tt.loss, convert.to_torch(p0), convert.to_torch(batches),
        FedZOConfig(**kw), channel_rng=prng.as_key(jax.random.key_data(kc)),
        weights=None if w is None else torch.from_numpy(w))
    _close(tp, jax.device_get(jp), rtol=1e-5, atol=1e-6)
    assert sorted(tm) == sorted(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    assert _no_grad_left(tp)


def test_round_takes_the_batched_form_of_the_track(monkeypatch):
    """The track's round runs its cohort as one batched forward and
    backward: with ``torch.func.vmap`` made to raise it still runs, and
    every weight equals the round over the clients one at a time (rows of
    the cohort never mix; reading: bitwise)."""
    jt, tt, p0, batches = _setup("transformer")
    cfg = FedZOConfig(**ROUND)
    tb = convert.to_torch(batches)

    def no_vmap(*a, **k):
        raise AssertionError("torch.func.vmap reached")

    monkeypatch.setattr(torch.func, "vmap", no_vmap)
    got, _ = fedavg.cohort_phase(tt.loss, convert.to_torch(p0), tb, cfg)
    for i in range(3):
        one, _ = fedavg.local_phase(tt.loss, convert.to_torch(p0),
                                    {k: v[i] for k, v in tb.items()}, cfg)
        g, o = _flat({k: v for k, v in got.items()}), _flat(one)
        for k in o:
            np.testing.assert_array_equal(g[k][i], o[k], err_msg=k)


def _lm_batch(seed, b=2, s=16):
    toks = jsyn.lm_token_stream(20_000, 512, seed=seed)
    return jsyn.lm_batches(toks, b, s, np.random.default_rng(seed))


def test_lm_train_step_matches_reference():
    """``make_train_step`` on qwen2-0.5b-smoke (lr 1e-3): the loss within 2
    ulps (reading 0) and the stepped weights within 1e-7 absolute
    (reading 1.5e-8: a gradient agrees to float32 reordering and lr scales
    it down)."""
    jm, tm = japi.build(jget_config(SMOKE)), api.build(get_config(SMOKE))
    p0 = jax.device_get(jm.init(jax.random.key(0)))
    batch = _lm_batch(3)
    cfg = dict(lr=1e-3)
    jp, jmet = jfedavg.make_train_step(jm.loss, JConfig(**cfg))(
        jax.tree.map(jnp.asarray, p0), jax.tree.map(jnp.asarray, batch),
        jax.random.key(1))
    tp, tmet = fedavg.make_train_step(tm.loss, FedZOConfig(**cfg))(
        convert.to_torch(p0), convert.to_torch(batch), prng.key(1))
    want = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - want) <= 2 * np.spacing(
        np.float32(want))
    _close(tp, jax.device_get(jp), rtol=0, atol=1e-7)
    assert _no_grad_left(tp)


def test_lm_gradient_matches_jax_grad():
    """The LM's gradient (through the RMSNorm and attention wrappers)
    against ``jax.grad`` of the reference's jnp model: relative 1e-4 of
    each leaf's largest entry (reading 1.3e-6)."""
    jm, tm = japi.build(jget_config(SMOKE)), api.build(get_config(SMOKE))
    p0 = jax.device_get(jm.init(jax.random.key(0)))
    batch = _lm_batch(4)
    jg = jax.device_get(jax.grad(jm.loss)(jax.tree.map(jnp.asarray, p0),
                                          jax.tree.map(jnp.asarray, batch)))
    _, tg = fedavg.value_and_grad(tm.loss, convert.to_torch(p0),
                                  convert.to_torch(batch))
    g, w = _flat(tg), _flat(jg)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0,
                                   atol=1e-4 * np.abs(w[k]).max(),
                                   err_msg=k)


def _tree_pair(seed, shapes):
    rs = np.random.default_rng(seed)
    return {k: rs.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (3, 5), "b": {"c": (7,)}}


def _nested(seed):
    rs = np.random.default_rng(seed)
    return {"a": rs.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rs.standard_normal((7,)).astype(np.float32)}}


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_apply_matches_reference(momentum):
    """Three SGD steps, with and without momentum: bitwise."""
    p, jst = _nested(0), jsgd.sgd_init(_nested(0), momentum)
    tp, tst = convert.to_torch(p), sgd.sgd_init(convert.to_torch(p),
                                                momentum)
    jp = jax.tree.map(jnp.asarray, p)
    for i in range(3):
        g = _nested(i + 1)
        jp, jst = jsgd.sgd_apply(jp, jax.tree.map(jnp.asarray, g), jst,
                                 lr=0.1, momentum=momentum)
        tp, tst = sgd.sgd_apply(tp, convert.to_torch(g), tst, lr=0.1,
                                momentum=momentum)
    _close(tp, jax.device_get(jp), rtol=0)


def test_adam_apply_matches_reference():
    """Four Adam steps (bias correction from the float32 count): within 2
    ulps of the weights (reading: bitwise or 1 ulp, torch's and XLA's
    float32 pow and sqrt)."""
    p = _nested(0)
    jp, jst = jax.tree.map(jnp.asarray, p), jsgd.adam_init(p)
    tp = convert.to_torch(p)
    tst = sgd.adam_init(tp)
    for i in range(4):
        g = _nested(i + 5)
        jp, jst = jsgd.adam_apply(jp, jax.tree.map(jnp.asarray, g), jst,
                                  lr=1e-2)
        tp, tst = sgd.adam_apply(tp, convert.to_torch(g), tst, lr=1e-2)
    assert int(tst.count) == int(jst.count) == 4
    g, w = _flat(tp), _flat(jax.device_get(jp))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0,
                                   atol=2 * np.spacing(np.abs(w[k])).max())
    _close({"mu": tst.mu, "nu": tst.nu},
           {"mu": jax.device_get(jst.mu), "nu": jax.device_get(jst.nu)},
           rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 3])
def test_cosine_lr_matches_reference(warmup):
    """The schedule over 13 steps, to past its end: within base_lr times
    one float32 ulp of the ``1 + cos(π·t)`` factor, which cancels near the
    end (torch's and XLA's float32 cos; reading 2.8e-9 against 1.2e-8)."""
    for step in range(13):
        want = float(jsgd.cosine_lr(step, base_lr=0.1, total_steps=10,
                                    warmup=warmup))
        got = float(sgd.cosine_lr(step, base_lr=0.1, total_steps=10,
                                  warmup=warmup))
        assert abs(got - want) <= 0.1 * np.spacing(np.float32(1.0))


@pytest.mark.parametrize("groups,shape", [(1, (4, 6, 32)), (3, (3, 5, 16)),
                                          (4, (4, 2, 3, 64))])
def test_rmsnorm_backward_is_the_plain_versions(groups, shape):
    """``ops.rmsnorm``'s gradients in x and in a ``[D]`` or ``[G, D]``
    scale (shaped as the scale) against autograd of the plain version on
    the same inputs: bitwise on the CPU, where the forward is the plain
    version; the wrapper's output carries a ``grad_fn`` only when an input
    asks for a gradient."""
    rs = np.random.default_rng(groups)
    x = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    sshape = (shape[-1],) if groups == 1 else (groups, shape[-1])
    s = torch.from_numpy(rs.standard_normal(sshape).astype(np.float32))
    g = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    xa, sa = x.clone().requires_grad_(), s.clone().requires_grad_()
    got = torch.autograd.grad(ops.rmsnorm(xa, sa), [xa, sa], g)
    xb, sb = x.clone().requires_grad_(), s.clone().requires_grad_()
    want = torch.autograd.grad(rmsnorm_plain(xb, sb), [xb, sb], g)
    assert got[1].shape == s.shape
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ops.rmsnorm(x, s).grad_fn is None
    xs = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad(ops.rmsnorm(xs, s), [xs], g)
    assert torch.equal(gx, want[0])


@pytest.mark.parametrize("hd,hq,hkv,window", [(8, 2, 2, 0), (16, 4, 2, 0),
                                              (16, 4, 1, 3), (64, 2, 1, 0)])
def test_attention_backward_is_the_plain_versions(hd, hq, hkv, window):
    """``ops.attention``'s gradients in q, k and v (GQA, a window, head dims
    8, 16 and 64, a ragged S = 70 across two key blocks) against autograd
    of the plain version: bitwise on the CPU."""
    rs = np.random.default_rng(hd + hq)
    b, s = 2, 70
    q, k, v = (torch.from_numpy(rs.standard_normal(sh).astype(np.float32))
               for sh in ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    g = torch.from_numpy(rs.standard_normal((b, s, hq, hd))
                         .astype(np.float32))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.attention(*a, window=window), a, g)
    p = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*p, window=window), p,
                               g)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_cli_fedavg_matches_reference(opt, tmp_path, monkeypatch, capsys):
    """``--algo fedavg --opt adam|sgd --device cpu``: the reference CLI's
    first line (default lr 1e-3) and printed losses (3 steps at batch 2 ×
    seq 16; reading: equal at the printed 4 decimals), the histories within
    1e-5 (readings 9.5e-7 adam, 4.8e-7 sgd: 1 or 2 loss ulps), ``algo``
    recorded, the weights requiring no gradient."""
    common = ["--algo", "fedavg", "--opt", opt, "--steps", "3",
              "--log-every", "1", "--batch", "2", "--seq", "16"]
    monkeypatch.setattr(sys, "argv",
                        ["train", *common, "--out", str(tmp_path / "j")])
    jtrain.main()
    jout = capsys.readouterr().out.splitlines()
    res = ttrain.main([*common, "--device", "cpu", "--out",
                       str(tmp_path / "t")])
    tout = capsys.readouterr().out.splitlines()
    assert jout[0] == tout[0] and "lr=0.001" in tout[0]
    assert [ln.split()[:4] for ln in jout[1:]] == \
        [ln.split()[:4] for ln in tout[1:]]
    jhist = __import__("json").load(open(tmp_path / "j" / "history.json"))
    thist = __import__("json").load(open(tmp_path / "t" / "history.json"))
    assert thist["algo"] == jhist["algo"] == "fedavg"
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=0,
                               atol=1e-5)
    assert _no_grad_left(res.params)
    assert all(r == {k: 0 for k in ops.LAUNCHES} for r in res.launches)
