"""The port's ssm and hybrid families (``rwkv6-7b``: the RWKV-6 time and
channel mix; ``hymba-1.5b``: attention beside a selective SSM) against a
live JAX run: every function of ``models/ssm.py``, the configs and init
trees, the loss, prefill and decode, the decode-against-prefill check and
the cache sizes of the reference's own tests, one FedZO train step, the
serve CLI's tokens and the full-width parameter counts.

Inputs come from numpy seeds, in float32; both packages start from the
same weights (``utils/convert.to_torch`` of the reference's init) at
``-smoke`` size. T = 37 is not a multiple of the WKV chunk (16), T = 300
spans two SSM chunks (256) and pads the second. Each tolerance stands
beside its reason and its reading: XLA fuses multiply-adds on the CPU
(the scans' ``a·h + b``) and sums its products in other orders, so the
floats agree to a few float32 ulps of their magnitude, not bitwise.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_config as jget_config
from repro.configs.base import FedZOConfig as JConfig
from repro.configs.base import ShapeConfig as JShape
from repro.core import fedzo as jfedzo
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.configs.base import FedZOConfig, ShapeConfig
from repro_torch.core import fedzo
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.utils import convert, prng
from repro_torch.utils.flatparams import _leaves, flat_spec

ARCHS = ("rwkv6-7b", "hymba-1.5b")
SMOKES = tuple(a + "-smoke" for a in ARCHS)
B, S = 2, 32
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    """Within ``rel`` of the largest magnitude of ``want``."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _jpaths(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(k.key for k in path), leaf) for path, leaf in leaves]


def _models(arch):
    jm, tm = japi.build(jget_config(arch)), api.build(get_config(arch))
    jp = jax.device_get(jm.init(jax.random.key(0)))
    return jm, tm, jp, convert.to_torch(jp)


def _rnd(seed, *shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _layer0(tree):
    return jax.tree.map(lambda v: v[0], tree)


@pytest.mark.parametrize("arch", ARCHS + SMOKES)
def test_configs_are_the_reference_configs(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))


@pytest.mark.parametrize("arch", SMOKES)
def test_init_tree_matches_the_reference(arch):
    """Paths (``tmix``/``cmix`` without attention for rwkv6, ``mamba``
    beside the attention for hymba), shapes, dtypes (the float32 ``w0``,
    ``u``, ``a_log``, ``dt_bias``, ``d_skip``) and values from the same
    seed: the normals within a few float32 ulp (reading 2.1e-7 of a leaf's
    largest weight)."""
    jp = jax.device_get(japi.build(jget_config(arch)).init(
        jax.random.key(0)))
    tp = api.build(get_config(arch)).init(prng.key(0), device="cpu")
    want, got = _jpaths(jp), _leaves(tp)
    assert [n for n, _ in want] == ["/".join(p) for p, _ in got]
    for (name, j), (_, t) in zip(want, got):
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype) == f"torch.{j.dtype}", name
        _close(t, j, 1e-6)


@pytest.mark.parametrize("arch,want", [("rwkv6-7b", 7_534_944_256),
                                       ("hymba-1.5b", 1_393_000_000)])
def test_full_width_parameter_counts_on_meta(arch, want):
    """The full-width trees on ``meta``: the reference's count and each
    leaf's shape and dtype (bfloat16, the SSM leaves float32)."""
    specs = jtf.param_specs(jget_config(arch))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(specs)) == want
    tp = ttf.init_params(prng.key(0), get_config(arch), device="meta")
    assert flat_spec(tp).d == want
    for (name, j), (_, t) in zip(_jpaths(specs), _leaves(tp)):
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype) == f"torch.{j.dtype}", name


@pytest.mark.parametrize("T", [37, 300])
def test_wkv_chunked_and_step_match_the_reference(T):
    """The chunked WKV from a nonzero state (out and the final state within
    1e-5 of their largest magnitude; readings 2.5e-6 and 1.3e-7 at T 37,
    8.9e-7 and 3.9e-7 at T 300), and one decode step (readings 2e-8 to
    1e-7)."""
    H, hd = 2, 8
    r, k, v = (_rnd(i, B, T, H, hd) for i in range(3))
    logw = np.clip(-np.exp(_rnd(3, B, T, H, hd)), -tssm.DECAY_CLAMP, -1e-6)
    u, s0 = _rnd(4, H, hd), _rnd(5, B, H, hd, hd)
    jo, js = jssm.wkv_chunked(*map(jnp.asarray, (r, k, v, logw, u, s0)))
    to, ts = tssm.wkv_chunked(*map(_t, (r, k, v, logw, u, s0)))
    _close(to, jo)
    _close(ts, js)
    jo, js = jssm.wkv_step(*(jnp.asarray(x[:, 0]) for x in (r, k, v, logw)),
                           jnp.asarray(u), jnp.asarray(s0))
    to, ts = tssm.wkv_step(*(_t(x[:, 0]) for x in (r, k, v, logw)), _t(u),
                           _t(s0))
    _close(to, jo)
    _close(ts, js)


@pytest.mark.parametrize("T", [37, 300])
def test_rwkv_time_and_channel_mix_match_the_reference(T):
    """rwkv6-7b-smoke's layer 0: the projections, the time mix from a
    carried state and token shift, its decode step, the channel mix
    (readings 0 to 1.3e-6 of the largest magnitude)."""
    cfg, jcfg = get_config(SMOKES[0]), jget_config(SMOKES[0])
    jp = _layer0(_models(SMOKES[0])[2]["blocks"])
    tp = convert.to_torch(jp)
    d = cfg.d_model
    x, xp = _rnd(6, B, T, d), _rnd(7, B, T, d)
    s0, last = _rnd(8, B, cfg.n_heads, cfg.head_dim, cfg.head_dim), \
        _rnd(9, B, d)
    for j, t in zip(jssm._tmix_project(jp["tmix"], jcfg, jnp.asarray(x),
                                       jnp.asarray(xp)),
                    tssm._tmix_project(tp["tmix"], cfg, _t(x), _t(xp))):
        _close(t, j)
    jo, (js, jl) = jssm.rwkv_tmix_fwd(jp["tmix"], jcfg, jnp.asarray(x),
                                      state=jnp.asarray(s0),
                                      x_prev_last=jnp.asarray(last))
    to, (ts, tl) = tssm.rwkv_tmix_fwd(tp["tmix"], cfg, _t(x), state=_t(s0),
                                      x_prev_last=_t(last))
    _close(to, jo)
    _close(ts, js)
    assert torch.equal(tl, _t(x[:, -1]))
    jo, (js, _) = jssm.rwkv_tmix_step(jp["tmix"], jcfg, jnp.asarray(x[:, :1]),
                                      jnp.asarray(s0), jnp.asarray(last))
    to, (ts, _) = tssm.rwkv_tmix_step(tp["tmix"], cfg, _t(x[:, :1]), _t(s0),
                                      _t(last))
    _close(to, jo)
    _close(ts, js)
    _close(tssm.rwkv_cmix_fwd(tp["cmix"], _t(x), _t(xp)),
           jssm.rwkv_cmix_fwd(jp["cmix"], jnp.asarray(x), jnp.asarray(xp)))


def test_associative_scan_is_jax_recursion():
    """``associative_scan`` with the SSM's combine, over lengths 1 to 300
    (even, odd, one element): bitwise ``jax.lax.associative_scan``'s (its
    eager combine rounds each product and sum, as torch does), but for the
    decay products that fall below float32's smallest normal after some
    hundred steps, which XLA flushes to zero on the CPU (differences of
    1.2e-38 at lengths 256 and 300)."""
    comb = lambda e1, e2: (e2[0] * e1[0], e2[0] * e1[1] + e2[1])  # noqa
    rs = np.random.default_rng(10)
    for T in (1, 2, 3, 7, 16, 37, 256, 300):
        a = rs.uniform(0.3, 1.0, (2, T, 5, 3)).astype(np.float32)
        b = rs.standard_normal((2, T, 5, 3)).astype(np.float32)
        ja, jb = jax.lax.associative_scan(comb, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
        ta, tb = tssm.associative_scan(tssm._combine, (_t(a), _t(b)), 1)
        assert np.array_equal(tb.numpy(), np.asarray(jb)), T
        normal = np.abs(np.asarray(ja)) >= np.finfo(np.float32).tiny
        assert np.array_equal(ta.numpy()[normal], np.asarray(ja)[normal]), T
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                                   atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("T", [37, 300])
def test_selective_ssm_matches_the_reference(T):
    """hymba-1.5b-smoke's Mamba branch with a nonzero ``a_log`` and
    ``dt_bias`` (zero at init): a, b and C (readings 1.9e-7 to 4.9e-7); the
    chunked scan from a nonzero state, padded with identity elements at T
    300 (h and the final state; readings 8.5e-8 to 1.2e-7: XLA's fused a·h
    + b); the branch's output and state (readings 1.9e-7 to 3.3e-7), and
    one decode step (readings 2e-7 to 4.4e-7); the softplus is
    ``logaddexp(x, 0)``, bitwise jax's, also above 20."""
    cfg, jcfg = get_config(SMOKES[1]), jget_config(SMOKES[1])
    jp = dict(_layer0(_models(SMOKES[1])[2]["blocks"])["mamba"])
    jp["a_log"] = _rnd(11, *jp["a_log"].shape)
    jp["dt_bias"] = _rnd(12, *jp["dt_bias"].shape)
    tp = convert.to_torch(jp)
    d, n = cfg.d_model, cfg.ssm_state
    x = _rnd(13, B, T, d)
    for j, t in zip(jssm._mamba_abc(jp, jnp.asarray(x)),
                    tssm._mamba_abc(tp, _t(x))):
        _close(t, j)
    a = np.random.default_rng(14).uniform(0.3, 1.0, (B, T, d, n)).astype(
        np.float32)
    b, s0 = _rnd(15, B, T, d, n), _rnd(16, B, d, n)
    jh, js = jssm.diag_ssm_scan(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(s0))
    th, ts = tssm.diag_ssm_scan(_t(a), _t(b), _t(s0))
    _close(th, jh)
    _close(ts, js)
    jo, js = jssm.mamba_fwd(jp, jcfg, jnp.asarray(x), state=jnp.asarray(s0))
    to, ts = tssm.mamba_fwd(tp, cfg, _t(x), state=_t(s0))
    _close(to, jo)
    _close(ts, js)
    jo, js = jssm.mamba_step(jp, jcfg, jnp.asarray(x[:, :1]),
                             jnp.asarray(s0))
    to, ts = tssm.mamba_step(tp, cfg, _t(x[:, :1]), _t(s0))
    _close(to, jo)
    _close(ts, js)
    z = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 21.0, 40.0], np.float32)
    assert np.array_equal(tssm._softplus(_t(z)).numpy(),
                          np.asarray(jax.nn.softplus(jnp.asarray(z))))


@pytest.mark.parametrize("arch", SMOKES)
def test_loss_prefill_and_decode_match_the_reference(arch):
    """The train loss (within 8 ulps; readings 4 and 1), prefill at width S
    + 4 and 4 decode steps on the reference's greedy tokens: logits and
    every cache leaf (the WKV state and token shifts; the ring KV and the
    SSM state) within 1e-5 of their largest magnitude (readings 7.8e-7 to
    1.8e-6). No kernel launches on the CPU (plain versions)."""
    jm, tm, jp, tp = _models(arch)
    tb = api.make_batch(tm, ShapeConfig("t", S, B, "train"), prng.key(1),
                        device="cpu")
    jb = japi.make_batch(jm, JShape("t", S, B, "train"), jax.random.key(1))
    jl, tl = float(jm.loss(jp, jb)), float(tm.loss(tp, tb))
    assert abs(jl - tl) <= 8 * np.spacing(np.float32(jl))
    shape = ShapeConfig("p", S, B, "prefill")
    jb = japi.make_batch(jm, JShape("p", S, B, "prefill"), jax.random.key(2))
    tb = api.make_batch(tm, shape, prng.key(2), device="cpu")
    jl, jc = jm.prefill(jp, jb, S + 4)
    ops.reset_launches()
    tl, tc = tm.prefill(tp, tb, S + 4)
    _close(tl, jl)
    for i in range(4):
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        jl, jc = jm.decode(jp, {"tokens": tok}, jc,
                           jnp.asarray(S + i, jnp.int32))
        tl, tc = tm.decode(tp, {"tokens": torch.from_numpy(np.array(tok))},
                           tc, torch.tensor(S + i))
        _close(tl, jl)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    want = _jpaths(jax.device_get(jc))
    assert [n for n, _ in want] == ["/".join(p) for p, _ in _leaves(tc)]
    for (name, j), (_, t) in zip(want, _leaves(tc)):
        assert str(t.dtype) == f"torch.{j.dtype}", name
        _close(t, j)


@pytest.mark.parametrize("arch", SMOKES)
def test_decode_matches_prefill(arch):
    """The reference's consistency check (``tests/test_arch_smoke.py``):
    one decode step at position S against a prefill of S + 1 tokens, its
    tolerance atol 2e-4 and rtol 2e-3 (readings 6.4e-7 and 9.4e-7 of the
    largest logit)."""
    tm = api.build(get_config(arch))
    tp = tm.init(prng.key(0), device="cpu")
    batch = api.make_batch(tm, ShapeConfig("p", S, B, "prefill"),
                           prng.key(4), device="cpu")
    _, cache = tm.prefill(tp, batch, S + 4)
    nxt = prng.randint(prng.key(5), (B, 1), 0, tm.cfg.vocab)
    dec, _ = tm.decode(tp, {"tokens": nxt}, cache, torch.tensor(S))
    ref, _ = tm.prefill(tp, {"tokens": torch.cat([batch["tokens"], nxt], 1)},
                        S + 5)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), atol=2e-4,
                               rtol=2e-3)


@pytest.mark.parametrize("arch", SMOKES)
def test_cache_size_as_the_reference_checks(arch):
    """``tests/test_arch_smoke.py``'s cache sizes: rwkv6's is pure state,
    the same at widths 16 and 64; hymba's grows with the ring but stays
    under 8x; both equal the reference's ``init_cache`` leaf for leaf, and
    zero."""
    cfg = get_config(arch)
    tm = api.build(cfg)
    sizes = []
    for width in (16, 64):
        c = tm.init_cache(B, width, device="cpu")
        jc = jtf.init_cache(jget_config(arch), B, width)
        want = _jpaths(jc)
        assert [n for n, _ in want] == ["/".join(p) for p, _ in _leaves(c)]
        for (name, j), (_, t) in zip(want, _leaves(c)):
            assert tuple(t.shape) == j.shape, name
            assert str(t.dtype) == f"torch.{j.dtype}", name
            assert not bool(t.any())
        sizes.append(sum(t.numel() for _, t in _leaves(c)))
    if cfg.family == "ssm":
        assert sizes[0] == sizes[1]
    else:
        assert sizes[0] < sizes[1] < 8 * sizes[0]


@pytest.mark.parametrize("flat", [False, True], ids=["pytree", "flat"])
@pytest.mark.parametrize("arch", SMOKES)
def test_train_step_matches_the_reference(arch, flat):
    """One FedZO step (b2 2, μ 1e-2, lr 1e-3) from the same weights, key
    and batch, on the pytree route (the launcher's) and the flat one: the
    loss within 8 ulps, the coefficient norm within 8 loss ulps' worth of
    a coefficient, every parameter within 1e-3 of the reference's while
    the step moves one by at least five times that. A loss ulp (4.8e-7
    near 6.8) moves a coefficient by d·ulp/μ (about 30 here, against norms
    of 2.7e5) and a weight by lr/b2 times that times max |v_i|, about
    1e-4, so 1e-3 is about ten ulps. Readings: loss 0 to 3 ulps; norms 0.5
    to 2.5 loss ulps; parameters 1.1e-4 to 2.7e-4 against moves of 9.7e-3
    (hymba's pytree step) to 0.98."""
    kw = dict(lr=1e-3, mu=1e-2, b2=2, estimator="sphere", flat_params=flat)
    jm, tm, jp0, tp0 = _models(arch)
    jstep = jax.jit(jfedzo.make_train_step(lambda p, b: jm.loss(p, b),
                                           JConfig(**kw)))
    tstep = fedzo.make_train_step(tm.loss, FedZOConfig(**kw))
    toks = jsyn.lm_token_stream(20_000, 512, seed=0)
    b = jsyn.lm_batches(toks, B, S, np.random.default_rng(0))
    jp, jmet = jstep(jp0, {k: jnp.asarray(v) for k, v in b.items()},
                     jax.random.key(2))
    tp, tmet = tstep(tp0, {k: torch.from_numpy(v) for k, v in b.items()},
                     prng.key(2))
    jl = float(jmet["loss"])
    assert abs(jl - float(tmet["loss"])) <= 8 * np.spacing(np.float32(jl))
    unit = flat_spec(tp0).d * np.spacing(np.float32(jl)) / kw["mu"]
    assert abs(float(tmet["coeff_norm"]) - float(jmet["coeff_norm"])) \
        <= 8 * unit
    worst, moved = 0.0, 0.0
    got = {"/".join(p): v for p, v in _leaves(tp)}
    init = dict(_jpaths(jp0))
    for name, want in _jpaths(jax.device_get(jp)):
        worst = max(worst, float(np.abs(got[name].numpy() - want).max()))
        moved = max(moved, float(np.abs(want - init[name]).max()))
    assert worst <= 1e-3
    assert moved >= 5e-3


def _request_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("  request")]


@pytest.mark.parametrize("arch", SMOKES)
def test_serve_cli_prints_the_reference_tokens(arch, monkeypatch):
    from repro.launch import serve as jserve
    argv = ["--arch", arch, "--gen", "6", "--batch", "2"]
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with contextlib.redirect_stdout(buf):
        jserve.main()
    want = _request_lines(buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = serve.main(argv + ["--device", "cpu"])
    assert _request_lines(buf.getvalue()) == want
    assert "serve OK" in buf.getvalue()
    assert res.tokens.shape == (2, 7)
    assert res.prefill_launches == dict.fromkeys(ops.LAUNCHES, 0)
