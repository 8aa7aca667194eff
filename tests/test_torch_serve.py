"""The port's serving path for the dense family against a live JAX run:
the shape registry, ``make_batch``, prefill and ring-cache decode of the
four dense configs at ``-smoke`` size, the categorical sampler and the
serve CLI (``repro_torch.launch.serve`` against ``repro.launch.serve``).

Both packages start from the same weights (``utils/convert.to_torch`` of
the reference's init). Integer work (batches, cache slots, sampled tokens)
is bitwise; logits and caches are float32 within 1e-5 of the largest
magnitude (torch and XLA sum the GEMMs in other orders; readings of a few
1e-7 stand beside each limit).
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
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.models import api as japi
from repro.models import transformer as jtf
from repro_torch.configs import (INPUT_SHAPES, SHAPE_IDS, get_config,
                                 get_shape)
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models import transformer as ttf
from repro_torch.utils import convert, prng
from repro_torch.utils.flatparams import flat_spec

DENSE = ("qwen2-0.5b", "qwen3-4b", "gemma-2b", "qwen1.5-32b")
B, S = 2, 16
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _models(arch, **over):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if over:
        jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    jm, tm = japi.build(jcfg), api.build(tcfg)
    jp = jax.device_get(jm.init(jax.random.key(0)))
    return jm, tm, jp, convert.to_torch(jp)


def _jcache(c):
    return {k: np.asarray(v) for k, v in c["blocks"].items()}


@pytest.mark.parametrize("arch", DENSE + tuple(a + "-smoke" for a in DENSE))
def test_configs_are_the_reference_configs(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))


def test_shapes_and_decode_width_are_the_reference():
    assert SHAPE_IDS == tuple(JSHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(JSHAPES[name])
        assert dataclasses.astuple(get_shape(name)) == \
            dataclasses.astuple(jget_shape(name))
        for arch in DENSE:
            assert api.decode_width(get_config(arch), shape) == \
                japi.decode_width(jget_config(arch), JSHAPES[name])
    # long_500k decodes over the long-context window's ring
    assert api.decode_width(get_config("qwen3-4b"),
                            INPUT_SHAPES["long_500k"]) == 16_384
    with pytest.raises(KeyError):
        get_shape("nope")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_is_bitwise_the_reference(kind):
    shape = ShapeConfig("t", 24, 3, kind)
    arch = "gemma-2b-smoke"
    jb = japi.make_batch(japi.build(jget_config(arch)), shape,
                         jax.random.key(4))
    tb = api.make_batch(api.build(get_config(arch)), shape, prng.key(4),
                        device="cpu")
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert tb[k].dtype == torch.int32
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("arch", [a + "-smoke" for a in DENSE])
def test_prefill_and_decode_match_reference(arch):
    """Prefill at width S + 4 (slots [0, S)), then 3 decode steps on the
    reference's greedy tokens: logits and every layer's cache."""
    jm, tm, jp, tp = _models(arch)
    cfg = tm.cfg
    shape = ShapeConfig("p", S, B, "prefill")
    jb = japi.make_batch(jm, shape, jax.random.key(1))
    tb = api.make_batch(tm, shape, prng.key(1), device="cpu")
    jl, jc = jm.prefill(jp, jb, S + 4)
    ops.reset_launches()
    tl, tc = tm.prefill(tp, tb, S + 4)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)   # plain versions
    assert tl.shape == (B, cfg.vocab)
    assert tc["blocks"]["k"].shape == (cfg.n_layers, B, S + 4,
                                       cfg.n_kv_heads, cfg.head_dim)
    _close(tl, jl)
    for k, v in _jcache(jc).items():
        _close(tc["blocks"][k], v)
    for i in range(3):
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        pos = S + i
        jl, jc = jm.decode(jp, {"tokens": tok}, jc, jnp.asarray(pos,
                                                               jnp.int32))
        tl, tc = tm.decode(tp, {"tokens": torch.from_numpy(np.asarray(tok))},
                           tc, torch.tensor(pos))
        _close(tl, jl)
        for k, v in _jcache(jc).items():
            _close(tc["blocks"][k], v)


@pytest.mark.parametrize("arch", [a + "-smoke" for a in DENSE])
def test_decode_matches_prefill(arch):
    """The reference's consistency check (``tests/test_arch_smoke.py``):
    one decode step at position S against a prefill of S + 1 tokens."""
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


@pytest.mark.parametrize("over,width", [({}, 12), ({"sliding_window": 8}, 12),
                                        ({"sliding_window": 8}, S + 4)])
def test_ring_width_and_sliding_window_match_reference(over, width):
    """A cache narrower than the prompt (the ring: ``roll(last width, S %
    width)``, then slots ``pos % W``) and a sliding window (prefill's
    windowed attention, decode's age test), 4 decode steps past the
    ring's wrap."""
    jm, tm, jp, tp = _models("qwen2-0.5b-smoke", **over)
    shape = ShapeConfig("p", S, B, "prefill")
    jb = japi.make_batch(jm, shape, jax.random.key(2))
    tb = api.make_batch(tm, shape, prng.key(2), device="cpu")
    jl, jc = jm.prefill(jp, jb, width)
    tl, tc = tm.prefill(tp, tb, width)
    _close(tl, jl)
    for k, v in _jcache(jc).items():
        _close(tc["blocks"][k], v)
    for i in range(4):
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        jl, jc = jm.decode(jp, {"tokens": tok}, jc,
                           jnp.asarray(S + i, jnp.int32))
        tl, tc = tm.decode(tp, {"tokens": torch.from_numpy(np.asarray(tok))},
                           tc, torch.tensor(S + i))
        _close(tl, jl)
        for k, v in _jcache(jc).items():
            _close(tc["blocks"][k], v)
    assert bool(torch.isfinite(tl).all())


def test_init_cache_and_bf16_weights_carry_across():
    """``init_cache`` is the reference's zeroed cache; a bfloat16 init
    converts bit for bit (the smoke config in the full config's dtype)."""
    arch = "qwen3-4b-smoke"
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jc = jtf.init_cache(jcfg, B, 24)
    tc = api.build(tcfg).init_cache(B, 24, device="cpu")
    for k, v in jc["blocks"].items():
        assert tuple(tc["blocks"][k].shape) == v.shape
        assert not bool(tc["blocks"][k].any())
    over = dict(dtype="bfloat16")
    jp = jax.device_get(japi.build(jcfg.replace(**over)).init(
        jax.random.key(0)))
    tp = convert.to_torch(jp)
    assert tp["blocks"]["attn"]["q_norm"]["scale"].dtype == torch.bfloat16
    for (name, j), (_, t) in zip(_paths(jp), _paths(tp)):
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(), np.asarray(j).view(np.int16),
            err_msg=name)


def _paths(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{pre}{k}/")
        else:
            yield pre + k, v


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_parameter_counts_on_meta(arch):
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jtf.param_specs(jget_config(arch))))
    tp = ttf.init_params(prng.key(0), get_config(arch), device="meta")
    assert flat_spec(tp).d == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_categorical_matches_jax(dtype):
    logits = np.asarray(jax.random.normal(jax.random.key(9), (4, 512)))
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    for seed in range(4):
        want = np.asarray(jax.random.categorical(jax.random.key(seed), jl))
        got = prng.categorical(prng.key(seed), tl)
        np.testing.assert_array_equal(got.numpy(), want)
    g = prng.gumbel(prng.key(3), (4, 512), dtype=getattr(torch, dtype))
    jg = np.asarray(jax.random.gumbel(jax.random.key(3), (4, 512),
                                      dtype).astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(g.float().numpy(), jg)
    else:   # torch's logs against XLA's (reading: 1 ulp)
        np.testing.assert_allclose(g.numpy(), jg, rtol=4e-7, atol=4e-7)


def _request_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("  request")]


@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_serve_cli_prints_the_reference_tokens(temperature, monkeypatch):
    from repro.launch import serve as jserve
    argv = ["--gen", "6", "--temperature", temperature]
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
    assert res.tokens.shape == (4, 7)
    assert res.prefill_launches == dict.fromkeys(ops.LAUNCHES, 0)
