"""The port's enc-dec family (``seamless-m4t-large-v2``: a bidirectional
encoder over stubbed audio-frame embeddings, a causal decoder with a
cross-attention in every layer) against a live JAX run: the configs, the
init tree, the full-width parameter count, the cross-attention and the
encoder, the loss, prefill and decode (every cache leaf), the
decode-against-prefill check, ``make_batch``, the flat and pytree train
steps, the training and serving CLIs, and the cohort loss running.

Inputs come from numpy seeds; both packages start from the same weights at
``-smoke`` size (float32). The smoke encoder and decoder have 2 layers
each, 4 query heads over 2 kv heads in self-attention and 4 heads in the
cross-attention, 16 source frames. Each tolerance stands beside its reason
and its reading.
"""
import dataclasses

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
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.utils import flatparams as jflat
from repro_torch.configs import get_config
from repro_torch.configs.base import FedZOConfig, ShapeConfig
from repro_torch.core import fedzo
from repro_torch.launch import serve, train
from repro_torch.models import api
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as ttf
from repro_torch.utils import convert, prng
from repro_torch.utils.flatparams import _leaves, flat_spec, flatten
from repro_torch.utils.tree import tree_map
from tests import _torch_xattn as xa

ARCH = "seamless-m4t-large-v2"
SMOKE = ARCH + "-smoke"
B, S = xa.B, xa.S


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    return xa.models(SMOKE)


def _rnd(seed, *shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


@pytest.mark.parametrize("arch", [ARCH, SMOKE])
def test_configs_are_the_reference_configs(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))


def test_init_tree_matches_the_reference():
    """Paths (``embed``, ``enc_blocks``, ``dec_blocks`` with ``xattn``,
    ``enc_norm``, ``final_norm``), shapes and dtypes equal the reference's
    from seed 0, the norms' scales and biases bitwise; the normals within a
    few float32 ulps of a leaf's largest weight (1e-6; reading 1.8e-7: the
    key chain and uniform bits are jax's, the erfinv's log1p is torch's)."""
    jp = jax.device_get(japi.build(jget_config(SMOKE)).init(
        jax.random.key(0)))
    tp = api.build(get_config(SMOKE)).init(prng.key(0), device="cpu")
    want, got = xa.jpaths(jp), _leaves(tp)
    assert [n for n, _ in want] == ["/".join(p) for p, _ in got]
    for (name, j), (_, t) in zip(want, got):
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype) == f"torch.{j.dtype}", name
        if "norm" in name:
            assert np.array_equal(t.numpy(), j), name
        else:
            xa.close(t, j, 1e-6)


def test_full_width_parameter_count_on_meta():
    """seamless-m4t-large-v2's full-width tree on ``meta``: 1,632,295,936
    parameters, the reference's count, each leaf's shape and dtype
    (bfloat16)."""
    specs = jencdec.param_specs(jget_config(ARCH))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(specs))
    assert want == 1_632_295_936
    tp = tencdec.init_params(prng.key(0), get_config(ARCH), device="meta")
    assert flat_spec(tp).d == want
    for (name, j), (_, t) in zip(xa.jpaths(specs), _leaves(tp)):
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype) == f"torch.{j.dtype}", name


def test_cross_attention_and_encoder_attention_match_the_reference(
        both, monkeypatch):
    """Decoder layer 0's ``cross_kv`` (k normed, v not; 4 heads, not the 2
    kv heads of self-attention) over a 16-frame memory, ``cross_attention_fwd``
    of 16 queries over it (Sq = Sk) and of 5 (Sq ≠ Sk), and encoder layer
    0's ``attention_fwd(causal=False)``: within 1e-5 of the largest
    magnitude (readings up to 3.2e-7: another summation order). The
    kernel calls: ``cross_kv`` one RMSNorm, the cross-attention one RMSNorm
    and one attention."""
    _, _, jp, tp = both
    cfg, jcfg = get_config(SMOKE), jget_config(SMOKE)
    jx = jax.tree.map(lambda v: v[0], jp["dec_blocks"]["xattn"])
    tx = ttf._layer(tp["dec_blocks"]["xattn"], 0)
    mem = _rnd(1, B, cfg.n_frontend_tokens, cfg.d_model)
    calls = xa.count_kernel_calls(monkeypatch)
    jkv = jattn.cross_kv(jx, jcfg, jnp.asarray(mem))
    tkv = tattn.cross_kv(tx, cfg, torch.from_numpy(mem))
    assert calls == {"rmsnorm": 1, "attention": 0}
    assert tkv["k"].shape == (B, cfg.n_frontend_tokens, cfg.n_heads,
                              cfg.head_dim)
    for k in ("k", "v"):
        xa.close(tkv[k], jkv[k])
    for sq in (16, 5):
        x = _rnd(2 + sq, B, sq, cfg.d_model)
        calls.update(rmsnorm=0, attention=0)
        got = tattn.cross_attention_fwd(tx, cfg, torch.from_numpy(x), tkv)
        assert calls == {"rmsnorm": 1, "attention": 1}
        xa.close(got, jattn.cross_attention_fwd(jx, jcfg, jnp.asarray(x),
                                                jkv))
    ja = jax.tree.map(lambda v: v[0], jp["enc_blocks"]["attn"])
    ta = ttf._layer(tp["enc_blocks"]["attn"], 0)
    x = _rnd(9, B, cfg.n_frontend_tokens, cfg.d_model)
    xa.close(tattn.attention_fwd(ta, cfg, torch.from_numpy(x), causal=False),
             jattn.attention_fwd(ja, jcfg, jnp.asarray(x), causal=False))


def test_encode_matches_the_reference(both):
    """The bidirectional encoder over 16 frames (2 layers, layernorms, the
    final ``enc_norm``): within 1e-5 of the largest magnitude (reading
    6.0e-7)."""
    _, _, jp, tp = both
    src = _rnd(10, B, 16, get_config(SMOKE).d_model)
    xa.close(tencdec.encode(tp, get_config(SMOKE), torch.from_numpy(src)),
             jencdec.encode(jp, jget_config(SMOKE), jnp.asarray(src)))


def test_loss_prefill_and_decode_match_the_reference(both, monkeypatch):
    """The train loss (within 8 ulps; reading 1), prefill at width S + 4
    and 4 decode steps on the reference's greedy tokens: logits and every
    cache leaf (the self ring, the cross K/V) within 1e-5 of their largest
    magnitude (readings 4.4e-7 to 6.7e-7). Kernel calls as
    ``kernel_calls`` derives them: 6 attentions and 4 RMSNorms a prefill,
    2 and 2 a decode step (layernorm blocks)."""
    jm, tm, jp, tp = both
    tb = api.make_batch(tm, ShapeConfig("t", S, B, "train"), prng.key(1),
                        device="cpu")
    jb = xa.to_jax(convert.to_numpy(tb))
    jl, tl = float(jm.loss(jp, jb)), float(tm.loss(tp, tb))
    assert abs(jl - tl) <= 8 * np.spacing(np.float32(jl))
    jb = japi.make_batch(jm, JShape("p", S, B, "prefill"), jax.random.key(2))
    tb = convert.to_torch(jax.device_get(jb))
    calls = xa.count_kernel_calls(monkeypatch)
    jl, jc = jm.prefill(jp, jb, S + 4)
    tl, tc = tm.prefill(tp, tb, S + 4)
    assert calls == xa.kernel_calls(tm.cfg, "prefill") == \
        {"rmsnorm": 4, "attention": 6}
    xa.close(tl, jl)
    for i in range(4):
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        jl, jc = jm.decode(jp, {"tokens": tok}, jc,
                           jnp.asarray(S + i, jnp.int32))
        calls.update(rmsnorm=0, attention=0)
        tl, tc = tm.decode(tp, {"tokens": torch.from_numpy(np.array(tok))},
                           tc, torch.tensor(S + i))
        assert calls == xa.kernel_calls(tm.cfg, "decode") == \
            {"rmsnorm": 2, "attention": 2}
        xa.close(tl, jl)
    want = xa.jpaths(jax.device_get(jc))
    assert [n for n, _ in want] == ["/".join(p) for p, _ in _leaves(tc)]
    for (name, j), (_, t) in zip(want, _leaves(tc)):
        assert str(t.dtype) == f"torch.{j.dtype}", name
        xa.close(t, j)
    empty = tm.init_cache(B, S + 4, device="cpu")
    jempty = jencdec.init_cache(jget_config(SMOKE), B, S + 4)
    for (name, j), (_, t) in zip(xa.jpaths(jempty), _leaves(empty)):
        assert tuple(t.shape) == j.shape and not bool(t.any()), name


def test_decode_matches_prefill(both):
    """The reference's consistency check (``tests/test_arch_smoke.py``):
    one decode step at position S against a prefill of S + 1 tokens over
    the same source, atol 2e-4 and rtol 2e-3 (reading 5.5e-7 of the
    largest logit)."""
    _, tm, _, tp = both
    batch = api.make_batch(tm, ShapeConfig("p", S, B, "prefill"),
                           prng.key(4), device="cpu")
    _, cache = tm.prefill(tp, batch, S + 4)
    nxt = prng.randint(prng.key(5), (B, 1), 0, tm.cfg.vocab)
    dec, _ = tm.decode(tp, {"tokens": nxt}, cache, torch.tensor(S))
    ref, _ = tm.prefill(tp, {"tokens": torch.cat([batch["tokens"], nxt], 1),
                             "src_embeds": batch["src_embeds"]}, S + 5)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), atol=2e-4,
                               rtol=2e-3)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_matches_the_reference(kind):
    """``make_batch`` (input i of the sorted names from ``fold_in(rng,
    i)``): the names and shapes the reference's (``src_embeds`` for train
    and prefill, none for decode); integers bitwise; ``src_embeds`` bitwise
    in bfloat16 (the full config's dtype) and within a few float32 ulps in
    float32 (1e-6 of the largest; readings up to 1.4e-7: erfinv)."""
    for dtype in ("float32", "bfloat16"):
        cfg, jcfg = (c.replace(dtype=dtype) for c in (
            get_config(SMOKE), jget_config(SMOKE)))
        jb = japi.make_batch(japi.build(jcfg), JShape("s", S, B, kind),
                             jax.random.key(3))
        tb = api.make_batch(api.build(cfg), ShapeConfig("s", S, B, kind),
                            prng.key(3), device="cpu")
        assert sorted(tb) == sorted(jb)
        assert ("src_embeds" in tb) == (kind != "decode")
        for name, j in jax.device_get(jb).items():
            assert tuple(tb[name].shape) == j.shape, name
            assert str(tb[name].dtype) == f"torch.{j.dtype}", name
            if name == "src_embeds" and dtype == "float32":
                xa.close(tb[name], j, 1e-6)
            else:
                assert xa.same_bits(tb[name], j), (name, dtype)


def test_flat_spec_matches_the_reference(both):
    """The flat buffer of the tree: names in the reference's leaf order,
    its offsets, ``d`` and ``n_pad``, and ``flatten`` of the same weights
    bitwise the reference's."""
    _, _, jp, tp = both
    jspec, tspec = jflat.flat_spec(jp), flat_spec(tp)
    assert tspec.names == tuple(n for n, _ in xa.jpaths(jp))
    assert (tspec.offsets, tspec.d, tspec.n_pad) == \
        (jspec.offsets, jspec.d, jspec.n_pad)
    assert np.array_equal(flatten(tp, tspec).numpy(),
                          np.asarray(jflat.flatten(jp, jspec)))


@pytest.mark.parametrize("flat", [False, True], ids=["pytree", "flat"])
def test_train_step_matches_the_reference(both, flat):
    """One FedZO step (b2 2, μ 1e-2, lr 1e-3) from the same weights, key
    and batch (tokens, labels and ``src_embeds``), on the pytree route and
    the flat one: the loss within 8 ulps (readings 0), the coefficient norm
    within 8 loss ulps' worth of a coefficient (d·ulp/μ; readings 0.11 and
    2.0), and every parameter within 1e-3 of the reference's while the
    step moves one by at least five times that: ``tests/test_torch_ssm.py``'s
    argument (a loss ulp moves a weight by about 1e-4; readings 2.2e-4 and
    2.6e-4 against moves of 1.3e-2 and 1.1e-2)."""
    kw = dict(lr=1e-3, mu=1e-2, b2=2, estimator="sphere", flat_params=flat)
    jm, tm, jp0, tp0 = both
    jstep = jax.jit(jfedzo.make_train_step(lambda p, b: jm.loss(p, b),
                                           JConfig(**kw)))
    tstep = fedzo.make_train_step(tm.loss, FedZOConfig(**kw))
    toks = jsyn.lm_token_stream(20_000, 512, seed=0)
    b = jsyn.lm_batches(toks, B, S, np.random.default_rng(0))
    b["src_embeds"] = _rnd(11, B, 16, tm.cfg.d_model, scale=0.1)
    jp, jmet = jstep(jp0, {k: jnp.asarray(v) for k, v in b.items()},
                     jax.random.key(2))
    tp, tmet = tstep(tp0, {k: torch.from_numpy(v) for k, v in b.items()},
                     prng.key(2))
    jl = float(jmet["loss"])
    assert abs(jl - float(tmet["loss"])) <= 8 * np.spacing(np.float32(jl))
    unit = flat_spec(tp0).d * np.spacing(np.float32(jl)) / kw["mu"]
    assert abs(float(tmet["coeff_norm"]) - float(jmet["coeff_norm"])) \
        <= 8 * unit
    got = {"/".join(p): v for p, v in _leaves(tp)}
    init = dict(xa.jpaths(jp0))
    worst, moved = 0.0, 0.0
    for name, want in xa.jpaths(jax.device_get(jp)):
        worst = max(worst, float(np.abs(got[name].numpy() - want).max()))
        moved = max(moved, float(np.abs(want - init[name]).max()))
    assert worst <= 1e-3
    assert moved >= 5e-3


def test_training_cli_matches_the_reference(monkeypatch, tmp_path):
    """``launch/train.py`` against the reference's CLI, 2 steps of batch 2
    x 32 at the launcher's defaults (pytree route, μ 1e-3, lr 1e-4, b2 8),
    each step's ``src_embeds`` ``0.1·normal(fold_in(key, step))``: the same
    lines up to the losses; the first loss within 8 ulps (reading 1), the
    second within 1e-3 and the final weights within 5e-4 (a loss ulp moves
    a coefficient by d·ulp/μ ≈ 340 at d 0.7 M and a weight by about 1e-5
    a direction, and a 2.3e-4 weight difference moves the next loss by
    that over |∇f|: readings 3.6e-4 and 2.3e-4, while the first step moves
    the loss by 2.9e-2)."""
    argv = ["--arch", SMOKE, "--steps", "2", "--log-every", "1", "--seq",
            "32", "--batch", "2"]
    want, got, res = xa.train_clis(jtrain.main, train.main, argv, tmp_path,
                                   monkeypatch)
    assert want[0] == got[0]
    assert [ln.split()[:2] for ln in want[1:]] == \
        [ln.split()[:2] for ln in got[1:]]
    jhist = __import__("json").load(open(tmp_path / "j" / "history.json"))
    assert abs(res.history[0] - jhist["loss"][0]) <= 8 * np.spacing(
        np.float32(jhist["loss"][0]))
    assert abs(res.history[1] - jhist["loss"][1]) <= 1e-3
    jfinal = np.load(tmp_path / "j" / "final" / "params.npz")
    tfinal = np.load(tmp_path / "t" / "final" / "params.npz")
    assert sorted(jfinal.files) == sorted(tfinal.files)
    assert max(float(np.abs(jfinal[k] - tfinal[k]).max())
               for k in jfinal.files) <= 5e-4
    # the frontend input of a step: bitwise what the reference draws
    key = prng.key(7)
    got = train.frontend_inputs(get_config(SMOKE).replace(dtype="bfloat16"),
                                2, key, 3, torch.device("cpu"))
    want = 0.1 * jax.random.normal(
        jax.random.fold_in(jax.random.key(7), 3),
        (2, 16, 128), jnp.bfloat16)
    assert xa.same_bits(got["src_embeds"], want)


def test_serve_cli_prints_the_reference_tokens(monkeypatch):
    want, got, res = xa.cli_lines(
        jserve.main, serve.main, ["--arch", SMOKE, "--gen", "6", "--batch",
                                  "2"], monkeypatch)
    assert [ln for ln in got if ln.startswith("  request")] == \
        [ln for ln in want if ln.startswith("  request")]
    assert "serve OK" in got
    assert res.tokens.shape == (2, 7)


def test_cohort_loss_raises(both, monkeypatch):
    """The enc-dec family's client-batched loss runs (it raised before it
    was ported; ``tests/test_torch_xattn_cohort.py`` holds it to the
    reference): two clients' rows, each on its own batch, equal each
    client's own loss within rtol 2e-7 (reading bitwise), and
    ``fedzo.batched_loss`` takes it without reaching
    ``torch.func.vmap``."""
    _, tm, _, tp = both
    xa.cohort_loss_runs(tm, tp, monkeypatch)
