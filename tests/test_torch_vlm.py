"""The port's VLM family (``llama-3.2-vision-90b``: a self-attention
decoder with a gated cross-attention layer over stubbed patch embeddings
after every ``cross_attn_every - 1`` self layers) against a live JAX run:
the configs, the nested init tree (``self_blocks`` ``[G, n_self, ...]``,
the float32 0-d gates), the full-width parameter counts, the
cross-attention and the gated cross layer, the loss, prefill and decode
(every cache leaf), the decode-against-prefill check, ``make_batch``, the
flat buffer with its 0-d gates, the flat and pytree train steps, the
training and serving CLIs, and the cohort loss running.

Both trees' gates are 0.5 (``_torch_xattn.gated``): at the reference's
zero gates ``tanh(0) = 0`` hides the cross path. Besides ``-smoke`` (G = 1
group of one self layer), ``DEEP`` (6 layers, a cross layer every 3: G =
2 groups of 2) nests both stacks. Inputs come from numpy seeds, in
float32; each tolerance stands beside its reason and its reading.
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
from repro.models import vlm as jvlm
from repro.utils import flatparams as jflat
from repro_torch.configs import get_config
from repro_torch.configs.base import FedZOConfig, ShapeConfig
from repro_torch.core import fedzo
from repro_torch.launch import serve, train
from repro_torch.models import api
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models import vlm as tvlm
from repro_torch.utils import convert, prng
from repro_torch.utils.flatparams import _leaves, flat_spec, flatten, unflatten
from repro_torch.utils.tree import tree_map
from tests import _torch_xattn as xa

ARCH = "llama-3.2-vision-90b"
SMOKE = ARCH + "-smoke"
DEEP = dict(n_layers=6, cross_attn_every=3)
B, S = xa.B, xa.S


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(deep):
    kw = DEEP if deep else {}
    return get_config(SMOKE).replace(**kw), jget_config(SMOKE).replace(**kw)


def _models(deep):
    cfg, jcfg = _cfgs(deep)
    jm, tm = japi.build(jcfg), api.build(cfg)
    jp = xa.gated(jax.device_get(jm.init(jax.random.key(0))))
    return jm, tm, jp, convert.to_torch(jp)


@pytest.fixture(scope="module")
def both():
    return _models(False)


def _rnd(seed, *shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


@pytest.mark.parametrize("arch", [ARCH, SMOKE])
def test_configs_are_the_reference_configs(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))


@pytest.mark.parametrize("deep", [False, True], ids=["smoke", "deep"])
def test_init_tree_matches_the_reference(deep):
    """Paths, shapes (``self_blocks`` ``[G, n_self, ...]``,
    ``cross_blocks`` ``[G, ...]``) and dtypes (the 0-d float32 gates among
    the model's) equal the reference's from seed 0; norms and gates
    bitwise; the normals within a few float32 ulps of a leaf's largest
    weight (1e-6; reading 1.9e-7: erfinv). Each group of the nested stack
    is bitwise its own ``_stack_init`` from ``fold_in(key, g)``."""
    cfg, jcfg = _cfgs(deep)
    jp = jax.device_get(japi.build(jcfg).init(jax.random.key(0)))
    tp = api.build(cfg).init(prng.key(0), device="cpu")
    want, got = xa.jpaths(jp), _leaves(tp)
    assert [n for n, _ in want] == ["/".join(p) for p, _ in got]
    G, n_self = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
    assert tp["self_blocks"]["attn"]["wq"].shape[:2] == (G, n_self)
    assert tp["cross_blocks"]["gate_attn"].shape == (G,)
    for (name, j), (_, t) in zip(want, got):
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype) == f"torch.{j.dtype}", name
        if "norm" in name or name.split("/")[-1].startswith("gate_"):
            assert np.array_equal(t.numpy(), j), name
        else:
            xa.close(t, j, 1e-6)
    ks = prng.split(prng.key(0), 4)
    for g in range(G):
        one = ttf._stack_init(prng.fold_in(ks[1], g), n_self, lambda k:
                              ttf.init_block(k, cfg, torch.float32))
        for (_, a), (_, c) in zip(_leaves(ttf._layer(tp["self_blocks"], g)),
                                  _leaves(one)):
            assert torch.equal(a, c)


def test_full_width_parameter_counts_on_meta():
    """llama-3.2-vision-90b's full-width trees on ``meta``: the reference's
    count at all 100 layers, and 10,892,780,036 at the 10 layers (2 groups
    of 4 self layers and a cross layer) the card holds; each leaf's shape
    and dtype (bfloat16, the gates float32)."""
    for n_layers, want in ((100, None), (10, 10_892_780_036)):
        jcfg = jget_config(ARCH).replace(n_layers=n_layers)
        specs = jvlm.param_specs(jcfg)
        count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(specs))
        assert want is None or count == want
        tp = tvlm.init_params(prng.key(0), get_config(ARCH).replace(
            n_layers=n_layers), device="meta")
        assert flat_spec(tp).d == count
        for (name, j), (_, t) in zip(xa.jpaths(specs), _leaves(tp)):
            assert tuple(t.shape) == j.shape, name
            assert str(t.dtype) == f"torch.{j.dtype}", name


def test_cross_attention_and_gated_layer_match_the_reference(
        both, monkeypatch):
    """Cross layer 0's ``cross_kv`` over 16 patches and
    ``cross_attention_fwd`` of 16 and of 5 queries over it, and the gated
    ``cross_block_fwd`` (gates 0.5): within 1e-5 of the largest magnitude
    (readings up to 3.8e-7). Kernel calls: the gated layer makes four
    RMSNorms (its two norms, q and k) and one attention."""
    _, _, jp, tp = both
    cfg, jcfg = _cfgs(False)
    jc = jax.tree.map(lambda v: v[0], jp["cross_blocks"])
    tc = ttf._layer(tp["cross_blocks"], 0)
    vis = _rnd(1, B, cfg.n_frontend_tokens, cfg.d_model)
    jkv = jattn.cross_kv(jc["xattn"], jcfg, jnp.asarray(vis))
    tkv = tattn.cross_kv(tc["xattn"], cfg, torch.from_numpy(vis))
    for k in ("k", "v"):
        xa.close(tkv[k], jkv[k])
    for sq in (16, 5):
        x = _rnd(2 + sq, B, sq, cfg.d_model)
        xa.close(tattn.cross_attention_fwd(tc["xattn"], cfg,
                                           torch.from_numpy(x), tkv),
                 jattn.cross_attention_fwd(jc["xattn"], jcfg,
                                           jnp.asarray(x), jkv))
    h = _rnd(9, B, S, cfg.d_model)
    calls = xa.count_kernel_calls(monkeypatch)
    got = tvlm.cross_block_fwd(tc, cfg, torch.from_numpy(h), tattn.cross_kv(
        tc["xattn"], cfg, torch.from_numpy(vis)))
    assert calls == {"rmsnorm": 4, "attention": 1}
    want = jvlm.cross_block_fwd(jc, jcfg, jnp.asarray(h), jnp.asarray(vis))
    xa.close(got, want)
    # the gates reach the output: a zero gate leaves h's cross terms out
    shut = dict(tc, gate_attn=torch.zeros(()), gate_mlp=torch.zeros(()))
    assert torch.equal(tvlm.cross_block_fwd(shut, cfg, torch.from_numpy(h),
                                            tkv), torch.from_numpy(h))


@pytest.mark.parametrize("deep", [False, True], ids=["smoke", "deep"])
def test_loss_prefill_and_decode_match_the_reference(deep, monkeypatch):
    """The train loss (within 8 ulps; readings 1 and 0), prefill at width S
    + 4 and 4 decode steps on the reference's greedy tokens: logits and
    every cache leaf (the self ring ``[G, n_self, ...]``, the cross K/V
    ``[G, ...]``) within 1e-5 of their largest magnitude (readings up to
    1.0e-6 at smoke and 1.3e-6 deep). Kernel calls as ``kernel_calls``
    derives them (smoke: 7 RMSNorms and 2 attentions a prefill, 6 and 1 a
    decode step)."""
    jm, tm, jp, tp = _models(deep)
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
    assert calls == xa.kernel_calls(tm.cfg, "prefill")
    assert deep or calls == {"rmsnorm": 7, "attention": 2}
    xa.close(tl, jl)
    for i in range(4):
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        jl, jc = jm.decode(jp, {"tokens": tok}, jc,
                           jnp.asarray(S + i, jnp.int32))
        calls.update(rmsnorm=0, attention=0)
        tl, tc = tm.decode(tp, {"tokens": torch.from_numpy(np.array(tok))},
                           tc, torch.tensor(S + i))
        assert calls == xa.kernel_calls(tm.cfg, "decode")
        assert deep or calls == {"rmsnorm": 6, "attention": 1}
        xa.close(tl, jl)
    want = xa.jpaths(jax.device_get(jc))
    assert [n for n, _ in want] == ["/".join(p) for p, _ in _leaves(tc)]
    for (name, j), (_, t) in zip(want, _leaves(tc)):
        assert str(t.dtype) == f"torch.{j.dtype}", name
        xa.close(t, j)
    empty = tm.init_cache(B, S + 4, device="cpu")
    jempty = jvlm.init_cache(_cfgs(deep)[1], B, S + 4)
    for (name, j), (_, t) in zip(xa.jpaths(jempty), _leaves(empty)):
        assert tuple(t.shape) == j.shape and not bool(t.any()), name


def test_decode_matches_prefill(both):
    """The reference's consistency check: one decode step at position S
    against a prefill of S + 1 tokens over the same patches, atol 2e-4 and
    rtol 2e-3 (reading 6.9e-7 of the largest logit)."""
    _, tm, _, tp = both
    batch = api.make_batch(tm, ShapeConfig("p", S, B, "prefill"),
                           prng.key(4), device="cpu")
    _, cache = tm.prefill(tp, batch, S + 4)
    nxt = prng.randint(prng.key(5), (B, 1), 0, tm.cfg.vocab)
    dec, _ = tm.decode(tp, {"tokens": nxt}, cache, torch.tensor(S))
    ref, _ = tm.prefill(tp, {"tokens": torch.cat([batch["tokens"], nxt], 1),
                             "vision_embeds": batch["vision_embeds"]}, S + 5)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), atol=2e-4,
                               rtol=2e-3)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_batch_matches_the_reference(kind):
    """``make_batch``: the names and shapes the reference's
    (``vision_embeds`` for train and prefill, none for decode); integers
    bitwise; ``vision_embeds`` bitwise in bfloat16 and within a few
    float32 ulps in float32 (1e-6 of the largest; readings up to 1.4e-7:
    erfinv)."""
    for dtype in ("float32", "bfloat16"):
        cfg, jcfg = (c.replace(dtype=dtype) for c in _cfgs(False))
        jb = japi.make_batch(japi.build(jcfg), JShape("s", S, B, kind),
                             jax.random.key(3))
        tb = api.make_batch(api.build(cfg), ShapeConfig("s", S, B, kind),
                            prng.key(3), device="cpu")
        assert sorted(tb) == sorted(jb)
        assert "vision_embeds" in tb
        for name, j in jax.device_get(jb).items():
            assert tuple(tb[name].shape) == j.shape, name
            assert str(tb[name].dtype) == f"torch.{j.dtype}", name
            if name == "vision_embeds" and dtype == "float32":
                xa.close(tb[name], j, 1e-6)
            else:
                assert xa.same_bits(tb[name], j), (name, dtype)


def test_flat_buffer_with_zero_d_gates_matches_the_reference():
    """The flat buffer of the bfloat16 tree (DEEP, gates 0.5): names in the
    reference's leaf order, offsets (each float32 0-d gate one element at
    the reference's position), ``d`` and ``n_pad``; ``flatten`` bitwise
    the reference's; ``unflatten`` gives the gates back as 0-d float32
    leaves (``[M]`` with a leading client axis) among bfloat16 ones, and
    ``convert`` carries them both ways."""
    cfg, jcfg = (c.replace(dtype="bfloat16") for c in _cfgs(True))
    jp = xa.gated(jax.device_get(japi.build(jcfg).init(jax.random.key(0))))
    tp = convert.to_torch(jp)
    jspec, tspec = jflat.flat_spec(jp), flat_spec(tp)
    assert tspec.names == tuple(n for n, _ in xa.jpaths(jp))
    assert (tspec.offsets, tspec.d, tspec.n_pad) == \
        (jspec.offsets, jspec.d, jspec.n_pad)
    buf = flatten(tp, tspec)
    assert np.array_equal(buf.numpy(), np.asarray(jflat.flatten(jp, jspec)))
    i = tspec.names.index("cross_blocks/gate_attn")
    assert tspec.sizes[i] == 2 and tspec.dtypes[i] == torch.float32
    back = unflatten(buf, tspec)
    assert back["cross_blocks"]["gate_attn"].dtype == torch.float32
    assert back["self_blocks"]["attn"]["wq"].dtype == torch.bfloat16
    for (_, a), (_, c) in zip(_leaves(back), _leaves(tp)):
        assert torch.equal(a, c)
    one = tree_map(lambda v: v[0], tvlm.init_params(prng.key(0), cfg))
    cohort = unflatten(flatten(one, flat_spec(one))[None].repeat(3, 1),
                       flat_spec(one))
    assert cohort["cross_blocks"]["gate_mlp"].shape == (3,)
    assert convert.to_numpy(convert.to_torch({"g": np.float32(0.5)}))["g"] \
        .shape == ()


@pytest.mark.parametrize("flat", [False, True], ids=["pytree", "flat"])
def test_train_step_matches_the_reference(both, flat):
    """One FedZO step (b2 2, μ 1e-2, lr 1e-3) from the same weights, key
    and batch (zero ``vision_embeds`` as the CLI's, and random ones), on
    the pytree route (the 0-d gates perturbed as leaves) and the flat one
    (the gates one element each of the buffer): the loss within 8 ulps
    (readings 1), the coefficient norm within 8 loss ulps' worth of a
    coefficient (readings 0.5 to 2.0), every parameter within 1e-3 of the
    reference's while the step moves one by at least five times that
    (``tests/test_torch_ssm.py``'s argument; readings 7.3e-5 to 1.7e-4
    against moves of 5.9e-2 to 9.2e-2)."""
    kw = dict(lr=1e-3, mu=1e-2, b2=2, estimator="sphere", flat_params=flat)
    jm, tm, jp0, tp0 = both
    jstep = jax.jit(jfedzo.make_train_step(lambda p, b: jm.loss(p, b),
                                           JConfig(**kw)))
    tstep = fedzo.make_train_step(tm.loss, FedZOConfig(**kw))
    toks = jsyn.lm_token_stream(20_000, 512, seed=0)
    b = jsyn.lm_batches(toks, B, S, np.random.default_rng(0))
    for vis in (np.zeros((B, 16, tm.cfg.d_model), np.float32),
                _rnd(11, B, 16, tm.cfg.d_model)):
        b["vision_embeds"] = vis
        jp, jmet = jstep(jp0, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.key(2))
        tp, tmet = tstep(tp0, {k: torch.from_numpy(v) for k, v in b.items()},
                         prng.key(2))
        jl = float(jmet["loss"])
        assert abs(jl - float(tmet["loss"])) <= 8 * np.spacing(
            np.float32(jl))
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
        assert float(got["cross_blocks/gate_attn"][0]) != xa.GATE


def test_training_cli_matches_the_reference(monkeypatch, tmp_path):
    """``launch/train.py`` against the reference's CLI, 2 steps of batch 2
    x 32 at the launcher's defaults (pytree route, μ 1e-3, lr 1e-4, b2 8),
    zero ``vision_embeds`` (the reference's zero gates: the cross layers
    start closed): the same lines up to the losses; the first loss within
    8 ulps (reading 0), the second within 1e-3 and the final weights within
    5e-4, the enc-dec CLI test's argument (readings 2.6e-4 and 2.4e-4,
    while the first step moves the loss by 0.12)."""
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
    got = train.frontend_inputs(get_config(ARCH), 2, prng.key(7), 3,
                                torch.device("meta"))
    assert got["vision_embeds"].shape == (2, 1600, 8192)
    assert got["vision_embeds"].dtype == torch.bfloat16


def test_serve_cli_prints_the_reference_tokens(monkeypatch):
    want, got, res = xa.cli_lines(
        jserve.main, serve.main, ["--arch", SMOKE, "--gen", "6", "--batch",
                                  "2"], monkeypatch)
    assert [ln for ln in got if ln.startswith("  request")] == \
        [ln for ln in want if ln.startswith("  request")]
    assert "serve OK" in got
    assert res.tokens.shape == (2, 7)


def test_cohort_loss_raises(both, monkeypatch):
    """The VLM family's client-batched loss runs (it raised before it
    was ported; ``tests/test_torch_xattn_cohort.py`` holds it to the
    reference): two clients' rows, each on its own batch, equal each
    client's own loss within rtol 2e-7 (reading bitwise), and
    ``fedzo.batched_loss`` takes it without reaching
    ``torch.func.vmap``."""
    _, tm, _, tp = both
    xa.cohort_loss_runs(tm, tp, monkeypatch)
