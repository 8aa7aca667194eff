"""The port's dense LM slice against a live JAX run: configs, nested
FlatParams, the on-device draws, the Qwen2 init and forward, and the
cross-silo FedZO train step (``make_train_step`` with ``flat_params``).

Both packages start from the same seed or the same weights, and the JAX
side runs in this process (its Pallas kernels in interpret mode). Integer
draws and the flat geometry are bitwise; floats carry a tolerance beside
its measured reading. In the train step a one-ulp loss difference (torch
and XLA sum the matmuls in other orders) moves a coefficient
c = d·(L(x+μv) − L(x))/μ by d·ulp/μ: 17 at d = 361,600, μ = 1e-2 and a loss
near 6.3 (ulp 4.8e-7). The test therefore uses μ = 1e-2 and lr = 1e-3, not
the launcher's μ = 1e-3, lr = 1e-4, where one ulp moves a coefficient by
172 against coefficients of a few thousand: at those settings the
coefficients are mostly float32 rounding in both packages.
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
from repro.core import fedzo as jfedzo
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.utils import flatparams as jflat
from repro_torch.configs import get_config
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedzo
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.utils import convert, prng
from repro_torch.utils import flatparams as tflat

SMOKE = "qwen2-0.5b-smoke"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path is thousands of small tensor ops. One intra-op
    thread runs them as fast, and leaves the other test workers' cores
    alone: eight threads per op wait on each other when the cores are
    shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(got, want):
    """max |got - want| in float32 spacings at |want| (numpy arrays)."""
    want = np.asarray(want, np.float32)
    spacing = np.spacing(np.abs(want)).astype(np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)
                        / spacing))


def _jax_params(arch=SMOKE, seed=0):
    return jax.device_get(japi.build(jget_config(arch)).init(
        jax.random.key(seed)))


def _get(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def _path_names(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(k.key for k in path), leaf) for path, leaf in leaves]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", SMOKE])
def test_config_is_the_reference_config(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))


def test_unported_architectures_and_routes_raise():
    """All ten reference architectures register, each with the reference's
    config (the enc-dec and VLM families are ported:
    ``tests/test_torch_encdec.py``, ``tests/test_torch_vlm.py``, their
    cohort loss ``tests/test_torch_xattn_cohort.py``), and an unknown id
    raises the reference's KeyError. The decoder-only assembly
    (``models/transformer.py``) rejects an enc-dec or VLM config: those
    build through ``api.build``. An unknown family raises."""
    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro_torch.configs import ARCH_IDS
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS) and len(ARCH_IDS) == 10
    for arch in JARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
    for get in (get_config, jget_config):
        with pytest.raises(KeyError):
            get("no-such-arch")
    cfg = get_config(SMOKE)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for arch in ("seamless-m4t-large-v2-smoke", "llama-3.2-vision-90b-smoke"):
        other = get_config(arch)
        assert api.build(other).cfg is other
        with pytest.raises(ValueError, match="api.build"):
            ttf.init_params(prng.key(0), other)
        with pytest.raises(ValueError, match="api.build"):
            ttf.prefill({}, toks, other, 16)
        with pytest.raises(ValueError, match="api.build"):
            ttf.decode_step({}, toks[:, :1], {}, 4, other)
    with pytest.raises(NotImplementedError, match="not ported"):
        api.build(cfg.replace(family="diffusion"))
    model = api.build(cfg)
    # the wireless channel model is ported; the train step ignores it, as
    # the reference's does
    from repro_torch.sim import ChannelModel
    params = model.init(prng.key(0), device="cpu")
    toks = torch.arange(16, dtype=torch.int32).reshape(2, 8) % cfg.vocab
    batch = {"tokens": toks, "labels": toks}
    steps = [fedzo.make_train_step(model.loss, FedZOConfig(
        b2=2, mu=1e-2, channel_model=cm))(params, batch, prng.key(1))[0]
        for cm in (None, ChannelModel(rho=0.5))]
    for a, b in zip(*(tflat._leaves(p) for p in steps)):
        assert torch.equal(a[1], b[1]), a[0]
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.init(prng.key(0))


def test_nested_flat_spec_matches_jax_tree_order():
    jp = _jax_params()
    tp = convert.to_torch(jp)
    jspec = jflat.flat_spec(jp)
    tspec = tflat.flat_spec(tp)
    assert list(tspec.names) == [n for n, _ in _path_names(jp)]
    assert tspec.names[:3] == ("blocks/attn/bk", "blocks/attn/bq",
                               "blocks/attn/bv")
    assert tspec.names[-2:] == ("embed/tok", "final_norm/scale")
    assert (tspec.shapes, tspec.offsets, tspec.sizes, tspec.d,
            tspec.n_pad) == (jspec.shapes, jspec.offsets, jspec.sizes,
                             jspec.d, jspec.n_pad)
    assert tspec.d == 361_600
    np.testing.assert_array_equal(
        np.asarray(jflat.flatten(jax.tree.map(jnp.asarray, jp), jspec)),
        tflat.flatten(tp, tspec).numpy())


def test_full_width_geometry_matches_jax_param_specs():
    """Qwen2-0.5B at full width, without allocating it: the port's init on
    the meta device against the reference's ``param_specs``."""
    jspecs = jtf.param_specs(jget_config("qwen2-0.5b"))
    names = _path_names(jspecs)
    tp = ttf.init_params(prng.key(0), get_config("qwen2-0.5b"),
                         device="meta")
    tspec = tflat.flat_spec(tp)
    assert list(tspec.names) == [n for n, _ in names]
    assert list(tspec.shapes) == [tuple(s.shape) for _, s in names]
    assert (tspec.d, tspec.n_pad) == (494_032_768, 494_075_904)
    assert tspec.n_pad < 2 ** 31   # flat indices fit the kernels' int32


def test_nested_unflatten_round_trip_keeps_dtypes():
    tree = {"b": {"y": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                  "x": torch.ones(4, dtype=torch.bfloat16) * 1.5},
            "a": torch.tensor([2.0], dtype=torch.float32)}
    spec = tflat.flat_spec(tree, block=8)
    assert spec.names == ("a", "b/x", "b/y") and spec.n_pad == 16
    buf = tflat.flatten(tree, spec)
    assert buf.dtype == torch.float32
    back = tflat.unflatten(buf[None].expand(3, -1), spec)
    assert back["b"]["x"].dtype == torch.bfloat16
    assert back["b"]["y"].shape == (3, 2, 3)
    assert torch.equal(back["b"]["x"][1], tree["b"]["x"])
    assert torch.equal(back["a"][2], tree["a"])


def test_draws_run_on_the_device_asked_for():
    """The bulk draws follow ``device=``: the integers are the same, and a
    meta-device draw allocates nothing. (The card twin in
    ``test_torch_cuda.py`` holds CUDA draws bitwise to these.)"""
    k = prng.key(9)
    ref = prng.random_bits(k, (5, 33))
    assert torch.equal(prng.random_bits(k, (5, 33), device="cpu"), ref)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jax.random.key(9), (5, 33), jnp.uint32))
        .astype(np.int64), ref.numpy())
    m = prng.normal(k, (1000, 7), device="meta")
    assert m.device.type == "meta" and m.shape == (1000, 7)
    assert torch.equal(prng.uniform(k, (77,), device="cpu"),
                       prng.uniform(k, (77,)))


def test_init_params_match_jax():
    params = api.build(get_config(SMOKE)).init(prng.key(0), device="cpu")
    worst = 0.0
    for name, want in _path_names(_jax_params()):
        got = _get(params, name).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        worst = max(worst, _ulps(got, want))
    # normals through XLA's erfinv polynomial (<= 3 ulp, prng tests), then
    # one float32 multiply by the layer's scale; reading: 3 ulp
    assert worst <= 6


def _batch(seed, b=2, s=16, vocab=512):
    toks = jsyn.lm_token_stream(4000, vocab, seed=seed)
    return jsyn.lm_batches(toks, b, s, np.random.default_rng(seed))


def test_lm_corpus_is_the_reference_corpus():
    a, b = jsyn.lm_token_stream(3000, 4096, seed=3), \
        tsyn.lm_token_stream(3000, 4096, seed=3)
    np.testing.assert_array_equal(a, b)
    x = jsyn.lm_batches(a, 4, 128, np.random.default_rng(1))
    y = tsyn.lm_batches(b, 4, 128, np.random.default_rng(1))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("over", [{}, {"qk_norm": True, "sliding_window": 8},
                                  {"qkv_bias": False, "act": "gelu"}])
def test_attention_and_block_forward_match_jax(over):
    """One block's attention and the whole pre-norm block on shared
    weights, across the dense options (qkv bias, qk_norm, window, act)."""
    cfg_j = jget_config(SMOKE).replace(**over)
    cfg_t = get_config(SMOKE).replace(**over)
    jp = jax.device_get(jtf.init_block(jax.random.key(4), cfg_j,
                                       jnp.float32))
    tp = convert.to_torch(jp)
    x = np.random.default_rng(5).standard_normal((2, 16, 128)) \
        .astype(np.float32)
    ja = np.asarray(jattn.attention_fwd(jp["attn"], cfg_j, x))
    ta = tattn.attention_fwd(tp["attn"], cfg_t, torch.from_numpy(x)).numpy()
    jb = np.asarray(jtf.block_fwd(jp, cfg_j, x, None)[0])
    tb = ttf.block_fwd(tp, cfg_t, torch.from_numpy(x))[0].numpy()
    # readings: 4.8e-7 (attention, |out| up to 3.4) and 1.4e-6 (block,
    # |h| up to 5.4)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=2e-6)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=6e-6)


def test_loss_on_shared_weights_matches_jax():
    jp = _jax_params()
    b = _batch(0)
    jl = float(japi.build(jget_config(SMOKE)).loss(
        jp, {k: jnp.asarray(v) for k, v in b.items()}))
    tl = float(api.build(get_config(SMOKE)).loss(
        convert.to_torch(jp), {k: torch.from_numpy(v) for k, v in b.items()}))
    # reading: 3 ulp (1.4e-6 at 6.29)
    assert abs(tl - jl) <= 8 * np.spacing(np.float32(jl))


def test_train_step_matches_jax_three_steps():
    """3 steps of the port's ``make_train_step`` against JAX's jitted
    flat train step, batch 2 x seq 16, b2 = 4, from the same weights, keys
    and batches (the launcher's key chain)."""
    kw = dict(lr=1e-3, mu=1e-2, b2=4, estimator="sphere", flat_params=True)
    jm, tm = japi.build(jget_config(SMOKE)), api.build(get_config(SMOKE))
    jstep = jax.jit(jfedzo.make_train_step(lambda p, b: jm.loss(p, b),
                                           JConfig(**kw)))
    tstep = fedzo.make_train_step(tm.loss, FedZOConfig(**kw))
    jp0 = _jax_params()
    jp, tp = jp0, convert.to_torch(jp0)
    jkey, tkey = jax.random.key(1), prng.key(1)
    toks = jsyn.lm_token_stream(20_000, 512, seed=0)
    rng = np.random.default_rng(0)
    ops.reset_launches()
    losses, norms = [], []
    for _ in range(3):
        b = jsyn.lm_batches(toks, 2, 16, rng)
        jkey, jsub = jax.random.split(jkey)
        ks = prng.split(tkey, 2)
        tkey, tsub = ks[0], ks[1]
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jsub)).astype(np.int64),
            tsub.numpy())
        jp, jm_ = jstep(jp, {k: jnp.asarray(v) for k, v in b.items()}, jsub)
        tp, tm_ = tstep(tp, {k: torch.from_numpy(v) for k, v in b.items()},
                        tsub)
        losses.append((float(jm_["loss"]), float(tm_["loss"])))
        norms.append((float(jm_["coeff_norm"]), float(tm_["coeff_norm"])))
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}   # plain versions
    # step 1's loss is one forward on the shared weights (reading 1 ulp);
    # later losses carry the parameter drift (readings 5.4e-5, 1.4e-4)
    assert abs(losses[0][0] - losses[0][1]) <= 8 * np.spacing(
        np.float32(losses[0][0]))
    for j, t in losses:
        assert abs(j - t) <= 5e-4
    # coefficient norms: a few loss ulps of 17 each against norms of 5,300
    # to 7,800 (readings: relative 2.5e-3, 1.1e-2, 4.4e-4)
    for j, t in norms:
        assert abs(j - t) <= 3e-2 * j
    # parameters: reading 2.1e-4 after step 3, while the 3 updates move a
    # weight by up to 2.3e-2 (asserted >= 10x the limit, so the limit is
    # not vacuous)
    worst, moved = 0.0, 0.0
    init = dict(_path_names(jp0))
    for name, want in _path_names(jax.device_get(jp)):
        worst = max(worst, float(np.abs(_get(tp, name).numpy()
                                        - want).max()))
        moved = max(moved, float(np.abs(want - init[name]).max()))
    assert worst <= 6e-4
    assert moved >= 10 * 6e-4
