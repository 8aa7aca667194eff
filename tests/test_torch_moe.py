"""The port's moe family (``qwen3-moe-30b-a3b``, ``deepseek-v3-671b`` with
MLA and MTP) against a live JAX run: the configs, the init tree, the MoE
layer's routing and outputs, the loss with its aux and MTP terms, prefill
and decode, one FedZO train step, the serve CLI, the full-width counts,
the chunked draws and in-place stacking, and the ``None`` subtree of an
empty stacked group.

Both packages start from the same weights (``utils/convert.to_torch`` of
the reference's init) at ``-smoke`` size. Routing integers (the top-k
experts, the kept assignments) are bitwise; floats are float32 within the
tolerance beside each check (torch and XLA sum the GEMMs in other orders;
readings of a few 1e-7 relative).
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
from repro.core import fedzo as jfedzo
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import MLAConfig, get_config
from repro_torch.configs.base import FedZOConfig, ShapeConfig
from repro_torch.core import fedzo
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.utils import convert, prng
from repro_torch.utils import tree as ttree
from repro_torch.utils.flatparams import _leaves, flat_spec
from tests import _torch_xattn as xa

MOE = ("qwen3-moe-30b-a3b", "deepseek-v3-671b")
SMOKES = tuple(a + "-smoke" for a in MOE)
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


def _jpaths(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(k.key for k in path), leaf) for path, leaf in leaves]


@pytest.mark.parametrize("arch", MOE + SMOKES)
def test_configs_are_the_reference_configs(arch):
    """Field for field, the MLA dims included (the smoke rule: q_lora 32,
    kv_lora 16, nope 16, rope 8, v 16)."""
    t, j = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if t.mla is not None:
        assert isinstance(t.mla, MLAConfig)
        assert dataclasses.astuple(t.mla) == dataclasses.astuple(j.mla)


@pytest.mark.parametrize("arch", SMOKES)
def test_init_tree_matches_the_reference(arch):
    """Paths (``dense_blocks`` None without dense layers), shapes, dtypes
    (the float32 router) and values from the same seed: the normals within
    a few float32 ulp (readings 1.8e-7 and 1.9e-7 of a leaf's largest
    weight)."""
    jp = jax.device_get(japi.build(jget_config(arch)).init(
        jax.random.key(0)))
    tp = api.build(get_config(arch)).init(prng.key(0), device="cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert (tp[k] is None) == (jp[k] is None), k
    want, got = _jpaths(jp), _leaves(tp)
    assert [n for n, _ in want] == ["/".join(p) for p, _ in got]
    for (name, j), (_, t) in zip(want, got):
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype) == f"torch.{j.dtype}", name
        _close(t, j, 1e-6)
    assert tp["moe_blocks"]["moe"]["router"].dtype == torch.float32


def _moe_setup(over=None, seed=0, T=32):
    cfg = get_config("qwen3-moe-30b-a3b-smoke").replace(**(over or {}))
    jcfg = jget_config("qwen3-moe-30b-a3b-smoke").replace(**(over or {}))
    jp = jax.device_get(jmoe.init_moe(jax.random.key(seed), jcfg,
                                      jnp.float32))
    x = (0.5 * np.random.default_rng(seed + 1).standard_normal(
        (2, T // 2, cfg.d_model))).astype(np.float32)
    return cfg, jcfg, jp, convert.to_torch(jp), x


def _jax_routing(jp, jcfg, x, capacity):
    """The reference's routing integers (``moe.py:75-93``), recomputed
    with its own jnp ops on the same inputs."""
    x_flat = jnp.asarray(x.reshape(-1, x.shape[-1]))
    T, k, E = x_flat.shape[0], jcfg.top_k, jcfg.n_experts
    logits = (x_flat @ jnp.asarray(jp["router"])).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    le = idx.reshape(-1)
    order = jnp.argsort(le, stable=True)
    se = le[order]
    counts = jnp.bincount(se, length=E + 1)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(T * k) - starts[se]
    keep = (se < E) & (pos < capacity)
    return np.asarray(idx), np.asarray(keep), np.asarray(se)


@pytest.mark.parametrize("case", ["ample", "capacity 2", "zero router"])
def test_moe_fwd_matches_the_reference(case):
    """Ample capacity (no drops), capacity 2 (drops) and a zero router
    (every probability ties: the reference then picks experts 0 … k − 1,
    and so must the stable sort). Routing integers bitwise; the output and
    the aux within float32 (readings: 1.9e-7 and 0 relative)."""
    cfg, jcfg, jp, tp, x = _moe_setup()
    T = x.shape[0] * x.shape[1]
    if case == "zero router":
        jp = dict(jp, router=np.zeros_like(jp["router"]))
        tp = dict(tp, router=torch.zeros_like(tp["router"]))
    cap = 2 if case == "capacity 2" else tmoe._capacity(T, cfg, cfg.n_experts)
    assert cap == jmoe._capacity(T, jcfg, jcfg.n_experts) or cap == 2
    idx, keep, se = _jax_routing(jp, jcfg, x, cap)
    r = tmoe.route(torch.from_numpy(x.reshape(T, -1)), tp["router"],
                   cfg=cfg, e_offset=0, e_local=cfg.n_experts, capacity=cap)
    np.testing.assert_array_equal(r["idx"].numpy(), idx)
    np.testing.assert_array_equal(r["se"].numpy(), se)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    if case == "zero router":
        assert (idx == np.arange(cfg.top_k)).all()
    if case == "capacity 2":
        assert not keep.all()
    else:
        assert keep.all()
    args = dict(cfg=jcfg, e_offset=0, e_local=jcfg.n_experts, capacity=cap)
    jout, (jme, jce) = jmoe._route_and_compute(
        jnp.asarray(x.reshape(T, -1)), jp["router"], jp["w_gate"],
        jp["w_up"], jp["w_down"], **args)
    tout, (tme, tce) = tmoe._route_and_compute(
        torch.from_numpy(x.reshape(T, -1)), tp["router"], tp["w_gate"],
        tp["w_up"], tp["w_down"], **dict(args, cfg=cfg))
    _close(tout, jout)
    _close(tme, jme)
    np.testing.assert_array_equal(tce.numpy(), np.asarray(jce))
    if case != "capacity 2":
        jo, ja = jmoe.moe_fwd(jp, jcfg, jnp.asarray(x))
        to, ta = tmoe.moe_fwd(tp, cfg, torch.from_numpy(x))
        _close(to, jo)
        assert ta.dtype == torch.float32
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_moe_shared_expert_and_mesh():
    """DeepSeek's shared expert is added on top of the routed output; on a
    one-member mesh the expert-parallel branch (one data rank: the decode
    layout, every expert local) is the one-device forward, bitwise."""
    jcfg = jget_config("deepseek-v3-671b-smoke")
    cfg = get_config("deepseek-v3-671b-smoke")
    jp = jax.device_get(jmoe.init_moe(jax.random.key(3), jcfg, jnp.float32))
    tp = convert.to_torch(jp)
    assert "shared" in tp
    x = np.random.default_rng(4).standard_normal((2, 8, cfg.d_model)) \
        .astype(np.float32)
    jo, ja = jmoe.moe_fwd(jp, jcfg, jnp.asarray(x))
    to, ta = tmoe.moe_fwd(tp, cfg, torch.from_numpy(x))
    _close(to, jo)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    from repro_torch.launch.mesh import make_host_mesh
    mo, ma = tmoe.moe_fwd(tp, cfg, torch.from_numpy(x),
                          mesh=make_host_mesh(device="cpu"))
    assert torch.equal(mo, to) and torch.equal(ma, ta)


def test_expert_partition_equivalence():
    """Experts computed in two local halves sum to the single-shot
    dispatch: the invariant the reference's expert-parallel psum relies
    on (its ``tests/test_moe.py``), here on the port."""
    cfg, _, _, tp, x = _moe_setup(dict(capacity_factor=8.0))
    T = x.shape[0] * x.shape[1]
    xf = torch.from_numpy(x.reshape(T, -1))
    cap = tmoe._capacity(T, cfg, cfg.n_experts)
    full, _ = tmoe._route_and_compute(
        xf, tp["router"], tp["w_gate"], tp["w_up"], tp["w_down"], cfg=cfg,
        e_offset=0, e_local=cfg.n_experts, capacity=cap)
    E2 = cfg.n_experts // 2
    half = 0
    for off in (0, E2):
        part, _ = tmoe._route_and_compute(
            xf, tp["router"], tp["w_gate"][off:off + E2],
            tp["w_up"][off:off + E2], tp["w_down"][off:off + E2], cfg=cfg,
            e_offset=off, e_local=E2, capacity=cap)
        half = half + part
    np.testing.assert_allclose(full.numpy(), half.numpy(), atol=1e-5)


@pytest.mark.parametrize("arch", SMOKES)
def test_loss_with_aux_and_mtp_matches_the_reference(arch):
    """The train forward on shared weights: cross entropy + the MoE aux
    (+ 0.3 x the MTP block's cross entropy for deepseek). Readings: 3 and
    0 ulp of the loss. The aux and MTP terms are there: the loss moves
    when either is switched off."""
    jm, tm, jp, tp = _models(arch)
    shape = ShapeConfig("t", S, B, "train")
    jb = japi.make_batch(jm, shape, jax.random.key(1))
    tb = api.make_batch(tm, shape, prng.key(1), device="cpu")
    jl, tl = float(jm.loss(jp, jb)), float(tm.loss(tp, tb))
    assert abs(jl - tl) <= 4 * np.spacing(np.float32(jl))
    no_aux = float(ttf.loss_fn(tp, tb, tm.cfg.replace(router_aux_coef=0.0)))
    assert no_aux < tl
    if tm.cfg.mtp:
        assert abs(float(ttf.loss_fn(tp, tb, tm.cfg.replace(mtp=False)))
                   - tl) > 1e-3


@pytest.mark.parametrize("arch", SMOKES)
def test_prefill_and_decode_match_the_reference(arch):
    """Prefill at width S + 4, then 4 decode steps on the reference's
    greedy tokens: logits and every group's cache (``{"dense", "moe"}``,
    ``{"latent"}`` under MLA) within 1e-5 of their largest magnitude."""
    jm, tm, jp, tp = _models(arch)
    shape = ShapeConfig("p", S, B, "prefill")
    jb = japi.make_batch(jm, shape, jax.random.key(1))
    tb = api.make_batch(tm, shape, prng.key(1), device="cpu")
    jl, jc = jm.prefill(jp, jb, S + 4)
    ops.reset_launches()
    tl, tc = tm.prefill(tp, tb, S + 4)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)   # plain versions
    _close(tl, jl)
    for i in range(4):
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        jl, jc = jm.decode(jp, {"tokens": tok}, jc,
                           jnp.asarray(S + i, jnp.int32))
        tl, tc = tm.decode(tp, {"tokens": torch.from_numpy(np.array(tok))},
                           tc, torch.tensor(S + i))
        _close(tl, jl)
    assert sorted(tc) == sorted(jc) == ["dense", "moe"]
    for g in jc:
        assert (tc[g] is None) == (jc[g] is None)
        for k, v in (jc[g] or {}).items():
            assert tuple(tc[g][k].shape) == v.shape
            _close(tc[g][k], v)
    zero = tm.init_cache(B, 8, device="cpu")
    jz = jtf.init_cache(jm.cfg, B, 8)
    for g in jz:
        for k, v in (jz[g] or {}).items():
            assert tuple(zero[g][k].shape) == v.shape
            assert not bool(zero[g][k].any())


@pytest.mark.parametrize("arch", SMOKES)
def test_decode_matches_prefill(arch):
    """The reference's consistency check (``tests/test_arch_smoke.py``):
    one decode step at position S against a prefill of S + 1 tokens, in
    float32 at the smoke configs' capacity factor 4.0, which drops
    nothing (its tolerance, atol 2e-4 and rtol 2e-3; readings 3.9e-7 and
    7.8e-7 of the largest logit)."""
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
def test_train_step_matches_the_reference(arch):
    """One pytree FedZO step (the launcher's route; b2 2, μ 1e-2) from the
    same weights, key and batch: the loss within 8 ulp; the coefficient
    norm within 1e-4 relative; every parameter within 1e-3 of the
    reference's while the step moves one by ten times that. A loss ulp
    (4.8e-7 near 6.6) moves a coefficient by d·ulp/μ = 30 at d = 624,384,
    and a weight by lr/b2 · 30 · max|v_i| ≈ 9.5e-5, so 1e-3 is about ten
    ulps. Readings: qwen3-moe 1.1e-5 (norm; its random router makes the
    coefficients 2.7e6) and 2.1e-4 (parameters, moved 8.6), deepseek 0 and
    1.2e-7 (moved 0.094)."""
    kw = dict(lr=1e-3, mu=1e-2, b2=2, estimator="sphere")
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
    jn = float(jmet["coeff_norm"])
    assert abs(float(tmet["coeff_norm"]) - jn) <= 1e-4 * jn
    worst, moved = 0.0, 0.0
    got = {"/".join(p): v for p, v in _leaves(tp)}
    init = dict(_jpaths(jp0))
    for name, want in _jpaths(jax.device_get(jp)):
        worst = max(worst, float(np.abs(got[name].numpy() - want).max()))
        moved = max(moved, float(np.abs(want - init[name]).max()))
    assert worst <= 1e-3
    assert moved >= 1e-2


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


@pytest.mark.parametrize("arch,want", [("qwen3-moe-30b-a3b", 30_532_122_624),
                                       ("deepseek-v3-671b", 671_609_894_912)])
def test_full_width_parameter_counts_on_meta(arch, want):
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jtf.param_specs(jget_config(arch)))) == want
    tp = ttf.init_params(prng.key(0), get_config(arch), device="meta")
    assert flat_spec(tp).d == want
    assert tp["moe_blocks"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_draw_is_bitwise_the_whole_draw(dtype):
    """``prng.normal_into`` in chunks (ragged last chunk) against the
    whole draw transformed and cast, the expert init's true division and
    ``dense_init``'s scale: bitwise."""
    k = prng.key(11)
    shape = (3, 70, 50)
    g = prng.normal(k, shape)
    for fn in (None, lambda x: x * 0.125,
               lambda x: x / torch.full_like(x, 70 ** 0.5)):
        want = (g if fn is None else fn(g)).to(dtype)
        for chunk in (1000, 4096, 10 ** 6):
            out = torch.empty(shape, dtype=dtype)
            prng.normal_into(k, out, fn, chunk=chunk)
            assert torch.equal(out, want), chunk


def test_stacked_init_is_bitwise_the_stack_of_layers():
    """``_stack_init`` fills each stacked leaf in place: bitwise
    ``_stack`` of the layers drawn one by one, for 1 (a view) and 3
    layers, dense and MoE blocks; an empty group is None."""
    cfg = get_config("deepseek-v3-671b-smoke")
    for moe_layer in (False, True):
        def init(k):
            return ttf.init_block(k, cfg, torch.float32, moe_layer=moe_layer)
        for n in (1, 3):
            got = ttf._stack_init(prng.key(5), n, init)
            want = ttf._stack([init(prng.fold_in(prng.key(5), i))
                               for i in range(n)])
            for (pa, a), (pb, b) in zip(_leaves(got), _leaves(want)):
                assert pa == pb and torch.equal(a, b), pa
    assert ttf._stack_init(prng.key(5), 0, None) is None


def test_none_subtree_is_carried_by_the_tree_utilities():
    """qwen3-moe's ``dense_blocks`` is None: no leaves in the flat order
    (jax's), kept by ``convert`` both ways and by ``tree_map``; the pytree
    helpers walk the other leaves."""
    jp = jax.device_get(japi.build(jget_config(SMOKES[0])).init(
        jax.random.key(0)))
    assert jp["dense_blocks"] is None
    tp = convert.to_torch(jp)
    assert tp["dense_blocks"] is None
    assert convert.to_numpy(tp)["dense_blocks"] is None
    assert [n for n, _ in _jpaths(jp)] == \
        ["/".join(p) for p, _ in _leaves(tp)]
    mapped = ttree.tree_map(lambda x: x * 2, tp)
    assert mapped["dense_blocks"] is None
    assert ttree.tree_size(tp) == sum(v.size for v in jax.tree.leaves(jp))
    twice = ops.tree_axpy2(tp, tp, tp, 1.0, 0.0)
    assert twice["dense_blocks"] is None
    assert torch.equal(twice["embed"]["tok"], 2 * tp["embed"]["tok"])
    assert flat_spec(tp).d == sum(v.size for v in jax.tree.leaves(jp))


def test_cohort_loss_of_the_moe_family_raises(monkeypatch):
    """The moe family's client-batched loss is ported
    (``tests/test_torch_moe_cohort.py``), and so are the ssm and hybrid
    families' (``tests/test_torch_ssm_cohort.py``) and the encdec and vlm
    families' (``tests/test_torch_xattn_cohort.py``), which raised before:
    at both of the latter's ``-smoke`` configs two clients' rows equal each
    client's own loss within rtol 2e-7, without reaching
    ``torch.func.vmap``."""
    for arch in ("seamless-m4t-large-v2-smoke", "llama-3.2-vision-90b-smoke"):
        m = api.build(get_config(arch))
        xa.cohort_loss_runs(m, m.init(prng.key(0), device="cpu"),
                            monkeypatch)
