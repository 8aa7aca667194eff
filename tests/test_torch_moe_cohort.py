"""The moe family's client-batched cohort loss (the flat and wide rounds'
forward) against a live JAX run, at ``qwen3-moe-30b-a3b-smoke`` and
``deepseek-v3-671b-smoke`` (MLA, MTP, a shared expert, a dense layer
before the MoE one).

The reference maps the one-client loss over a round's clients with
``jax.vmap``: client m routes its own tokens with its own router, at the
capacity of its own token count. The port's ``Model.loss_batched`` takes
``[M', ...]`` leaves (M' = r·M on the wide route) and numbers client m's
expert e as the global expert m·E + e (``moe.route_batched``). Inputs come
from numpy seeds; each tolerance stands beside its reason and its reading.
"""
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
from repro_torch.configs import get_config
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedzo
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.utils import convert, prng

SMOKES = ("qwen3-moe-30b-a3b-smoke", "deepseek-v3-671b-smoke")
M, H, B2, MU, LR = 3, 2, 4, 1e-2, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg, seed=0):
    return jax.device_get(japi.build(cfg).init(jax.random.key(seed)))


def _cohort(jp, seed, m=M):
    """m clients' weights: the shared weights plus a per-client offset of
    1e-2 (each client's router gives its own top-k), numpy ``[m, ...]``
    leaves; an empty group stays None."""
    rs = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: (v[None] + 1e-2 * rs.standard_normal((m,) + v.shape))
        .astype(np.float32), jp)


def _batches(seed, lead, b=2, s=16, vocab=512):
    toks = jsyn.lm_token_stream(20_000, vocab, seed=seed)
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead))
    bs = [jsyn.lm_batches(toks, b, s, rng) for _ in range(n)]
    return {k: np.stack([x[k] for x in bs]).reshape(tuple(lead) + (b, s))
            for k in ("tokens", "labels")}


def _t(tree):
    return convert.to_torch(tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _row(tree, i):
    return jax.tree.map(lambda v: v[i], tree)


def _client(tree, m):
    """Client m's leaves of a ``[M, ...]`` tensor tree."""
    return {k: _client(v, m) if isinstance(v, dict) else v[m]
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", SMOKES)
def test_batched_loss_matches_each_client_and_jax_vmap(arch, monkeypatch):
    """``Model.loss_batched`` on M clients' own weights and batches equals
    each client's ``Model.loss`` (rtol 2e-7, as the dense cohort is held:
    the same plain kernels on the same rows, the expert GEMMs one client's
    shape; reading bitwise) and the reference's ``jax.vmap(loss)`` within 8
    loss ulps (readings 2 for both configs), every row's aux and MTP term
    its own; ``torch.func.vmap`` is never reached."""
    def no_vmap(*a, **k):
        raise AssertionError("reached torch.func.vmap")
    monkeypatch.setattr(torch.func, "vmap", no_vmap)
    jcfg, tcfg = jget_config(arch), get_config(arch)
    params = _cohort(_jax_params(jcfg), seed=1)
    batch = _batches(2, (M,))
    model = api.build(tcfg)
    assert model.loss.batched is model.loss_batched
    got = fedzo.batched_loss(model.loss)(_t(params), _t(batch))
    assert got.shape == (M,)
    each = torch.stack([model.loss(_t(_row(params, i)),
                                   _t({k: v[i] for k, v in batch.items()}))
                        for i in range(M)])
    torch.testing.assert_close(got, each, rtol=2e-7, atol=0)
    want = np.asarray(jax.vmap(japi.build(jcfg).loss)(_j(params),
                                                      _j(batch)))
    ulp = np.spacing(np.float32(want.max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=8 * ulp)
    # the aux and MTP terms are there, each row its own
    plain = ttf.loss_fn_batched(_t(params), _t(batch), tcfg.replace(
        router_aux_coef=0.0, mtp=False))
    assert bool((got > plain).all())


@pytest.mark.parametrize("arch", SMOKES)
def test_routing_integers_per_client_bitwise(arch):
    """``route_batched`` over M clients' tokens and routers: each client's
    top-k experts ``idx`` equal its own ``route``'s and jax's
    ``lax.top_k`` of its own probabilities, and its block of the sorted
    assignments (the slots, ``keep``) equals its own sort, integer for
    integer."""
    cfg = get_config(arch)
    jp = _jax_params(jget_config(arch))
    moe = jp["moe_blocks"]["moe"]
    routers = np.stack([moe["router"][0] + 1e-2 * np.random.default_rng(
        i).standard_normal(moe["router"][0].shape).astype(np.float32)
        for i in range(M)])
    T = 32
    x = (0.5 * np.random.default_rng(3).standard_normal(
        (M, T, cfg.d_model))).astype(np.float32)
    cap = tmoe._capacity(T, cfg, cfg.n_experts)
    r = tmoe.route_batched(torch.from_numpy(x), torch.from_numpy(routers),
                           cfg=cfg, capacity=cap)
    k = cfg.top_k
    for m in range(M):
        own = tmoe.route(torch.from_numpy(x[m]), torch.from_numpy(routers[m]),
                         cfg=cfg, e_offset=0, e_local=cfg.n_experts,
                         capacity=cap)
        assert torch.equal(r["idx"][m], own["idx"])
        blk = slice(m * T * k, (m + 1) * T * k)
        assert torch.equal(r["keep"][blk], own["keep"])
        assert torch.equal(r["pos"][blk], own["pos"])
        assert torch.equal(r["se"][blk] - m * cfg.n_experts, own["se"])
        assert torch.equal(r["st"][blk] - m * T, own["st"])
        probs = jax.nn.softmax(jnp.asarray(x[m]) @ jnp.asarray(routers[m]))
        _, jidx = jax.lax.top_k(probs, k)
        np.testing.assert_array_equal(r["idx"][m].numpy(), np.asarray(jidx))


@pytest.mark.parametrize("factor", [4.0, 1.0])
def test_moe_layer_batched_equals_each_client(factor):
    """``moe_fwd_batched`` rows equal each client's ``moe_fwd`` bitwise on
    the CPU (the same gathers and one client's GEMM shapes), the output
    and the aux, with ample capacity and at capacity factor 1.0, where
    assignments drop: the drops too are each client's own."""
    cfg = get_config("deepseek-v3-671b-smoke").replace(
        capacity_factor=factor)
    jp = _cohort(_jax_params(jget_config("deepseek-v3-671b-smoke")), seed=5)
    p = ttf._layer_batched(_t(jp)["moe_blocks"]["moe"], 0)
    x = torch.from_numpy((0.5 * np.random.default_rng(6).standard_normal(
        (M, 2, 16, cfg.d_model))).astype(np.float32))
    out, aux = tmoe.moe_fwd_batched(p, cfg, x)
    assert out.shape == x.shape and aux.shape == (M,)
    cap = tmoe._capacity(32, cfg, cfg.n_experts)
    dropped = 0
    for m in range(M):
        pm = _client(p, m)
        o, a = tmoe.moe_fwd(pm, cfg, x[m])
        assert torch.equal(out[m], o) and torch.equal(aux[m], a), m
        own = tmoe.route(x[m].reshape(32, -1), pm["router"], cfg=cfg,
                         e_offset=0, e_local=cfg.n_experts, capacity=cap)
        dropped += int((~own["keep"]).sum())
    assert (dropped > 0) == (factor == 1.0)


def test_mla_batched_equals_each_client():
    """``mla_fwd_batched`` (the latents' RMSNorms with a ``[M, D]`` scale,
    one attention over the ``[M·B]`` rows at (24, 16)) equals each client's
    ``mla_fwd`` output bitwise on the CPU."""
    cfg = get_config("deepseek-v3-671b-smoke")
    jp = _cohort(_jax_params(jget_config("deepseek-v3-671b-smoke")), seed=7)
    p = ttf._layer_batched(_t(jp)["moe_blocks"]["attn"], 0)
    x = torch.from_numpy((0.5 * np.random.default_rng(8).standard_normal(
        (M, 2, 16, cfg.d_model))).astype(np.float32))
    ops.reset_launches()
    got = tattn.mla_fwd_batched(p, cfg, x)
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}   # plain versions
    for m in range(M):
        want, _ = tattn.mla_fwd(_client(p, m), cfg, x[m])
        assert torch.equal(got[m], want), m


@pytest.mark.parametrize("arch", SMOKES)
def test_wide_copies_take_their_clients_batch(arch):
    """The wide route hands the batched loss r = 2 perturbed copies of each
    client (leaves ``[M·r, ...]``) against ``[M, ...]`` batches: row m·r + j
    is client m's copy j on client m's batch, its own ``Model.loss`` within
    rtol 2e-7 (reading bitwise)."""
    r = 2
    params = _cohort(_jax_params(jget_config(arch)), seed=4, m=M * r)
    batch = _batches(5, (M,))
    model = api.build(get_config(arch))
    got = model.loss_batched(_t(params), _t(batch))
    assert got.shape == (M * r,)
    each = torch.stack([model.loss(
        _t(_row(params, i)), _t({k: v[i // r] for k, v in batch.items()}))
        for i in range(M * r)])
    torch.testing.assert_close(got, each, rtol=2e-7, atol=0)


def _round_configs(air, **extra):
    kw = dict(n_participating=M, local_iters=H, b2=B2, lr=LR, mu=MU,
              estimator="sphere", flat_params=True, **extra)
    if air:
        kw.update(aircomp=True, channel_schedule=True, snr_db=5.0)
    return JConfig(**kw), FedZOConfig(**kw)


def _path_names(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(k.key for k in path), leaf) for path, leaf in leaves]


def _get(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("air", [False, True], ids=["mean", "aircomp"])
@pytest.mark.parametrize("arch", SMOKES)
def test_flat_moe_round_matches_reference(arch, air, monkeypatch):
    """One flat ``round_simulated`` over M = 3 clients (H = 2, b2 = 4, μ =
    1e-2, lr = 1e-3; the plain mean, and AirComp with channel scheduling at
    5 dB) against the reference's vmapped round, from the same weights,
    batches and keys, without reaching ``torch.func.vmap``. The weights
    within the dense round's 6e-4 (``test_torch_flat_lm.py``: a loss ulp
    moves a coefficient by d·ulp/μ; readings 2.3e-4 for qwen3-moe and
    4.4e-4 for deepseek, whose MTP head doubles the loss's slopes, while
    the round moves a weight by 4.4e-2 to 4.9e-2), the mean local loss
    within 5e-4 and the first loss within 8 ulps (readings 5.6e-5 and
    3.8e-4; 1 and 0 ulps). On these batches the round is not chaotic: a
    1e-5 relative change of the start moves its result by 1.3e-4 (qwen3-moe)
    and 4.1e-4 (deepseek) at most, measured on the CPU; on other batches a
    perturbed point of the first iterate can cross a routing boundary, and
    the second iterate then starts where a 1e-6 change moves the result by
    0.4 (``chip_smoke.COHORT_SMOKE_H``).
    The AirComp statistics within 1e-2 relative: Δ_max is the largest
    client's squared delta norm, which moves by about 2·|δc|/|c| with the
    coefficients c, and here each coefficient differs from the
    reference's by up to 9 loss ulps (d/μ each) against coefficients of
    100 to 1,000 of them (the dense smoke model's are of 100 to 400, hence
    its 1e-3): readings 1.5e-3 and 3.1e-3 for Δ_max, 7.5e-4 and 1.6e-3
    for the noise std."""
    def no_vmap(*a, **k):
        raise AssertionError("reached torch.func.vmap")
    monkeypatch.setattr(torch.func, "vmap", no_vmap)
    jcfg, tcfg = _round_configs(air)
    jm, tm = japi.build(jget_config(arch)), api.build(get_config(arch))
    p0 = _jax_params(jget_config(arch))
    batch = _batches(5, (M, H))
    keys = jax.random.split(jax.random.key(6), M)
    kchan = jax.random.key(7)
    jp, jmet = jfedzo.round_simulated(
        jm.loss, _j(p0), _j(batch), keys, jcfg, channel_rng=kchan)
    tp, tmet = fedzo.round_simulated(
        tm.loss, _t(p0), _t(batch), prng.as_key(jax.random.key_data(keys)),
        tcfg, channel_rng=prng.as_key(jax.random.key_data(kchan)))
    assert sorted(tmet) == sorted(jmet)
    worst, moved = 0.0, 0.0
    for name, want in _path_names(jax.device_get(jp)):
        worst = max(worst, float(np.abs(_get(tp, name).numpy()
                                        - want).max()))
        moved = max(moved, float(np.abs(want - _get(p0, name)).max()))
    assert worst <= 6e-4
    assert moved >= 10 * 6e-4       # the limit is not vacuous
    first = float(jmet["first_loss"])
    assert abs(float(tmet["first_loss"]) - first) \
        <= 8 * np.spacing(np.float32(first))
    assert abs(float(tmet["mean_local_loss"])
               - float(jmet["mean_local_loss"])) <= 5e-4
    if air:
        assert float(tmet["m_effective"]) == float(jmet["m_effective"])
        for k in ("delta_max", "aircomp_noise_std"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-2, err_msg=k)


def test_wide_moe_round_runs_the_cohort_loss(monkeypatch):
    """A wide round (batch_directions, block directions) on
    qwen3-moe-30b-a3b-smoke goes through the cohort loss (M·b2 copies in
    one call), never through ``torch.func.vmap``, and matches the
    reference's wide round within the flat round's 6e-4 (reading 1.7e-4
    against a move of 0.14)."""
    def no_vmap(*a, **k):
        raise AssertionError("reached torch.func.vmap")
    monkeypatch.setattr(torch.func, "vmap", no_vmap)
    arch = SMOKES[0]
    jcfg, tcfg = _round_configs(False, batch_directions=True,
                                direction_conv="block")
    jm, tm = japi.build(jget_config(arch)), api.build(get_config(arch))
    p0 = _jax_params(jget_config(arch))
    batch = _batches(9, (M, H))
    keys = jax.random.split(jax.random.key(10), M)
    jp, _ = jfedzo.round_simulated(jm.loss, _j(p0), _j(batch), keys, jcfg)
    tp, _ = fedzo.round_simulated(tm.loss, _t(p0), _t(batch),
                                  prng.as_key(jax.random.key_data(keys)),
                                  tcfg)
    worst, moved = 0.0, 0.0
    for name, want in _path_names(jax.device_get(jp)):
        worst = max(worst, float(np.abs(_get(tp, name).numpy()
                                        - want).max()))
        moved = max(moved, float(np.abs(want - _get(p0, name)).max()))
    assert worst <= 6e-4 and moved >= 10 * 6e-4
