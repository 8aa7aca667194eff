"""The ssm and hybrid families' client-batched cohort loss (the flat and
wide rounds' forward) against a live JAX run, at ``rwkv6-7b-smoke`` (the
RWKV-6 time and channel mix) and ``hymba-1.5b-smoke`` (attention under a
sliding window beside a selective SSM).

The reference maps the one-client loss over a round's clients with
``jax.vmap``. The port's ``Model.loss_batched`` takes ``[M', ...]`` leaves
(M' = r·M on the wide route): the projections are batched GEMMs, each
client's elementwise leaves (``w0``, ``u``, the lerp mixes, ``a_log``,
``dt_bias``, ``d_skip``) broadcast over its own rows, and the WKV chunk
loop and the selective scan run once over all M·B rows; a hybrid layer's
attention is one launch over the cohort. Inputs come from numpy seeds;
each tolerance stands beside its reason and its reading.
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
from repro_torch.models import api
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.utils import convert, prng
from tests import _torch_xattn as xa

SMOKES = ("rwkv6-7b-smoke", "hymba-1.5b-smoke")
M, H, B2, MU, LR = 3, 2, 4, 1e-2, 1e-3
S = 24   # not a multiple of the WKV chunk (16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(arch, seed=0):
    return jax.device_get(japi.build(jget_config(arch)).init(
        jax.random.key(seed)))


def _cohort(jp, seed, m=M):
    """m clients' weights: the shared weights plus a per-client offset of
    1e-2 (so ``a_log``, ``dt_bias``, ``w0`` and ``u``, zero at init, differ
    between clients), numpy ``[m, ...]`` leaves."""
    rs = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: (v[None] + 1e-2 * rs.standard_normal((m,) + v.shape))
        .astype(np.float32), jp)


def _batches(seed, lead, b=2, s=S, vocab=512):
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
    return {k: _client(v, m) if isinstance(v, dict) else v[m]
            for k, v in tree.items()}


def _no_vmap(monkeypatch):
    def no_vmap(*a, **k):
        raise AssertionError("reached torch.func.vmap")
    monkeypatch.setattr(torch.func, "vmap", no_vmap)


@pytest.mark.parametrize("arch", SMOKES)
def test_batched_loss_matches_each_client_and_jax_vmap(arch, monkeypatch):
    """``Model.loss_batched`` (through ``fedzo.batched_loss``) on M
    clients' own weights and batches equals each client's ``Model.loss``
    within rtol 2e-7, as the dense cohort is held (the products in the
    one-client order, the scans over the same rows; reading bitwise), and
    the reference's ``jax.vmap(loss)`` within 8 loss ulps (readings 3 and
    2); ``torch.func.vmap`` is never reached."""
    _no_vmap(monkeypatch)
    params = _cohort(_jax_params(arch), seed=1)
    batch = _batches(2, (M,))
    model = api.build(get_config(arch))
    assert model.loss.batched is model.loss_batched
    got = fedzo.batched_loss(model.loss)(_t(params), _t(batch))
    assert got.shape == (M,)
    each = torch.stack([model.loss(_t(_row(params, i)),
                                   _t({k: v[i] for k, v in batch.items()}))
                        for i in range(M)])
    torch.testing.assert_close(got, each, rtol=2e-7, atol=0)
    want = np.asarray(jax.vmap(japi.build(jget_config(arch)).loss)(
        _j(params), _j(batch)))
    ulp = np.spacing(np.float32(want.max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=8 * ulp)


def test_batched_layers_equal_each_client():
    """The batched time mix, channel mix and Mamba branch on M clients'
    layer-0 weights equal each client's one-client function from a zero
    state bitwise on the CPU (the same GEMM shapes a client, the chunk
    loops over the M·B rows), the clients' elementwise leaves all nonzero
    and distinct. At B·T = 64 rows a client: PyTorch's CPU elementwise
    kernels take exp and log vectorized over whole vector groups and by
    the scalar libm for a tensor's tail, so where a client's rows of the
    Mamba step ``dt`` (one value a token) do not fill whole groups, an
    element of the cohort's tensor can take the other path than the
    one-client tensor's and differ by an ulp (at T = 37: the loss itself
    stays within the 2e-7 of the test above)."""
    rs = np.random.default_rng(3)
    for arch in SMOKES:
        cfg = get_config(arch)
        p = ttf._layer_batched(_t(_cohort(_jax_params(arch), seed=4))
                               ["blocks"], 0)
        x = torch.from_numpy((0.5 * rs.standard_normal(
            (M, 2, 32, cfg.d_model))).astype(np.float32))
        if cfg.family == "ssm":
            xp = torch.from_numpy((0.5 * rs.standard_normal(
                x.shape)).astype(np.float32))
            got = (tssm.rwkv_tmix_fwd_batched(p["tmix"], cfg, x),
                   tssm.rwkv_cmix_fwd_batched(p["cmix"], x, xp))
            for m in range(M):
                pm = _client(p, m)
                want = (tssm.rwkv_tmix_fwd(pm["tmix"], cfg, x[m])[0],
                        tssm.rwkv_cmix_fwd(pm["cmix"], x[m], xp[m]))
                for g, w in zip(got, want):
                    assert torch.equal(g[m], w), (arch, m)
        else:
            got = tssm.mamba_fwd_batched(p["mamba"], cfg, x)
            for m in range(M):
                want, _ = tssm.mamba_fwd(_client(p, m)["mamba"], cfg, x[m])
                assert torch.equal(got[m], want), (arch, m)


@pytest.mark.parametrize("arch", SMOKES)
def test_wide_copies_take_their_clients_batch(arch):
    """The wide route hands the batched loss r = 2 perturbed copies of each
    client (leaves ``[M·r, ...]``) against ``[M, ...]`` batches: row m·r + j
    is client m's copy j on client m's batch, its own ``Model.loss``
    within rtol 2e-7 (reading bitwise)."""
    r = 2
    params = _cohort(_jax_params(arch), seed=5, m=M * r)
    batch = _batches(6, (M,))
    model = api.build(get_config(arch))
    got = model.loss_batched(_t(params), _t(batch))
    assert got.shape == (M * r,)
    each = torch.stack([model.loss(
        _t(_row(params, i)), _t({k: v[i // r] for k, v in batch.items()}))
        for i in range(M * r)])
    torch.testing.assert_close(got, each, rtol=2e-7, atol=0)


def test_hymba_kernel_calls_do_not_grow_with_m(monkeypatch):
    """hymba-1.5b-smoke's cohort loss makes as many RMSNorm and attention
    calls at M = 1 as at M = 4 (each one launch over the whole cohort on
    the card): 2L + 1 norms and L attentions a forward; rwkv6 (layernorms,
    no attention) makes none."""
    calls = xa.count_kernel_calls(monkeypatch)
    for arch in SMOKES:
        cfg = get_config(arch)
        model = api.build(cfg)
        seen = []
        for m in (1, 4):
            params = _cohort(_jax_params(arch), seed=7, m=m)
            for k in calls:
                calls[k] = 0
            model.loss_batched(_t(params), _t(_batches(8, (m,))))
            seen.append(dict(calls))
        assert seen[0] == seen[1], arch
        want = {"rmsnorm": 0, "attention": 0} if cfg.family == "ssm" else \
            {"rmsnorm": 2 * cfg.n_layers + 1, "attention": cfg.n_layers}
        assert seen[0] == want, (arch, seen)


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


def _rounds(arch, jcfg, tcfg, seed, n):
    """``n`` chained ``round_simulated`` rounds of each package from the
    same weights, batches and keys -> per round (worst |param diff|,
    largest move from the start, the reference's metrics, the port's)."""
    jm, tm = japi.build(jget_config(arch)), api.build(get_config(arch))
    p0 = _jax_params(arch)
    jp, tp, out = _j(p0), _t(p0), []
    for rnd in range(n):
        batch = _batches(seed + rnd, (M, H))
        keys = jax.random.split(jax.random.key(seed + 10 + rnd), M)
        kchan = jax.random.key(seed + 20 + rnd)
        jp, jmet = jfedzo.round_simulated(jm.loss, jp, _j(batch), keys,
                                          jcfg, channel_rng=kchan)
        tp, tmet = fedzo.round_simulated(
            tm.loss, tp, _t(batch), prng.as_key(jax.random.key_data(keys)),
            tcfg, channel_rng=prng.as_key(jax.random.key_data(kchan)))
        worst, moved = 0.0, 0.0
        for name, want in _path_names(jax.device_get(jp)):
            worst = max(worst, float(np.abs(_get(tp, name).numpy()
                                            - want).max()))
            moved = max(moved, float(np.abs(want - _get(p0, name)).max()))
        out.append((worst, moved, jmet, tmet))
    return out


@pytest.mark.parametrize("air", [False, True], ids=["mean", "aircomp"])
@pytest.mark.parametrize("arch", SMOKES)
def test_flat_round_matches_reference(arch, air, monkeypatch):
    """Flat ``round_simulated`` rounds over M = 3 clients (H = 2, b2 = 4, μ
    = 1e-2, lr = 1e-3), the plain mean over two rounds and AirComp (channel
    scheduling at 5 dB) over one, against the reference's vmapped rounds
    from the same weights, batches and keys, without reaching
    ``torch.func.vmap``. After one round the weights within the dense and
    moe rounds' 6e-4 (``test_torch_flat_lm.py``: a loss ulp moves a
    coefficient by d·ulp/μ, a weight by about 1e-4 an iterate; readings
    2.2e-4 and 3.1e-4 for rwkv6's mean and AirComp rounds, 3.1e-4 and
    4.3e-4 for hymba's), after two within 2e-3: the first round's
    differences carried into a second round, whose coefficients they move
    by d·δ·|∇f|/μ (readings 3.1e-4 for rwkv6, 1.6e-3 for hymba, whose
    Mamba decays exp(dt·A) and sliding attention make the steeper loss),
    while the rounds move a weight by at least 10x the bound (0.74 to 1.05
    for rwkv6, 3.6e-2 to 7.7e-2 for hymba); the first round's first loss
    within 8 ulps and each round's mean loss within 5e-4; the AirComp
    statistics within 1e-2 relative, the moe rounds' bound (Δ_max moves by
    about 2·|δc|/|c|; readings 1.8e-4 and 9.1e-5 for rwkv6, 6.4e-3 and
    3.2e-3 for hymba)."""
    _no_vmap(monkeypatch)
    jcfg, tcfg = _round_configs(air)
    rounds = _rounds(arch, jcfg, tcfg, seed=30, n=1 if air else 2)
    for (worst, moved, jmet, tmet), bound in zip(rounds, (6e-4, 2e-3)):
        assert sorted(tmet) == sorted(jmet)
        assert worst <= bound
        assert moved >= 10 * bound       # the limit is not vacuous
        assert abs(float(tmet["mean_local_loss"])
                   - float(jmet["mean_local_loss"])) <= 5e-4
    jmet, tmet = rounds[0][2:]
    first = float(jmet["first_loss"])
    assert abs(float(tmet["first_loss"]) - first) \
        <= 8 * np.spacing(np.float32(first))
    if air:
        assert float(tmet["m_effective"]) == float(jmet["m_effective"])
        for k in ("delta_max", "aircomp_noise_std"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-2, err_msg=k)


@pytest.mark.parametrize("arch", SMOKES)
def test_wide_round_matches_reference(arch, monkeypatch):
    """One wide round (batch_directions, block directions: the M·b2
    perturbed copies in one cohort call) against the reference's, within
    the flat round's 6e-4 (readings 1.4e-4 for rwkv6, 4.9e-4 for hymba,
    against moves of 0.79 and 3.8e-2), never through
    ``torch.func.vmap``."""
    _no_vmap(monkeypatch)
    jcfg, tcfg = _round_configs(False, batch_directions=True,
                                direction_conv="block")
    (worst, moved, _, _), = _rounds(arch, jcfg, tcfg, seed=40, n=1)
    assert worst <= 6e-4 and moved >= 10 * 6e-4
