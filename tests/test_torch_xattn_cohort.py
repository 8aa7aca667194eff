"""The enc-dec and VLM families' client-batched cohort loss (the flat,
AirComp and wide rounds' forward) against a live JAX run, at
``seamless-m4t-large-v2-smoke`` (a bidirectional encoder over 16 stub
frames, a causal decoder with a cross-attention in every layer) and
``llama-3.2-vision-90b-smoke`` (one self layer and one gated cross layer
over 16 stub patches, both trees' gates at 0.5: at zero gates a broken
cross path passes).

The reference maps the one-client loss over a round's clients with
``jax.vmap``. The port's ``Model.loss_batched`` takes ``[M', ...]`` leaves
(M' = r·M on the wide route, whose rows repeat their client's tokens and
frontend embeddings): the products are batched GEMMs, each client's gates
scale its own rows, and every RMSNorm and attention is one launch over the
cohort. Inputs come from numpy seeds; each tolerance stands beside its
reason and its reading.
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
from repro_torch.utils import convert, prng
from tests import _torch_xattn as xa

SMOKES = ("seamless-m4t-large-v2-smoke", "llama-3.2-vision-90b-smoke")
M, S = 3, 16
# the rounds: the plain Threefry draws of a smoke model's 0.44-0.72 M
# weights dominate a round on the CPU, so two clients, one iterate and
# two directions
RM, H, B2, MU, LR = 2, 1, 2, 1e-2, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frontend(cfg):
    return "src_embeds" if cfg.family == "encdec" else "vision_embeds"


def _jax_params(arch):
    return xa.gated(jax.device_get(japi.build(jget_config(arch)).init(
        jax.random.key(0))))


def _cohort(jp, seed, m=M):
    """m clients' weights: the shared weights plus a per-client offset of
    1e-2 (the VLM's gates then differ between clients), numpy ``[m, ...]``
    leaves."""
    rs = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: (v[None] + 1e-2 * rs.standard_normal((m,) + v.shape))
        .astype(np.float32), jp)


def _batches(cfg, seed, lead, b=2):
    """LM tokens and labels ``lead + [b, S]`` and the frontend stub's
    embeddings ``lead + [b, n_frontend_tokens, d_model]``."""
    toks = jsyn.lm_token_stream(20_000, cfg.vocab, seed=seed)
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead))
    bs = [jsyn.lm_batches(toks, b, S, rng) for _ in range(n)]
    out = {k: np.stack([x[k] for x in bs]).reshape(tuple(lead) + (b, S))
           for k in ("tokens", "labels")}
    out[_frontend(cfg)] = rng.standard_normal(
        tuple(lead) + (b, cfg.n_frontend_tokens, cfg.d_model)).astype(
        np.float32)
    return out


def _t(tree):
    return convert.to_torch(tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _row(tree, i):
    return jax.tree.map(lambda v: v[i], tree)


@pytest.mark.parametrize("arch", SMOKES)
def test_batched_loss_matches_each_client_and_jax_vmap(arch, monkeypatch):
    """``Model.loss_batched`` (through ``fedzo.batched_loss``) on M = 3
    clients' own weights and batches equals each client's ``Model.loss``
    within rtol 2e-7, as the dense cohort is held (the products in the
    one-client shapes; reading bitwise), and the reference's
    ``jax.vmap(loss)`` within 8 loss ulps (readings 1 and 2);
    ``torch.func.vmap`` is never reached."""
    xa.no_vmap(monkeypatch)
    cfg = get_config(arch)
    params = _cohort(_jax_params(arch), seed=1)
    batch = _batches(cfg, 2, (M,))
    model = api.build(cfg)
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


@pytest.mark.parametrize("arch", SMOKES)
def test_wide_copies_take_their_clients_batch(arch):
    """The wide route hands the batched loss r = 2 perturbed copies of each
    client (leaves ``[M·r, ...]``) against ``[M, ...]`` batches: row m·r + j
    is client m's copy j on client m's tokens and frontend embeddings (the
    encoder runs per row), its own ``Model.loss`` within rtol 2e-7
    (reading bitwise)."""
    r = 2
    cfg = get_config(arch)
    params = _cohort(_jax_params(arch), seed=5, m=M * r)
    batch = _batches(cfg, 6, (M,))
    model = api.build(cfg)
    got = model.loss_batched(_t(params), _t(batch))
    assert got.shape == (M * r,)
    each = torch.stack([model.loss(
        _t(_row(params, i)), _t({k: v[i // r] for k, v in batch.items()}))
        for i in range(M * r)])
    torch.testing.assert_close(got, each, rtol=2e-7, atol=0)


def test_kernel_calls_do_not_grow_with_m(monkeypatch):
    """The cohort loss makes as many RMSNorm and attention calls at M = 1
    as at M = 4 (each one launch over the whole cohort on the card), and
    never reaches ``torch.func.vmap``: the enc-dec's E + 2L attentions and
    2L cross k and q norms (its block norms are layernorms), the VLM's L
    attentions and 2L + 2G + 1 norms: a one-client train forward's
    (``chip_smoke.xattn_launches``, the counts the card's run holds the
    full-width cohorts to)."""
    xa.no_vmap(monkeypatch)
    calls = xa.count_kernel_calls(monkeypatch)
    for arch in SMOKES:
        cfg = get_config(arch)
        model = api.build(cfg)
        seen = []
        for m in (1, 4):
            params = _cohort(_jax_params(arch), seed=7, m=m)
            for k in calls:
                calls[k] = 0
            model.loss_batched(_t(params), _t(_batches(cfg, 8, (m,))))
            seen.append(dict(calls))
        assert seen[0] == seen[1], arch
        assert seen[0] == xa.kernel_calls(cfg, "prefill"), arch
    assert seen[0] == {"rmsnorm": 7, "attention": 2}   # the VLM smoke's


def _round_configs(air, **extra):
    kw = dict(n_participating=RM, local_iters=H, b2=B2, lr=LR, mu=MU,
              estimator="sphere", flat_params=True, flat_block_rows=4,
              **extra)
    if air:
        kw.update(aircomp=True, channel_schedule=True, snr_db=5.0)
    return JConfig(**kw), FedZOConfig(**kw)


def _rounds(arch, jcfg, tcfg, seed, n):
    """``n`` chained ``round_simulated`` rounds of each package from the
    same weights, batches and keys -> per round (worst |param diff|,
    largest move from the start, the reference's metrics, the port's)."""
    cfg = get_config(arch)
    jm, tm = japi.build(jget_config(arch)), api.build(cfg)
    # jitted, as the reference's engine runs its rounds: one trace for
    # the chained rounds instead of an eager dispatch of every op
    jround = jax.jit(lambda p, b, k, kc: jfedzo.round_simulated(
        jm.loss, p, b, k, jcfg, channel_rng=kc))
    p0 = _jax_params(arch)
    jp, tp, out = _j(p0), _t(p0), []
    for rnd in range(n):
        batch = _batches(cfg, seed + rnd, (RM, H))
        keys = jax.random.split(jax.random.key(seed + 10 + rnd), RM)
        kchan = jax.random.key(seed + 20 + rnd)
        jp, jmet = jround(jp, _j(batch), keys, kchan)
        tp, tmet = fedzo.round_simulated(
            tm.loss, tp, _t(batch), prng.as_key(jax.random.key_data(keys)),
            tcfg, channel_rng=prng.as_key(jax.random.key_data(kchan)))
        worst, moved = 0.0, 0.0
        for name, want in xa.jpaths(jax.device_get(jp)):
            got = tp
            for k in name.split("/"):
                got = got[k]
            base = p0
            for k in name.split("/"):
                base = base[k]
            worst = max(worst, float(np.abs(got.numpy() - want).max()))
            moved = max(moved, float(np.abs(want - base).max()))
        out.append((worst, moved, jmet, tmet))
    return out


@pytest.mark.parametrize("route", ["mean", "aircomp", "wide"])
@pytest.mark.parametrize("arch", SMOKES)
def test_round_matches_reference(arch, route, monkeypatch):
    """Flat ``round_simulated`` rounds over M = 2 clients (H = 1, b2 = 2,
    μ = 1e-2, lr = 1e-3): the plain mean over two rounds, AirComp (channel
    scheduling at 5 dB) over one, and one wide round (batch_directions,
    block directions: the M·b2 perturbed copies in one cohort call),
    against the reference's vmapped rounds from the same weights, batches
    and keys, without reaching ``torch.func.vmap``. The tolerances of the
    ssm and hybrid cohort rounds (``tests/test_torch_ssm_cohort.py``):
    after one round the weights within 6e-4 (a loss ulp moves a
    coefficient by d·ulp/μ), after two within 2e-3, while the rounds move
    a weight by at least 10x the bound; the first round's first loss
    within 8 ulps and each round's mean loss within 5e-4; the AirComp
    statistics within 1e-2 relative. Readings: seamless 1.6e-4 and 2.3e-4
    (mean), 1.2e-7 (AirComp, one client scheduled), 1.2e-4 (wide); the
    VLM 2.8e-4 and 4.7e-4, 4.3e-4, 2.6e-4; moves 2.0e-2 to 6.7e-2; first
    losses 0 and 2 ulps; the VLM's delta_max 6.3e-3 relative."""
    xa.no_vmap(monkeypatch)
    extra = (dict(batch_directions=True, direction_conv="block")
             if route == "wide" else {})
    jcfg, tcfg = _round_configs(route == "aircomp", **extra)
    rounds = _rounds(arch, jcfg, tcfg, seed=30, n=2 if route == "mean"
                     else 1)
    for (worst, moved, jmet, tmet), bound in zip(rounds, (6e-4, 2e-3)):
        assert sorted(tmet) == sorted(jmet)
        assert worst <= bound, (worst, bound)
        assert moved >= 10 * bound       # the limit is not vacuous
        assert abs(float(tmet["mean_local_loss"])
                   - float(jmet["mean_local_loss"])) <= 5e-4
    jmet, tmet = rounds[0][2:]
    first = float(jmet["first_loss"])
    assert abs(float(tmet["first_loss"]) - first) \
        <= 8 * np.spacing(np.float32(first))
    if route == "aircomp":
        assert float(tmet["m_effective"]) == float(jmet["m_effective"])
        for k in ("delta_max", "aircomp_noise_std"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-2, err_msg=k)
