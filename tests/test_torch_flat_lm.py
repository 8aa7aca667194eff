"""The flat FedZO round on the dense LM with the client axis written out,
against a live JAX run; and the CPU halves of the kernels that round runs
at new shapes (RMSNorm with a per-client scale, attention at head dims 16
and 256, the AirComp norms' summation order).

The reference maps the loss over the M clients of a round with
``jax.vmap``; the port's ``Model.loss`` carries a client-batched form
(``loss.batched``: ``[M, ...]`` leaves, ``[M]`` losses) that
``core/fedzo.batched_loss`` takes instead of ``torch.func.vmap``, because a
kernel launch cannot run under ``vmap``. Everything runs at
``qwen2-0.5b-smoke`` (d = 361,600) on the CPU, where the wrappers run the
kernels' plain versions. Inputs come from numpy seeds; each tolerance
stands beside its reason and its reading.
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
from repro.models.layers import chunked_attention, norm_fwd
from repro.utils import flatparams as jflat
from repro_torch.configs import get_config
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedzo
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import zo_aircomp as zac
from repro_torch.models import api
from repro_torch.utils import convert, prng
from repro_torch.utils import flatparams as tflat

SMOKE = "qwen2-0.5b-smoke"
M, H, B2, MU, LR = 3, 2, 4, 1e-2, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the port's CPU path is many small ops, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg, seed=0):
    return jax.device_get(japi.build(cfg).init(jax.random.key(seed)))


def _cohort(jp, seed, m=M):
    """M clients' weights: the shared weights plus a small per-client
    offset, as numpy ``[M, ...]`` leaves (what ``unflatten`` of the cohort
    buffer gives, one row a client)."""
    rs = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: (v[None] + 1e-2 * rs.standard_normal((m,) + v.shape))
        .astype(np.float32), jp)


def _batches(seed, lead, b=2, s=16, vocab=512):
    """Token batches with leading axes ``lead``: leaves ``[*lead, b, s]``."""
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


@pytest.mark.parametrize("over", [{}, {"qk_norm": True, "sliding_window": 8},
                                  {"qkv_bias": False, "act": "gelu",
                                   "norm": "layernorm"}])
def test_batched_loss_matches_each_client_and_jax_vmap(over):
    """``Model.loss_batched`` on M clients' own weights and batches equals
    each client's ``Model.loss`` and the reference's ``jax.vmap(loss)``.
    Per client: the same kernels' plain versions on the same rows (reading
    bitwise on the CPU; the card test allows float32 GEMM reordering).
    Against jax: 8 loss ulps, as the one-client loss test allows (readings
    0, 2 and 3)."""
    jcfg, tcfg = jget_config(SMOKE).replace(**over), \
        get_config(SMOKE).replace(**over)
    params = _cohort(_jax_params(jcfg), seed=1)
    batch = _batches(2, (M,))
    model = api.build(tcfg)
    assert model.loss.batched is model.loss_batched
    got = model.loss_batched(_t(params), _t(batch))
    assert got.shape == (M,)
    each = torch.stack([model.loss(_t(jax.tree.map(lambda v: v[i], params)),
                                   _t({k: v[i] for k, v in batch.items()}))
                        for i in range(M)])
    torch.testing.assert_close(got, each, rtol=2e-7, atol=0)
    jloss = japi.build(jcfg).loss
    want = np.asarray(jax.vmap(jloss)(_j(params), _j(batch)))
    ulp = np.spacing(np.float32(want.max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=8 * ulp)


def test_batched_forward_reads_the_cohort_buffer_in_place():
    """The flat round hands the loss ``unflatten`` of the ``[M, n_pad]``
    buffer: every leaf a strided view into it, a layer the slice
    ``leaf[:, i]``. The batched loss reads those views as they are and
    equals the loss of contiguous copies."""
    params = _t(_cohort(_jax_params(jget_config(SMOKE)), seed=3))
    spec = tflat.flat_spec(_index(params, 0))
    buf = torch.stack([tflat.flatten(_index(params, i), spec)
                       for i in range(M)])
    views = tflat.unflatten(buf, spec)
    leaf = views["blocks"]["mlp"]["w_up"]
    assert leaf.shape[0] == M and not leaf.is_contiguous()
    batch = _t(_batches(4, (M,)))
    model = api.build(get_config(SMOKE))
    assert torch.equal(model.loss_batched(views, batch),
                       model.loss_batched(params, batch))


def _index(tree, i):
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _round_configs(air):
    kw = dict(n_participating=M, local_iters=H, b2=B2, lr=LR, mu=MU,
              estimator="sphere", flat_params=True)
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
def test_flat_lm_round_matches_reference(air):
    """One flat ``round_simulated`` of qwen2-0.5b-smoke over M = 3 clients
    (H = 2, b2 = 4, μ = 1e-2, lr = 1e-3; the plain mean, and AirComp with
    channel scheduling at 5 dB) against the reference's vmapped round, from
    the same weights, batches and keys. The tolerances are those
    ``test_torch_lm.py`` derives for three train steps (a loss ulp moves a
    coefficient by d·ulp/μ ≈ 17, a weight by about 1e-4 per step): weights
    within 6e-4 after the H = 2 iterates each client runs (readings 1.1e-4
    with either aggregation, while the round moves a weight by 8.8e-3), the
    round's mean loss within 5e-4 and its first loss within 8 ulps
    (readings 2.9e-5 and 0); the AirComp statistics within 1e-3 relative
    (Δ_max sums 361,600 squared deltas, each off by the weights'
    differences: readings 6.5e-4 for Δ_max, 3.2e-4 for the noise std)."""
    jcfg, tcfg = _round_configs(air)
    jm, tm = japi.build(jget_config(SMOKE)), api.build(get_config(SMOKE))
    p0 = _jax_params(jget_config(SMOKE))
    batch = _batches(5, (M, H))
    keys = jax.random.split(jax.random.key(6), M)
    kchan = jax.random.key(7)
    jp, jmet = jfedzo.round_simulated(
        jm.loss, _j(p0), _j(batch), keys, jcfg, channel_rng=kchan)
    ops.reset_launches()
    tp, tmet = fedzo.round_simulated(
        tm.loss, _t(p0), _t(batch), prng.as_key(jax.random.key_data(keys)),
        tcfg, channel_rng=prng.as_key(jax.random.key_data(kchan)))
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}   # plain versions
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
                                       rtol=1e-3, err_msg=k)


def test_flat_lm_local_phase_matches_reference():
    """One client's H = 2 flat iterates (``local_phase``) of
    qwen2-0.5b-smoke against the reference, from the same weights, batches
    and key: coefficients within 8 loss ulps of d/μ each (reading 2), the
    first loss within 2 ulps (reading 0), the weights within the round
    test's 6e-4 (reading 1.4e-4)."""
    jcfg, tcfg = _round_configs(False)
    jm, tm = japi.build(jget_config(SMOKE)), api.build(get_config(SMOKE))
    p0 = _jax_params(jget_config(SMOKE))
    batch = {k: v[0] for k, v in _batches(8, (1, H)).items()}
    want = jfedzo.local_phase(jm.loss, _j(p0), _j(batch), jax.random.key(9),
                              jcfg)
    got = fedzo.local_phase(tm.loss, _t(p0), _t(batch), prng.key(9), tcfg)
    d = jflat.flat_spec(p0).d
    ulp = float(np.spacing(np.float32(np.max(np.asarray(want.losses)))))
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs),
                               rtol=0, atol=8 * d * ulp / MU)
    assert abs(float(got.losses[0]) - float(want.losses[0])) <= 2 * ulp
    worst = max(float(np.abs(_get(got.params, n).numpy() - w).max())
                for n, w in _path_names(jax.device_get(want.params)))
    assert worst <= 6e-4


@pytest.mark.parametrize("air", [False, True], ids=["mean", "aircomp"])
def test_flat_lm_round_never_reaches_vmap(monkeypatch, air):
    """The flat LM round runs the cohort through the loss's client-batched
    form: with ``torch.func.vmap`` made to raise, ``round_simulated`` and
    ``local_phase`` still run (before the batched form, both mapped the
    loss with ``vmap``, which cannot run a kernel launch on the card), and
    a loss without a batched form still reaches ``vmap``."""
    def no_vmap(*a, **k):
        raise AssertionError("torch.func.vmap reached")

    monkeypatch.setattr(torch.func, "vmap", no_vmap)
    tm = api.build(get_config(SMOKE))
    params = tm.init(prng.key(0), device="cpu")
    batch = _t(_batches(10, (M, H)))
    _, tcfg = _round_configs(air)
    new, met = fedzo.round_simulated(
        tm.loss, params, batch, prng.split(prng.key(1), M), tcfg,
        channel_rng=prng.key(2))
    assert np.isfinite(float(met["mean_local_loss"]))
    res = fedzo.local_phase(tm.loss, params,
                            {k: v[0] for k, v in batch.items()},
                            prng.key(3), tcfg)
    assert res.losses.shape == (H,)
    with pytest.raises(AssertionError, match="vmap reached"):
        fedzo.local_phase(lambda p, b: tm.loss(p, b), params,
                          {k: v[0] for k, v in batch.items()}, prng.key(3),
                          tcfg)


@pytest.mark.parametrize("groups,shape", [(3, (3, 16, 64)), (4, (4, 5, 896)),
                                          (2, (2, 7, 3, 32))])
def test_rmsnorm_group_scale_matches_vmapped_norm_fwd(groups, shape):
    """RMSNorm with a ``[G, D]`` scale (G equal contiguous groups of rows)
    is the reference's ``norm_fwd`` under ``vmap`` over the G clients: the
    plain version within the one-client test's 1e-6 relative (readings up
    to 3.3e-7), and both it and the kernel-order twin bitwise per group."""
    rs = np.random.default_rng(11)
    x = (rs.standard_normal(shape) * 3).astype(np.float32)
    sc = (1 + 0.1 * rs.standard_normal((groups, shape[-1]))) \
        .astype(np.float32)
    tx, tsc = torch.from_numpy(x), torch.from_numpy(sc)
    got = trn.rmsnorm_plain(tx, tsc)
    want = np.asarray(jax.vmap(lambda s, xx: norm_fwd({"scale": s}, xx))(
        jnp.asarray(sc), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    order = trn.rmsnorm_kernel_order(tx, tsc)
    for g in range(groups):
        assert torch.equal(got[g], trn.rmsnorm_plain(tx[g], tsc[g]))
        assert torch.equal(order[g], trn.rmsnorm_kernel_order(tx[g], tsc[g]))
    # a strided [G, D] view (a layer slice of stacked [G, L, D] scales)
    stacked = torch.from_numpy(np.stack([sc, sc[::-1]], 1).copy())
    assert torch.equal(trn.rmsnorm_plain(tx, stacked[:, 0]), got)


@pytest.mark.parametrize("d", [16, 256])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_attention_plain_head_dims_16_and_256(d, causal, window):
    """The plain attention at the head dims the CUDA kernel now builds: 16
    (the neural transformer track's d_model 32 over 2 heads) and 256
    (Gemma-2B), GQA with G = 2, against the reference's
    ``chunked_attention``: within 2e-6·sqrt(D/64), the 2e-6 that head dims
    32 and 64 use scaled by the rounding of a D-term dot product, which
    grows as sqrt(D) (readings 5.4e-7 at D = 16, 1.8e-6 at D = 256)."""
    rs = np.random.default_rng(12)
    q, k, v = (rs.standard_normal((2, 100, h, d)).astype(np.float32)
               for h in (4, 2, 2))
    got = tfa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    window=window).numpy()
    want = np.asarray(chunked_attention(q, k, v, causal=causal,
                                        window=window))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.sqrt(d / 64))


@pytest.mark.parametrize("m,n,d,per,grid", [
    (10, 65_536, 7_850, 1, 64),      # the softmax round: one tile a block
    (10, 65_536 + 77, 7_850, 1, 9),  # ragged, several tiles a block
    (4, 3 * 4096, 3 * 4096, 4, 2),   # wide tiles, the whole row valid
    (3, 1000, 999, 1, 1),            # one partial a row
    (2000, 1024, 512, 1, 1),         # more rows than the previous design's
                                     # shared-memory limit of 1,536
])
def test_aircomp_sq_order_matches_plain(m, n, d, per, grid):
    """The AirComp norms in the CUDA kernel's summation order (the twin the
    card holds the kernel to bit for bit) against the plain version (the
    reference oracle's blocked order) within 1e-5 relative, the tolerance
    the card check allows the kernel (readings up to 2.4e-7), and against
    a float64 sum (readings up to 1.4e-7)."""
    x = torch.from_numpy(np.random.default_rng(13).standard_normal((m, n))
                         .astype(np.float32) * 1e-3)
    got = zac.aircomp_sq_order_sum(x, d, per=per, grid=grid)
    _, want = zac.aircomp_reduce_plain(x, torch.ones(m), d)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    exact = (x[:, :d].double() ** 2).sum(1)
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=0)
