"""The neural workload's transformer track in the port against a live JAX
run on the CPU: the classifier head's init and forward, its client-batched
loss, and ``neural.run`` on the pytree, flat and flat-AirComp routes.

Sizes are the reference's test size (``tests/test_neural.py``: 24 features
in 4 patch tokens, d_model 16 over 2 heads of 8, d_ff 32, 1 layer, 4
classes, 6 clients). Weights are carried across with
``utils/convert.to_torch``; inputs come from numpy seeds. On the CPU the
port's RMSNorm and attention run their plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import sim as jsim
from repro.models import transformer as jtr
from repro.workloads import neural as jneural
from repro_torch.models import transformer as ttr
from repro_torch.utils import convert
from repro_torch.utils.tree import tree_map
from repro_torch.workloads import neural as tneural

TASK_KW = dict(n_train=180, n_test=48, n_clients=6, n_features=24,
               n_classes=4, n_patches=4, d_model=16, d_ff=32, n_heads=2)
ROUND_KW = dict(n_participating=3, local_iters=2, b1=6, b2=3, lr=2e-2,
                mu=1e-3, seed=7, weight_by_size=False)
# the ZO trajectory tolerance of the port's other card-vs-CPU and
# port-vs-JAX references
ATOL = 1e-3
# AirComp's delta_max is max_i ‖Δ_i‖ over d = 2,320 weights (about 6 in the
# second round) and the Eq.-17 noise std scales with it: a norm of weights
# that each drift by up to ATOL moves by a like relative amount (reading:
# 2.3e-3 relative)
NORMS, NORM_RTOL = ("delta_max", "aircomp_noise_std"), 5e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the port's CPU path is many small ops, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tasks():
    return (jneural.make_task("transformer", **TASK_KW),
            tneural.make_task("transformer", device="cpu", **TASK_KW))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jcfg():
    """The track's ModelConfig, as the reference's task builds it."""
    from repro.configs.base import ModelConfig
    return ModelConfig(name="tiny-patch-cls", family="dense", source="",
                       n_layers=1, d_model=16, d_ff=32, vocab=0, n_heads=2,
                       n_kv_heads=2, head_dim=8, act="gelu",
                       dtype="float32")


def _tcfg():
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name="tiny-patch-cls", family="dense", source="",
                       n_layers=1, d_model=16, d_ff=32, vocab=0, n_heads=2,
                       n_kv_heads=2, head_dim=8, act="gelu",
                       dtype="float32")


def test_init_classifier_matches_reference():
    """Same seed, same key chain (``split(rng, 3)``; the blocks from
    ``fold_in``): the same leaves in jax's order, equal shapes, and values
    within 4 float32 ulps (the normal draws' erfinv; 1 ulp measured)."""
    jt, tt = _tasks()
    want = _flat(jax.device_get(jneural.params_init(jt, 7)))
    got = _flat(convert.to_numpy(tneural.params_init(tt, 7)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]) / np.spacing(
            np.maximum(np.abs(want[k]), np.float32(1e-30)))
        assert err.max() <= 4, (k, err.max())


def _shared(seed=3, b=10):
    jt, tt = _tasks()
    jp = jax.device_get(jneural.params_init(jt, seed))
    rs = np.random.default_rng(seed)
    x = rs.uniform(-1, 1, (b, 24)).astype(np.float32)
    y = rs.integers(0, 4, (b,)).astype(np.int32)
    return jp, x, y


def test_classifier_forward_loss_and_accuracy_match_reference():
    """The same weights through both heads: logits and loss within a
    relative 1e-5 (torch and XLA sum the products in other orders),
    accuracy equal."""
    jp, x, y = _shared()
    jc, tc = _jcfg(), _tcfg()
    tp = convert.to_torch(jp)
    jl = np.asarray(jtr.classifier_logits(jp, jc, jnp.asarray(x)))
    tl = ttr.classifier_logits(tp, tc, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5 * np.abs(jl).max())
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    np.testing.assert_allclose(float(ttr.classifier_loss(tp, tb, tc)),
                               float(jtr.classifier_loss(jp, jb, jc)),
                               rtol=1e-5)
    assert float(ttr.classifier_accuracy(tp, tb, tc)) == \
        float(jtr.classifier_accuracy(jp, jb, jc))
    # the [B, n_patches, patch_dim] input form
    tl3 = ttr.classifier_logits(tp, tc, torch.from_numpy(x).reshape(10, 4, 6))
    assert torch.equal(tl3, torch.from_numpy(tl))


@pytest.mark.parametrize("reps", [1, 3])
def test_batched_loss_matches_each_client_and_jax_vmap(reps):
    """M = 4 clients' weights ``[M·r, ...]`` (r = 1: the flat round's
    cohort; r = 3: the wide route's copies sharing their client's batch)
    against each row's own loss (4 float32 ulps: other GEMM shapes) and the
    reference's ``jax.vmap`` of its loss over the rows (relative 1e-5)."""
    jp, _, _ = _shared(5)
    m, rs = 4, np.random.default_rng(11)
    params = {k: np.stack([v + 1e-2 * rs.normal(size=v.shape).astype(
        np.float32) for _ in range(m * reps)]) for k, v in _flat(jp).items()}
    x = rs.uniform(-1, 1, (m, 6, 24)).astype(np.float32)
    y = rs.integers(0, 4, (m, 6)).astype(np.int32)

    def nest(flat):
        out = {}
        for k, v in flat.items():
            node = out
            *path, leaf = k.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        return out

    tc, jc = _tcfg(), _jcfg()
    tp = convert.to_torch(nest(params))
    got = ttr.classifier_loss_batched(
        tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, tc).numpy()
    assert got.shape == (m * reps,)
    each = np.array([float(ttr.classifier_loss(
        tree_map(lambda t: t[i], tp),
        {"x": torch.from_numpy(x[i // reps]),
         "y": torch.from_numpy(y[i // reps])}, tc))
        for i in range(m * reps)], np.float32)
    np.testing.assert_array_less(np.abs(got - each),
                                 4 * np.spacing(each) + 1e-30)
    xr, yr = np.repeat(x, reps, 0), np.repeat(y, reps, 0)
    want = np.asarray(jax.vmap(lambda p, b: jtr.classifier_loss(p, b, jc))(
        jax.tree.map(jnp.asarray, nest(params)),
        {"x": jnp.asarray(xr), "y": jnp.asarray(yr)}))
    np.testing.assert_allclose(got, want, rtol=1e-5)


_RUNS = {
    "pytree": dict(),
    "flat": dict(flat_params=True, flat_block_rows=4),
    "flat_aircomp": dict(flat_params=True, flat_block_rows=4, aircomp=True,
                         channel_schedule=True, snr_db=5.0),
}


@pytest.mark.parametrize("route", sorted(_RUNS))
def test_neural_run_matches_reference(route):
    """Two rounds of ``neural.run`` from the same weights on each route,
    with the in-run evaluation: metrics, evals and final weights within
    1e-3 (a loss ulp moves a coefficient by d·ulp/μ and the weights by
    lr/b2 of it per iterate; the readings are 2e-4 to 5e-4)."""
    jt, tt = _tasks()
    kw = dict(ROUND_KW, **_RUNS[route])
    jcfg, tcfg = jneural.default_config(jt, **kw), \
        tneural.default_config(tt, **kw)
    p0 = jneural.params_init(jt, jcfg.seed)
    jres = jsim.run_experiment(jt.loss, p0, jt.store, jcfg, 2,
                               eval_fn=jneural.task_eval(jt, 48),
                               eval_every=1, donate=False)
    tres = tneural.run(tt, tcfg, 2, eval_every=1, eval_rows=48,
                       params=convert.to_torch(jax.device_get(p0)))
    jm, je = jax.device_get(jres.metrics), jax.device_get(jres.evals)
    assert sorted(jm) == sorted(tres.metrics)
    for k in jm:
        np.testing.assert_allclose(tres.metrics[k].numpy(), np.asarray(jm[k]),
                                   rtol=NORM_RTOL if k in NORMS else 1e-4,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(tres.evals["test_loss"].numpy(),
                               np.asarray(je["test_loss"]), rtol=1e-4,
                               atol=ATOL)
    jp, tp = _flat(jax.device_get(jres.params)), \
        _flat(convert.to_numpy(tres.params))
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-4, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("air", [False, True])
def test_flat_round_never_reaches_vmap(monkeypatch, air):
    """The track's loss carries its client-batched form: with
    ``torch.func.vmap`` made to raise, a flat round (and a wide one) still
    runs, so on the card every forward can launch the kernels."""
    _, tt = _tasks()

    def no_vmap(*a, **k):
        raise AssertionError("torch.func.vmap reached")

    monkeypatch.setattr(torch.func, "vmap", no_vmap)
    air_kw = dict(aircomp=True, channel_schedule=True) if air else {}
    for route in (dict(flat_params=True, flat_block_rows=4),
                  dict(batch_directions=True)):
        cfg = tneural.default_config(tt, **ROUND_KW, **route, **air_kw)
        res = tneural.run(tt, cfg, 1, eval_every=0)
        assert np.isfinite(res.metrics["mean_local_loss"].numpy()).all()


def test_transformer_task_validates_its_patching():
    with pytest.raises(ValueError, match="patch tokens"):
        tneural.make_task("transformer", device="cpu",
                          **dict(TASK_KW, n_patches=5))
    with pytest.raises(ValueError, match="unknown model kwargs"):
        tneural.make_task("transformer", device="cpu",
                          **dict(TASK_KW, width=3))
    with pytest.raises(ValueError, match="unknown neural task"):
        tneural.make_task("vit", device="cpu")
