"""The port's first-order step on the production mesh: the backward of the
expert-parallel ``moe_fwd`` (``models/moe.py``), FedAvg through the kernel
wrappers on ``meta`` shards (``kernels/ops.py``), the vocab-parallel token
cross-entropy (``models/layers._token_xent``) and ``launch/dryrun.run_case``
with ``algo="fedavg"``.

4 gloo ranks on the CPU as a (2, 2) ``("data", "model")`` mesh (one spawn
for the module):

- the gradient of ``sum(out · w) + aux`` of the MoE layer with respect to
  x and every leaf, for qwen3-moe-30b-a3b-smoke and deepseek-v3-671b-smoke
  (its shared expert), in the train layout (x [4, 16, d]: tokens over data,
  the expert FFN dim gathered over data) and the decode layout (x [3, 1,
  d]: replicated), at capacity factor E/k (nothing dropped on any shard).
  Against one device's autograd, and against ``jax.grad`` of the
  reference's ``shard_map`` ``moe_fwd`` on 4 host devices (a subprocess),
  each gradient within ``GRAD_REL`` of its largest magnitude: float32
  sums split over ranks and the expert GEMMs at the shard's capacity, in
  other orders (the value of ``f`` within rtol 1e-5 of the reference's:
  the two packages' forwards differ in float32 rounding). The reference
  runs with its ``shard_map`` unchecked (``check_vma=False``, or
  ``check_rep=False`` before ``jax.shard_map``): under jax 0.9.0's checked
  ``shard_map`` its gradients of x and the router miss the sum over
  ``model`` of an input replicated there (0.61 and 0.48 of its own
  one-device gradient's projection in the train layout), while unchecked
  they are its one-device gradient within 2e-6. One more case with w = 0
  holds the load-balance term's gradient alone (its stats are computed
  alike on both model ranks, so a backward that counted them per rank
  would double it);
- one FedAvg step (lr 1e-3) of both MoE smoke models and of
  rwkv6-7b-smoke (the WKV scan's per-head bonus ``u``, read whole by each
  rank's block of heads) against the unsharded step: the loss within rtol
  1e-6, every leaf's update within ``STEP_TOL`` plus 1e-5 of its largest
  (rwkv6's ``u`` moves by 0.36: its gradient is 360), some leaf moved by
  ten times ``STEP_TOL``;
- the token cross-entropy of vocab-sharded logits bitwise the masked sum
  it replaced.

In this process: ``ops.rmsnorm`` and ``ops.attention`` on ``meta`` inputs
that require a gradient (gradients of the inputs' shapes, the backward's
ops counted as the plain recompute's), and the dry-run's FedAvg case of
every ``-smoke`` architecture on a fake (4, 2) mesh at batch 8 x seq 16.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import FedZOConfig, ShapeConfig
from repro_torch.core import fedavg
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as shr
from repro_torch.models import api
from repro_torch.models import moe as tmoe
from repro_torch.utils import prng
from repro_torch.utils.flatparams import _leaves
from repro_torch.utils.tree import tree_leaves, tree_unflatten
from tests import _torch_ranks
from tests.conftest import run_subprocess

MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v3-671b")
STEP_ARCHS = MOE_ARCHS + ("rwkv6-7b",)
LAYOUTS = {"train": (4, 16), "decode": (3, 1)}
CASES = [(a, lay) for a in MOE_ARCHS for lay in LAYOUTS]
# a gradient against its one-device or reference counterpart, relative to
# its largest magnitude (measured: at most 3e-7 against one device)
GRAD_REL = 1e-5
STEP_TOL = 1e-6
STEP_KW = dict(lr=1e-3)

_REF = """
import sys, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import _make_mesh
from repro.models.moe import init_moe, moe_fwd
import repro.models.moe as M
mesh = _make_mesh((2, 2), ("data", "model"))
res = {}
# the shard_map's unchecked transpose (a psum over the axes an input is
# replicated on): jax's checked shard_map of this body gives x and router
# gradients without their sum over ``model`` (see the module docstring)
if hasattr(jax, "shard_map"):
    def _sm(f, *, mesh, in_specs, out_specs, axis_names=None):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, axis_names=axis_names,
                             check_vma=False)
else:
    from jax.experimental.shard_map import shard_map as _legacy

    def _sm(f, *, mesh, in_specs, out_specs, axis_names=None):
        return _legacy(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                       check_rep=False)
M._shard_map = _sm


def flat(tree, pre):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, pre + k + "/")
        else:
            yield pre + k, v


for arch, lay, (B, S) in CASES:
    cfg = get_config(arch).reduced()
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    p = init_moe(jax.random.key(0), cfg, jnp.float32)
    x = 0.5 * jax.random.normal(jax.random.key(1), (B, S, cfg.d_model))
    w = jax.random.normal(jax.random.key(2), (B, S, cfg.d_model))

    def f(p, x):
        o, aux = moe_fwd(p, cfg, x, mesh=mesh)
        return jnp.sum(o * w) + aux
    val, (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(p, x)
    tag = f"{arch}_{lay}"
    for k, v in flat(p, ""):
        res[f"{tag}/p/{k}"] = np.asarray(v)
    for k, v in flat(gp, ""):
        res[f"{tag}/gp/{k}"] = np.asarray(v)
    res[f"{tag}/x"] = np.asarray(x)
    res[f"{tag}/w"] = np.asarray(w)
    res[f"{tag}/gx"] = np.asarray(gx)
    res[f"{tag}/f"] = np.asarray(val)
np.savez(OUT, **res)
"""


def _nested(flat):
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _moe_cfg(arch):
    cfg = get_config(f"{arch}-smoke")
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


def _step_cfg(arch):
    return _moe_cfg(arch) if arch in MOE_ARCHS else get_config(f"{arch}-smoke")


def _step_batch(cfg, seed=1, B=4, S=8):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab, (B, S), generator=g,
                             dtype=torch.int32) for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_fedavg")
    ref_path = str(d / "ref.npz")
    run_subprocess(f"CASES = {[(a, lay, LAYOUTS[lay]) for a, lay in CASES]!r}"
                   f"\nOUT = {ref_path!r}\n" + _REF, n_devices=4)
    ref = dict(np.load(ref_path))
    grad_cases = []
    for arch, lay in CASES:
        tag = f"{arch}_{lay}"
        p = _nested({k[len(tag) + 3:]: torch.from_numpy(v)
                     for k, v in ref.items() if k.startswith(f"{tag}/p/")})
        grad_cases.append((_moe_cfg(arch), p,
                           torch.from_numpy(ref[f"{tag}/x"]),
                           torch.from_numpy(ref[f"{tag}/w"])))
    cfg, p, x, w = grad_cases[0]
    grad_cases.append((cfg, p, x, torch.zeros_like(w)))   # aux alone
    step_cases = []
    for arch in STEP_ARCHS:
        cfg = _step_cfg(arch)
        step_cases.append((f"{arch}-smoke", _step_batch(cfg), STEP_KW,
                           prng.key(7), "fedavg", 2,
                           {"capacity_factor": cfg.capacity_factor}))
    g = torch.Generator().manual_seed(3)
    xent = (torch.randn(4, 8, 64, generator=g),
            torch.randint(0, 64, (4, 8), generator=g, dtype=torch.int32))
    out = str(d / "runs.pt")
    tmesh.run_ranks(_torch_ranks.sharded_fedavg_run, 4, backend="gloo",
                    init_dir=str(d), args=(out, grad_cases, step_cases, xent))
    grads, steps, xent_res = torch.load(out, weights_only=False)
    return ref, grad_cases, grads, dict(zip(STEP_ARCHS, steps)), xent_res


def _one_device_grads(cfg, p, x, w):
    pairs = _leaves(p)
    leaves = [v.detach().requires_grad_() for _, v in pairs]
    xin = x.detach().requires_grad_()
    o, aux = tmoe.moe_fwd(tree_unflatten([k for k, _ in pairs], leaves), cfg,
                          xin)
    g = torch.autograd.grad(torch.sum(o * w) + aux, [xin] + leaves)
    return g[0], {"/".join(k): t for (k, _), t in zip(pairs, g[1:])}


def _close(got, want, what):
    top = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert top > 0, what
    assert err <= GRAD_REL * top, (what, err, top)


@pytest.mark.parametrize("case", CASES + [("aux-only", "train")],
                         ids=[f"{a}-{lay}" for a, lay in CASES]
                         + ["aux-only-train"])
def test_moe_backward_matches_one_device(ranks, case):
    torch.set_num_threads(1)
    _, cases, grads, _, _ = ranks
    i = len(CASES) if case[0] == "aux-only" else CASES.index(case)
    gx, gp = _one_device_grads(*cases[i])
    got = grads[i]
    _close(got["x"], gx, "x")
    assert set(got["p"]) == set(gp)
    for k, t in gp.items():
        if case[0] == "aux-only" and k != "router":
            # the load-balance term reads only the router's probabilities
            assert not t.any() and not got["p"][k].any(), k
        else:
            _close(got["p"][k], t, k)


@pytest.mark.parametrize("case", CASES, ids=[f"{a}-{lay}" for a, lay in CASES])
def test_moe_backward_matches_reference_sharded(ranks, case):
    ref, _, grads, _, _ = ranks
    tag = f"{case[0]}_{case[1]}"
    got = grads[CASES.index(case)]
    np.testing.assert_allclose(float(got["f"]), float(ref[f"{tag}/f"]),
                               rtol=1e-5)
    _close(got["x"].numpy(), ref[f"{tag}/gx"], "x")
    want = {k[len(tag) + 4:]: v for k, v in ref.items()
            if k.startswith(f"{tag}/gp/")}
    assert set(got["p"]) == set(want)
    for k, v in want.items():
        _close(got["p"][k].numpy(), v, k)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_fedavg_step_matches_unsharded(ranks, arch):
    torch.set_num_threads(1)
    got = ranks[3][arch]
    cfg = _step_cfg(arch)
    model = api.build(cfg)
    p = model.init(prng.key(0), device="cpu")
    new, mets = fedavg.make_train_step(lambda q, b: model.loss(q, b),
                                       FedZOConfig(**STEP_KW))(
        p, _step_batch(cfg), prng.key(7))
    np.testing.assert_allclose(float(got["metrics"]["loss"]),
                               float(mets["loss"]), rtol=1e-6)
    moved = 0.0
    for a, b, b0 in zip(tree_leaves(got["params"]), tree_leaves(new),
                        tree_leaves(p)):
        step = float((b - b0).abs().max())
        np.testing.assert_allclose((a - b0).numpy(), (b - b0).numpy(),
                                   atol=STEP_TOL + 1e-5 * step)
        moved = max(moved, step)
    assert moved >= 10 * STEP_TOL      # the limit is not vacuous


def test_vocab_parallel_xent_is_the_masked_sum(ranks):
    got = ranks[4]
    assert torch.equal(got["new"], got["old"])
    assert got["placements"].startswith("(Shard(dim=0)")


def test_label_mask_is_the_ranks_vocab_slice():
    """On a fake (4, 2) mesh, logits [8, 16, 4096] over (data, model): the
    label mask, and every other tensor the loss and its gradient make, is
    the rank's [2, 16, 2048] block (a whole-vocab iota made a [2, 16, 4096]
    mask, and the gradient a [8, 16, 4096] cast)."""
    from repro_torch.models.layers import softmax_xent
    from repro_torch.utils.shardutil import on_dtensors, on_mesh
    dryrun._fake_world(8)
    try:
        mesh = tmesh.make_host_mesh(2, device="cpu")
        B, S, V = 8, 16, 4096
        ins = dryrun._on_meta(
            {"l": torch.empty(B, S, V, device="meta", dtype=torch.bfloat16),
             "y": torch.empty(B, S, dtype=torch.int32, device="meta")},
            {"l": shr.NamedSharding(mesh, shr.P("data", None, "model")),
             "y": shr.NamedSharding(mesh, shr.P("data", None))})
        lg = ins["l"].detach().requires_grad_()
        seen = []
        with on_mesh(mesh), _Spy(seen):
            loss = softmax_xent(lg, ins["y"])
            with on_dtensors([lg]):
                g, = torch.autograd.grad(loss, [lg])
        assert tuple(g.placements) == tuple(lg.placements)
        assert ("aten::eq", (2, 16, 2048)) in seen
        assert max(int(np.prod(s)) for _, s in seen) == 2 * 16 * 2048, seen
    finally:
        torch.distributed.destroy_process_group()


class _Spy(dryrun.StepCounter):
    """A ``StepCounter`` that lists (op, shape) of every tensor it counts
    as newly allocated."""

    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def _op(self, func, args, kwargs, out, flop_registry):
        before = set(self._alive)
        super()._op(func, args, kwargs, out, flop_registry)
        for t in dryrun._tensors(out):
            if id(t.untyped_storage()) in set(self._alive) - before:
                self.seen.append((func._schema.name, tuple(t.shape)))


def _meta(*shape):
    return torch.empty(*shape, device="meta", requires_grad=True)


@pytest.mark.parametrize("kind", ["rmsnorm", "attention"])
def test_meta_wrappers_under_autograd(kind):
    """On ``meta`` inputs that require a gradient: the forward reports the
    kernel once, the backward gives every input's gradient at its shape,
    and the backward's counted work is the plain recompute and its
    gradient (the FLOPs and bytes of running them)."""
    if kind == "rmsnorm":
        ins = (_meta(2, 16, 64), _meta(64))

        def fwd(*t):
            return ops.rmsnorm(*t)

        def plain(*t):
            return rmsnorm_plain(*t)
    else:
        ins = (_meta(2, 16, 4, 32), _meta(2, 16, 2, 32), _meta(2, 16, 2, 16))

        def fwd(*t):
            return ops.attention(*t, causal=True)

        def plain(*t):
            return flash_attention_plain(*t, causal=True)
    with dryrun.StepCounter() as c:
        out = fwd(*ins)
        f0, b0 = c.flops, c.hbm_bytes
        assert c.kernels == {"flash_attention" if kind == "attention"
                             else kind: 1}
        grads = torch.autograd.grad(out, ins, torch.empty_like(out))
        bwd = (c.flops - f0, c.hbm_bytes - b0)
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in ins]
    assert all(g.device.type == "meta" for g in grads)
    ref_ins = [t.detach().requires_grad_() for t in ins]
    with dryrun.StepCounter() as c:
        o = plain(*ref_ins)
        torch.autograd.grad(o, ref_ins, torch.empty_like(o))
        want = (c.flops, c.hbm_bytes)
    # the same FLOPs; the same bytes, but for at most one copy of the
    # output's gradient (read and written) that autograd makes contiguous
    assert bwd[0] == want[0] and want[1] > 0, (bwd, want)
    g_bytes = out.numel() * out.element_size()
    assert want[1] <= bwd[1] <= want[1] + 2 * g_bytes, (bwd, want)
    # without a gradient the wrapper allocates only the output, as before
    with dryrun.StepCounter() as c:
        fwd(*[t.detach() for t in ins])
    assert c.peak == out.numel() * out.element_size()


SMOKE_SHAPE = ShapeConfig("train_4k", 16, 8, "train")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_fedavg_on_a_small_fake_mesh(monkeypatch, arch):
    """``run_case(..., algo="fedavg")`` of the ``-smoke`` config on a fake
    (4, 2) mesh at batch 8 x seq 16: it runs, the updated parameters are
    laid out as the parameters (output bytes = their bytes and the loss's
    4), the kernels run where the model has them, and no tensor the step
    counts has the whole batch's logits' shape (a logit gradient gathered
    whole, or the propagator's fake tensors of that shape counted)."""
    def small(mp):
        dryrun._fake_world(8)
        return tmesh._make_mesh((4, 2), ("data", "model"), device="cpu")
    monkeypatch.setattr(dryrun, "_mesh", small)
    monkeypatch.setattr(dryrun, "get_shape", lambda name: SMOKE_SHAPE)
    seen = []
    monkeypatch.setattr(dryrun, "StepCounter", lambda: _Spy(seen))
    cfg = get_config(f"{arch}-smoke")
    rec = dryrun.run_case(f"{arch}-smoke", "train_4k", multi_pod=False,
                          algo="fedavg")
    assert not torch.distributed.is_initialized()
    assert rec["algo"] == "fedavg" and rec["mesh"] == "4x2"
    dryrun._fake_world(8)
    try:
        mesh = tmesh._make_mesh((4, 2), ("data", "model"), device="cpu")
        pspecs = api.build(cfg).param_specs()
        pbytes = sum(t.numel() * t.element_size() for t in
                     dryrun._local_leaves(dryrun._on_meta(
                         pspecs, shr.param_shardings(pspecs, mesh))))
    finally:
        torch.distributed.destroy_process_group()
    assert rec["memory"]["output_size_in_bytes"] == pbytes + 4
    assert rec["hlo_flops_per_device"] > 0
    calls = rec["kernel_calls"]
    if cfg.norm == "rmsnorm":
        assert calls.get("rmsnorm", 0) > 0, calls
    whole = (SMOKE_SHAPE.global_batch, SMOKE_SHAPE.seq_len, cfg.vocab)
    assert whole not in [s for _, s in seen], [t for t in seen
                                               if t[1] == whole]
