"""The port's production path against the reference's (``launch/mesh.py``,
``launch/sharding.py``, ``utils/shardutil.py``, the models'
``param_specs``, ``utils/hw.roofline_seconds``, ``launch/dryrun.py``).

- Sharding specs: the reference's rules read only ``mesh.shape`` (its
  ``tests/test_substrate.py`` calls ``leaf_spec`` on a stand-in mesh), so
  every leaf of all ten architectures' full-width ``param_specs`` is held
  entry for entry against the reference's ``leaf_spec`` on the (16, 16)
  and (2, 16, 16) shapes, and ``batch_shardings``/``cache_shardings``
  against the reference's with its ``NamedSharding`` standing for its spec.
- ``param_specs`` and ``count_params``: equal to the reference's.
- The fake 8-rank group: the collective counter's exact bytes on a known
  redistribution, shard-local direction draws bitwise the global draw's
  slices, the Mamba and WKV scans on each rank's rows and block, and
  ``run_case`` on a (4, 2) and a (2, 2, 2) mesh; on the (16, 16) group,
  three full-size cases that fit only where shards stay local.
- 4 gloo ranks on the CPU as a (2, 2) mesh: the smoke LMs' loss, prefill
  and 3 decode steps against one rank (the loss within rtol 1e-6, logits
  within atol 1e-5: float32 sums split over ranks), one FedZO train step
  at μ 16 (loss bitwise; coefficients within d·4 ulp(loss)/μ, the loss-ulp
  amplification; parameters within atol 1e-6) and one FedAvg step
  (parameters within atol 1e-6) against the unsharded step.
"""
import math
import os

import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs import get_config as jget_config, get_shape as jget_shape
from repro.configs import ARCH_IDS, SHAPE_IDS
from repro.launch import sharding as jshr
from repro.models import api as japi
from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedavg, fedzo
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as shr
from repro_torch.models import api
from repro_torch.utils import hw, prng
from repro_torch.utils.tree import tree_leaves
from tests import _torch_ranks

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _standin(shape):
    """A mesh of the given axis sizes with no process group: all the rules
    read."""
    return tmesh.Mesh(tuple(shape), dict(shape), 0, None,
                      torch.device("cpu"))


class _JMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _jspec(spec):
    """A spec's entries, a tuple of one axis name as that name (jax
    releases differ in which of the two a ``PartitionSpec`` keeps)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS for 512
    host devices (its first statement); this process's jax has started
    already, and the variable is put back for the processes it starts."""
    old = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jd
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return jd


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    import jax
    ps = api.build(get_config(arch)).param_specs()
    rs = japi.build(jget_config(arch)).param_specs()
    want = [(jax.tree_util.keystr(kp), tuple(l.shape), str(l.dtype))
            for kp, l in jax.tree_util.tree_flatten_with_path(rs)[0]]
    got = [(shr.keystr(p), tuple(l.shape), str(l.dtype).split(".")[-1])
           for p, l in shr._leaves_any(ps)]
    assert got == want
    assert all(l.device.type == "meta" for _, l in shr._leaves_any(ps))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_equal_the_reference(arch, mesh_name):
    """Every leaf's spec, entry for entry (the reference's FSDP threshold is
    0, so its ``param_shardings`` calls ``leaf_spec`` with data allowed)."""
    assert jshr.FSDP_BYTES_THRESHOLD == 0 == shr.FSDP_BYTES_THRESHOLD
    assert jshr.MIN_SHARD_ELEMS == shr.MIN_SHARD_ELEMS
    shape = MESHES[mesh_name]
    ps = api.build(get_config(arch)).param_specs()
    got = shr.param_shardings(ps, _standin(shape))
    flat = dict(shr._leaves_any(got))
    for p, leaf in shr._leaves_any(ps):
        path = shr.keystr(p)
        want = jshr.leaf_spec(path, tuple(leaf.shape), _JMesh(shape))
        assert _jspec(flat[p].spec) == _jspec(want), path
        assert _jspec(shr.leaf_spec(path, tuple(leaf.shape),
                                    _standin(shape))) == _jspec(want)
    rows = shr.explain(ps, _standin(shape))
    assert [r[0] for r in rows] == [shr.keystr(p) for p, _ in
                                    shr._leaves_any(ps)]


@pytest.mark.parametrize("shape_id", SHAPE_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_shardings_equal_the_reference(arch, shape_id,
                                                       monkeypatch):
    """On both production shapes; the cache of a decode shape at its
    ``decode_width``, of a train or prefill shape at the prefill width."""
    import jax
    monkeypatch.setattr(jshr, "NamedSharding", lambda mesh, spec: spec)
    cfg, jcfg = get_config(arch), jget_config(arch)
    model, jmodel = api.build(cfg), japi.build(jcfg)
    shape, jshape = get_shape(shape_id), jget_shape(shape_id)
    width = api.decode_width(cfg, shape) if shape.kind == "decode" \
        else min(shape.seq_len, 32_768)
    bs = {k: torch.empty(s, dtype=d, device="meta")
          for k, (s, d) in model.batch_shapes(shape).items()}
    jbs = {k: jax.ShapeDtypeStruct(s, d)
           for k, (s, d) in jmodel.batch_shapes(jshape).items()}
    cs = model.init_cache(shape.global_batch, width, device="meta")
    jcs = jax.eval_shape(lambda: jmodel.init_cache(jshape.global_batch,
                                                   width))
    for mshape in MESHES.values():
        got = shr.batch_shardings(bs, _standin(mshape))
        want = jshr.batch_shardings(jbs, _JMesh(mshape))
        assert {k: _jspec(v.spec) for k, v in got.items()} == \
            {k: _jspec(v) for k, v in want.items()}
        got = dict(shr._leaves_any(shr.cache_shardings(
            cs, _standin(mshape), cfg)))
        wflat = jax.tree_util.tree_flatten_with_path(
            jshr.cache_shardings(jcs, _JMesh(mshape), jcfg),
            is_leaf=lambda x: isinstance(x, tuple))[0]
        assert {shr.keystr(p): _jspec(v.spec) for p, v in got.items()} == \
            {jax.tree_util.keystr(kp): _jspec(v) for kp, v in wflat}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b",
                                  "deepseek-v3-671b",
                                  "seamless-m4t-large-v2"])
def test_reference_prefill_cache_is_its_init_cache(arch):
    """The dry-run lays a prefill's cache out by ``cache_shardings`` of
    ``init_cache`` at the prefill width: the reference's prefill returns a
    cache of that very tree (paths, shapes, dtypes)."""
    import jax
    jcfg = jget_config(arch)
    jmodel = japi.build(jcfg)
    jshape = jget_shape("prefill_32k")
    ps = jmodel.param_specs()
    bs = {k: jax.ShapeDtypeStruct(s, d)
          for k, (s, d) in jmodel.batch_shapes(jshape).items()}
    out = jax.eval_shape(lambda p, b: jmodel.prefill(p, b, 32_768), ps, bs)
    init = jax.eval_shape(lambda: jmodel.init_cache(jshape.global_batch,
                                                    32_768))

    def flat(t):
        return [(jax.tree_util.keystr(kp), l.shape, l.dtype)
                for kp, l in jax.tree_util.tree_flatten_with_path(t)[0]]
    assert flat(out[1]) == flat(init)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_equal_the_reference(arch, jdryrun):
    cfg = get_config(arch)
    got = dryrun.count_params(api.build(cfg).param_specs(), cfg)
    jcfg = jget_config(arch)
    want = jdryrun.count_params(japi.build(jcfg).param_specs(), jcfg)
    assert got == want


def test_roofline_seconds_by_formula():
    r = hw.roofline_seconds(hw.BF16_FLOP_PER_S, hw.HBM_BYTES_PER_S,
                            hw.NVLINK_BYTES_PER_S_PER_LINK, chips=1)
    assert r == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}
    r = hw.roofline_seconds(2e15, 6.7e12, 900e9, chips=4,
                            links=hw.NVLINK_LINKS)
    assert math.isclose(r["compute_s"], 2e15 / (4 * 989e12))
    assert math.isclose(r["memory_s"], 0.5)
    assert math.isclose(r["collective_s"], 900e9 / (4 * 25e9 * 18))
    assert hw.HBM_CAPACITY_BYTES == 80 * 2**30


def test_meshes_need_their_world(monkeypatch):
    """Without a process group the host mesh is one member; a production
    mesh or a model axis that the world cannot hold raises."""
    m = tmesh.make_host_mesh(device="cpu")
    assert m.axis_names == ("data", "model") and m.shape == {"data": 1,
                                                             "model": 1}
    assert m.group is None and m.device_mesh is None
    assert m.axis_rank("model") == 0 and m.axis_group("model") is None
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_host_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_production_mesh(device="cpu")
    dryrun._fake_world(8)
    try:
        with pytest.raises(ValueError, match="world of 8"):
            tmesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="does not divide"):
            tmesh.make_host_mesh(3, device="cpu")
        m = tmesh.make_host_mesh(2, device="cpu")
        assert m.shape == {"data": 4, "model": 2}
        assert m.device_mesh.mesh.tolist() == [[0, 1], [2, 3], [4, 5],
                                               [6, 7]]
        assert tmesh.data_axes(m) == ("data",)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture
def fake8():
    dryrun._fake_world(8)
    yield tmesh.make_host_mesh(2, device="cpu")
    torch.distributed.destroy_process_group()


def test_collective_counter_exact_bytes(fake8):
    """A [64, 6] float32 leaf sharded over ``data`` gathered whole: one
    all-gather whose result is the whole 1,536 bytes; a partial sum made
    whole: one all-reduce of its 256 bytes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = fake8
    spec = torch.empty(64, 6, device="meta")
    x = dryrun._on_meta({"x": spec}, {"x": shr.NamedSharding(
        mesh, shr.P("data", None))})["x"]
    with dryrun.StepCounter() as c:
        x.redistribute(mesh.device_mesh, [Replicate(), Replicate()])
    assert c.coll_counts["all-gather"] == 1
    assert c.coll_bytes["all-gather"] == 64 * 6 * 4
    assert sum(c.coll_counts.values()) == 1
    from torch.distributed.tensor import DTensor
    y = DTensor.from_local(torch.empty(8, 8, device="meta"), mesh.device_mesh,
                           [Replicate(), Partial()], run_check=False)
    with dryrun.StepCounter() as c:
        y.redistribute(mesh.device_mesh, [Replicate(), Replicate()])
    assert c.coll_counts == {**{k: 0 for k in dryrun.COLLECTIVES},
                             "all-reduce": 1}
    assert c.coll_bytes["all-reduce"] == 8 * 8 * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shard_draws_are_the_global_draws_slices(fake8, dtype):
    """``prng.normal_shard`` of blocks of a [6, 10, 12] draw (chunked along
    the leading dim), and ``tree.leaf_normal_like`` of a DTensor leaf on
    the (4, 2) mesh: bitwise the slices of ``prng.normal``."""
    from repro_torch.utils.tree import leaf_normal_like
    k = prng.fold_in(prng.key(3), 5)
    whole = prng.normal(k, (6, 10, 12), dtype=dtype)
    for off, ls, chunk in [((0, 0, 0), (6, 10, 12), 1 << 25),
                           ((2, 5, 6), (3, 5, 6), 30),
                           ((5, 0, 11), (1, 10, 1), 7)]:
        got = prng.normal_shard(k, (6, 10, 12), off, ls, dtype=dtype,
                                chunk=chunk)
        want = whole[off[0]:off[0] + ls[0], off[1]:off[1] + ls[1],
                     off[2]:off[2] + ls[2]]
        assert torch.equal(got, want)
    assert torch.equal(prng.normal_shard(k, (), (), (), dtype=dtype),
                       prng.normal(k, (), dtype=dtype))
    mesh = fake8
    leaf = torch.zeros(12, 10)
    for spec in [("data", "model"), ("model", None), (None, None)]:
        d = shr.distribute({"w": leaf}, {"w": shr.NamedSharding(
            mesh, shr.P(*spec))})["w"]
        g = leaf_normal_like(k, d, dtype)
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        ls, off = compute_local_shape_and_global_offset(
            (12, 10), mesh.device_mesh, d.placements)
        want = prng.normal(k, (12, 10), dtype=dtype)[
            off[0]:off[0] + ls[0], off[1]:off[1] + ls[1]]
        assert g.placements == d.placements
        assert torch.equal(g.to_local(), want)


@pytest.mark.parametrize("scan", ["mamba", "wkv"])
def test_sharded_scans_stay_on_their_shards(fake8, scan):
    """The selective (Mamba) and WKV scans of DTensors laid out over rows
    and dim 2 on the fake (4, 2) mesh, from a plain zero state: the output
    and the final state keep that layout, no collective runs, and the
    peak of the bytes allocated is no more than the plain scan's on one
    rank's block (a replicated state, or a tensor of the global shape made
    for a stride, would add the whole tensor: 8 blocks)."""
    from repro_torch.models import ssm
    from repro_torch.utils.shardutil import on_mesh
    from torch.distributed.tensor import Shard
    mesh = fake8
    B, T, H, n = 8, 64, 16, 4
    seq = torch.empty(B, T, H, n, device="meta")
    lay = shr.NamedSharding(mesh, shr.P("data", None, "model", None))
    names = ("a", "b") if scan == "mamba" else ("r", "k", "v", "w")
    xs = dryrun._on_meta({k: seq for k in names}, {k: lay for k in names})
    def run(ts, rows, heads):
        if scan == "mamba":
            s0 = torch.zeros(rows, heads, n, device="meta")
            return s0, ssm.diag_ssm_scan(*ts, s0, chunk=16)
        s0 = torch.zeros(rows, heads, n, n, device="meta")
        return s0, ssm.wkv_chunked(*ts, torch.zeros(heads, n, device="meta"),
                                   s0)
    with on_mesh(mesh), dryrun.StepCounter() as c:     # as a forward runs
        s0, (out, s) = run(xs.values(), B, H)
    with dryrun.StepCounter() as one:
        run([torch.empty(B // 4, T, H // 2, n, device="meta")] * len(names),
            B // 4, H // 2)
    assert tuple(out.placements) == (Shard(0), Shard(2))
    assert tuple(out.shape) == (B, T, H, n)
    assert tuple(s.placements) == (Shard(0), Shard(1))
    assert tuple(s.shape) == tuple(s0.shape)
    assert sum(c.coll_counts.values()) == 0
    assert 0 < c.peak <= one.peak, (c.peak, one.peak)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_run_case_on_a_small_fake_mesh(monkeypatch, jdryrun, multi_pod):
    """``run_case`` of qwen2-0.5b x train_4k on a fake (4, 2) mesh, and with
    ``multi_pod`` a (2, 2, 2) one (the pod step and the delta program), as
    the reference's ``tests/test_dryrun_unit.py`` runs its own: the
    reference's keys, its ``n_params``, positive FLOPs, bytes and
    collectives."""
    def small(mp):
        dryrun._fake_world(8)
        return tmesh._make_mesh(
            (2, 2, 2) if mp else (4, 2),
            ("pod", "data", "model") if mp else ("data", "model"),
            device="cpu")
    monkeypatch.setattr(dryrun, "_mesh", small)
    rec = dryrun.run_case("qwen2-0.5b", "train_4k", multi_pod=multi_pod)
    assert not torch.distributed.is_initialized()
    keys = {"arch", "shape", "mesh", "multi_pod", "algo", "b2", "estimator",
            "direction_dtype", "donate", "n_params", "n_active_params",
            "lower_s", "compile_s", "memory", "hlo_flops_per_device",
            "hlo_bytes_per_device", "collective_bytes_per_device",
            "collective_counts", "collective_total_bytes", "roofline_s",
            "dominant_term", "model_flops_total", "zo_model_flops_total",
            "useful_flops_ratio", "hbm_ok"}
    assert keys <= set(rec)
    assert rec["mesh"] == ("2x2x2" if multi_pod else "4x2")
    jcfg = jget_config("qwen2-0.5b")
    assert rec["n_params"] == jdryrun.count_params(
        japi.build(jcfg).param_specs(), jcfg)[0]
    assert rec["hlo_flops_per_device"] > 0
    assert rec["hlo_bytes_per_device"] > 0
    assert rec["collective_total_bytes"] > 0
    assert rec["memory"]["total_bytes_per_device"] > 0
    assert set(rec["collective_bytes_per_device"]) == set(dryrun.COLLECTIVES)
    assert rec["kernel_calls"]["rmsnorm"] > 0
    assert rec["kernel_calls"]["flash_attention"] > 0
    assert rec["kernel_calls"]["zo_axpy"] > 0
    assert ("delta_agg_program" in rec) == multi_pod
    if multi_pod:
        assert rec["delta_agg_program"]["collective_total_bytes"] > 0


@pytest.mark.parametrize("arch,shape_id", [
    ("hymba-1.5b", "train_4k"), ("qwen1.5-32b", "prefill_32k"),
    ("deepseek-v3-671b", "train_4k")])
def test_run_case_fits_where_shards_stay_local(arch, shape_id):
    """On the (16, 16) fake group these cases fit one card (``hbm_ok``)
    only where the layout keeps each rank's shard local: the Mamba scan on
    its rows and channels (a replicated entry state gathered every row:
    408.5 GiB a rank), each prefill layer's cache laid out as its slice of
    the stacked cache (the layers' caches stood whole beside their stack:
    161.9 GiB), and the MTP head's input reduced before the vocab-parallel
    unembedding (a partial input gathered the whole vocab: 106.5 GiB)."""
    rec = dryrun.run_case(arch, shape_id, multi_pod=False)
    assert "error" not in rec
    assert rec["hbm_ok"], rec["memory"]


def test_dryrun_cli_names_a_failed_case(tmp_path, monkeypatch, capsys):
    """A case that raises is a record with its ``error`` and exit code 1."""
    def boom(*a, **k):
        raise RuntimeError("no such layout")
    monkeypatch.setattr(dryrun, "run_case", boom)
    out = tmp_path / "r.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                     "--out", str(out)])
    assert e.value.code == 1
    import json
    rec = json.loads(out.read_text())
    assert rec["error"] == "RuntimeError: no such layout"
    assert "FAIL" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# 4 gloo ranks on the CPU


LM_ARCHS = ["qwen2-0.5b-smoke", "qwen3-moe-30b-a3b-smoke",
            "deepseek-v3-671b-smoke", "rwkv6-7b-smoke",
            "hymba-1.5b-smoke", "seamless-m4t-large-v2-smoke"]


def _lm_inputs(cfg, B=4, S=8, seed=0):
    g = torch.Generator().manual_seed(seed)

    def toks(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=g,
                             dtype=torch.int32)
    train = {"tokens": toks(B, S), "labels": toks(B, S)}
    pre = {"tokens": train["tokens"]}
    if cfg.family == "encdec":
        src = 0.5 * torch.randn(B, cfg.n_frontend_tokens, cfg.d_model,
                                generator=g)
        train["src_embeds"] = pre["src_embeds"] = src
    steps = [toks(B, 1) for _ in range(3)]
    return train, pre, steps


def _moe_kw(cfg):
    # capacity factor E/k: the shard's capacity drops nothing either
    return {"capacity_factor": cfg.n_experts / cfg.top_k} \
        if cfg.n_experts else None


STEP_KW = dict(b2=2, mu=16.0, lr=1e-3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("production")
    lm_cases = []
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        train, pre, steps = _lm_inputs(cfg)
        lm_cases.append((arch, train, pre, steps, 16, 2, _moe_kw(cfg)))
    cfg = get_config("qwen2-0.5b-smoke")
    train, _, _ = _lm_inputs(cfg, seed=1)
    batch = {k: train[k] for k in ("tokens", "labels")}
    step_cases = [("qwen2-0.5b-smoke", batch, STEP_KW, prng.key(7), algo)
                  for algo in ("fedzo", "fedavg")]
    out = str(d / "runs.pt")
    tmesh.run_ranks(_torch_ranks.production_run, 4, backend="gloo",
                    init_dir=str(d), args=(out, lm_cases, step_cases))
    res = torch.load(out, weights_only=False)
    return (dict(zip(LM_ARCHS, res[:len(LM_ARCHS)])),
            dict(zip(("fedzo", "fedavg"), res[len(LM_ARCHS):])), batch)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_on_a_2x2_mesh_matches_one_rank(ranks, arch):
    torch.set_num_threads(1)
    got = ranks[0][arch]
    cfg = get_config(arch)
    if _moe_kw(cfg):
        cfg = cfg.replace(**_moe_kw(cfg))
    model = api.build(cfg)
    p = model.init(prng.key(0), device="cpu")
    train, pre, steps = _lm_inputs(get_config(arch))
    np.testing.assert_allclose(float(got["loss"]),
                               float(model.loss(p, train)), rtol=1e-6)
    logits, cache = model.prefill(p, pre, 16)
    np.testing.assert_allclose(got["prefill"].numpy(), logits.numpy(),
                               atol=1e-5)
    S = pre["tokens"].shape[1]
    for i, tok in enumerate(steps):
        logits, cache = model.decode(p, {"tokens": tok}, cache,
                                     torch.tensor(S + i))
        np.testing.assert_allclose(got["decode"][i].numpy(),
                                   logits.numpy(), atol=1e-5)


@pytest.mark.parametrize("algo", ["fedzo", "fedavg"])
def test_sharded_train_step_matches_unsharded(ranks, algo):
    torch.set_num_threads(1)
    got = ranks[1][algo]
    batch = ranks[2]
    model = api.build(get_config("qwen2-0.5b-smoke"))
    p = model.init(prng.key(0), device="cpu")
    mod = fedzo if algo == "fedzo" else fedavg
    new, mets = mod.make_train_step(lambda q, b: model.loss(q, b),
                                    FedZOConfig(**STEP_KW))(
        p, batch, prng.key(7))
    assert torch.equal(got["metrics"]["loss"], mets["loss"])
    if algo == "fedzo":
        d = sum(t.numel() for t in tree_leaves(p))
        ulp = float(torch.finfo(torch.float32).eps) * abs(float(
            mets["loss"]))
        bound = 4 * d * ulp / STEP_KW["mu"]
        assert abs(float(got["metrics"]["coeff_norm"])
                   - float(mets["coeff_norm"])) <= 2 * bound
    moved = 0.0
    for a, b, b0 in zip(tree_leaves(got["params"]), tree_leaves(new),
                        tree_leaves(p)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        moved = max(moved, float((b - b0).abs().max()))
    assert moved >= 10 * 1e-6      # the limit is not vacuous
