"""Production dry-run: every (arch × input shape × mesh) case run once on
shapes alone, with the roofline terms of one H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k [--multi-pod] [--algo fedzo|fedavg] [--out out.json]

Counterpart of ``repro/launch/dryrun.py``, with its flags and its record's
keys. The reference lowers and compiles each case on a 256- or 512-device
mesh with abstract inputs and reads XLA's memory and cost analyses. Here
one process stands for rank 0 of a 256- or 512-rank world: torch's
``fake`` process group (no rank exists but this one; a collective returns
at once), the production mesh on it (``launch/mesh.make_production_mesh``),
and parameters, batch and cache as DTensors laid out by
``launch/sharding.py`` whose local shards live on the ``meta`` device (shapes
and dtypes, no memory). The step (train: the FedZO, FedAvg or multi-pod
FedZO step; prefill; decode) runs eagerly on them under a dispatch mode
(``StepCounter``) that sees every op DTensor runs on the local shards:

- FLOPs: the matmul-type ops of ``torch.utils.flop_counter`` on the local
  shards, plus each kernel's own count (``kernels/ops.META_WORK``: on
  ``meta`` shards a kernel's wrapper allocates only its output, as the
  CUDA kernel would, and reports 2·B·H·pairs·(D + Dv) for attention). Torch
  has no HLO: unlike XLA's cost analysis, elementwise work is not counted.
- bytes accessed: each local op's inputs read once and outputs written
  once (views and collectives excluded), the kernels' as they report: an
  unfused count, so above what XLA's fused program moves.
- collectives: bytes (each result's size, as the reference counts the HLO
  result type) and counts per device under the reference's five names, one
  entry a functional collective (DTensor redistributions, the expert-
  parallel MoE's all-gathers and all-reduces).
- memory: argument bytes (this rank's shards of the inputs), output bytes
  (its shards of the results) and the peak of the storages the step
  allocates beside them (``temp_size_in_bytes``; ``generated_code_size_in_
  bytes`` is 0: nothing is compiled).

``lower_s`` is the seconds to build a case (mesh, placement), ``compile_s``
the seconds of the counted run. ``roofline_s`` holds the three terms of
``utils/hw.roofline_seconds`` for one card: data-sheet peaks of the H100
SXM5, not measurements, the collective term over one NVLink link.
``hbm_ok`` holds the total against the card's 80 GiB. ``--donate`` is kept
for parity with the reference's CLI and record and changes nothing: a
decode step writes its cache in place either way.

``--arch all --shape all`` runs every case and exits 1 if any failed; a
failed case's record holds its ``error``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import weakref

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPE_IDS, get_config, get_shape
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedavg, fedzo
from repro_torch.kernels import ops
from repro_torch.launch import sharding as shr
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build, decode_width
from repro_torch.utils import hw, prng
from repro_torch.utils.shardutil import P

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# functional (DTensor, funcol) and c10d collectives by the reference's name
_COLL_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t):
    return t.numel() * t.element_size()


class StepCounter:
    """A dispatch mode counting the work of one rank's local shards:
    ``flops``, ``hbm_bytes``, collective ``coll_bytes``/``coll_counts`` by
    name, and the ``peak`` of the bytes of the storages allocated while it
    is on (``live`` at exit). Ops on DTensors pass through to DTensor,
    whose local ops it then sees; ops on tensors off the ``device``, and
    the sharding propagator's own fake tensors of the global shapes (on
    ``meta`` too: a backward's cast of a whole-vocab logit gradient stood
    112.5 GiB in rwkv6-7b's FedAvg peak), are not counted. Enter it with
    ``with``; it sets ``kernels/ops.META_WORK`` meanwhile."""

    def __init__(self, device="meta"):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        self.device = torch.device(device)
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes = {c: 0 for c in COLLECTIVES}
        self.coll_counts = {c: 0 for c in COLLECTIVES}
        self.kernels = {}
        self.live = 0
        self.peak = 0
        self._alive = {}
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                counter._op(func, args, kwargs, out, flop_registry)
                return out

        self._mode = _Mode()

    def _kernel(self, name, flops, nbytes):
        self.flops += flops
        self.hbm_bytes += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def _op(self, func, args, kwargs, out, flop_registry):
        from torch._subclasses.fake_tensor import FakeTensor
        outs = _tensors(out)
        if not outs or any(t.device != self.device
                           or isinstance(t, FakeTensor) for t in outs):
            return
        ins = _tensors(args) + _tensors(kwargs)
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d", "c10d_functional"):
            kind = _COLL_OPS.get(name)
            if kind is not None:
                self.coll_bytes[kind] += sum(_nbytes(t) for t in outs)
                self.coll_counts[kind] += 1
            return
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        in_st = {id(t.untyped_storage()) for t in ins
                 if t.device == self.device}
        new = []
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in in_st or key in self._alive:
                continue          # a view or an in-place write: no new bytes
            new.append(t)
            nb = st.nbytes()
            self.live += nb
            self.peak = max(self.peak, self.live)
            self._alive[key] = weakref.finalize(st, self._free, key, nb)
        if new and not func._schema.name.startswith("aten::empty"):
            self.hbm_bytes += sum(_nbytes(t) for t in ins
                                  if t.device == self.device)
            self.hbm_bytes += sum(_nbytes(t) for t in new)

    def _free(self, key, nb):
        self.live -= nb
        self._alive.pop(key, None)

    def new_bytes(self, tensors):
        """Bytes of those of ``tensors`` allocated while counting."""
        seen, total = set(), 0
        for t in tensors:
            st = t.untyped_storage()
            if id(st) in self._alive and id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
        return total

    def __enter__(self):
        ops.META_WORK = self._kernel
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        ops.META_WORK = None
        return False


def _local_leaves(tree):
    from repro_torch.utils.shardutil import local
    return [local(t) for t in _tensors(tree)]


def count_params(specs, cfg):
    """(total, active) parameter counts of a tree (``param_specs``):
    ``total`` every element of every leaf; ``active`` the elements one
    token's forward reads, the expert leaves (``sharding._is_expert``)
    counted at ``top_k / n_experts`` of their size (the reference's
    count: router, shared experts and every other leaf whole)."""
    pairs = shr._leaves_any(specs)
    total = sum(int(leaf.numel()) for _, leaf in pairs)
    if not cfg.n_experts:
        return total, total
    expert = sum(int(leaf.numel()) for p, leaf in pairs
                 if shr._is_expert(shr.keystr(p)))
    active = total - expert + expert * cfg.top_k / cfg.n_experts
    return total, int(active)


def _fake_world(n):
    """A fresh ``fake`` process group of ``n`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _mesh(multi_pod):
    """The production mesh over a fresh fake world of its size."""
    _fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


def _on_meta(specs, shardings):
    """DTensors of the specs' global shapes on the shardings' placements,
    each local shard an empty ``meta`` tensor."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    flat_sh = dict(shr._leaves_any(shardings))
    local = {}
    for p, leaf in shr._leaves_any(specs):
        sh = flat_sh[p]
        shape, _ = compute_local_shape_and_global_offset(
            tuple(leaf.shape), sh.mesh.device_mesh, sh.placements)
        local[p] = torch.empty(tuple(shape), dtype=leaf.dtype, device="meta")
    from repro_torch.utils.tree import tree_unflatten
    tree = tree_unflatten(list(local), list(local.values()))
    return shr.from_local(tree, shardings, specs)


def _meta_specs(shapes):
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in shapes.items()}


def build_case(arch, shape_name, *, multi_pod, algo="fedzo", b2=1, h=2,
               estimator="sphere", direction_dtype="float32", donate=False):
    """(cfg, shape, mesh, model, pspecs, fn, args): ``fn(*args)`` runs the
    case's step once on the placed inputs."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    model = build(cfg)
    mesh = _mesh(multi_pod)
    fedcfg = FedZOConfig(b2=b2, local_iters=h, estimator=estimator,
                         direction_dtype=direction_dtype)
    pspecs = model.param_specs()
    params_in = _on_meta(pspecs, shr.param_shardings(pspecs, mesh))
    bspecs = _meta_specs(model.batch_shapes(shape))
    batch_in = _on_meta(bspecs, shr.batch_shardings(bspecs, mesh))

    if shape.kind == "train":
        def loss(p, b):
            return model.loss(p, b, mesh=mesh)
        if algo == "fedavg":
            raw = fedavg.make_train_step(loss, fedcfg)
        elif multi_pod:
            n_pod = mesh.shape["pod"]
            raw = fedzo.make_pod_round_step(
                lambda p, b: model.loss(p, b, n_groups=n_pod, mesh=mesh),
                fedcfg, mesh)
        else:
            raw = fedzo.make_train_step(loss, fedcfg)
        args = (params_in, batch_in, prng.key(0))
        fn = raw
    elif shape.kind == "prefill":
        width = min(shape.seq_len, 32_768)
        csh = shr.cache_shardings(model.init_cache(
            shape.global_batch, width, device="meta"), mesh, cfg)

        def fn(p, b):
            logits, cache = model.prefill(p, b, width, mesh=mesh)
            return logits, _constrained(cache, csh)
        args = (params_in, batch_in)
    else:  # decode
        width = decode_width(cfg, shape)
        window = cfg.long_context_window if shape.seq_len > 65_536 else 0
        cspecs = model.init_cache(shape.global_batch, width, device="meta")
        csh = shr.cache_shardings(cspecs, mesh, cfg)
        cache_in = _on_meta(cspecs, csh)

        def fn(p, b, cache, pos):
            return model.decode(p, b, cache, pos, window=window, mesh=mesh)
        args = (params_in, batch_in, cache_in, torch.tensor(0))
    return cfg, shape, mesh, model, pspecs, fn, args


def _constrained(tree, shardings):
    """Each DTensor leaf redistributed to its sharding (jit's
    ``out_shardings``)."""
    flat = dict(shr._leaves_any(shardings))
    from repro_torch.utils.tree import tree_unflatten
    pairs = shr._leaves_any(tree)
    return tree_unflatten([p for p, _ in pairs], [
        leaf.redistribute(leaf.device_mesh, flat[p].placements)
        if p in flat and tuple(leaf.placements) != flat[p].placements
        else leaf for p, leaf in pairs])


def _delta_agg(pspecs, mesh):
    """The dense-uplink aggregation program of a multi-pod train case:
    per-pod deltas (leaves ``[n_pod, ...]`` over ``pod`` then each leaf's
    spec) to their AirComp mean (``fedzo.make_delta_agg_step``)."""
    n_pod = mesh.shape["pod"]
    psh = shr.param_shardings(pspecs, mesh)
    flat = dict(shr._leaves_any(psh))
    from repro_torch.utils.tree import tree_unflatten
    pairs = shr._leaves_any(pspecs)
    specs = tree_unflatten([p for p, _ in pairs], [
        torch.empty((n_pod,) + tuple(leaf.shape), dtype=leaf.dtype,
                    device="meta") for _, leaf in pairs])
    sh = tree_unflatten([p for p, _ in pairs], [
        shr.NamedSharding(mesh, P("pod", *flat[p].spec)) for p, _ in pairs])
    deltas = _on_meta(specs, sh)
    step = fedzo.make_delta_agg_step(FedZOConfig(aircomp=True, snr_db=0.0),
                                     n_pod)
    with StepCounter() as c:
        # the aggregate laid out as the parameters (a pod sum left partial
        # is reduced here, as the reference's program returns it whole)
        out = _constrained(step(deltas, prng.key(1)), psh)
        temp = c.peak - c.new_bytes(_local_leaves(out))
    return {"collective_bytes_per_device": dict(c.coll_bytes),
            "temp_bytes": int(max(temp, 0)),
            "collective_total_bytes": float(sum(c.coll_bytes.values()))}


def run_case(arch, shape_name, *, multi_pod, algo="fedzo", b2=1, h=2,
             estimator="sphere", direction_dtype="float32", donate=False):
    """One case's record (the reference's keys)."""
    t0 = time.time()
    try:
        cfg, shape, mesh, model, pspecs, fn, args = build_case(
            arch, shape_name, multi_pod=multi_pod, algo=algo, b2=b2, h=h,
            estimator=estimator, direction_dtype=direction_dtype,
            donate=donate)
        t_lower = time.time() - t0
        arg_bytes = sum(_nbytes(t) for t in _local_leaves(args))
        t0 = time.time()
        with StepCounter() as c:
            out = fn(*args)
            out_local = _local_leaves(out)
            out_new = c.new_bytes(out_local)
        t_compile = time.time() - t0
        out_bytes = sum(_nbytes(t) for t in
                        {id(t.untyped_storage()): t
                         for t in out_local}.values())
        agg = _delta_agg(pspecs, mesh) \
            if multi_pod and shape.kind == "train" else None
        n_chips = 1
        for v in mesh.shape.values():
            n_chips *= v
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    mem = {"argument_size_in_bytes": int(arg_bytes),
           "output_size_in_bytes": int(out_bytes),
           "temp_size_in_bytes": int(max(c.peak - out_new, 0)),
           "generated_code_size_in_bytes": 0}
    mem["total_bytes_per_device"] = (mem["argument_size_in_bytes"]
                                     + mem["temp_size_in_bytes"]
                                     + mem["output_size_in_bytes"])
    flops = float(c.flops)
    coll_total = float(sum(c.coll_bytes.values()))
    roof = hw.roofline_seconds(flops, c.hbm_bytes, coll_total, chips=1)
    n_params, n_active = count_params(pspecs, cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
    else:
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind == "prefill" else 1)
    model_flops = 6.0 * n_active * tokens  # forward + backward convention
    # FedZO runs 1 + b2 forwards and no backward
    zo_model_flops = 2.0 * n_active * tokens * (1 + b2) \
        if shape.kind == "train" else 2.0 * n_active * tokens
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(v) for v in mesh.shape.values()),
        "multi_pod": multi_pod, "algo": algo, "b2": b2,
        "estimator": estimator, "direction_dtype": direction_dtype,
        "donate": donate,
        "n_params": n_params, "n_active_params": n_active,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory": mem,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": float(c.hbm_bytes),
        "collective_bytes_per_device": dict(c.coll_bytes),
        "collective_counts": dict(c.coll_counts),
        "collective_total_bytes": coll_total,
        "roofline_s": roof,
        "dominant_term": max(roof, key=roof.get),
        "model_flops_total": model_flops,
        "zo_model_flops_total": zo_model_flops,
        "useful_flops_ratio": (zo_model_flops / n_chips) / flops
        if flops else None,
        "hbm_ok": bool(mem["total_bytes_per_device"]
                       < hw.HBM_CAPACITY_BYTES),
        "kernel_calls": dict(c.kernels),
    }
    if agg is not None:
        rec["delta_agg_program"] = agg
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=ARCH_IDS + ("all",))
    ap.add_argument("--shape", default="train_4k",
                    choices=SHAPE_IDS + ("all",))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--algo", default="fedzo", choices=("fedzo", "fedavg"))
    ap.add_argument("--b2", type=int, default=1)
    ap.add_argument("--local-iters", type=int, default=2)
    ap.add_argument("--estimator", default="sphere",
                    choices=("sphere", "gaussian", "coordinate"))
    ap.add_argument("--direction-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--donate", action="store_true",
                    help="kept for parity with the reference's CLI and "
                         "record; changes nothing (a decode step writes its "
                         "cache in place either way)")
    ap.add_argument("--out", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = SHAPE_IDS if args.shape == "all" else (args.shape,)
    existing = set()
    if args.out and args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                existing.add((r["arch"], r["shape"], r["multi_pod"],
                              r["algo"]))

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            key = (arch, shape, args.multi_pod, args.algo)
            if key in existing:
                print(f"skip {key}", flush=True)
                continue
            print(f"=== {arch} × {shape} × "
                  f"{'2x16x16' if args.multi_pod else '16x16'} "
                  f"({args.algo})", flush=True)
            try:
                rec = run_case(arch, shape, multi_pod=args.multi_pod,
                               algo=args.algo, b2=args.b2,
                               h=args.local_iters, estimator=args.estimator,
                               direction_dtype=args.direction_dtype,
                               donate=args.donate)
            except Exception as e:  # noqa: BLE001 — report and continue
                rec = {"arch": arch, "shape": shape,
                       "multi_pod": args.multi_pod, "algo": args.algo,
                       "error": f"{type(e).__name__}: {e}"}
                n_fail += 1
                print(f"FAIL: {rec['error'][:400]}", flush=True)
            else:
                print(json.dumps({k: rec[k] for k in
                                  ("memory", "hlo_flops_per_device",
                                   "roofline_s", "dominant_term", "hbm_ok",
                                   "compile_s")}, indent=1), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
