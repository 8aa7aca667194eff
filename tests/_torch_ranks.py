"""Rank bodies of the port's multi-process tests: module-level functions a
spawned process can import (``launch/mesh.run_ranks``). Each runs under
gloo (on the CPU, or with every rank on the one card) and writes rank 0's
result with ``torch.save``."""
import torch

from repro_torch import sim
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedzo
from repro_torch.workloads import neural


def sharded_run(rank, world, out, task_kw, cfgs, rounds, device="cpu"):
    """``neural.run(mesh=)`` of each config in ``cfgs`` over the
    ``world``-rank clients mesh."""
    torch.set_num_threads(1)
    task = neural.make_task("softmax", device=device, **task_kw)
    mesh = sim.make_clients_mesh(world, device=device)
    res = [neural.run(task, FedZOConfig(**kw), rounds, eval_every=0,
                      mesh=mesh) for kw in cfgs]
    if rank == 0:
        torch.save([{"params": {k: v.cpu() for k, v in r.params.items()},
                     "metrics": {k: v.cpu() for k, v in r.metrics.items()}}
                    for r in res], out)


def pod_run(rank, world, out, params, batches, cfg_kw, key):
    """One flat pod step over a ``world``-pod mesh, rank r's silo batch
    ``batches[r]``."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import api
    model = api.build(get_config("qwen2-0.5b-smoke"))
    mesh = make_pod_mesh(world, device="cpu")
    step = fedzo.make_pod_round_step(
        lambda p, b: model.loss(p, b).reshape(1), FedZOConfig(**cfg_kw),
        mesh)
    new, mets = step(params, batches[rank], key)
    if rank == 0:
        torch.save({"params": new, "metrics": mets}, out)


def _full(t):
    """A DTensor's whole value on the CPU (a plain tensor as it is)."""
    from repro_torch.utils.shardutil import is_dtensor
    if is_dtensor(t):
        t = t.full_tensor()
        t = t.wait() if hasattr(t, "wait") else t   # an async collective's
    return t.detach().cpu()


def moe_mesh_run(rank, world, out, cases, model_axis=2):
    """The expert-parallel ``moe_fwd`` on a ``(world // model_axis,
    model_axis)`` host mesh for each ``(cfg, p, x)`` of ``cases``: the
    expert leaves laid out by ``launch/sharding.leaf_spec``, x by
    ``batch_shardings``."""
    torch.set_num_threads(1)
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import moe_fwd
    mesh = make_host_mesh(model_axis, device="cpu")
    res = []
    for cfg, p, x in cases:
        psh = {k: shr.NamedSharding(mesh, shr.leaf_spec(
            shr.keystr(("moe", k)), tuple(v.shape), mesh))
            for k, v in p.items()}
        dp = shr.distribute(p, psh)
        dx = shr.distribute({"x": x}, shr.batch_shardings({"x": x}, mesh))
        o, aux = moe_fwd(dp, cfg, dx["x"], mesh=mesh)
        res.append({"out": _full(o), "aux": _full(aux),
                    "placements": str(o.placements)})
    if rank == 0:
        torch.save(res, out)


def production_run(rank, world, out, lm_cases, step_cases):
    """``lm_mesh_run`` of each of ``lm_cases`` and ``train_step_mesh_run``
    of each of ``step_cases`` (tuples of their arguments after ``out``), in
    one group; rank 0 saves the list of results."""
    res = [lm_mesh_run(rank, world, None, *c) for c in lm_cases] \
        + [train_step_mesh_run(rank, world, None, *c) for c in step_cases]
    if rank == 0:
        torch.save(res, out)


def lm_mesh_run(rank, world, out, arch, train, prefill, steps, width,
                model_axis=2, cfg_kw=None):
    """The ``arch`` model's loss on ``train``, prefill of ``prefill`` and
    ``steps`` decode steps on a host mesh, params, batches and cache laid
    out by ``launch/sharding.py``; rank 0 saves the whole values (to
    ``out``, or returns them when it is None)."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.utils import prng
    cfg = get_config(arch)
    if cfg_kw:
        cfg = cfg.replace(**cfg_kw)
    model = api.build(cfg)
    mesh = make_host_mesh(model_axis, device="cpu")
    params = model.init(prng.key(0), device="cpu")
    dp = shr.distribute(params, shr.param_shardings(model.param_specs(),
                                                    mesh))

    def put(b):
        return shr.distribute(b, shr.batch_shardings(b, mesh))

    res = {"loss": _full(model.loss(dp, put(train), mesh=mesh))}
    logits, cache = model.prefill(dp, put(prefill), width, mesh=mesh)
    res["prefill"] = _full(logits)
    res["decode"] = []
    S = prefill["tokens"].shape[1]
    for i, tok in enumerate(steps):
        logits, cache = model.decode(dp, put({"tokens": tok}), cache,
                                     torch.tensor(S + i), mesh=mesh)
        res["decode"].append(_full(logits))
    if out is None:
        return res
    if rank == 0:
        torch.save(res, out)


def train_step_mesh_run(rank, world, out, arch, batch, cfg_kw, key,
                        algo="fedzo", model_axis=2):
    """One cross-silo train step (``fedzo``/``fedavg.make_train_step``) of
    the ``arch`` model with its params laid out on a host mesh by
    ``launch/sharding.py``; rank 0 saves the new params and metrics whole
    (or returns them when ``out`` is None)."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.core import fedavg
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_map
    model = api.build(get_config(arch))
    mesh = make_host_mesh(model_axis, device="cpu")
    params = model.init(prng.key(0), device="cpu")
    dp = shr.distribute(params, shr.param_shardings(model.param_specs(),
                                                    mesh))
    db = shr.distribute(batch, shr.batch_shardings(batch, mesh))
    mod = fedzo if algo == "fedzo" else fedavg
    step = mod.make_train_step(lambda p, b: model.loss(p, b, mesh=mesh),
                               FedZOConfig(**cfg_kw))
    new, mets = step(dp, db, key)
    res = {"params": tree_map(_full, new),
           "metrics": {k: _full(v) for k, v in mets.items()}}
    if out is None:
        return res
    if rank == 0:
        torch.save(res, out)
