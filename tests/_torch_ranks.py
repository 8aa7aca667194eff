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
                        algo="fedzo", model_axis=2, model_kw=None):
    """One cross-silo train step (``fedzo``/``fedavg.make_train_step``) of
    the ``arch`` model (its config replaced by ``model_kw``) with its params
    laid out on a host mesh by ``launch/sharding.py``; rank 0 saves the new
    params and metrics whole (or returns them when ``out`` is None)."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.core import fedavg
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_map
    cfg = get_config(arch)
    model = api.build(cfg.replace(**model_kw) if model_kw else cfg)
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


def sharded_fedavg_run(rank, world, out, grad_cases, step_cases, xent):
    """``moe_grad_run`` of ``grad_cases``, ``train_step_mesh_run`` of each
    of ``step_cases`` and ``xent_mesh_run`` of ``xent``, in one group;
    rank 0 saves the three results."""
    res = (moe_grad_run(rank, world, None, grad_cases),
           [train_step_mesh_run(rank, world, None, *c) for c in step_cases],
           xent_mesh_run(rank, world, *xent))
    if rank == 0:
        torch.save(res, out)


def xent_mesh_run(rank, world, logits, labels, model_axis=2):
    """The token cross-entropy (``models/layers._token_xent``) of logits laid
    out vocab-parallel on a host mesh (rows over data, vocab over model),
    and the masked sum it replaced (a whole-vocab iota and mask on every
    rank) on the same DTensors; both whole."""
    torch.set_num_threads(1)
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import _token_xent
    from repro_torch.utils.shardutil import on_mesh
    mesh = make_host_mesh(model_axis, device="cpu")
    d = shr.distribute({"l": logits, "y": labels}, {
        "l": shr.NamedSharding(mesh, shr.P("data", None, "model")),
        "y": shr.NamedSharding(mesh, shr.P("data", None))})
    with on_mesh(mesh):
        new = _token_xent(d["l"], d["y"])
        lf = d["l"].to(torch.float32)
        m = torch.amax(lf, dim=-1)
        lse = m + torch.log(torch.sum(torch.exp(lf - m[..., None]), dim=-1))
        hit = torch.arange(lf.shape[-1]) == d["y"].to(torch.int64)[..., None]
        old = lse - torch.sum(torch.where(hit, lf, 0.0), dim=-1)
    return {"new": _full(new), "old": _full(old),
            "placements": str(new.placements)}


def moe_grad_run(rank, world, out, cases, model_axis=2):
    """The gradient of ``sum(out · w) + aux`` of the expert-parallel
    ``moe_fwd`` (leaves and x laid out as ``moe_mesh_run`` lays them out)
    with respect to x and every leaf, for each ``(cfg, p, x, w)`` of
    ``cases``; rank 0 saves the whole gradients."""
    torch.set_num_threads(1)
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import moe_fwd
    from repro_torch.utils.flatparams import _leaves
    from repro_torch.utils.shardutil import on_dtensors
    from repro_torch.utils.tree import tree_unflatten
    mesh = make_host_mesh(model_axis, device="cpu")
    res = []
    for cfg, p, x, w in cases:
        pairs = _leaves(p)
        psh = tree_unflatten([k for k, _ in pairs], [shr.NamedSharding(
            mesh, shr.leaf_spec(shr.keystr(("moe",) + tuple(k)),
                                tuple(v.shape), mesh)) for k, v in pairs])
        dp = shr.distribute(p, psh)
        b = shr.distribute({"x": x, "w": w},
                           shr.batch_shardings({"x": x, "w": w}, mesh))
        leaves = [v.detach().requires_grad_() for _, v in _leaves(dp)]
        xin = b["x"].detach().requires_grad_()
        o, aux = moe_fwd(tree_unflatten([k for k, _ in pairs], leaves), cfg,
                         xin, mesh=mesh)
        f = torch.sum(o * b["w"]) + aux
        with on_dtensors(leaves):
            g = torch.autograd.grad(f, [xin] + leaves)
        res.append({"f": _full(f), "x": _full(g[0]),
                    "p": {"/".join(k): _full(t)
                          for (k, _), t in zip(pairs, g[1:])}})
    if out is None:
        return res
    if rank == 0:
        torch.save(res, out)
