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
