"""Meshes of the port on ``torch.distributed``: the clients mesh of the
sharded fan-out and the pod mesh of the cross-silo round.

Counterpart of ``repro/launch/mesh.py:34-45, 52-53``. The reference's mesh
is a ``jax.sharding.Mesh`` over local devices; here a mesh is the process
group that runs one program per rank (SPMD over processes), described by a
small ``Mesh``: its ``axis_names``, a ``shape`` mapping (``mesh.shape[axis]``
as in the reference), this process's ``rank``, the ``group`` and the
``device`` the rank computes on.

- With no process group initialised, ``make_clients_mesh()`` is a
  one-member mesh on the card: the reference's 1-device mesh.
- With one, it spans the group's ranks. The backend is the caller's
  choice when it calls ``torch.distributed.init_process_group``: ``nccl``
  (one card per rank), or ``gloo`` (the CPU, and several ranks sharing one
  card; gloo all-reduces CUDA tensors through the host). Nothing picks or
  swaps a backend here.

``make_pod_mesh(n_pod)`` without a process group is a mesh whose ``n_pod``
pods all live in this process, as the reference's GSPMD pod round computes
every pod's loss group in one program (``core/fedzo.make_pod_round_step``).

``run_ranks(fn, n, backend=..., init_dir=...)`` spawns n processes, each
of which joins an n-rank group (rendezvous through a file, no TCP port to
pick) and calls ``fn(rank, n, *args)``; it joins them within a timeout and
raises if a rank fails or hangs.

The TPU v5e production meshes (``make_production_mesh``,
``make_host_mesh``) are not ported.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Mapping

import torch
import torch.distributed as dist

from repro_torch import resolve_device


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: Mapping[str, int]
    rank: int
    group: Any            # the process group; None: no collective runs
    device: torch.device

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group's ranks, in place (nothing without a
        group). Every rank must call it with a tensor of one shape."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t


def _device(device):
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _group_mesh(axis, n, group, device):
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if n and n != size:
        raise ValueError(f"a {axis!r} mesh of {n} members asked of a process "
                         f"group of {size} ranks")
    return Mesh((axis,), {axis: size}, dist.get_rank(group), group,
                _device(device))


def make_clients_mesh(n_devices: int = 0, *, axis: str = "clients",
                      group=None, device="cuda") -> Mesh:
    """1-D mesh with the federated ``clients`` axis: the simulation
    engine's fan-out mesh (``sim/shard.py``), the M sampled clients of each
    round split over its ranks, one shard of local phases and one partial
    reduce per rank. ``group`` (default: the initialised world) spans the
    ranks; without a process group the mesh is this process alone."""
    if group is None and not dist.is_initialized():
        if n_devices > 1:
            raise ValueError(f"a {n_devices}-rank clients mesh needs an "
                             f"initialised torch.distributed process group")
        return Mesh((axis,), {axis: 1}, 0, None, _device(device))
    return _group_mesh(axis, n_devices, group, device)


def make_pod_mesh(n_pod: int = 0, *, group=None, device="cuda") -> Mesh:
    """The cross-silo round's ``pod`` axis: over a process group, one pod
    per rank; without one, ``n_pod`` pods computed in this process."""
    if group is None and not dist.is_initialized():
        return Mesh(("pod",), {"pod": max(n_pod, 1)}, 0, None,
                    _device(device))
    return _group_mesh("pod", n_pod, group, device)


def data_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _rank_main(rank, fn, world_size, backend, init_file, args):
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world_size, rank=rank)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, *, backend: str, init_dir: str,
              args=(), timeout: float = 300.0):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one ``backend`` process group (``gloo`` or
    ``nccl``), the rendezvous a fresh file under ``init_dir``. ``fn`` must
    be importable by the children (a module-level function). Every process
    is joined: a rank that raises fails the call (the others are
    terminated), and one still running after ``timeout`` seconds is killed
    and the call raises ``TimeoutError``."""
    import torch.multiprocessing as mp
    os.makedirs(init_dir, exist_ok=True)
    init_file = os.path.join(init_dir, f"rendezvous_{os.getpid()}_"
                             f"{time.monotonic_ns()}")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, backend, init_file, tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, min(
                1.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
