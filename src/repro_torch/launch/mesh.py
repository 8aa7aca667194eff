"""Meshes of the port on ``torch.distributed``: the clients mesh of the
sharded fan-out, the pod mesh of the cross-silo round, and the production
and host meshes of the sharded model path.

Counterpart of ``repro/launch/mesh.py``. The reference's mesh is a
``jax.sharding.Mesh`` over local devices; here a mesh is the process group
that runs one program per rank (SPMD over processes), described by a small
``Mesh``: its ``axis_names``, a ``shape`` mapping (``mesh.shape[axis]`` as
in the reference), this process's ``rank``, the ``group``, the ``device``
the rank computes on and, for a mesh of more than one axis, the
``torch.distributed`` ``DeviceMesh`` of its axes (``device_mesh``): each
axis has its own sub-group (``axis_group``), and DTensors are placed on it
(``launch/sharding.py``).

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

gloo runs ``all_reduce`` on CUDA tensors but not the other collectives
DTensor redistributes with (its all-gather of a CUDA tensor ends the
process), and one card holds no nccl group of more than one rank. So a
mesh over a gloo group on the card calls ``bridge_gloo_cuda()``: it
registers CUDA kernels for the functional all-gather, reduce-scatter and
all-to-all built from ``all_reduce`` alone on the card (a zero-filled
buffer each rank writes its part of; sums with zeros are exact), and DTensor
then runs on the card unchanged.

``run_ranks(fn, n, backend=..., init_dir=...)`` spawns n processes, each
of which joins an n-rank group (rendezvous through a file, no TCP port to
pick) and calls ``fn(rank, n, *args)``; it joins them within a timeout and
raises if a rank fails or hangs.

``make_production_mesh(multi_pod=False)`` is the reference's (16, 16)
``("data", "model")`` mesh, or (2, 16, 16) ``("pod", "data", "model")``,
over an initialised world of 256 or 512 ranks: in the dry-run
(``launch/dryrun.py``) that world is torch's ``fake`` process group, one
process standing for rank 0. ``make_host_mesh(model_axis)`` is ``(n //
model_axis, model_axis)`` over the world's n ranks (several gloo ranks may
share one card), or without a process group a one-member mesh. A world of
another size raises ``ValueError``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Mapping

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.utils.shardutil import dp_axes as data_axes  # noqa: F401


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: Mapping[str, int]
    rank: int
    group: Any            # the process group; None: no collective runs
    device: torch.device
    device_mesh: Any = None   # the DeviceMesh of a multi-axis mesh

    def axis_group(self, axis):
        """The sub-group of the ranks that differ only along ``axis``
        (None on a one-member mesh)."""
        if self.device_mesh is None:
            return self.group if self.axis_names == (axis,) else None
        return self.device_mesh.get_group(axis)

    def axis_rank(self, axis) -> int:
        """This rank's coordinate along ``axis``."""
        if self.device_mesh is None:
            return self.rank if self.axis_names == (axis,) else 0
        return self.device_mesh.get_local_rank(axis)

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


_BRIDGE = []


def bridge_gloo_cuda():
    """CUDA kernels of ``_c10d_functional``'s all-gather, reduce-scatter
    and all-to-all built from ``all_reduce``, for gloo groups on the card
    (once a process). Each is exact: an all-gather is the sum of zero
    buffers each holding one rank's part, a reduce-scatter this rank's
    slice of the all-reduced input, an all-to-all (even splits) the
    all-gathered chunks this rank receives."""
    if _BRIDGE:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gathered(inp, group_size, group_name):
        g = _resolve_process_group(group_name)
        buf = inp.new_zeros((group_size,) + tuple(inp.shape))
        buf[dist.get_rank(g)].copy_(inp)
        dist.all_reduce(buf, group=g)
        return buf, dist.get_rank(g)

    def all_gather_into_tensor(inp, group_size, group_name):
        buf, _ = gathered(inp, group_size, group_name)
        return buf.reshape((group_size * inp.shape[0],)
                           + tuple(inp.shape[1:]))

    def reduce_scatter_tensor(inp, reduce_op, group_size, group_name):
        if reduce_op.lower() != "sum":
            raise NotImplementedError(f"reduce_scatter {reduce_op} on gloo "
                                      f"CUDA tensors")
        g = _resolve_process_group(group_name)
        buf = inp.contiguous().clone()
        dist.all_reduce(buf, group=g)
        return buf.chunk(group_size)[dist.get_rank(g)].clone()

    def all_to_all_single(inp, output_split_sizes, input_split_sizes,
                          group_name):
        if output_split_sizes is not None or input_split_sizes is not None:
            raise NotImplementedError("uneven all_to_all on gloo CUDA "
                                      "tensors")
        g = _resolve_process_group(group_name)
        n = dist.get_world_size(g)
        buf, r = gathered(inp.contiguous(), n, group_name)
        return torch.cat([c.chunk(n)[r] for c in buf.unbind(0)])

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    lib.impl("reduce_scatter_tensor", reduce_scatter_tensor, "CUDA")
    lib.impl("all_to_all_single", all_to_all_single, "CUDA")
    _BRIDGE.append(lib)


def _make_mesh(shape, axes, *, device="cuda") -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over the initialised
    world, its ranks in row-major order (the reference's ``jax.make_mesh``
    order): a world of another size raises ``ValueError``."""
    if not dist.is_initialized():
        raise ValueError(f"a {shape} mesh needs an initialised "
                         f"torch.distributed process group")
    n, world = 1, dist.get_world_size()
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {tuple(shape)} {tuple(axes)} mesh of {n} ranks "
                         f"asked of a world of {world}")
    from torch.distributed.device_mesh import init_device_mesh
    dev = _device(device)
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        bridge_gloo_cuda()
    dm = init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))
    return Mesh(tuple(axes), dict(zip(axes, shape)), dist.get_rank(),
                dist.group.WORLD, dev, dm)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: the ``pod`` axis is the federated one,
    one FedZO client per pod (``core/fedzo.make_pod_round_step``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device=device)


def make_host_mesh(model_axis: int = 1, *, device="cuda") -> Mesh:
    """``(n // model_axis, model_axis)`` ``("data", "model")`` over the
    world's n ranks (tests, the card's smoke run); without a process group
    a one-member mesh on ``device``."""
    if not dist.is_initialized():
        if model_axis != 1:
            raise ValueError(f"a model axis of {model_axis} needs an "
                             f"initialised process group")
        return Mesh(("data", "model"), {"data": 1, "model": 1}, 0, None,
                    _device(device))
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"a model axis of {model_axis} does not divide "
                         f"{n} ranks")
    return _make_mesh((n // model_axis, model_axis), ("data", "model"),
                      device=device)


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
