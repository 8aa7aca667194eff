"""Sharding constraints on DTensors: ``dp_axes``, ``constrain`` and
``constrain_batch``.

Counterpart of ``repro/utils/shardutil.py``. The reference constrains a
jax array to ``NamedSharding(mesh, P(*spec))``; here a spec is the port's
``P`` (a tuple of axis names, tuples of names or None, one entry a tensor
dim) and ``constrain`` redistributes a DTensor to the placements it names
on the mesh's ``DeviceMesh`` (``placements``). Without a mesh, or on a
plain tensor, both are the identity, so every path without a mesh is
bitwise what it was.

Axes the mesh lacks are dropped from a spec. The reference also drops
the manual axes of a ``shard_map`` region; the port's manual region, the
body of the expert-parallel MoE (``models/moe.py``), works on local
tensors, on which a constraint is the identity.
"""
from __future__ import annotations

import contextlib

import torch


class P(tuple):
    """A partition spec: ``P("model", None)``; an entry is an axis name, a
    tuple of names (major to minor) or None (replicated). A tuple of one
    name is that name, as jax's ``PartitionSpec`` holds it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def dp_axes(mesh):
    """The batch ('data-parallel') axes present in a mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def strip(spec, axis_names):
    """``spec`` without the axes not in ``axis_names`` (an emptied tuple
    entry becomes None)."""
    def one(s):
        if s is None:
            return None
        if isinstance(s, (tuple, list)):
            t = tuple(a for a in s if a in axis_names)
            return t if t else None
        return s if s in axis_names else None
    return P(*[one(s) for s in spec])


def placements(mesh, spec):
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh axis in
    ``mesh.axis_names`` order: ``Shard(d)`` where the axis shards tensor
    dim d, else ``Replicate()``. A tuple entry shards its dim over each of
    its axes, the first the major one, as ``NamedSharding`` lays it out
    (the mesh's axes are in that order in every spec the port makes)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, s in enumerate(spec):
        for a in ((s,) if isinstance(s, str) else (s or ())):
            if a in where:
                raise ValueError(f"axis {a!r} twice in {spec}")
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.axis_names)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, mesh, *spec):
    """``x`` redistributed to ``P(*spec)`` on ``mesh`` (axes the mesh
    lacks stripped); ``x`` itself without a mesh, for a plain tensor, or
    when it is laid out so already."""
    if mesh is None or not is_dtensor(x):
        return x
    want = placements(mesh, strip(spec, mesh.axis_names))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_batch(x, mesh):
    """Leading dim over (pod, data), the rest replicated."""
    if mesh is None or not is_dtensor(x):
        return x
    return constrain(x, mesh, dp_axes(mesh), *([None] * (x.ndim - 1)))


def _implicit(on):
    if not on:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def on_mesh(mesh):
    """The context a forward runs in on ``mesh``: plain tensors made
    inside it (positions, masks, scalars) count as replicated beside the
    DTensors (DTensor's ``implicit_replication``); nothing without a
    multi-axis mesh."""
    return _implicit(mesh is not None
                     and getattr(mesh, "device_mesh", None) is not None)


def on_dtensors(tensors):
    """``on_mesh``'s context when any of ``tensors`` is a DTensor (an
    autograd backward through a sharded forward runs in it too)."""
    return _implicit(any(is_dtensor(t) for t in tensors))


def reduce_fanout_partials(root):
    """Before a backward from ``root``: every gradient that autograd will
    add to another (a tensor the forward used more than once) has its
    partial sums reduced first. The two addends of such a sum can come out
    of DTensor's backward rules partial and sharded over crossed mesh axes
    (``(Shard(2), Partial())`` and ``(Partial(), Shard(2))`` for a hidden
    state two branches read); a release's rule for the add may then ask to
    turn a shard into a partial sum, which no release can (torch 2.11 asks
    it of hymba's and qwen3-moe's hidden states). Reduced, the addends meet
    in a layout every release adds. The sums' values are unchanged."""
    from collections import Counter
    from torch.distributed.tensor import Replicate
    uses, edges, seen, todo = Counter(), [], set(), [root.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for i, (nxt, nr) in enumerate(node.next_functions):
            if nxt is not None:
                uses[(nxt, nr)] += 1
                edges.append((node, i, (nxt, nr)))
                todo.append(nxt)
    fan = {}
    for node, i, key in edges:
        if uses[key] > 1:
            fan.setdefault(node, set()).add(i)

    def hook(idx):
        def reduce(grad_inputs, grad_outputs):
            return tuple(
                g.redistribute(g.device_mesh, [
                    Replicate() if p.is_partial() else p
                    for p in g.placements])
                if i in idx and is_dtensor(g)
                and any(p.is_partial() for p in g.placements) else g
                for i, g in enumerate(grad_inputs))
        return reduce
    for node, idx in fan.items():
        node.register_hook(hook(idx))


def divisible(t, dim, size):
    """DTensor ``t`` with dim ``dim`` gathered unless the mesh axes that
    shard it divide ``size`` (the dim a reshape splits it into first);
    ``t`` itself otherwise, and for a plain tensor."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    n = 1
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            n *= t.device_mesh.size(i)
    if n == 1 or size % n == 0:
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_shard(dim) else p for p in t.placements])


def whole(t, dim):
    """DTensor ``t`` with dim ``dim`` gathered (sliced next); ``t`` itself
    when no mesh axis shards it, and for a plain tensor."""
    return divisible(t, dim, 1)


def reduced(t):
    """DTensor ``t`` with its partial sums reduced (each ``Partial``
    placement made ``Replicate``); ``t`` itself otherwise."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def split_last(t, shape):
    """``t.reshape(shape)`` for a reshape that splits t's last dim (heads
    out of a projection). A DTensor whose last dim is sharded over mesh
    axes that do not divide the new dim there (qwen2's 14 heads on a
    16-way ``model`` axis) first gathers that dim, as GSPMD reshards it."""
    d = t.ndim - 1
    return divisible(t, d, shape[d]).reshape(shape)


class _MergeLastFn(torch.autograd.Function):
    """A DTensor's last dims merged into one; the gradient split back by
    ``split_last``."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.shape = tuple(t.shape)
        return t.reshape(ctx.shape[:-n] + (-1,))

    @staticmethod
    def backward(ctx, g):
        return split_last(g, ctx.shape), None


def merge_last(t, n=2):
    """``t``'s last ``n`` dims merged into one (heads into the output
    projection's input): ``reshape`` itself. On a DTensor that needs a
    gradient, the backward splits the gradient with ``split_last``, which
    first gathers the merged dim where the mesh axes that shard it do not
    divide the leading split dim (DTensor's view rule refuses to split a
    dim sharded unevenly: qwen2's 14 heads on a 16-way ``model`` axis)."""
    if is_dtensor(t) and t.requires_grad and torch.is_grad_enabled():
        return _MergeLastFn.apply(t, n)
    return t.reshape(tuple(t.shape[:-n]) + (-1,))


def as_dtensor(t, mesh, placements, shape):
    """Local shard ``t`` as the contiguous DTensor of global ``shape`` laid
    out by ``placements`` on ``mesh`` (a ``DeviceMesh``), unchecked across
    ranks. Its stride is computed, not read off a tensor of the global
    shape (which the dry-run would count as memory)."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for v in reversed(shape):
        stride.insert(0, n)
        n *= v
    return DTensor.from_local(t.contiguous(), mesh, tuple(placements),
                              run_check=False, shape=tuple(shape),
                              stride=tuple(stride))


def local(x):
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


__all__ = ["P", "as_dtensor", "constrain", "constrain_batch",
           "divisible", "dp_axes", "is_dtensor", "local", "merge_last",
           "on_dtensors", "on_mesh", "reduce_fanout_partials",
           "placements", "reduced", "split_last", "strip", "whole"]
