"""Divisibility-aware sharding rules: parameter, batch and cache trees to
DTensor placements on a mesh.

Counterpart of ``repro/launch/sharding.py``; the rules and every leaf's
spec are the reference's, entry for entry:

- params: FSDP everywhere plus tensor or expert parallelism where it
  fits. For each leaf the dims are walked largest first, skipping a
  stacked leaf's leading layer axis, and ``model`` goes on the first
  divisible dim, then ``data`` on the next. Leaves under
  ``MIN_SHARD_ELEMS`` (norm scales, biases) stay replicated. Expert
  tensors ``[L, E, d, f]`` get E over ``model`` and the FFN dim over
  ``data`` (the expert-parallel ``moe_fwd``'s layout). The token table
  and the unembedding are vocab-parallel: vocab over ``model``.
- batch: the leading batch dim over ``("pod", "data")`` jointly when it
  divides; ``long_500k`` (batch 1) replicates its inputs.
- caches: batch over ``("pod", "data")`` when it divides, else the ring's
  sequence dim over ``data``; heads over ``model`` when they divide, else
  the sequence dim over ``model``.

A path is a leaf's key path in jax's ``keystr`` form (``"['blocks']
['attn']['wq']"``, ``keystr``), a spec the port's ``P`` (a tuple of axis
names, tuples of names or None). The ``*_shardings`` functions return a
tree of ``NamedSharding``: the spec and the mesh, whose ``placements`` are
the DTensor placements of the spec on the mesh's ``DeviceMesh``
(``utils/shardutil.placements``); ``distribute`` puts a tree on the mesh
with them, the counterpart of jit's ``in_shardings``. The rules read only
``mesh.axis_names`` and ``mesh.shape``.

Awkward dims (qwen1.5-32b's 40 heads on a 16-way model axis) fall
through to the next divisible dim; ``explain`` lists them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.utils.shardutil import P, dp_axes, placements
from repro_torch.utils.tree import tree_unflatten

MIN_SHARD_ELEMS = 2048  # below this a leaf is replicated

# ZO training keeps no gradients or optimizer state, so FSDP over ``data``
# would only be needed past a per-device budget; the reference measured
# that dropping it replicates the float32 direction trees (they inherit
# the weights' sharding) and keeps FSDP on unconditionally (threshold 0).
FSDP_BYTES_THRESHOLD = 0


def keystr(path) -> str:
    """jax's ``keystr`` of a dict key path: ``"['a']['b']"``."""
    return "".join(f"[{k!r}]" for k in path)


def _is_stacked(path_str):
    # a stacked leaf's leading layer axis is never sharded
    return "blocks" in path_str


def _is_expert(path_str):
    return any(k in path_str for k in ("w_gate", "w_up", "w_down")) and \
        "moe" in path_str


def leaf_spec(path_str, shape, mesh, allow_data=True) -> P:
    ndim = len(shape)
    if ndim == 0:
        return P()
    n_model = mesh.shape.get("model", 1)
    n_data = mesh.shape.get("data", 1) if allow_data or _is_expert(path_str) \
        else 1
    start = 1 if (_is_stacked(path_str) and ndim > 1) else 0

    if path_str.endswith("['tok']") or path_str.endswith("['unembed']"):
        # vocab-parallel layout: vocab over model, d_model replicated
        v_ax = 0 if path_str.endswith("['tok']") else ndim - 1
        spec = [None] * ndim
        if shape[v_ax] % n_model == 0:
            spec[v_ax] = "model"
        return P(*spec)

    if _is_expert(path_str):
        # [L, E, d, f] (or [E, d, f]): E -> model, FFN dim -> data
        spec = [None] * ndim
        e_ax = start
        spec[e_ax] = "model" if shape[e_ax] % n_model == 0 else None
        # the FSDP dim: w_down has f at e_ax + 1, w_gate/w_up at e_ax + 2
        f_ax = e_ax + (1 if "w_down" in path_str else 2)
        if f_ax < ndim and shape[f_ax] % n_data == 0:
            spec[f_ax] = "data"
        return P(*spec)

    size = 1
    for s in shape:
        size *= s
    if size < MIN_SHARD_ELEMS:
        return P()

    dims = sorted(range(start, ndim), key=lambda i: -shape[i])
    spec = [None] * ndim
    for axis_name, n in (("model", n_model), ("data", n_data)):
        if n == 1:
            continue
        for i in dims:
            if spec[i] is None and shape[i] % n == 0 and shape[i] >= n:
                spec[i] = axis_name
                break
    return P(*spec)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; ``placements`` are its DTensor placements."""
    mesh: Any
    spec: P

    @property
    def placements(self):
        return placements(self.mesh, self.spec)


def _tree(specs, fn):
    pairs = _leaves_any(specs)
    return tree_unflatten([p for p, _ in pairs],
                          [fn(p, leaf) for p, leaf in pairs])


def _nbytes(leaf):
    n = 1
    for s in leaf.shape:
        n *= s
    return n * leaf.dtype.itemsize


def param_shardings(param_specs, mesh):
    """Tree of tensors (``meta`` ones: ``param_specs``) -> tree of
    ``NamedSharding``. FSDP (``data`` on weights) is on whenever the
    tensor-parallel share exceeds ``FSDP_BYTES_THRESHOLD`` per device."""
    total = sum(_nbytes(leaf) for _, leaf in _leaves_any(param_specs))
    allow_data = total / max(mesh.shape.get("model", 1), 1) \
        > FSDP_BYTES_THRESHOLD
    return _tree(param_specs, lambda p, leaf: NamedSharding(
        mesh, leaf_spec(keystr(p), tuple(leaf.shape), mesh,
                        allow_data=allow_data)))


def batch_shardings(batch_specs, mesh):
    """``{name: tensor}`` -> ``{name: NamedSharding}``: the leading batch
    dim over the data axes when it divides, else replicated."""
    dp = dp_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]

    def one(leaf):
        if leaf.ndim >= 1 and leaf.shape[0] % n_dp == 0:
            return NamedSharding(mesh, P(dp, *([None] * (leaf.ndim - 1))))
        # batch not divisible (long_500k B=1): replicate inputs
        return NamedSharding(mesh, P())

    return {k: one(v) for k, v in batch_specs.items()}


def cache_shardings(cache_specs, mesh, cfg):
    """Decode caches ``[L(, G), B, W, H, hd]``, latents ``[L, B, W, r]``,
    states: batch over (pod, data) when divisible; otherwise the ring's
    sequence (W) dim over ``data`` (context parallelism for long_500k);
    heads over ``model`` when divisible, else W over ``model``."""
    dp = dp_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    n_model = mesh.shape.get("model", 1)

    def one(path, leaf):
        path_str = keystr(path)
        shape = tuple(leaf.shape)
        ndim = len(shape)
        spec = [None] * ndim
        # the batch dim follows the stacked prefix; the reference detects a
        # two-axis prefix by ".self" in the key string (which its keystr
        # never holds: every prefix is one axis)
        prefix = 1
        if ".self" in path_str and ndim >= 5:
            prefix = 2 if "cross" not in path_str else 1
        b_ax = prefix
        if b_ax < ndim and shape[b_ax] % n_dp == 0 and n_dp > 1:
            spec[b_ax] = dp
        elif ndim > b_ax + 1 \
                and shape[b_ax + 1] % mesh.shape.get("data", 1) == 0 \
                and ("k" in path_str or "v" in path_str
                     or "latent" in path_str):
            spec[b_ax + 1] = "data"   # context parallelism on W
        # heads axis of kv caches: [..., W, H, hd]
        if ndim >= b_ax + 3:
            h_ax = ndim - 2
            w_ax = ndim - 3
            if spec[h_ax] is None and shape[h_ax] % n_model == 0 \
                    and shape[h_ax] >= n_model:
                spec[h_ax] = "model"
            elif spec[w_ax] is None and shape[w_ax] % n_model == 0:
                # heads do not divide the model axis (qwen1.5's 40, GQA 8
                # on 16): the cache's sequence dim over model instead
                spec[w_ax] = "model"
        return NamedSharding(mesh, P(*spec))

    return _tree(cache_specs, one)


def explain(param_specs, mesh, max_rows=0):
    """(path, shape, spec) of every leaf: the sharding table."""
    rows = [(keystr(p), tuple(leaf.shape),
             leaf_spec(keystr(p), tuple(leaf.shape), mesh))
            for p, leaf in _leaves_any(param_specs)]
    return rows[:max_rows] if max_rows else rows


def distribute(tree, shardings):
    """Each leaf of ``tree`` as a DTensor laid out by its ``NamedSharding``
    in ``shardings`` (the same structure); every rank passes the same
    whole leaf and keeps its shard, cut from it locally (no collective:
    ``src_data_rank=None``). A ``dict`` batch takes a ``dict`` of
    shardings."""
    from torch.distributed.tensor import distribute_tensor

    def one(leaf, sh):
        return distribute_tensor(leaf, sh.mesh.device_mesh, sh.placements,
                                 src_data_rank=None)

    pairs = _leaves_any(tree)
    flat_sh = dict(_leaves_any(shardings))
    return tree_unflatten([p for p, _ in pairs],
                          [one(leaf, flat_sh[p]) for p, leaf in pairs])


def _leaves_any(tree, prefix=()):
    """(path, leaf) of a nested dict of any leaves (None skipped)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves_any(v, prefix + (k,))
        elif v is not None:
            out.append((prefix + (k,), v))
    return out


def from_local(tree, shardings, like):
    """Each leaf of ``tree`` (this rank's shard) as the DTensor of its
    ``NamedSharding``, with the global shape and stride of the leaf of
    ``like`` at its path (``meta`` tensors serve)."""
    from torch.distributed.tensor import DTensor
    flat_sh = dict(_leaves_any(shardings))
    flat_like = dict(_leaves_any(like))
    pairs = _leaves_any(tree)
    return tree_unflatten([p for p, _ in pairs], [
        DTensor.from_local(leaf, flat_sh[p].mesh.device_mesh,
                           flat_sh[p].placements, run_check=False,
                           shape=flat_like[p].shape,
                           stride=flat_like[p].stride())
        for p, leaf in pairs])


__all__ = ["FSDP_BYTES_THRESHOLD", "MIN_SHARD_ELEMS", "NamedSharding",
           "batch_shardings", "cache_shardings", "distribute", "explain",
           "from_local", "keystr", "leaf_spec", "param_shardings"]
