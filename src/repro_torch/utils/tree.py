"""Helpers over parameter trees: nested dicts of tensors.

Counterpart of ``repro/utils/tree.py``, the workhorses of the pytree FedZO
route (``core/estimator.py``). Leaf order is jax's: keys sorted at every
level (``utils/flatparams._leaves``), so leaf i here is leaf i of
``jax.tree.flatten`` on the same dict, and the per-leaf keys
``fold_in(rng, i)`` draw the reference's directions.

``tree_axpy`` runs the ``zo_axpy`` kernel on every leaf (its plain version
for a leaf on the CPU). The normal draws are whole leaves at once: the
reference's chunked form only starts at ``CHUNK_ELEMS = 1 << 62`` elements,
so it never runs. A DTensor leaf (the sharded train step, ``launch/
sharding.py``) draws on each rank only its own shard of the leaf's
direction, bitwise the slice of the whole draw (``leaf_normal_like``), and
its axpys run on the local shards. Draws are float32 (within a few ulp of
the reference's) or bfloat16 (bitwise).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.utils import prng
from repro_torch.utils.flatparams import _leaves
from repro_torch.utils.shardutil import is_dtensor


def tree_leaves(tree) -> list:
    """The leaf tensors in jax's order."""
    return [leaf for _, leaf in _leaves(tree)]


def tree_unflatten(paths, leaves) -> dict:
    """Nested dict from key paths (``_leaves`` order) and their leaves."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, tree, *rest) -> dict:
    """``fn`` over the leaves of same-structured nested dicts; a None
    subtree stays None (jax's node without leaves)."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else None if v is None else fn(v, *(r[k] for r in rest))
            for k, v in tree.items()}


def tree_size(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(leaf.numel() for leaf in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(tree))


def tree_axpy(a, x_tree, y_tree):
    """y + a·x leafwise in float32, each leaf cast back to y's dtype: one
    ``zo_axpy`` launch per leaf. ``a`` a scalar or a one-element tensor
    (on the card, a float32 tensor there: the kernel reads it)."""
    return tree_map(lambda x, y: kops.axpy(y, x, a), x_tree, y_tree)


def tree_axpy_plain(a, x_tree, y_tree):
    """y + a·x leafwise in plain torch ops (no kernel), each leaf cast back
    to y's dtype: the reference's ``tree_axpy`` arithmetic, for the
    first-order updates (FedAvg's SGD step, the optimizers)."""
    return tree_map(lambda x, y: (y + a * x).to(y.dtype), x_tree, y_tree)


def tree_add(x_tree, y_tree):
    return tree_map(torch.add, x_tree, y_tree)


def tree_sub(x_tree, y_tree):
    return tree_map(torch.sub, x_tree, y_tree)


def tree_scale(a, tree):
    return tree_map(lambda x: (a * x).to(x.dtype), tree)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _stack_sum(parts):
    return torch.sum(torch.stack(parts))


def tree_dot(x_tree, y_tree):
    """Global inner product <x, y> over all leaves: a float32 sum per leaf,
    then the sum of the leaves' sums."""
    return _stack_sum([torch.sum(x.float() * y.float()) for x, y in
                       zip(tree_leaves(x_tree), tree_leaves(y_tree))])


def tree_sq_norm(tree):
    return _stack_sum([torch.sum(torch.square(x.float()))
                       for x in tree_leaves(tree)])


def tree_norm(tree):
    return torch.sqrt(tree_sq_norm(tree))


def tree_stack(trees):
    """Stack identically-structured trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree, n):
    return [tree_map(lambda x: x[i], tree) for i in range(n)]


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def leaf_normal(key, shape, dtype=torch.float32, *, device=None,
                impl=None):
    """N(0,1) of ``shape`` from ``key`` in ``dtype``, drawn on ``device``:
    ``jax.random.normal`` (float32 within a few ulp, bfloat16 bitwise).
    ``impl``: the key's (``utils/prng.py``), here and below."""
    return prng.normal(key, shape, dtype=dtype, device=device, impl=impl)


def leaf_normal_like(key, leaf, dtype=torch.float32, impl=None):
    """``leaf_normal(key, leaf.shape)`` on the leaf's device; for a DTensor
    leaf a DTensor of the leaf's layout whose every rank draws only its
    own shard, from the shard's flat indices (``prng.normal_shard``):
    bitwise the slice of the whole draw."""
    if not is_dtensor(leaf):
        return leaf_normal(key, leaf.shape, dtype, device=leaf.device,
                           impl=impl)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    prng.impl_of(key, impl)
    shape = tuple(leaf.shape)
    local_shape, offset = compute_local_shape_and_global_offset(
        shape, leaf.device_mesh, leaf.placements)
    g = prng.normal_shard(key, shape, offset, local_shape, dtype=dtype,
                          device=leaf.to_local().device)
    return DTensor.from_local(g, leaf.device_mesh, leaf.placements,
                              run_check=False, shape=leaf.shape,
                              stride=leaf.stride())


def add_leaf_normal(x, key, coef, dtype=torch.float32, impl=None):
    """x + coef·N(0,1)(key), cast to x's dtype."""
    g = leaf_normal_like(key, x, dtype, impl=impl)
    return (x + coef * g).to(x.dtype)


def normal_like_tree(rng, tree, dtype=None, impl=None):
    """One i.i.d. N(0,1) sample per parameter, leaf i from
    ``fold_in(rng, i)``, each on its leaf's device."""
    pairs = _leaves(tree)
    return tree_unflatten(
        [p for p, _ in pairs],
        [leaf_normal_like(prng.fold_in(rng, i, impl), leaf,
                          dtype or leaf.dtype, impl=impl)
         for i, (_, leaf) in enumerate(pairs)])


def tree_random_sq_norm(rng, tree, dtype=torch.float32, impl=None):
    """‖normal_like_tree(rng, tree)‖², summed leaf by leaf in order,
    without keeping the tree."""
    leaves = tree_leaves(tree)
    total = None
    for i, leaf in enumerate(leaves):
        g = leaf_normal_like(prng.fold_in(rng, i, impl), leaf, dtype, impl)
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return total


def tree_add_normal(tree, rng, coef, dtype=torch.float32, impl=None):
    """tree + coef·g(rng), leaf by leaf (g never whole)."""
    pairs = _leaves(tree)
    return tree_unflatten(
        [p for p, _ in pairs],
        [add_leaf_normal(leaf, prng.fold_in(rng, i, impl), coef, dtype,
                         impl)
         for i, (_, leaf) in enumerate(pairs)])


def sphere_like_tree(rng, tree, dtype=torch.float32, impl=None):
    """v ~ U(S^{d-1}) over the whole flattened parameter vector (paper
    Eq. 2): g/‖g‖ with g ~ N(0, I_d) and the norm taken across all
    leaves."""
    g = normal_like_tree(rng, tree, dtype=dtype, impl=impl)
    inv = 1.0 / (tree_norm(g) + 1e-30)
    return tree_scale(inv, g)
