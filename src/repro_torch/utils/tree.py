"""Helpers over parameter trees: nested dicts of tensors.

Counterpart of ``repro/utils/tree.py``, the workhorses of the pytree FedZO
route (``core/estimator.py``). Leaf order is jax's: keys sorted at every
level (``utils/flatparams._leaves``), so leaf i here is leaf i of
``jax.tree.flatten`` on the same dict, and the per-leaf keys
``fold_in(rng, i)`` draw the reference's directions.

``tree_axpy`` runs the ``zo_axpy`` kernel on every leaf (its plain version
for a leaf on the CPU). The normal draws are whole leaves at once: the
reference's chunked form only starts at ``CHUNK_ELEMS = 1 << 62`` elements,
so it never runs. Draws are float32 (within a few ulp of the reference's)
or bfloat16 (bitwise).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.utils import prng
from repro_torch.utils.flatparams import _leaves


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


def add_leaf_normal(x, key, coef, dtype=torch.float32, impl=None):
    """x + coef·N(0,1)(key), cast to x's dtype."""
    g = leaf_normal(key, x.shape, dtype, device=x.device, impl=impl)
    return (x + coef * g).to(x.dtype)


def leaf_normal_sq_norm(key, shape, dtype=torch.float32, *, device=None,
                        impl=None):
    """‖N(0,1)(key)‖² in float32."""
    g = leaf_normal(key, shape, dtype, device=device, impl=impl)
    return torch.sum(torch.square(g.float()))


def normal_like_tree(rng, tree, dtype=None, impl=None):
    """One i.i.d. N(0,1) sample per parameter, leaf i from
    ``fold_in(rng, i)``, each on its leaf's device."""
    pairs = _leaves(tree)
    return tree_unflatten(
        [p for p, _ in pairs],
        [leaf_normal(prng.fold_in(rng, i, impl), leaf.shape,
                     dtype or leaf.dtype, device=leaf.device, impl=impl)
         for i, (_, leaf) in enumerate(pairs)])


def tree_random_sq_norm(rng, tree, dtype=torch.float32, impl=None):
    """‖normal_like_tree(rng, tree)‖², summed leaf by leaf in order,
    without keeping the tree."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i, leaf in enumerate(leaves):
        total = total + leaf_normal_sq_norm(
            prng.fold_in(rng, i, impl), leaf.shape, dtype,
            device=leaf.device, impl=impl)
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
