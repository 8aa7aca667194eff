"""Stochastic zeroth-order estimators (paper Sec. II-B, Eq. 2).

Counterpart of ``repro/core/estimator.py``. With b2 directions v_n the
coefficients are

    c_n = scale·(L(x + μ·v_n) − L(x))/μ          (one-sided)
    c_n = scale·(L(x + μ·v_n) − L(x − μ·v_n))/2μ (central)

with scale = d for the sphere and coordinate estimators and 1 for
gaussian/rademacher, and the update x + s·Σ_n c_n·v_n/b2 replays the same
directions from the same keys. Directions are never kept between uses.

Three parts, as in the reference:

- **The pytree route** (``coefficients``, ``apply_coefficients``): each
  direction is a materialized tree, regenerated per use from
  ``fold_in(rng, n)`` (``conv="tree"``: per-leaf keys ``fold_in(., i)``,
  ``utils/tree.py``) or from the flat counter convention
  (``conv="counter"``). Every perturbation and every replayed update is
  one ``zo_axpy`` launch per leaf (``utils/tree.tree_axpy``).
- **The flat route** (``flat_*``): directions regenerated inside the
  walk/replay/norm kernels from the counter convention. Everything is
  batched over the leading client dimension: ``buf`` is ``[M, n_pad]``,
  ``keys`` ``[M, 2]`` on the buffer's device, and ``loss_fn`` maps a dict
  of ``[M, ...]`` parameters and a batch of ``[M, ...]`` leaves to ``[M]``
  losses.
- **The wide route's direction blocks** (``direction_block``): all b2
  directions of an iterate as one ``[..., b2, n_pad]`` tensor for a batch
  of client keys at once: the torch Threefry chain for threefry keys, one
  ``philox_bits`` launch (a batched draw from the first client's key, as
  under the reference's client vmap) for rbg and unsafe_rbg keys.

Every function takes its key's ``impl`` (``utils/prng.py``; None:
threefry). The flat route's kernels read words 0–1 of any key
(``prng.counter_words``), as the reference's ``counter_gen`` does.

The operation order is the reference's, so the float32 roundings agree:
``scale·(lp − base)/μ``, ``scale·c_n/b2`` and ``(scale/b2)·coeffs·inv``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.zo_axpy import counter_direction_flat
from repro_torch.utils import prng
from repro_torch.utils.flatparams import (FlatSpec, _leaves, flat_spec,
                                          unflatten)
from repro_torch.utils.tree import (normal_like_tree, sphere_like_tree,
                                    tree_add_normal, tree_axpy,
                                    tree_random_sq_norm, tree_size,
                                    tree_unflatten, tree_zeros_like)

# estimator kind -> counter-convention generator kind (coordinate directions
# have no streaming generator; the flat path rejects them)
COUNTER_KINDS = {"sphere": "normal", "gaussian": "normal",
                 "rademacher": "sign"}


def _scale_factor(d, kind):
    # unbiasedness factor: d for sphere/coordinate, 1 for gaussian/rademacher
    return 1.0 if kind in ("gaussian", "rademacher") else float(d)


def _counter_kind(kind):
    ck = COUNTER_KINDS.get(kind)
    if ck is None:
        raise ValueError(f"flat path does not support kind={kind!r}")
    return ck


# ---------------------------------------------------------------------------
# pytree route


def _device(params):
    return _leaves(params)[0][1].device


def sample_direction(rng, params, kind: str, dtype=torch.float32,
                     impl=None):
    """One direction tree v shaped like ``params`` (``rng`` a raw key on
    the CPU; leaves on their parameter's device)."""
    if kind == "sphere":
        return sphere_like_tree(rng, params, dtype=dtype, impl=impl)
    if kind == "gaussian":
        return normal_like_tree(rng, params, dtype=dtype, impl=impl)
    pairs = _leaves(params)
    paths = [p for p, _ in pairs]
    if kind == "rademacher":
        return tree_unflatten(paths, [
            prng.rademacher(prng.fold_in(rng, i, impl), leaf.shape,
                            dtype=dtype, device=leaf.device, impl=impl)
            for i, (_, leaf) in enumerate(pairs)])
    if kind == "coordinate":
        # one-hot at a uniformly random flat index, built leafwise
        idx = int(prng.randint(rng, (), 0, tree_size(params), impl=impl))
        out, off = [], 0
        for _, leaf in pairs:
            n = leaf.numel()
            flat = torch.arange(n, device=leaf.device) == idx - off
            out.append(flat.reshape(leaf.shape).to(dtype))
            off += n
        return tree_unflatten(paths, out)
    raise ValueError(f"unknown estimator kind {kind!r}")


def counter_direction(rng, n, params, kind, dtype=torch.float32):
    """Direction tree v_n under the flat counter convention: the elements
    ``zo_walk``/``zo_replay`` regenerate, cut into the leaves (the sphere
    norm over the valid length d)."""
    ck = COUNTER_KINDS.get(kind)
    if ck is None:
        raise ValueError(f"counter convention does not support {kind!r}")
    spec = flat_spec(params)
    g = counter_direction_flat(prng.counter_words(rng).to(_device(params)),
                               n, spec.d, kind=ck)
    if kind == "sphere":
        g = g * (1.0 / (torch.sqrt(torch.sum(g * g)) + 1e-30))
    return tree_unflatten(spec.paths, [
        g[off:off + sz].reshape(shp).to(dtype)
        for shp, off, sz in zip(spec.shapes, spec.offsets, spec.sizes)])


def _direction(rng, n, params, kind, dtype, conv, impl=None):
    if conv == "counter":
        return counter_direction(rng, n, params, kind, dtype)
    return sample_direction(prng.fold_in(rng, n, impl), params, kind, dtype,
                            impl)


def _perturb_mu(mu, direction_dtype):
    """The reference perturbs by ``mu * v`` with ``mu`` a Python float, which
    takes v's dtype: a bfloat16 direction moves by bf16(μ)·v (XLA keeps the
    product in float32)."""
    return float(torch.tensor(mu, dtype=direction_dtype))


def stream_perturb(params, key, mag, kind="sphere", dtype=torch.float32,
                   impl=None):
    """params + mag·v(key) without keeping v: leaf by leaf (the sphere norm
    first, from its own pass over the draws)."""
    if kind == "coordinate":
        return tree_axpy(mag, sample_direction(key, params, kind, impl=impl),
                         params)
    if kind == "sphere":
        inv = 1.0 / (torch.sqrt(tree_random_sq_norm(key, params, dtype,
                                                    impl)) + 1e-30)
        return tree_add_normal(params, key, mag * inv, dtype, impl)
    return tree_add_normal(params, key, mag, dtype, impl)  # gaussian


def coefficients(loss_fn, params, batch, rng, *, mu, b2, kind="sphere",
                 base_loss=None, direction_dtype=torch.float32,
                 central=False, conv="tree", impl=None):
    """The b2 coefficients c_n = scale·(L(x+μ v_n) − L(x))/μ (float32
    ``[b2]``) and the base loss. ``loss_fn(params, batch) -> scalar``;
    ``rng`` a raw key on the CPU. Each perturbed point is one ``zo_axpy``
    per leaf, with μ read by the kernel from a tensor on the device."""
    scale = _scale_factor(tree_size(params), kind)
    base = loss_fn(params, batch) if base_loss is None else base_loss
    mu_t = torch.full((), _perturb_mu(mu, direction_dtype),
                      dtype=torch.float32, device=_device(params))
    coeffs = []
    for n in range(b2):
        v = _direction(rng, n, params, kind, direction_dtype, conv, impl)
        lp = loss_fn(tree_axpy(mu_t, v, params), batch)
        if central:
            lm = loss_fn(tree_axpy(-mu_t, v, params), batch)
            c = scale * (lp - lm).to(torch.float32) / (2 * mu)
        else:
            c = scale * (lp - base).to(torch.float32) / mu
        coeffs.append(c)
    return torch.stack(coeffs), base


def apply_coefficients(params, rng, coeffs, *, scale=1.0, kind="sphere",
                       direction_dtype=torch.float32, conv="tree",
                       impl=None):
    """params + scale·Σ_n coeffs[n]·v_n/b2, replaying each v_n in
    ascending n: one ``zo_axpy`` per leaf and direction, its scalar
    ``scale·coeffs[n]/b2`` a tensor on the device."""
    b2 = coeffs.shape[0]
    p = params
    for n in range(b2):
        v = _direction(rng, n, params, kind, direction_dtype, conv, impl)
        p = tree_axpy(scale * coeffs[n] / b2, v, p)
    return p


# ---------------------------------------------------------------------------
# flat route


def flat_inv_norms(keys, spec: FlatSpec, b2, kind, *, block_rows=None):
    """``[M, b2]`` per-direction factors: 1/‖g_n‖ for sphere, else ones."""
    if kind != "sphere":
        return torch.ones((keys.shape[0], b2), dtype=torch.float32,
                          device=keys.device)
    sq = kops.zo_dirnorms(keys, spec.d, b2=b2, kind="normal",
                          block_rows=block_rows)
    return 1.0 / (torch.sqrt(sq) + 1e-30)


def flat_coefficients(loss_fn, buf, spec: FlatSpec, batch, keys, *, mu, b2,
                      kind="sphere", central=False,
                      block_rows=None, inv=None):
    """Fused MeZO-style perturbation walk: ``[M, b2]`` coefficients and the
    ``[M]`` base losses.

    Each step moves x+μv_{n-1} to x+μv_n with one zo_walk (a = −μ·inv[n−1],
    b = +μ·inv[n]): one read and one write of the buffer per direction.
    ``mu`` is a scalar or one value per row (``[M]``, a batched sweep's
    scenarios).
    """
    ck = _counter_kind(kind)
    scale = _scale_factor(spec.d, kind)
    base = loss_fn(unflatten(buf, spec), batch)
    if inv is None:
        inv = flat_inv_norms(keys, spec, b2, kind, block_rows=block_rows)
    mu = torch.as_tensor(mu, dtype=torch.float32).to(buf.device)
    xp, coeffs = buf, []
    for n in range(b2):
        prev = max(n - 1, 0)
        # state entering step n: x (n=0); x+μv_{n-1} (one-sided, n>0);
        # x−μv_{n-1} (central, n>0) — remove it and add +μv_n in one pass
        a = torch.zeros_like(inv[:, 0]) if n == 0 \
            else (mu if central else -mu) * inv[:, prev]
        b = mu * inv[:, n]
        xp = kops.zo_walk(xp, keys, (prev, n), torch.stack([a, b], dim=1),
                          kind=ck)
        lp = loss_fn(unflatten(xp, spec), batch)
        if central:
            ab = torch.stack([-2 * mu * inv[:, n], torch.zeros_like(a)], 1)
            xp = kops.zo_walk(xp, keys, (n, n), ab, kind=ck)
            lm = loss_fn(unflatten(xp, spec), batch)
            c = scale * (lp - lm).to(torch.float32) / (2 * mu)
        else:
            c = scale * (lp - base).to(torch.float32) / mu
        coeffs.append(c)
    return torch.stack(coeffs, dim=1), base


def flat_apply_coefficients(buf, spec: FlatSpec, keys, coeffs, *, scale=1.0,
                            kind="sphere", block_rows=None, inv=None):
    """buf + scale·Σ_n coeffs[:, n]·v_n/b2 in a single pass (zo_replay);
    ``scale`` a scalar or one value per row (``[M]``)."""
    ck = _counter_kind(kind)
    b2 = coeffs.shape[1]
    if inv is None:
        inv = flat_inv_norms(keys, spec, b2, kind, block_rows=block_rows)
    s = torch.as_tensor(scale, dtype=torch.float32).to(buf.device)
    s = (s[:, None] if s.dim() else s) / b2
    eff = s * coeffs.to(torch.float32) * inv
    return kops.zo_replay(buf, keys, eff, kind=ck)


# ---------------------------------------------------------------------------
# the wide route's direction blocks


def direction_block(rng, spec: FlatSpec, b2, *, kind="sphere", conv="block",
                    like=None, device=None, impl=None):
    """All b2 directions of one iterate as ONE float32 ``[..., b2, n_pad]``
    block and the ``[..., b2]`` float32 factors (1/‖g_n‖ for sphere over
    the valid ``[:d]`` columns, ones otherwise), drawn on ``device``.

    ``rng`` is a raw key ``[words]`` or a batch of client keys ``[M,
    words]`` (CPU) of ``impl``; a batch draws every client's block in one
    call per leaf or block (leading ``[M]`` on both outputs), under the
    reference's client vmap: per key for threefry, one batched draw from
    the first key for rbg and unsafe_rbg. The conventions are the
    reference's:

    - ``block``: one ``normal``/``rademacher`` draw over ``(b2, n_pad)``
      (pad columns carry generator residue; ``unflatten`` drops them).
    - ``tree``: direction n from ``fold_in(rng, n)`` and its leaf i from
      ``fold_in(., i)``, flattened with zero padding: the pytree route's
      directions. The b2 keys are the fold-in vmapped over n
      (``prng.fold_in_range``: ``split(rng, b2)`` for threefry and rbg, a
      batched draw for unsafe_rbg). Needs ``like`` (a parameter tree
      matching ``spec``).
    - ``channel``: the gaussian block of ``split(rng)[0]`` (the one-point
      wireless estimator); ``inv`` is ones whatever ``kind`` says.
    """
    if kind == "coordinate":
        raise ValueError("batched-direction path does not support "
                         "kind='coordinate'")
    lead = tuple(rng.shape[:-1])
    if conv == "channel":
        kr = prng.split(rng, 2, impl)[..., 0, :]
        V = prng.normal(kr, (b2, spec.n_pad), device=device, impl=impl)
        return V, torch.ones(lead + (b2,), dtype=torch.float32,
                             device=V.device)
    if conv == "tree":
        if like is None:
            raise ValueError("conv='tree' direction blocks need the params "
                             "pytree (like=...) for per-leaf key derivation")
        keys = prng.fold_in_range(rng, b2, impl)            # [..., b2, w]
        parts = []
        for i, (_, leaf) in enumerate(_leaves(like)):
            ki = prng.fold_in(keys, i, impl)
            g = (prng.rademacher(ki, leaf.shape, device=device, impl=impl)
                 if kind == "rademacher" else
                 prng.normal(ki, leaf.shape, device=device, impl=impl))
            parts.append(g.reshape(lead + (b2, -1)))
        if spec.n_pad > spec.d:
            parts.append(parts[0].new_zeros(lead + (b2, spec.n_pad - spec.d)))
        V = torch.cat(parts, dim=-1)
    elif conv == "block":
        V = (prng.rademacher(rng, (b2, spec.n_pad), device=device,
                             impl=impl)
             if kind == "rademacher" else
             prng.normal(rng, (b2, spec.n_pad), device=device, impl=impl))
    else:
        raise ValueError(f"unknown direction block conv {conv!r}")
    if kind == "sphere":
        inv = 1.0 / (torch.linalg.vector_norm(V[..., :spec.d], dim=-1)
                     + 1e-30)
    else:
        inv = torch.ones(lead + (b2,), dtype=torch.float32, device=V.device)
    return V, inv


# ---------------------------------------------------------------------------
# materialized estimates


def estimate(loss_fn, params, batch, rng, *, mu, b2, kind="sphere",
             impl=None):
    """The materialized gradient-estimate tree of Eq. 2, ``(1/b2)·Σ_n
    c_n·v_n``: the coefficients, then their replay onto zeros (two tree
    passes per direction). For tests and paper-scale checks."""
    coeffs, _ = coefficients(loss_fn, params, batch, rng, mu=mu, b2=b2,
                             kind=kind, impl=impl)
    return apply_coefficients(tree_zeros_like(params), rng, coeffs,
                              kind=kind, impl=impl)


def two_point_estimate(loss_fn, params, batch, rng, *, mu, kind="sphere",
                       impl=None):
    """The classic two-point estimator, the b1 = b2 = 1 case the DZOPA and
    ZONE-S baselines start from."""
    return estimate(loss_fn, params, batch, rng, mu=mu, b2=1, kind=kind,
                    impl=impl)
