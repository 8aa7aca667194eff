"""Distributed zeroth-order baselines the paper compares against (Figs.
1-2).

Counterpart of ``repro/core/baselines.py:26-92``:

- ZO-SGD (Ghadimi & Lan 2013): centralized stochastic ZO, the speedup
  reference point of Table I.
- DZOPA (Yi et al. 2021): peer-to-peer distributed ZO, one ZO update and
  one consensus-mixing step per iteration, on a fully-connected graph
  (mixing = uniform averaging), with the mini-batch estimator of Eq. (2).
- ZONE-S (Hajinezhad et al. 2019): one sampled agent per iteration with
  penalty ρ, in its practical form x ← x − (1/ρ)·e_i.

Each runs the pytree estimator on the direction convention asked
(``tree`` or ``counter``): every perturbation and update is one ``zo_axpy``
per leaf. DZOPA's N agents run one after another where the reference
vmaps them: each agent draws as its row of the vmap (``prng.lanes``: under
rbg keys its slice of one draw from the first agent's key). Every step
takes its keys' ``impl`` (``utils/prng.py``; None: threefry).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import estimator
from repro_torch.core.fedzo import _DIRECTION_DTYPES
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_map, tree_stack


def zo_sgd_step(loss_fn, params, batch, rng, *, lr, mu, b2=1, kind="sphere",
                conv="tree", direction_dtype=torch.float32, impl=None):
    """Centralized ZO-SGD step: (new params, base loss). ``rng`` a raw key
    (CPU) of ``impl``."""
    coeffs, base = estimator.coefficients(
        loss_fn, params, batch, rng, mu=mu, b2=b2, kind=kind,
        direction_dtype=direction_dtype, conv=conv, impl=impl)
    params = estimator.apply_coefficients(
        params, rng, coeffs, scale=-lr, kind=kind,
        direction_dtype=direction_dtype, conv=conv, impl=impl)
    return params, base


def dzopa_round(loss_fn, client_params, client_batches, client_rngs,
                cfg: FedZOConfig, impl=None):
    """One DZOPA iteration over all N agents (fully-connected mixing).

    ``client_params`` leaves ``[N, ...]`` (the agents' iterates),
    ``client_batches`` leaves ``[N, ...]``, ``client_rngs`` ``[N, words]``
    of ``impl``.
    Returns (new client params, mean loss): one ZO update per agent (H = 1
    by construction), directions per ``cfg.direction_conv`` and
    ``cfg.direction_dtype``, then every agent moves to the average."""
    n = client_rngs.shape[0]
    rows = prng.lanes(client_rngs, impl)
    updated, losses = [], []
    for i in range(n):
        p, base = zo_sgd_step(
            loss_fn, tree_map(lambda v: v[i], client_params),
            tree_map(lambda v: v[i], client_batches), rows[i],
            lr=cfg.lr, mu=cfg.mu, b2=cfg.b2, kind=cfg.estimator,
            conv=cfg.direction_conv,
            direction_dtype=_DIRECTION_DTYPES[cfg.direction_dtype],
            impl=impl)
        updated.append(p)
        losses.append(base)
    mixed = tree_map(
        lambda x: torch.mean(x, 0, keepdim=True).expand(x.shape).contiguous(),
        tree_stack(updated))
    return mixed, torch.mean(torch.stack(losses))


def zone_s_round(loss_fn, params, batch, rng, *, rho, mu, b2=1, kind="sphere",
                 conv="tree", direction_dtype=torch.float32, impl=None):
    """One ZONE-S iteration of the sampled agent (the caller samples it and
    its batch): x ← x − (1/ρ)·e_i with e_i its mini-batch ZO estimate."""
    coeffs, base = estimator.coefficients(
        loss_fn, params, batch, rng, mu=mu, b2=b2, kind=kind,
        direction_dtype=direction_dtype, conv=conv, impl=impl)
    params = estimator.apply_coefficients(
        params, rng, coeffs, scale=-1.0 / rho, kind=kind,
        direction_dtype=direction_dtype, conv=conv, impl=impl)
    return params, base
