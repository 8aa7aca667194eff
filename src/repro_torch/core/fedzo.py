"""FedZO (paper Algorithm 1): the pytree and flat-buffer routes.

Counterpart of ``repro/core/fedzo.py:51-116, 201-276, 339-449, 554-563``.
Two routes compute one local iterate x ← x − η·∇̃F(x), chosen by
``cfg.flat_params`` as in the reference:

- **The pytree route** (the reference's default, ``flat_params=False``):
  the estimator materializes each direction as a tree (``conv="tree"``:
  per-leaf Threefry keys; ``conv="counter"``: the flat convention cut into
  leaves), and every perturbation and replayed update is one ``zo_axpy``
  launch per leaf: 2·b2 per leaf and iterate. A round loops over its M
  clients (the reference vmaps them; ``torch.func.vmap`` cannot trace a
  kernel launch), each running H iterates on its own tree, and aggregates
  the stacked ``[M, ...]`` delta tree.
- **The flat route** (``flat_params=True``): the server parameters are
  flattened once per round into a padded float32 buffer; the M clients run
  their H iterates side by side on one ``[M, n_pad]`` buffer (the client
  axis is an explicit batch dimension, so one kernel launch covers the
  cohort): one ``zo_dirnorms``, b2 × (one ``zo_walk`` + one batched loss
  forward), one ``zo_replay``. The batched loss is the loss's own
  client-batched form where it has one (the dense LM: one RMSNorm and one
  attention launch per forward for all M clients), else
  ``torch.func.vmap``. The ``[M, n_pad]`` delta matrix is
  aggregated by a masked/weighted mean or by AirComp, then unflattened
  once.

The cross-silo unit, ``local_iterate`` / ``make_train_step``, is one
iterate on one client on either route; on the flat route it is a row of
the batched iterate. ``jax.grad`` has no counterpart here: FedZO is
forward-only.

Routes the port does not have yet raise ``NotImplementedError``: the
batched-direction (wide) local phase and the estimators that run on it,
seed-compressed uplinks, faults, the wireless channel model, and the
strategy hooks (client state, loss wraps, state functions).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import estimator
from repro_torch.core.aircomp import (aircomp_aggregate,
                                      aircomp_aggregate_flat, mask_stats,
                                      schedule_by_channel)
from repro_torch.utils import prng
from repro_torch.utils.flatparams import flat_geometry, flatten, unflatten
from repro_torch.utils.tree import (tree_add, tree_map, tree_scale,
                                    tree_stack, tree_sub)

_DIRECTION_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class LocalResult(NamedTuple):
    params: object         # x_i^{(t,H)}
    coeffs: torch.Tensor   # [H, b2] estimator coefficients
    losses: torch.Tensor   # [H] base losses along the trajectory


def check_route(cfg: FedZOConfig):
    """Reject every config the port cannot run as asked."""
    if cfg.batch_directions:
        raise NotImplementedError("the batched-direction (wide) local phase "
                                  "is not ported")
    if cfg.direction_conv in ("surrogate", "channel"):
        raise NotImplementedError(f"direction_conv={cfg.direction_conv!r} "
                                  "runs on the wide phase, not ported")
    if cfg.channel_model is not None:
        raise NotImplementedError("the wireless channel model is not ported")
    if cfg.delta_compression != "dense":
        raise NotImplementedError("seed-compressed uplinks are not ported")
    if (not cfg.flat_params and cfg.direction_conv == "tree"
            and cfg.direction_dtype != "float32"
            and cfg.estimator in ("sphere", "gaussian")):
        raise NotImplementedError(
            f"normal draws in direction_dtype={cfg.direction_dtype!r} on the "
            "tree convention are not ported (ROADMAP A, item 2)")
    if cfg.flat_params:
        estimator._counter_kind(cfg.estimator)


def batched_loss(loss_fn):
    """Map a one-client ``loss(params, batch)`` over a leading client axis
    of both the parameter dict and the batch: returns ``[M]`` losses.

    A loss that carries its client-batched form as ``loss_fn.batched`` (the
    dense LM's, ``models/api.py``) runs through it: one kernel launch per
    RMSNorm and attention for the whole cohort. Any other loss goes
    through ``torch.func.vmap``, which cannot trace a kernel launch (a
    vmapped tensor has no storage to hand the kernel) and serves the losses
    that launch none (softmax, CNN)."""
    return getattr(loss_fn, "batched", None) or torch.func.vmap(loss_fn)


def flat_local_iterate(loss_fn, buf, spec, batch, keys, cfg: FedZOConfig,
                       block_rows=None):
    """One ZO update of every row of ``buf`` ``[M, n_pad]``: the fused
    walk, then the single-pass replay. ``loss_fn`` is batched (``[M]``
    losses); ``keys`` ``[M, 2]`` on the buffer's device. The sphere
    inv-norms are computed once and shared by both ends."""
    inv = estimator.flat_inv_norms(keys, spec, cfg.b2, cfg.estimator,
                                   block_rows=block_rows)
    coeffs, base = estimator.flat_coefficients(
        loss_fn, buf, spec, batch, keys, mu=cfg.mu, b2=cfg.b2,
        kind=cfg.estimator, central=cfg.central, block_rows=block_rows,
        inv=inv)
    buf = estimator.flat_apply_coefficients(
        buf, spec, keys, coeffs, scale=-cfg.lr, kind=cfg.estimator,
        block_rows=block_rows, inv=inv)
    return buf, coeffs, base


def local_iterate(loss_fn, params, batch, rng, cfg: FedZOConfig):
    """One stochastic zeroth-order update (Eq. 5-6): x ← x − η ∇̃F(x).

    ``loss_fn(params, batch) -> scalar``; ``params`` a (nested) dict of
    tensors on the run's device; ``rng`` a raw key ``[2]`` (CPU). Returns
    (new_params, coeffs ``[b2]``, base_loss). On the flat route the
    parameters are flattened once, walked and replayed by the kernels, and
    unflattened once (leaves are views of the new buffer); on the pytree
    route every perturbation and update is a ``zo_axpy`` per leaf.
    """
    check_route(cfg)
    if cfg.flat_params:
        spec, br = flat_geometry(params, cfg.flat_block_rows)
        buf = flatten(params, spec)[None]
        keys = rng.reshape(1, 2).to(buf.device)

        def loss1(p, b):
            return loss_fn(tree_map(lambda v: v[0], p), b).reshape(1)

        buf, coeffs, base = flat_local_iterate(loss1, buf, spec, batch, keys,
                                               cfg, block_rows=br)
        return unflatten(buf[0], spec), coeffs[0], base[0]
    ddt = _DIRECTION_DTYPES[cfg.direction_dtype]
    coeffs, base = estimator.coefficients(
        loss_fn, params, batch, rng, mu=cfg.mu, b2=cfg.b2, kind=cfg.estimator,
        direction_dtype=ddt, central=cfg.central, conv=cfg.direction_conv)
    new_params = estimator.apply_coefficients(
        params, rng, coeffs, scale=-cfg.lr, kind=cfg.estimator,
        direction_dtype=ddt, conv=cfg.direction_conv)
    return new_params, coeffs, base


def make_train_step(loss_fn, cfg: FedZOConfig):
    """Cross-silo train step: one local ZO iterate.

    signature: (params, batch, rng) -> (params, metrics) with metrics
    ``loss`` (the base loss) and ``coeff_norm`` (‖coeffs‖₂).
    """
    def step(params, batch, rng):
        new_params, coeffs, base = local_iterate(loss_fn, params, batch,
                                                 rng, cfg)
        return new_params, {"loss": base,
                            "coeff_norm": torch.linalg.norm(coeffs)}

    return step


def _flat_phase_scan(loss_fn, buf0, spec, br, keys, batches, cfg):
    """H flat local iterates over ``buf0`` ``[M, n_pad]``. ``keys``
    ``[M, H, 2]``; ``batches`` leaves ``[M, H, ...]``. Returns (final buf,
    coeffs ``[M, H, b2]``, losses ``[M, H]``)."""
    buf, coeffs, losses = buf0, [], []
    for h in range(cfg.local_iters):
        batch = tree_map(lambda v: v[:, h], batches)
        buf, c, base = flat_local_iterate(loss_fn, buf, spec, batch,
                                          keys[:, h].contiguous(), cfg,
                                          block_rows=br)
        coeffs.append(c)
        losses.append(base)
    return buf, torch.stack(coeffs, 1), torch.stack(losses, 1)


def local_phase(loss_fn, params, batches, rng, cfg: FedZOConfig
                ) -> LocalResult:
    """H local iterates (Algorithm 1 inner loop) of one client.

    ``batches`` leaves carry a leading ``[H]`` axis; iterate h takes key
    ``split(rng, H)[h]``. On the flat route the tree is flattened once for
    the whole phase.
    """
    check_route(cfg)
    keys = prng.split(rng, cfg.local_iters)
    if cfg.flat_params:
        spec, br = flat_geometry(params, cfg.flat_block_rows)
        buf0 = flatten(params, spec)[None]
        buf, coeffs, losses = _flat_phase_scan(
            batched_loss(loss_fn), buf0, spec, br,
            keys[None].to(buf0.device), tree_map(lambda v: v[None], batches),
            cfg)
        return LocalResult(unflatten(buf[0], spec), coeffs[0], losses[0])
    p, coeffs, losses = params, [], []
    for h in range(cfg.local_iters):
        p, c, base = local_iterate(loss_fn, p, tree_map(lambda v: v[h],
                                                        batches),
                                   keys[h], cfg)
        coeffs.append(c)
        losses.append(base)
    return LocalResult(p, torch.stack(coeffs), torch.stack(losses))


def client_delta(loss_fn, params, batches, rng, cfg) -> tuple:
    """Δ_i = x_i^{(t,H)} − x^t plus the local phase's summary."""
    res = local_phase(loss_fn, params, batches, rng, cfg)
    return tree_sub(res.params, params), res


def round_simulated(loss_fn, server_params, client_batches, client_rngs,
                    cfg: FedZOConfig, *, channel_rng=None, momentum=None,
                    weights=None, faults=None, channel=None, cstate=None,
                    loss_wrap=None, state_fn=None):
    """One communication round over the M sampled clients.

    ``loss_fn(params, batch) -> scalar`` for one client; ``server_params``
    a (nested) dict of tensors on the run's device; ``client_batches``
    leaves ``[M, H, b1, ...]`` on that device; ``client_rngs`` ``[M, 2]``
    raw keys and ``channel_rng`` a raw key (both CPU). ``weights`` ``[M]``:
    mean-1 size weights. ``momentum`` a tree like the parameters (with
    ``cfg.server_momentum > 0``). Returns (new_params, metrics[,
    new_momentum]).

    The aggregation follows the reference on both routes: AirComp (Eq. 17)
    when ``cfg.aircomp``; else the masked (channel scheduling) and/or
    size-weighted mean; else the plain mean, which the pytree route takes
    as ``(1/M)·Σ_i Δ_i``.
    """
    for name, hook in (("faults", faults), ("channel", channel),
                       ("cstate", cstate), ("loss_wrap", loss_wrap),
                       ("state_fn", state_fn)):
        if hook is not None:
            raise NotImplementedError(f"round_simulated({name}=...) is not "
                                      f"ported")
    check_route(cfg)
    M = client_rngs.shape[0]
    dev = estimator._device(server_params)
    mask = None
    noise_rng = channel_rng
    air_stats = {}
    if cfg.channel_schedule and channel_rng is not None:
        ks = prng.split(channel_rng, 2)
        k_sched, noise_rng = ks[0], ks[1]
        _, mask = schedule_by_channel(k_sched, M, cfg.h_min)
        mask = mask.to(dev)

    if cfg.flat_params:
        spec, br = flat_geometry(server_params, cfg.flat_block_rows)
        buf0 = flatten(server_params, spec)
        keys = prng.split(client_rngs, cfg.local_iters).to(dev)  # [M, H, 2]
        buf, _, losses = _flat_phase_scan(
            batched_loss(loss_fn), buf0.expand(M, spec.n_pad).contiguous(),
            spec, br, keys, client_batches, cfg)
        deltas = buf - buf0

        if cfg.aircomp and channel_rng is not None:
            agg_flat, air_stats = aircomp_aggregate_flat(
                deltas, noise_rng, snr_db=cfg.snr_db, h_min=cfg.h_min,
                d=spec.d, mask=mask, weights=weights, block_rows=br)
        elif mask is not None or weights is not None:
            maskf, m_div, m_sched = mask_stats(mask, M, weights, device=dev)
            agg_flat = torch.einsum("mn,m->n", deltas, maskf) / m_div
            air_stats = {"m_effective": m_sched}
        else:
            agg_flat = torch.mean(deltas, dim=0)
        agg = unflatten(agg_flat, spec)
    else:
        deltas, losses = [], []
        for i in range(M):
            delta, res = client_delta(
                loss_fn, server_params,
                tree_map(lambda v: v[i], client_batches), client_rngs[i],
                cfg)
            deltas.append(delta)
            losses.append(res.losses)
        deltas, losses = tree_stack(deltas), torch.stack(losses)

        if cfg.aircomp and channel_rng is not None:
            agg, air_stats = aircomp_aggregate(
                deltas, noise_rng, snr_db=cfg.snr_db, h_min=cfg.h_min,
                mask=mask, weights=weights)
        elif mask is not None or weights is not None:
            maskf, m_div, m_sched = mask_stats(mask, M, weights, device=dev)
            agg = tree_map(
                lambda x: (torch.einsum("m...,m->...", x.to(torch.float32),
                                        maskf) / m_div).to(x.dtype), deltas)
            air_stats = {"m_effective": m_sched}
        else:
            agg = tree_scale(1.0 / M,
                             tree_map(lambda x: torch.sum(x, 0), deltas))

    if momentum is not None and cfg.server_momentum > 0:
        momentum = tree_map(
            lambda m, g: (cfg.server_momentum * m + g).to(m.dtype),
            momentum, agg)
        agg = momentum
    new_params = tree_add(server_params, agg)
    metrics = {"mean_local_loss": torch.mean(losses),
               "first_loss": torch.mean(losses[:, 0]), **air_stats}
    if momentum is not None:
        return new_params, metrics, momentum
    return new_params, metrics
