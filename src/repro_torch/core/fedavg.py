"""FedAvg (McMahan et al. 2017): the paper's first-order baseline (Sec.
V-B, Figs. 3-5).

Counterpart of ``repro/core/fedavg.py``: the round of FedZO with the
zeroth-order update replaced by an SGD step on the gradient. The reference
takes ``jax.value_and_grad`` of the loss (``jax.vmap`` of it over the
clients of a round); here the gradient is ``torch.autograd`` of the loss.
The dense LM's and the transformer track's RMSNorm and attention run their
kernels forward and differentiate through the plain versions
(``kernels/ops.py``: ``autograd.Function``s whose backward recomputes the
plain version), as ``jax.grad`` differentiates the reference's jnp math.

The clients of a round run side by side: a loss that carries its
client-batched form (``loss.batched``: the LM and the transformer track)
takes the cohort's stacked ``[M, ...]`` weights in one forward and the
gradient of the sum of its ``[M]`` losses; client rows never mix, so row m
of that gradient is client m's own, and each RMSNorm and attention is one
launch whatever M is. Any other loss (softmax, CNN: no kernel) goes through
``torch.func.vmap(torch.func.grad_and_value(loss))``.

Parameters handed back never require a gradient: each step's new weights
are computed from detached tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core.aircomp import (aircomp_aggregate, mask_stats,
                                      schedule_by_channel)
from repro_torch.core.estimator import _device
from repro_torch.utils import prng
from repro_torch.utils.flatparams import _leaves
from repro_torch.utils.shardutil import (is_dtensor, on_dtensors,
                                         reduce_fanout_partials)
from repro_torch.utils.tree import (tree_add, tree_axpy_plain, tree_map,
                                    tree_scale, tree_sub, tree_unflatten)


def value_and_grad(loss_fn, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)`` by autograd, both
    detached. The loss may be a scalar or a vector (``[M]`` cohort losses:
    the gradient is then that of their sum). A DTensor leaf's gradient is
    laid out as the leaf (DTensor's backward leaves a replicated leaf's
    gradient a partial sum, or sharded where the leaf is not): its partial
    sums reduced, as jit gives a gradient its parameter's sharding, so the
    updated parameters keep their layout."""
    pairs = _leaves(params)
    leaves = [leaf.detach().requires_grad_() for _, leaf in pairs]
    loss = loss_fn(tree_unflatten([p for p, _ in pairs], leaves), batch)
    total = loss.sum()
    if is_dtensor(total):
        reduce_fanout_partials(total)
    with on_dtensors(leaves):   # a sharded forward's backward
        grads = torch.autograd.grad(total, leaves)
    grads = [g.redistribute(g.device_mesh, leaf.placements)
             if is_dtensor(g) and tuple(g.placements) != tuple(
                 leaf.placements) else g for g, leaf in zip(grads, leaves)]
    return loss.detach(), tree_unflatten([p for p, _ in pairs], grads)


def local_phase(loss_fn, params, batches, cfg: FedZOConfig):
    """H SGD steps of one client (``batches`` leaves ``[H, ...]``): returns
    (final params, losses ``[H]``)."""
    p, losses = params, []
    for h in range(cfg.local_iters):
        loss, g = value_and_grad(loss_fn, p,
                                 tree_map(lambda v: v[h], batches))
        p = tree_axpy_plain(-cfg.lr, g, p)
        losses.append(loss)
    return p, torch.stack(losses)


def cohort_phase(loss_fn, server_params, client_batches, cfg: FedZOConfig):
    """The M clients' local phases side by side from ``server_params``
    (``client_batches`` leaves ``[M, H, ...]``): returns (stacked final
    params ``[M, ...]``, losses ``[M, H]``)."""
    M = next(iter(_leaves(client_batches)))[1].shape[0]
    return cohort_rows(loss_fn, tree_map(
        lambda x: x.expand((M,) + x.shape).clone(), server_params),
        client_batches, cfg)


def cohort_rows(loss_fn, p, client_batches, cfg: FedZOConfig, lr=None):
    """The local phases of the R rows of the stacked params ``p`` (leaves
    ``[R, ...]``), row r on ``client_batches[r]`` (leaves ``[R, H, ...]``):
    a batched sweep's ``[S·M]`` scenarios × clients, each row from its
    scenario's params, with ``lr`` float64 ``[R]`` its step size (None:
    ``cfg.lr``), rounded to float32 as a Python scalar would be. Returns
    (final params ``[R, ...]``, losses ``[R, H]``)."""
    fn = getattr(loss_fn, "batched", None)
    vg = (None if fn is not None else
          torch.func.vmap(torch.func.grad_and_value(loss_fn)))
    rows = None if lr is None else torch.tensor(
        np.asarray(-lr, np.float32), device=_leaves(p)[0][1].device)

    def sgd(g, v):   # tree_axpy_plain's y + a·x, a per row
        a = -cfg.lr if rows is None else rows.reshape(
            (-1,) + (1,) * (v.dim() - 1))
        return (v + a * g).to(v.dtype)

    losses = []
    for h in range(cfg.local_iters):
        batch = tree_map(lambda v: v[:, h], client_batches)
        if fn is not None:
            loss, g = value_and_grad(fn, p, batch)
        else:
            g, loss = vg(p, batch)
        p = tree_map(sgd, g, p)
        losses.append(loss)
    return p, torch.stack(losses, 1)


def round_simulated(loss_fn, server_params, client_batches, cfg: FedZOConfig,
                    *, channel_rng=None, weights=None, faults=None,
                    channel=None, impl=None):
    """One FedAvg round over the M clients of ``client_batches`` (leaves
    ``[M, H, ...]`` on the parameters' device). ``channel_rng`` a raw key
    (CPU); ``weights`` ``[M]`` mean-1 size weights. The aggregation follows
    the reference branch for branch: channel-truncation scheduling
    (``cfg.channel_schedule``; a realized ``channel``'s transmit mask in
    its place), ``faults`` corrupting and scrubbing the stacked deltas in
    place (``sim.faults.RoundFaults``), AirComp on the stacked delta tree,
    the masked and/or size-weighted mean, else ``(1/M)·Σ_i Δ_i``. ``impl``
    is ``channel_rng``'s ``prng.Impl`` (None: threefry). Returns
    (new_params, metrics)."""
    dev = _device(server_params)
    p_fin, losses = cohort_phase(loss_fn, server_params, client_batches, cfg)
    deltas = tree_sub(p_fin, server_params)
    M = losses.shape[0]
    mask = None
    noise_rng = channel_rng
    stats = {}
    if cfg.channel_schedule and channel_rng is not None:
        ks = prng.split(channel_rng, 2, impl)
        k_sched, noise_rng = ks[0], ks[1]
        if channel is None:
            _, mask = schedule_by_channel(k_sched, M, cfg.h_min, impl)
            mask = mask.to(dev)
    if channel is not None:
        mask = channel.mask.to(dev)
    if faults is not None:
        deltas, fmask = faults.apply_tree(deltas)
        mask = fmask if mask is None else mask & fmask
    if cfg.aircomp and channel_rng is not None:
        agg, stats = aircomp_aggregate(deltas, noise_rng, snr_db=cfg.snr_db,
                                       h_min=cfg.h_min, mask=mask,
                                       weights=weights, impl=impl)
    elif mask is not None or weights is not None:
        maskf, m_div, m_sched = mask_stats(mask, M, weights, device=dev)
        agg = tree_map(
            lambda x: (torch.einsum("m...,m->...", x.to(torch.float32),
                                    maskf) / m_div).to(x.dtype), deltas)
        stats = {"m_effective": m_sched}
    else:
        agg = tree_scale(1.0 / M, tree_map(lambda x: torch.sum(x, 0), deltas))
    if faults is not None:
        stats["m_corrupt"] = faults.n_corrupt.to(dev)
    return tree_add(server_params, agg), {"mean_local_loss": torch.mean(losses),
                                          **stats}


def make_train_step(loss_fn, cfg: FedZOConfig):
    """Cross-silo first-order step: ``(params, batch, rng) -> (params,
    {"loss"})``, one SGD step of ``cfg.lr`` on the autograd gradient."""
    def step(params, batch, rng):
        del rng
        loss, g = value_and_grad(loss_fn, params, batch)
        return tree_axpy_plain(-cfg.lr, g, params), {"loss": loss}

    return step
