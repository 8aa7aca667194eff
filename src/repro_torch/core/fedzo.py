"""FedZO (paper Algorithm 1), flat-buffer branch.

Counterpart of ``repro/core/fedzo.py:74-130, 339-449`` with
``cfg.flat_params=True``. The server parameters are flattened once per
round into a padded fp32 buffer; the M sampled clients run their H local
iterates side by side on one ``[M, n_pad]`` buffer (the reference vmaps the
local phase over the clients; here the client axis is an explicit batch
dimension, so one kernel launch covers the cohort); the deltas form one
``[M, n_pad]`` matrix that is aggregated by a masked/weighted mean or by
AirComp, then unflattened once.

One local iterate is one ``zo_dirnorms`` (sphere norms), b2 × (one
``zo_walk`` + one loss forward over the M parameter sets), then one
``zo_replay``. ``jax.grad`` has no counterpart here: the path is forward-only.

The cross-silo mode's unit, ``local_iterate`` / ``make_train_step``
(``repro/core/fedzo.py:95-115, 554-563``), is the same flat iterate on ONE
client: a row of the batched iterate with the key reshaped to ``[1, 2]``
and the loss wrapped to return ``[1]``. It drives any (nested) parameter
dict, e.g. the dense transformer of ``models/api.py``.

Routes the port does not have yet raise ``NotImplementedError``: the pytree
and batched-direction (wide) local phases, faults, the wireless channel
model, and the strategy hooks (client state, loss wraps, state functions).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import estimator
from repro_torch.core.aircomp import (aircomp_aggregate_flat, mask_stats,
                                      schedule_by_channel)
from repro_torch.utils import prng
from repro_torch.utils.flatparams import flat_geometry, flatten, unflatten


class LocalResult(NamedTuple):
    buf: torch.Tensor      # [M, n_pad] x_i^{(t,H)}
    coeffs: torch.Tensor   # [M, H, b2] estimator coefficients
    losses: torch.Tensor   # [M, H] base losses along the trajectory


def check_flat_route(cfg: FedZOConfig):
    """Reject every config the port cannot run as asked."""
    if not cfg.flat_params:
        raise NotImplementedError("the pytree local phase is not ported; "
                                  "set cfg.flat_params=True")
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
    estimator._counter_kind(cfg.estimator)


def batched_loss(loss_fn):
    """Map a one-client ``loss(params, batch)`` over a leading client axis
    of both the parameter dict and the batch: returns ``[M]`` losses."""
    return torch.func.vmap(loss_fn)


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


def _first_row(tree):
    """Leaves ``[1, ...]`` -> ``[...]`` (views), through nested dicts."""
    return {k: _first_row(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def local_iterate(loss_fn, params, batch, rng, cfg: FedZOConfig):
    """One stochastic zeroth-order update (Eq. 5-6): x ← x − η ∇̃F(x).

    ``loss_fn(params, batch) -> scalar``; ``params`` a (nested) dict of
    tensors on the run's device; ``rng`` a raw key ``[2]``. Returns
    (new_params, coeffs ``[b2]``, base_loss). Flat route only: the
    parameters are flattened once, walked and replayed by the kernels, and
    unflattened once (leaves are views of the new buffer).
    """
    check_flat_route(cfg)
    spec, br = flat_geometry(params, cfg.flat_block_rows)
    buf = flatten(params, spec)[None]
    keys = rng.reshape(1, 2).to(buf.device)

    def loss1(p, b):
        return loss_fn(_first_row(p), b).reshape(1)

    buf, coeffs, base = flat_local_iterate(loss1, buf, spec, batch, keys,
                                           cfg, block_rows=br)
    return unflatten(buf[0], spec), coeffs[0], base[0]


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
    ``[M, H, 2]``; ``batches`` leaves ``[M, H, ...]``."""
    buf, coeffs, losses = buf0, [], []
    for h in range(cfg.local_iters):
        batch = {k: v[:, h] for k, v in batches.items()}
        buf, c, base = flat_local_iterate(loss_fn, buf, spec, batch,
                                          keys[:, h].contiguous(), cfg,
                                          block_rows=br)
        coeffs.append(c)
        losses.append(base)
    return LocalResult(buf, torch.stack(coeffs, 1), torch.stack(losses, 1))


def round_simulated(loss_fn, server_params, client_batches, client_rngs,
                    cfg: FedZOConfig, *, channel_rng=None, momentum=None,
                    weights=None, faults=None, channel=None, cstate=None,
                    loss_wrap=None, state_fn=None):
    """One communication round over the M sampled clients, flat route.

    ``loss_fn(params, batch) -> scalar`` for one client; ``server_params``
    a dict of tensors on the run's device; ``client_batches`` leaves
    ``[M, H, b1, ...]`` on that device; ``client_rngs`` ``[M, 2]`` raw keys
    and ``channel_rng`` a raw key (both CPU). ``weights`` ``[M]``: mean-1
    size weights. Returns (new_params, metrics[, new_momentum]).
    """
    for name, hook in (("faults", faults), ("channel", channel),
                       ("cstate", cstate), ("loss_wrap", loss_wrap),
                       ("state_fn", state_fn)):
        if hook is not None:
            raise NotImplementedError(f"round_simulated({name}=...) is not "
                                      f"ported")
    check_flat_route(cfg)
    M = client_rngs.shape[0]
    dev = next(iter(server_params.values())).device
    mask = None
    noise_rng = channel_rng
    air_stats = {}
    if cfg.channel_schedule and channel_rng is not None:
        ks = prng.split(channel_rng, 2)
        k_sched, noise_rng = ks[0], ks[1]
        _, mask = schedule_by_channel(k_sched, M, cfg.h_min)
        mask = mask.to(dev)

    spec, br = flat_geometry(server_params, cfg.flat_block_rows)
    buf0 = flatten(server_params, spec)
    keys = prng.split(client_rngs, cfg.local_iters).to(dev)    # [M, H, 2]
    res = _flat_phase_scan(batched_loss(loss_fn),
                           buf0.expand(M, spec.n_pad).contiguous(), spec, br,
                           keys, client_batches, cfg)
    deltas = res.buf - buf0
    losses = res.losses

    if cfg.aircomp and channel_rng is not None:
        agg_flat, air_stats = aircomp_aggregate_flat(
            deltas, noise_rng, snr_db=cfg.snr_db, h_min=cfg.h_min, d=spec.d,
            mask=mask, weights=weights, block_rows=br)
    elif mask is not None or weights is not None:
        maskf, m_div, m_sched = mask_stats(mask, M, weights, device=dev)
        agg_flat = torch.einsum("mn,m->n", deltas, maskf) / m_div
        air_stats = {"m_effective": m_sched}
    else:
        agg_flat = torch.mean(deltas, dim=0)
    agg = unflatten(agg_flat, spec)

    if momentum is not None and cfg.server_momentum > 0:
        momentum = {k: (cfg.server_momentum * m + agg[k]).to(m.dtype)
                    for k, m in momentum.items()}
        agg = momentum
    new_params = {k: p + agg[k] for k, p in server_params.items()}
    metrics = {"mean_local_loss": torch.mean(losses),
               "first_loss": torch.mean(losses[:, 0]), **air_stats}
    if momentum is not None:
        return new_params, metrics, momentum
    return new_params, metrics
