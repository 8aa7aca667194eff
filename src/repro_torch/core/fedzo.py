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
- **The wide route** (``batch_directions=True``, the simulation engine's
  plan): per iterate one ``[b2, n_pad]`` direction block per client, drawn
  by the torch Threefry chain for the whole cohort at once
  (``estimator.direction_block``; conventions ``block``, ``tree``,
  ``channel``, and the ``surrogate`` phase); the M·b2 perturbed copies go
  through the loss as one ``[M·b2]`` cohort, and the update is one batched
  matvec. No ZO kernel runs on it; with AirComp the aggregation runs
  ``aircomp_reduce`` and the noise ``zo_walk``.

The cross-silo unit, ``local_iterate`` / ``make_train_step``, is one
iterate on one client on either route; on the flat route it is a row of
the batched iterate. ``jax.grad`` has no counterpart here: FedZO is
forward-only.

``round_simulated`` takes the strategy hooks of ``core/strategy.py`` on
every route (client state, loss wraps, delta corrections), a round's
realized faults (``sim/faults.RoundFaults``: the deltas corrupted and
scrubbed in place before the aggregation) and its realized wireless channel
(``sim/channel.RoundChannel``: its transmit mask in place of the i.i.d.
scheduling draw); a ``delta_compression="seed"`` config runs the same dense
round, as in the reference (the seed-compressed uplink itself is
``fed/server.run_seed_compressed_round``, ``core/seedcomm.py``). The
tiered store's cohort round (``sim/engine.make_cohort_round_step``) runs
this round on staged cohorts; the sharded round (``sim/shard.py``) is not
ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import estimator
from repro_torch.core.aircomp import (aircomp_aggregate,
                                      aircomp_aggregate_flat, mask_stats,
                                      schedule_by_channel)
from repro_torch.kernels.zo_axpy import LANES
from repro_torch.utils import prng
from repro_torch.utils.flatparams import (_leaves, flat_geometry, flat_spec,
                                          flatten, unflatten)
from repro_torch.utils.tree import (tree_add, tree_map, tree_scale,
                                    tree_stack, tree_sub)

_DIRECTION_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class LocalResult(NamedTuple):
    params: object         # x_i^{(t,H)}
    coeffs: torch.Tensor   # [H, b2] estimator coefficients
    losses: torch.Tensor   # [H] base losses along the trajectory


def _check_iterate(cfg: FedZOConfig):
    """Reject every config a local iterate cannot run as asked (the
    reference's ``local_iterate`` ignores ``batch_directions`` and takes
    any ``direction_conv`` other than ``counter`` as ``tree``)."""
    if cfg.flat_params:
        estimator._counter_kind(cfg.estimator)


def check_route(cfg: FedZOConfig):
    """Reject every config a local phase or round cannot run as asked."""
    if cfg.direction_conv in ("surrogate", "channel") \
            and not cfg.batch_directions:
        raise ValueError(
            f"direction_conv={cfg.direction_conv!r} runs on the batched-"
            f"direction (wide) local phase — set cfg.batch_directions=True")
    _check_iterate(cfg)
    if cfg.batch_directions and cfg.estimator == "coordinate":
        raise ValueError("batched-direction path does not support "
                         "kind='coordinate'")


def batched_loss(loss_fn):
    """Map a one-client ``loss(params, batch)`` over a cohort: parameter
    leaves ``[M·r, ...]`` against batch leaves ``[M, ...]`` give ``[M·r]``
    losses, row m·r + j client m's copy j on client m's batch (r = 1: one
    row a client).

    A loss that carries its client-batched form as ``loss_fn.batched`` (the
    dense LM's, ``models/api.py``; the transformer track's) runs through
    it: one kernel launch per RMSNorm and attention for the whole cohort,
    and the batch is not copied r times. Any other loss goes through
    ``torch.func.vmap`` (two levels when r > 1, the inner one sharing the
    client's batch), which cannot trace a kernel launch (a vmapped tensor
    has no storage to hand the kernel) and serves the losses that launch
    none (softmax, CNN)."""
    fn = getattr(loss_fn, "batched", None)
    if fn is not None:
        return fn

    def cohort(params, batch):
        mr = _leaves(params)[0][1].shape[0]
        m = _leaves(batch)[0][1].shape[0]
        if mr == m:
            return torch.func.vmap(loss_fn)(params, batch)
        inner = torch.func.vmap(loss_fn, in_dims=(0, None))
        return torch.func.vmap(inner)(
            tree_map(lambda v: v.reshape((m, mr // m) + v.shape[1:]),
                     params), batch).reshape(mr)

    return cohort


def _wide_losses(loss_fn, xp, spec, batch):
    """``[M, r]`` losses of the r points ``xp`` ``[M, r, n_pad]`` of each of
    M clients, client m's on its own batch (leaves ``[M, ...]``): the M·r
    points as one cohort of ``batched_loss``."""
    M, r = xp.shape[:2]
    return batched_loss(loss_fn)(unflatten(xp.reshape(M * r, -1), spec),
                                 batch).reshape(M, r)


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
    _check_iterate(cfg)
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


def _wide_setup(params, cfg: FedZOConfig):
    """(spec, block_rows) of the wide route: padded to the 128-lane width
    only (no kernel walks the buffer, and every ``[b2, n_pad]`` block pays
    for the pad), or the kernel geometry when ``aircomp_reduce`` takes the
    delta matrix."""
    if cfg.aircomp:
        return flat_geometry(params, cfg.flat_block_rows)
    return flat_spec(params, block=LANES), (cfg.flat_block_rows or None)


def surrogate_queries(cfg: FedZOConfig) -> int:
    """Fresh perturbed-loss queries per iterate of the surrogate phase:
    round(b2·surrogate_fraction), at least 1."""
    return max(1, int(round(cfg.b2 * cfg.surrogate_fraction)))


def _wide_coefficients(loss_fn, buf, spec, batch, V, inv, scale, cfg):
    """``[M, r]`` coefficients and ``[M]`` base losses of the r directions
    ``V`` ``[M, r, n_pad]`` around every row of ``buf`` ``[M, n_pad]``, in
    the reference's order: the points ``buf + (μ·s)·v``, then
    ``scale·(lp − base)/μ`` or the central difference."""
    mu = float(np.float32(cfg.mu))
    base = batched_loss(loss_fn)(unflatten(buf, spec), batch)
    step = (mu * inv)[..., None] * V
    lp = _wide_losses(loss_fn, buf[:, None] + step, spec, batch)
    if cfg.central:
        lm = _wide_losses(loss_fn, buf[:, None] - step, spec, batch)
        return scale * (lp - lm).to(torch.float32) / (2 * mu), base
    return scale * (lp - base[:, None]).to(torch.float32) / mu, base


def _combine(coeffs, inv, V):
    """Σ_n coeffs[:, n]·inv[:, n]·V[:, n] ``[M, n_pad]``: one batched
    matvec."""
    return torch.matmul((coeffs * inv)[:, None], V)[:, 0]


def _surrogate_phase_scan(loss_fn, buf0, spec, keys, batches, cfg):
    """The trajectory-informed surrogate phase (FedZOO-style): per iterate
    ``surrogate_queries(cfg)`` fresh ``block`` directions, their estimate
    blended into a running surrogate g ← β·g + (1−β)·ĝ (ĝ alone on the
    first iterate), x ← x − η·g. Returns (buf, coeffs ``[M, H, b2q]``,
    losses ``[M, H]``)."""
    scale = estimator._scale_factor(spec.d, cfg.estimator)
    b2q = surrogate_queries(cfg)
    beta = float(np.float32(cfg.surrogate_beta))
    buf, g_hat, coeffs, losses = buf0, torch.zeros_like(buf0), [], []
    for h in range(cfg.local_iters):
        V, inv = estimator.direction_block(keys[:, h], spec, b2q,
                                           kind=cfg.estimator, conv="block",
                                           device=buf.device)
        c, base = _wide_coefficients(
            loss_fn, buf, spec, tree_map(lambda v: v[:, h], batches), V,
            inv, scale, cfg)
        g_fresh = _combine(c, inv, V) / b2q
        w = 0.0 if h == 0 else beta
        g_hat = w * g_hat + (1.0 - w) * g_fresh
        buf = buf - cfg.lr * g_hat
        coeffs.append(c)
        losses.append(base)
    return buf, torch.stack(coeffs, 1), torch.stack(losses, 1)


def _wide_phase_scan(loss_fn, buf0, spec, keys, batches, cfg, like=None):
    """H batched-direction ("wide") iterates of every row of ``buf0``
    ``[M, n_pad]``: per iterate one direction block per client
    (``keys[:, h]``, ``[M, 2]`` on the CPU), the M·b2 perturbed forwards as
    one cohort, and the update ``buf + (−lr/b2)·((coeffs·inv) @ V)``.
    ``batches`` leaves ``[M, H, ...]``; ``like`` the parameter tree (the
    ``tree`` convention's leaves). ``channel`` directions are gaussian
    whatever ``cfg.estimator`` says (scale 1). Returns (buf, coeffs ``[M,
    H, b2]``, losses ``[M, H]``)."""
    if cfg.direction_conv == "surrogate":
        return _surrogate_phase_scan(loss_fn, buf0, spec, keys, batches, cfg)
    conv = (cfg.direction_conv if cfg.direction_conv in ("tree", "channel")
            else "block")
    scale = (1.0 if conv == "channel"
             else estimator._scale_factor(spec.d, cfg.estimator))
    buf, coeffs, losses = buf0, [], []
    for h in range(cfg.local_iters):
        V, inv = estimator.direction_block(keys[:, h], spec, cfg.b2,
                                           kind=cfg.estimator, conv=conv,
                                           like=like, device=buf.device)
        c, base = _wide_coefficients(
            loss_fn, buf, spec, tree_map(lambda v: v[:, h], batches), V,
            inv, scale, cfg)
        buf = buf + (-cfg.lr / cfg.b2) * _combine(c, inv, V)
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
    if cfg.batch_directions:
        spec, _ = _wide_setup(params, cfg)
        buf0 = flatten(params, spec)[None]
        buf, coeffs, losses = _wide_phase_scan(
            loss_fn, buf0, spec, keys[None],
            tree_map(lambda v: v[None], batches), cfg, like=params)
        return LocalResult(unflatten(buf[0], spec), coeffs[0], losses[0])
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


class CohortResult(NamedTuple):
    deltas: object         # [M, n_pad] (flat, wide) or a stacked tree
    coeffs: torch.Tensor   # [M, H, b2] estimator coefficients
    losses: torch.Tensor   # [M, H] base losses
    spec: object           # the flat geometry (None on the pytree route)
    block_rows: object


def _wrapped(loss_fn, loss_wrap, cst):
    """The cohort's loss under a strategy's wrap on the flat and wide
    routes: ``loss_wrap`` is called once with the cohort's ``[M, ...]``
    state, and its loss must carry ``.batched`` (the cohort loss plus the
    per-row regularizers): the round never maps a wrapped loss with
    ``torch.func.vmap``, which cannot trace a kernel launch."""
    if loss_wrap is None:
        return loss_fn
    lf = loss_wrap(loss_fn, cst)
    if getattr(lf, "batched", None) is None:
        raise ValueError(
            "on the flat and wide routes loss_wrap(loss_fn, cstate) is "
            "called once with the cohort's [M, ...] state and must return "
            "a loss carrying its client-batched form as .batched")
    return lf


def cohort_phase(loss_fn, server_params, client_batches, client_rngs,
                 cfg: FedZOConfig, *, cstate=None, loss_wrap=None
                 ) -> CohortResult:
    """The local phases of the M sampled clients, all from
    ``server_params``: client i runs H iterates with key
    ``split(client_rngs[i], H)[h]`` on its batches ``client_batches[i]``.

    On the flat and wide routes the cohort runs side by side on one ``[M,
    n_pad]`` buffer, and the deltas come back as that matrix; on the pytree
    route the clients run one after another and the deltas come back as a
    stacked ``[M, ...]`` tree. ``loss_wrap`` (a strategy's hook) wraps the
    loss: per client with its row of ``cstate`` on the pytree route, once
    for the cohort with the whole ``cstate`` on the others (``_wrapped``).
    """
    check_route(cfg)
    M = client_rngs.shape[0]
    if cfg.flat_params or cfg.batch_directions:
        lf = _wrapped(loss_fn, loss_wrap, cstate)
        spec, br = (_wide_setup(server_params, cfg) if cfg.batch_directions
                    else flat_geometry(server_params, cfg.flat_block_rows))
        buf0 = flatten(server_params, spec)
        bufs = buf0.expand(M, spec.n_pad).contiguous()
        keys = prng.split(client_rngs, cfg.local_iters)  # [M, H, 2]
        if cfg.batch_directions:
            buf, coeffs, losses = _wide_phase_scan(
                lf, bufs, spec, keys, client_batches, cfg,
                like=server_params)
        else:
            buf, coeffs, losses = _flat_phase_scan(
                batched_loss(lf), bufs, spec, br, keys.to(buf0.device),
                client_batches, cfg)
        return CohortResult(buf - buf0, coeffs, losses, spec, br)
    deltas, coeffs, losses = [], [], []
    for i in range(M):
        lf = loss_fn
        if loss_wrap is not None:
            lf = loss_wrap(loss_fn, None if cstate is None
                           else tree_map(lambda v: v[i], cstate))
        delta, res = client_delta(
            lf, server_params, tree_map(lambda v: v[i], client_batches),
            client_rngs[i], cfg)
        deltas.append(delta)
        coeffs.append(res.coeffs)
        losses.append(res.losses)
    return CohortResult(tree_stack(deltas), torch.stack(coeffs),
                        torch.stack(losses), None, None)


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
    new_momentum][, new_cstate]).

    The aggregation follows the reference on every route: AirComp (Eq. 17)
    when ``cfg.aircomp``; else the masked (channel scheduling) and/or
    size-weighted mean; else the plain mean, which the pytree route takes
    as ``(1/M)·Σ_i Δ_i``.

    Strategy hooks (``core/strategy.py``), all None by default, when every
    route is the plain FedZO round:

    - ``cstate``: the cohort's ``[M, ...]`` strategy state (SCAFFOLD
      controls, FedDyn duals); the updated state is appended to the
      returned tuple whenever it is passed.
    - ``loss_wrap(loss_fn, cst) -> loss_fn'`` wraps the ZO loss query:
      per client with ``cst`` its row on the pytree route; once with the
      cohort's ``cstate`` on the flat and wide routes, where the wrapped
      loss must carry ``.batched`` (``cohort_phase``).
    - ``state_fn(deltas, cstate, spec) -> (deltas', cstate')``: the
      client-side delta correction before the aggregation, on the ``[M,
      n_pad]`` matrix (``spec`` set) or the stacked delta tree (``spec``
      None).

    ``faults`` (a ``sim.faults.RoundFaults``) corrupts and scrubs the
    deltas after ``state_fn`` and before the aggregation; its surviving
    rows' mask composes with the channel mask (``mask = fmask & mask``),
    ``m_effective`` reports the survivors and ``m_corrupt`` the poisoned
    uploads. ``channel`` (a ``sim.channel.RoundChannel``) supplies the
    round's transmit mask in place of ``schedule_by_channel``'s draw.
    """
    check_route(cfg)
    M = client_rngs.shape[0]
    dev = estimator._device(server_params)
    new_cstate = cstate
    mask = None
    noise_rng = channel_rng
    air_stats = {}
    if cfg.channel_schedule and channel_rng is not None:
        ks = prng.split(channel_rng, 2)
        k_sched, noise_rng = ks[0], ks[1]
        if channel is None:
            _, mask = schedule_by_channel(k_sched, M, cfg.h_min)
            mask = mask.to(dev)
    if channel is not None:
        # the scenario's realized channel (sim/channel.py): correlated-
        # fading scheduling ∧ battery gating replaces the i.i.d. draw
        mask = channel.mask.to(dev)

    res = cohort_phase(loss_fn, server_params, client_batches, client_rngs,
                       cfg, cstate=cstate, loss_wrap=loss_wrap)
    deltas, losses, spec = res.deltas, res.losses, res.spec
    if state_fn is not None:
        deltas, new_cstate = state_fn(deltas, cstate, spec)
    if faults is not None:
        # corrupt-then-guard the uploads in place; the survivors' mask
        # composes with the channel's
        deltas, fmask = (faults.apply_flat(deltas) if spec is not None
                         else faults.apply_tree(deltas))
        mask = fmask if mask is None else mask & fmask

    if spec is not None:
        if cfg.aircomp and channel_rng is not None:
            agg_flat, air_stats = aircomp_aggregate_flat(
                deltas, noise_rng, snr_db=cfg.snr_db, h_min=cfg.h_min,
                d=spec.d, mask=mask, weights=weights,
                block_rows=res.block_rows)
        elif mask is not None or weights is not None:
            maskf, m_div, m_sched = mask_stats(mask, M, weights, device=dev)
            agg_flat = torch.einsum("mn,m->n", deltas, maskf) / m_div
            air_stats = {"m_effective": m_sched}
        else:
            agg_flat = torch.mean(deltas, dim=0)
        agg = unflatten(agg_flat, spec)
    elif cfg.aircomp and channel_rng is not None:
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
    if faults is not None:
        # the mask is set under faults, so every branch above reported
        # m_effective (the surviving cohort)
        air_stats["m_corrupt"] = faults.n_corrupt.to(dev)
    metrics = {"mean_local_loss": torch.mean(losses),
               "first_loss": torch.mean(losses[:, 0]), **air_stats}
    out = (new_params, metrics)
    if momentum is not None:
        out = out + (momentum,)
    if cstate is not None:
        out = out + (new_cstate,)
    return out
