"""FedZO (paper Algorithm 1): the pytree and flat-buffer routes.

Counterpart of ``repro/core/fedzo.py:51-116, 201-276, 339-563``.
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
  for the whole cohort at once (``estimator.direction_block``; conventions
  ``block``, ``tree``, ``channel``, and the ``surrogate`` phase): by the
  torch Threefry chain under threefry keys, by one ``philox_bits`` launch
  under rbg and unsafe_rbg keys (``sim.fast_sim_config``); the M·b2
  perturbed copies go through the loss as one ``[M·b2]`` cohort, and the
  update is one batched matvec. No ZO kernel runs on it; with AirComp the
  aggregation runs ``aircomp_reduce`` and the noise ``zo_walk``.

Keys carry their ``prng.Impl`` beside them (``impl=``, resolved by the
engine from ``cfg.prng_impl``; None: threefry), and the cohort's draws are
the reference's under its client vmap (``utils/prng.py``).

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
this round on staged cohorts; the sharded round (``sim/shard.py``) runs
each rank's rows through ``cohort_phase`` and ``flat_partial`` and ends
with this round's own tail (``flat_finish``, ``finish_round``).

``make_pod_round_step`` is the cross-silo round over a ``pod`` axis (one
iterate, directions shared by the pods, the mean of the per-pod
coefficients as the only uplink), and ``make_delta_agg_step`` the
dense-uplink aggregation of per-pod deltas.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import estimator
from repro_torch.core.aircomp import (aircomp_aggregate,
                                      aircomp_aggregate_flat,
                                      aircomp_noise_flat, mask_stats,
                                      schedule_by_channel)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.zo_axpy import LANES
from repro_torch.utils import prng
from repro_torch.utils.flatparams import (_leaves, flat_geometry, flat_spec,
                                          flatten, unflatten)
from repro_torch.utils.shardutil import on_dtensors
from repro_torch.utils.tree import (tree_add, tree_leaves, tree_map,
                                    tree_scale, tree_stack, tree_sub)

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

    A loss that carries its client-batched form as ``loss_fn.batched``
    (every ``models/api.py`` model's, all ten architectures; the
    transformer track's; a strategy's wrap of either) runs through it: one
    kernel launch per RMSNorm and attention for the whole cohort, and the
    batch is not copied r times. Any other loss goes through
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


class RowHyper(NamedTuple):
    """The dynamic hyperparameters of a batched sweep, one value per row of
    a cohort buffer (float64 ``[R]``, each scenario's value repeated over
    its clients): the local step size and the smoothing radius. None
    everywhere else, where ``cfg.lr`` and ``cfg.mu`` hold."""
    lr: np.ndarray
    mu: np.ndarray


def _rows_f32(v, device, cols: bool):
    """float64 ``[R]`` per-row values as float32 on ``device`` (``[R, 1]``
    with ``cols``): the rounding a Python scalar takes in a float32
    operation, so a row of a batched sweep computes as its single run."""
    t = torch.tensor(np.asarray(v, np.float32), device=device)
    return t[:, None] if cols else t


def flat_local_iterate(loss_fn, buf, spec, batch, keys, cfg: FedZOConfig,
                       block_rows=None, hyper: RowHyper = None):
    """One ZO update of every row of ``buf`` ``[M, n_pad]``: the fused
    walk, then the single-pass replay. ``loss_fn`` is batched (``[M]``
    losses); ``keys`` ``[M, 2]`` (the counter words) on the buffer's
    device. The sphere inv-norms are computed once and shared by both
    ends."""
    mu, scale = cfg.mu, -cfg.lr
    if hyper is not None:
        mu = _rows_f32(hyper.mu, buf.device, False)
        scale = _rows_f32(-hyper.lr, buf.device, False)
    inv = estimator.flat_inv_norms(keys, spec, cfg.b2, cfg.estimator,
                                   block_rows=block_rows)
    coeffs, base = estimator.flat_coefficients(
        loss_fn, buf, spec, batch, keys, mu=mu, b2=cfg.b2,
        kind=cfg.estimator, central=cfg.central, block_rows=block_rows,
        inv=inv)
    buf = estimator.flat_apply_coefficients(
        buf, spec, keys, coeffs, scale=scale, kind=cfg.estimator,
        block_rows=block_rows, inv=inv)
    return buf, coeffs, base


def local_iterate(loss_fn, params, batch, rng, cfg: FedZOConfig, impl=None):
    """One stochastic zeroth-order update (Eq. 5-6): x ← x − η ∇̃F(x).

    ``loss_fn(params, batch) -> scalar``; ``params`` a (nested) dict of
    tensors on the run's device; ``rng`` a raw key (CPU) of ``impl``
    (``utils/prng.py``; None: threefry). Returns (new_params, coeffs
    ``[b2]``, base_loss). On the flat route the parameters are flattened
    once, walked and replayed by the kernels (with the key's words 0–1),
    and unflattened once (leaves are views of the new buffer); on the
    pytree route every perturbation and update is a ``zo_axpy`` per leaf.
    """
    _check_iterate(cfg)
    prng.impl_of(rng, impl)
    if cfg.flat_params:
        spec, br = flat_geometry(params, cfg.flat_block_rows)
        buf = flatten(params, spec)[None]
        keys = prng.counter_words(rng).reshape(1, 2).to(buf.device)

        def loss1(p, b):
            return loss_fn(tree_map(lambda v: v[0], p), b).reshape(1)

        buf, coeffs, base = flat_local_iterate(loss1, buf, spec, batch, keys,
                                               cfg, block_rows=br)
        return unflatten(buf[0], spec), coeffs[0], base[0]
    ddt = _DIRECTION_DTYPES[cfg.direction_dtype]
    coeffs, base = estimator.coefficients(
        loss_fn, params, batch, rng, mu=cfg.mu, b2=cfg.b2, kind=cfg.estimator,
        direction_dtype=ddt, central=cfg.central, conv=cfg.direction_conv,
        impl=impl)
    new_params = estimator.apply_coefficients(
        params, rng, coeffs, scale=-cfg.lr, kind=cfg.estimator,
        direction_dtype=ddt, conv=cfg.direction_conv, impl=impl)
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


def _flat_phase_scan(loss_fn, buf0, spec, br, keys, batches, cfg,
                     hyper=None):
    """H flat local iterates over ``buf0`` ``[M, n_pad]``. ``keys``
    ``[M, H, 2]`` (counter words); ``batches`` leaves ``[M, H, ...]``.
    Returns (final buf, coeffs ``[M, H, b2]``, losses ``[M, H]``)."""
    buf, coeffs, losses = buf0, [], []
    for h in range(cfg.local_iters):
        batch = tree_map(lambda v: v[:, h], batches)
        buf, c, base = flat_local_iterate(loss_fn, buf, spec, batch,
                                          keys[:, h].contiguous(), cfg,
                                          block_rows=br, hyper=hyper)
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


def _wide_scalars(cfg, hyper, device, step_of):
    """(μ, ``step_of(lr)``) of the wide route as float32 tensors on
    ``device``: 0-d from ``cfg``, or ``[R, 1]`` per row from ``hyper``.
    Tensors in both
    cases, so a row of a batched sweep divides and multiplies exactly as
    its single run does (on the card a Python-scalar divisor becomes a
    multiply by its float32 reciprocal, a tensor divisor does not)."""
    if hyper is None:
        return (torch.full((), float(np.float32(cfg.mu)), device=device),
                torch.full((), step_of(cfg.lr), device=device))
    return (_rows_f32(hyper.mu, device, True),
            _rows_f32(step_of(hyper.lr), device, True))


def _wide_coefficients(loss_fn, buf, spec, batch, V, inv, scale, cfg, mu):
    """``[M, r]`` coefficients and ``[M]`` base losses of the r directions
    ``V`` ``[M, r, n_pad]`` around every row of ``buf`` ``[M, n_pad]``, in
    the reference's order: the points ``buf + (μ·s)·v``, then
    ``scale·(lp − base)/μ`` or the central difference (``mu``: 0-d or
    ``[M, 1]``)."""
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


def _surrogate_phase_scan(loss_fn, buf0, spec, keys, batches, cfg,
                          impl=None, hyper=None):
    """The trajectory-informed surrogate phase (FedZOO-style): per iterate
    ``surrogate_queries(cfg)`` fresh ``block`` directions, their estimate
    blended into a running surrogate g ← β·g + (1−β)·ĝ (ĝ alone on the
    first iterate), x ← x − η·g. Returns (buf, coeffs ``[M, H, b2q]``,
    losses ``[M, H]``)."""
    scale = estimator._scale_factor(spec.d, cfg.estimator)
    b2q = surrogate_queries(cfg)
    beta = float(np.float32(cfg.surrogate_beta))
    mu, lr = _wide_scalars(cfg, hyper, buf0.device, lambda v: v)
    buf, g_hat, coeffs, losses = buf0, torch.zeros_like(buf0), [], []
    for h in range(cfg.local_iters):
        V, inv = estimator.direction_block(keys[:, h], spec, b2q,
                                           kind=cfg.estimator, conv="block",
                                           device=buf.device, impl=impl)
        c, base = _wide_coefficients(
            loss_fn, buf, spec, tree_map(lambda v: v[:, h], batches), V,
            inv, scale, cfg, mu)
        g_fresh = _combine(c, inv, V) / b2q
        w = 0.0 if h == 0 else beta
        g_hat = w * g_hat + (1.0 - w) * g_fresh
        buf = buf - lr * g_hat
        coeffs.append(c)
        losses.append(base)
    return buf, torch.stack(coeffs, 1), torch.stack(losses, 1)


def _wide_phase_scan(loss_fn, buf0, spec, keys, batches, cfg, like=None,
                     impl=None, hyper=None):
    """H batched-direction ("wide") iterates of every row of ``buf0``
    ``[M, n_pad]``: per iterate one direction block per client
    (``keys[:, h]``, ``[M, words]`` on the CPU, drawn as under the
    reference's client vmap), the M·b2 perturbed forwards as one cohort,
    and the update ``buf + (−lr/b2)·((coeffs·inv) @ V)``. ``batches``
    leaves ``[M, H, ...]``; ``like`` the parameter tree (the ``tree``
    convention's leaves). ``channel`` directions are gaussian whatever
    ``cfg.estimator`` says (scale 1). Returns (buf, coeffs ``[M, H, b2]``,
    losses ``[M, H]``)."""
    if cfg.direction_conv == "surrogate":
        return _surrogate_phase_scan(loss_fn, buf0, spec, keys, batches, cfg,
                                     impl, hyper)
    conv = (cfg.direction_conv if cfg.direction_conv in ("tree", "channel")
            else "block")
    scale = (1.0 if conv == "channel"
             else estimator._scale_factor(spec.d, cfg.estimator))
    mu, step = _wide_scalars(cfg, hyper, buf0.device,
                             lambda v: -v / cfg.b2)
    buf, coeffs, losses = buf0, [], []
    for h in range(cfg.local_iters):
        V, inv = estimator.direction_block(keys[:, h], spec, cfg.b2,
                                           kind=cfg.estimator, conv=conv,
                                           like=like, device=buf.device,
                                           impl=impl)
        c, base = _wide_coefficients(
            loss_fn, buf, spec, tree_map(lambda v: v[:, h], batches), V,
            inv, scale, cfg, mu)
        buf = buf + step * _combine(c, inv, V)
        coeffs.append(c)
        losses.append(base)
    return buf, torch.stack(coeffs, 1), torch.stack(losses, 1)


def local_phase(loss_fn, params, batches, rng, cfg: FedZOConfig,
                impl=None) -> LocalResult:
    """H local iterates (Algorithm 1 inner loop) of one client.

    ``batches`` leaves carry a leading ``[H]`` axis; iterate h takes key
    ``split(rng, H)[h]`` (``rng`` of ``impl``). On the flat route the tree
    is flattened once for the whole phase.
    """
    check_route(cfg)
    keys = prng.split(rng, cfg.local_iters, impl)
    if cfg.batch_directions:
        spec, _ = _wide_setup(params, cfg)
        buf0 = flatten(params, spec)[None]
        buf, coeffs, losses = _wide_phase_scan(
            loss_fn, buf0, spec, keys[None],
            tree_map(lambda v: v[None], batches), cfg, like=params,
            impl=impl)
        return LocalResult(unflatten(buf[0], spec), coeffs[0], losses[0])
    if cfg.flat_params:
        spec, br = flat_geometry(params, cfg.flat_block_rows)
        buf0 = flatten(params, spec)[None]
        buf, coeffs, losses = _flat_phase_scan(
            batched_loss(loss_fn), buf0, spec, br,
            prng.counter_words(keys)[None].to(buf0.device),
            tree_map(lambda v: v[None], batches), cfg)
        return LocalResult(unflatten(buf[0], spec), coeffs[0], losses[0])
    p, coeffs, losses = params, [], []
    for h in range(cfg.local_iters):
        p, c, base = local_iterate(loss_fn, p, tree_map(lambda v: v[h],
                                                        batches),
                                   keys[h], cfg, impl)
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


def cohort_geometry(server_params, cfg: FedZOConfig):
    """(spec, block_rows) of a cohort's flat or wide buffer."""
    return (_wide_setup(server_params, cfg) if cfg.batch_directions
            else flat_geometry(server_params, cfg.flat_block_rows))


def cohort_rows(loss_fn, bufs, spec, br, client_batches, client_rngs,
                cfg: FedZOConfig, *, like, impl=None, hyper=None):
    """The local phases of a cohort on the flat or wide route, each row of
    ``bufs`` ``[R, n_pad]`` from its own start: row r runs H iterates with
    key ``split(client_rngs[r], H)[h]`` on ``client_batches[r]``. The R
    rows are one cohort under the reference's vmap (a batched sweep's
    ``[S, M]`` scenarios × clients flattened row-major), and ``hyper``
    gives each row its own lr and μ. Returns (final bufs, coeffs ``[R, H,
    b2]``, losses ``[R, H]``)."""
    keys = prng.split(client_rngs, cfg.local_iters, impl)  # [R, H, words]
    if cfg.batch_directions:
        return _wide_phase_scan(loss_fn, bufs, spec, keys, client_batches,
                                cfg, like=like, impl=impl, hyper=hyper)
    return _flat_phase_scan(batched_loss(loss_fn), bufs, spec, br,
                            prng.counter_words(keys).to(bufs.device),
                            client_batches, cfg, hyper=hyper)


def tree_rows(loss_fns, params, client_batches, client_rngs, cfgs,
              impl=None):
    """The pytree route's local phases of R clients, one after another:
    client r runs H iterates from ``params[r]`` with ``cfgs[r]`` and
    ``loss_fns[r]`` on its batches ``client_batches[r]`` (leaves ``[R, H,
    ...]``), iterate h with key ``split(client_rngs[r], H)[h]``. The R
    rows stand for the reference's client vmap (a batched sweep's
    scenarios × clients flattened): the keys split as one batch and each
    iterate's key is a ``prng.lanes`` row, so under rbg keys every
    per-leaf draw is the client's slice of one draw from the first
    client's key, as in the reference. Returns (the R delta trees, coeffs
    ``[R, H, b2]``, losses ``[R, H]``)."""
    H = cfgs[0].local_iters
    keys = prng.split(client_rngs, H, impl)               # [R, H, words]
    rows = [prng.lanes(keys[:, h], impl) for h in range(H)]
    deltas, coeffs, losses = [], [], []
    for r in range(client_rngs.shape[0]):
        p, cs, ls = params[r], [], []
        for h in range(H):
            p, c, base = local_iterate(
                loss_fns[r], p, tree_map(lambda v: v[r, h], client_batches),
                rows[h][r], cfgs[r], impl)
            cs.append(c)
            ls.append(base)
        deltas.append(tree_sub(p, params[r]))
        coeffs.append(torch.stack(cs))
        losses.append(torch.stack(ls))
    return deltas, torch.stack(coeffs), torch.stack(losses)


def cohort_phase(loss_fn, server_params, client_batches, client_rngs,
                 cfg: FedZOConfig, *, cstate=None, loss_wrap=None,
                 impl=None) -> CohortResult:
    """The local phases of the M sampled clients, all from
    ``server_params``: client i runs H iterates with key
    ``split(client_rngs[i], H)[h]`` on its batches ``client_batches[i]``.

    On the flat and wide routes the cohort runs side by side on one ``[M,
    n_pad]`` buffer (``cohort_rows``), and the deltas come back as that
    matrix; on the pytree route the clients run one after another
    (``tree_rows``) and the deltas come back as a stacked ``[M, ...]``
    tree. ``loss_wrap`` (a
    strategy's hook) wraps the loss: per client with its row of ``cstate``
    on the pytree route, once for the cohort with the whole ``cstate`` on
    the others (``_wrapped``). ``impl``: the keys' (None: threefry).
    """
    check_route(cfg)
    M = client_rngs.shape[0]
    if cfg.flat_params or cfg.batch_directions:
        lf = _wrapped(loss_fn, loss_wrap, cstate)
        spec, br = cohort_geometry(server_params, cfg)
        buf0 = flatten(server_params, spec)
        bufs = buf0.expand(M, spec.n_pad).contiguous()
        buf, coeffs, losses = cohort_rows(
            lf, bufs, spec, br, client_batches, client_rngs, cfg,
            like=server_params, impl=impl)
        return CohortResult(buf - buf0, coeffs, losses, spec, br)
    lfs = [loss_fn if loss_wrap is None else loss_wrap(
        loss_fn, None if cstate is None else tree_map(lambda v: v[i], cstate))
        for i in range(M)]
    deltas, coeffs, losses = tree_rows(lfs, [server_params] * M,
                                       client_batches, client_rngs,
                                       [cfg] * M, impl)
    return CohortResult(tree_stack(deltas), coeffs, losses, None, None)


def round_schedule(cfg: FedZOConfig, channel_rng, channel, M, dev,
                   impl=None, h_min=None):
    """The round's transmit mask and AirComp noise key: ``(mask | None,
    noise_rng)``. With ``cfg.channel_schedule`` the channel key splits
    into the scheduling draw's key and the noise key, and the i.i.d.
    Rayleigh draw sets the mask unless a realized ``channel`` supplies it.
    Keys ``[S, words]`` (a batched sweep) give ``[S, M]`` masks and ``[S,
    words]`` noise keys, with ``h_min`` ``[S, 1]``."""
    mask, noise_rng = None, channel_rng
    if cfg.channel_schedule and channel_rng is not None:
        ks = prng.split(channel_rng, 2, impl)
        k_sched, noise_rng = ks[..., 0, :], ks[..., 1, :]
        if channel is None:
            _, mask = schedule_by_channel(
                k_sched, M, cfg.h_min if h_min is None else h_min, impl)
            mask = mask.to(dev)
    if channel is not None:
        # the scenario's realized channel (sim/channel.py): correlated-
        # fading scheduling ∧ battery gating replaces the i.i.d. draw
        mask = channel.mask.to(dev)
    return mask, noise_rng


def flat_partial(deltas, coef, m_div, d, block_rows, *, use_air):
    """The reduction of a flat aggregate over the rows of ``deltas`` ``[m,
    n_pad]``, before any division by the cohort's size: ``(part [n_pad],
    sq [m] | None)``. AirComp: one ``aircomp_reduce`` with the row
    coefficients ``coef / m_div`` (the scaled mean and the row norms); a
    mask or weights: the ``coef``-weighted row sum; otherwise the plain
    row sum. The unsharded round reduces all M rows (its AirComp route
    through ``aircomp_aggregate_flat``, the same reduction and noise); a
    rank of the sharded round (``sim/shard.py``) its own and all-reduces
    ``part``."""
    if use_air:
        return kops.aircomp_reduce(deltas, coef / m_div, d,
                                   block_rows=block_rows)
    if coef is not None:
        return torch.einsum("mn,m->n", deltas, coef), None
    return torch.sum(deltas, dim=0), None


def flat_finish(part, sq, spec, cfg: FedZOConfig, *, M, noise_rng=None,
                maskf=None, m_div=None, m_sched=None):
    """The flat aggregate from its reduced ``part`` (``flat_partial`` over
    all M rows, or its all-reduce across ranks), as a parameter tree, and
    the stats: the Eq.-17 noise when ``noise_rng`` is given
    (``aircomp_noise_flat``, ``sq`` the ``[M]`` row norms), else the
    division by ``m_div`` (a mask or weights, ``maskf`` set) or by M."""
    if noise_rng is not None:
        agg_flat, stats = aircomp_noise_flat(
            part, sq, maskf, m_div, m_sched, noise_rng, snr_db=cfg.snr_db,
            h_min=cfg.h_min, d=spec.d)
    elif maskf is not None:
        agg_flat, stats = part / m_div, {"m_effective": m_sched}
    else:
        agg_flat, stats = part / M, {}
    return unflatten(agg_flat, spec), stats


def aggregate(deltas, spec, block_rows, cfg: FedZOConfig, *, noise_rng,
              mask=None, weights=None, impl=None, dev=None):
    """The server's aggregate of one cohort's deltas, as a parameter tree,
    and the aggregation's stats: AirComp (Eq. 17) when ``cfg.aircomp`` and
    a noise key is given; else the masked (channel scheduling) and/or
    size-weighted mean; else the plain mean (``(1/M)·Σ_i Δ_i``).
    ``deltas``: the ``[M, n_pad]`` matrix (``spec`` set) or a stacked
    ``[M, ...]`` tree."""
    M = (deltas.shape[0] if spec is not None
         else _leaves(deltas)[0][1].shape[0])
    use_air = cfg.aircomp and noise_rng is not None
    if spec is not None and use_air:
        agg_flat, stats = aircomp_aggregate_flat(
            deltas, noise_rng, snr_db=cfg.snr_db, h_min=cfg.h_min, d=spec.d,
            mask=mask, weights=weights, block_rows=block_rows)
        return unflatten(agg_flat, spec), stats
    if spec is not None:
        maskf = m_div = m_sched = None
        if mask is not None or weights is not None:
            maskf, m_div, m_sched = mask_stats(mask, M, weights,
                                               device=deltas.device)
        part, _ = flat_partial(deltas, maskf, m_div, spec.d, block_rows,
                               use_air=False)
        return flat_finish(part, None, spec, cfg, M=M, maskf=maskf,
                           m_div=m_div, m_sched=m_sched)
    if use_air:
        return aircomp_aggregate(deltas, noise_rng, snr_db=cfg.snr_db,
                                 h_min=cfg.h_min, mask=mask, weights=weights,
                                 impl=impl)
    if mask is not None or weights is not None:
        maskf, m_div, m_sched = mask_stats(mask, M, weights, device=dev)
        agg = tree_map(
            lambda x: (torch.einsum("m...,m->...", x.to(torch.float32),
                                    maskf) / m_div).to(x.dtype), deltas)
        return agg, {"m_effective": m_sched}
    return tree_scale(1.0 / M,
                      tree_map(lambda x: torch.sum(x, 0), deltas)), {}


def finish_round(server_params, agg, air_stats, losses, cfg: FedZOConfig, *,
                 momentum=None, faults=None, cstate=None, new_cstate=None,
                 dev=None):
    """Everything of a round after its aggregate: server momentum, the new
    parameters, ``m_corrupt`` under faults and the metrics. Returns
    (new_params, metrics[, new_momentum][, new_cstate]), the tuple of
    ``round_simulated`` and of the sharded round."""
    if momentum is not None and cfg.server_momentum > 0:
        momentum = tree_map(
            lambda m, g: (cfg.server_momentum * m + g).to(m.dtype),
            momentum, agg)
        agg = momentum
    new_params = tree_add(server_params, agg)
    if faults is not None:
        # the mask is set under faults, so every aggregation reported
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


def round_simulated(loss_fn, server_params, client_batches, client_rngs,
                    cfg: FedZOConfig, *, channel_rng=None, momentum=None,
                    weights=None, faults=None, channel=None, cstate=None,
                    loss_wrap=None, state_fn=None, impl=None):
    """One communication round over the M sampled clients.

    ``loss_fn(params, batch) -> scalar`` for one client; ``server_params``
    a (nested) dict of tensors on the run's device; ``client_batches``
    leaves ``[M, H, b1, ...]`` on that device; ``client_rngs`` ``[M,
    words]`` raw keys and ``channel_rng`` a raw key (both CPU), of
    ``impl`` (``utils/prng.py``; None: threefry). ``weights`` ``[M]``:
    mean-1 size weights. ``momentum`` a tree like the parameters (with
    ``cfg.server_momentum > 0``). Returns (new_params, metrics[,
    new_momentum][, new_cstate]).

    The aggregation follows the reference on every route (``aggregate``):
    AirComp (Eq. 17) when ``cfg.aircomp``; else the masked (channel
    scheduling) and/or size-weighted mean; else the plain mean.

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
    mask, noise_rng = round_schedule(cfg, channel_rng, channel, M, dev,
                                     impl)
    res = cohort_phase(loss_fn, server_params, client_batches, client_rngs,
                       cfg, cstate=cstate, loss_wrap=loss_wrap, impl=impl)
    deltas, losses, spec = res.deltas, res.losses, res.spec
    if state_fn is not None:
        deltas, new_cstate = state_fn(deltas, cstate, spec)
    if faults is not None:
        # corrupt-then-guard the uploads in place; the survivors' mask
        # composes with the channel's
        deltas, fmask = (faults.apply_flat(deltas) if spec is not None
                         else faults.apply_tree(deltas))
        mask = fmask if mask is None else mask & fmask
    agg, air_stats = aggregate(
        deltas, spec, res.block_rows, cfg,
        noise_rng=noise_rng if channel_rng is not None else None,
        mask=mask, weights=weights, impl=impl, dev=dev)
    return finish_round(server_params, agg, air_stats, losses, cfg,
                        momentum=momentum, faults=faults, cstate=cstate,
                        new_cstate=new_cstate, dev=dev)


def make_pod_round_step(loss_fn_grouped, cfg: FedZOConfig, mesh):
    """Cross-silo FedZO round over the ``pod`` axis: each pod is one client,
    and all pods share the round's directions (common random seeds, the
    wire format of ``core/seedcomm.py``), so the step is one ZO iterate
    (H = 1) whose only cross-pod uplink is the per-pod coefficients, of
    which the update takes the mean over pods.

    Counterpart of ``repro/core/fedzo.py:452-532``. ``mesh.shape["pod"]``
    pods (``launch/mesh.make_pod_mesh``):

    - without a process group (``mesh.group`` None) the pods live in this
      process: ``loss_fn_grouped(params, batch)`` returns the ``[n_pod]``
      group losses, as the reference's GSPMD program computes them (its
      batch holds every pod's rows);
    - over a process group, one pod per rank: each rank's loss returns its
      own silo's ``[1]`` loss on its own batch, and the ``[b2 + 1, n_pod]``
      pack of every pod's coefficients and loss (zero-filled, each rank
      writing its column) is the one all-reduce; its sum over pods is the
      ``[b2]`` coefficient sum.

    The flat route (``cfg.flat_params``) runs one ``zo_dirnorms``, b2
    ``zo_walk`` and one ``zo_replay`` on the flattened buffer; the pytree
    route the per-leaf ``zo_axpy`` estimator. Metrics: ``loss`` (the mean
    over pods), ``per_pod_loss`` ``[n_pod]`` and ``coeff_pod_spread`` (the
    pods' coefficient std, averaged over directions).
    signature: (params, batch, rng) -> (params, metrics)
    """
    n_pod = mesh.shape["pod"]
    # a production mesh runs every pod in one DTensor program, as the
    # reference's GSPMD step: its [n_pod] losses need no pack
    group = None if getattr(mesh, "device_mesh", None) is not None \
        else getattr(mesh, "group", None)
    ddt = _DIRECTION_DTYPES[cfg.direction_dtype]

    def pods(coeffs, base):
        """(coeffs [b2, n_pod], base [n_pod]) of every pod."""
        if group is None:
            return coeffs, base
        pack = torch.zeros((cfg.b2 + 1, n_pod), dtype=torch.float32,
                           device=base.device)
        pack[:cfg.b2, mesh.rank] = coeffs[:, 0]
        pack[cfg.b2, mesh.rank] = base[0].to(torch.float32)
        mesh.all_reduce(pack)
        return pack[:cfg.b2], pack[cfg.b2]

    def metrics(coeffs, base):
        return {"loss": torch.mean(base), "per_pod_loss": base,
                "coeff_pod_spread": torch.mean(
                    torch.std(coeffs, dim=1, correction=0))}

    if cfg.flat_params:
        def flat_step(params, batch, rng):
            spec, br = flat_geometry(params, cfg.flat_block_rows)
            buf = flatten(params, spec)[None]
            keys = prng.counter_words(rng).reshape(1, 2).to(buf.device)
            # the sphere inv-norms once, shared by the walk and the replay
            inv = estimator.flat_inv_norms(keys, spec, cfg.b2,
                                           cfg.estimator, block_rows=br)

            def loss1(p, b):
                return loss_fn_grouped(tree_map(lambda v: v[0], p),
                                       b).reshape(1, -1)

            coeffs, base = estimator.flat_coefficients(
                loss1, buf, spec, batch, keys, mu=cfg.mu, b2=cfg.b2,
                kind=cfg.estimator, central=cfg.central, block_rows=br,
                inv=inv)
            coeffs, base = pods(coeffs[0], base[0])
            c_mean = torch.sum(coeffs, dim=1) / n_pod            # [b2]
            buf = estimator.flat_apply_coefficients(
                buf, spec, keys, c_mean[None], scale=-cfg.lr,
                kind=cfg.estimator, block_rows=br, inv=inv)
            return unflatten(buf[0], spec), metrics(coeffs, base)

        return flat_step

    def step(params, batch, rng):
        coeffs, base = estimator.coefficients(
            loss_fn_grouped, params, batch, rng, mu=cfg.mu, b2=cfg.b2,
            kind=cfg.estimator, direction_dtype=ddt,
            conv=cfg.direction_conv)
        coeffs, base = pods(coeffs, base)
        c_mean = torch.sum(coeffs, dim=1) / n_pod
        new_params = estimator.apply_coefficients(
            params, rng, c_mean, scale=-cfg.lr, kind=cfg.estimator,
            direction_dtype=ddt, conv=cfg.direction_conv)
        return new_params, metrics(coeffs, base)

    return step


def make_delta_agg_step(cfg: FedZOConfig, n_pod: int):
    """The dense-uplink aggregation program: per-pod model deltas (leaves
    with a leading ``[n_pod]`` axis) -> their mean, or the Eq.-17 AirComp
    aggregate when ``cfg.aircomp`` (``core/aircomp.aircomp_aggregate``).
    Counterpart of ``repro/core/fedzo.py:535-551``.
    signature: (deltas, rng) -> tree
    """
    def step(deltas, rng):
        with on_dtensors(tree_leaves(deltas)):   # the sharded program's
            if cfg.aircomp:
                agg, _ = aircomp_aggregate(deltas, rng, snr_db=cfg.snr_db,
                                           h_min=cfg.h_min)
                return agg
            return tree_map(lambda x: torch.mean(x, dim=0), deltas)

    return step
