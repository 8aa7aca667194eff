"""Sharded client fan-out: the simulated round over a ``clients`` mesh of
``torch.distributed`` ranks.

Counterpart of ``repro/sim/shard.py:37-207``. The flat simulation round
materializes the M client deltas as one ``[M, n_pad]`` matrix
(``core/fedzo.py``). Here each rank runs the local phases of its M/n
contiguous client rows (``fedzo.cohort_phase`` on the flat or wide route)
and reduces its rows first (``fedzo.flat_partial``: a partial
``aircomp_reduce`` with the coefficients ``maskf_l / m_div``, a masked or
weighted row sum, or a plain row sum), so the one large exchange is an
``all_reduce(SUM)`` of the ``[n_pad]`` partial. The per-row tensors (the
``[M]`` row norms, the ``[M, H]`` losses and, under faults, the ``[M]``
coefficients) travel as one ``all_reduce`` of a zero-filled ``[M, H + 2]``
tensor in which each rank writes its own rows: adding zeros is exact, so
it is bitwise an all-gather, and gloo takes it on CUDA tensors, which its
all-gather does not. Everything after the reduce (Δ_max, the Eq.-17 noise
through ``zo_walk``, momentum, metrics) runs on the replicated result
through ``fedzo.round_simulated``'s own ops (``flat_finish``, whose
AirComp branch is the noise half of ``aircomp_aggregate_flat``, and
``finish_round``), so on a one-rank mesh the sharded round is bitwise the
unsharded one, which is the reference's invariant.

Every rank runs the same engine program (the same key chain, the same
sampled cohort and batches) and keeps replicated parameters; the round
takes its rows of the cohort. Under rbg and unsafe_rbg keys each rank's
slice of ``client_rngs`` is the leading key dimension of its client
batch, so its draws come from the first key of its own shard, as jax's
``rng_bit_generator`` batching rule gives each device under
``shard_map``: with more than one rank, a sharded rbg round is not the
unsharded one, in either package.

The returned round is a drop-in ``round_fn`` for the engine
(``sim.engine.make_round_step``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedzo
from repro_torch.core.aircomp import mask_stats
from repro_torch.core.estimator import _device
from repro_torch.launch.mesh import make_clients_mesh  # noqa: F401  (re-export)
from repro_torch.utils.tree import tree_map


def make_sharded_round(loss_fn, cfg: FedZOConfig, mesh, *,
                       axis: str = "clients", store=None):
    """Signature-compatible replacement for ``fedzo.round_simulated``
    (flat or wide cfg only) with the M clients sharded over ``axis`` of
    ``mesh`` (``launch/mesh.make_clients_mesh``).

    The round consumes only the per-round cohort batches, so it runs under
    the resident engine and the tiered cohort stream alike. Passing the
    deployment's ``store=`` (either tier, or a client list) checks the
    split against the population when the round is built."""
    if not (cfg.flat_params or cfg.batch_directions):
        raise ValueError("the sharded round runs on the flat delta matrix — "
                         "set cfg.flat_params or cfg.batch_directions")
    n_dev = mesh.shape[axis]
    if n_dev > 1 and mesh.group is None:
        raise ValueError(f"a {n_dev}-member '{axis}' mesh without a process "
                         f"group: each rank must run its own shard")
    if store is not None:
        from repro_torch.sim.tiered import resolve_store
        store = resolve_store(store, tier="auto", device=mesh.device)
        if cfg.n_participating > store.n_clients:
            raise ValueError(
                f"cfg.n_participating={cfg.n_participating} exceeds the "
                f"store's population N={store.n_clients}")
        if cfg.n_participating % n_dev:
            raise ValueError(
                f"n_participating={cfg.n_participating} must divide evenly "
                f"over the {n_dev}-device '{axis}' mesh axis")

    def round_fn(loss_fn_, server_params, client_batches, client_rngs, cfg_,
                 *, channel_rng=None, momentum=None, weights=None,
                 faults=None, channel=None, impl=None):
        if loss_fn_ is not loss_fn or cfg_ is not cfg:
            # the deployment (route, geometry, split) is bound at
            # construction; a per-call substitute would run the old one
            raise ValueError("make_sharded_round binds loss_fn and cfg at "
                             "deployment time; build a new sharded round to "
                             "run a different loss/config")
        M = client_rngs.shape[0]
        if M % n_dev:
            raise ValueError(f"n_participating={M} must divide evenly over "
                             f"the {n_dev}-device '{axis}' mesh axis")
        m = M // n_dev
        rows = slice(mesh.rank * m, (mesh.rank + 1) * m)
        dev = _device(server_params)
        mask, noise_rng = fedzo.round_schedule(cfg, channel_rng, channel, M,
                                               dev, impl)
        res = fedzo.cohort_phase(
            loss_fn, server_params, tree_map(lambda v: v[rows],
                                             client_batches),
            client_rngs[rows], cfg, impl=impl)
        deltas_l, spec = res.deltas, res.spec
        use_air = cfg.aircomp and channel_rng is not None
        w_l = None if weights is None else weights[rows]
        maskf = m_div = m_sched = coef_l = None
        if faults is not None:
            # the guard's verdict is known per shard: scrub the rank's rows,
            # then sum the survivors and their coefficients across ranks
            # (``mask_stats`` of the combined mask, bitwise on one rank)
            deltas_l, ok_l = faults.model.scrub(deltas_l, faults.mask[rows],
                                                faults.corrupt[rows])
            mask_l = ok_l if mask is None else mask[rows] & ok_l
            coef_l, _, _ = mask_stats(mask_l, m, w_l, device=dev)
            sums = mesh.all_reduce(torch.stack([
                torch.sum(mask_l.to(torch.float32)), torch.sum(coef_l)]))
            m_sched = sums[0]
            m_div = (torch.clamp_min(sums[0], 1.0) if weights is None
                     else torch.clamp_min(sums[1], 1e-8))
        elif use_air or mask is not None or weights is not None:
            maskf, m_div, m_sched = mask_stats(mask, M, weights, device=dev)
            coef_l = maskf[rows]
        part, sq_l = fedzo.flat_partial(deltas_l, coef_l, m_div, spec.d,
                                        res.block_rows, use_air=use_air)
        part = mesh.all_reduce(part)
        H = res.losses.shape[1]
        pack = torch.zeros((M, H + 2), dtype=torch.float32, device=dev)
        pack[rows, :H] = res.losses.to(torch.float32)
        if sq_l is not None:
            pack[rows, H] = sq_l
        if faults is not None:
            pack[rows, H + 1] = coef_l
        mesh.all_reduce(pack)
        losses = pack[:, :H].contiguous()
        if faults is not None:
            maskf = pack[:, H + 1]
        agg, air_stats = fedzo.flat_finish(
            part, pack[:, H], spec, cfg, M=M,
            noise_rng=noise_rng if use_air else None, maskf=maskf,
            m_div=m_div, m_sched=m_sched)
        return fedzo.finish_round(server_params, agg, air_stats, losses, cfg,
                                  momentum=momentum, faults=faults, dev=dev)

    return round_fn
