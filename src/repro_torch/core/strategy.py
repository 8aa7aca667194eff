"""Composable algorithm strategies: FedZO, FedAvg, ZO-FedProx, ZO-FedDyn,
ZO-SCAFFOLD.

Counterpart of ``repro/core/strategy.py:72-347``. One round decomposes into
four pluggable pieces, all wired through the same simulated round
(``fedzo.round_simulated``), so every aggregation path (pytree, flat, wide,
AirComp, channel scheduling, size weighting) serves every algorithm:

- **loss transform** (``loss_wrap``): wraps the ZO loss query (FedProx's
  proximal term, FedDyn's dynamic regularizer); the estimator never sees
  the algorithm. A wrapped loss carries its own client-batched form
  (``.batched``: the cohort loss plus the per-row regularizers, in tree ops
  over the leading axis), because the flat and wide routes run the cohort
  as one batched loss where the reference maps each client's wrapped loss
  with ``jax.vmap``. On the wide route the batched loss sees ``M·r``
  parameter rows against ``M`` batch rows, so the per-client state is
  repeated r times along the row axis (row m·r + j meets client m's).
- **client state**: ``[N, ...]`` stacked per-client trees (SCAFFOLD
  controls, FedDyn duals) carried by the engine; the round gathers the
  sampled rows by ``idx``, updates them and scatters them back.
- **delta transform** (``state_fn``): the post-phase correction on the
  ``[M, n_pad]`` delta matrix (flat, wide) or the stacked delta tree.
- **server update**: SCAFFOLD's global control, FedDyn's ``x ← x̄ − h/α``,
  from the aggregate ``Δ̄ = x' − x_t``.

``AlgoStrategy`` is FedZO. ``HookedZO`` builds a round's hooks from its
server parameters, config and state (``hooks``, ``server_step``), so a
batched sweep (``sim/sweep.py``) runs them per scenario of one cohort.
ZO-FedProx with ``prox_mu=0`` and ZO-FedDyn with ``dyn_alpha=0`` elide
their hooks and run the base round unchanged. The
registry (``register``, ``get``, ``resolve``) is what
``sim.engine.make_round_step`` dispatches on.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedavg, fedzo
from repro_torch.utils import prng
from repro_torch.utils.flatparams import flatten, flatten_stacked, unflatten
from repro_torch.utils.tree import (tree_dot, tree_leaves, tree_map,
                                    tree_sub, tree_zeros_like)


def _sq_diff(a, b):
    """Σ‖a − b‖² over a tree pair, float32, leaf by leaf in order."""
    return sum(torch.sum(torch.square(la.to(torch.float32) -
                                      lb.to(torch.float32)))
               for la, lb in zip(tree_leaves(a), tree_leaves(b)))


def _rows(x, n):
    """Sums of ``x`` ``[n, ...]`` over everything but the row axis."""
    return torch.sum(x.reshape(n, -1), dim=1)


def _sq_diff_rows(a, b):
    """``[n]`` of ``_sq_diff`` per row of the stacked tree ``a`` (leaves
    ``[n, ...]``) against ``b`` (one tree, broadcast)."""
    n = tree_leaves(a)[0].shape[0]
    return sum(_rows(torch.square(la.to(torch.float32) -
                                  lb.to(torch.float32)), n)
               for la, lb in zip(tree_leaves(a), tree_leaves(b)))


def _dot_rows(x, y):
    """``[n]`` of ``tree_dot`` per row of two stacked trees: a float32 sum
    per leaf and row, then the sum over the leaves."""
    n = tree_leaves(y)[0].shape[0]
    return torch.sum(torch.stack(
        [_rows(lx.to(torch.float32) * ly.to(torch.float32), n)
         for lx, ly in zip(tree_leaves(x), tree_leaves(y))]), dim=0)


def _per_row(cst, params):
    """The cohort state ``cst`` (leaves ``[M, ...]``) repeated to the rows
    of ``params`` (leaves ``[M·r, ...]``): row m·r + j takes row m."""
    r = tree_leaves(params)[0].shape[0] // tree_leaves(cst)[0].shape[0]
    return cst if r == 1 else tree_map(
        lambda v: v.repeat_interleave(r, dim=0), cst)


def _wrap(lf, add, add_rows):
    """The loss ``add(lf(p, b), p)`` of one client, carrying ``.batched``:
    ``add_rows`` of the cohort's losses (``fedzo.batched_loss``) and its
    stacked weights; and ``.add_rows`` itself, which a batched sweep adds
    to each scenario's rows of one cohort loss."""
    cohort = fedzo.batched_loss(lf)

    def wrapped(p, b):
        return add(lf(p, b), p)

    def batched(p, b):
        return add_rows(cohort(p, b), p)

    wrapped.batched = batched
    wrapped.add_rows = add_rows
    return wrapped


def _stack_zeros(template, n: int):
    """``[n, ...]``-stacked zeros like a tree."""
    return tree_map(lambda l: torch.zeros((n,) + tuple(l.shape),
                                          dtype=l.dtype, device=l.device),
                    template)


class AlgoStrategy:
    """Base strategy: plain FedZO (paper Algorithm 1).

    The engine calls, per round::

        params', metrics, momentum', zstate' = strat.run_round(
            loss_fn, params, batches, k_zo, cfg, channel_rng=..,
            momentum=.., zstate=.., idx=.., round_fn=.., impl=.., **wkw)

    ``zstate`` is None for stateless strategies, else ``{"client": [N,
    ...] stacked tree, "server": tree}``; ``idx`` the round's sampled
    client ids (``[M]`` int64, CPU); ``k_zo`` a raw key (CPU) and ``impl``
    its ``prng.Impl`` (None: threefry).
    """
    name = "fedzo"
    stateful = False
    # a custom round_fn replaces fedzo.round_simulated wholesale and knows
    # nothing of strategy hooks
    supports_round_fn = True

    def validate(self, cfg: FedZOConfig):
        """Config validation when the round step is built."""

    def has_momentum(self, cfg: FedZOConfig) -> bool:
        return cfg.server_momentum > 0

    def init_state(self, params, cfg: FedZOConfig, n_clients: int):
        """Round-0 strategy carry (None when the strategy is stateless)."""
        return None

    def run_round(self, loss_fn, params, batches, k_zo, cfg: FedZOConfig, *,
                  channel_rng=None, momentum=None, zstate=None, idx=None,
                  round_fn=None, impl=None, **wkw):
        fz = round_fn if round_fn is not None else fedzo.round_simulated
        rngs = prng.split(k_zo, cfg.n_participating, impl)
        if self.has_momentum(cfg):
            params, metrics, momentum = fz(
                loss_fn, params, batches, rngs, cfg, channel_rng=channel_rng, impl=impl,
                momentum=momentum, **wkw)
        else:
            params, metrics = fz(loss_fn, params, batches, rngs, cfg,
                                 channel_rng=channel_rng, impl=impl, **wkw)
        return params, metrics, momentum, zstate


class FedAvgStrategy(AlgoStrategy):
    """First-order FedAvg as a strategy (no ZO keys, no momentum carry)."""
    name = "fedavg"

    def has_momentum(self, cfg):
        return False

    def run_round(self, loss_fn, params, batches, k_zo, cfg, *,
                  channel_rng=None, momentum=None, zstate=None, idx=None,
                  round_fn=None, impl=None, **wkw):
        params, metrics = fedavg.round_simulated(
            loss_fn, params, batches, cfg, channel_rng=channel_rng, impl=impl, **wkw)
        return params, metrics, momentum, zstate


class HookedZO(AlgoStrategy):
    """The FedZO round with a strategy's hooks, each built per round from
    the server parameters ``params`` and ``cfg`` (``hooks``): a loss wrap,
    a delta transform on the cohort's state, and the server step after the
    aggregate (``server_step``). ``active(cfg)`` False elides them all: the
    plain FedZO round. A batched sweep (``sim/sweep.py``) calls the same
    hooks once per scenario of its ``[S·M]`` cohort."""
    supports_round_fn = False

    def active(self, cfg) -> bool:
        return True

    def hooks(self, params, cfg, zstate):
        """(loss_wrap | None, state_fn | None) of one round from
        ``params``; ``loss_wrap(lf, cst)`` as ``fedzo.round_simulated``
        takes it (its loss carries ``.batched`` and ``.add_rows``, the
        per-row term alone)."""
        return None, None

    def server_step(self, params, params_new, cfg, zstate, idx, cohort,
                    new_cohort):
        """(params', zstate') from the aggregated ``params_new``."""
        return params_new, zstate

    def run_round(self, loss_fn, params, batches, k_zo, cfg, *,
                  channel_rng=None, momentum=None, zstate=None, idx=None,
                  round_fn=None, impl=None, **wkw):
        if not self.active(cfg):
            return super().run_round(
                loss_fn, params, batches, k_zo, cfg, channel_rng=channel_rng,
                impl=impl, momentum=momentum, zstate=zstate, idx=idx,
                round_fn=round_fn, **wkw)
        rngs = prng.split(k_zo, cfg.n_participating, impl)
        loss_wrap, state_fn = self.hooks(params, cfg, zstate)
        cohort = None
        if self.stateful:
            wkw["cstate"] = cohort = self._gather(zstate, idx)
        if self.has_momentum(cfg):
            wkw["momentum"] = momentum
        out = fedzo.round_simulated(
            loss_fn, params, batches, rngs, cfg, channel_rng=channel_rng,
            impl=impl, loss_wrap=loss_wrap, state_fn=state_fn, **wkw)
        if self.has_momentum(cfg):
            momentum = out[2]
        params_new, zstate = self.server_step(
            params, out[0], cfg, zstate, idx, cohort,
            out[-1] if self.stateful else None)
        return params_new, out[1], momentum, zstate


class ZOFedProx(HookedZO):
    """ZO-FedProx: the FedZO round with the proximal term
    (prox_mu/2)·‖x − x_t‖² in every local ZO loss query. Stateless;
    composes with server momentum. ``prox_mu=0`` elides the wrap."""
    name = "fedprox"

    def active(self, cfg):
        return cfg.prox_mu > 0

    def hooks(self, params, cfg, zstate):
        half_mu = 0.5 * cfg.prox_mu

        def loss_wrap(lf, cst):
            del cst
            return _wrap(
                lf, lambda l, p: l + half_mu * _sq_diff(p, params),
                lambda l, p: l + half_mu * _sq_diff_rows(p, params))

        return loss_wrap, None


class _StatefulZO(HookedZO):
    """Shared plumbing for strategies with a per-client and a server
    state."""
    stateful = True

    def validate(self, cfg):
        self.has_momentum(cfg)  # rejects cfg.server_momentum > 0

    def has_momentum(self, cfg):
        if cfg.server_momentum > 0:
            raise ValueError(
                f"strategy {self.name!r} carries its own server-side "
                f"control state and does not compose with "
                f"cfg.server_momentum — run momentum through fedzo/fedprox")
        return False

    def _gather(self, zstate, idx):
        return tree_map(lambda a: a[idx.to(a.device)], zstate["client"])

    def _scatter(self, zstate, idx, cohort):
        return tree_map(
            lambda a, u: a.index_copy(0, idx.to(a.device), u.to(a.dtype)),
            zstate["client"], cohort)


class ZOFedDyn(_StatefulZO):
    """ZO-FedDyn (Acar et al. 2021, zeroth-order form). Client i's ZO loss
    query is L(x) − ⟨h_i, x⟩ + (α/2)‖x − x_t‖², and its dual is refreshed
    from its own delta, h_i ← h_i − α·Δ_i. The server keeps h ← h −
    α·(M/N)·Δ̄ and steps x ← (x_t + Δ̄) − h/α. ``dyn_alpha=0`` elides
    everything."""
    name = "feddyn"

    def active(self, cfg):
        return cfg.dyn_alpha > 0

    def init_state(self, params, cfg, n_clients):
        if cfg.dyn_alpha <= 0:
            return None
        return {"client": _stack_zeros(params, n_clients),
                "server": tree_zeros_like(params)}

    def hooks(self, params, cfg, zstate):
        a = cfg.dyn_alpha

        def loss_wrap(lf, h):
            return _wrap(
                lf,
                lambda l, p: (l - tree_dot(h, p)
                              + (0.5 * a) * _sq_diff(p, params)),
                lambda l, p: (l - _dot_rows(_per_row(h, p), p)
                              + (0.5 * a) * _sq_diff_rows(p, params)))

        def state_fn(deltas, h, spec):
            d_tree = unflatten(deltas, spec) if spec is not None else deltas
            new_h = tree_map(lambda hi, d: (hi - a * d).to(hi.dtype), h,
                             d_tree)
            return deltas, new_h

        return loss_wrap, state_fn

    def server_step(self, params, params_new, cfg, zstate, idx, cohort,
                    new_cohort):
        # the server step from the aggregate Δ̄ = x' − x_t, whatever the
        # aggregation (AirComp noise, masking, weighting) made of it
        a = cfg.dyn_alpha
        agg = tree_sub(params_new, params)
        frac = cfg.n_participating / cfg.n_devices
        hs = tree_map(lambda h, d: (h - (a * frac) * d).to(h.dtype),
                      zstate["server"], agg)
        params_new = tree_map(lambda p, h: (p - h / a).to(p.dtype),
                              params_new, hs)
        return params_new, {"client": self._scatter(zstate, idx, new_cohort),
                            "server": hs}


class ZOScaffold(_StatefulZO):
    """ZO-SCAFFOLD (Karimireddy et al. 2020, option II, zeroth-order
    post-phase form). The correction −lr·(c − c_i) of each local step is
    the same over the H iterates, so it is applied once in delta space:
    Δ_i ← Δ_zo,i − lr·H·(c − c_i). The client control becomes
    c_i⁺ = −Δ_zo,i/(lr·H) and the server's moves by
    c ← c + (M/N)·mean_i(c_i⁺ − c_i)."""
    name = "scaffold"

    def init_state(self, params, cfg, n_clients):
        return {"client": _stack_zeros(params, n_clients),
                "server": tree_zeros_like(params)}

    def hooks(self, params, cfg, zstate):
        c = zstate["server"]
        eta = cfg.lr * cfg.local_iters  # total local step length lr·H

        def state_fn(deltas, c_i, spec):
            if spec is not None:
                c_flat = flatten(c, spec)
                ci_flat = flatten_stacked(c_i, spec)
                new_deltas = deltas - eta * (c_flat[None, :] - ci_flat)
                new_ci = tree_map(lambda ref, u: u.to(ref.dtype), c_i,
                                  unflatten((-1.0 / eta) * deltas, spec))
            else:
                new_deltas = tree_map(
                    lambda d, cc, cic: (d - eta * (cc[None] - cic)
                                        ).to(d.dtype), deltas, c, c_i)
                new_ci = tree_map(
                    lambda cic, d: ((-1.0 / eta) * d).to(cic.dtype),
                    c_i, deltas)
            return new_deltas, new_ci

        return None, state_fn

    def server_step(self, params, params_new, cfg, zstate, idx, cohort,
                    new_cohort):
        frac = cfg.n_participating / cfg.n_devices
        dmean = tree_map(
            lambda n_, o: torch.mean(n_.to(torch.float32) -
                                     o.to(torch.float32), dim=0),
            new_cohort, cohort)
        c_new = tree_map(lambda cc, d: (cc + frac * d).to(cc.dtype),
                         zstate["server"], dmean)
        return params_new, {"client": self._scatter(zstate, idx, new_cohort),
                            "server": c_new}


# ---------------------------------------------------------------------------
# registry

STRATEGIES: dict = {}


def register(strat: AlgoStrategy) -> AlgoStrategy:
    """Register a strategy instance under its ``name`` (last write wins, so
    a tuned variant can replace a built-in one)."""
    STRATEGIES[strat.name] = strat
    return strat


register(AlgoStrategy())
register(FedAvgStrategy())
register(ZOFedProx())
register(ZOFedDyn())
register(ZOScaffold())


def get(name: str) -> AlgoStrategy:
    """Look up a registered strategy by name, loudly."""
    try:
        return STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; registered strategies: "
            f"{sorted(STRATEGIES)}") from None


def resolve(strategy=None, algo: Optional[str] = None,
            cfg: Optional[FedZOConfig] = None) -> AlgoStrategy:
    """An explicit ``strategy`` (name or instance) wins; the deprecated
    ``algo=`` string is honored with a DeprecationWarning; otherwise
    ``cfg.strategy``."""
    if strategy is not None:
        return get(strategy) if isinstance(strategy, str) else strategy
    if algo is not None:
        warnings.warn(
            "the algo= string kwarg is deprecated — pass strategy="
            "(a name or AlgoStrategy) or set cfg.strategy",
            DeprecationWarning, stacklevel=3)
        return get(algo)
    return get(cfg.strategy if cfg is not None else "fedzo")
