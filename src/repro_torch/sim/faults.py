"""Fault injection and graceful degradation.

Counterpart of ``repro/sim/faults.py:44-244``. Real federations lose
clients to time-correlated outages, deadlines and corrupted uploads; this
module makes those processes part of every round, as in the reference:

- **Time-correlated availability**: each of the N clients carries a
  Gilbert–Elliott up/down Markov chain (up→down with probability
  ``p_fail``, down→up with ``p_recover`` per round); a sampled client in
  the down state never uploads. The stationary up-fraction is
  ``p_recover / (p_fail + p_recover)``.
- **Stragglers**: per-round exponential latencies; a sampled client whose
  latency exceeds ``deadline`` misses the round.
- **Corrupted uploads**: with probability ``p_corrupt`` a client's delta
  arrives all-NaN, all-Inf or scaled by ``corrupt_scale``.
- **The finite-guard**: per-client deltas that are non-finite (or, with
  ``guard_norm > 0``, norm-exploded) are zeroed and masked before the
  aggregation. With the guard on, a poisoned client gives the same
  parameters, bit for bit, as the same client channel-masked; with it off
  the poison propagates.

The chain and the draws are integer and host-side: the ``[N]`` state and
the ``[M]`` masks live on the CPU with the keys (``utils/prng.py``), and
only the masks the aggregation reads reach the run's device. The draws are
the reference's: the availability and corruption uniforms bitwise, the
straggler latencies within an ulp (``prng.exponential``: ``torch.log1p``
against XLA's), so a straggler mask differs only where a latency lies
within an ulp of ``deadline``.

The scrub works on the round's own delta matrix in place: the ``[M,
n_pad]`` cohort of a full-width LM is gigabytes, so a poisoned row is
filled and a rejected row zeroed where it lies, and a row's squared norm is
one dot product of the row with itself (no cohort-sized temporary). The
norm runs over all ``n_pad`` columns, pad included, as the reference's
does (``faults.py:197``). The tiered store's cohort round realizes a
round's faults with ``realize`` from the availability slice its host
stream replayed; the sharded round (``sim/shard.py``) scrubs each rank's
rows with ``FaultModel.scrub`` and all-reduces the survivors' counts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils import prng
from repro_torch.utils.flatparams import _leaves


class DivergenceError(RuntimeError):
    """A run diverged (non-finite params or metrics) and stayed divergent
    through the bounded lr-backoff retries."""

    def __init__(self, round_idx: int, retries: int, lr: float,
                 detail: str = ""):
        self.round = int(round_idx)
        self.retries = int(retries)
        self.lr = float(lr)
        msg = (f"experiment diverged at round {round_idx} and stayed "
               f"divergent after {retries} lr-backoff retries "
               f"(last lr={lr:g})")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def _rows(mask) -> list:
    """Row indices where a host-side ``[M]`` bool mask is set."""
    return torch.nonzero(mask).flatten().tolist()


def _flat_row_sq_norms(deltas):
    """``[M]`` float32 ‖Δ_i‖² of a ``[M, n]`` float32 matrix, one dot per
    row (no ``[M, n]`` temporary)."""
    return torch.stack([torch.dot(row, row) for row in deltas])


def _tree_row_sq_norms(deltas):
    """``[M]`` ‖Δ_i‖² over stacked tree deltas (leading ``[M]`` axes), in
    float32, summed over the leaves in order."""
    return sum(torch.sum(torch.square(leaf.to(torch.float32)).reshape(
        leaf.shape[0], -1), dim=1) for _, leaf in _leaves(deltas))


@dataclass(frozen=True)
class FaultModel:
    """Fault-process configuration (hashable). Every process defaults off;
    the finite-guard defaults on."""
    # Gilbert–Elliott availability chain (per client, per round)
    p_fail: float = 0.0        # up → down transition probability
    p_recover: float = 1.0     # down → up transition probability
    # stragglers: latency ~ Exponential(mean=straggler_mean); a sampled
    # client with latency > deadline misses the round. 0 disables.
    deadline: float = 0.0
    straggler_mean: float = 1.0
    # corrupted uploads
    p_corrupt: float = 0.0
    corrupt_mode: str = "nan"  # nan | inf | scale
    corrupt_scale: float = 1e8
    # server-side finite-guard: zero and mask non-finite (and, with
    # guard_norm > 0, norm-exploded) client deltas before aggregation
    guard: bool = True
    guard_norm: float = 0.0    # > 0: also mask rows with ‖Δ‖ > this

    def __post_init__(self):
        if self.corrupt_mode not in ("nan", "inf", "scale"):
            raise ValueError(f"corrupt_mode must be nan|inf|scale, got "
                             f"{self.corrupt_mode!r}")
        for name in ("p_fail", "p_recover", "p_corrupt"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} is not a probability")

    @property
    def stationary_up(self) -> float:
        """Stationary availability of the Gilbert–Elliott chain."""
        denom = self.p_fail + self.p_recover
        return 1.0 if denom == 0 else self.p_recover / denom

    def describe(self) -> dict:
        """The configuration as a plain-JSON manifest block, with the
        stationary availability."""
        d = dataclasses.asdict(self)
        d["stationary_up"] = self.stationary_up
        return d

    # -- carry state ---------------------------------------------------------
    def init_state(self, n_clients: int):
        """Round-0 availability: every client up (``[N]`` bool, CPU)."""
        return torch.ones((n_clients,), dtype=torch.bool)

    def advance(self, k_avail, state, impl=None):
        """One Gilbert–Elliott transition of all N clients: ``[N]`` bool →
        next round's ``[N]`` bool. Pure in (key, state); ``impl`` the key's
        (``utils/prng.py``), as for every draw below."""
        u = prng.uniform(k_avail, tuple(state.shape), impl=impl)
        return torch.where(state, u >= self.p_fail, u < self.p_recover)

    def _realize(self, k_lat, k_corr, mask, impl=None) -> "RoundFaults":
        """Straggler and corruption draws for a cohort whose availability
        ``mask`` ``[M]`` is known: the tail shared by ``step`` and
        ``realize``."""
        m = mask.shape[0]
        if self.deadline > 0:
            lat = prng.exponential(k_lat, (m,), impl=impl) \
                * self.straggler_mean
            mask = mask & (lat <= self.deadline)
        if self.p_corrupt > 0:
            corrupt = prng.uniform(k_corr, (m,), impl=impl) < self.p_corrupt
        else:
            corrupt = torch.zeros((m,), dtype=torch.bool)
        return RoundFaults(model=self, mask=mask, corrupt=corrupt)

    def step(self, key, state, idx, impl=None) -> tuple:
        """Advance the chain one round and realize the faults of the
        sampled cohort ``idx`` (``[M]`` client ids): ``(new_state,
        RoundFaults)``."""
        ks = prng.split(key, 3, impl)
        up = self.advance(ks[0], state, impl)
        return up, self._realize(ks[1], ks[2], up[idx], impl)

    def realize(self, key, avail, impl=None) -> "RoundFaults":
        """One round's faults from a known availability slice ``avail``
        ``[M]``: the same 3-way split as ``step``, the availability stream
        left unused."""
        ks = prng.split(key, 3, impl)
        return self._realize(ks[1], ks[2], avail, impl)

    # -- delta scrubbing (every aggregation path) ----------------------------
    def _poison_(self, row):
        """Overwrite one delta row (or leaf row) with its poisoned upload."""
        if self.corrupt_mode == "scale":
            return row.mul_(float(torch.tensor(self.corrupt_scale,
                                               dtype=row.dtype)))
        return row.fill_(float("nan") if self.corrupt_mode == "nan"
                         else float("inf"))

    def _guard(self, sq, mask):
        """The surviving rows: ``mask`` ∧ (guard on: finite, within
        ``guard_norm``), on ``sq``'s device."""
        ok = mask.to(sq.device)
        if self.guard:
            good = torch.isfinite(sq)
            if self.guard_norm > 0:
                gn = np.float32(self.guard_norm)
                good = good & (sq <= float(gn * gn))
            ok = ok & good
        return ok

    def scrub(self, deltas, mask, corrupt):
        """Corrupt-then-guard a flat ``[M, n]`` delta matrix, IN PLACE.

        Poisons the flagged rows, then (guard on) rejects rows that arrive
        non-finite or norm-exploded. Returns ``(deltas, ok [M] bool)``:
        ``ok`` is availability ∧ deadline ∧ guard on the deltas' device,
        and every row it rejects is exactly zero, so the masked aggregation
        over the survivors is bitwise the same round with those clients
        channel-masked. ``mask`` and ``corrupt`` are host-side ``[M]``
        bools."""
        for i in (_rows(corrupt) if self.p_corrupt > 0 else ()):
            self._poison_(deltas[i])
        if self.guard:
            ok = self._guard(_flat_row_sq_norms(deltas), mask)
            deltas.masked_fill_(~ok[:, None], 0.0)
        else:
            ok = mask.to(deltas.device)
            for i in _rows(~mask):
                deltas[i].zero_()
        return deltas, ok

    def scrub_tree(self, deltas, mask, corrupt):
        """``scrub`` of stacked tree deltas (leading ``[M]`` axes), in
        place."""
        leaves = [leaf for _, leaf in _leaves(deltas)]
        for i in (_rows(corrupt) if self.p_corrupt > 0 else ()):
            for leaf in leaves:
                self._poison_(leaf[i])
        dev = leaves[0].device
        if self.guard:
            ok = self._guard(_tree_row_sq_norms(deltas), mask)
            for leaf in leaves:
                leaf.masked_fill_(
                    ~ok.reshape((-1,) + (1,) * (leaf.dim() - 1)), 0)
        else:
            ok = mask.to(dev)
            for i in _rows(~mask):
                for leaf in leaves:
                    leaf[i].zero_()
        return deltas, ok

    def replace(self, **kw) -> "FaultModel":
        return dataclasses.replace(self, **kw)


class RoundFaults(NamedTuple):
    """One round's realized faults of the M sampled clients, handed to the
    round functions by ``sim.engine.make_round_step``: ``model`` carries
    the scrub parameters, ``mask`` and ``corrupt`` are ``[M]`` bools on the
    CPU."""
    model: FaultModel
    mask: torch.Tensor      # [M] bool: client reachable (up ∧ deadline met)
    corrupt: torch.Tensor   # [M] bool: upload poisoned in flight

    def apply_flat(self, deltas):
        """Scrub a flat ``[M, n_pad]`` delta matrix in place -> (deltas,
        ok ``[M]``)."""
        return self.model.scrub(deltas, self.mask, self.corrupt)

    def apply_tree(self, deltas):
        """Scrub stacked tree deltas in place -> (deltas, ok ``[M]``)."""
        return self.model.scrub_tree(deltas, self.mask, self.corrupt)

    @property
    def n_corrupt(self):
        return torch.sum(self.corrupt.to(torch.float32))
