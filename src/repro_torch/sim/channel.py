"""The wireless scenario: correlated fading and energy-gated participation.

Counterpart of ``repro/sim/channel.py:84-283``. The paper's AirComp round
draws one i.i.d. Rayleigh channel per round; ``ChannelModel`` carries the
channel through the run instead, as in the reference:

- **Time-correlated flat fading**: each of the N clients carries a complex
  Gauss–Markov (AR(1)) chain, h' = ρ·h + sqrt(1 − ρ²)·w with w ~ CN(0, 1).
  ρ = 0 is the i.i.d. draw itself; the stationary law is CN(0, 1) for every
  ρ.
- **Energy-gated participation**: each client carries a battery, debited by
  ``tx_cost`` every round it transmits; a drained client is masked out
  like a deep-faded or faulted one.

The chain is integer fixed point, as in the reference (``channel.py:
38-74``): fading in Q.14 int32 ``[N, 2]``, the AR(1) coefficients in Q.12,
the CN(0, 1) innovation a 24-term Irwin–Hall sum of raw Threefry words,
batteries in Q.16, and the scheduling threshold compares the exact integer
|h|² in Q.20 against ``round(h_min²·2²⁰)``. No float operation decides
anything, so the port's chain, masks and batteries are the reference's
bit for bit. The state is tiny and lives on the CPU with the keys; the
round moves only the ``[M]`` transmit mask to the run's device.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.utils import prng

# salt of the chain's round-0 key: folded into the experiment key, so the
# round key chain is never consumed by the initial draw
INIT_SALT = 0x6368  # "ch"

_FRAC_H = 14        # fading component fixed point: Q.14
_FRAC_C = 12        # AR(1) coefficient fixed point: Q.12
_FRAC_B = 16        # battery fixed point: Q.16
_FRAC_M = 20        # |h|² fixed point of the h_min compare
_CLT_DRAWS = 24     # Irwin–Hall terms per component (variance 1/2 exactly)
_H_CLIP = (1 << (_FRAC_H + 4)) - 1   # |h| < 16: int32 overflow guard


def init_key(key):
    """The chain's round-0 key, folded off the experiment key."""
    return prng.fold_in(key, INIT_SALT)


def fading(state):
    """The chain's ``[N]`` complex64 fading from its integer state."""
    return _to_complex(state[0])


def battery(state):
    """The chain's ``[N]`` float32 battery levels."""
    return state[1].to(torch.float32) * (2.0 ** -_FRAC_B)


def _to_complex(h_q):
    """Q.14 int32 ``[..., 2]`` → complex64: an exact convert and a
    power-of-two scale."""
    f = h_q.to(torch.float32) * (2.0 ** -_FRAC_H)
    return torch.complex(f[..., 0], f[..., 1])


@dataclass(frozen=True)
class ChannelModel:
    """Wireless-scenario configuration (hashable). ``rho``: the AR(1)
    fading correlation (0: i.i.d. per round; quantized to Q.12,
    ``describe()`` gives the effective value). ``battery`` > 0 enables
    energy gating with that initial budget per client; ``tx_cost`` is the
    energy a transmission debits."""
    rho: float = 0.0
    battery: float = 0.0
    tx_cost: float = 1.0

    def __post_init__(self):
        if not 0.0 <= self.rho < 1.0:
            raise ValueError(f"rho={self.rho} must be in [0, 1)")
        if self.tx_cost <= 0.0:
            raise ValueError(f"tx_cost={self.tx_cost} must be positive")
        if self.battery >= 30000.0 or self.tx_cost >= 30000.0:
            raise ValueError("battery/tx_cost must stay below 30000 "
                             "(Q.16 int32 energy accounting)")

    @classmethod
    def from_doppler(cls, fd_T: float, **kw) -> "ChannelModel":
        """From a normalized Doppler spread fd·T under the exponential
        correlation model ρ = exp(−2π·fd·T)."""
        if fd_T < 0:
            raise ValueError(f"fd_T={fd_T} must be >= 0")
        return cls(rho=math.exp(-2.0 * math.pi * fd_T), **kw)

    @property
    def gated(self) -> bool:
        """Whether energy gating is active."""
        return self.battery > 0.0

    @property
    def coherence_rounds(self) -> float:
        """Rounds until the fading autocorrelation decays to 1/e."""
        return math.inf if self.rho >= 1.0 else (
            0.0 if self.rho == 0.0 else -1.0 / math.log(self.rho))

    def _coeffs(self) -> tuple:
        """(ρ_q, σ_q) in Q.12, σ from the quantized ρ."""
        rho_q = min(int(round(self.rho * (1 << _FRAC_C))), (1 << _FRAC_C) - 1)
        sigma_q = int(round(math.sqrt((1 << (2 * _FRAC_C)) - rho_q ** 2)))
        return rho_q, sigma_q

    def describe(self) -> dict:
        """The configuration as a plain-JSON manifest block, with the
        effective ρ, the coherence time and the gating flag."""
        d = dataclasses.asdict(self)
        d["rho_effective"] = self._coeffs()[0] / (1 << _FRAC_C)
        d["coherence_rounds"] = self.coherence_rounds
        d["energy_gated"] = self.gated
        return d

    # -- carry state ---------------------------------------------------------
    def init_state(self, n_clients: int, key) -> tuple:
        """Round-0 state ``(h [N, 2] int32 Q.14, battery [N] int32 Q.16)``
        on the CPU; ``h`` from the stationary law. ``key`` should be
        ``init_key(experiment_key)``."""
        h0 = self._innovation(key, n_clients)
        batt = torch.full(
            (n_clients,), int(round(max(self.battery, 0.0) * (1 << _FRAC_B))),
            dtype=torch.int32)
        return h0, batt

    def _innovation(self, key, n: int):
        """One CN(0, 1) draw as int32 ``[n, 2]`` Q.14 from integer ops: per
        component the sum of 24 22-bit words, centred, shifted to Q.14
        (``jax.random.bits(key, (n, 2, 24), uint32)`` underneath)."""
        u = prng.random_bits(key, (n, 2, _CLT_DRAWS))
        s = torch.sum((u >> 10).to(torch.int32), dim=-1, dtype=torch.int32)
        s = s - _CLT_DRAWS // 2 * (1 << 22)
        return (s + 256) >> 9

    def advance(self, key, h):
        """One AR(1) transition of all N clients; ρ = 0 returns the fresh
        draw itself. The Q.12 × Q.14 mul-add stays below 2³¹, the shift
        back rounds half up, the result is clipped to the guard."""
        w = self._innovation(key, h.shape[0])
        if self.rho == 0.0:
            return w
        rho_q, sigma_q = self._coeffs()
        nxt = (rho_q * h + sigma_q * w + (1 << (_FRAC_C - 1))) >> _FRAC_C
        return torch.clamp(nxt, -_H_CLIP, _H_CLIP)

    def step(self, key, state, idx, *, h_min: float,
             schedule: bool) -> tuple:
        """Advance the chain one round and realize the channel of the
        sampled cohort ``idx`` (``[M]`` client ids): ``(new_state,
        RoundChannel)``. A sampled client transmits iff it is scheduled
        (``schedule``: |h| ≥ h_min on the post-advance fading) and its
        battery covers ``tx_cost``; transmitting clients are debited."""
        h, batt = state
        h = self.advance(key, h)
        h_coh = h[idx]
        mask = torch.ones(tuple(idx.shape), dtype=torch.bool)
        if schedule:
            # |h|² ≥ h_min² on exact integer magnitudes (components in
            # Q.10), the threshold by float32 square, scale and round
            # (half to even, as jnp.round)
            r = h_coh >> (_FRAC_H - 10)
            mag = r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]
            h2 = torch.square(torch.tensor(h_min, dtype=torch.float32))
            thresh = torch.round(h2 * float(1 << _FRAC_M)).to(torch.int32)
            mask = mag >= thresh
        if self.gated:
            cost = int(round(self.tx_cost * (1 << _FRAC_B)))
            mask = mask & (batt[idx] >= cost)
            # idx is a permutation prefix (unique ids): each transmitting
            # client is debited once
            debit = torch.where(mask, -cost, 0).to(torch.int32)
            batt = batt.index_add(0, idx, debit)
        return (h, batt), RoundChannel(model=self, h=_to_complex(h_coh),
                                       mask=mask)

    def replace(self, **kw) -> "ChannelModel":
        return dataclasses.replace(self, **kw)


class RoundChannel(NamedTuple):
    """One round's realized channel of the M sampled clients (CPU): the
    post-advance cohort fading and the transmit mask (scheduling ∧
    battery)."""
    model: ChannelModel
    h: torch.Tensor        # [M] complex64 cohort fading this round
    mask: torch.Tensor     # [M] bool: client transmits this round

    @property
    def m_transmitting(self):
        return torch.sum(self.mask.to(torch.float32))
