"""The round's key chain and the channel draw, for the benchmark's
reference (plain torch on the CPU; imports nothing of the program).

Keys are pairs of uint32 words. A client's iterate keys are the H keys of
its round key's split; the flat route's directions take an iterate key's
two words. With channel scheduling the round's channel key splits into
the scheduling key and the AirComp noise key; the scheduling key splits
again into the real and the imaginary part of M Rayleigh gains

    h_i = (N(0, 1) + j·N(0, 1))/√2,   client i transmits iff |h_i| ≥ h_min,

each normal jax's: 32 random bits (the two Threefry words of the counter
(0, i), xored) to a float32 uniform on (nextafter(-1, 0), 1), then
√2·erfinv(u) (evaluated here in float64).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fedbench.reference.threefry import split, threefry_words

_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(k0: int, k1: int, count: int) -> torch.Tensor:
    """``count`` standard normals of key (k0, k1), float64 on the CPU."""
    c1 = torch.arange(count, dtype=torch.int64).to(torch.int32)
    x0, x1 = threefry_words(k0, k1, 0, c1)
    bits = (x0 ^ x1).to(torch.int64) & 0xFFFFFFFF
    f = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    u = f.to(torch.int32).view(torch.float32) - 1.0
    span = float(np.float32(1.0) - np.float32(_LO))
    u = torch.clamp_min(u * span + _LO, _LO)
    return math.sqrt(2.0) * torch.erfinv(u.double())


def channel(key, n_clients: int, h_min: float):
    """(transmit mask ``[M]`` bool, noise key) of a round's channel key."""
    k_sched, k_noise = split(*key, 2)
    k_re, k_im = split(*k_sched, 2)
    h = torch.complex(normal(*k_re, n_clients), normal(*k_im, n_clients))
    h = h / math.sqrt(2.0)
    return h.abs() >= h_min, k_noise


def iterate_keys(key, local_iters: int):
    """The H iterate keys of a client's round key."""
    return split(*key, local_iters)
