"""AirComp-assisted aggregation (paper Section IV).

Counterpart of ``repro/core/aircomp.py``. The scheduled devices transmit
their deltas concurrently; after channel inversion and receive scaling the
server holds the masked (optionally size-weighted) mean plus real Gaussian
noise of variance (Eq. 17)

    σ_eff² = σ_w²·Δ_max / (m_div²·d·P·h_min²),  Δ_max = max_i ‖Δ_i‖².

Three forms, as in the reference:

- ``aircomp_aggregate`` takes a stacked delta tree (leaves ``[M, ...]``,
  the pytree route): per-leaf float32 means and norms, and noise drawn per
  leaf from ``fold_in(key, i)``.
- ``aircomp_aggregate_flat`` takes the ``[M, n_pad]`` delta matrix of the
  flat route: one ``aircomp_reduce`` kernel gives the mean and the row
  norms in one read, the noise scale is scalar work on the ``[M]`` norms,
  and one ``zo_walk`` pass adds the noise, regenerated in the kernel from
  the channel key.
- ``aircomp_simulate_channel`` simulates the complex channel explicitly
  (transmit scalars, superposition, AWGN, receive scaling) on ``[M, d]``
  deltas: the closed form's check and the per-device energy constraint.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.utils import prng
from repro_torch.utils.flatparams import _leaves
from repro_torch.utils.shardutil import is_dtensor
from repro_torch.utils.tree import (leaf_normal_like, tree_size,
                                    tree_unflatten)

# per-round per-device energy budget is d·P with P normalized to 1;
# SNR γ = P·h_min²/σ_w² is controlled through snr_db = 10·log10(P/σ_w²).
P_TX = 1.0
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def schedule_by_channel(key, n_devices, h_min, impl=None):
    """Rayleigh channel draw + threshold scheduling M_t = {i : |h_i| >= h_min}.

    ``key`` is a raw key (CPU) of ``impl``. Returns (h ``[N]`` complex64,
    mask ``[N]`` bool), both on the CPU. The draws are jax's within a few
    ulp, so the mask is jax's unless some |h_i| lies within ulps of h_min.
    Keys ``[S, words]`` (a batched sweep's scenarios, under the reference's
    vmap) give ``[S, N]``, with ``h_min`` a scalar or ``[S, 1]``.
    """
    ks = prng.split(key, 2, impl)
    h = torch.complex(prng.normal(ks[..., 0, :], (n_devices,), impl=impl),
                      prng.normal(ks[..., 1, :], (n_devices,), impl=impl)) \
        / _SQRT2
    return h, h.abs() >= h_min


def mask_stats(mask, M, weights=None, *, device="cpu"):
    """(maskf, m_div, m_sched) for a scheduling mask over M rows.

    ``m_div`` is the clamped mean/noise divisor (never 0); ``m_sched`` the
    true scheduled count that ``m_effective`` reports. ``weights`` (mean-1
    size weights, ``size_weights``) turn the row coefficients into
    ``mask·w`` and the divisor into ``Σ mask·w``.
    """
    maskf = (torch.ones((M,), dtype=torch.float32, device=device)
             if mask is None else mask.to(device=device, dtype=torch.float32))
    m_sched = torch.sum(maskf)
    if weights is None:
        return maskf, torch.clamp_min(m_sched, 1.0), m_sched
    wf = maskf * weights.to(device=device, dtype=torch.float32)
    return wf, torch.clamp_min(torch.sum(wf), 1e-8), m_sched


def size_weights(sizes):
    """FedAvg-style n_i/n client weights, normalized to mean 1 (divide by
    the mean, so uniform sizes give exactly 1.0)."""
    w = sizes.to(torch.float32)
    return w / (torch.sum(w) / w.shape[0])


def _delta_sq_norms(deltas):
    """``[M]`` squared norms ‖Δ_i‖² of a stacked delta tree (leaves
    ``[M, ...]``): a float32 sum per leaf and row, summed over the leaves
    in order."""
    return sum(_row_sq(leaf) for _, leaf in _leaves(deltas))


def _row_sq(leaf):
    sq = torch.square(leaf.to(torch.float32))
    if is_dtensor(leaf):   # a sum over the trailing dims: no reshape of
        return torch.sum(sq, dim=tuple(range(1, leaf.ndim)))  # shards
    return torch.sum(sq.reshape(leaf.shape[0], -1), dim=1)


def aircomp_aggregate(deltas, key, *, snr_db, h_min, mask=None,
                      weights=None, impl=None):
    """Noisy mean of a stacked delta tree (leaves ``[M, ...]``) per Eq. 17.

    ``mask`` marks the rows that transmit (channel scheduling): the others
    are left out of the mean and Δ_max. ``weights`` make the mean the
    size-weighted one; Δ_max keeps the unweighted row norms. ``key`` is the
    raw channel key (CPU) of ``impl``; leaf i's noise is
    ``normal(fold_in(key, i))``.
    Returns (noisy mean tree, stats).
    """
    pairs = _leaves(deltas)
    M = pairs[0][1].shape[0]
    dev = pairs[0][1].device
    d = tree_size(deltas) // M
    sigma_w2 = P_TX / (10.0 ** (snr_db / 10.0))
    sq = _delta_sq_norms(deltas)
    maskf, m_div, m_sched = mask_stats(mask, M, weights, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    delta_max = torch.max(torch.where(maskf > 0, sq, zero))
    noise_var = sigma_w2 * delta_max / (m_div ** 2 * float(d) * P_TX
                                        * h_min ** 2)
    noise_std = torch.sqrt(noise_var)
    out = []
    for i, (_, leaf) in enumerate(pairs):
        if is_dtensor(leaf):
            # the row-weighted sum as a broadcast product and a sum over
            # the rows, which DTensor partitions at once over a 3-axis mesh
            w = maskf.reshape((M,) + (1,) * (leaf.ndim - 1))
            mean = torch.sum(leaf.to(torch.float32) * w, dim=0) / m_div
        else:
            mean = torch.einsum("m...,m->...", leaf.to(torch.float32),
                                maskf) / m_div
        # a DTensor mean (the sharded delta program) draws its own shard
        g = leaf_normal_like(prng.fold_in(key, i, impl), mean, impl=impl)
        out.append((mean + noise_std * g).to(leaf.dtype))
    stats = {"aircomp_noise_std": noise_std, "delta_max": delta_max,
             "m_effective": m_sched}
    return tree_unflatten([p for p, _ in pairs], out), stats


def aircomp_aggregate_flat(deltas, key, *, snr_db, h_min, d=None, mask=None,
                           weights=None, block_rows=None):
    """Eq.-17 aggregation of a flat delta matrix ``[M, n_pad]``.

    ``key``: the raw channel key (CPU) whose words 0–1 seed the noise
    field (``zo_walk`` reads those of any key, as the reference's
    ``counter_gen`` does);
    ``d``: the valid flat length (pad columns carry walk residue and are
    left out of the norms). Returns (noisy mean ``[n_pad]``, stats).
    """
    M, n = deltas.shape
    d = n if d is None else d
    maskf, m_div, m_sched = mask_stats(mask, M, weights, device=deltas.device)
    mean, sq = kops.aircomp_reduce(deltas, maskf / m_div, d,
                                   block_rows=block_rows)
    return aircomp_noise_flat(mean, sq, maskf, m_div, m_sched, key,
                              snr_db=snr_db, h_min=h_min, d=d)


def aircomp_noise_flat(mean, sq, maskf, m_div, m_sched, key, *, snr_db,
                       h_min, d):
    """The tail of ``aircomp_aggregate_flat`` after the reduction, on the
    scaled mean ``[n_pad]`` and the ``[M]`` row norms: Δ_max over the
    transmitting rows, the Eq.-17 noise scale, and one ``zo_walk`` that
    adds the noise. The sharded round (``sim/shard.py``) runs it on its
    all-reduced partial means. Returns (noisy mean, stats)."""
    dev = mean.device
    sigma_w2 = P_TX / (10.0 ** (snr_db / 10.0))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    delta_max = torch.max(torch.where(maskf > 0, sq, zero))
    noise_var = sigma_w2 * delta_max / (m_div ** 2 * float(d) * P_TX
                                        * h_min ** 2)
    noise_std = torch.sqrt(noise_var)
    out = kops.zo_walk(mean[None], prng.counter_words(key).reshape(1, 2)
                       .to(dev), (0, 0),
                       torch.stack([noise_std, zero]).reshape(1, 2),
                       kind="normal")[0]
    stats = {"aircomp_noise_std": noise_std, "delta_max": delta_max,
             "m_effective": m_sched}
    return out, stats


def aircomp_simulate_channel(deltas_flat, key, *, snr_db, h_min, h=None,
                             impl=None):
    """Explicit complex-channel simulation on ``[M, d]`` deltas.

    Only the scheduled devices (|h_i| ≥ h_min) transmit, with the Eq.-15
    scalar α_i = (h_min/h_i)·sqrt(d·P/Δ_max); the server receives their
    superposition plus complex AWGN, scales it back and keeps the real
    part (Eq. 17). ``key`` is a raw key (CPU); ``h`` an optional channel
    ``[M]`` complex64 in place of the fresh Rayleigh draw. Returns (y
    ``[d]``, diagnostics: the channel, the mask, the scheduled count, the
    per-device transmit energies, Δ_max and the energy budget d·P).
    """
    M, d = deltas_flat.shape
    dev = deltas_flat.device
    sigma_w2 = P_TX / (10.0 ** (snr_db / 10.0))
    ks = prng.split(key, 2, impl)
    k_h, k_n = ks[0], ks[1]
    if h is None:
        h, mask = schedule_by_channel(k_h, M, h_min, impl)
        h, mask = h.to(dev), mask.to(dev)
    else:
        mask = torch.abs(h) >= h_min
    maskf, m_div, m_sched = mask_stats(mask, M, device=dev)
    sq = torch.sum(torch.square(deltas_flat), dim=1)
    zero = torch.zeros((), dtype=sq.dtype, device=dev)
    delta_max = torch.max(torch.where(maskf > 0, sq, zero))
    alpha = maskf * (h_min / h) \
        * torch.sqrt(d * P_TX / torch.clamp_min(delta_max, 1e-30))  # Eq. 15
    tx = alpha[:, None] * deltas_flat.to(torch.complex64)
    energies = torch.sum(torch.abs(tx) ** 2, dim=1)                  # ≤ d·P
    kn = prng.split(k_n, 2, impl)
    noise = torch.complex(prng.normal(kn[0], (d,), device=dev, impl=impl),
                          prng.normal(kn[1], (d,), device=dev, impl=impl)) \
        * float(np.sqrt(np.float32(sigma_w2 / 2.0)))
    s = torch.sum(h[:, None] * tx, dim=0) + noise                   # Eq. 14/16
    rx_scale = torch.sqrt(delta_max / (d * P_TX * h_min ** 2)) / m_div
    y = torch.real(rx_scale * s)                                     # Eq. 17
    return y, {"h": h, "mask": mask, "m_effective": m_sched,
               "tx_energy": energies, "delta_max": delta_max,
               "energy_budget": d * P_TX}
