"""AirComp-assisted aggregation (paper Section IV), flat-buffer route.

Counterpart of ``repro/core/aircomp.py:46-96, 141-170``. The scheduled
devices transmit their deltas concurrently; after channel inversion and
receive scaling the server holds the masked (optionally size-weighted) mean
plus real Gaussian noise of variance (Eq. 17)

    σ_eff² = σ_w²·Δ_max / (m_div²·d·P·h_min²),  Δ_max = max_i ‖Δ_i‖².

``aircomp_aggregate_flat`` takes the ``[M, n_pad]`` delta matrix: one
``aircomp_reduce`` kernel gives the mean and the row norms in one read, the
noise scale is scalar work on the ``[M]`` norms, and one ``zo_walk`` pass
adds the noise, regenerated in the kernel from the channel key.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.utils import prng

# per-round per-device energy budget is d·P with P normalized to 1;
# SNR γ = P·h_min²/σ_w² is controlled through snr_db = 10·log10(P/σ_w²).
P_TX = 1.0
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def schedule_by_channel(key, n_devices, h_min):
    """Rayleigh channel draw + threshold scheduling M_t = {i : |h_i| >= h_min}.

    ``key`` is a raw key (CPU). Returns (h ``[N]`` complex64, mask ``[N]``
    bool), both on the CPU. The draws are jax's within a few ulp, so the
    mask is jax's unless some |h_i| lies within ulps of h_min.
    """
    ks = prng.split(key, 2)
    h = torch.complex(prng.normal(ks[0], (n_devices,)),
                      prng.normal(ks[1], (n_devices,))) / _SQRT2
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


def aircomp_aggregate_flat(deltas, key, *, snr_db, h_min, d=None, mask=None,
                           weights=None, block_rows=None):
    """Eq.-17 aggregation of a flat delta matrix ``[M, n_pad]``.

    ``key``: the raw channel key (CPU) whose words seed the noise field;
    ``d``: the valid flat length (pad columns carry walk residue and are
    left out of the norms). Returns (noisy mean ``[n_pad]``, stats).
    """
    M, n = deltas.shape
    d = n if d is None else d
    dev = deltas.device
    sigma_w2 = P_TX / (10.0 ** (snr_db / 10.0))
    maskf, m_div, m_sched = mask_stats(mask, M, weights, device=dev)
    mean, sq = kops.aircomp_reduce(deltas, maskf / m_div, d,
                                   block_rows=block_rows)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    delta_max = torch.max(torch.where(maskf > 0, sq, zero))
    noise_var = sigma_w2 * delta_max / (m_div ** 2 * float(d) * P_TX
                                        * h_min ** 2)
    noise_std = torch.sqrt(noise_var)
    out = kops.zo_walk(mean[None], key.reshape(1, 2).to(dev), (0, 0),
                       torch.stack([noise_std, zero]).reshape(1, 2),
                       kind="normal")[0]
    stats = {"aircomp_noise_std": noise_std, "delta_max": delta_max,
             "m_effective": m_sched}
    return out, stats
