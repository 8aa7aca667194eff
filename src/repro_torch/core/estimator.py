"""Stochastic zeroth-order estimator, flat-buffer half (paper Eq. 2).

Counterpart of ``repro/core/estimator.py:191-278``. With b2 directions v_n
(regenerated from the counter convention, never stored) the coefficients
are

    c_n = scale·(L(x + μ·v_n) − L(x))/μ          (one-sided)
    c_n = scale·(L(x + μ·v_n) − L(x − μ·v_n))/2μ (central)

with scale = d for the sphere estimator and 1 for gaussian/rademacher, and
the update x + s·Σ_n c_n·v_n/b2 is replayed from the same keys in one pass.

Everything is batched over the leading client dimension: ``buf`` is
``[M, n_pad]``, ``keys`` ``[M, 2]`` on the buffer's device, and ``loss_fn``
maps a dict of ``[M, ...]`` parameters and a batch of ``[M, ...]`` leaves
to ``[M]`` losses. The operation order is the reference's, so the float32
roundings agree: ``scale·(lp − base)/μ`` and ``(scale/b2)·coeffs·inv``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.utils.flatparams import FlatSpec, unflatten

# estimator kind -> counter-convention generator kind (coordinate directions
# have no streaming generator; the flat path rejects them)
COUNTER_KINDS = {"sphere": "normal", "gaussian": "normal",
                 "rademacher": "sign"}


def _scale_factor(d, kind):
    # unbiasedness factor: d for sphere/coordinate, 1 for gaussian/rademacher
    return 1.0 if kind in ("gaussian", "rademacher") else float(d)


def _counter_kind(kind):
    ck = COUNTER_KINDS.get(kind)
    if ck is None:
        raise ValueError(f"flat path does not support kind={kind!r}")
    return ck


def flat_inv_norms(keys, spec: FlatSpec, b2, kind, *, block_rows=None):
    """``[M, b2]`` per-direction factors: 1/‖g_n‖ for sphere, else ones."""
    if kind != "sphere":
        return torch.ones((keys.shape[0], b2), dtype=torch.float32,
                          device=keys.device)
    sq = kops.zo_dirnorms(keys, spec.d, b2=b2, kind="normal",
                          block_rows=block_rows)
    return 1.0 / (torch.sqrt(sq) + 1e-30)


def flat_coefficients(loss_fn, buf, spec: FlatSpec, batch, keys, *, mu, b2,
                      kind="sphere", central=False,
                      block_rows=None, inv=None):
    """Fused MeZO-style perturbation walk: ``[M, b2]`` coefficients and the
    ``[M]`` base losses.

    Each step moves x+μv_{n-1} to x+μv_n with one zo_walk (a = −μ·inv[n−1],
    b = +μ·inv[n]): one read and one write of the buffer per direction.
    """
    ck = _counter_kind(kind)
    scale = _scale_factor(spec.d, kind)
    base = loss_fn(unflatten(buf, spec), batch)
    if inv is None:
        inv = flat_inv_norms(keys, spec, b2, kind, block_rows=block_rows)
    mu = torch.tensor(mu, dtype=torch.float32, device=buf.device)
    xp, coeffs = buf, []
    for n in range(b2):
        prev = max(n - 1, 0)
        # state entering step n: x (n=0); x+μv_{n-1} (one-sided, n>0);
        # x−μv_{n-1} (central, n>0) — remove it and add +μv_n in one pass
        a = torch.zeros_like(inv[:, 0]) if n == 0 \
            else (mu if central else -mu) * inv[:, prev]
        b = mu * inv[:, n]
        xp = kops.zo_walk(xp, keys, (prev, n), torch.stack([a, b], dim=1),
                          kind=ck)
        lp = loss_fn(unflatten(xp, spec), batch)
        if central:
            ab = torch.stack([-2 * mu * inv[:, n], torch.zeros_like(a)], 1)
            xp = kops.zo_walk(xp, keys, (n, n), ab, kind=ck)
            lm = loss_fn(unflatten(xp, spec), batch)
            c = scale * (lp - lm).to(torch.float32) / (2 * mu)
        else:
            c = scale * (lp - base).to(torch.float32) / mu
        coeffs.append(c)
    return torch.stack(coeffs, dim=1), base


def flat_apply_coefficients(buf, spec: FlatSpec, keys, coeffs, *, scale=1.0,
                            kind="sphere", block_rows=None, inv=None):
    """buf + scale·Σ_n coeffs[:, n]·v_n/b2 in a single pass (zo_replay)."""
    ck = _counter_kind(kind)
    b2 = coeffs.shape[1]
    if inv is None:
        inv = flat_inv_norms(keys, spec, b2, kind, block_rows=block_rows)
    s = torch.tensor(scale, dtype=torch.float32, device=buf.device) / b2
    eff = s * coeffs.to(torch.float32) * inv
    return kops.zo_replay(buf, keys, eff, kind=ck)
