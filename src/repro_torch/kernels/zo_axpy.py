"""The plain versions of the ZO kernels, and counter-convention directions.

Counterpart of ``repro/kernels/zo_axpy.py``. Two of its kernels stream
materialized vectors of any shape: ``zo_axpy`` (x + a·u, the pytree route's
perturbation and replayed update, one leaf at a time) and ``zo_axpy2``
(x + a·u + b·v, the MeZO unperturb-and-reperturb pass). The other three
regenerate their directions: a direction element is a pure function of
``(round_key, n, flat_index)`` through Threefry-2x32, so the perturb end
(``zo_walk``), the replay end (``zo_replay``) and the sphere norms
(``zo_dirnorms``) regenerate the same direction from the same three numbers,
and no direction is ever stored.

The direction kernels are batched over a leading row dimension: the M
sampled clients of a round, each with its own key ``keys[m] = (k0, k1)``
and its own coefficients, so one call covers the cohort (the reference
vmaps its Pallas calls over the clients). Buffers are ``[M, N]`` float32,
keys ``[M, 2]`` int64 holding uint32 words.

The plain versions below are what a wrapper in ``kernels/ops.py`` runs for a
tensor on the CPU, and what ``chip_smoke.py`` holds each CUDA kernel
against on the card. They keep the reference oracles' arithmetic order
(``repro/kernels/ref.py``): the axpys add ``a·u`` then ``b·v`` in float32;
the walk adds ``a·g_prev`` then ``b·g_next``;
the replay accumulates ``acc += c[n]·g_n`` in ascending n from zero; the
norms sum per ``block_rows·128`` block, then across blocks in block order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.prng import threefry2x32

LANES = 128
BLOCK_ROWS = 512           # pad granularity of the reference: 512·128 = 64Ki

_TWO_M24 = 2.0 ** -24
_TWO_M25 = 2.0 ** -25
_TWO_PI_F32 = float(np.float32(2.0 * 3.14159265358979323846))  # rounded once


def _f32_scalar(a):
    """A 0-d float32 tensor of a scalar or one-element tensor (a CPU scalar
    combines with a tensor on any device)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).reshape(())
    return torch.tensor(a, dtype=torch.float32)


def zo_axpy_plain(x, u, a):
    """x + a[0]·u in float32, cast to x's dtype (``ref.axpy_ref``). ``a``:
    float32 ``[1]``. The explicit casts matter: torch keeps a float32 0-d
    tensor times a bfloat16 tensor in bfloat16, where jnp promotes."""
    a = _f32_scalar(a)
    return (x.float() + a * u.float()).to(x.dtype)


def zo_axpy2_plain(x, u, v, ab):
    """(x + ab[0]·u) + ab[1]·v in float32, cast to x's dtype
    (``ref.axpy2_ref``). ``ab``: float32 ``[2]``."""
    a, b = _f32_scalar(ab[0]), _f32_scalar(ab[1])
    return (x.float() + a * u.float() + b * v.float()).to(x.dtype)


def _bits_to_normal(b0, b1):
    """Box-Muller on two uint32 bit planes -> one N(0,1) float32 each."""
    u1 = (b0 >> 8).to(torch.float32) * _TWO_M24 + _TWO_M25       # (0, 1)
    u2 = (b1 >> 8).to(torch.float32) * _TWO_M24
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI_F32 * u2)


def counter_gen(kind: str, k0, k1, n, idx):
    """Direction elements v_n[idx] for kind in {normal, sign}.

    k0, k1: key words (int64, broadcastable, e.g. ``[M, 1]``); n: direction
    index (int); idx: int64 flat element indices.
    """
    b0, b1 = threefry2x32(k0, k1, n, idx)
    if kind == "sign":
        one = torch.ones((), dtype=torch.float32, device=b0.device)
        return torch.where((b0 & 1) > 0, one, -one)
    if kind == "normal":
        return _bits_to_normal(b0, b1)
    raise ValueError(f"unknown counter direction kind {kind!r}")


def counter_direction_flat(key2, n, count, *, kind="normal", start=0):
    """v_n[start:start+count] as float32 ``[count]`` for one key ``[2]``."""
    idx = start + torch.arange(count, dtype=torch.int64, device=key2.device)
    return counter_gen(kind, key2[0], key2[1], int(n), idx)


def _key_cols(keys):
    return keys[:, 0:1], keys[:, 1:2]


def zo_walk_plain(x, keys, nn, ab, *, kind="normal"):
    """x + ab[:, 0]·v(nn[0]) + ab[:, 1]·v(nn[1]) per row. x ``[M, N]``."""
    idx = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    k0, k1 = _key_cols(keys)
    gp = counter_gen(kind, k0, k1, int(nn[0]), idx)
    gn = counter_gen(kind, k0, k1, int(nn[1]), idx)
    return x + ab[:, 0:1] * gp + ab[:, 1:2] * gn


def zo_replay_plain(x, keys, coeffs, *, kind="normal"):
    """x + Σ_n coeffs[:, n]·v_n per row, fp32 accumulator, ascending n."""
    idx = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    k0, k1 = _key_cols(keys)
    acc = torch.zeros_like(x)
    for n in range(coeffs.shape[1]):
        acc = acc + coeffs[:, n:n + 1] * counter_gen(kind, k0, k1, n, idx)
    return x + acc


def _blocked_sum(vals, per):
    """Σ over the last dim of ``vals`` [..., N]: per ``per``-element block
    (zero-padded), then across blocks in ascending block order."""
    n = vals.shape[-1]
    nblk = -(-n // per)
    vals = torch.nn.functional.pad(vals, (0, nblk * per - n))
    parts = vals.reshape(vals.shape[:-1] + (nblk, per)).sum(-1)
    total = torch.zeros(vals.shape[:-1], dtype=torch.float32,
                        device=vals.device)
    for i in range(nblk):
        total = total + parts[..., i]
    return total


def zo_dirnorms_plain(keys, d, *, b2, kind="normal", block_rows=None):
    """``[M, b2]`` squared norms ‖v_n[:d]‖². Only the blocks that overlap
    the valid prefix are generated: the masked rest adds exact zeros."""
    per = (block_rows or BLOCK_ROWS) * LANES
    span = -(-d // per) * per
    idx = torch.arange(span, dtype=torch.int64, device=keys.device)
    valid = idx < d
    k0, k1 = _key_cols(keys)
    out = []
    for n in range(b2):
        g = counter_gen(kind, k0, k1, n, idx)
        g = torch.where(valid, g, torch.zeros((), device=g.device))
        out.append(_blocked_sum(g * g, per))
    return torch.stack(out, dim=1)
