"""Blocked online-softmax (flash) attention: the plain version of the CUDA
kernel.

Counterpart of ``repro/kernels/flash_attention.py`` (``_flash_kernel``),
the TPU twin of ``repro/models/layers.py:chunked_attention``. The order is
the Pallas kernel's: q is scaled before the dot product; for each block of
``BLOCK_K`` keys the scores are masked to ``NEG_INF``, the running max,
denominator and accumulator are rescaled by ``exp(m_prev − m_new)`` and the
block's ``p = exp(s − m_new)`` is added; the output is divided by
``max(l, 1e-30)``. Keys beyond the block multiple are zero-padded and masked
by position, as the CUDA kernel (``csrc/flash_attention.cu``) masks its
ragged edge, so the two walk the same blocks. Every block is processed, also
those wholly above the causal diagonal: they add exact zeros (the CUDA
kernel skips them).

Layouts are the reference wrapper's (``repro/kernels/ops.py:attention``):
q ``[B, Sq, Hq, D]``, k/v ``[B, Sk, Hkv, D]``, GQA with kv head
``h // (Hq // Hkv)``. Math in float32, output in q's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
BLOCK_K = 64   # keys per block: the CUDA kernel's K/V tile


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None,
                          block_k=BLOCK_K):
    """q ``[B, Sq, Hq, D]``; k/v ``[B, Sk, Hkv, D]`` -> ``[B, Sq, Hq, D]``.

    ``window`` > 0 keeps keys with ``q_pos − k_pos < window``; positions
    start at 0 for both q and k.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    # [B, Hkv, G, Sq, D]: query head h = hk·G + g reads kv head hk
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, Hkv, G, D) \
        .permute(0, 2, 3, 1, 4)
    n_blk = -(-Sk // block_k)
    pad = n_blk * block_k - Sk
    kf = torch.nn.functional.pad(k.to(torch.float32), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, 0, 0, pad))
    kf = kf.permute(0, 2, 1, 3)[:, :, None]          # [B, Hkv, 1, Sk', D]
    vf = vf.permute(0, 2, 1, 3)[:, :, None]
    q_pos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, Dv), dtype=torch.float32, device=dev)
    for j in range(n_blk):
        lo, hi = j * block_k, (j + 1) * block_k
        s = qf @ kf[..., lo:hi, :].transpose(-1, -2)  # [B, Hkv, G, Sq, bk]
        k_pos = torch.arange(lo, hi, device=dev)[None, :]
        mask = k_pos < Sk
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window:
            mask = mask & (q_pos - k_pos < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vf[..., lo:hi, :]
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dv).to(q.dtype)
