"""RMSNorm over the last dimension: the plain version of the CUDA kernel.

Counterpart of ``repro/kernels/rmsnorm.py`` (``_rmsnorm_kernel``), which is
the same function as the rmsnorm branch of ``repro/models/layers.py:
norm_fwd``. The arithmetic is the reference's, in its order: the row's mean
square in float32, ``x · rsqrt(ms + eps) · scale`` left to right, then a
cast to x's dtype. ``kernels/ops.py:rmsnorm`` runs this for a CPU tensor,
and ``chip_smoke.py`` holds the CUDA kernel (``csrc/rmsnorm.cu``) against it
on the card.
"""
from __future__ import annotations

import torch


def rmsnorm_plain(x, scale, *, eps=1e-6):
    """x ``[..., D]`` (float32 or bfloat16), scale ``[D]`` -> x's dtype."""
    xf = x.to(torch.float32)
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)
    return out.to(x.dtype)
