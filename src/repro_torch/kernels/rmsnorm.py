"""RMSNorm over the last dimension: the plain version of the CUDA kernel.

Counterpart of ``repro/kernels/rmsnorm.py`` (``_rmsnorm_kernel``), which is
the same function as the rmsnorm branch of ``repro/models/layers.py:
norm_fwd``. The arithmetic is the reference's, in its order: the row's mean
square in float32, ``x · rsqrt(ms + eps) · scale`` left to right, then a
cast to x's dtype. ``kernels/ops.py:rmsnorm`` runs this for a CPU tensor,
and ``chip_smoke.py`` holds the CUDA kernel (``csrc/rmsnorm.cu``) against it
on the card.

``rmsnorm_kernel_order`` is the CUDA kernel's own summation order of the
mean square in torch, used only by the tests and ``chip_smoke.py`` to hold
the kernel to it bit for bit.

``scale`` is ``[D]``, or ``[G, D]`` for a client-batched forward: the rows
of x fall into G equal contiguous groups and group g takes ``scale[g]``
(the reference's ``norm_fwd`` under ``vmap``, each client with its own
scale).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _times_scale(y, scale):
    """y ``[..., D]`` float32 times scale ``[D]``, or ``[G, D]`` over G equal
    contiguous groups of y's rows."""
    if scale.dim() == 1:
        return y * scale.to(torch.float32)
    G, D = scale.shape
    return (y.reshape(G, -1, D) * scale.to(torch.float32)[:, None]) \
        .reshape(y.shape)


def rmsnorm_plain(x, scale, *, eps=1e-6):
    """x ``[..., D]`` (float32 or bfloat16), scale ``[D]`` or ``[G, D]`` ->
    x's dtype."""
    xf = x.to(torch.float32)
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = _times_scale(xf * torch.rsqrt(ms + eps), scale)
    return out.to(x.dtype)


def rmsnorm_kernel_order(x, scale, *, eps=1e-6):
    """The CUDA kernel's arithmetic in torch, on any device: lane l of a
    row's LPR lanes sums the squares of the elements of its 16-byte vectors
    l, l + LPR, ... in ascending order, each term a float32 multiply then
    add; the LPR lane sums meet in the xor-shuffle tree (offsets LPR/2, ...,
    1); then ms = sum / D (a true division), r = 1 / sqrt(ms + eps) and
    (x · r) · scale, each correctly rounded. On the card it is the kernel
    bit for bit; against the reference it differs by the summation order."""
    D = x.shape[-1]
    vec = 16 // x.element_size()             # elements per 16-byte vector
    nvec = -(-D // vec)                      # vectors per row
    lpr = 32 if D > 128 else (16 if nvec > 8 else 8)   # lanes per row
    nv = -(-nvec // lpr)                     # vectors per lane
    xf = x.reshape(-1, D).to(torch.float32)
    sq = F.pad(xf * xf, (0, nv * lpr * vec - D))   # exact zeros beyond D
    sq = sq.reshape(-1, nv, lpr, vec)
    acc = torch.zeros(sq.shape[0], lpr, dtype=torch.float32, device=x.device)
    for j in range(nv):
        for k in range(vec):
            acc = acc + sq[:, j, :, k]
    w = lpr
    while w > 1:
        w //= 2
        acc = acc[:, :w] + acc[:, w:2 * w]
    ms = acc / torch.full_like(acc, D)
    r = torch.reciprocal(torch.sqrt(ms + eps))
    out = _times_scale(xf * r, scale)
    return out.to(x.dtype).reshape(x.shape)
