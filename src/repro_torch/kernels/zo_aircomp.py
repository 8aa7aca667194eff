"""Plain version of the fused AirComp reduction.

Counterpart of ``repro/kernels/zo_aircomp.py``. The server side of one
AirComp round needs, from the stacked client deltas ``[M, N]``, the per-row
weighted combination ``Σ_m scale_m·x_m`` (``[N]``, the masked scaled mean:
the caller folds mask and divisor into ``scale``) and the per-row squared
norms over the valid prefix ``‖x_m[:d]‖²`` (``[M]``, for Δ_max, Eq. 15).
The CUDA kernel (``kernels/csrc/zo_aircomp.cu``) produces both in one read
of the matrix; this is the version it is held against, in the reference
oracle's order (``repro/kernels/ref.py:aircomp_reduce_ref``): rows combined
in ascending m from zero, the norms summed per ``block_rows·128`` block and
then across blocks in block order. The mean covers all N columns.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.zo_axpy import BLOCK_ROWS, LANES, _blocked_sum


def aircomp_reduce_plain(x, scale, d, *, block_rows=None):
    """(mean ``[N]``, sq ``[M]``) of deltas x ``[M, N]``, scale ``[M]``."""
    m_rows, n = x.shape
    mean = torch.zeros(n, dtype=torch.float32, device=x.device)
    for m in range(m_rows):
        mean = mean + scale[m] * x[m]
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    sq_terms = torch.where(idx < d, x * x, torch.zeros((), device=x.device))
    sq = _blocked_sum(sq_terms, (block_rows or BLOCK_ROWS) * LANES)
    return mean, sq
