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

``aircomp_sq_order_sum`` is the CUDA kernel's own summation order of the
norms in torch, used only by the tests and ``chip_smoke.py`` to hold the
kernel to it bit for bit (its mean is bitwise the plain version's).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.zo_axpy import (BLOCK_ROWS, LANES, _block_tree,
                                         _blocked_sum, _xor_tree)

AIR_THREADS = 256   # threads of a CUDA block
AIR_VEC = 4         # floats in a thread's 16-byte vector
AIR_FINISH_LANES = 16   # lanes that sum a row's block partials


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


def aircomp_sq_order_sum(x, d, *, per, grid):
    """``[M]`` Σ_{c<d} x[m, c]² in the CUDA kernel's order, for its geometry
    (``per``, ``grid``: ``ops.aircomp_geometry``). A tile is 256·4·per
    columns; thread t of a tile sums the squares of the columns
    (j·256 + t)·4 + k for j < per, k < 4 in that order; the tile's 256
    thread sums meet in ``_block_tree``; block b adds the totals of tiles
    b, b + grid, ... in ascending order; then, per row, lane l of 16 sums
    the block partials l, l + 16, ... in ascending order and the 16 lanes
    meet in an xor tree. Columns at or beyond d add exact zeros."""
    m, n = x.shape
    tile = AIR_THREADS * AIR_VEC * per
    tiles = -(-n // tile)
    sq = torch.square(x)
    if d < n:
        sq[:, max(d, 0):] = 0.0
    if tiles * tile != n:
        sq = F.pad(sq, (0, tiles * tile - n))
    sq = sq.reshape(m, tiles, per, AIR_THREADS, AIR_VEC)
    s = torch.zeros((m, tiles, AIR_THREADS), dtype=torch.float32,
                    device=x.device)
    for j in range(per):
        for k in range(AIR_VEC):
            s = s + sq[:, :, j, :, k]
    del sq
    tot = _block_tree(s)                       # [M, tiles]
    part = tot[:, :grid]
    for i in range(grid, tiles, grid):
        c = min(grid, tiles - i)
        part = torch.cat([part[:, :c] + tot[:, i:i + c], part[:, c:]], 1)
    rounds = -(-grid // AIR_FINISH_LANES)
    p = F.pad(part, (0, rounds * AIR_FINISH_LANES - grid)).reshape(
        m, rounds, AIR_FINISH_LANES)
    f = torch.zeros((m, AIR_FINISH_LANES), dtype=torch.float32,
                    device=x.device)
    for i in range(rounds):
        f = f + p[:, i]
    return _xor_tree(f)
