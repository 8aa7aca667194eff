"""Wrappers of the four ZO kernels: dispatch by device, launch counters.

A tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/zo_axpy.py``, ``kernels/zo_aircomp.py``). A tensor on a CUDA
device goes to the hand-written kernel (``kernels/csrc/*.cu``), built on
first use, or the call raises: there is no fallback. After every launch the
C launcher's ``cudaGetLastError`` is checked, and the kernel's counter in
``LAUNCHES`` goes up by one, there and nowhere else, so a run can show that
its main path went through the kernels.

Kernels launch on PyTorch's current stream and do not synchronise; outputs
and scratch are allocated here with ``torch.empty``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.zo_aircomp import aircomp_reduce_plain
from repro_torch.kernels.zo_axpy import (zo_dirnorms_plain, zo_replay_plain,
                                         zo_walk_plain)

LAUNCHES = {"zo_walk": 0, "zo_replay": 0, "zo_dirnorms": 0,
            "aircomp_reduce": 0}
_KIND_CODE = {"normal": 0, "sign": 1}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _need(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: need contiguous {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")


def _kind(kind):
    if kind not in _KIND_CODE:
        raise ValueError(f"unknown counter direction kind {kind!r}")
    return _KIND_CODE[kind]


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def zo_walk(x, keys, nn, ab, *, kind="normal"):
    """out[m] = x[m] + ab[m, 0]·v_m(nn[0]) + ab[m, 1]·v_m(nn[1]).

    x: float32 ``[M, N]``; keys: int64 ``[M, 2]`` (uint32 words); nn: two
    direction indices (ints); ab: float32 ``[M, 2]``. One read and one write
    of x; the directions are regenerated in the kernel.
    """
    code = _kind(kind)
    n0, n1 = int(nn[0]), int(nn[1])
    if _on_cpu(x):
        return zo_walk_plain(x, keys, (n0, n1), ab, kind=kind)
    m, n = x.shape
    _need(x, "x", torch.float32, (m, n), x.device)
    _need(keys, "keys", torch.int64, (m, 2), x.device)
    _need(ab, "ab", torch.float32, (m, 2), x.device)
    out = torch.empty_like(x)
    lib = build.load()["zo_axpy"]
    _check(lib.zo_walk_launch(x.data_ptr(), out.data_ptr(), keys.data_ptr(),
                              ab.data_ptr(), n0, n1, m, n, code, _stream()),
           "zo_walk")
    LAUNCHES["zo_walk"] += 1
    return out


def zo_replay(x, keys, coeffs, *, kind="normal"):
    """out[m] = x[m] + Σ_n coeffs[m, n]·v_m(n) in one pass over x.

    coeffs: float32 ``[M, b2]`` effective coefficients (the caller folds in
    scale, 1/b2 and the sphere norms).
    """
    code = _kind(kind)
    if _on_cpu(x):
        return zo_replay_plain(x, keys, coeffs, kind=kind)
    m, n = x.shape
    b2 = coeffs.shape[1]
    _need(x, "x", torch.float32, (m, n), x.device)
    _need(keys, "keys", torch.int64, (m, 2), x.device)
    _need(coeffs, "coeffs", torch.float32, (m, b2), x.device)
    out = torch.empty_like(x)
    lib = build.load()["zo_axpy"]
    _check(lib.zo_replay_launch(x.data_ptr(), out.data_ptr(),
                                keys.data_ptr(), coeffs.data_ptr(), b2, m, n,
                                code, _stream()), "zo_replay")
    LAUNCHES["zo_replay"] += 1
    return out


def zo_dirnorms(keys, d, *, b2, kind="normal", block_rows=None):
    """``[M, b2]`` squared direction norms ‖v_m(n)[:d]‖². No direction
    leaves the chip. ``block_rows`` sets the plain version's block order."""
    code = _kind(kind)
    if d < 1:
        raise ValueError(f"d must be positive, got {d}")
    if _on_cpu(keys):
        return zo_dirnorms_plain(keys, d, b2=b2, kind=kind,
                                 block_rows=block_rows)
    m = keys.shape[0]
    _need(keys, "keys", torch.int64, (m, 2), keys.device)
    lib = build.load()["zo_axpy"]
    chunks = -(-d // lib.zo_norm_chunk())
    partial = torch.empty((m, b2, chunks), dtype=torch.float32,
                          device=keys.device)
    out = torch.empty((m, b2), dtype=torch.float32, device=keys.device)
    _check(lib.zo_dirnorms_launch(keys.data_ptr(), partial.data_ptr(),
                                  out.data_ptr(), d, b2, m, code, _stream()),
           "zo_dirnorms")
    LAUNCHES["zo_dirnorms"] += 1
    return out


def aircomp_reduce(deltas, scale, d, *, block_rows=None):
    """(mean ``[N]``, sq ``[M]``): ``Σ_m scale[m]·deltas[m]`` and the per-row
    ‖deltas[m, :d]‖², in one read of the ``[M, N]`` matrix."""
    if _on_cpu(deltas):
        return aircomp_reduce_plain(deltas, scale, d, block_rows=block_rows)
    m, n = deltas.shape
    _need(deltas, "deltas", torch.float32, (m, n), deltas.device)
    _need(scale, "scale", torch.float32, (m,), deltas.device)
    lib = build.load()["zo_aircomp"]
    if m > lib.aircomp_max_rows():
        raise ValueError(f"aircomp_reduce takes at most "
                         f"{lib.aircomp_max_rows()} rows, got {m}")
    blocks = -(-n // lib.aircomp_block_cols())
    partial = torch.empty((m, blocks), dtype=torch.float32,
                          device=deltas.device)
    mean = torch.empty(n, dtype=torch.float32, device=deltas.device)
    sq = torch.empty(m, dtype=torch.float32, device=deltas.device)
    _check(lib.aircomp_reduce_launch(deltas.data_ptr(), scale.data_ptr(),
                                     mean.data_ptr(), partial.data_ptr(),
                                     sq.data_ptr(), m, n, int(d), _stream()),
           "aircomp_reduce")
    LAUNCHES["aircomp_reduce"] += 1
    return mean, sq
