"""Kernel wrappers: dispatch by device, launch counters.

The four ZO kernels of the flat FedZO round, the two axpys of the pytree
route (``axpy`` per leaf in ``utils/tree.tree_axpy``; ``axpy2`` and
``tree_axpy2``, the reference's public entry points for ``zo_axpy2``) and
the two of the dense transformer forward (RMSNorm, flash attention). A
tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/zo_axpy.py``,
``kernels/zo_aircomp.py``, ``kernels/rmsnorm.py``,
``kernels/flash_attention.py``). A tensor on a CUDA
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
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.kernels.zo_aircomp import aircomp_reduce_plain
from repro_torch.kernels.zo_axpy import (dirnorm_geometry, zo_axpy2_plain,
                                         zo_axpy_plain, zo_dirnorms_plain,
                                         zo_replay_plain, zo_walk_plain)

LAUNCHES = {"zo_walk": 0, "zo_replay": 0, "zo_dirnorms": 0,
            "aircomp_reduce": 0, "zo_axpy": 0, "zo_axpy2": 0, "rmsnorm": 0,
            "flash_attention": 0}
_KIND_CODE = {"normal": 0, "sign": 1}
_TICKETS: dict = {}
_AIR_GEOMETRY: dict = {}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def _dtype_code(t, name):
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, got "
                         f"{t.dtype}")
    return _DTYPE_CODE[t.dtype]


def _kind(kind):
    if kind not in _KIND_CODE:
        raise ValueError(f"unknown counter direction kind {kind!r}")
    return _KIND_CODE[kind]


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _scalars(vals, device):
    """Float32 ``[len(vals)]`` on ``device`` from scalars or one-element
    tensors. A lone float32 tensor already on ``device`` is used as it is;
    otherwise each slot is filled on the device (a fill or a device copy,
    never a host synchronisation)."""
    if len(vals) == 1 and isinstance(vals[0], torch.Tensor) \
            and vals[0].numel() == 1 and vals[0].dtype == torch.float32 \
            and vals[0].device == device:
        return vals[0].reshape(1)
    out = torch.empty(len(vals), dtype=torch.float32, device=device)
    for i, v in enumerate(vals):
        out[i] = v.reshape(()) if isinstance(v, torch.Tensor) else float(v)
    return out


def _axpy_operands(x, vecs):
    """Check x (float32 or bfloat16) and the vectors (each x's dtype or
    float32, x's shape, contiguous, on x's device); their dtype codes."""
    codes = [_dtype_code(x, "x")]
    _need(x, "x", x.dtype, x.shape, x.device)
    for name, t in vecs:
        if t.dtype not in (x.dtype, torch.float32):
            raise ValueError(f"{name}: must be x's dtype ({x.dtype}) or "
                             f"float32, got {t.dtype}")
        _need(t, name, t.dtype, x.shape, x.device)
        codes.append(_DTYPE_CODE[t.dtype])
    return codes


def axpy(x, u, a):
    """x + a·u in float32, returned in x's dtype (``zo_axpy``). x float32
    or bfloat16, u of x's shape in x's dtype or float32, ``a`` a scalar or
    a one-element tensor (on the card, best a float32 tensor there: it is
    read by the kernel, so the host never waits for it)."""
    if _on_cpu(x):
        return zo_axpy_plain(x, u, a)
    xc, uc = _axpy_operands(x, [("u", u)])
    s = _scalars([a], x.device)
    out = torch.empty_like(x)
    lib = build.load()["axpy"]
    _check(lib.zo_axpy_launch(x.data_ptr(), u.data_ptr(), s.data_ptr(),
                              out.data_ptr(), x.numel(), xc, uc, _stream()),
           "zo_axpy")
    LAUNCHES["zo_axpy"] += 1
    return out


def axpy2(x, u, v, a, b):
    """x + a·u + b·v in float32, returned in x's dtype (``zo_axpy2``), for
    same-shaped x, u, v of any length; u and v each x's dtype or float32.
    No padding: the kernel masks its own ragged edge."""
    if _on_cpu(x):
        return zo_axpy2_plain(x, u, v, (a, b))
    xc, uc, vc = _axpy_operands(x, [("u", u), ("v", v)])
    s = _scalars([a, b], x.device)
    out = torch.empty_like(x)
    lib = build.load()["axpy"]
    _check(lib.zo_axpy2_launch(x.data_ptr(), u.data_ptr(), v.data_ptr(),
                               s.data_ptr(), out.data_ptr(), x.numel(), xc,
                               uc, vc, _stream()), "zo_axpy2")
    LAUNCHES["zo_axpy2"] += 1
    return out


def tree_axpy2(x_tree, u_tree, v_tree, a, b):
    """Leafwise fused x + a·u + b·v over nested dicts of one structure (the
    MeZO unperturb-and-reperturb pass): one ``axpy2`` per leaf."""
    return {k: tree_axpy2(x, u_tree[k], v_tree[k], a, b)
            if isinstance(x, dict) else axpy2(x, u_tree[k], v_tree[k], a, b)
            for k, x in x_tree.items()}


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


def _tickets(device, count):
    """The ``count`` ticket counters of the norms and AirComp kernels on
    ``device``: one int32 buffer per device, zeroed once when it is
    allocated (or grown); each call leaves its counters at zero again.
    Calls on one stream are ordered, so they share it safely."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def zo_dirnorms(keys, d, *, b2, kind="normal", block_rows=None):
    """``[M, b2]`` squared direction norms ‖v_m(n)[:d]‖², in one launch. No
    direction leaves the chip. ``block_rows`` sets the plain version's
    block order."""
    code = _kind(kind)
    if d < 1:
        raise ValueError(f"d must be positive, got {d}")
    if _on_cpu(keys):
        return zo_dirnorms_plain(keys, d, b2=b2, kind=kind,
                                 block_rows=block_rows)
    m = keys.shape[0]
    _need(keys, "keys", torch.int64, (m, 2), keys.device)
    lib = build.load()["zo_axpy"]
    per, chunks = dirnorm_geometry(d, m * b2)
    partial = torch.empty((m, b2, chunks if chunks > 1 else 0),
                          dtype=torch.float32, device=keys.device)
    out = torch.empty((m, b2), dtype=torch.float32, device=keys.device)
    _check(lib.zo_dirnorms_launch(keys.data_ptr(), partial.data_ptr(),
                                  _tickets(keys.device, m * b2).data_ptr(),
                                  out.data_ptr(), d, b2, m, per, code,
                                  _stream()), "zo_dirnorms")
    LAUNCHES["zo_dirnorms"] += 1
    return out


def aircomp_geometry(n, device):
    """(per, grid) of the CUDA AirComp reduction over N columns on
    ``device``: the 16-byte vectors a thread takes of a row in a tile (1 or
    4) and the blocks of the launch, from the card's SM count and the
    kernel's occupancy. The summation order of the norms depends on both
    (``kernels/zo_aircomp.aircomp_sq_order_sum``)."""
    key = (torch.device(device), int(n))
    if key not in _AIR_GEOMETRY:
        lib = build.load()["zo_aircomp"]
        per, grid = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(key[0]):
            _check(lib.aircomp_geometry(key[1], ctypes.byref(per),
                                        ctypes.byref(grid)),
                   "aircomp_geometry")
        _AIR_GEOMETRY[key] = (per.value, grid.value)
    return _AIR_GEOMETRY[key]


def aircomp_reduce(deltas, scale, d, *, block_rows=None):
    """(mean ``[N]``, sq ``[M]``): ``Σ_m scale[m]·deltas[m]`` and the per-row
    ‖deltas[m, :d]‖², in one read of the ``[M, N]`` matrix and one launch.
    ``block_rows`` sets the plain version's block order."""
    if _on_cpu(deltas):
        return aircomp_reduce_plain(deltas, scale, d, block_rows=block_rows)
    m, n = deltas.shape
    _need(deltas, "deltas", torch.float32, (m, n), deltas.device)
    _need(scale, "scale", torch.float32, (m,), deltas.device)
    lib = build.load()["zo_aircomp"]
    per, grid = aircomp_geometry(n, deltas.device)
    partial = torch.empty((m, grid), dtype=torch.float32,
                          device=deltas.device)
    mean = torch.empty(n, dtype=torch.float32, device=deltas.device)
    sq = torch.empty(m, dtype=torch.float32, device=deltas.device)
    _check(lib.aircomp_reduce_launch(
        deltas.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        partial.data_ptr(), _tickets(deltas.device, 1).data_ptr(),
        sq.data_ptr(), m, n, max(0, min(int(d), n)), per, grid, _stream()),
        "aircomp_reduce")
    LAUNCHES["aircomp_reduce"] += 1
    return mean, sq


def rmsnorm(x, scale, *, eps=1e-6):
    """RMSNorm over the last dim of x ``[..., D]``: ``x · rsqrt(mean(x²) +
    eps) · scale`` in float32, returned in x's dtype. x and scale float32 or
    bfloat16. ``scale`` is ``[D]``, or ``[G, D]`` (any row stride) for G
    equal contiguous groups of x's rows, group g scaled by ``scale[g]``."""
    if _on_cpu(x):
        return rmsnorm_plain(x, scale, eps=eps)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    xc = _dtype_code(x, "x")
    sc = _dtype_code(scale, "scale")
    _need(x, "x", x.dtype, x.shape, x.device)
    groups = scale.shape[0] if scale.dim() == 2 else 1
    if scale.dim() not in (1, 2) or scale.shape[-1] != D \
            or scale.stride(-1) != 1 or scale.device != x.device \
            or (groups > 1 and scale.stride(0) < D):
        raise ValueError(f"rmsnorm: scale must be [{D}] or [G, {D}] with "
                         f"unit-stride rows on {x.device}, got "
                         f"{tuple(scale.shape)} strides {scale.stride()} on "
                         f"{scale.device}")
    if groups < 1 or rows % groups:
        raise ValueError(f"rmsnorm: {rows} rows do not fall into {groups} "
                         f"equal groups")
    out = torch.empty_like(x)
    lib = build.load()["rmsnorm"]
    _check(lib.rmsnorm_launch(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                              rows, D, float(eps), xc, sc, groups,
                              scale.stride(0) if groups > 1 else D,
                              _stream()), "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return out


def attention(q, k, v, *, causal=True, window=0, scale=None):
    """Flash attention on the reference wrapper's layout: q ``[B, Sq, Hq,
    D]``, k/v ``[B, Sk, Hkv, D]`` -> ``[B, Sq, Hq, D]`` in q's dtype.

    GQA (``Hq`` a multiple of ``Hkv``); ``window`` > 0 keeps keys with
    ``q_pos − k_pos < window``. Any Sq, Sk: the kernel masks its own ragged
    edge, so there is no padding and no restriction on non-causal calls.
    """
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    code = _dtype_code(q, "q")
    _need(q, "q", q.dtype, (B, Sq, Hq, D), q.device)
    _need(k, "k", q.dtype, (B, Sk, Hkv, D), q.device)
    _need(v, "v", q.dtype, (B, Sk, Hkv, D), q.device)
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    # the kernel copies 16 bytes at a time: an input that starts elsewhere
    # (a slice at an odd row) is copied to a fresh, aligned tensor first
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    lib = build.load()["flash_attention"]
    if not lib.flash_head_dim_ok(D):
        raise ValueError(f"attention: head dim {D} not built (16, 32, 64, "
                         f"128, 256)")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    _check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        Hq, Hkv, D, int(bool(causal)), int(window), float(scale), code,
        _stream()), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
