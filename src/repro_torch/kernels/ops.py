"""Kernel wrappers: dispatch by device, launch counters.

The four ZO kernels of the flat FedZO round, the Philox bit generator of
the rbg and unsafe_rbg keys (``philox_bits``, ``utils/prng.py``), the two axpys of the pytree
route (``axpy`` per leaf in ``utils/tree.tree_axpy``; ``axpy2`` and
``tree_axpy2``, the reference's public entry points for ``zo_axpy2``) and
the two of the dense transformer forward (RMSNorm, flash attention). A
tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/zo_axpy.py``,
``kernels/zo_aircomp.py``, ``kernels/philox.py``, ``kernels/rmsnorm.py``,
``kernels/flash_attention.py``). A tensor on a CUDA
device goes to the hand-written kernel (``kernels/csrc/*.cu``), built on
first use, or the call raises: there is no fallback. After every launch the
C launcher's ``cudaGetLastError`` is checked, and the kernel's counter in
``LAUNCHES`` goes up by one, there and nowhere else, so a run can show that
its main path went through the kernels.

Kernels launch on PyTorch's current stream and do not synchronise; outputs
and scratch are allocated here with ``torch.empty``.

On the sharded model path (``launch/sharding.py``) ``rmsnorm`` and
``attention`` take DTensors: each first lays its inputs out so that the
work of a shard is whole (RMSNorm's last dim unsharded; attention sharded
over batch and heads only, heads where both head counts divide), then runs
the kernel (or on the CPU its plain version) on each rank's local shard,
and returns a DTensor of that layout. A kernel never sees a DTensor.

``rmsnorm`` and ``attention`` are differentiable on both devices. No kernel
has a backward (nor has the reference: ``jax.grad`` differentiates its jnp
math), and a launch's output carries no ``grad_fn``; so when autograd is
on and an input requires a gradient, the call goes through an
``autograd.Function`` whose forward is the same dispatch (the kernel on
the card, counted, or the plain version on the CPU) and which saves only
its inputs; its backward recomputes the plain version from them under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it. Calls
that need no gradient (every ZO path) take the direct dispatch. On
``meta`` tensors (the dry-run) that forward allocates only the output and
reports the kernel's work, and the backward runs the same plain recompute
and gradient on ``meta``: the dry-run's counter sees the ops and the
storages the card's backward would run and hold.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.philox import MASK32, philox_bits_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.kernels.zo_aircomp import aircomp_reduce_plain
from repro_torch.kernels.zo_axpy import (dirnorm_geometry, zo_axpy2_plain,
                                         zo_axpy_plain, zo_dirnorms_plain,
                                         zo_replay_plain, zo_walk_plain)
from repro_torch.utils.shardutil import as_dtensor, is_dtensor

LAUNCHES = {"zo_walk": 0, "zo_replay": 0, "zo_dirnorms": 0,
            "aircomp_reduce": 0, "zo_axpy": 0, "zo_axpy2": 0, "rmsnorm": 0,
            "flash_attention": 0, "philox_bits": 0}
_KIND_CODE = {"normal": 0, "sign": 1}
_TICKETS: dict = {}
_AIR_GEOMETRY: dict = {}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# Called as ``META_WORK(name, flops, bytes)`` when a kernel's wrapper is
# given ``meta`` tensors (the dry-run's shards, ``launch/dryrun.py``): the
# wrapper allocates only the kernel's output, as the kernel would, and
# reports the work the kernel would do. None: nothing is reported.
META_WORK = None


def _meta_work(name, flops, nbytes):
    if META_WORK is not None:
        META_WORK(name, float(flops), float(nbytes))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@functools.lru_cache(maxsize=64)
def _attention_pairs(Sq, Sk, causal, window):
    """The (query, key) pairs attention keeps: all of them, or under
    ``causal`` those with ``0 <= q_pos - k_pos`` (query i at position ``i +
    Sk - Sq``), and ``< window`` when a window is set."""
    if not causal:
        return Sq * Sk
    off = Sk - Sq
    total = 0
    for i in range(Sq):
        hi = min(i + off, Sk - 1)
        lo = max(0, i + off - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


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
    """Check x and the vectors (each float32 or bfloat16, x's shape,
    contiguous, on x's device); their dtype codes."""
    codes = [_dtype_code(x, "x")]
    _need(x, "x", x.dtype, x.shape, x.device)
    for name, t in vecs:
        codes.append(_dtype_code(t, name))
        _need(t, name, t.dtype, x.shape, x.device)
    return codes


def _axpy_shards(fn, x, vecs, scalars):
    """``fn`` (``axpy`` or ``axpy2``) of DTensors on each rank's local
    shard: the vectors laid out as x, the scalars whole."""
    local = [_laid_out(t, x.placements).to_local() for t in vecs]
    out = fn(x.to_local(), *local, *[_replicated(c) for c in scalars])
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def axpy(x, u, a):
    """x + a·u in float32, returned in x's dtype (``zo_axpy``). x and u of
    one shape, each float32 or bfloat16, ``a`` a scalar or
    a one-element tensor (on the card, best a float32 tensor there: it is
    read by the kernel, so the host never waits for it). DTensors run on
    each rank's local shard (the kernel never sees a DTensor)."""
    if is_dtensor(x):
        return _axpy_shards(axpy, x, [u], [a])
    if x.device.type == "meta":
        out = torch.empty_like(x)
        _meta_work("zo_axpy", 2 * x.numel(), _nbytes(x, u, out))
        return out
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
    same-shaped x, u, v of any length, each float32 or bfloat16.
    No padding: the kernel masks its own ragged edge. DTensors run on
    each rank's local shard."""
    if is_dtensor(x):
        return _axpy_shards(axpy2, x, [u, v], [a, b])
    if x.device.type == "meta":
        out = torch.empty_like(x)
        _meta_work("zo_axpy2", 4 * x.numel(), _nbytes(x, u, v, out))
        return out
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
    MeZO unperturb-and-reperturb pass): one ``axpy2`` per leaf; a None
    subtree stays None."""
    return {k: tree_axpy2(x, u_tree[k], v_tree[k], a, b)
            if isinstance(x, dict) else None if x is None
            else axpy2(x, u_tree[k], v_tree[k], a, b)
            for k, x in x_tree.items()}


def philox_bits(words, n: int, *, device="cpu", start: int = 0):
    """int32 ``[n]`` (uint32 bit patterns): words ``[start, start + n)`` of
    XLA's RngBitGenerator stream (Philox-4x32-10) of the 4-word key
    ``words`` (ints or a ``[4]`` tensor), on ``device``. The key's words
    are kernel arguments, so a host key costs no copy."""
    words = tuple(int(w) & MASK32 for w in (
        words.tolist() if isinstance(words, torch.Tensor) else words))
    if len(words) != 4:
        raise ValueError(f"philox_bits takes a 4-word key, got {words}")
    device = torch.device(device)
    if device.type == "cpu":
        return philox_bits_plain(words, n, start=start)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    b0 = start // 4
    off = start - 4 * b0
    out = torch.empty(n + off, dtype=torch.int32, device=device)
    lib = build.load()["philox"]
    _check(lib.philox_bits_launch(out.data_ptr(), *words, b0, n + off,
                                  _stream()), "philox_bits")
    LAUNCHES["philox_bits"] += 1
    return out[off:] if off else out


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


def _rmsnorm(x, scale, eps):
    """RMSNorm over the last dim of x ``[..., D]``: ``x · rsqrt(mean(x²) +
    eps) · scale`` in float32, returned in x's dtype. x and scale float32 or
    bfloat16. ``scale`` is ``[D]``, or ``[G, D]`` (any row stride) for G
    equal contiguous groups of x's rows, group g scaled by ``scale[g]``.
    On ``meta`` only the output is allocated and the work reported."""
    if x.device.type == "meta":
        out = torch.empty_like(x)
        _meta_work("rmsnorm", 4 * x.numel(), _nbytes(x, scale, out))
        return out
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


def _attention(q, k, v, causal, window, scale):
    """Flash attention on the reference wrapper's layout: q ``[B, Sq, Hq,
    D]``, k ``[B, Sk, Hkv, D]``, v ``[B, Sk, Hkv, Dv]`` -> ``[B, Sq, Hq,
    Dv]`` in q's dtype (the Pallas kernel's contract: v may have its own
    head dim).

    GQA (``Hq`` a multiple of ``Hkv``); ``window`` > 0 keeps keys with
    ``q_pos − k_pos < window``; ``scale`` defaults to 1/√D. Any Sq, Sk:
    the kernel masks its own ragged edge, so there is no padding and no
    restriction on non-causal calls. A pair (D, Dv) the kernel does not
    build raises ``ValueError`` on the card. On ``meta`` only the output is
    allocated and the work reported.
    """
    if q.device.type == "meta":
        B, Sq, Hq, D = q.shape
        Sk, Dv = k.shape[1], v.shape[3]
        out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device="meta")
        pairs = _attention_pairs(Sq, Sk, causal, window)
        _meta_work("flash_attention", 2 * B * Hq * pairs * (D + Dv),
                   _nbytes(q, k, v, out))
        return out
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    code = _dtype_code(q, "q")
    _need(q, "q", q.dtype, (B, Sq, Hq, D), q.device)
    _need(k, "k", q.dtype, (B, Sk, Hkv, D), q.device)
    _need(v, "v", q.dtype, (B, Sk, Hkv, Dv), q.device)
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    # the kernel copies 16 bytes at a time: an input that starts elsewhere
    # (a slice at an odd row) is copied to a fresh, aligned tensor first
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    lib = build.load()["flash_attention"]
    if not lib.flash_head_dim_ok(D, Dv, code):
        dims = f"head dim {D}" if D == Dv else f"head dims (q/k {D}, v {Dv})"
        raise ValueError(f"attention: {dims} in {q.dtype} not built (equal: "
                         f"8 in float32 only; 16, 32, 64, 128, 256; "
                         f"unequal: (192, 128); (24, 16) in float32 only)")
    # the grid: (q tiles x column groups) of every batch row in grid.x,
    # heads in grid.y
    x_blocks = B * (-(-Sq // 32) if code == 0
                    else -(-Sq // 64) * max(1, Dv // 64))
    if x_blocks > 2**31 - 1 or Hq > 65535:
        raise ValueError(f"attention: {x_blocks} blocks of grid.x (at most "
                         f"2^31 - 1) or {Hq} heads (at most 65,535)")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    _check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        Hq, Hkv, D, Dv, int(bool(causal)), int(window), float(scale), code,
        _stream()), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _plain_grads(ctx, fn, grad_out):
    """Gradients of the plain version ``fn`` at the saved inputs: the
    forward recomputed under autograd, then ``autograd.grad`` of it against
    ``grad_out``, for the inputs that need one (None for the others)."""
    saved = ctx.saved_tensors
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(saved, ctx.needs_input_grad)]
        out = fn(*ins)
        want = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(out, want, grad_out))
    return tuple(next(got) if t.requires_grad else None for t in ins)


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(x, scale, eps):
        return _rmsnorm(x, scale, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, ctx.eps = inputs
        ctx.save_for_backward(x, scale)

    @staticmethod
    def backward(ctx, g):
        return _plain_grads(
            ctx, lambda x, s: rmsnorm_plain(x, s, eps=ctx.eps), g) + (None,)


class _AttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, causal, window, scale):
        return _attention(q, k, v, causal, window, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale = inputs
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, scale=scale)

    @staticmethod
    def backward(ctx, g):
        return _plain_grads(
            ctx, lambda q, k, v: flash_attention_plain(q, k, v, **ctx.kw),
            g) + (None, None, None)


def _laid_out(t, want):
    """DTensor ``t`` redistributed to the placements ``want``."""
    if tuple(t.placements) == tuple(want):
        return t
    return t.redistribute(t.device_mesh, tuple(want))


def _replicated(t, rows=None):
    """The whole of ``t`` on every rank, as a local tensor. ``rows``: the
    placements of the input it meets, whose shards over a mesh axis hold
    distinct rows, so that the gradient of ``t`` is a partial sum over that
    axis (and replicated over the others)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate
    rep = [Replicate()] * t.device_mesh.ndim
    grads = rep if rows is None else [Partial() if p.is_shard() else
                                      Replicate() for p in rows]
    return _laid_out(t, rep).to_local(grad_placements=grads)


def _rmsnorm_shards(x, scale, eps):
    """``rmsnorm`` of a DTensor: its last dim gathered (a partial sum
    reduced), the kernel on each rank's rows, the scale whole."""
    from torch.distributed.tensor import Replicate
    nd = x.ndim
    want = [Replicate() if p.is_partial()
            or (p.is_shard() and p.dim % nd == nd - 1) else p
            for p in x.placements]
    x = _laid_out(x, want)
    out = rmsnorm(x.to_local(), _replicated(scale, rows=want), eps=eps)
    return as_dtensor(out, x.device_mesh, want, tuple(x.shape))


def _attention_shards(q, k, v, causal, window, scale):
    """``attention`` of DTensors: q, k and v laid out alike, over batch
    and heads only (heads where both head counts divide over the mesh
    axes that shard them; every other placement gathered), the kernel on
    each rank's batch rows and heads."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    want, head_n = [], 1
    for i, p in enumerate(q.placements):
        if p.is_shard(0):
            want.append(Shard(0))
        elif p.is_shard(2):
            want.append(Shard(2))
            head_n *= mesh.size(i)
        else:
            want.append(Replicate())
    if q.shape[2] % head_n or k.shape[2] % head_n:
        want = [Replicate() if p.is_shard(2) else p for p in want]
    q, k, v = (_laid_out(t, want) for t in (q, k, v))
    out = attention(q.to_local(), k.to_local(), v.to_local(), causal=causal,
                    window=window, scale=scale)
    B, Sq, Hq = q.shape[:3]
    return as_dtensor(out, q.device_mesh, want, (B, Sq, Hq, v.shape[3]))


def rmsnorm(x, scale, *, eps=1e-6):
    """RMSNorm over the last dim of x ``[..., D]``: ``x · rsqrt(mean(x²) +
    eps) · scale`` in float32, returned in x's dtype (the ``rmsnorm``
    kernel on the card). ``scale`` is ``[D]``, or ``[G, D]`` for G equal
    contiguous groups of x's rows. Differentiable in x and scale (the
    plain version's gradient, recomputed in the backward). A DTensor x
    runs on its local shards (module docstring)."""
    if is_dtensor(x):
        return _rmsnorm_shards(x, scale, eps)
    if _wants_grad(x, scale):
        return _RMSNormFn.apply(x, scale, eps)
    return _rmsnorm(x, scale, eps)


def attention(q, k, v, *, causal=True, window=0, scale=None):
    """Flash attention on the reference wrapper's layout (the
    ``flash_attention`` kernel on the card): q ``[B, Sq, Hq, D]``, k ``[B,
    Sk, Hkv, D]``, v ``[B, Sk, Hkv, Dv]`` -> ``[B, Sq, Hq, Dv]`` in q's
    dtype, at ``scale`` (default 1/√D). Differentiable in q, k and v (the
    plain version's gradient, recomputed in the backward). DTensors run
    on their local shards (module docstring)."""
    if is_dtensor(q):
        return _attention_shards(q, k, v, causal, window, scale)
    if _wants_grad(q, k, v):
        return _AttentionFn.apply(q, k, v, causal, window, scale)
    return _attention(q, k, v, causal, window, scale)
