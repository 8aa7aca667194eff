"""Per-kernel timing harness: measured µs beside the memory-pass model of
the ZO hot-path kernels.

Counterpart of ``repro/obs/kernel_timing.py:1-108``. The flat route's
performance argument is passes over device memory: ``zo_walk`` regenerates
its directions in the kernel, so a perturbation reads and writes the buffer
once, and ``zo_replay`` folds all b2 directions of an iterate into one
read and one write. ``kernel_report`` times ``zo_walk``, ``zo_replay`` and
``aircomp_reduce`` and prints the pass model beside each, projected at the
card's memory rate (``utils/hw.py``): a kernel that regresses drifts away
from a constant model column.

On the card ``time_fn`` takes CUDA events around calls queued back to back
behind a ``torch.cuda._sleep`` spin (``device_ms``): a host clock around a
launch times the wrapper's host work, not the kernel. On the CPU (the
kernels' plain versions) it takes the host clock; those are regression
trackers, not device times.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch import resolve_device
from repro_torch.utils import hw, prng

# projection bandwidth, GB/s: the card's HBM3 rate
HBM_GBPS = hw.HBM_BYTES_PER_S / 1e9


def device_ms(fn, reps: int, trials: int = 3) -> float:
    """Device time of one ``fn()`` on the current CUDA stream, in ms:
    events around ``reps`` calls enqueued back to back, median of
    ``trials``. A ``torch.cuda._sleep`` spin holds the stream while the
    host enqueues the calls, so the events bracket only the calls, which
    then run back to back on the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((2 * enqueue_s + 2e-3) * 2e9))  # ~2 GHz clock
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def _on_cuda(out) -> bool:
    if isinstance(out, (tuple, list)):
        return any(_on_cuda(o) for o in out)
    return isinstance(out, torch.Tensor) and out.is_cuda


def time_fn(fn, *args, iters: int = 20, warmup: int = 1) -> float:
    """Steady-state µs per call of ``fn(*args)``: ``device_ms`` when its
    output lies on a card, else the host clock around ``iters`` calls
    after ``warmup``."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
    if _on_cuda(out):
        return device_ms(lambda: fn(*args), max(1, iters)) * 1e3
    t0 = time.perf_counter()
    for _ in range(max(1, iters)):
        fn(*args)
    return (time.perf_counter() - t0) / max(1, iters) * 1e6


@dataclass
class KernelTiming:
    """One kernel's measured time beside its memory-traffic model."""
    name: str
    measured_us: float
    hbm_passes: float       # full passes over the principal buffer
    hbm_bytes: int          # modelled bytes moved per call
    model_us: float = 0.0   # hbm_bytes at the projection bandwidth
    meta: dict = field(default_factory=dict)

    def rows(self):
        """As benchmark-harness (name, us, derived) tuples."""
        return [(f"{self.name}_us", self.measured_us, self.hbm_passes),
                (f"{self.name}_hbm_model_us", self.model_us,
                 self.hbm_bytes)]


def _model(nbytes: float, gbps: float) -> float:
    return nbytes / (gbps * 1e9) * 1e6  # µs


def kernel_report(*, n: int = None, b2: int = 8, m: int = 8,
                  gbps: float = HBM_GBPS, device="cuda") -> list:
    """Time the three ZO hot-path kernels at one working size on
    ``device``: ``n`` the flat buffer length (default one pad block,
    65,536), ``b2`` the replay's directions, ``m`` the AirComp cohort.
    Returns ``[KernelTiming]`` for ``zo_walk``, ``zo_replay`` and
    ``aircomp_reduce``, with the reference's names and pass model."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.zo_axpy import BLOCK_ROWS, LANES

    device = resolve_device(device)
    if n is None:
        n = BLOCK_ROWS * LANES
    f32 = 4
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((1, n), generator=g, device=device)
    keys = prng.key(1).reshape(1, 2).to(device)
    out = []

    # zo_walk: x read, x' written, directions regenerated in the kernel
    ab = torch.tensor([[-0.1, 0.1]], dtype=torch.float32, device=device)
    us = time_fn(lambda: ops.zo_walk(x, keys, (0, 1), ab))
    out.append(KernelTiming(
        name=f"zo_walk_n{n}", measured_us=us, hbm_passes=2.0,
        hbm_bytes=2 * n * f32, model_us=_model(2 * n * f32, gbps),
        meta={"n": n}))

    # zo_replay: one read and one write fold all b2 directions
    coeffs = torch.linspace(-1.0, 1.0, b2, device=device).reshape(1, b2)
    us = time_fn(lambda: ops.zo_replay(x, keys, coeffs))
    out.append(KernelTiming(
        name=f"zo_replay_n{n}_b2{b2}", measured_us=us, hbm_passes=2.0,
        hbm_bytes=2 * n * f32, model_us=_model(2 * n * f32, gbps),
        meta={"n": n, "b2": b2}))
    del x

    # aircomp_reduce: the [M, n] delta matrix read once, the mean written
    deltas = torch.randn((m, n), generator=g, device=device)
    scale = torch.full((m,), 1.0 / m, dtype=torch.float32, device=device)
    us = time_fn(lambda: ops.aircomp_reduce(deltas, scale, n))
    nbytes = (m + 1) * n * f32
    out.append(KernelTiming(
        name=f"aircomp_reduce_m{m}_n{n}", measured_us=us,
        hbm_passes=m + 1.0, hbm_bytes=nbytes, model_us=_model(nbytes, gbps),
        meta={"m": m, "n": n}))
    return out
