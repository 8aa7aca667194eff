"""The traced window: ``torch.profiler`` over the whole measured window,
reduced to device intervals, the device's busy time and the breakdown.

Busy time is the union of the device's activity intervals (kernels,
copies, fills), so work on overlapping streams counts once. An idle gap is
a stretch between two merged intervals inside the window, named by the
innermost host event that covers its middle (an ATen op or a harness span:
what the host was doing while the device waited).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass

import torch

WINDOW_SPAN = "fedbench.window"
TOP = 10
NAME_CHARS = 120


@dataclass
class Window:
    """What the readers of ``metrics/`` see of a traced window."""
    kernels: list            # (name, start_ns, duration_ns), device kernels
    busy_s: float
    window_s: float
    rounds: int
    family: object
    cfg: dict
    traffic: dict


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _kind(e) -> str:
    try:
        return str(e.activity_type())
    except (AttributeError, RuntimeError):
        return ""


def events(prof):
    """(device events, host events, window span) of a finished profile:
    (name, start_ns, duration_ns, is_kernel) on the device, (name,
    start_ns, end_ns) on the host, the window span's (start_ns, end_ns)."""
    dev, host, span = [], [], None
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name, t0, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            kind = _kind(e)
            if "annotation" in kind or name.startswith("fedbench."):
                continue          # a host span mirrored on the device
            copy = ("memcpy" in kind or "memset" in kind
                    or name.startswith(("Memcpy", "Memset")))
            dev.append((name, t0, dur, not copy))
        else:
            if name == WINDOW_SPAN:
                span = (t0, t0 + dur)
            host.append((name, t0, t0 + dur))
    return dev, host, span


def merged(intervals):
    """Union of (start, end) intervals, sorted and merged."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(prof, window_s, rounds, family, cfg, traffic):
    """(Window, breakdown) of a finished profile over the window."""
    dev, host, span = events(prof)
    if span is not None:
        lo, hi = span
        dev = [(n, max(t, lo), min(t + d, hi) - max(t, lo), k)
               for n, t, d, k in dev if t + d > lo and t < hi]
    busy = merged([(t, t + d) for _, t, d, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    w = Window(kernels=[(n, t, d) for n, t, d, k in dev if k],
               busy_s=busy_s, window_s=window_s, rounds=rounds,
               family=family, cfg=cfg, traffic=traffic)
    return w, breakdown(dev, busy, host, span)


def breakdown(dev, busy, host, span):
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing, each ``[name, seconds]``."""
    by_name = {}
    for n, _, d, _ in dev:
        by_name[n] = by_name.get(n, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    edges = busy if span is None else [[span[0], span[0]]] + busy \
        + [[span[1], span[1]]]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            gaps.append((b - a, a, b))
    gaps = sorted(gaps, reverse=True)[:TOP]
    host = sorted(host, key=lambda h: h[1])
    spans = [h for h in host if h[0].startswith("fedbench.")]
    starts = [h[1] for h in host]
    named = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        cover = [h for h in host[max(0, i - 4096):i] if h[2] >= mid] or \
            [h for h in spans if h[1] <= mid <= h[2]]
        name = max(cover, key=lambda h: h[1])[0] if cover else "host idle"
        named.append([name[:NAME_CHARS], length / 1e9])
    return {"device_ops": [[n[:NAME_CHARS], d / 1e9] for n, d in ops],
            "idle_gaps": named}
