"""Trace spans and the profiler hook.

Counterpart of ``repro/obs/trace.py``. A ``Tracer`` records a tree of
wall-clock spans around the phases of a run — ``compile``, ``execute`` or
``segment``, ``eval``, whatever a driver opens. Spans nest: the tracer
keeps a stack, every span records its depth and parent, and ``report()``
renders the tree.

The port runs eagerly, so a span times device work only if the device has
finished it: on a CUDA run a span ends after ``torch.cuda.synchronize()``.
The reference's ``compile`` span is its XLA compile; the port's one-time
compile is the CUDA build of its kernels (``kernels/build.load``), and
``compile_once`` records it once per key, the first time a traced run on
the card needs it (on the CPU there is nothing to build, and the span
records the no-op once all the same). ``Tracer(profile_dir=...)`` wraps a
run in a ``torch.profiler`` trace, written to ``profile_dir`` as
``trace.json`` (the reference writes a ``jax.profiler`` trace there).
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import torch


def _sync():
    """Wait for the card's queued work (a no-op without a CUDA context)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class Span:
    name: str
    start: float
    duration: float = 0.0
    depth: int = 0
    parent: Optional[int] = None   # index into Tracer.spans
    meta: dict = field(default_factory=dict)


class Tracer:
    """Hierarchical wall-clock span recorder and optional torch.profiler
    hook. One tracer per driver (not thread-safe)."""

    def __init__(self, profile_dir: Optional[str] = None):
        self.spans: list = []
        self.profile_dir = profile_dir
        self._stack: list = []       # indices of open spans
        self._compiled: set = set()  # keys whose compile span was recorded

    @contextmanager
    def span(self, name: str, **meta):
        _sync()
        idx = len(self.spans)
        s = Span(name=name, start=time.perf_counter(),
                 depth=len(self._stack),
                 parent=self._stack[-1] if self._stack else None,
                 meta=dict(meta))
        self.spans.append(s)
        self._stack.append(idx)
        try:
            yield s
        finally:
            _sync()
            s.duration = time.perf_counter() - s.start
            self._stack.pop()

    @contextmanager
    def profile(self):
        """Wrap a block in a torch.profiler trace when ``profile_dir`` is
        set (CPU and, with a card, CUDA activity; the chrome trace lands
        in ``profile_dir/trace.json``); a no-op otherwise."""
        if not self.profile_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            with self.span("torch_profile", trace_dir=self.profile_dir):
                yield
        prof.export_chrome_trace(os.path.join(self.profile_dir,
                                              "trace.json"))

    # -- compile/execute separation ------------------------------------------
    def compile_once(self, key, build) -> None:
        """Run ``build()`` under a ``compile`` span once per ``key``;
        later calls with the same key record nothing."""
        if key not in self._compiled:
            with self.span("compile", key=str(key)):
                build()
            self._compiled.add(key)

    # -- reporting -----------------------------------------------------------
    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def total(self, name: str) -> float:
        """Summed seconds across all spans of one name."""
        return sum(s.duration for s in self.named(name))

    def totals(self) -> dict:
        out: dict = {}
        for s in self.spans:
            agg = out.setdefault(s.name, {"count": 0, "seconds": 0.0})
            agg["count"] += 1
            agg["seconds"] += s.duration
        return out

    def report(self) -> str:
        """The span tree as indented text, one line per span."""
        lines = []
        for s in self.spans:
            meta = (" " + " ".join(f"{k}={v}" for k, v in s.meta.items())
                    if s.meta else "")
            lines.append(f"{'  ' * s.depth}{s.name}: "
                         f"{s.duration * 1e3:.2f} ms{meta}")
        return "\n".join(lines)
