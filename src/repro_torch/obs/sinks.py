"""Metric sinks: where the engine's per-round taps land.

Counterpart of ``repro/obs/sinks.py`` (the port keeps its own copy). A
sink consumes per-round metric rows — plain dicts of Python scalars with at
least a ``"round"`` key — that the engine emits after every k-th round
(``sim/engine.py``, opt-in ``tap_every=k``). Sinks are plain host-side
objects with no buffering policy beyond ``flush_every``, so a ``tail -f``
on a ``JsonlSink`` file is the live view of a running federation.

Row values are Python floats/ints before they reach a sink, and floats
serialize via ``repr`` (shortest round-trip decimal), so a row read back
from JSONL equals the float64 widening of the float32 metric the engine
wrote.
"""
from __future__ import annotations

import json
import os
from typing import Optional


class MetricsSink:
    """Base/no-op sink — also the protocol every sink implements.

    ``write(row)`` consumes one per-round row; ``flush``/``close`` are
    lifecycle hooks (file sinks honor them, memory sinks no-op). Sinks
    support the context-manager protocol so ``with JsonlSink(p) as s:``
    always leaves a closed, fully-flushed file.
    """

    def write(self, row: dict) -> None:  # pragma: no cover - interface
        del row

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NullSink(MetricsSink):
    """Swallow rows (counts them): the tap's cost without the I/O."""

    def __init__(self):
        self.count = 0

    def write(self, row: dict) -> None:
        self.count += 1


class MemorySink(MetricsSink):
    """Accumulate rows in a host-side list (tests, notebooks)."""

    def __init__(self):
        self.rows: list = []

    def write(self, row: dict) -> None:
        self.rows.append(dict(row))


class JsonlSink(MetricsSink):
    """One JSON object per line, appended to ``path``.

    ``flush_every=1`` (default) flushes after every row so a concurrent
    ``tail -f path`` streams the run live; raise it to amortize syscalls
    on very hot taps. The file is opened lazily on the first row, so
    constructing a sink never touches disk.
    """

    def __init__(self, path: str, *, flush_every: int = 1):
        self.path = path
        self.flush_every = max(1, int(flush_every))
        self._f = None
        self._since_flush = 0

    def _file(self):
        if self._f is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a")
        return self._f

    def write(self, row: dict) -> None:
        self._file().write(json.dumps(row) + "\n")
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._since_flush = 0

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None


def read_jsonl(path: str) -> list:
    """Read a JsonlSink file back into a list of row dicts."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


class CsvSink(MetricsSink):
    """Wide-format CSV: the header is fixed by the FIRST row's keys; later
    rows missing a column write an empty cell, extra keys are dropped (the
    tap emits a fixed metric set per run, so in practice every row
    matches). Good for spreadsheet-side consumption of a single run."""

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._cols: Optional[list] = None

    def write(self, row: dict) -> None:
        if self._f is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a")
            self._cols = list(row)
            self._f.write(",".join(self._cols) + "\n")
        self._f.write(",".join(
            "" if c not in row else repr(row[c]) if isinstance(row[c], float)
            else str(row[c]) for c in self._cols) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class MultiSink(MetricsSink):
    """Fan one tap stream out to several sinks (e.g. JSONL on disk + an
    in-memory tail for the driving process)."""

    def __init__(self, *sinks: MetricsSink):
        self.sinks = list(sinks)

    def write(self, row: dict) -> None:
        for s in self.sinks:
            s.write(row)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()
