"""repro_torch.obs — the observability layer of the port.

- ``sinks``    — MetricsSink protocol and JSONL / CSV / memory / fan-out
  sinks.
- ``taps``     — RoundTap: the engine's per-round metric stream (opt-in
  ``tap_every=k``).
- ``trace``    — Tracer: nested spans (compile, execute, segment, eval)
  and a torch.profiler hook.
- ``ledger``   — CommsLedger: per-round wire/dense byte accounting and the
  energy column.
- ``manifest`` — run manifests (config hash, strategy, versions, git sha,
  topology, fault/channel blocks, event stream).

Counterpart of ``repro/obs``; kernel timing and the benchmark snapshots
(``kernel_timing.py``, ``bench.py``) are not ported.
"""
from __future__ import annotations

from repro_torch.obs.ledger import CommsLedger
from repro_torch.obs.manifest import (MANIFEST_NAME, build_manifest, git_sha,
                                      read_manifest, write_manifest)
from repro_torch.obs.sinks import (CsvSink, JsonlSink, MemorySink,
                                   MetricsSink, MultiSink, NullSink,
                                   read_jsonl)
from repro_torch.obs.taps import RoundTap
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "CommsLedger",
    "MANIFEST_NAME", "build_manifest", "git_sha", "read_manifest",
    "write_manifest",
    "CsvSink", "JsonlSink", "MemorySink", "MetricsSink", "MultiSink",
    "NullSink", "read_jsonl",
    "RoundTap",
    "Span", "Tracer",
]
