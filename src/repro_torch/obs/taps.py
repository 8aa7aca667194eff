"""Per-round metric taps.

Counterpart of ``repro/obs/taps.py``. ``RoundTap`` streams the engine's
round metrics to a sink: the port's engine calls ``tap.emit(t, metrics)``
directly after every round t with ``t % tap.every == 0`` (the reference
calls it from inside its compiled scan through an ``io_callback``).
``emit`` turns the round's 0-d tensors into Python scalars, which reads
them from the device: the tap's one host sync per tapped round. With
``tap_every=None`` (the default) the engine makes no tap and no sync.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.obs.sinks import MetricsSink


def _scalar(v):
    """A 0-d tensor or number -> a Python scalar, exactly: floats widen to
    float64 (lossless from float32), ints to int, bools to bool."""
    if isinstance(v, torch.Tensor):
        v = v.item()
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        return int(v)
    return float(v)


@dataclass
class RoundTap:
    """One tap stream: a sink and the cadence ``every`` (the engine's
    ``tap_every=k``: rounds with ``t % every == 0`` are emitted).
    ``emitted`` counts the rows delivered."""
    sink: MetricsSink
    every: int = 1
    meta: dict = field(default_factory=dict)
    emitted: int = 0

    def __post_init__(self):
        if int(self.every) < 1:
            raise ValueError(f"tap_every must be >= 1, got {self.every}")
        self.every = int(self.every)

    def emit(self, t, metrics: dict) -> None:
        """One round's metrics -> one sink row."""
        row = {"round": int(t)}
        row.update({k: _scalar(v) for k, v in metrics.items()})
        if self.meta:
            row.update(self.meta)
        self.sink.write(row)
        self.emitted += 1

    def close(self) -> None:
        self.sink.close()
