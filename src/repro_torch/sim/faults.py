"""The divergence error of ``FedServer``'s guard.

Counterpart of ``DivergenceError`` in ``repro/sim/faults.py``. The rest of
that module (``FaultModel``: client availability chains, stragglers,
corrupted uploads and the finite-guard) is not ported (ROADMAP.md section
A, item 5).
"""
from __future__ import annotations


class DivergenceError(RuntimeError):
    """A run diverged (non-finite params or metrics) and stayed divergent
    through the bounded lr-backoff retries."""

    def __init__(self, round_idx: int, retries: int, lr: float,
                 detail: str = ""):
        self.round = int(round_idx)
        self.retries = int(retries)
        self.lr = float(lr)
        msg = (f"experiment diverged at round {round_idx} and stayed "
               f"divergent after {retries} lr-backoff retries "
               f"(last lr={lr:g})")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
