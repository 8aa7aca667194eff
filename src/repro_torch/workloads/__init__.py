"""repro_torch.workloads — gradient-free tasks on the engine.

- ``attack``    — the Sec. V-A federated black-box adversarial attack.
- ``hypertune`` — federated hyperparameter tuning: the ZO loss is the
  inner-trained head's validation loss on each client's private shard.
- ``neural``    — the Sec. V-B training track (softmax, SmallCNN, the
  patch-token transformer).

Counterpart of ``repro/workloads``.
"""
from __future__ import annotations

from repro_torch.workloads import attack, hypertune, neural

__all__ = ["attack", "hypertune", "neural"]
