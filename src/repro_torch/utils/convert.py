"""Parameters between the reference's numpy pytrees and the port's tensors.

The reference's parameters, fetched to the host (``jax.device_get``), are
dicts of numpy arrays; the port's are dicts of tensors in the same layouts
(HWIO conv weights), so a conversion is a copy per leaf. The tests start
both packages from the same weights this way (the SmallCNN init is
random).
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(params, *, device="cpu") -> dict:
    """{name: array-like} -> {name: tensor on ``device``} (dtype kept)."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in params.items()}


def to_numpy(params) -> dict:
    """{name: tensor} -> {name: numpy array} on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
