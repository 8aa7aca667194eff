"""Parameters between the reference's numpy pytrees and the port's tensors.

The reference's parameters, fetched to the host (``jax.device_get``), are
(nested) dicts of numpy arrays; the port's are dicts of tensors in the same
layouts (HWIO conv weights, ``[d_in, d_out]`` dense weights, a leading
``[L]`` axis on stacked transformer blocks), so a conversion is a copy per
leaf. The tests start both packages from the same weights this way.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(params, *, device="cpu") -> dict:
    """{name: array-like or nested dict} -> the same tree of tensors on
    ``device`` (dtype kept)."""
    return {k: to_torch(v, device=device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in params.items()}


def to_numpy(params) -> dict:
    """{name: tensor or nested dict} -> the same tree of numpy arrays."""
    return {k: to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in params.items()}
