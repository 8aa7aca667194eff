"""Parameters between the reference's numpy pytrees and the port's tensors.

The reference's parameters, fetched to the host (``jax.device_get``), are
(nested) dicts of numpy arrays; the port's are dicts of tensors in the same
layouts (HWIO conv weights, ``[d_in, d_out]`` dense weights, a leading
``[L]`` axis on stacked transformer blocks), so a conversion is a copy per
leaf. The tests start both packages from the same weights this way.
Every dense config's tree converts: tied or untied embeddings, q/k/v
biases and ``qk_norm`` scales are leaves like any other, and bfloat16
leaves (numpy's ``bfloat16`` extension dtype, which ``torch.from_numpy``
does not take) are carried bit for bit through their 16-bit words.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(v, device):
    a = np.array(v, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_torch(params, *, device="cpu") -> dict:
    """{name: array-like or nested dict} -> the same tree of tensors on
    ``device`` (dtype kept, bfloat16 included)."""
    return {k: to_torch(v, device=device) if isinstance(v, dict)
            else _leaf(v, device) for k, v in params.items()}


def to_numpy(params) -> dict:
    """{name: tensor or nested dict} -> the same tree of numpy arrays."""
    return {k: to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in params.items()}
