"""Parameters between the reference's numpy pytrees and the port's tensors.

The reference's parameters, fetched to the host (``jax.device_get``), are
(nested) dicts of numpy arrays; the port's are dicts of tensors in the same
layouts (HWIO conv weights, ``[d_in, d_out]`` dense weights, a leading
``[L]`` axis on stacked transformer blocks), so a conversion is a copy per
leaf. The tests start both packages from the same weights this way.
Every config's tree converts: tied or untied embeddings, q/k/v biases,
``qk_norm`` scales, routers and experts, the float32 SSM leaves among
bfloat16 ones (each leaf keeps its own dtype), the cross-attention
families' stacks (the vlm's nested ``[G, n_self, ...]`` self layers and
its float32 0-d gates) are leaves like any other, an empty group is None
in both trees, and bfloat16
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
    ``device`` (dtype kept, bfloat16 included). A None subtree (an empty
    stacked group, e.g. a moe config's ``dense_blocks`` without dense
    layers) stays None: jax's trees hold it as a node without leaves."""
    return {k: to_torch(v, device=device) if isinstance(v, dict)
            else None if v is None else _leaf(v, device)
            for k, v in params.items()}


def to_numpy(params) -> dict:
    """{name: tensor or nested dict} -> the same tree of numpy arrays
    (None subtrees kept)."""
    return {k: to_numpy(v) if isinstance(v, dict)
            else None if v is None else v.detach().cpu().numpy()
            for k, v in params.items()}
