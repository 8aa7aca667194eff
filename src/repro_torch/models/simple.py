"""Models for the paper's own experiments (Sec. V-B), in PyTorch.

Counterpart of ``repro/models/simple.py:20-97``: softmax regression and the
LeNet-style SmallCNN. Parameters are plain dicts of tensors in the
reference's layouts (HWIO conv weights, NHWC images), so the flat index of
every scalar, and with it every direction the ZO kernels walk, is the
reference's. The forward permutes to PyTorch's NCHW/OIHW internally.

Losses and accuracies take ONE parameter set; the FedZO round maps them
over the M clients of a cohort with ``torch.func.vmap``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils import prng


def mean_xent(logits, y):
    """Mean cross-entropy of integer labels."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y.to(torch.int64)[:, None])[:, 0]
    return torch.mean(lse - ll)


# ---------------------------------------------------------------------------
# softmax regression (Sec V-B)


def softmax_init(n_features=784, n_classes=10, *, device="cpu"):
    return {"w": torch.zeros((n_features, n_classes), dtype=torch.float32,
                             device=device),
            "b": torch.zeros((n_classes,), dtype=torch.float32,
                             device=device)}


def softmax_logits(params, x):
    return x @ params["w"] + params["b"]


def softmax_loss(params, batch):
    """batch: {"x": [B, F], "y": [B]} -> mean cross-entropy."""
    return mean_xent(softmax_logits(params, batch["x"]), batch["y"])


def softmax_accuracy(params, batch):
    pred = torch.argmax(softmax_logits(params, batch["x"]), dim=-1)
    return torch.mean((pred == batch["y"].to(torch.int64)).to(torch.float32))


# ---------------------------------------------------------------------------
# trainable LeNet-style SmallCNN (Sec V-B CNN track)


def _conv_pool(h, w_hwio):
    """3x3 SAME conv (HWIO weight) + relu + VALID 2x2 max-pool, NCHW."""
    h = F.conv2d(h, w_hwio.permute(3, 2, 0, 1), padding=1)
    return F.max_pool2d(F.relu(h), 2)


def smallcnn_init(key, image_shape=(28, 28, 1), n_classes=10, width=8, *,
                  device="cpu"):
    """3x3 conv -> 2x2 pool, twice, then a linear head; weights drawn from
    the jax-compatible key chain (``key``: a raw key, ``prng.key(seed)``)."""
    h, w, cin = image_shape
    fh, fw = (h // 2) // 2, (w // 2) // 2
    ks = prng.split(key, 3)

    def conv(k, ci, co):
        return prng.normal(k, (3, 3, ci, co)) * (2.0 / (9 * ci)) ** 0.5

    params = {"c1": conv(ks[0], cin, width),
              "c2": conv(ks[1], width, 2 * width),
              "w": prng.normal(ks[2], (2 * width * fh * fw, n_classes)) * 0.01,
              "b": torch.zeros((n_classes,), dtype=torch.float32)}
    return {k: v.to(device) for k, v in params.items()}


def smallcnn_logits(params, images):
    """images [B, H, W, C] in [0, 1] -> logits [B, n_classes]."""
    h = (images * 2.0 - 1.0).permute(0, 3, 1, 2)
    h = _conv_pool(h, params["c1"])
    h = _conv_pool(h, params["c2"])
    h = h.permute(0, 2, 3, 1)                     # back to NHWC for the head
    return h.reshape(h.shape[0], -1) @ params["w"] + params["b"]


def smallcnn_loss(params, batch):
    return mean_xent(smallcnn_logits(params, batch["x"]), batch["y"])


def smallcnn_accuracy(params, batch):
    pred = torch.argmax(smallcnn_logits(params, batch["x"]), dim=-1)
    return torch.mean((pred == batch["y"].to(torch.int64)).to(torch.float32))
