"""Models for the paper's own experiments (Sec. V-B), in PyTorch.

Counterpart of ``repro/models/simple.py:20-173``: softmax regression, the
LeNet-style SmallCNN, and the paper's Sec. V-A pieces: the CIFAR-shaped CNN
classifier that the federated black-box attack queries, the Carlini–Wagner
attack objective (Eq. 21) and the attack's success rate. Parameters are
plain dicts of tensors in the
reference's layouts (HWIO conv weights, NHWC images), so the flat index of
every scalar, and with it every direction the ZO kernels walk, is the
reference's. The forward permutes to PyTorch's NCHW/OIHW internally.

Losses and accuracies take ONE parameter set; the FedZO round maps them
over the M clients of a cohort with ``torch.func.vmap``.
``mean_xent_batched`` is ``mean_xent`` per client for the client-batched
losses.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.utils import prng


def mean_xent(logits, y):
    """Mean cross-entropy of integer labels."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y.to(torch.int64)[:, None])[:, 0]
    return torch.mean(lse - ll)


def mean_xent_batched(logits, y):
    """``mean_xent`` per row of ``logits`` ``[M', B, C]`` -> ``[M']``, with
    labels ``y`` ``[M, B]`` (M' = r·M: rows m·r … m·r + r − 1 take y[m])."""
    Mp, B, C = logits.shape
    M = y.shape[0]
    lse = torch.logsumexp(logits, dim=-1)
    idx = y.to(torch.int64)[:, None, :, None].expand(M, Mp // M, B, 1)
    ll = torch.gather(logits.reshape(M, Mp // M, B, C), -1, idx)
    return torch.mean(lse - ll.reshape(Mp, B), dim=-1)


# ---------------------------------------------------------------------------
# softmax regression (Sec V-B)


def softmax_init(n_features=784, n_classes=10, *, device="cuda"):
    """Zero weights on ``device`` (the card unless the caller asks for the
    CPU; raises without a card)."""
    device = resolve_device(device)
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
                  device="cuda"):
    """3x3 conv -> 2x2 pool, twice, then a linear head; weights drawn from
    the jax-compatible key chain (``key``: a raw key, ``prng.key(seed)``)
    and placed on ``device`` (the card unless the caller asks for the CPU;
    raises without a card)."""
    device = resolve_device(device)
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


# ---------------------------------------------------------------------------
# small CNN classifier (the black-box target of the attack, Sec. V-A)


def cnn_init(key, n_classes=10, width=16, *, device="cuda"):
    """The 32x32x3 classifier: 3x3 conv (HWIO) -> 2x2 pool, twice, then a
    linear head; weights from the jax-compatible key chain (``key``: a raw
    key) on ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    ks = prng.split(key, 4)

    def conv(k, ci, co):
        return prng.normal(k, (3, 3, ci, co)) * (2.0 / (9 * ci)) ** 0.5

    params = {"c1": conv(ks[0], 3, width),
              "c2": conv(ks[1], width, 2 * width),
              "w": prng.normal(ks[2], (2 * width * 8 * 8, n_classes)) * 0.01,
              "b": torch.zeros((n_classes,), dtype=torch.float32)}
    return {k: v.to(device) for k, v in params.items()}


def cnn_logits(params, images):
    """images [B, 32, 32, 3] in [0, 1] -> logits [B, C] (SAME 3x3 convs,
    VALID 2x2 max-pools, the NHWC flatten of the reference)."""
    return smallcnn_logits(params, images)


def cnn_loss(params, batch):
    return mean_xent(cnn_logits(params, batch["x"]), batch["y"])


# ---------------------------------------------------------------------------
# Carlini-Wagner federated black-box attack loss (Eq. 21)


def _tanh_example(z, x):
    """The adversarial example 0.5·(tanh(atanh(2z − 1) + x) + 1) in [0, 1]
    image space (the paper's [−1/2, 1/2] images under the same
    bijection)."""
    z_c = torch.clamp(z * 2.0 - 1.0, -1 + 1e-6, 1 - 1e-6)
    return 0.5 * (torch.tanh(torch.atanh(z_c) + x) + 1.0)


def cw_attack_loss(x_pert, batch, classifier_params, c=1.0):
    """Eq. (21): the mean over the device's images of
    max(Φ_y(adv) − max_{j≠y} Φ_j(adv), 0) + c·‖adv − z‖².

    ``x_pert`` ``[32·32·3]`` is the shared perturbation (the FedZO
    variable); the classifier is only queried."""
    z, y = batch["x"], batch["y"].to(torch.int64)
    adv = _tanh_example(z, x_pert.reshape(1, 32, 32, 3))
    logits = cnn_logits(classifier_params, adv)
    conf_true = torch.gather(logits, -1, y[:, None])[:, 0]
    onehot = (torch.arange(logits.shape[-1], device=logits.device)
              == y[:, None]).to(logits.dtype)
    conf_best_other = torch.max(logits - 1e9 * onehot, dim=-1).values
    margin = torch.clamp_min(conf_true - conf_best_other, 0.0)
    dist = torch.sum(torch.square(adv - z), dim=(1, 2, 3))
    return torch.mean(margin + c * dist)


def attack_success(x_pert, batch, classifier_params):
    """The share of the batch's images the perturbation misclassifies."""
    z, y = batch["x"], batch["y"].to(torch.int64)
    adv = _tanh_example(z, x_pert.reshape(1, 32, 32, 3))
    pred = torch.argmax(cnn_logits(classifier_params, adv), dim=-1)
    return torch.mean((pred != y).to(torch.float32))
