"""Federated hyperparameter tuning as a FedZO workload.

Counterpart of ``repro/workloads/hypertune.py:1-140``: the second
gradient-free setting the paper motivates. The federated "model" is the
vector ``{"h": [log lr, log λ]}`` of an L2-regularized softmax head; each
loss query trains the head on a shared public train set for
``inner_steps`` full-batch gradient steps at ``lr = exp(h[0])``, ``λ =
exp(h[1])`` and returns the trained head's cross-entropy on the client's
private validation minibatch. No gradient of that value with respect to
``h`` reaches the clients; the inner problem itself is differentiated
(``torch.func.grad``).

``tune_loss`` carries its client-batched form as ``loss.batched`` for the
flat route: the inner training of the whole cohort's ``[M', 2]`` vectors
under ``torch.func.vmap`` (the inner loop launches no kernel, so the map is
legal), then one batched head forward against the ``[M, ...]`` validation
batch. Entry points take ``device="cuda"`` by default and raise without a
card.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import resolve_device, sim
from repro_torch.configs.base import FedZOConfig
from repro_torch.data.synthetic import dirichlet_partition, make_classification
from repro_torch.models.simple import (mean_xent_batched, softmax_accuracy,
                                       softmax_loss)

# keep exp() of perturbed log-hyperparameters in a numerically sane band
LOG_LR_RANGE = (-7.0, 1.0)
LOG_LAM_RANGE = (-9.0, 2.0)


class HyperTuneTask(NamedTuple):
    """Shared public train set and private per-client validation shards
    (host lists and the stacked store on the task's device)."""
    train: dict
    clients: list
    store: sim.ClientStore
    val_all: dict
    inner_steps: int
    n_features: int
    n_classes: int


@functools.lru_cache(maxsize=2)
def make_task(n_train=256, n_val=768, n_clients=8, n_features=32,
              n_classes=4, seed=0, inner_steps=12, alpha=0.5, *,
              device="cuda") -> HyperTuneTask:
    """Synthetic tuning problem on ``device``: one public train split, the
    validation rows Dirichlet(α)-label-skewed across ``n_clients`` private
    shards (the reference's draws)."""
    device = resolve_device(device)
    x, y = make_classification(n_train + n_val, n_features, n_classes,
                               seed=seed)
    clients = dirichlet_partition(x[n_train:], y[n_train:], n_clients,
                                  alpha=alpha, seed=seed)

    def put(a):
        return torch.from_numpy(a).to(device)

    return HyperTuneTask(
        train={"x": put(x[:n_train]), "y": put(y[:n_train])},
        clients=clients, store=sim.build_store(clients, device=device),
        val_all={"x": put(x[n_train:]), "y": put(y[n_train:])},
        inner_steps=inner_steps, n_features=n_features,
        n_classes=n_classes)


def hp_init(log_lr=-4.0, log_lam=-4.0, *, device="cuda"):
    """A deliberately mis-tuned start (a tiny inner lr underfits the head)
    on ``device``."""
    return {"h": torch.tensor([log_lr, log_lam], dtype=torch.float32,
                              device=resolve_device(device))}


def transform(h):
    """(lr, λ) from the unconstrained log-space vector, clipped to the
    sane bands."""
    return (torch.exp(torch.clamp(h[0], *LOG_LR_RANGE)),
            torch.exp(torch.clamp(h[1], *LOG_LAM_RANGE)))


def inner_train(task: HyperTuneTask, h):
    """The head trained under hyperparameters ``h``: ``inner_steps``
    full-batch gradient steps on the shared train set from zero weights
    (the inner problem may use gradients; only the outer one is a black
    box)."""
    lr, lam = transform(h)

    def reg_loss(p):
        return softmax_loss(p, task.train) + 0.5 * lam * torch.sum(
            p["w"] ** 2)

    grad = torch.func.grad(reg_loss)
    p = {"w": torch.zeros((task.n_features, task.n_classes),
                          dtype=torch.float32, device=h.device),
         "b": torch.zeros((task.n_classes,), dtype=torch.float32,
                          device=h.device)}
    for _ in range(task.inner_steps):
        g = grad(p)
        p = {k: p[k] - lr * g[k] for k in p}
    return p


def tune_loss(task: HyperTuneTask):
    """The engine's loss: params the hyperparameter vector, batch a
    private validation minibatch, value the inner-trained head's
    validation cross-entropy; ``loss.batched`` is the cohort form
    (``[M', 2]`` vectors against ``[M, ...]`` batches, M' = r·M)."""
    def loss(params, batch):
        return softmax_loss(inner_train(task, params["h"]), batch)

    def loss_batched(params, batch):
        heads = torch.func.vmap(lambda h: inner_train(task, h))(params["h"])
        mp = heads["w"].shape[0]
        m = batch["x"].shape[0]
        w = heads["w"].reshape(m, mp // m, task.n_features, task.n_classes)
        logits = torch.matmul(batch["x"][:, None], w) + heads["b"].reshape(
            m, mp // m, 1, task.n_classes)
        return mean_xent_batched(logits.reshape(mp, -1, task.n_classes),
                                 batch["y"])

    loss.batched = loss_batched
    return loss


def tune_eval(task: HyperTuneTask):
    """The run's eval: pooled validation loss and accuracy of the tuned
    hyperparameters, and the log hyperparameters themselves."""
    def ev(params):
        head = inner_train(task, params["h"])
        return {"val_loss": softmax_loss(head, task.val_all),
                "val_acc": softmax_accuracy(head, task.val_all),
                "log_lr": params["h"][0], "log_lam": params["h"][1]}
    return ev


def default_config(task: HyperTuneTask, **overrides) -> FedZOConfig:
    """A 2-dimensional problem: few directions and a larger smoothing
    radius (log-space units); size weighting matches the skewed shards."""
    kw = dict(n_devices=task.store.n_clients,
              n_participating=min(4, task.store.n_clients),
              local_iters=2, lr=0.2, mu=0.05, b1=16, b2=6,
              weight_by_size=True)
    kw.update(overrides)
    return FedZOConfig(**kw)


def run(task: HyperTuneTask, cfg: FedZOConfig, rounds: int, *, eval_every=2,
        **kw) -> sim.ExperimentResult:
    """One federated tuning run through the engine."""
    return sim.run_experiment(tune_loss(task), hp_init(
        device=task.store.device), task.store, cfg, rounds,
        eval_fn=tune_eval(task), eval_every=eval_every, **kw)
