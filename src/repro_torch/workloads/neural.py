"""Neural FedZO: the paper's Sec. V-B training track, in PyTorch.

Counterpart of ``repro/workloads/neural.py:42-190`` for the ``softmax`` and
``cnn`` tracks: a model's init/loss/accuracy triple, the Dirichlet-skewed
client shards of the synthetic class-conditional problem stacked into a
``ClientStore`` on the device, and the pooled held-out test batch. The model
trains forward-only through the flat FedZO round.

Entry points take ``device="cuda"`` by default and raise without a card.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import FedZOConfig
from repro_torch.data.synthetic import federated_classification
from repro_torch.models import simple
from repro_torch.sim import engine
from repro_torch.sim.store import ClientStore, build_store
from repro_torch.utils import prng


class NeuralTask(NamedTuple):
    name: str
    init: Callable        # (seed) -> params dict on the task's device
    loss: Callable        # (params, batch) -> scalar mean cross-entropy
    accuracy: Callable    # (params, batch) -> top-1 accuracy
    clients: list
    store: ClientStore
    test: dict            # pooled {"x", "y"} held-out batch on the device


def _softmax_triple(n_features, n_classes, kw, device):
    return (lambda seed: simple.softmax_init(n_features, n_classes,
                                             device=device),
            simple.softmax_loss, simple.softmax_accuracy, None)


def _cnn_triple(n_features, n_classes, kw, device):
    shape = kw.pop("image_shape")
    width = kw.pop("width", 8)
    return (lambda seed: simple.smallcnn_init(prng.key(seed), shape,
                                              n_classes, width,
                                              device=device),
            simple.smallcnn_loss, simple.smallcnn_accuracy, shape)


_TRIPLES = {"softmax": _softmax_triple, "cnn": _cnn_triple}


def make_task(name="softmax", *, device="cuda", **kw) -> NeuralTask:
    """Build a registered neural FedZO task on ``device``.

    ``name``: softmax | cnn (the reference's transformer track is not
    ported). Keywords are the reference's: data (n_train, n_test,
    n_clients, n_features, n_classes, seed, scale, partition, alpha) and
    model (cnn: image_shape, width). Cached per argument set.
    """
    if kw.get("image_shape") is not None:
        kw["image_shape"] = tuple(kw["image_shape"])
    return _make_task(name, str(resolve_device(device)), **kw)


@functools.lru_cache(maxsize=8)
def _make_task(name, device, *, n_train=2000, n_test=512, n_clients=10,
               n_features=784, n_classes=10, seed=0, scale=1.0,
               partition="dirichlet", alpha=0.5, **model_kw) -> NeuralTask:
    if name not in _TRIPLES:
        raise NotImplementedError(f"neural task {name!r} is not ported; "
                                  f"ported: {sorted(_TRIPLES)}")
    kw = dict(model_kw)
    if name == "cnn":
        shape = tuple(kw.get("image_shape") or (28, 28, 1))
        kw["image_shape"] = shape
        n_features = 1
        for s in shape:
            n_features *= s
    dev = torch.device(device)
    init, loss, acc, image_shape = _TRIPLES[name](n_features, n_classes, kw,
                                                  dev)
    if kw:
        raise ValueError(f"unknown model kwargs for task {name!r}: "
                         f"{sorted(kw)}")
    clients, test = federated_classification(
        n_train, n_test, n_clients, n_features=n_features,
        n_classes=n_classes, seed=seed, scale=scale,
        image_shape=image_shape, partition=partition, alpha=alpha)
    return NeuralTask(name=name, init=init, loss=loss, accuracy=acc,
                      clients=clients, store=build_store(clients, device=dev),
                      test={k: torch.from_numpy(v).to(dev)
                            for k, v in test.items()})


def params_init(task: NeuralTask, seed: int = 0):
    """Fresh model parameters for a task (the FedZO server state x^0)."""
    return task.init(seed)


def task_eval(task: NeuralTask, max_rows: int = 1024):
    """Pooled top-1 test accuracy and test loss on the first ``max_rows``
    test rows."""
    test = {k: v[:max_rows] for k, v in task.test.items()}

    def ev(params):
        return {"test_acc": task.accuracy(params, test),
                "test_loss": task.loss(params, test)}

    return ev


def default_config(task: NeuralTask, **overrides) -> FedZOConfig:
    """Sec. V-B-shaped hyperparameters (the reference's defaults)."""
    kw = dict(n_devices=task.store.n_clients,
              n_participating=max(2, task.store.n_clients // 2),
              local_iters=5, lr=5e-3, mu=1e-3, b1=25, b2=20,
              weight_by_size=True)
    kw.update(overrides)
    return FedZOConfig(**kw)


def run(task: NeuralTask, cfg: FedZOConfig, rounds: int, *, eval_every=2,
        eval_rows=1024, params=None, **kw) -> engine.ExperimentResult:
    """Train the task's model with FedZO for ``rounds`` rounds. ``params``
    overrides the seeded init (to start from given weights)."""
    if params is None:
        params = params_init(task, cfg.seed)
    return engine.run_experiment(task.loss, params, task.store, cfg, rounds,
                                 eval_fn=task_eval(task, eval_rows),
                                 eval_every=eval_every, **kw)
