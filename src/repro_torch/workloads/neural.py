"""Neural FedZO: the paper's Sec. V-B training track, in PyTorch.

Counterpart of ``repro/workloads/neural.py:42-190`` with its three tracks,
``softmax``, ``cnn`` and ``transformer`` (a patch-token classifier on the
LM's blocks, whose loss carries its client-batched form as
``loss.batched``): a model's init/loss/accuracy triple, the Dirichlet-skewed
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
from repro_torch.configs.base import FedZOConfig, ModelConfig
from repro_torch.data.synthetic import federated_classification
from repro_torch.models import simple, transformer
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


def _transformer_triple(n_features, n_classes, kw, device):
    n_patches = kw.pop("n_patches", 8)
    if n_features % n_patches:
        raise ValueError(f"n_features={n_features} must split into "
                         f"{n_patches} patch tokens")
    d_model = kw.pop("d_model", 32)
    n_heads = kw.pop("n_heads", 2)
    cfg = ModelConfig(
        name="tiny-patch-cls", family="dense",
        source="repro-internal tiny head (DESIGN.md §11)",
        n_layers=kw.pop("n_layers", 1), d_model=d_model,
        d_ff=kw.pop("d_ff", 64), vocab=0, n_heads=n_heads,
        n_kv_heads=n_heads, head_dim=d_model // n_heads,
        act="gelu", dtype="float32")
    patch_dim = n_features // n_patches

    def loss(p, b):
        return transformer.classifier_loss(p, b, cfg)

    def loss_batched(p, b):
        return transformer.classifier_loss_batched(p, b, cfg)

    loss.batched = loss_batched
    return (lambda seed: transformer.init_classifier(
                prng.key(seed), cfg, n_patches=n_patches,
                patch_dim=patch_dim, n_classes=n_classes, device=device),
            loss,
            lambda p, b: transformer.classifier_accuracy(p, b, cfg),
            None)


_TRIPLES = {"softmax": _softmax_triple, "cnn": _cnn_triple,
            "transformer": _transformer_triple}


def make_task(name="softmax", *, device="cuda", **kw) -> NeuralTask:
    """Build a registered neural FedZO task on ``device``.

    ``name``: softmax | cnn | transformer. Keywords are the reference's:
    data (n_train, n_test, n_clients, n_features, n_classes, seed, scale,
    partition, alpha) and model (cnn: image_shape, width; transformer:
    n_patches, n_layers, d_model, d_ff, n_heads). Cached per argument set.
    """
    if kw.get("image_shape") is not None:
        kw["image_shape"] = tuple(kw["image_shape"])
    return _make_task(name, str(resolve_device(device)), **kw)


@functools.lru_cache(maxsize=8)
def _make_task(name, device, *, n_train=2000, n_test=512, n_clients=10,
               n_features=784, n_classes=10, seed=0, scale=1.0,
               partition="dirichlet", alpha=0.5, **model_kw) -> NeuralTask:
    if name not in _TRIPLES:
        raise ValueError(f"unknown neural task {name!r}; registered: "
                         f"{sorted(_TRIPLES)}")
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
        mesh=None, eval_rows=1024, params=None,
        **kw) -> engine.ExperimentResult:
    """Train the task's model with FedZO for ``rounds`` rounds. ``params``
    overrides the seeded init (to start from given weights). ``mesh`` (a
    ``sim.make_clients_mesh()``) fans the M sampled clients out over its
    ranks through the sharded round (``sim/shard.py``); every rank runs
    this call."""
    if mesh is not None:
        from repro_torch.sim.shard import make_sharded_round
        kw.setdefault("round_fn", make_sharded_round(task.loss, cfg, mesh))
    if params is None:
        params = params_init(task, cfg.seed)
    return engine.run_experiment(task.loss, params, task.store, cfg, rounds,
                                 eval_fn=task_eval(task, eval_rows),
                                 eval_every=eval_every, **kw)


def run_sweep(task: NeuralTask, base_cfg: FedZOConfig, scenarios, rounds, *,
              eval_every=2, eval_rows=1024, out_csv=None) -> list:
    """A scenario grid over the task (``sim.run_sweep``): one batched round
    loop per static group, the {snr_db, lr, mu, h_min, seed} axes per row;
    the per-round metrics and the eval curve land as long-format CSV."""
    from repro_torch.sim import sweep
    return sweep.run_sweep(task.loss, params_init(task, base_cfg.seed),
                           task.store, base_cfg, scenarios, rounds,
                           eval_fn=task_eval(task, eval_rows),
                           eval_every=eval_every, out_csv=out_csv)
