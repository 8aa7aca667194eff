"""The federated black-box adversarial attack (paper Sec. V-A) on the
engine.

Counterpart of ``repro/workloads/attack.py``. FedZO finds one shared
perturbation that fools a frozen classifier, querying only its outputs
(the CW loss, Eq. 21). The per-client attack images live in a
``ClientStore`` on the device (uneven shard sizes, as in the paper — 'each
device is assigned a random number of samples' — or Dirichlet label skew),
the attack-success eval runs inside the run every ``eval_every`` rounds,
and the paper's AirComp SNR curve family is one ``sim.run_sweep``, written
as long-format CSV.

The classifier stands in for the pretrained CIFAR-10 network: a small CNN
trained here on synthetic CIFAR-like images (300 SGD steps at lr 0.05,
batch 64, the reference's row draws), with torch autograd; the attack only
queries it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device, sim
from repro_torch.configs.base import FedZOConfig
from repro_torch.core.fedavg import value_and_grad
from repro_torch.data.synthetic import (dirichlet_partition, make_classification,
                                        random_partition)
from repro_torch.models import simple
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_map

IMAGE_SHAPE = (32, 32, 3)
D = int(np.prod(IMAGE_SHAPE))
# CW margin-vs-distortion trade-off, shared by the loss and the eval so the
# reported curve is the optimized objective
CW_C = 0.3


class AttackTask(NamedTuple):
    """The federated attack problem: a frozen classifier, the per-client
    image shards (host lists and the stacked device store), and the pooled
    correctly-classified images the success rate is measured on."""
    classifier: dict
    clients: list
    store: sim.ClientStore
    eval_batch: dict
    clean_accuracy: float


@functools.lru_cache(maxsize=2)
def make_task(n_train=2000, n_attack=512, n_clients=10, seed=0,
              train_steps=300, partition="uneven", alpha=0.5, *,
              device="cuda") -> AttackTask:
    """Train the surrogate classifier on synthetic CIFAR-like data on
    ``device`` (the card unless the caller asks for the CPU), keep the
    correctly-classified images, and split them across ``n_clients``
    (``partition``: "uneven" random sizes, "dirichlet" label skew with
    concentration ``alpha``, or "even")."""
    device = resolve_device(device)
    x, y = make_classification(n_train + 512, D, 10, seed=seed,
                               scale=0.35, image_shape=IMAGE_SHAPE)
    xtr = torch.from_numpy(x[:n_train]).to(device)
    ytr = torch.from_numpy(y[:n_train]).to(device)
    params = simple.cnn_init(prng.key(seed), device=device)
    rng = np.random.default_rng(seed)
    for _ in range(train_steps):
        idx = torch.from_numpy(rng.integers(0, n_train, 64)).to(device)
        _, g = value_and_grad(simple.cnn_loss, params,
                              {"x": xtr[idx], "y": ytr[idx]})
        params = tree_map(lambda a, b: a - 0.05 * b, params, g)

    with torch.no_grad():
        pred = torch.argmax(simple.cnn_logits(
            params, torch.from_numpy(x).to(device)), -1)
    correct = (pred.cpu().numpy() == y)
    acc = correct[:n_train].mean()
    xi, yi = x[correct][:n_attack], y[correct][:n_attack]
    flat = xi.reshape(len(yi), -1)
    if partition == "dirichlet":
        clients = dirichlet_partition(flat, yi, n_clients, alpha=alpha,
                                      seed=seed)
    else:
        clients = random_partition(flat, yi, n_clients, seed=seed,
                                   uneven=(partition == "uneven"))
    for c in clients:
        c["x"] = c["x"].reshape((-1,) + IMAGE_SHAPE)
    return AttackTask(classifier=params, clients=clients,
                      store=sim.build_store(clients, device=device),
                      eval_batch={"x": torch.from_numpy(xi).to(device),
                                  "y": torch.from_numpy(yi).to(device)},
                      clean_accuracy=float(acc))


def attack_loss(task: AttackTask, c=CW_C):
    """The engine's loss: ``loss(pert_params, batch) -> scalar`` CW
    objective, the classifier closed over as a black box. Pass the same
    ``c`` to ``attack_eval``."""
    def loss(pert_params, batch):
        return simple.cw_attack_loss(pert_params["x"], batch,
                                     task.classifier, c=c)
    return loss


def attack_eval(task: AttackTask, c=CW_C):
    """The in-run eval: attack success rate and CW loss over the pooled
    correctly-classified images."""
    def ev(pert_params):
        with torch.no_grad():
            return {"attack_success": simple.attack_success(
                        pert_params["x"], task.eval_batch, task.classifier),
                    "eval_cw_loss": simple.cw_attack_loss(
                        pert_params["x"], task.eval_batch, task.classifier,
                        c=c)}
    return ev


def pert_init(device="cuda"):
    """The shared perturbation the federation optimizes (the ZO
    variable), zero, on ``device``."""
    return {"x": torch.zeros((D,), dtype=torch.float32,
                             device=resolve_device(device))}


def default_config(task: AttackTask, **overrides) -> FedZOConfig:
    """The attack's hyperparameters (Sec. V-A, scale-reduced): full
    participation, H = 20 local iterates, b2 = 20 directions."""
    kw = dict(n_devices=task.store.n_clients,
              n_participating=task.store.n_clients,
              local_iters=20, lr=1e-3, mu=1e-3, b1=25, b2=20,
              weight_by_size=True)
    kw.update(overrides)
    return FedZOConfig(**kw)


def run(task: AttackTask, cfg: FedZOConfig, rounds: int, *, eval_every=5,
        **kw) -> sim.ExperimentResult:
    """One attack experiment through the engine, with the attack-success
    eval every ``eval_every`` rounds."""
    return sim.run_experiment(attack_loss(task),
                              pert_init(task.store.device), task.store, cfg,
                              rounds, eval_fn=attack_eval(task),
                              eval_every=eval_every, **kw)


def run_sweep(task: AttackTask, base_cfg: FedZOConfig, *, snr_dbs, seeds,
              rounds: int, eval_every=5, out_csv=None):
    """The AirComp SNR curve family: an SNR × seed grid over the attack
    (``sim.run_sweep``), curves written as long-format CSV."""
    cfg = dataclasses.replace(base_cfg, aircomp=True)
    scen = sim.scenario_grid(snr_db=tuple(float(s) for s in snr_dbs),
                             seed=tuple(int(s) for s in seeds))
    return sim.run_sweep(attack_loss(task), pert_init(task.store.device),
                         task.store, cfg, scen, rounds,
                         eval_fn=attack_eval(task), eval_every=eval_every,
                         out_csv=out_csv)
