"""FedZO on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The JAX package ``repro`` is the reference. This package mirrors its module
paths and runs FedZO (paper Algorithm 1 with the AirComp aggregation of
Sec. IV) on the card on both of the reference's routes, the pytree route
(its default) and the flat-buffer route, for the paper's models and the
dense LM family, through eight hand-written CUDA kernels
(``repro_torch.kernels``), with the training CLI ``repro_torch.launch.train``.
The algorithm layer sits on top: the strategy registry (FedZO, FedAvg,
ZO-FedProx, ZO-FedDyn, ZO-SCAFFOLD; ``core/strategy.py``), first-order
FedAvg with SGD or Adam (``core/fedavg.py``, ``optim/sgd.py``), the
seed-compressed uplink (``core/seedcomm.py``), the ZO baselines and the
``FedServer`` API (``fed/server.py``). Around the rounds sit fault
injection (``sim/faults.py``), the wireless scenario's correlated fading and
energy gating (``sim/channel.py``), durable checkpointed runs with
divergence rollback (``sim/engine.py``, ``checkpoint/``), the metric taps,
trace spans and run manifests (``obs/``), scenario sweeps
(``sim/sweep.py``), the tiered client store that keeps the population in
host memory and streams the sampled cohorts to the card
(``sim/tiered.py``), the paper's Sec. V-A federated black-box attack
(``workloads/attack.py``), federated hyperparameter tuning
(``workloads/hypertune.py``) and the kernel-timing harness
(``obs/kernel_timing.py``). It never imports ``jax`` or ``repro``.

Randomness follows jax's raw Threefry-2x32 key chain
(``repro_torch.utils.prng``), so a run from a seed draws the same clients,
minibatch rows, channel masks and perturbation directions as the reference.

Entry points take ``device="cuda"`` by default and raise when no card is
present; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels (the tests do).
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` without a card raises:
    the port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch path")
    return dev
