"""FedZO on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The JAX package ``repro`` is the reference. This package mirrors its module
paths and runs the flat-buffer FedZO round (paper Algorithm 1 with the
AirComp aggregation of Sec. IV) on the card through four hand-written CUDA
kernels (``repro_torch.kernels``). It never imports ``jax`` or ``repro``.

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
