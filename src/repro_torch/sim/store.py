"""Device-resident federated client store with jax-compatible draws.

Counterpart of ``repro/sim/store.py:30-150``. All N client datasets are
stacked once into padded tensors on the run's device, with the true
per-client row counts beside them. The per-round draws use the
jax-compatible key chain (``utils/prng.py``), so they pick the reference's
clients and rows from the same keys:

- ``sample_participants``: the M-of-N draw, a permutation prefix;
- ``sample_batches``: H minibatches of b1 rows per sampled client, uniform
  with replacement over that client's own rows (``randint`` bounded by its
  true size, so pad rows are never drawn), gathered on the device.

The draws run on the CPU (keys and sizes are host-side control state); only
the index tensors cross to the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils import prng


class ClientStore(NamedTuple):
    """All N clients' data as stacked padded tensors (leaves ``[N, cap,
    ...]`` on the device) plus the true row counts ``[N]`` (CPU int32)."""
    data: dict
    sizes: torch.Tensor

    @property
    def n_clients(self) -> int:
        return self.sizes.shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.data.values())).device


def client_sizes(clients) -> list:
    """Validated per-client row counts of a list of {"x", "y", ...} dicts
    (row counts agree within a client, dtypes across clients)."""
    if not clients:
        raise ValueError("need at least one client dataset")
    sizes = []
    for i, c in enumerate(clients):
        ns = {int(np.shape(l)[0]) for l in c.values()}
        if len(ns) != 1:
            raise ValueError(
                f"client {i} has leaves with mismatched row counts: {ns}")
        sizes.append(ns.pop())
    for i, c in enumerate(clients[1:], start=1):
        for k, l0 in clients[0].items():
            d0, d = np.asarray(l0).dtype, np.asarray(c[k]).dtype
            if d0 != d:
                raise ValueError(
                    f"client {i} leaf {k!r} has dtype {d} but client 0 has "
                    f"{d0}; make the client datasets dtype-uniform")
    return sizes


def stack_padded(leaves, cap: int) -> np.ndarray:
    """Stack ragged per-client leaves into one ``[len, cap, ...]``
    zero-padded host buffer."""
    head = np.asarray(leaves[0])
    out = np.zeros((len(leaves), cap) + head.shape[1:], head.dtype)
    for i, l in enumerate(leaves):
        out[i, :len(l)] = np.asarray(l)
    return out


def build_store(clients, *, device="cpu") -> ClientStore:
    """Stack a list of per-client dataset dicts into one ClientStore on
    ``device``, zero-padding every client to the largest row count."""
    sizes = client_sizes(clients)
    cap = max(sizes)
    data = {k: torch.from_numpy(stack_padded([c[k] for c in clients],
                                             cap)).to(device)
            for k in clients[0]}
    return ClientStore(data=data, sizes=torch.tensor(sizes,
                                                      dtype=torch.int32))


def sample_participants(key, n_clients: int, m: int) -> torch.Tensor:
    """Uniform M-of-N draw without replacement: ``[m]`` int64 client ids."""
    return prng.permutation(key, n_clients)[:m]


def sample_batches(store: ClientStore, idx, key, h: int, b1: int):
    """``[M, H, b1, ...]`` minibatches of the sampled clients ``idx``.

    Per client i of the cohort, rows ``randint(split(key, M)[i], (h, b1),
    0, sizes[idx[i]])``, the reference's draw, gathered on the device."""
    m = idx.shape[0]
    keys = prng.split(key, m)
    rows = prng.randint(keys, (h, b1), 0,
                        store.sizes[idx].to(torch.int64).reshape(m, 1, 1))
    dev = store.device
    ci = idx.to(dev).reshape(m, 1, 1)
    ri = rows.to(device=dev, dtype=torch.int64)
    return {k: v[ci, ri] for k, v in store.data.items()}
