"""Device-resident federated client store with jax-compatible draws.

Counterpart of ``repro/sim/store.py:30-150``. All N client datasets are
stacked once into padded tensors on the run's device, with the true
per-client row counts beside them. The per-round draws use the
jax-compatible key chain (``utils/prng.py``), so they pick the reference's
clients and rows from the same keys:

- ``sample_participants``: the M-of-N draw, a permutation prefix;
- ``sample_batches``: H minibatches of b1 rows per sampled client, uniform
  with replacement over that client's own rows (``randint`` bounded by its
  true size, so pad rows are never drawn), gathered on the device. It
  delegates to ``sample_cohort_batches``, which draws the same rows from an
  already gathered cohort: the tiered store's staged cohort
  (``sim/tiered.py``) samples exactly the resident store's rows.

The draws run on the CPU (keys and sizes are host-side control state); only
the index tensors cross to the device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
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


class CohortBatch(NamedTuple):
    """One round's staged cohort on the tiered path (``sim/tiered.py``):
    the M sampled clients' rows padded to the cohort's bucket capacity
    (leaves ``[M, cap, ...]`` on the run's device) and their true sizes
    (``[M]`` int32, CPU). In a segment every field carries a leading ``[S]``
    rounds axis. ``avail`` is the host-replayed availability slice of a
    fault run, ``chan_h``/``chan_mask`` the host-replayed realization of a
    ``cfg.channel_model`` run (``[M]`` CPU tensors); each None when the
    process is off."""
    data: Any              # dict, leaves [M, cap, ...]
    sizes: torch.Tensor    # [M] int32 true row counts (CPU)
    avail: Any = None      # [M] bool fault-chain slice, or None
    chan_h: Any = None     # [M] complex64 cohort fading, or None
    chan_mask: Any = None  # [M] bool transmit mask, or None


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


def build_store(clients, *, device="cuda") -> ClientStore:
    """Stack a list of per-client dataset dicts into one ClientStore on
    ``device`` (the card unless the caller asks for the CPU; raises without
    a card), zero-padding every client to the largest row count."""
    device = resolve_device(device)
    sizes = client_sizes(clients)
    cap = max(sizes)
    data = {k: torch.from_numpy(stack_padded([c[k] for c in clients],
                                             cap)).to(device)
            for k in clients[0]}
    return ClientStore(data=data, sizes=torch.tensor(sizes,
                                                      dtype=torch.int32))


def sample_participants(key, n_clients: int, m: int, impl=None
                        ) -> torch.Tensor:
    """Uniform M-of-N draw without replacement: ``[..., m]`` int64 client
    ids (a batch of keys ``[S, words]`` draws ``[S, m]``, as under the
    reference sweep's vmap)."""
    return prng.permutation(key, n_clients, impl=impl)[..., :m]


def sample_cohort_batches(data, sizes, key, h: int, b1: int, impl=None):
    """``[M, H, b1, ...]`` minibatches from an already gathered cohort:
    ``data`` leaves ``[M, cap, ...]`` on the device, ``sizes`` ``[M]`` true
    row counts. Client i's rows are ``randint(split(key, M)[i], (h, b1), 0,
    sizes[i])``: the draw depends only on the key and the true size, never
    on the padded capacity, so a bucket-padded staged cohort samples the
    rows the resident store would. The per-client draws are the
    reference's under its client ``vmap`` (``impl``: the key's; a batched
    rbg draw runs from the first client's key)."""
    m = sizes.shape[0]
    keys = prng.split(key, m, impl)
    rows = prng.randint(keys, (h, b1), 0,
                        sizes.to(torch.int64).reshape(m, 1, 1), impl=impl)
    dev = next(iter(data.values())).device
    ci = torch.arange(m, device=dev).reshape(m, 1, 1)
    ri = rows.to(device=dev, dtype=torch.int64)
    return {k: v[ci, ri] for k, v in data.items()}


def sample_batches(store: ClientStore, idx, key, h: int, b1: int,
                   impl=None):
    """``[M, H, b1, ...]`` minibatches of the sampled clients ``idx``: the
    cohort gathered from the store, then ``sample_cohort_batches``.

    A scenario batch (``idx`` ``[S, M]``, ``key`` ``[S, words]``, the
    reference sweep's vmap over scenarios) gives ``[S, M, H, b1, ...]``:
    the keys split to ``[S, M]`` and the rows drawn as one batch."""
    if idx.dim() == 2:
        s, m = idx.shape
        keys = prng.split(key, m, impl)                   # [S, M, words]
        sizes = store.sizes[idx].to(torch.int64).reshape(s, m, 1, 1)
        rows = prng.randint(keys, (h, b1), 0, sizes, impl=impl)
        ci = idx.to(store.device).reshape(s, m, 1, 1)
        ri = rows.to(device=store.device, dtype=torch.int64)
        return {k: v[ci, ri] for k, v in store.data.items()}
    ci = idx.to(store.device)
    cohort = {k: v[ci] for k, v in store.data.items()}
    return sample_cohort_batches(cohort, store.sizes[idx], key, h, b1, impl)
