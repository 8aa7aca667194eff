"""Synthetic federated datasets with the paper's non-iid protocols.

A copy of ``repro/data/synthetic.py`` (numpy only), kept in the port so it
imports nothing of the reference: the same seed gives the same data in both
packages, which is what lets a port run be held against a reference run.

Fashion-MNIST is replaced by a deterministic synthetic generator that
preserves the *shape of the problem*: class-conditional Gaussian images
(classes are linearly separable enough for softmax regression to train,
like F-MNIST), optionally squashed to [0, 1] pixels for the image track.
The classification generators and partitioners and the LM corpus
(``lm_token_stream``, ``lm_batches``: the cross-silo train step's data) are
copied; the reference's host minibatch sampler is not on the port's path.

Non-iid split (Sec. V-B, following McMahan et al.): sort by label, cut into
2·N shards, deal 2 shards per client → each client sees ≤ 4 distinct labels
(2 per shard boundary effects aside).
"""
from __future__ import annotations

import numpy as np


def make_classification(n, n_features=784, n_classes=10, seed=0, scale=1.0,
                        image_shape=None):
    """Class-conditional Gaussians: x = mu_y + noise, labels balanced."""
    rng = np.random.default_rng(seed)
    mus = rng.normal(0, 1, (n_classes, n_features)).astype(np.float32)
    y = np.arange(n) % n_classes
    rng.shuffle(y)
    x = mus[y] * scale + rng.normal(0, 1, (n, n_features)).astype(np.float32)
    if image_shape is not None:
        # squash to [0,1] pixel range for image-space tasks
        x = 1.0 / (1.0 + np.exp(-x))
        x = x.reshape((n,) + tuple(image_shape))
    return x.astype(np.float32), y.astype(np.int32)


def noniid_shards(x, y, n_clients, shards_per_client=2, seed=0):
    """Label-sorted shard split (the paper's Fashion-MNIST protocol).

    When ``len(y)`` doesn't divide into ``n_clients · shards_per_client``
    shards the remainder rows are dealt across the leading shards (one
    extra row each) instead of being dropped — the union of the client
    datasets is always the full dataset.
    """
    rng = np.random.default_rng(seed)
    order = np.argsort(y, kind="stable")
    x, y = x[order], y[order]
    n_shards = n_clients * shards_per_client
    if len(y) < n_shards:
        raise ValueError(f"{len(y)} rows cannot fill {n_shards} shards "
                         f"({n_clients} clients × {shards_per_client})")
    shard_sizes = np.full(n_shards, len(y) // n_shards, np.int64)
    shard_sizes[:len(y) % n_shards] += 1
    bounds = np.concatenate([[0], np.cumsum(shard_sizes)])
    shard_ids = rng.permutation(n_shards)
    clients = []
    for c in range(n_clients):
        take = shard_ids[c * shards_per_client:(c + 1) * shards_per_client]
        idx = np.concatenate([np.arange(bounds[s], bounds[s + 1])
                              for s in take])
        clients.append({"x": x[idx], "y": y[idx]})
    assert sum(len(c["y"]) for c in clients) == len(y)
    return clients


def _renormalize_counts(counts, total):
    """Adjust integer client sizes so each is ≥ 1 and they sum to ``total``
    (deals surpluses/deficits against the largest clients first)."""
    counts = np.maximum(np.asarray(counts, np.int64), 1)
    diff = total - int(counts.sum())
    order = np.argsort(-counts, kind="stable")
    j = 0
    while diff != 0:
        c = order[j % len(counts)]
        if diff > 0:
            counts[c] += 1
            diff -= 1
        elif counts[c] > 1:
            counts[c] -= 1
            diff += 1
        j += 1
    return counts


def random_partition(x, y, n_clients, seed=0, uneven=True):
    """IID partition; ``uneven`` draws random (Dirichlet) client sizes like
    the attack experiment ('each device is assigned a random number of
    samples'). Every client gets ≥ 1 row and the counts sum exactly to
    ``len(y)`` (the naive clamp-then-subtract assignment could hand the
    last client a zero or negative row count)."""
    if len(y) < n_clients:
        raise ValueError(f"{len(y)} rows cannot give each of {n_clients} "
                         f"clients at least one row")
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    if uneven:
        w = rng.dirichlet(np.full(n_clients, 5.0))
        counts = _renormalize_counts((w * len(y)).astype(int), len(y))
    else:
        counts = np.full(n_clients, len(y) // n_clients)
        counts[:len(y) % n_clients] += 1    # deal the remainder, drop nothing
    out, off = [], 0
    for c in counts:
        take = idx[off:off + c]
        out.append({"x": x[take], "y": y[take]})
        off += c
    return out


def dirichlet_partition(x, y, n_clients, alpha=0.5, seed=0):
    """Dirichlet(α) label-skew partition (Hsu et al. 2019): per class c a
    Dirichlet(α·1) draw over clients proportions the class's rows, so small
    α concentrates each class on few clients and α→∞ recovers IID. All
    rows are assigned; every client ends with ≥ 1 row (deficits are filled
    from the largest clients)."""
    if len(y) < n_clients:
        raise ValueError(f"{len(y)} rows cannot give each of {n_clients} "
                         f"clients at least one row")
    rng = np.random.default_rng(seed)
    assign = [[] for _ in range(n_clients)]
    for cls in np.unique(y):
        rows = np.flatnonzero(y == cls)
        rng.shuffle(rows)
        p = rng.dirichlet(np.full(n_clients, alpha))
        # cumulative-proportion splits keep every row exactly once
        cuts = (np.cumsum(p)[:-1] * len(rows)).astype(int)
        for c, part in enumerate(np.split(rows, cuts)):
            assign[c].extend(part.tolist())
    # re-home rows so no client is empty (build_store needs ≥ 1 row each)
    for c in range(n_clients):
        while not assign[c]:
            donor = max(range(n_clients), key=lambda i: len(assign[i]))
            assign[c].append(assign[donor].pop())
    assert sum(len(a) for a in assign) == len(y)
    return [{"x": x[np.asarray(a, np.int64)], "y": y[np.asarray(a, np.int64)]}
            for a in assign]


def federated_classification(n_train, n_test, n_clients, *, n_features=784,
                             n_classes=10, seed=0, scale=1.0,
                             image_shape=None, partition="dirichlet",
                             alpha=0.5, shards_per_client=2):
    """The Sec. V-B data protocol in one call: a synthetic classification
    problem split into federated client shards plus a pooled held-out test
    batch. ``partition``: "dirichlet" (Hsu-style label skew, concentration
    ``alpha``), "shards" (the paper's label-sorted deal), "iid", or
    "uneven" (IID rows, Dirichlet client sizes). Returns
    (clients, test_batch)."""
    x, y = make_classification(n_train + n_test, n_features, n_classes,
                               seed=seed, scale=scale,
                               image_shape=image_shape)
    xtr, ytr = x[:n_train], y[:n_train]
    if partition == "dirichlet":
        clients = dirichlet_partition(xtr, ytr, n_clients, alpha=alpha,
                                      seed=seed)
    elif partition == "shards":
        clients = noniid_shards(xtr, ytr, n_clients,
                                shards_per_client=shards_per_client,
                                seed=seed)
    elif partition in ("iid", "uneven"):
        clients = random_partition(xtr, ytr, n_clients, seed=seed,
                                   uneven=(partition == "uneven"))
    else:
        raise ValueError(f"unknown partition {partition!r}; use dirichlet | "
                         f"shards | iid | uneven")
    return clients, {"x": x[n_train:], "y": y[n_train:]}


def lm_token_stream(n_tokens, vocab, seed=0, order=3):
    """Deterministic synthetic LM corpus: a random Markov chain over the
    vocabulary (gives a learnable non-uniform next-token distribution)."""
    rng = np.random.default_rng(seed)
    state = rng.integers(0, vocab)
    # sparse transition structure: each token has `order` likely successors
    succ = rng.integers(0, vocab, size=(vocab, order))
    toks = np.empty(n_tokens, np.int32)
    jumps = rng.random(n_tokens)
    choices = rng.integers(0, order, n_tokens)
    for i in range(n_tokens):
        state = succ[state, choices[i]] if jumps[i] < 0.9 \
            else rng.integers(0, vocab)
        toks[i] = state
    return toks


def lm_batches(tokens, batch, seq, rng: np.random.Generator):
    starts = rng.integers(0, len(tokens) - seq - 1, size=batch)
    x = np.stack([tokens[s:s + seq] for s in starts])
    y = np.stack([tokens[s + 1:s + seq + 1] for s in starts])
    return {"tokens": x, "labels": y}
