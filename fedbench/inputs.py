"""Everything a run feeds the program, made from ``--seed``.

- **Weights**: one float32 draw of the whole parameter vector on the
  device from a ``torch.Generator`` (one call), each leaf then scaled or
  filled in place by its family's ``leaf_init``. The leaves are views of
  that vector, in the layout of the family's ``param_shapes``.
- **Tokens**: each client has a Markov chain of its own over the full
  vocabulary (every token has ``MARKOV_ORDER`` likely successors, taken
  with probability ``MARKOV_STAY``, else a uniform jump; the structure of
  ``data/synthetic.lm_token_stream``), so the clients' data differ as in
  a non-IID split. Rows for ``ROUNDS_POOL`` rounds are drawn on the device
  at set-up; round r of a run takes pool entry r modulo the pool.
- **Keys**: each round's M client keys and its channel key, uint32 word
  pairs from a numpy generator.
- **The check's sample**: ``SAMPLE`` flat parameter indices.

The same seed gives the same inputs, on any device of one kind.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE = 1 << 16
MARKOV_ORDER = 3
MARKOV_STAY = 0.9
# rounds of tokens and keys drawn at set-up: round 0 and the 20 rounds a
# window of the longest run_seconds (51 s) holds at the fastest cell's
# 2.6 s a round; a run with more rounds takes the pool again from its start
ROUNDS_POOL = 24
_TAGS = {"weights": 1, "tokens": 2, "keys": 3, "sample": 4}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one kind of input, from the run's seed."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), _TAGS[tag]])
    return int(ss.generate_state(2, np.uint32).astype(np.uint64)
               @ np.array([1, 2 ** 32], np.uint64)) >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


class Weights:
    """The parameter vector ``flat`` [d] and its leaves as views (``tree``,
    nested dicts in the family's layout)."""

    def __init__(self, family, cfg, seed, device):
        self.shapes = family.param_shapes(cfg)
        self.d = sum(math.prod(s) for _, s in self.shapes)
        g = generator(seed, "weights", device)
        self.flat = torch.randn(self.d, generator=g, device=device,
                                dtype=torch.float32)
        self.offsets = []
        off = 0
        for path, shape in self.shapes:
            n = math.prod(shape)
            kind, val = family.leaf_init(path, shape)
            view = self.flat[off:off + n]
            if kind == "fill":
                view.fill_(val)
            else:
                view.mul_(val)
            self.offsets.append(off)
            off += n
        self.tree = unflatten(self.flat, self.shapes)


def unflatten(flat, shapes):
    """Nested dict of views of ``flat`` [..., >= d] in ``shapes``' order
    (leading dimensions kept)."""
    lead = tuple(flat.shape[:-1])
    out, off = {}, 0
    for path, shape in shapes:
        n = math.prod(shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[..., off:off + n].reshape(lead + tuple(shape))
        off += n
    return out


def leaves(tree, prefix=()):
    """(path, tensor) pairs, keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaves(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def token_pool(traffic, vocab, seed, device):
    """(tokens, labels), each int32 ``[R, M, H, rows, seq]``: R rounds of
    every client's H iterate batches, client m's rows from its own chain."""
    R, M, H = ROUNDS_POOL, traffic["clients"], traffic["local_iters"]
    rows, S = traffic["rows"], traffic["seq"]
    order, stay = MARKOV_ORDER, MARKOV_STAY
    g = generator(seed, "tokens", device)
    succ = torch.randint(0, vocab, (M, vocab, order), generator=g,
                         device=device)
    per = R * H * rows                       # rows of one client
    client = torch.arange(M, device=device).repeat_interleave(per)
    n = M * per
    state = torch.randint(0, vocab, (n,), generator=g, device=device)
    moves = torch.rand((S + 1, n), generator=g, device=device) < stay
    picks = torch.randint(0, order, (S + 1, n), generator=g, device=device)
    jumps = torch.randint(0, vocab, (S + 1, n), generator=g, device=device)
    seqs = torch.empty((S + 1, n), dtype=torch.int32, device=device)
    for t in range(S + 1):
        state = torch.where(moves[t], succ[client, state, picks[t]],
                            jumps[t])
        seqs[t] = state
    seqs = seqs.T.reshape(M, R, H, rows, S + 1).transpose(0, 1)
    return (seqs[..., :-1].contiguous(), seqs[..., 1:].contiguous())


def key_pool(traffic, seed):
    """(client keys int64 ``[R, M, 2]``, channel keys int64 ``[R, 2]``) on
    the CPU: uint32 words."""
    rng = np.random.default_rng(sub_seed(seed, "keys"))
    R, M = ROUNDS_POOL, traffic["clients"]
    words = rng.integers(0, 2 ** 32, size=(R, M + 1, 2), dtype=np.uint64)
    w = torch.from_numpy(words.astype(np.int64))
    return w[:, :M].contiguous(), w[:, M].contiguous()


def sample_index(d, seed):
    """``SAMPLE`` distinct flat indices in [0, d), sorted (int64, CPU)."""
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    k = min(SAMPLE, d)
    return torch.from_numpy(np.sort(rng.choice(d, size=k, replace=False)))
