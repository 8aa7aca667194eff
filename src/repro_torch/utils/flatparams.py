"""FlatParams: a (nested) dict of parameter tensors as ONE padded 1-D buffer.

Counterpart of ``repro/utils/flatparams.py``. The flat index of a scalar is
its offset in leaf order, and that index is the counter the in-kernel
directions are keyed on. So the leaf order must be the reference's: jax
flattens a dict in sorted-key order at every level of nesting (softmax:
``b`` then ``w``; a transformer: ``blocks/attn/bk`` ... ``blocks/norm2/
scale``, ``embed/tok``, ``final_norm/scale``), and a ``state_dict`` or
insertion order would silently walk other directions.

``n_pad`` is the reference's too: the valid length rounded up to a multiple
of ``block_rows·128`` (65,536 at the default 512 rows). The pad region is
walked by the kernels and is part of the client deltas; ``unflatten`` drops
it.

The buffer is float32 whatever the leaves' dtypes; ``unflatten`` casts each
leaf back to its own dtype (a no-op view for float32 leaves). A 0-d leaf
(the vlm's float32 gates among bfloat16 ones) is one element of the
buffer at its place in the reference's leaf order, and comes back 0-d, or
``[M]`` under a leading client axis. Buffers may
carry leading batch dimensions (``[M, n_pad]`` for the M clients of a
round): ``unflatten`` slices the last dimension and keeps the leading ones
on every leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels.zo_axpy import BLOCK_ROWS, LANES


@dataclass(frozen=True)
class FlatSpec:
    """Static description of a flattened parameter dict."""
    paths: Tuple[Tuple[str, ...], ...]   # key paths, in leaf order
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    d: int                      # total valid scalar count
    n_pad: int                  # padded buffer length (block multiple)
    block: int                  # pad granularity in elements

    @property
    def names(self) -> Tuple[str, ...]:
        """"/"-joined key paths, in leaf order."""
        return tuple("/".join(p) for p in self.paths)


def _leaves(params, prefix=()):
    """(key path, tensor) pairs in jax's order: keys sorted at every level;
    a None subtree (an empty stacked group) has no leaves, as in jax."""
    if not isinstance(params, dict):
        raise TypeError("FlatParams takes a dict of tensors (nested dicts "
                        f"allowed), got {type(params).__name__} at "
                        f"{'/'.join(prefix) or 'the root'}")
    out = []
    for k in sorted(params):
        v = params[k]
        if v is None:
            continue
        out.extend([((*prefix, k), v)] if isinstance(v, torch.Tensor)
                   else _leaves(v, (*prefix, k)))
    return out


def flat_spec(params, *, block: int = 0) -> FlatSpec:
    """The FlatSpec of a parameter dict (leaves in jax's order)."""
    block = block or BLOCK_ROWS * LANES
    pairs = _leaves(params)
    paths = tuple(p for p, _ in pairs)
    leaves = [l for _, l in pairs]
    shapes = tuple(tuple(l.shape) for l in leaves)
    sizes, offsets, off = [], [], 0
    for leaf in leaves:
        offsets.append(off)
        sizes.append(leaf.numel())
        off += leaf.numel()
    return FlatSpec(paths=paths, shapes=shapes,
                    dtypes=tuple(l.dtype for l in leaves),
                    offsets=tuple(offsets), sizes=tuple(sizes), d=off,
                    n_pad=off + ((-off) % block), block=block)


def flatten(params, spec: FlatSpec) -> torch.Tensor:
    """Dict -> float32 ``[n_pad]`` buffer (pad region zero)."""
    parts = [l.reshape(-1).to(torch.float32) for _, l in _leaves(params)]
    pad = spec.n_pad - spec.d
    if pad:
        parts.append(torch.zeros(pad, dtype=torch.float32,
                                 device=parts[0].device))
    return torch.cat(parts)


def flatten_stacked(params, spec: FlatSpec) -> torch.Tensor:
    """Stacked dict (leaves ``[M, *shape]``) -> float32 ``[M, n_pad]``
    buffer, row m the ``flatten`` of the tree's row m (the reference's
    ``jax.vmap(flatten)``)."""
    parts = [l.reshape(l.shape[0], -1).to(torch.float32)
             for _, l in _leaves(params)]
    pad = spec.n_pad - spec.d
    if pad:
        parts.append(parts[0].new_zeros((parts[0].shape[0], pad)))
    return torch.cat(parts, dim=1)


def unflatten(buf: torch.Tensor, spec: FlatSpec) -> dict:
    """``[..., >= d]`` buffer -> (nested) dict of ``[..., *shape]`` views,
    cast back to the leaf dtypes."""
    lead = tuple(buf.shape[:-1])
    out: dict = {}
    for path, shp, dt, off, n in zip(spec.paths, spec.shapes, spec.dtypes,
                                     spec.offsets, spec.sizes):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = buf[..., off:off + n].reshape(lead + shp).to(dt)
    return out


def flat_geometry(params, block_rows: int = 0):
    """(spec, block_rows) for a block-rows setting; 0 means the default.

    The one mapping from the config's ``flat_block_rows`` to the buffer
    geometry; the second value is what the kernels' plain versions take as
    their reduction block (None for the default)."""
    spec = flat_spec(params, block=block_rows * LANES if block_rows else 0)
    return spec, (block_rows or None)
