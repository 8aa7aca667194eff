"""Parameter checkpoints in the reference's on-disk format.

Counterpart of ``repro/checkpoint/checkpoint.py:35-118`` (``config_hash``,
``save``, ``restore``). A checkpoint is a directory holding

- ``params.npz``: one array per leaf, keyed by the leaf's path as
  ``jax.tree_util.keystr`` writes it (``"['blocks']['attn']['wq']"``);
- ``meta.json``: the step, the write time, ``torch_version``, and for a
  dataclass ``meta`` its fields and ``config_hash``.

So either package restores what the other saved. A bfloat16 leaf is stored
as the 2-byte void records (``|V2``) that ``np.savez`` writes for jax's
bfloat16 arrays, and read back as bfloat16. A ``jax_version`` key in a
sidecar the reference wrote is read and ignored. The durable run-state
snapshots of the reference's engine are not ported.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import os
import warnings

import numpy as np
import torch

from repro_torch.utils.flatparams import _leaves
from repro_torch.utils.tree import tree_unflatten


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"cannot read a {arr.dtype} record as a tensor")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=like.device, dtype=like.dtype)


def config_hash(cfg) -> str:
    """Stable short hash of a config (dataclass or dict), as the
    reference computes it."""
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    blob = json.dumps(cfg, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _sidecar(meta=None, *, step=None) -> dict:
    md = {"torch_version": torch.__version__,
          "created_at": datetime.datetime.now(
              datetime.timezone.utc).isoformat()}
    if step is not None:
        md["step"] = int(step)
    if meta is not None:
        if dataclasses.is_dataclass(meta):
            md["config_hash"] = config_hash(meta)
            meta = dataclasses.asdict(meta)
        md["meta"] = meta
    return md


def save(path, params, *, step=0, meta=None):
    """Write ``params`` (a nested dict of tensors) and its sidecar."""
    os.makedirs(path, exist_ok=True)
    arrays = {_keystr(p): _to_numpy(t) for p, t in _leaves(params)}
    np.savez(os.path.join(path, "params.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(_sidecar(meta, step=step), f, indent=1)


def restore(path, params_like):
    """Restore into the structure of ``params_like`` (each leaf takes the
    dtype and device of its counterpart there). Returns ``(params, step)``.
    A missing leaf or a shape mismatch raises, naming the leaf."""
    with open(os.path.join(path, "meta.json")) as f:
        md = json.load(f)
    want = md.get("torch_version")
    if want is not None and want != torch.__version__:
        warnings.warn(f"checkpoint {path} was written under torch {want} but "
                      f"this is torch {torch.__version__}")
    npz_path = os.path.join(path, "params.npz")
    pairs = _leaves(params_like)
    leaves = []
    with np.load(npz_path) as loaded:
        for p, ref in pairs:
            name = _keystr(p)
            if name not in loaded.files:
                raise ValueError(
                    f"checkpoint {npz_path} has no entry for leaf {name!r} "
                    f"(file holds {sorted(loaded.files)}); was it written "
                    f"from a different model?")
            arr = loaded[name]
            if arr.shape != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint {npz_path} leaf {name!r} has shape "
                    f"{arr.shape} but the restore target expects "
                    f"{tuple(ref.shape)}")
            leaves.append(_from_numpy(arr, ref))
    return tree_unflatten([p for p, _ in pairs], leaves), md["step"]
