"""Checkpoints in the reference's on-disk format.

Counterpart of ``repro/checkpoint/checkpoint.py``. Two layers share one
format:

- ``save``/``restore``: parameter snapshots;
- ``save_run_state``/``latest_run_state``/``restore_run_state``: durable
  snapshots of the engine's whole carry (params, momentum, key words,
  fault and channel state, strategy state, metrics ring, eval buffer) at a
  round index, ``<dir>/round_%08d/{state.npz, meta.json}``, written
  atomically: into a temporary directory renamed into place, then the
  ``LATEST`` pointer swapped (itself through a temporary file and
  ``os.replace``). A kill at any instant leaves the previous snapshot or
  the new one, never a torn write; stale ``*.tmp*`` debris is ignored and
  swept on the next save.

A parameter checkpoint is a directory holding

- ``params.npz``: one array per leaf, keyed by the leaf's path as
  ``jax.tree_util.keystr`` writes it (``"['blocks']['attn']['wq']"``);
- ``meta.json``: the step, the write time, ``torch_version``, and for a
  dataclass ``meta`` its fields and ``config_hash``.

So either package restores what the other saved. A bfloat16 leaf is stored
as the 2-byte void records (``|V2``) that ``np.savez`` writes for jax's
bfloat16 arrays, and read back as bfloat16. A run-state snapshot names its
arrays as the reference's does (``['params']['w']``, ``['key']`` as two
uint32 words, ``['cstate'][0]``, ``['ring']['mean_local_loss']``), so a
snapshot the reference wrote resumes in the port. Sidecars record
``torch_version``; restoring one written under another torch version warns
(a ``jax_version`` key in a sidecar the reference wrote is read and
ignored).
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import os
import shutil
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
    if arr.dtype == np.uint32:      # key words: the port holds them in int64
        arr = arr.astype(np.int64)
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


def _check_torch_version(md: dict, path):
    want = md.get("torch_version")
    if want is not None and want != torch.__version__:
        warnings.warn(f"checkpoint {path} was written under torch {want} but "
                      f"this is torch {torch.__version__}")


def _load_leaf(loaded, npz_path, name, ref):
    """The array ``name`` of an open npz as a tensor like ``ref``; a
    missing entry or a shape mismatch raises, naming the leaf."""
    if name not in loaded.files:
        raise ValueError(
            f"checkpoint {npz_path} has no entry for leaf {name!r} (file "
            f"holds {sorted(loaded.files)}); was it written from a "
            f"different model or carry?")
    arr = loaded[name]
    if arr.shape != tuple(ref.shape):
        raise ValueError(
            f"checkpoint {npz_path} leaf {name!r} has shape {arr.shape} but "
            f"the restore target expects {tuple(ref.shape)}")
    return _from_numpy(arr, ref)


def restore(path, params_like):
    """Restore into the structure of ``params_like`` (each leaf takes the
    dtype and device of its counterpart there). Returns ``(params, step)``.
    A missing leaf or a shape mismatch raises, naming the leaf."""
    with open(os.path.join(path, "meta.json")) as f:
        md = json.load(f)
    _check_torch_version(md, path)
    npz_path = os.path.join(path, "params.npz")
    pairs = _leaves(params_like)
    with np.load(npz_path) as loaded:
        leaves = [_load_leaf(loaded, npz_path, _keystr(p), ref)
                  for p, ref in pairs]
    return tree_unflatten([p for p, _ in pairs], leaves), md["step"]


# -- durable run-state snapshots (the engine's whole carry) ------------------

_LATEST = "LATEST"


def _state_items(tree, path=()):
    """(path, leaf) pairs of a carry tree: dicts (keys sorted), tuples and
    lists (by index) and tensor or array leaves; None contributes none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [it for k in sorted(tree)
                for it in _state_items(tree[k], (*path, k))]
    if isinstance(tree, (tuple, list)):
        return [it for i, v in enumerate(tree)
                for it in _state_items(v, (*path, i))]
    return [(path, tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves replaced in ``_state_items``
    order from the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _snapshot_name(round_idx: int) -> str:
    return f"round_{round_idx:08d}"


def save_run_state(ckpt_dir, state, *, round_idx: int, meta=None,
                   keep: int = 3) -> str:
    """Atomically snapshot a carry tree (leaves tensors or numpy arrays)
    at ``round_idx``: stage into ``<name>.tmp.<pid>``, rename the
    directory into place, swap the ``LATEST`` pointer through a temporary
    file and ``os.replace``, then sweep snapshots beyond the newest
    ``keep`` and stale temporary debris. Returns the snapshot path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = _snapshot_name(round_idx)
    final = os.path.join(ckpt_dir, name)
    tmp = os.path.join(ckpt_dir, f"{name}.tmp.{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {_keystr(p): (_to_numpy(v) if isinstance(v, torch.Tensor)
                           else np.asarray(v))
              for p, v in _state_items(state)}
    np.savez(os.path.join(tmp, "state.npz"), **arrays)
    md = _sidecar(dict(meta or {}, round=int(round_idx)))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(md, f, indent=1)
    if os.path.exists(final):  # a re-save of the same round: replace it
        shutil.rmtree(final)
    os.rename(tmp, final)
    ptr_tmp = os.path.join(ckpt_dir, f"{_LATEST}.tmp.{os.getpid()}")
    with open(ptr_tmp, "w") as f:
        f.write(name)
    os.replace(ptr_tmp, os.path.join(ckpt_dir, _LATEST))
    _sweep(ckpt_dir, keep=keep)
    return final


def _snapshots(ckpt_dir):
    try:
        entries = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    return sorted(e for e in entries
                  if e.startswith("round_") and ".tmp" not in e
                  and os.path.isdir(os.path.join(ckpt_dir, e)))


def _sweep(ckpt_dir, *, keep: int):
    latest = None
    ptr = os.path.join(ckpt_dir, _LATEST)
    if os.path.exists(ptr):
        with open(ptr) as f:
            latest = f.read().strip()
    snaps = _snapshots(ckpt_dir)
    drop = set(snaps[:-keep]) if keep > 0 else set()
    drop.discard(latest)
    for e in os.listdir(ckpt_dir):
        if e in drop or (".tmp" in e and e != latest):
            target = os.path.join(ckpt_dir, e)
            if os.path.isdir(target):
                shutil.rmtree(target, ignore_errors=True)
            elif e != _LATEST:
                try:
                    os.remove(target)
                except OSError:
                    pass


def latest_run_state(ckpt_dir):
    """Path of the newest consistent snapshot in ``ckpt_dir`` (the
    ``LATEST`` pointer, else the highest complete round directory), or None
    when there is none: a fresh start."""
    ptr = os.path.join(ckpt_dir, _LATEST)
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        cand = os.path.join(ckpt_dir, name)
        if os.path.exists(os.path.join(cand, "meta.json")):
            return cand
    for name in reversed(_snapshots(ckpt_dir)):
        cand = os.path.join(ckpt_dir, name)
        if os.path.exists(os.path.join(cand, "meta.json")):
            return cand
    return None


def read_sidecar(snapshot_path) -> dict:
    """The JSON sidecar of a snapshot (either layout) without loading any
    array; a ``config_hash`` inside a dict meta (the run-state layout) is
    hoisted to the top level."""
    with open(os.path.join(snapshot_path, "meta.json")) as f:
        md = json.load(f)
    meta = md.get("meta")
    if isinstance(meta, dict) and "config_hash" not in md \
            and "config_hash" in meta:
        md["config_hash"] = meta["config_hash"]
    return md


def snapshot_entries(snapshot_path, prefix: str) -> dict:
    """{name: array} of a run-state snapshot's arrays under one top-level
    key (``prefix``, e.g. ``"ring"``), by the name below it: the engine
    reads the metric and eval buffers' names from the snapshot."""
    head = _keystr((prefix,))
    out = {}
    with np.load(os.path.join(snapshot_path, "state.npz")) as loaded:
        for name in loaded.files:
            if name.startswith(head):
                out[name[len(head) + 2:-2]] = loaded[name]
    return out


def restore_run_state(snapshot_path, state_like):
    """Restore a run-state snapshot into the structure of ``state_like``
    (each leaf takes its counterpart's dtype and device). Returns
    ``(state, meta dict)``: the sidecar's meta (round, lr, events,
    config_hash, ...)."""
    with open(os.path.join(snapshot_path, "meta.json")) as f:
        md = json.load(f)
    _check_torch_version(md, snapshot_path)
    npz_path = os.path.join(snapshot_path, "state.npz")
    with np.load(npz_path) as loaded:
        leaves = [_load_leaf(loaded, npz_path, _keystr(p), ref)
                  for p, ref in _state_items(state_like)]
    return _rebuild(state_like, iter(leaves)), md.get("meta", {})
