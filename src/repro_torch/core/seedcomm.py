"""Seed-compressed uplinks: the digital counterpart of AirComp.

Counterpart of ``repro/core/seedcomm.py:66-204``. A FedZO client's local
delta is a linear combination of directions regenerated from its key,

    Δ_i = −η · Σ_{k<H} Σ_{n<b2} (c_{i,k,n} / b2) · v(key_i, k, n),

so the client uploads its key and its H·b2 coefficients instead of d
floats: 8 + 4·H·b2 + 4 bytes (the two uint32 key words, the float32
coefficients, the float32 lr). The server replays the directions to
rebuild the deltas, trading uplink bytes for replay passes over the
parameters.

The port holds a raw key as an int64 tensor carrying two uint32 words; on
the wire each word is 4 bytes, and ``wire_bytes`` counts it so, as the
reference's uint32 ``key_data``. The replay follows ``cfg``:

- flat (``cfg.flat_params``): one ``[1, n_pad]`` float32 accumulator from
  zero, one ``zo_replay`` per (client, iterate) record in the reference's
  order (m ascending, then h), the divide by M at the end. The sphere
  norms of all M·H records come from one ``zo_dirnorms`` launch over the
  ``[M·H, 2]`` keys (rows are independent; the kernel's summation order
  follows ``kernels/zo_axpy.dirnorm_geometry``, which at the Qwen2-0.5B
  width is the same for M·H rows as for one): a flat sphere aggregate
  launches 1 ``zo_dirnorms`` and M·H ``zo_replay``.
- pytree: ``estimator.apply_coefficients`` with the config's convention
  (b2 ``zo_axpy`` per leaf per record).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import FedZOConfig
from repro_torch.core import estimator
from repro_torch.utils import prng
from repro_torch.utils.flatparams import flat_geometry, unflatten
from repro_torch.utils.tree import tree_scale, tree_zeros_like

KEY_WORD_BYTES = 4   # a Threefry key word is a uint32 on the wire


def _wire_key_data(rngs):
    """The raw key words, with the wire contract enforced: the format
    ships the two-word Threefry key."""
    if rngs.shape[-1] != 2:
        raise ValueError(
            f"seed-compression wire format carries the 8-byte threefry key; "
            f"got {rngs.shape[-1]}-word key data (cfg.prng_impl='rbg'/"
            f"'unsafe_rbg'?) — use threefry2x32 keys for seed-compressed "
            f"uplinks")
    return rngs


def _check_replayable(cfg: FedZOConfig):
    """Block-convention coefficients exist only inside the simulation: a
    receiver would rebuild uncorrelated directions from them with no
    error, so they are rejected at the replay boundary."""
    if cfg.batch_directions and cfg.direction_conv != "tree":
        raise ValueError(
            "coefficients from the batched-direction path with "
            "direction_conv='block' are not seed-replayable — use "
            "direction_conv='tree' (bit-identical directions) or the flat "
            "counter path for seed-compressed uplinks")


def compress(rng, coeffs, cfg: FedZOConfig):
    """The wire message of one client round: (key ``[2]``, coeffs ``[H,
    b2]``, lr)."""
    return {"key": _wire_key_data(rng), "coeffs": coeffs,
            "lr": torch.tensor(cfg.lr, dtype=torch.float32)}


def compress_stacked(rngs, coeffs, cfg: FedZOConfig):
    """All M wire messages of a round as one bundle: (keys ``[M, 2]``,
    coeffs ``[M, H, b2]``, lrs ``[M]``), byte for byte M ``compress``
    messages."""
    return {"key": _wire_key_data(rngs), "coeffs": coeffs,
            "lr": torch.full((coeffs.shape[0],), cfg.lr,
                             dtype=torch.float32)}


def wire_bytes(msg) -> int:
    """Uplink bytes of one message, or of a whole ``compress_stacked``
    bundle: 4 bytes per key word, plus the coefficients' and the lr's
    bytes."""
    def nbytes(t):
        return t.numel() * t.element_size()

    return int(KEY_WORD_BYTES * msg["key"].numel() + nbytes(msg["coeffs"])
               + nbytes(torch.as_tensor(msg["lr"], dtype=torch.float32)))


def wire_bytes_model(cfg: FedZOConfig) -> int:
    """The per-client bytes of one message from the config alone: the
    8-byte key, H·b2 float32 coefficients and the 4-byte lr (what
    ``wire_bytes`` measures, and what ``obs.ledger`` charges)."""
    return 8 + cfg.local_iters * cfg.b2 * 4 + 4


def _lr(lr) -> float:
    """The float32 lr of a message as a Python float (exact)."""
    return float(np.float32(float(lr)))


def reconstruct_delta(msg, params_like, cfg: FedZOConfig):
    """Replay Δ = −η Σ_k Σ_n (c[k, n]/b2) v(key, k, n) from one message:
    one ``zo_replay`` per iterate on the flat route (the sender's
    geometry), else b2 axpy passes per iterate in the config's
    convention."""
    _check_replayable(cfg)
    coeffs = msg["coeffs"]
    H = coeffs.shape[0]
    keys = prng.split(msg["key"], H)
    lr = _lr(msg["lr"])
    if cfg.flat_params:
        spec, br = flat_geometry(params_like, cfg.flat_block_rows)
        dev = estimator._device(params_like)
        buf = torch.zeros((1, spec.n_pad), dtype=torch.float32, device=dev)
        for k in range(H):
            buf = estimator.flat_apply_coefficients(
                buf, spec, keys[k].reshape(1, 2).to(dev), coeffs[k][None],
                scale=-lr, kind=cfg.estimator, block_rows=br)
        return unflatten(buf[0], spec)
    delta = tree_zeros_like(params_like)
    for k in range(H):
        delta = estimator.apply_coefficients(
            delta, keys[k], coeffs[k], scale=-lr, kind=cfg.estimator,
            conv=cfg.direction_conv)
    return delta


def stack_messages(msgs):
    """M wire messages as (keys ``[M, 2]``, coeffs ``[M, H, b2]``, lrs
    ``[M]``); all must share (H, b2)."""
    keys = torch.stack([m["key"] for m in msgs])
    coeffs = torch.stack([m["coeffs"] for m in msgs])
    lrs = torch.stack([torch.as_tensor(m["lr"], dtype=torch.float32)
                       for m in msgs])
    return keys, coeffs, lrs


def _iterate_keys(keys, H):
    """``[M, 2]`` round keys -> ``[M·H, 2]`` per-iterate keys: the
    ``split(key, H)`` every receiver of one message performs."""
    return prng.split(keys, H).reshape(-1, 2)


def aggregate(msgs, params_like, cfg: FedZOConfig):
    """Mean of the M replayed deltas: ``msgs`` a list of ``compress``
    messages or one ``compress_stacked`` bundle. The M·H (key, coeffs
    ``[b2]``, lr) records replay into one accumulator (flat buffer or delta
    tree), m ascending then h, and the sum is divided by M."""
    _check_replayable(cfg)
    if isinstance(msgs, dict):
        keys, coeffs, lrs = msgs["key"], msgs["coeffs"], msgs["lr"]
        M = coeffs.shape[0]
    else:
        M = len(msgs)
        keys, coeffs, lrs = stack_messages(msgs)
    H, b2 = coeffs.shape[1], coeffs.shape[2]
    k_mh = _iterate_keys(keys.cpu(), H)
    c_mh = coeffs.reshape(M * H, b2)
    lr_mh = [_lr(v) for v in torch.repeat_interleave(lrs.cpu(), H)]
    if cfg.flat_params:
        spec, br = flat_geometry(params_like, cfg.flat_block_rows)
        dev = estimator._device(params_like)
        kd = k_mh.to(dev)
        inv = estimator.flat_inv_norms(kd, spec, b2, cfg.estimator,
                                       block_rows=br)
        buf = torch.zeros((1, spec.n_pad), dtype=torch.float32, device=dev)
        for r in range(M * H):
            buf = estimator.flat_apply_coefficients(
                buf, spec, kd[r:r + 1], c_mh[r:r + 1], scale=-lr_mh[r],
                kind=cfg.estimator, block_rows=br, inv=inv[r:r + 1])
        return unflatten(buf[0] / M, spec)
    delta = tree_zeros_like(params_like)
    for r in range(M * H):
        delta = estimator.apply_coefficients(
            delta, k_mh[r], c_mh[r], scale=-lr_mh[r], kind=cfg.estimator,
            conv=cfg.direction_conv)
    return tree_scale(1.0 / M, delta)
