"""Serving CLI: one batched prefill, then a decode loop, on a registered
architecture (dense, moe, ssm, hybrid, encdec or vlm), in PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b-smoke \
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --batch 2 --prompt-len 64 --gen 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch hymba-1.5b --batch 2 --prompt-len 2048 --gen 8

Counterpart of ``repro/launch/serve.py``: the same flags, key chain and
printed lines. The weights come from ``--seed``, the prompt from
``make_batch(…, key(seed + 1))``; the cache is ``--width`` wide (default
prompt + gen; narrower is a ring, ``models/attention.py``). Each step
decodes one token per request, greedily or, with ``--temperature``, by
``prng.categorical`` on the logits over the temperature from
``split(key(seed + 2))``. It prints the prefill and decode tokens per
second (host clock between ``torch.cuda.synchronize()`` calls), the first
two requests' tokens and ``serve OK`` after a finite check of the last
logits. On the card the prefill runs the ``flash_attention`` and
``rmsnorm`` kernels in every layer and decode the ``rmsnorm`` kernel; the
one-token attention over the cache (MLA's absorbed form included), the
MoE routing and expert GEMMs, and the rwkv6 and Mamba layers (the chunked
WKV, the selective scan, their one-step recurrences on the cached state)
are plain torch, as the reference's. An ssm model (rwkv6-7b, layernorms,
no attention) launches no kernel at all; a hybrid one (hymba-1.5b)
launches them as a dense one does, its attention under its sliding window
of 1,024. qwen3-moe-30b-a3b at full width holds 56.89 GiB of bfloat16
weights: one 80 GB card serves it with its cache. An encdec or vlm
model's prompt batch carries its stubbed frontend's embeddings
(``src_embeds`` or ``vision_embeds``, drawn by ``make_batch``): the
prefill encodes them (seamless-m4t-large-v2's bidirectional encoder, one
non-causal flash attention a layer) and writes every cross layer's K/V
into the cache once; a decode batch holds the tokens only, and each step's
cross-attentions are the flash kernel at one query over the cached K/V.

``--device`` (default ``cuda``; the CPU only when asked) is the port's
addition. ``main(argv)`` returns a ``ServeResult``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.models.api import build, make_batch
from repro_torch.utils import prng


class ServeResult(NamedTuple):
    tokens: np.ndarray     # [B, gen + 1]: the prefill's token, then gen
    logits: torch.Tensor   # the last decode step's [B, V]
    prefill_s: float
    decode_s: float
    init_s: float           # the weights' init (host clock, synchronised)
    prefill_launches: dict  # ops.LAUNCHES of the prefill
    decode_launches: dict   # ops.LAUNCHES of the gen decode steps
    model: Any
    params: dict
    batch: dict             # the prompt


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--width", type=int, default=0, help="cache width")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                    "versions)")
    return ap


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _next_token(logits, temperature, key):
    """(token [B, 1] int32, key'): greedy, or a categorical draw."""
    if temperature > 0:
        ks = prng.split(key, 2)
        key, sub = ks[0], ks[1]
        tok = prng.categorical(sub, logits / temperature)
    else:
        tok = torch.argmax(logits, dim=-1)
    return tok[:, None].to(torch.int32), key


def main(argv=None) -> ServeResult:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = build(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    params = model.init(prng.key(args.seed), device=dev)
    _sync(dev)
    t_init = time.perf_counter() - t0
    width = args.width or (args.prompt_len + args.gen)

    shape = ShapeConfig("serve", args.prompt_len, args.batch, "prefill")
    batch = make_batch(model, shape, prng.key(args.seed + 1), device=dev)

    ops.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, width)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    pre_launches = dict(ops.LAUNCHES)
    print(f"prefill: batch={args.batch} len={args.prompt_len} "
          f"{t_prefill:.2f}s ({args.batch*args.prompt_len/t_prefill:.0f} "
          f"tok/s)")

    key = prng.key(args.seed + 2)
    tok, _ = _next_token(logits, 0.0, key)
    out_tokens = [tok]
    pos0 = torch.tensor(args.prompt_len, dtype=torch.int64, device=dev)
    ops.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(args.gen):
        logits, cache = model.decode(params, {"tokens": tok}, cache,
                                     pos0 + i)
        tok, key = _next_token(logits, args.temperature, key)
        out_tokens.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    dec_launches = dict(ops.LAUNCHES)
    seqs = torch.cat(out_tokens, dim=1).cpu().numpy()
    print(f"decode: {args.gen} steps in {dt:.2f}s "
          f"({args.batch*args.gen/dt:.1f} tok/s)")
    for b in range(min(args.batch, 2)):
        print(f"  request {b}: {seqs[b].tolist()}")
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("serve: non-finite logits")
    print("serve OK")
    return ServeResult(seqs, logits, t_prefill, dt, t_init, pre_launches,
                       dec_launches, model, params, batch)


if __name__ == "__main__":
    main()
