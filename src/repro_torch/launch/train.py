"""Training CLI: FedZO on a registered architecture, in PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b-smoke \
        --steps 50 --batch 4 --seq 128 --b2 8 [--device cpu]

Counterpart of ``repro/launch/train.py``: the same flags and defaults, the
same printed lines, the same key chain and synthetic LM stream, and with
``--out`` the same ``history.json`` (with ``algo``) and ``final/``
checkpoint (the format both packages read, ``checkpoint/checkpoint.py``).
``--arch`` takes any registered architecture: the dense, moe, ssm
(``rwkv6-7b``), hybrid (``hymba-1.5b``), encdec (``seamless-m4t-large-v2``,
each step's ``src_embeds`` drawn from the step's key) and vlm
(``llama-3.2-vision-90b``, zero ``vision_embeds``) families, each step one
client's loss.

- ``--algo fedzo`` (default, lr 1e-4) runs one local iterate per step on
  the reference's default route, the pytree estimator (``FedZOConfig()``'s
  ``flat_params=False``, ``direction_conv="tree"``), whose every
  perturbation and update is a ``zo_axpy`` launch per leaf. ``--opt`` is
  ignored, as in the reference.
- ``--algo fedavg`` (default lr 1e-3) takes one first-order step: the
  loss and its gradient by autograd (RMSNorm and attention run their
  kernels forward and differentiate through their plain versions,
  ``kernels/ops.py``), then ``sgd_apply`` (``--opt sgd``, the reference's
  ``fedavg.make_train_step``) or ``adam_apply`` (``--opt adam``).

``--device`` (default ``cuda``; the CPU only when asked) is the port's
addition.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import restore, save
from repro_torch.configs import get_config
from repro_torch.configs.base import FedZOConfig
from repro_torch.core import fedavg, fedzo
from repro_torch.data.synthetic import lm_batches, lm_token_stream
from repro_torch.kernels import ops
from repro_torch.models.api import build
from repro_torch.optim.sgd import adam_apply, adam_init
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_size


class TrainResult(NamedTuple):
    params: dict
    history: list        # the loss of every step
    step_ms: list        # host time of every step, synchronised
    launches: list       # ops.LAUNCHES after every step (cumulative)


def make_lm_data(cfg, n_tokens=200_000, seed=0):
    vocab = min(cfg.vocab, 4096)  # synthetic stream over a vocab subset
    return lm_token_stream(n_tokens, vocab, seed=seed)


def frontend_inputs(cfg, batch, key, step, dev) -> dict:
    """The stubbed modality frontend's inputs of one step, as the
    reference's CLI makes them: zero ``vision_embeds`` for a vlm model,
    ``0.1·normal(fold_in(key, step))`` ``src_embeds`` for an encdec one
    (drawn from the step's key before its split), ``[batch,
    n_frontend_tokens, d_model]`` in the model's dtype; none otherwise."""
    shape = (batch, cfg.n_frontend_tokens, cfg.d_model)
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        return {"vision_embeds": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.family == "encdec":
        # 0.1 rounded to the dtype, as jax's weakly typed scalar is
        scale = float(torch.tensor(0.1, dtype=dtype))
        return {"src_embeds": prng.normal(prng.fold_in(key, step), shape,
                                          dtype=dtype, device=dev) * scale}
    return {}


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b-smoke")
    ap.add_argument("--algo", default="fedzo", choices=("fedzo", "fedavg"))
    ap.add_argument("--opt", default="sgd", choices=("sgd", "adam"),
                    help="first-order optimizer (fedavg path only)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--mu", type=float, default=1e-3)
    ap.add_argument("--b2", type=int, default=8)
    ap.add_argument("--estimator", default="sphere",
                    choices=("sphere", "gaussian", "coordinate"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--override", default="", help="cfg overrides, e.g. "
                    "d_model=768,n_layers=12,d_ff=3072,vocab=16384")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                    "versions)")
    return ap


def _overridden(cfg, spec):
    kw = {}
    for part in spec.split(","):
        k, v = part.split("=")
        cur = getattr(cfg, k)
        kw[k] = type(cur)(v) if cur is not None else int(v)
    return cfg.replace(**kw)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> TrainResult:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.override:
        cfg = _overridden(cfg, args.override)
    model = build(cfg)
    lr = args.lr if args.lr is not None else (1e-4 if args.algo == "fedzo"
                                              else 1e-3)
    fcfg = FedZOConfig(lr=lr, mu=args.mu, b2=args.b2,
                       estimator=args.estimator, seed=args.seed)

    params = model.init(prng.key(args.seed), device=dev)
    print(f"arch={cfg.name} params={tree_size(params)/1e6:.1f}M "
          f"algo={args.algo} lr={lr} b2={args.b2}", flush=True)

    start = 0
    if args.resume:
        params, start = restore(args.resume, params)
        print(f"resumed from {args.resume} @ step {start}")

    opt_state = None
    if args.algo == "fedzo":
        step_fn = fedzo.make_train_step(model.loss, fcfg)
    elif args.opt == "adam":
        opt_state = adam_init(params)

        def step_fn(p, batch, rng):
            nonlocal opt_state
            del rng
            loss, g = fedavg.value_and_grad(model.loss, p, batch)
            p, opt_state = adam_apply(p, g, opt_state, lr=lr)
            return p, {"loss": loss}
    else:
        step_fn = fedavg.make_train_step(model.loss, fcfg)
    toks = make_lm_data(cfg, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    key = prng.key(args.seed + 1)
    history, step_ms, launches = [], [], []
    t0 = time.time()
    for step in range(start, start + args.steps):
        b = lm_batches(toks, args.batch, args.seq, rng)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        batch.update(frontend_inputs(cfg, args.batch, key, step, dev))
        ks = prng.split(key, 2)
        key, sub = ks[0], ks[1]
        _sync(dev)
        ts = time.perf_counter()
        params, metrics = step_fn(params, batch, sub)
        history.append(float(metrics["loss"]))
        _sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - ts))
        launches.append(dict(ops.LAUNCHES))
        if step % args.log_every == 0:
            dt = (time.time() - t0) / max(step - start + 1, 1)
            print(f"step {step:5d} loss {history[-1]:.4f} "
                  f"({dt:.2f}s/step)", flush=True)
        if args.ckpt_every and args.out and \
                (step + 1) % args.ckpt_every == 0:
            save(os.path.join(args.out, f"ckpt_{step+1}"), params,
                 step=step + 1, meta=fcfg)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "history.json"), "w") as f:
            json.dump({"loss": history, "arch": cfg.name,
                       "algo": args.algo}, f)
        save(os.path.join(args.out, "final"), params,
             step=start + args.steps, meta=fcfg)
    first = np.mean(history[:5]) if len(history) >= 5 else history[0]
    last = np.mean(history[-5:])
    print(f"done: loss {first:.4f} -> {last:.4f} over {args.steps} steps")
    return TrainResult(params, history, step_ms, launches)


if __name__ == "__main__":
    main()
