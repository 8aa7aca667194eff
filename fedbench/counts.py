"""The yardstick: the card's peaks, least times, and the work a round
needs, counted from the algorithm's shapes (never from what implements a
kernel).

Peaks are NVIDIA's H100 SXM5 80GB data sheet at the 700 W limit (as
``utils/hw.py`` and ``chip_smoke.py`` hold them): HBM3 3.35 TB/s; float32
outside the tensor cores 67 TFLOP/s (132 SMs x 128 lanes x 2 x 1.98 GHz);
int32 a quarter of that (64 lanes an SM), 16.75 T op/s. The benchmark runs
float32 with TF32 off, so 67 TFLOP/s is the float32 peak of every model
FLOP here.

A Threefry-2x32 evaluation is 20 rounds of (add, rotate, xor), five key
injections of two adds and the add of the counter word: 71 int32
operations. Box-Muller's float work runs on other pipes and is not
counted, so a bound stays a least time.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT32_OP_PER_S = FP32_FLOP_PER_S / 4
THREEFRY_EVAL_OPS = 71
PAD = 512 * 128          # the flat buffer's pad granularity


def param_count(family, cfg) -> int:
    return sum(math.prod(s) for _, s in family.param_shapes(cfg))


def n_pad(d: int) -> int:
    return d + (-d) % PAD


def bound_s(nbytes, ops, kind="fp32") -> float:
    """Least seconds: the larger of bytes over the HBM rate and operations
    over the peak of their type."""
    rate = INT32_OP_PER_S if kind == "int" else FP32_FLOP_PER_S
    return max(nbytes / HBM_BYTES_PER_S, ops / rate)


def zo_bound_s(traffic, d: int) -> float:
    """Least seconds of one round's ZO kernels on the flat route: per
    iterate one norms pass (M·b2·d evaluations), b2 walks over the ``[M,
    n_pad]`` buffer (the first adds one direction, each later one removes
    the last and adds the next: 2 evaluations an element) and one replay
    (b2 evaluations an element); with AirComp one reduction of the
    ``[M, n_pad]`` deltas (the weighted mean and the row norms) and one
    noise walk of one direction over ``[n_pad]``."""
    M, H, b2 = traffic["clients"], traffic["local_iters"], \
        traffic["directions"]
    n = n_pad(d)
    walk = M * n * 8
    per_iterate = (
        bound_s(M * 16 + M * b2 * 4, THREEFRY_EVAL_OPS * M * b2 * d, "int")
        + bound_s(walk, THREEFRY_EVAL_OPS * M * n, "int")
        + (b2 - 1) * bound_s(walk, THREEFRY_EVAL_OPS * 2 * M * n, "int")
        + bound_s(walk + M * b2 * 4, THREEFRY_EVAL_OPS * b2 * M * n, "int"))
    total = H * per_iterate
    if traffic["aggregation"] == "aircomp":
        total += bound_s(M * n * 4 + n * 4 + M * 8, 2 * M * n + 2 * M * d)
        total += bound_s(n * 8, THREEFRY_EVAL_OPS * n, "int")
    return total


def forwards_per_round(traffic) -> int:
    """Cohort forwards of a round: each iterate's base and b2 points."""
    return traffic["local_iters"] * (traffic["directions"] + 1)


def flops_per_round(family, cfg, traffic) -> float:
    """Model FLOPs of one round's forwards: every client's rows."""
    seqs = traffic["clients"] * traffic["rows"]
    return (forwards_per_round(traffic) * seqs
            * family.forward_flops(cfg, traffic["seq"]))


def lm_kernel_bound_s(family, cfg, traffic) -> float:
    """Least seconds of one round's RMSNorm and attention launches at the
    cohort's shapes: per forward 2L + 1 RMSNorms over the ``[M·rows·seq,
    d_model]`` rows (each client's scale), and L causal attentions over
    ``[M·rows, seq]`` with the configuration's heads. RMSNorm reads x and
    the scales and writes its output, 4 FLOPs an element; attention reads
    q, k, v and writes its output, 4·head_dim FLOPs a kept (query, key)
    pair and head."""
    M, rows, S = traffic["clients"], traffic["rows"], traffic["seq"]
    L, D = cfg["n_layers"], cfg["d_model"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    R, B = M * rows * S, M * rows
    norm = bound_s(2 * R * D * 4 + M * D * 4, 4 * R * D)
    pairs = family.attention_pairs(S, cfg.get("sliding_window", 0))
    attn = bound_s(4 * B * S * hd * (2 * hq + 2 * hkv),
                   4 * hd * pairs * B * hq)
    return forwards_per_round(traffic) * ((2 * L + 1) * norm + L * attn)


# kernel names the program's hand-written kernels carry in a trace
ZO_KERNELS = ("zo_walk", "zo_replay", "dirnorm", "aircomp_reduce")
LM_KERNELS = ("rmsnorm", "flash_fwd")


def is_kind(name: str, pieces) -> bool:
    return any(p in name for p in pieces)
