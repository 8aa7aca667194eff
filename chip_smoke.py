#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FedZO on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout (it imports ``src/repro_torch``). Phases,
each of which raises on a failure (the script then exits non-zero):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
2. Hold every kernel against its plain PyTorch version on the card, at the
   main paths' shapes, and time it with CUDA events beside its plain
   version, its bound and (where one exists) one PyTorch library call.
   - The four ZO kernels at the flat round's shapes (M = 10 clients,
     n_pad = 65,536, d = 7,850, b2 = 20), for both direction kinds and a
     ragged length that is not a multiple of the CUDA block. Tolerances:
     the sign kind bitwise; the normal kind within 4 ulp of the magnitude of
     the summed terms; the reductions within a relative 1e-5 (another
     summation order).
     zo_dirnorms also bitwise the torch twin of its summation order
     (``dirnorm_order_sum``; the sign kind from the plain directions, the
     normal kind on the kernels' own directions) and over two calls.
     aircomp_reduce's mean bitwise, its norms bitwise their twin
     (``aircomp_sq_order_sum``), also ragged and at an odd offset; timed
     beside its previous two-launch design.
   - zo_walk, zo_replay and zo_dirnorms again at the Qwen2-0.5B train
     step's width (M = 1, n_pad = 494,075,904, d = 494,032,768, b2 = 8);
     the norms' finish is also timed on its own. aircomp_reduce at the flat
     Qwen2-0.5B round's [4, 494,075,904], beside its previous design.
   - rmsnorm ([512, 896] and the [7168, 64] rows of a qk_norm) and
     flash_attention (q [4, 128, 14, 64], k/v [4, 128, 2, 64], causal; a
     ragged S = 100, a window of 32, a non-causal call, causal S = 512, a
     ragged S = 1,000 with a window of 256), each in float32 and bfloat16.
     Tolerances: float32 within a relative 1e-5 (another summation order);
     bfloat16 within 1 bf16 ulp of the output (the two float32 results
     round to neighbouring bf16 values at most). rmsnorm is also bitwise
     the torch twin of its summation order (``rmsnorm_kernel_order``), also
     at an odd element offset and with a ``[G, D]`` scale (G = 1 and 4, the
     client-batched forward), timed with G = 4 beside G = 1. Attention
     again at head dims 16 and 256 (causal, window, GQA, ragged), timed
     against SDPA at [4, 128, 14 or 8, D]; and at the transformer track's
     shapes (q [250 or 5,000, 8, 2, 16 or 8], float32), timed against
     SDPA, with RMSNorm over 10 and 200 groups of 200 rows of D = 32.
   - zo_axpy and zo_axpy2, bitwise, for x, u and v each float32 or
     bfloat16 (all eight mixes): ragged n (1, 7, 65,537), views at odd
     element offsets, and Qwen2-0.5B's largest leaves (the tied embedding
     [151,936, 896], the stacked w_gate [24, 896, 4,864]); timed at the
     embedding beside torch.add.
3. The main paths, through the entry points a user calls:
   - softmax regression 784x10 (the paper's Sec. V-B model) on 50 clients
     with the FedZOConfig defaults (N=50, M=10, H=5, b1=25, b2=20),
     flat_params and size-weighted aggregation, 5 rounds; the same with
     AirComp (channel scheduling, 5 dB); the SmallCNN (28x28x1, width 8),
     2 rounds;
   - the cross-silo FedZO train step on Qwen2-0.5B at full width in
     float32 (arXiv:2407.10671; 494 M parameters, random weights from seed
     0), batch 4 x seq 128 of the synthetic LM stream, b2 = 8, 4 steps;
     then one more step through ``fedzo.local_iterate`` at mu = 16, each
     coefficient held to its recomputation without a ZO kernel
     (``check_estimator``: every loss difference at least 256 ulps).
   - the flat FedZO round on the same model (``fedzo.round_simulated``, M =
     4 clients, H = 2, b2 = 8), once with the plain mean and once with
     AirComp: the cohort's forwards go through the model's client-batched
     loss, so the launch counts are those of one client; the batched loss
     against each client's own loss; kernel time by kind of a profiled
     AirComp round; ms per round and peak memory.
   - the pytree route (the reference's default): ``ops.tree_axpy2`` once
     over the full-width Qwen2-0.5B tree (14 leaves, held against the plain
     version leaf by leaf); the training CLI ``repro_torch.launch.train``
     on Qwen2-0.5B in float32, 3 steps (2·b2 zo_axpy launches per leaf and
     step); softmax 784x10 with flat_params off, 2 rounds, and one AirComp
     round.
   - phase "transformer and wide rounds": the neural transformer track
     (784 features in 8 patch tokens, d_model 32, 2 heads, 1 layer) at the
     same N, M, H, b1, b2 and its own lr (``neural.default_config``):
     flat 3 rounds, flat AirComp 2, pytree 1 round cut to H = 1, and the
     same pytree round with bfloat16 directions (sphere and gaussian); the
     wide route (batch_directions, block directions) on softmax and on the
     track, 3 rounds each, and on softmax one round of each of the tree,
     channel and surrogate conventions and of block with AirComp; one
     profiled round of three of them.
   The launch counters are set to 0 before each run (each train step) and
   must equal exactly what it implies.
4. Small-input references: a short softmax run on each route, 3 train
   steps of qwen2-0.5b-smoke on each route and one flat round of it over 3
   clients, 2 rounds of the transformer track at its test size (head dim
   8) on the flat, pytree and wide routes and on the pytree route with
   bfloat16 directions (sphere and gaussian), each on the card against the
   same run on the CPU (plain versions), within the float32 tolerance of a
   ZO trajectory; bfloat16 normals drawn on the card bitwise the CPU's.

5. Phase "algorithms and uplinks" (the strategy layer, FedAvg, the
   seed-compressed uplink and ``FedServer``), each part's seconds and peak
   memory printed:
   (a) softmax 784x10 at the phase-3 settings, 3 rounds each: fedprox
       (prox_mu 0.01), feddyn (dyn_alpha 0.01) and scaffold on the flat
       route, scaffold on the wide route, fedprox with AirComp, fedavg (lr
       0.05); each strategy launches exactly the fedzo round's kernels on
       its route, fedavg none; the loss falls.
   (b) the transformer track at its lr 5e-3: fedprox (flat) and fedavg, one
       round each, M-free attention and RMSNorm counts; one client's FedAvg
       gradient on the card against the CPU's (every leaf within 1e-4 of
       its largest entry: a backward that skipped the kernels' inputs
       would leave the attention and norm weights at zero).
   (c) the autograd wrappers' backward at Qwen2-0.5B's shapes (batch 1 x
       seq 16), the track's, a [G, D] scale and head dims 8-256, float32
       and bfloat16, bitwise the plain version's autograd on the card, and
       timed at the Qwen step's and the track round's shapes; then 3 steps
       of ``repro_torch.launch.train --algo fedavg --opt adam`` on
       Qwen2-0.5B at full width (float32, batch 4 x seq 128): ms per step,
       peak memory, the losses, one forward's launches a step, and the
       recompute's share of a step.
   (d) ``run_seed_compressed_round`` on Qwen2-0.5B (flat, M = 4, H = 2, b2
       = 8) against a dense ``fedzo.round_simulated`` on the same batches
       and keys: the replayed weights within H + 2 ulps of each leaf's
       largest weight, exactly 1 zo_dirnorms and M.H zo_replay in the
       aggregate, M.(8 + 4.H.b2 + 4) wire bytes and the compression ratio.
   (e) one ZO-FedProx flat round on Qwen2-0.5B (M = 4, H = 2, b2 = 8): ms,
       peak memory, the fedzo round's launch counts.
   (f) ``FedServer`` on softmax, 2 rounds: the host loop with fedzo and
       fedavg, the store path with all five strategies; exact counts and
       the ledger's columns on every row.
   Then one round each of fedprox (flat), scaffold (wide) and fedavg on the
   transformer track at its test size, card against CPU (1e-3; FedAvg
   1e-5).
6. Phase "faults, channel and durability" (fault injection, the wireless
   channel chain, durable checkpointed runs, taps, manifests and the
   paper's Sec. V-A attack), each part's seconds and peak memory printed:
   (a) the flat AirComp round on Qwen2-0.5B (M = 4, H = 2, b2 = 8, 5 dB)
       under a correlated, energy-gated channel with client 2 poisoned
       (NaN, guard on): weights bitwise those of the round with client 2
       masked, the chain's m_effective and m_corrupt 1, non-finite weights
       with the guard off, the plain AirComp round's launches, peak memory
       at most one [n_pad] float32 row above it; ms beside it.
   (b) softmax 784x10 at phase 3's N, M, H with AirComp under dropout,
       stragglers, NaN uploads and the channel, 6 rounds: taps every 2
       rounds equal to the history rows; 2-round segments, and a run
       killed after 2 segments then resumed, bitwise the single-shot run;
       the manifest read back; a divergence drill (a rollback, then
       DivergenceError); a poisoned pytree round (H = 1) bitwise the
       masked one.
   (c) the attack at the reference task's width (32x32x3 images, 10 uneven
       shards of 512 images): the classifier trained on the card, 5 flat
       rounds (H = 20, b2 = 20) with exact launches, and the SNR {0, 10, 20}
       dB x seeds {0, 1} sweep into a CSV that covers every scenario and
       round.
   Then the 6-round run of (b) on the CPU against the card's: the chains
   and masks equal, the weights within 1e-3.

The line before the last is the JSON kernel table, the last line
``{"ok": true, "device": {...}}``. ``--profile DIR`` adds torch.profiler
traces of one softmax round and one Qwen2-0.5B train step (kernel time by
name, device busy share), written to DIR, and the kernel table (no
timeline) of one pytree softmax round and one pytree Qwen2-0.5B step.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# the card's peak rates (H100 SXM data sheet, at the 700 W limit): HBM3
# 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s = 132 SMs x 128
# lanes x 2 (FMA) x 1.98 GHz; an SM has 64 int32 lanes, so int32 is a
# quarter of that: 16.7 T op/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT32_OP_PER_S = FP32_FLOP_PER_S / 4
# bfloat16 on the tensor cores, dense (data sheet)
BF16_FLOP_PER_S = 989e12
# int32 operations of the Threefry-2x32 evaluations a kernel makes
# (csrc/threefry.cuh). Each evaluation: 20 rounds of (add, rotate, xor), five
# key injections of two adds, and the add of the counter word that changes
# from one evaluation of a thread to the next (the direction index n in walk
# and replay, the flat index in dirnorms): 71. Once per thread: k2 = k0^k1^C
# (2), the five injected constants k + s (5), and the add of the counter word
# that stays fixed for the thread: 8. Box-Muller's float work runs on other
# pipes and is not counted, so the bound stays a least time.
THREEFRY_EVAL_OPS = 71
THREEFRY_THREAD_OPS = 8

M, N_PAD, D, B2 = 10, 65536, 7850, 20
RAGGED = N_PAD + 77
# the Qwen2-0.5B train step: flat buffer of one client, b2 = 8 directions,
# batch 4 x seq 128 = 512 token rows of d_model 896; 14 q heads over 2 kv
# heads of dim 64
QWEN_D, QWEN_N_PAD, QWEN_B2 = 494_032_768, 494_075_904, 8
# the flat Qwen2-0.5B round: M = 4 clients, H = 2 iterates each
QWEN_M, QWEN_H = 4, 2
LM_B, LM_S, LM_HQ, LM_HKV, LM_HD, LM_DM = 4, 128, 14, 2, 64, 896
# the Qwen2-0.5B parameter tree: 14 leaves; the largest are the tied
# embedding and the stacked MLP weights
QWEN_LEAVES, QWEN_EMBED, QWEN_W_GATE = 14, (151_936, 896), (24, 896, 4_864)
# The estimator check (check_estimator). At the launcher's mu = 1e-3 a
# coefficient d.(L(x + mu.v) - L(x))/mu of Qwen2-0.5B is a whole number of
# float32 ulps of the loss: the ulp of L at about 12.1 is 9.5e-7, so one ulp
# moves a coefficient by d.ulp/mu = 4.7e5, and the four steps read
# coefficient norms of 0 to 1.2e6 over 8 directions: |L(x + mu.v) - L(x)|
# of about 1 ulp, so the directional slopes |dL/dv| are about 1e-3 and the
# forward's rounding decides each coefficient. The check needs every
# difference to be at least CHECK_MIN_ULPS = 256 ulps (2.4e-4): mu = 0.25
# for a slope of 1e-3, and the smallest of 8 slopes can be ten times
# smaller, so mu = 16 for a margin of about 6. The step mu/sqrt(d) = 7e-4
# per weight stays well below the weights' 0.02. The check prints the
# differences; on an H100 the smallest read 902 ulps.
QWEN_CHECK_MU = 16.0
CHECK_MIN_ULPS = 256
# Tolerance of a coefficient against its recomputation: the kernel's point
# x + mu.v_n (reached by the walk, which adds and removes the steps in
# float32, with the kernel's Box-Muller and float32 norm) and the
# recomputed one (float64 norm) differ per weight by about an ulp, which
# moves L by the forward's float32 rounding noise: a few loss ulps, and
# CHECK_TOL_ULPS = 8 of them in the coefficient's units d.ulp/mu; plus the
# norms' relative difference (at most 1e-4, the full-width dirnorms
# tolerance) of the coefficient itself. 8 ulps are 1/32 of the smallest
# difference allowed, so a zeroed or sign-flipped coefficient cannot pass.
CHECK_TOL_ULPS = 8
CHECK_NORM_REL = 1e-4


# names of the port's CUDA kernels in a profiler trace
PORT_KERNELS = ("zo_walk_kernel", "zo_replay_kernel", "dirnorm_kernel",
                "aircomp_reduce_kernel", "axpy_kernel", "rmsnorm_kernel",
                "rmsnorm_long_kernel", "flash_fwd")


def die(msg):
    print(msg, file=sys.stderr)
    sys.exit(2)


def check(cond, msg):
    """A failed check raises, so the script exits non-zero (even under -O)."""
    if not cond:
        raise RuntimeError(msg)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps, trials=3):
    """Device time of one ``fn()`` call: CUDA events around ``reps`` calls
    enqueued back to back, median over ``trials``.

    A wrapper's host work (checks, allocation, the ctypes call) takes longer
    than a small kernel runs, so events around calls issued one by one would
    time the host. Here a ``torch.cuda._sleep`` spin holds the stream while
    the host enqueues all ``reps`` calls, and the events bracket only the
    calls, which then run back to back on the device.
    """
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((2 * enqueue_s + 2e-3) * 2e9))  # ~2 GHz clock
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def ulp_err(torch, got, want, scale):
    """max |got - want| in units of the float32 spacing of ``scale``."""
    spacing = torch.nextafter(scale, torch.full_like(scale, float("inf"))) \
        - scale
    return float(((got - want).abs() / spacing).max())


def check_kernels(torch, ops, plain, plain_air):
    """Phase 2. Returns {kernel: row of the JSON table, without launches}."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def keys(m):
        return torch.randint(0, 2 ** 32, (m, 2), generator=g, device=dev,
                             dtype=torch.int64)

    rows = {}
    lines = []

    # zo_walk: x + a.v(n0) + b.v(n1)
    errs = []
    for kind in ("normal", "sign"):
        for n in (N_PAD, RAGGED):
            x, k, ab = rnd(M, n), keys(M), rnd(M, 2)
            got = ops.zo_walk(x, k, (3, 4), ab, kind=kind)
            want = plain.zo_walk_plain(x, k, (3, 4), ab, kind=kind)
            gp = plain.counter_gen(kind, k[:, :1], k[:, 1:], 3,
                                   torch.arange(n, device=dev))
            gn = plain.counter_gen(kind, k[:, :1], k[:, 1:], 4,
                                   torch.arange(n, device=dev))
            scale = x.abs() + (ab[:, :1] * gp).abs() + (ab[:, 1:] * gn).abs()
            if kind == "sign":
                check(torch.equal(got, want), f"zo_walk sign n={n} differs")
            else:
                u = ulp_err(torch, got, want, scale)
                check(u <= 4, f"zo_walk normal n={n}: {u} ulp")
            errs.append(float((got - want).abs().max()))
            lines.append(f"zo_walk {kind} n={n}: max_abs_err {errs[-1]:.3e}")
    # the AirComp noise pass: one row, one channel key, ab = (noise_std, 0),
    # nn = (0, 0)
    x, k = rnd(1, N_PAD) * 1e-3, keys(1)
    ab = torch.tensor([[2e-4, 0.0]], device=dev)
    got = ops.zo_walk(x, k, (0, 0), ab, kind="normal")
    want = plain.zo_walk_plain(x, k, (0, 0), ab, kind="normal")
    g0 = plain.counter_gen("normal", k[:, :1], k[:, 1:], 0,
                           torch.arange(N_PAD, device=dev))
    u = ulp_err(torch, got, want, x.abs() + (ab[:, :1] * g0).abs())
    check(u <= 4, f"zo_walk noise pass (M=1): {u} ulp")
    errs.append(float((got - want).abs().max()))
    lines.append(f"zo_walk normal M=1 noise pass: max_abs_err {errs[-1]:.3e}")
    x, k, ab = rnd(M, N_PAD), keys(M), rnd(M, 2)
    ms = median_ms(torch, lambda: ops.zo_walk(x, k, (3, 4), ab), 50)
    plain_ms = median_ms(torch, lambda: plain.zo_walk_plain(x, k, (3, 4), ab),
                         5)
    rows["zo_walk"] = dict(
        source="src/repro_torch/kernels/csrc/zo_axpy.cu",
        replaces="src/repro/kernels/zo_axpy.py:215", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(M * N_PAD * 8, threefry_ops(2 * M * N_PAD, M * N_PAD),
                "int"))

    # zo_replay: x + sum_n c[n].v(n)
    errs = []
    for kind in ("normal", "sign"):
        for n in (N_PAD, RAGGED):
            x, k, c = rnd(M, n), keys(M), rnd(M, B2) * 0.01
            got = ops.zo_replay(x, k, c, kind=kind)
            want = plain.zo_replay_plain(x, k, c, kind=kind)
            if kind == "sign":
                check(torch.equal(got, want), f"zo_replay sign n={n} differs")
            else:
                idx = torch.arange(n, device=dev)
                scale = x.abs()
                for j in range(B2):
                    scale = scale + (c[:, j:j + 1] * plain.counter_gen(
                        kind, k[:, :1], k[:, 1:], j, idx)).abs()
                u = ulp_err(torch, got, want, scale)
                check(u <= 4, f"zo_replay normal n={n}: {u} ulp")
            errs.append(float((got - want).abs().max()))
            lines.append(f"zo_replay {kind} n={n}: max_abs_err "
                         f"{errs[-1]:.3e}")
    x, k, c = rnd(M, N_PAD), keys(M), rnd(M, B2)
    ms = median_ms(torch, lambda: ops.zo_replay(x, k, c), 30)
    plain_ms = median_ms(torch, lambda: plain.zo_replay_plain(x, k, c), 3)
    rows["zo_replay"] = dict(
        source="src/repro_torch/kernels/csrc/zo_axpy.cu",
        replaces="src/repro/kernels/zo_axpy.py:259", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(M * N_PAD * 8 + M * B2 * 4,
                threefry_ops(B2 * M * N_PAD, M * N_PAD), "int"))

    # zo_dirnorms: [M, b2] of |v_n[:d]|^2
    errs = []
    for kind in ("normal", "sign"):
        for d in (D, RAGGED):
            k = keys(M)
            got = ops.zo_dirnorms(k, d, b2=B2, kind=kind)
            want = plain.zo_dirnorms_plain(k, d, b2=B2, kind=kind)
            rel = float(((got - want).abs() / want.abs()).max())
            check(rel <= 1e-5, f"zo_dirnorms {kind} d={d}: rel {rel}")
            errs.append(float((got - want).abs().max()))
            lines.append(f"zo_dirnorms {kind} d={d}: max_abs_err "
                         f"{errs[-1]:.3e} rel {rel:.2e}")
    # bitwise its summation order's torch twin: the sign kind from the plain
    # directions; the normal kind from the kernels' own directions (zo_walk
    # of zeros with ab = (1, 0) returns v_n exactly), whose squares the twin
    # sums; and the same result from a second call
    for d in (D, RAGGED):
        k = keys(M)
        got = ops.zo_dirnorms(k, d, b2=B2, kind="sign")
        check(torch.equal(got, plain.zo_dirnorms_kernel_order(
            k, d, b2=B2, kind="sign")),
              f"zo_dirnorms sign d={d}: not its twin")
        got = ops.zo_dirnorms(k, d, b2=B2)
        check(torch.equal(got, dirnorms_from_walk(torch, ops, plain, k, d,
                                                  B2)),
              f"zo_dirnorms normal d={d}: not its twin's sum of its squares")
        check(torch.equal(got, ops.zo_dirnorms(k, d, b2=B2)),
              f"zo_dirnorms d={d}: two calls differ")
    lines.append("zo_dirnorms: bitwise its twin (sign kind; normal kind on "
                 "the kernels' own directions) and over two calls")
    k = keys(M)
    per, chunks = plain.dirnorm_geometry(D, M * B2)
    ms = median_ms(torch, lambda: ops.zo_dirnorms(k, D, b2=B2), 50)
    plain_ms = median_ms(torch, lambda: plain.zo_dirnorms_plain(k, D, b2=B2),
                         3)
    rows["zo_dirnorms"] = dict(
        source="src/repro_torch/kernels/csrc/zo_axpy.cu",
        replaces="src/repro/kernels/zo_axpy.py:302", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(M * 16 + M * B2 * 4,
                threefry_ops(M * B2 * D, M * B2 * chunks * 256), "int"))
    r = rows["zo_dirnorms"]
    lines.append(f"zo_dirnorms M={M} b2={B2} d={D} ({per} evaluations a "
                 f"thread, {chunks} chunks): ms {ms:.5f} bound "
                 f"{r['bound_ms']:.5f} ({r['bound_ms'] / ms:.1%} of it)")

    # aircomp_reduce: (sum_m s[m].x[m], |x[m, :d]|^2). The mean bitwise the
    # plain version; the norms within 1e-5 relative of it (another order)
    # and bitwise the twin of the kernel's own order; a view at an odd
    # offset takes the scalar loads
    errs = []
    for n, off in ((N_PAD, 0), (RAGGED, 0), (N_PAD, 1)):
        x = (rnd(M * n + off) * 1e-3)[off:].view(M, n)
        s = torch.rand(M, generator=g, device=dev)
        mean, sq = ops.aircomp_reduce(x, s, D)
        pmean, psq = plain_air.aircomp_reduce_plain(x, s, D)
        check(torch.equal(mean, pmean), f"aircomp_reduce mean n={n} differs")
        rel = float(((sq - psq).abs() / psq.abs()).max())
        check(rel <= 1e-5, f"aircomp_reduce sq n={n}: rel {rel}")
        per, grid = ops.aircomp_geometry(n, x.device)
        check(torch.equal(sq, plain_air.aircomp_sq_order_sum(
            x, D, per=per, grid=grid)), f"aircomp_reduce sq n={n}: not its "
              f"twin")
        errs.append(max(float((mean - pmean).abs().max()),
                        float((sq - psq).abs().max())))
        lines.append(f"aircomp_reduce n={n} offset {off}: mean bitwise, sq "
                     f"rel {rel:.2e}, sq bitwise its twin (per {per}, grid "
                     f"{grid})")
    x, s = rnd(M, N_PAD) * 1e-3, torch.rand(M, generator=g, device=dev)
    row = aircomp_times(torch, ops, plain_air, x, s, D, 50)
    row.update(source="src/repro_torch/kernels/csrc/zo_aircomp.cu",
               replaces="src/repro/kernels/zo_aircomp.py:75",
               max_abs_err=max(errs))
    rows["aircomp_reduce"] = row
    lines.append(aircomp_line(f"[{M}, {N_PAD}]", row))
    for line in lines:
        print(line)
    return rows


def aircomp_twopass(torch, ops, x, s, d):
    """The previous two-launch AirComp reduction (its second kernel one
    thread per row summing every block partial in series), kept in
    ``csrc/zo_aircomp.cu`` only to be timed here beside the one-launch
    design. Not on any path."""
    lib = ops.build.load()["zo_aircomp"]
    m, n = x.shape
    partial = torch.empty((m, -(-n // lib.aircomp_twopass_block_cols())),
                          device=x.device)
    mean = torch.empty(n, device=x.device)
    sq = torch.empty(m, device=x.device)
    ops._check(lib.aircomp_reduce_twopass_launch(
        x.data_ptr(), s.data_ptr(), mean.data_ptr(), partial.data_ptr(),
        sq.data_ptr(), m, n, d, ops._stream()), "aircomp_reduce twopass")
    return mean, sq


def aircomp_times(torch, ops, plain_air, x, s, d, reps):
    """Times of the AirComp reduction over x ``[M, N]``: the kernel, the
    previous two-launch design, the plain version and one library call,
    beside the byte bound (each element read once, the mean written once).
    The previous design's mean must be the kernel's, bit for bit."""
    m, n = x.shape
    check(torch.equal(aircomp_twopass(torch, ops, x, s, d)[0],
                      ops.aircomp_reduce(x, s, d)[0]),
          "aircomp_reduce: the previous design's mean differs")
    ms = median_ms(torch, lambda: ops.aircomp_reduce(x, s, d), reps)
    prev = median_ms(torch, lambda: aircomp_twopass(torch, ops, x, s, d),
                     reps)
    plain_ms = median_ms(
        torch, lambda: plain_air.aircomp_reduce_plain(x, s, d),
        max(1, reps // 10), trials=3 if reps >= 10 else 1)
    # yardstick only, never called by the port: one matvec + one row norm
    library_ms = median_ms(
        torch, lambda: (s @ x, x[:, :d].square().sum(1)), reps)
    return dict(ms=ms, previous_ms=prev, plain_ms=plain_ms,
                library_ms=library_ms,
                **bound(m * n * 4 + n * 4 + m * 8, 2 * m * n + 2 * m * d,
                        "fp32"))


def aircomp_line(shape, r):
    return (f"aircomp_reduce {shape}: ms {r['ms']:.5f} (previous two-launch "
            f"design {r['previous_ms']:.5f}, {r['previous_ms'] / r['ms']:.2f}x)"
            f" plain {r['plain_ms']:.4f} library {r['library_ms']:.5f} bound "
            f"{r['bound_ms']:.5f} ({r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of it)")


def dirnorms_from_walk(torch, ops, plain, k, d, b2):
    """[M, b2] squared norms of the CUDA kernels' own normal directions
    (zo_walk of zeros with ab = (1, 0): v_n exactly, up to the sign of a
    zero) summed in the norms kernel's order by its torch twin."""
    m = k.shape[0]
    zeros = torch.zeros(m, d, device=k.device)
    ab = torch.tensor([[1.0, 0.0]] * m, device=k.device)
    per = plain.dirnorm_geometry(d, m * b2)[0]
    out = []
    for n in range(b2):
        g = ops.zo_walk(zeros, k, (n, n), ab)
        out.append(plain.dirnorm_order_sum(g * g, per))
    return torch.stack(out, dim=1)


def threefry_ops(evals, threads):
    """int32 operations of ``evals`` Threefry evaluations made by
    ``threads`` threads."""
    return evals * THREEFRY_EVAL_OPS + threads * THREEFRY_THREAD_OPS


def bound(nbytes, ops, kind):
    """Least time: the larger of bytes over HBM rate and operations over the
    peak rate of their type."""
    rate = {"int": INT32_OP_PER_S, "fp32": FP32_FLOP_PER_S,
            "bf16": BF16_FLOP_PER_S}[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bf16_ulp_err(torch, got, want, floor):
    """max |got - want| in units of the bfloat16 spacing at |want|, the
    spacing taken no finer than at ``floor``."""
    w = want.float().abs().clamp_min(floor)
    _, e = torch.frexp(w)                 # w = m * 2**e, m in [0.5, 1)
    spacing = torch.ldexp(torch.ones_like(w), e - 8)  # 8 significant bits
    return float(((got.float() - want.float()).abs() / spacing).max())


def check_lm_kernels(torch, ops, plain_rms, plain_flash):
    """Phase 2, transformer kernels. Returns {kernel: row of the JSON
    table, without launches}."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"
    rows, lines = {}, []

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    # rmsnorm: the block norms' [B*S, d_model] and a qk_norm's
    # [B*S*Hq, head_dim] rows. float32: elementwise relative 1e-5 (another
    # summation order of the mean square); bf16: 1 ulp of the output
    errs = []
    for r, d in ((LM_B * LM_S, LM_DM), (LM_B * LM_S * LM_HQ, LM_HD)):
        for dt in (torch.float32, torch.bfloat16):
            x, sc = rnd(r, d, dtype=dt), (1.0 + 0.1 * rnd(d)).to(dt)
            got = ops.rmsnorm(x, sc, eps=1e-6)
            want = plain_rms.rmsnorm_plain(x, sc, eps=1e-6)
            check(got.dtype == dt and got.shape == x.shape,
                  f"rmsnorm {dt}: output {got.dtype} {tuple(got.shape)}")
            if dt == torch.float32:
                rel = float(((got - want).abs()
                             / want.abs().clamp_min(1e-30)).max())
                check(rel <= 1e-5, f"rmsnorm fp32 [{r}, {d}]: rel {rel}")
                lines.append(f"rmsnorm fp32 [{r}, {d}]: max rel {rel:.2e}")
            else:
                u = bf16_ulp_err(torch, got, want, 1e-30)
                check(u <= 1, f"rmsnorm bf16 [{r}, {d}]: {u} bf16 ulp")
                lines.append(f"rmsnorm bf16 [{r}, {d}]: {u:.0f} bf16 ulp, "
                             f"bitwise {torch.equal(got, want)}")
            errs.append(float((got.float() - want.float()).abs().max()))
            check(torch.equal(got, plain_rms.rmsnorm_kernel_order(
                x, sc, eps=1e-6)), f"rmsnorm {dt} [{r}, {d}]: not its twin")
            # a view one element past a 16-byte boundary: scalar loads
            xo = torch.empty(r * d + 1, device=dev, dtype=dt)[1:].view(r, d)
            xo.copy_(x)
            check(torch.equal(ops.rmsnorm(xo, sc, eps=1e-6), got),
                  f"rmsnorm {dt} [{r}, {d}] at an odd offset differs")
    lines.append("rmsnorm: bitwise its twin (rmsnorm_kernel_order) at both "
                 "shapes and dtypes, and at an odd element offset")
    r, d = LM_B * LM_S, LM_DM
    x, sc = rnd(r, d), 1.0 + 0.1 * rnd(d)
    ms = median_ms(torch, lambda: ops.rmsnorm(x, sc, eps=1e-6), 100)
    plain_ms = median_ms(torch,
                         lambda: plain_rms.rmsnorm_plain(x, sc, eps=1e-6), 50)
    # yardstick only, never called by the port
    library_ms = median_ms(
        torch, lambda: F.rms_norm(x, (d,), weight=sc, eps=1e-6), 100)
    rows["rmsnorm"] = dict(
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:29", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(2 * r * d * 4 + d * 4, 4 * r * d, "fp32"))
    xb, scb = x.bfloat16(), sc.bfloat16()
    rows["rmsnorm"]["bf16"] = dict(
        ms=median_ms(torch, lambda: ops.rmsnorm(xb, scb), 100),
        plain_ms=median_ms(torch, lambda: plain_rms.rmsnorm_plain(xb, scb),
                           50),
        library_ms=median_ms(torch, lambda: F.rms_norm(
            xb, (d,), weight=scb, eps=1e-6), 100),
        **bound(2 * r * d * 2 + d * 2, 4 * r * d, "fp32"))
    for tag, f in (("fp32", rows["rmsnorm"]),
                   ("bf16", rows["rmsnorm"]["bf16"])):
        lines.append(f"rmsnorm {tag} [{r}, {d}]: ms {f['ms']:.5f} plain "
                     f"{f['plain_ms']:.5f} library {f['library_ms']:.5f} "
                     f"({f['ms'] / f['library_ms']:.2f}x F.rms_norm) bound "
                     f"{f['bound_ms']:.5f} ({f['bound_by']}, "
                     f"{f['bound_ms'] / f['ms']:.1%} of it)")
    xq = rnd(LM_B * LM_S * LM_HQ, LM_HD)
    sq = 1.0 + 0.1 * rnd(LM_HD)
    lines.append("rmsnorm fp32 [{}, {}]: ms {:.5f} library {:.5f}".format(
        *xq.shape, median_ms(torch, lambda: ops.rmsnorm(xq, sq), 100),
        median_ms(torch, lambda: F.rms_norm(xq, (LM_HD,), weight=sq,
                                            eps=1e-6), 100)))
    # a [G, D] scale (the client-batched forward: G clients' rows, each
    # group under its own scale row, read as a strided layer slice): bitwise
    # the twin at the batched Qwen2 forward's shapes, G = 1 and 4
    for lead, dd in (((LM_B * LM_S,), LM_DM),
                     ((QWEN_M, LM_B * LM_S), LM_DM),
                     ((QWEN_M, LM_B * LM_S * LM_HQ), LM_HD)):
        for dt in (torch.float32, torch.bfloat16):
            G = lead[0] if len(lead) > 1 else 1
            xg = rnd(*lead, dd, dtype=dt)
            scv = (1.0 + 0.1 * rnd(G, 3, dd)).to(dt)[:, 1]
            scv = scv if G > 1 else scv[0]
            check(torch.equal(ops.rmsnorm(xg, scv),
                              plain_rms.rmsnorm_kernel_order(xg, scv)),
                  f"rmsnorm {dt} G={G} {list(lead)}: not its twin")
    lines.append("rmsnorm: bitwise its twin with a [G, D] scale view, G = 1 "
                 "and 4, at the batched forward's shapes, both dtypes")
    # the same [512, 896] float32 rows as one group and as four, in turns
    scg = 1.0 + 0.1 * rnd(4, d)
    g1 = [median_ms(torch, lambda: ops.rmsnorm(x, sc, eps=1e-6), 100)]
    g4 = [median_ms(torch, lambda: ops.rmsnorm(x, scg, eps=1e-6), 100)]
    g1.append(median_ms(torch, lambda: ops.rmsnorm(x, sc, eps=1e-6), 100))
    g4.append(median_ms(torch, lambda: ops.rmsnorm(x, scg, eps=1e-6), 100))
    g1, g4 = min(g1), min(g4)
    rows["rmsnorm"]["groups4_ms"] = g4
    lines.append(f"rmsnorm fp32 [{r}, {d}]: G = 1 {g1:.5f} ms, G = 4 "
                 f"{g4:.5f} ms ({g4 / g1:.3f}x G = 1, {g4 / library_ms:.2f}x "
                 f"F.rms_norm)")
    xb4 = rnd(QWEN_M * r, d)
    sc4 = 1.0 + 0.1 * rnd(QWEN_M, d)
    lines.append("rmsnorm fp32 [{}, {}] G = {} (the batched flat round's "
                 "norms): ms {:.5f}".format(
                     QWEN_M * r, d, QWEN_M,
                     median_ms(torch, lambda: ops.rmsnorm(xb4, sc4), 100)))

    # flash attention, [B, S, H, D] layout. float32: max |err| within 1e-5
    # of max |out| (the dot products and the softmax sums run in another
    # order); bf16: 1 bf16 ulp of the output, the ulp taken no finer than at
    # 1e-5 * max |out| (below that the float32 reordering, not the final
    # rounding, decides which neighbour the two results round to)
    errs = []
    cases = [("main", LM_B, LM_S, True, 0), ("ragged S=100", 2, 100, True, 0),
             ("window 32", 2, LM_S, True, 32),
             ("non-causal S=100", 2, 100, False, 0),
             # several K/V tiles through the two staging buffers
             ("causal S=512", 1, 512, True, 0),
             ("ragged S=1000 window 256", 1, 1000, True, 256)]
    for name, b, sq, causal, window in cases:
        for dt in (torch.float32, torch.bfloat16):
            q = rnd(b, sq, LM_HQ, LM_HD, dtype=dt)
            k = rnd(b, sq, LM_HKV, LM_HD, dtype=dt)
            v = rnd(b, sq, LM_HKV, LM_HD, dtype=dt)
            got = ops.attention(q, k, v, causal=causal, window=window)
            want = plain_flash.flash_attention_plain(q, k, v, causal=causal,
                                                     window=window)
            check(got.dtype == dt and got.shape == q.shape,
                  f"attention {name}: output {got.dtype} {tuple(got.shape)}")
            top = float(want.float().abs().max())
            if dt == torch.float32:
                rel = float((got - want).abs().max()) / top
                check(rel <= 1e-5, f"attention {name} fp32: rel {rel}")
                lines.append(f"flash_attention {name} fp32: max err / max "
                             f"|out| {rel:.2e}")
            else:
                u = bf16_ulp_err(torch, got, want, 1e-5 * top)
                check(u <= 1, f"attention {name} bf16: {u} bf16 ulp")
                lines.append(f"flash_attention {name} bf16: {u:.2f} bf16 "
                             f"ulp, bitwise {torch.equal(got, want)}")
            errs.append(float((got.float() - want.float()).abs().max()))
    q = rnd(LM_B, LM_S, LM_HQ, LM_HD)
    k, v = rnd(LM_B, LM_S, LM_HKV, LM_HD), rnd(LM_B, LM_S, LM_HKV, LM_HD)

    def sdpa(q, k, v):
        # yardstick only, never called by the port: [B, H, S, D] views
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    ms = median_ms(torch, lambda: ops.attention(q, k, v, causal=True), 50)
    plain_ms = median_ms(
        torch, lambda: plain_flash.flash_attention_plain(q, k, v), 20)
    library_ms = median_ms(torch, lambda: sdpa(q, k, v), 50)
    pairs = LM_S * (LM_S + 1) // 2          # causal (q, k) pairs per head
    flops = 4 * LM_HD * pairs * LM_B * LM_HQ  # q.k and p.v multiply-adds
    nbytes = 4 * LM_B * LM_S * LM_HD * (2 * LM_HQ + 2 * LM_HKV)
    rows["flash_attention"] = dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:90",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, **bound(nbytes, flops, "fp32"))
    r = rows["flash_attention"]
    lines.append(
        f"flash_attention fp32 main: ms {ms:.5f} plain {plain_ms:.5f} library "
        f"{library_ms:.5f} ({ms / library_ms:.2f}x SDPA) bound "
        f"{r['bound_ms']:.5f} ({r['bound_by']}, {r['bound_ms'] / ms:.1%} of "
        f"it)")
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    bb = bound(nbytes // 2, flops, "bf16")
    ms_b = median_ms(torch, lambda: ops.attention(qb, kb, vb), 50)
    lib_b = median_ms(torch, lambda: sdpa(qb, kb, vb), 50)
    lines.append(
        "flash_attention bf16 main: ms {:.5f} plain {:.5f} library {:.5f} "
        "({:.2f}x SDPA) bound {:.5f} ({}, {:.1%} of it)".format(
            ms_b,
            median_ms(torch, lambda: plain_flash.flash_attention_plain(
                qb, kb, vb), 20),
            lib_b, ms_b / lib_b, bb["bound_ms"], bb["bound_by"],
            bb["bound_ms"] / ms_b))
    lines += check_attention_head_dims(torch, ops, plain_flash, rnd, rows)
    lines += check_classifier_kernels(torch, ops, plain_rms, plain_flash,
                                      rnd, rows)
    for line in lines:
        print(line)
    return rows


# head dims beyond the main shape's: 16 (the neural transformer track's
# d_model 32 over 2 heads; here with Qwen2-0.5B's 14 q over 2 kv heads) and
# 256 (Gemma-2B: 8 q heads over 1 kv head)
EXTRA_HEAD_DIMS = {16: (14, 2), 256: (8, 1)}


def attention_f64(torch, q, k, v, causal, window):
    """softmax(q kᵀ / √D + mask) v in float64 (GQA by head repetition), on
    q's device."""
    Sq, Hq, D = q.shape[1:]
    Sk, Hkv = k.shape[1], k.shape[2]
    kk, vv = (t.double().repeat_interleave(Hq // Hkv, 2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() / math.sqrt(D), kk)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)


def bf16_attention_errs(torch, q, k, v, got, want, causal, window):
    """(kernel vs plain, plain vs float64, kernel vs float64) in bf16 ulps,
    the ulp taken no finer than at 1e-5 · max |out|. The rule of the bf16
    design's CPU test (``tests/test_torch_lm_kernels.py``): the kernel is
    held within 1 ulp of the plain version, or 1 + r where the plain
    version's own float32 rounding puts it r > 1 ulp from the float64
    values (triangle inequality). At head dim 256 a score sums 256
    products, and on an H100 the plain version read up to 1.67 ulp from
    float64 while the kernel stayed within 1."""
    truth = attention_f64(torch, q, k, v, causal, window).float()
    floor = 1e-5 * float(truth.abs().max())
    return (bf16_ulp_err(torch, got, want, floor),
            bf16_ulp_err(torch, want, truth, floor),
            bf16_ulp_err(torch, got, truth, floor))


def check_attention_head_dims(torch, ops, plain_flash, rnd, rows):
    """Phase 2: flash attention at head dims 16 and 256, both dtypes, under
    the main shape's tolerances (causal, sliding window, GQA, ragged S), and
    timed against SDPA at [4, 128, Hq, D]. Returns the printed lines; the
    times go to the attention row's ``head_dims`` entry."""
    import torch.nn.functional as F
    lines, out = [], {}
    for hd, (hq, hkv) in EXTRA_HEAD_DIMS.items():
        cases = [("causal", LM_B, LM_S, True, 0),
                 ("window 32, ragged S=100", 2, 100, True, 32),
                 ("non-causal S=130", 1, 130, False, 0),
                 ("causal S=300", 1, 300, True, 0)]
        for name, b, sq, causal, window in cases:
            for dt in (torch.float32, torch.bfloat16):
                q = rnd(b, sq, hq, hd, dtype=dt)
                k = rnd(b, sq, hkv, hd, dtype=dt)
                v = rnd(b, sq, hkv, hd, dtype=dt)
                got = ops.attention(q, k, v, causal=causal, window=window)
                want = plain_flash.flash_attention_plain(
                    q, k, v, causal=causal, window=window)
                top = float(want.float().abs().max())
                tag = f"attention D={hd} {name} {str(dt)[6:]}"
                if dt == torch.float32:
                    rel = float((got - want).abs().max()) / top
                    check(rel <= 1e-5, f"{tag}: rel {rel}")
                    lines.append(f"{tag}: max err / max |out| {rel:.2e}")
                else:
                    u, r, t = bf16_attention_errs(torch, q, k, v, got, want,
                                                  causal, window)
                    check(u <= (1 if r <= 1 else 1 + r),
                          f"{tag}: {u} bf16 ulp from the plain version, "
                          f"which is {r} from float64")
                    lines.append(f"{tag}: {u:.2f} bf16 ulp from the plain "
                                 f"version ({r:.2f} from float64; the kernel "
                                 f"{t:.2f})")
        q = rnd(LM_B, LM_S, hq, hd)
        k, v = rnd(LM_B, LM_S, hkv, hd), rnd(LM_B, LM_S, hkv, hd)
        pairs = LM_S * (LM_S + 1) // 2
        flops = 4 * hd * pairs * LM_B * hq
        nbytes = 4 * LM_B * LM_S * hd * (2 * hq + 2 * hkv)
        for dt, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            ms = median_ms(torch, lambda: ops.attention(qd, kd, vd), 50)
            lib = median_ms(torch, lambda: F.scaled_dot_product_attention(
                qd.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
                is_causal=True, enable_gqa=True), 50)
            plain_ms = median_ms(torch, lambda: plain_flash
                                 .flash_attention_plain(qd, kd, vd), 10)
            bd = bound(nbytes // (1 if dt == torch.float32 else 2), flops,
                       kind)
            out[f"{hd} {kind}"] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib, **bd)
            lines.append(
                f"flash_attention D={hd} {kind} [{LM_B}, {LM_S}, {hq}/{hkv}, "
                f"{hd}] causal: ms {ms:.5f} plain {plain_ms:.4f} library "
                f"{lib:.5f} ({ms / lib:.2f}x SDPA) bound {bd['bound_ms']:.5f}"
                f" ({bd['bound_by']}, {bd['bound_ms'] / ms:.1%} of it)")
    rows["flash_attention"]["head_dims"] = out
    return lines


# the neural transformer track (workloads/neural.py): S = 8 patch tokens,
# 2 heads; head dim 16 at its default d_model 32, 8 at the reference's test
# and figure sizes (d_model 16). Batch rows: M.b1 = 250 on the flat round,
# M.b2.b1 = 5,000 on the wide route's perturbed cohort (M 10, b1 25, b2 20)
CLS_S, CLS_H, CLS_M, CLS_B1, CLS_B2 = 8, 2, 10, 25, 20


def check_classifier_kernels(torch, ops, plain_rms, plain_flash, rnd, rows):
    """Phase 2: flash attention at the transformer track's shapes (float32,
    causal, [250 or 5,000, 8, 2, 16 or 8]) against its plain version
    within 1e-5 of max |out| and timed beside SDPA; RMSNorm over the wide
    cohort's 200 groups of 200 rows of D = 32 and the flat round's 10 of
    200, bitwise its twin. Times go to the attention row's ``classifier``
    entry. Returns the printed lines."""
    import torch.nn.functional as F
    lines, out = [], {}
    pairs = CLS_S * (CLS_S + 1) // 2   # causal (q, k) pairs per head
    for hd in (16, 8):
        for b in (CLS_M * CLS_B1, CLS_M * CLS_B2 * CLS_B1):
            q, k, v = (rnd(b, CLS_S, CLS_H, hd) for _ in range(3))
            got = ops.attention(q, k, v)
            want = plain_flash.flash_attention_plain(q, k, v)
            rel = float((got - want).abs().max()) / float(want.abs().max())
            tag = f"attention [{b}, {CLS_S}, {CLS_H}, {hd}] fp32"
            check(rel <= 1e-5, f"{tag}: rel {rel}")
            ms = median_ms(torch, lambda: ops.attention(q, k, v), 50)
            lib = median_ms(torch, lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True), 50)
            plain_ms = median_ms(torch, lambda: plain_flash
                                 .flash_attention_plain(q, k, v), 10)
            # q, k, v read and out written; q.k and p.v multiply-adds
            bd = bound(4 * 4 * b * CLS_S * CLS_H * hd,
                       4 * hd * pairs * b * CLS_H, "fp32")
            out[f"{b}x{hd}"] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=lib, max_rel_err=rel, **bd)
            lines.append(
                f"{tag}: max err / max |out| {rel:.2e}; ms {ms:.5f} plain "
                f"{plain_ms:.4f} library {lib:.5f} ({ms / lib:.2f}x SDPA) "
                f"bound {bd['bound_ms']:.5f} ({bd['bound_by']}, "
                f"{bd['bound_ms'] / ms:.1%} of it)")
    rows["flash_attention"]["classifier"] = out
    for g in (CLS_M, CLS_M * CLS_B2):
        x = rnd(g, CLS_B1 * CLS_S, 32)
        sc = (1.0 + 0.1 * rnd(g, 3, 32))[:, 1]
        check(torch.equal(ops.rmsnorm(x, sc),
                          plain_rms.rmsnorm_kernel_order(x, sc)),
              f"rmsnorm [{g}, {CLS_B1 * CLS_S}, 32]: not its twin")
        ms = median_ms(torch, lambda: ops.rmsnorm(x, sc), 100)
        lines.append(f"rmsnorm fp32 [{g * CLS_B1 * CLS_S}, 32] in {g} "
                     f"groups: bitwise its twin; ms {ms:.5f}")
    return lines


def check_full_width(torch, ops, plain, plain_air):
    """Phase 2, the flat kernels at the Qwen2-0.5B train step's width: one
    client row of n_pad = 494,075,904, b2 = 8. Returns {kernel: fields for
    the row's ``full_width`` entry}. Same tolerances as at the round's
    shapes, except the norms: a float32 sum of 120,615 chunk partials (the
    kernel) against one of 7,539 block sums (the plain version) differs by
    about sqrt(n)·ulp of the total, so a relative 1e-4."""
    g = torch.Generator(device="cuda").manual_seed(3)
    dev = "cuda"
    x = torch.randn(1, QWEN_N_PAD, generator=g, device=dev) * 0.02
    k = torch.randint(0, 2 ** 32, (1, 2), generator=g, device=dev,
                      dtype=torch.int64)
    # the walk's and replay's own scales: mu/|v| and lr·coeff/(b2·|v|)
    ab = torch.randn(1, 2, generator=g, device=dev) * 5e-8
    c = torch.randn(1, QWEN_B2, generator=g, device=dev) * 1e-9
    # |v| <= 5.9 for Box-Muller on 24-bit uniforms: a bound on the summed
    # terms' magnitude for the 4-ulp check
    out, lines = {}, []

    got = ops.zo_walk(x, k, (3, 4), ab)
    want = plain.zo_walk_plain(x, k, (3, 4), ab)
    exact = torch.equal(got, want)
    u = 0.0 if exact else ulp_err(
        torch, got, want, x.abs() + 5.9 * ab.abs().sum(1, keepdim=True))
    check(u <= 4, f"zo_walk full width: {u} ulp")
    walk_err = float((got - want).abs().max())
    lines.append(f"zo_walk full width: bitwise {exact}, max_abs_err "
                 f"{walk_err:.3e}")
    del got, want
    got = ops.zo_replay(x, k, c)
    want = plain.zo_replay_plain(x, k, c)
    exact = torch.equal(got, want)
    u = 0.0 if exact else ulp_err(
        torch, got, want, x.abs() + 5.9 * c.abs().sum(1, keepdim=True))
    check(u <= 4, f"zo_replay full width: {u} ulp")
    replay_err = float((got - want).abs().max())
    lines.append(f"zo_replay full width: bitwise {exact}, max_abs_err "
                 f"{replay_err:.3e}")
    del got, want
    got = ops.zo_dirnorms(k, QWEN_D, b2=QWEN_B2)
    want = plain.zo_dirnorms_plain(k, QWEN_D, b2=QWEN_B2)
    rel = float(((got - want).abs() / want.abs()).max())
    check(rel <= 1e-4, f"zo_dirnorms full width: rel {rel}")
    check(torch.equal(got, ops.zo_dirnorms(k, QWEN_D, b2=QWEN_B2)),
          "zo_dirnorms full width: two calls differ")
    lines.append(f"zo_dirnorms full width: rel {rel:.2e}, two calls bitwise "
                 f"(norms^2/d {(got / QWEN_D).flatten().tolist()})")

    m, n, b2, d = 1, QWEN_N_PAD, QWEN_B2, QWEN_D
    per, chunks = plain.dirnorm_geometry(d, m * b2)
    # the finish alone (the last block's sum of an output's chunk partials),
    # launched as its own kernel on partials of the same shape
    parts = torch.rand(m * b2, chunks, generator=g, device=dev)
    fin = torch.empty(m * b2, device=dev)
    lib = ops.build.load()["zo_axpy"]

    def finish():
        ops._check(lib.zo_dirnorms_finish_launch(
            parts.data_ptr(), fin.data_ptr(), m * b2, chunks, ops._stream()),
            "zo_dirnorms finish")

    finish_ms = median_ms(torch, finish, 20)
    want_fin = parts.double().sum(1)
    check(float(((fin.double() - want_fin).abs() / want_fin).max()) <= 1e-5,
          "zo_dirnorms finish: not the sum of its partials")
    out["zo_walk"] = dict(
        max_abs_err=walk_err,
        ms=median_ms(torch, lambda: ops.zo_walk(x, k, (3, 4), ab), 8),
        plain_ms=median_ms(torch, lambda: plain.zo_walk_plain(
            x, k, (3, 4), ab), 1, trials=1),
        **bound(m * n * 8, threefry_ops(2 * m * n, m * n), "int"))
    out["zo_replay"] = dict(
        max_abs_err=replay_err,
        ms=median_ms(torch, lambda: ops.zo_replay(x, k, c), 8),
        plain_ms=median_ms(torch, lambda: plain.zo_replay_plain(x, k, c), 1,
                           trials=1),
        **bound(m * n * 8 + m * b2 * 4, threefry_ops(b2 * m * n, m * n),
                "int"))
    out["zo_dirnorms"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=median_ms(torch, lambda: ops.zo_dirnorms(k, d, b2=b2), 8),
        plain_ms=median_ms(torch, lambda: plain.zo_dirnorms_plain(
            k, d, b2=b2), 1, trials=1),
        finish_ms=finish_ms, evals_per_thread=per, chunks=chunks,
        **bound(m * 16 + m * b2 * 4,
                threefry_ops(m * b2 * d, m * b2 * chunks * 256), "int"))
    for name, f in out.items():
        lines.append(f"{name} full width: ms {f['ms']:.4f} plain "
                     f"{f['plain_ms']:.1f} bound {f['bound_ms']:.4f} "
                     f"({f['bound_by']}, {f['bound_ms'] / f['ms']:.1%} of it)")
    lines.append(f"zo_dirnorms full width: finish alone {finish_ms:.5f} ms "
                 f"({chunks} partials an output, {per} evaluations a thread)")
    del x, got, want, parts
    torch.cuda.empty_cache()

    # aircomp_reduce at the flat Qwen2-0.5B AirComp round: M = 4 client
    # deltas of n_pad. The norms within 1e-4 relative of the plain version
    # (the full-width dirnorms argument: a float32 sum of ~7,500 block sums
    # against one of ~460 tile totals a block, each off by about
    # sqrt(n)·ulp of the total) and bitwise the twin
    ma = QWEN_M
    x = torch.randn(ma, QWEN_N_PAD, generator=g, device=dev) * 1e-5
    s = torch.rand(ma, generator=g, device=dev)
    mean, sq = ops.aircomp_reduce(x, s, QWEN_D)
    pmean, psq = plain_air.aircomp_reduce_plain(x, s, QWEN_D)
    check(torch.equal(mean, pmean), "aircomp_reduce full width: mean differs")
    rel = float(((sq - psq).abs() / psq).max())
    check(rel <= 1e-4, f"aircomp_reduce full width: sq rel {rel}")
    err = max(float((mean - pmean).abs().max()), float((sq - psq).abs().max()))
    del pmean, psq
    per_a, grid_a = ops.aircomp_geometry(QWEN_N_PAD, x.device)
    check(torch.equal(sq, plain_air.aircomp_sq_order_sum(
        x, QWEN_D, per=per_a, grid=grid_a)),
          "aircomp_reduce full width: sq not its twin")
    f = aircomp_times(torch, ops, plain_air, x, s, QWEN_D, 8)
    f["max_abs_err"] = err
    out["aircomp_reduce"] = f
    lines = [f"aircomp_reduce full width: mean bitwise, sq rel {rel:.2e}, sq "
             f"bitwise its twin (per {per_a}, grid {grid_a})",
             aircomp_line(f"[{ma}, {QWEN_N_PAD}]", f)]
    for line in lines:
        print(line)
    return out


def check_axpy_kernels(torch, ops, plain):
    """Phase 2, zo_axpy and zo_axpy2: bitwise against their plain versions
    (both round the product, then the sum, in float32; the build never
    contracts them into an FMA). Returns {kernel: row of the JSON table,
    without launches}."""
    g = torch.Generator(device="cuda").manual_seed(4)
    dev, f32, bf16 = "cuda", torch.float32, torch.bfloat16
    lines, errs = [], {"zo_axpy": [], "zo_axpy2": []}

    def view(shape, dt, off):
        base = torch.randn(math.prod(shape) + off, generator=g,
                           device=dev).to(dt)
        return base[off:].view(shape)

    # the pytree route's scalars: mu and lr*c_n/b2, tensors on the card
    a, b = torch.randn(2, generator=g, device=dev) * 1e-3
    cases = [((1,), (0, 0, 0)), ((7,), (0, 0, 0)), ((65_537,), (0, 0, 0)),
             ((65_537,), (1, 1, 1)), ((65_537,), (3, 0, 5)),
             (QWEN_EMBED, (0, 0, 0)), (QWEN_W_GATE, (0, 0, 0))]
    for dts in itertools.product((f32, bf16), repeat=3):
        for shape, offs in cases:
            x, u, v = (view(shape, dt, off) for dt, off in zip(dts, offs))
            tag = (f"{'/'.join(str(t)[6:] for t in dts)} {list(shape)} "
                   f"offsets {offs}")
            got = ops.axpy(x, u, a)
            want = plain.zo_axpy_plain(x, u, a)
            check(got.dtype == x.dtype and torch.equal(got, want),
                  f"zo_axpy {tag} differs")
            errs["zo_axpy"].append(float((got.float() - want.float())
                                         .abs().max()))
            got = ops.axpy2(x, u, v, a, b)
            want = plain.zo_axpy2_plain(x, u, v, torch.stack([a, b]))
            check(got.dtype == x.dtype and torch.equal(got, want),
                  f"zo_axpy2 {tag} differs")
            errs["zo_axpy2"].append(float((got.float() - want.float())
                                          .abs().max()))
            del x, u, v, got, want
    lines.append(f"zo_axpy, zo_axpy2: bitwise in all {len(errs['zo_axpy'])} "
                 f"cases (8 dtype mixes, ragged, offsets, Qwen2 leaves)")
    # times at the embedding leaf in float32: each array read once, the
    # output written once; two flops per term
    x, u, v = (view(QWEN_EMBED, f32, 0) for _ in range(3))
    n = x.numel()
    mu = torch.full((), 1e-3, device=dev)
    rows = {
        "zo_axpy": dict(
            source="src/repro_torch/kernels/csrc/axpy.cu",
            replaces="src/repro/kernels/zo_axpy.py:103",
            max_abs_err=max(errs["zo_axpy"]),
            ms=median_ms(torch, lambda: ops.axpy(x, u, mu), 20),
            plain_ms=median_ms(torch, lambda: plain.zo_axpy_plain(x, u, mu),
                               5),
            # yardstick only, never called by the port
            library_ms=median_ms(torch, lambda: torch.add(x, u, alpha=1e-3),
                                 20),
            **bound(12 * n, 2 * n, "fp32")),
        "zo_axpy2": dict(
            source="src/repro_torch/kernels/csrc/axpy.cu",
            replaces="src/repro/kernels/zo_axpy.py:80",
            max_abs_err=max(errs["zo_axpy2"]),
            ms=median_ms(torch, lambda: ops.axpy2(x, u, v, -mu, mu), 20),
            plain_ms=median_ms(torch, lambda: plain.zo_axpy2_plain(
                x, u, v, torch.stack([-mu, mu])), 5),
            library_ms=None, **bound(16 * n, 4 * n, "fp32"))}
    # bf16 weights moved by a float32 direction, and float32 weights by a
    # bf16 tree-convention direction
    for tag, xx, uu, per in (("bf16 x, f32 u", x.bfloat16(), u, 8),
                             ("f32 x, bf16 u", x, u.bfloat16(), 10)):
        ms_b = median_ms(torch, lambda: ops.axpy(xx, uu, mu), 20)
        bound_b = bound(per * n, 2 * n, "fp32")["bound_ms"]
        lines.append("zo_axpy {} {}: ms {:.5f} plain {:.5f} library {:.5f} "
                     "bound {:.5f} ({:.1%} of it)".format(
                         tag, list(QWEN_EMBED), ms_b,
                         median_ms(torch, lambda: plain.zo_axpy_plain(
                             xx, uu, mu), 5),
                         median_ms(torch, lambda: torch.add(
                             xx, uu, alpha=1e-3), 20),
                         bound_b, bound_b / ms_b))
    # a direction that is a view at an odd element offset (the counter
    # convention slices one flat buffer) takes the scalar loop throughout
    uo = view(QWEN_EMBED, f32, 1)
    lines.append("zo_axpy float32 {}, u at element offset 1 (scalar loop): "
                 "ms {:.5f} bound {:.5f}".format(
                     list(QWEN_EMBED),
                     median_ms(torch, lambda: ops.axpy(x, uo, mu), 20),
                     rows["zo_axpy"]["bound_ms"]))
    del uo
    for name, per in (("zo_axpy", 12), ("zo_axpy2", 16)):
        r = rows[name]
        lines.append(f"{name} float32 {list(QWEN_EMBED)}: ms {r['ms']:.5f} "
                     f"plain {r['plain_ms']:.5f} library {r['library_ms']} "
                     f"bound {r['bound_ms']:.5f} ({r['bound_by']}, "
                     f"{r['bound_ms'] / r['ms']:.1%} of it); whole "
                     f"Qwen2-0.5B tree ({QWEN_D:,} float32) bound "
                     f"{per * QWEN_D / HBM_BYTES_PER_S * 1e3:.3f} ms")
    for line in lines:
        print(line)
    return rows


def run_main_path(torch, ops, neural, FedZOConfig):
    """Phase 3. Returns {kernel: launches summed over the runs}."""
    softmax = neural.make_task("softmax", n_features=784, n_classes=10,
                               n_clients=50)
    cnn = neural.make_task("cnn", image_shape=(28, 28, 1), width=8,
                           n_clients=50)
    base = dict(flat_params=True, weight_by_size=True)
    air = dict(aircomp=True, channel_schedule=True, snr_db=5.0)
    runs = [("softmax_flat", softmax, FedZOConfig(**base), 5),
            ("softmax_aircomp", softmax, FedZOConfig(**base, **air), 5),
            ("cnn_flat", cnn, FedZOConfig(**base), 2),
            # the pytree route, the reference's default (flat_params off)
            ("softmax_pytree", softmax, FedZOConfig(weight_by_size=True), 2),
            ("softmax_aircomp_pytree", softmax,
             FedZOConfig(weight_by_size=True, **air), 1)]
    return drive_runs(torch, ops, neural, [
        (name, task, cfg, rounds,
         round_launches(ops, cfg, rounds, 2 if task is softmax else 4),
         "local")
        for name, task, cfg, rounds in runs])


# the least fall of the test loss, as a share of the starting weights' test
# loss, that the "test" descent rule accepts
TEST_DESCENT = 0.02


def drive_runs(torch, ops, neural, runs):
    """Drive each ``(name, task, cfg, rounds, want, descend)`` run
    through ``neural.run``, one round per call with the carry passed back
    in, so each round is timed on its own. The launch counters are set to
    0 before the run and must equal ``want`` after it; the test set is
    evaluated once, after the counts. Checks that metrics, evals and
    weights are finite and that the loss went down by the run's rule:
    ``"local"``, the last round's mean local loss below the first
    iterate's loss of round 1; ``"test"``, the test loss at least
    ``TEST_DESCENT`` of the start below that of the starting weights (the
    transformer track's per-round losses on fresh batches move by more
    than a round's progress); None, no check (a run of one round of one
    iterate); ``"mean"``, the last round's mean local loss below the first
    round's (FedAvg, whose metrics have no first-iterate loss). A run's
    strategy (``cfg.strategy``) carries its state from round to round.
    Prints ms per round, the peak memory and the counts. Returns {kernel:
    launches summed over the runs}."""
    from repro_torch.utils.tree import tree_leaves
    total = {k: 0 for k in ops.LAUNCHES}
    for name, task, cfg, rounds, want, descend in runs:
        if descend == "test":
            before = float(neural.task_eval(task)(neural.params_init(
                task, cfg.seed))["test_loss"])
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        params = key = momentum = zstate = None
        per_round, mets = [], {}
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = neural.run(task, cfg, 1, eval_every=0, params=params,
                             key=key, momentum=momentum, zstate=zstate)
            torch.cuda.synchronize()
            per_round.append(1e3 * (time.perf_counter() - t0))
            params, key, momentum, zstate = (res.params, res.key,
                                             res.momentum,
                                             res.strategy_state)
            for k, v in res.metrics.items():
                mets.setdefault(k, []).extend(v.cpu().tolist())
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(counts == want, f"{name}: launches {counts} != {want}")
        evals = {k: float(v)
                 for k, v in neural.task_eval(task)(params).items()}
        for k, v in list(mets.items()) + [(k, [v]) for k, v in evals.items()]:
            check(all(map(math.isfinite, v)), f"{name}: {k} not finite: {v}")
        for p in tree_leaves(params):
            check(bool(torch.isfinite(p).all()), f"{name}: param not finite")
        if descend == "local":
            check(mets["mean_local_loss"][-1] < mets["first_loss"][0],
                  f"{name}: loss did not descend: {mets}")
        elif descend == "mean":
            check(mets["mean_local_loss"][-1] < mets["mean_local_loss"][0],
                  f"{name}: loss did not descend: {mets}")
        elif descend == "test":
            check(evals["test_loss"] <= (1 - TEST_DESCENT) * before,
                  f"{name}: test loss {evals['test_loss']} not "
                  f"{TEST_DESCENT:.0%} below {before} at the start")
        # round 1 carries one-time set-up (a one-round run has only it)
        steady = sorted(per_round[1:]) or per_round
        print(f"{name}: ms/round {[round(t, 3) for t in per_round]} "
              f"(median after round 1 {steady[len(steady) // 2]:.3f}); peak "
              f"memory {peak:.3f} GiB; launches {counts}")
        print(f"{name}: metrics {json.dumps(mets)}")
        print(f"{name}: evals {json.dumps(evals)}")
        for k in total:
            total[k] += counts[k]
    return total


# the transformer track's stack: 1 layer, 12 parameter leaves
CLS_LAYERS, CLS_LEAVES = 1, 12


def round_launches(ops, cfg, rounds, n_leaves=0, L=0):
    """Launches of ``rounds`` simulated rounds of a model with ``n_leaves``
    parameter leaves whose forward runs 2L + 1 RMSNorms and L attentions.
    Per iterate: on the flat route b2 walks, one replay, one norms launch
    and b2 + 1 batched forwards (one launch covers the cohort, whatever M
    is); on the pytree route 2·b2 zo_axpy per client and leaf and M·(b2 +
    1) forwards; on the wide route no walk, replay or norms (its directions
    come from the torch Threefry chain) and two batched forwards, the base
    and the M·b2 perturbed copies (three with a central difference).
    AirComp adds its reduction and the noise walk on the flat and wide
    routes."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    iters = rounds * cfg.local_iters
    air = rounds if cfg.aircomp else 0
    if cfg.batch_directions:
        want.update(zo_walk=air, aircomp_reduce=air)
        forwards = iters * (3 if cfg.central else 2)
    elif cfg.flat_params:
        want.update(zo_walk=iters * cfg.b2 + air, zo_replay=iters,
                    zo_dirnorms=iters, aircomp_reduce=air)
        forwards = iters * (cfg.b2 + 1)
    else:
        want["zo_axpy"] = (iters * cfg.n_participating * 2 * cfg.b2
                           * n_leaves)
        forwards = iters * cfg.n_participating * (cfg.b2 + 1)
    if L:
        want.update(rmsnorm=forwards * (2 * L + 1),
                    flash_attention=forwards * L)
    return want


def run_track_rounds(torch, ops, neural, FedZOConfig):
    """Phase 3, the transformer track and the wide route, at the other
    rounds' settings (N = 50, M = 10, H = 5, b1 = 25, b2 = 20, size-
    weighted): the track at its defaults (784 features in 8 patch tokens,
    d_model 32 over 2 heads, d_ff 64, 1 layer; d = 12,000) and at its own
    lr (``neural.default_config``: 5e-3 where the softmax runs take
    FedZOConfig's 1e-3) on the flat route 3 rounds, flat with AirComp 2
    rounds, and one pytree round cut to H = 1 (a whole one is 24,000
    zo_axpy launches), also with bfloat16 tree-convention directions
    (sphere and gaussian: float32 weights, bfloat16 directions into
    zo_axpy); the wide route (``batch_directions``) on softmax and on the
    track with ``block`` directions, 3 rounds each, and on softmax one
    round each of ``tree``, ``channel``, ``surrogate`` and ``block`` with
    AirComp. Returns {kernel: launches}."""
    softmax = neural.make_task("softmax", n_features=784, n_classes=10,
                               n_clients=50)
    track = neural.make_task("transformer", n_clients=50)
    base = dict(weight_by_size=True)
    flat = dict(flat_params=True)
    wide = dict(batch_directions=True, direction_conv="block")
    air = dict(aircomp=True, channel_schedule=True, snr_db=5.0)
    bf16 = dict(local_iters=1, direction_dtype="bfloat16")

    def on_track(**kw):
        return neural.default_config(track, n_participating=10, **kw)

    def conv(c):
        return FedZOConfig(**base, **dict(wide, direction_conv=c))

    runs = [("transformer_flat", track, on_track(**flat), 3),
            ("transformer_aircomp", track, on_track(**flat, **air), 2),
            ("transformer_pytree", track, on_track(local_iters=1), 1),
            ("transformer_pytree_bf16_sphere", track, on_track(**bf16), 1),
            ("transformer_pytree_bf16_gaussian", track,
             on_track(**bf16, estimator="gaussian"), 1),
            ("softmax_wide", softmax, FedZOConfig(**base, **wide), 3),
            ("transformer_wide", track, on_track(**wide), 3),
            ("softmax_wide_tree", softmax, conv("tree"), 1),
            ("softmax_wide_channel", softmax, conv("channel"), 1),
            ("softmax_wide_surrogate", softmax, conv("surrogate"), 1),
            ("softmax_wide_aircomp", softmax,
             FedZOConfig(**base, **wide, **air), 1)]
    print(f"transformer_pytree: cut to H = 1 (a round of H = 5 is "
          f"{5 * 10 * 2 * 20 * CLS_LEAVES:,} zo_axpy launches)")
    total = drive_runs(torch, ops, neural, [
        (name, task, cfg, rounds,
         round_launches(ops, cfg, rounds,
                        CLS_LEAVES if task is track else 2,
                        CLS_LAYERS if task is track else 0),
         None if cfg.local_iters == 1
         else "test" if task is track else "local")
        for name, task, cfg, rounds in runs])
    # where a round's time goes: one more round of three runs under the
    # profiler (not counted in the launches)
    for name, task, cfg, _ in runs:
        if name not in ("transformer_flat", "softmax_wide",
                        "transformer_wide"):
            continue
        wall, busy, kinds = kernel_time_by_kind(
            torch, lambda: neural.run(task, cfg, 1, eval_every=0))
        print(f"{name}, profiled round: wall {wall:.1f} ms, kernel time "
              f"{sum(kinds.values()):.2f} ms, busy share {busy:.3f}; by kind "
              f"(ms) {json.dumps({k: round(v, 3) for k, v in kinds.items()})}")
    return total


def lm_setup(arch, dtype):
    """(model, train-step config, token stream) of the cross-silo train
    step as ``repro/launch/train.py`` sets it up, for ``arch``."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_token_stream
    from repro_torch.models import api
    cfg = get_config(arch).replace(dtype=dtype)
    model = api.build(cfg)
    # the launcher's synthetic stream: 200k tokens over a 4096-token subset
    toks = lm_token_stream(200_000, min(cfg.vocab, 4096), seed=0)
    return model, toks


def lm_batch(torch, toks, rng, batch, seq, device):
    from repro_torch.data.synthetic import lm_batches
    b = lm_batches(toks, batch, seq, rng)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def run_qwen_train(torch, ops, FedZOConfig, steps=4, profile_dir=None):
    """Phase 3, the Qwen2-0.5B train step at full width. Returns {kernel:
    launches summed over the steps}."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten

    model, toks = lm_setup("qwen2-0.5b", "float32")
    cfg = model.cfg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(prng.key(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spec = flat_spec(params)
    check(spec.d == QWEN_D and spec.n_pad == QWEN_N_PAD,
          f"qwen2-0.5b: d {spec.d}, n_pad {spec.n_pad}")
    fcfg = FedZOConfig(lr=1e-4, mu=1e-3, b2=QWEN_B2, estimator="sphere",
                       flat_params=True)
    step = fedzo.make_train_step(model.loss, fcfg)
    rng, key = np.random.default_rng(0), prng.key(1)
    L = cfg.n_layers
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(zo_walk=fcfg.b2, zo_replay=1, zo_dirnorms=1,
                rmsnorm=(1 + fcfg.b2) * (2 * L + 1),
                flash_attention=(1 + fcfg.b2) * L)
    total = {k: 0 for k in ops.LAUNCHES}
    per_step, losses, norms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        batch = lm_batch(torch, toks, rng, 4, 128, "cuda")
        ks = prng.split(key, 2)
        key, sub = ks[0], ks[1]
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, mets = step(params, batch, sub)
        torch.cuda.synchronize()
        per_step.append(1e3 * (time.perf_counter() - t0))
        counts = dict(ops.LAUNCHES)
        check(counts == want, f"qwen2-0.5b step: launches {counts} != {want}")
        for k in total:
            total[k] += counts[k]
        losses.append(float(mets["loss"]))
        norms.append(float(mets["coeff_norm"]))
    peak = torch.cuda.max_memory_allocated()
    for name, vals in (("loss", losses), ("coeff_norm", norms)):
        check(all(map(math.isfinite, vals)), f"qwen2-0.5b: {name} {vals}")
    check(bool(torch.isfinite(flatten(params, spec)).all()),
          "qwen2-0.5b: parameters not finite")
    steady = sorted(per_step[1:])  # step 1 carries one-time set-up
    print(f"qwen2_0_5b_train: d {spec.d} n_pad {spec.n_pad}; init "
          f"{init_s:.2f} s; ms/step {[round(t, 2) for t in per_step]} "
          f"(median after step 1 {steady[len(steady) // 2]:.2f}); peak "
          f"memory {peak / 2**30:.2f} GiB; launches per step {want}")
    print(f"qwen2_0_5b_train: loss {losses} coeff_norm {norms}")
    # one more full-width step from these weights, at a mu where every loss
    # difference is hundreds of ulps, against an independent recomputation
    batch = lm_batch(torch, toks, rng, 4, 128, "cuda")
    ks = prng.split(key, 2)
    key, sub = ks[0], ks[1]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = check_estimator(model, params, batch, sub, "cuda", mu=QWEN_CHECK_MU)
    print(f"qwen2_0_5b estimator check: {time.perf_counter() - t0:.1f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; mu {r['mu']}, loss {r['loss']} (ulp "
          f"{r['ulp']:.3e}); |L(x+mu.v_n) - L(x)| in ulps "
          f"{[round(u, 1) for u in r['diff_ulps']]} (least allowed "
          f"{CHECK_MIN_ULPS}); coefficients {r['coeffs']}; recomputed "
          f"{r['ref']}; largest relative error {r['max_rel_err']:.3e}, "
          f"largest error / tolerance {r['max_err_over_tol']:.3f}")
    if profile_dir:
        batch = lm_batch(torch, toks, rng, 4, 128, "cuda")
        profile_call(torch, lambda: step(params, batch, key),
                     profile_dir, "qwen2_train_step")
    return total


# kernel kinds of a profiled flat round, by a piece of the kernel's name
KERNEL_KINDS = (("flash_attention", ("flash_fwd",)),
                ("rmsnorm", ("rmsnorm",)),
                ("zo_walk", ("zo_walk",)), ("zo_replay", ("zo_replay",)),
                ("zo_dirnorms", ("dirnorm",)),
                ("aircomp_reduce", ("aircomp_reduce",)),
                ("float32 GEMM", ("gemm", "xmma", "cutlass", "Kernel2")))


def kernel_time_by_kind(torch, fn):
    """``fn()`` once under torch.profiler: wall ms, device busy share and
    kernel ms by kind (``KERNEL_KINDS``, the rest as "other")."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kinds = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(w in e.key for w in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    busy = sum(kinds.values())
    return wall, busy / wall, dict(sorted(kinds.items(),
                                          key=lambda kv: -kv[1]))


def run_qwen_flat_round(torch, ops, FedZOConfig):
    """Phase 3, the flat FedZO round on Qwen2-0.5B at full width and depth
    in float32 (random weights from seed 0) through
    ``fedzo.round_simulated``: M = 4 clients, H = 2 iterates each on batch
    4 x seq 128 of the synthetic LM stream, b2 = 8 sphere directions,
    mu = 1e-3, lr = 1e-4; one round with the plain mean, one with AirComp
    (channel scheduling, 5 dB). The cohort's forwards run through the
    model's client-batched loss, so the launch counts are those of one
    client. Then the batched loss against each client's own ``model.loss``
    and a profiled AirComp round (kernel time by kind). Returns the
    launches of the two counted rounds."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten
    from repro_torch.utils.tree import tree_leaves

    model, toks = lm_setup("qwen2-0.5b", "float32")
    L, m, h = model.cfg.n_layers, QWEN_M, QWEN_H
    params = model.init(prng.key(0), device="cuda")
    spec = flat_spec(params)
    rng = np.random.default_rng(1)
    per = [lm_batch(torch, toks, rng, LM_B, LM_S, "cuda")
           for _ in range(m * h)]
    batches = {k: torch.stack([b[k] for b in per]).reshape(
        (m, h, LM_B, LM_S)) for k in ("tokens", "labels")}
    keys = prng.split(prng.key(1), m)
    base = dict(n_participating=m, local_iters=h, lr=1e-4, mu=1e-3,
                b2=QWEN_B2, estimator="sphere", flat_params=True)
    cfgs = {"mean": FedZOConfig(**base),
            "aircomp": FedZOConfig(**base, aircomp=True,
                                   channel_schedule=True, snr_db=5.0)}
    total = dict.fromkeys(ops.LAUNCHES, 0)
    mem = 4 * spec.n_pad
    print(f"qwen flat round: d {spec.d}, n_pad {spec.n_pad}; expected peak "
          f"about {(2 + 3 * m) * mem / 2**30:.1f} GiB of buffers (weights "
          f"and buf0, {m * mem / 2**30:.2f} GiB for each [M, n_pad] of the "
          f"cohort, the walked copy and the deltas) plus the forward's "
          f"[{m * LM_B * LM_S}, {model.cfg.vocab}] float32 logits "
          f"({m * LM_B * LM_S * model.cfg.vocab * 4 / 2**30:.2f} GiB)")
    for name, cfg in cfgs.items():
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, met = fedzo.round_simulated(model.loss, params, batches, keys,
                                         cfg, channel_rng=prng.key(2))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(ops.LAUNCHES)
        want = round_launches(ops, cfg, 1, L=L)
        check(counts == want, f"qwen flat round {name}: launches {counts} "
              f"!= {want}")
        for k in total:
            total[k] += counts[k]
        mets = {k: float(v) for k, v in met.items()}
        check(all(map(math.isfinite, mets.values())),
              f"qwen flat round {name}: metrics {mets}")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(new)),
              f"qwen flat round {name}: parameters not finite")
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(new), tree_leaves(params)))
        check(moved > 0, f"qwen flat round {name}: no weight moved")
        del new
        print(f"qwen flat round {name}: M {m}, H {h}, b2 {cfg.b2}: ms/round "
              f"{ms:.1f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"metrics {json.dumps(mets)}; largest weight move {moved:.3e};"
              f" launches {counts} (M-independent)")
        torch.cuda.empty_cache()

    # the batched loss on m clients' own weights (the server weights plus a
    # per-client offset, as views of one [m, n_pad] buffer) against each
    # client's own loss: the RMSNorm and attention launches are the same
    # rows either way, the batched GEMMs may take other cuBLAS algorithms,
    # so 1e-5 relative, as the card-vs-CPU loss checks allow
    g = torch.Generator(device="cuda").manual_seed(5)
    buf = flatten(params, spec)[None].repeat(m, 1)
    buf += 1e-3 * torch.randn(buf.shape, generator=g, device="cuda")
    b0 = {k: v[:, 0] for k, v in batches.items()}
    got = model.loss_batched(unflatten(buf, spec), b0)
    each = torch.stack([model.loss(unflatten(buf[i], spec),
                                   {k: v[i] for k, v in b0.items()})
                        for i in range(m)])
    rel = float(((got - each).abs() / each.abs()).max())
    ulp = torch.nextafter(each, torch.full_like(each, math.inf)) - each
    check(rel <= 1e-5, f"qwen batched loss vs each client: rel {rel}")
    print(f"qwen batched loss: {got.tolist()} against each client's own "
          f"{each.tolist()}: rel {rel:.2e} "
          f"({float(((got - each).abs() / ulp).max()):.1f} ulps)")
    del buf
    torch.cuda.empty_cache()
    wall, busy, kinds = kernel_time_by_kind(
        torch, lambda: fedzo.round_simulated(
            model.loss, params, batches, keys, cfgs["aircomp"],
            channel_rng=prng.key(2)))
    print(f"qwen flat round aircomp, profiled: wall {wall:.1f} ms, kernel "
          f"time {sum(kinds.values()):.1f} ms, busy share {busy:.3f}; by "
          f"kind (ms) {json.dumps({k: round(v, 3) for k, v in kinds.items()})}")
    return total


def check_estimator(model, params, batch, key, device, *, mu, b2=QWEN_B2,
                    min_ulps=CHECK_MIN_ULPS, tol_ulps=CHECK_TOL_ULPS,
                    norm_rel=CHECK_NORM_REL):
    """Hold one flat-route sphere step to the estimator's definition.

    ``fedzo.local_iterate`` (the walk, the norms kernel, the loss
    forwards) returns the b2 coefficients and the base loss at ``mu``. Each
    is recomputed without a ZO kernel: v_n from the plain counter-convention
    generator (``kernels/zo_axpy.counter_direction_flat``) on ``device``,
    its norm summed in float64, L_n = loss(x + mu.v_n/|v_n|) and
    c_n = d.(L_n - L_0)/mu by the estimator's formula
    (``core/estimator.py:flat_coefficients``). Raises, with the readings,
    unless every |L_n - L_0| is at least ``min_ulps`` float32 ulps of L_0 (so
    the coefficients are a signal, not rounding) and every c_n is within
    d.tol_ulps.ulp/mu + norm_rel.|ref_n| of its recomputation, and the base
    loss within tol_ulps ulps of L_0. Returns the readings."""
    import torch
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.core import fedzo
    from repro_torch.kernels.zo_axpy import counter_direction_flat
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten

    cfg = FedZOConfig(mu=mu, b2=b2, estimator="sphere", flat_params=True)
    _, coeffs, base = fedzo.local_iterate(model.loss, params, batch, key,
                                          cfg)
    spec = flat_spec(params)
    d = spec.d
    x = flatten(params, spec)
    loss0 = model.loss(params, batch).to(torch.float32)
    ulp = float(torch.nextafter(loss0, torch.full_like(loss0, math.inf))
                - loss0)
    kdev = key.to(device)
    ref, diffs = [], []
    for n in range(b2):
        g = counter_direction_flat(kdev, n, d, kind="normal")
        norm = math.sqrt(float(torch.sum(torch.square(g.double()))))
        xp = x.clone()
        xp[:d] += (mu / norm) * g
        del g
        ln = model.loss(unflatten(xp, spec), batch).to(torch.float32)
        del xp
        diffs.append(float(ln - loss0) / ulp)
        ref.append(float(float(d) * (ln - loss0).to(torch.float32) / mu))
    coeffs = [float(c) for c in coeffs.reshape(-1)]
    unit = d * ulp / mu          # one loss ulp in a coefficient
    tols = [tol_ulps * unit + norm_rel * abs(r) for r in ref]
    errs = [abs(c - r) for c, r in zip(coeffs, ref)]
    out = dict(mu=mu, loss=float(loss0), base=float(base), ulp=ulp,
               diff_ulps=diffs, coeffs=coeffs, ref=ref,
               max_rel_err=max(e / abs(r) for e, r in zip(errs, ref)),
               max_err_over_tol=max(e / t for e, t in zip(errs, tols)))
    check(all(abs(u) >= min_ulps for u in diffs),
          f"estimator check: a loss difference below {min_ulps} ulps at mu "
          f"{mu}, the coefficients would be rounding: {out}")
    check(abs(float(base) - float(loss0)) <= tol_ulps * ulp,
          f"estimator check: base loss {float(base)} against {float(loss0)}")
    check(all(e <= t for e, t in zip(errs, tols)),
          f"estimator check: a coefficient differs from its recomputation "
          f"by more than its tolerance: {out}")
    return out


def run_tree_axpy2(torch, ops, plain):
    """Phase 3, ``ops.tree_axpy2`` (the MeZO unperturb-and-reperturb pass)
    once over the full-width Qwen2-0.5B tree in float32: x the weights, u
    and v two sphere directions, (a, b) = (-mu, +mu) with mu = 1e-3 on the
    card. One zo_axpy2 per leaf; each leaf bitwise its plain version.
    Returns the launches."""
    from repro_torch.core import estimator
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import _leaves

    model, _ = lm_setup("qwen2-0.5b", "float32")
    params = model.init(prng.key(0), device="cuda")
    u = estimator.sample_direction(prng.key(7), params, "sphere")
    v = estimator.sample_direction(prng.key(8), params, "sphere")
    mu = torch.full((), 1e-3, device="cuda")
    ops.reset_launches()
    out = ops.tree_axpy2(params, u, v, -mu, mu)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["zo_axpy2"] = QWEN_LEAVES
    check(counts == want, f"tree_axpy2: launches {counts} != {want}")
    ab = torch.stack([-mu, mu])
    for (path, got), (_, x), (_, uu), (_, vv) in zip(
            _leaves(out), _leaves(params), _leaves(u), _leaves(v)):
        check(torch.equal(got, plain.zo_axpy2_plain(x, uu, vv, ab)),
              f"tree_axpy2 leaf {'/'.join(path)} differs")
    print(f"tree_axpy2 (Qwen2-0.5B, {len(_leaves(out))} leaves): every leaf "
          f"bitwise its plain version; launches {counts}")
    return counts


def run_qwen_pytree_cli(torch, ops, steps=3):
    """Phase 3, the pytree train step at full width through the training
    CLI in this process: Qwen2-0.5B in float32 (as the flat run, for the
    same reason), the launcher's batch 4 x seq 128, b2 = 8, mu = 1e-3, lr =
    1e-4. Per step: 2·b2 zo_axpy per leaf (b2 perturbations, b2 replayed
    updates), nine forwards' RMSNorms and attentions, nothing else.
    Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config("qwen2-0.5b")
    b2, L = 8, cfg.n_layers
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(zo_axpy=2 * b2 * QWEN_LEAVES,
                rmsnorm=(1 + b2) * (2 * L + 1), flash_attention=(1 + b2) * L)
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.main(["--arch", "qwen2-0.5b", "--override", "dtype=float32",
                      "--steps", str(steps), "--batch", "4", "--seq", "128",
                      "--b2", str(b2), "--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    prev = dict.fromkeys(ops.LAUNCHES, 0)
    for i, cum in enumerate(res.launches):
        per = {k: cum[k] - prev[k] for k in cum}
        check(per == want, f"pytree CLI step {i}: launches {per} != {want}")
        prev = cum
    check(all(map(math.isfinite, res.history)),
          f"pytree CLI: loss {res.history}")
    check(all(bool(torch.isfinite(t).all()) for t in
              tree_leaves(res.params)), "pytree CLI: parameters not finite")
    steady = sorted(res.step_ms[1:]) or res.step_ms
    print(f"qwen2_0_5b_pytree_cli: ms/step "
          f"{[round(t, 1) for t in res.step_ms]} (median after step 1 "
          f"{steady[len(steady) // 2]:.1f}); whole CLI {wall:.1f} s; peak "
          f"memory {peak / 2**30:.2f} GiB; loss {res.history}; launches per "
          f"step {want}")
    return dict(res.launches[-1])


def check_small_reference(torch, neural, FedZOConfig):
    """Phase 4: the same short run on the card and on the CPU."""
    kw = dict(n_train=320, n_test=96, n_clients=6, n_features=24,
              n_classes=4, alpha=0.5)
    cfg = FedZOConfig(n_devices=6, n_participating=3, local_iters=2, b1=8,
                      b2=4, lr=5e-2, mu=1e-3, flat_params=True,
                      flat_block_rows=4, weight_by_size=True, seed=11)
    out = {}
    for dev in ("cuda", "cpu"):
        task = neural.make_task("softmax", device=dev, **kw)
        res = neural.run(task, cfg, 4, eval_rows=96)
        out[dev] = {k: v.cpu() for k, v in res.params.items()}
    # each coefficient is d.(L+ - L)/mu: one float32 ulp of the loss (the
    # card's matmul sums in another order) moves it by d.ulp/mu ~ 0.012 here;
    # the port-vs-reference runs of this config differ by < 2e-4 on the CPU
    worst = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
                for k in out["cpu"])
    check(worst <= 2e-3, f"card vs CPU run: max |diff| {worst}")
    print(f"small reference (softmax 24x4, 4 rounds): card vs CPU max |diff| "
          f"{worst:.3e}")


def check_pytree_small_reference(torch, neural, FedZOConfig):
    """Phase 4: the golden softmax_counter configuration (the pytree route
    with the counter convention; 6 clients, 24x4 softmax), 8 rounds on the
    card and on the CPU. Same limit as the flat run's, for the same
    reason (a loss ulp moves a coefficient by d.ulp/mu ~ 0.012); port vs
    JAX on the CPU reads 1.2e-4 for this config."""
    kw = dict(n_train=320, n_test=96, n_clients=6, n_features=24,
              n_classes=4, alpha=0.5)
    cfg = FedZOConfig(n_devices=6, n_participating=3, local_iters=2, b1=8,
                      b2=4, lr=5e-2, mu=1e-3, direction_conv="counter",
                      weight_by_size=True, seed=11)
    out = {}
    for dev in ("cuda", "cpu"):
        task = neural.make_task("softmax", device=dev, **kw)
        res = neural.run(task, cfg, 8, eval_rows=96)
        out[dev] = {k: v.cpu() for k, v in res.params.items()}
    worst = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
                for k in out["cpu"])
    check(worst <= 2e-3, f"pytree card vs CPU run: max |diff| {worst}")
    print(f"small reference (softmax_counter, pytree, 8 rounds): card vs CPU "
          f"max |diff| {worst:.3e}")


# the transformer track at the reference's test size (tests/test_neural.py):
# 24 features in 4 patch tokens, d_model 16 over 2 heads of 8, d = 2,320
TRACK_SMALL = dict(n_train=180, n_test=48, n_clients=6, n_features=24,
                   n_classes=4, n_patches=4, d_model=16, d_ff=32, n_heads=2)


def check_track_small_reference(torch, ops, neural, FedZOConfig, route):
    """Phase 4: 2 rounds of the transformer track at its test size (the
    head dim 8 kernel) on the card and on the CPU, on the flat, pytree or
    wide (``block``) route, or on the pytree route with bfloat16 sphere or
    gaussian directions (float32 weights, bfloat16 directions into
    zo_axpy). The card run's launch counts are exact. A loss ulp moves a
    coefficient by d.ulp/mu ~ 0.28 here and a weight by lr/b2 of that along
    a unit direction, so the two runs drift like port and JAX on the CPU
    (2e-4 to 6e-4 there, tests/test_torch_transformer_track.py and
    tests/test_torch_wide.py): within the ZO trajectory tolerance 1e-3."""
    from repro_torch.utils.tree import tree_leaves
    over = {"flat": dict(flat_params=True, flat_block_rows=4),
            "pytree": {},
            "pytree bf16 sphere": dict(direction_dtype="bfloat16"),
            "pytree bf16 gaussian": dict(direction_dtype="bfloat16",
                                         estimator="gaussian"),
            "wide": dict(batch_directions=True, direction_conv="block")}
    cfg = FedZOConfig(n_devices=6, n_participating=3, local_iters=2, b1=6,
                      b2=3, lr=2e-2, mu=1e-3, seed=7, **over[route])
    out = {}
    for dev in ("cuda", "cpu"):
        task = neural.make_task("transformer", device=dev, **TRACK_SMALL)
        ops.reset_launches()
        res = neural.run(task, cfg, 2, eval_every=0)
        if dev == "cuda":
            want = round_launches(ops, cfg, 2, CLS_LEAVES, CLS_LAYERS)
            check(dict(ops.LAUNCHES) == want, f"transformer {route}: "
                  f"launches {dict(ops.LAUNCHES)} != {want}")
        out[dev] = [t.cpu() for t in tree_leaves(res.params)]
    worst = max(float((a - b).abs().max()) for a, b in zip(*out.values()))
    check(worst <= 1e-3, f"transformer {route} card vs CPU: max |diff| "
          f"{worst}")
    print(f"small reference (transformer track at its test size, {route}, "
          f"2 rounds): card vs CPU max |diff| {worst:.3e}")


def check_bf16_draws(torch):
    """Phase 4: bfloat16 normals (the tree convention's draws) made on the
    card bitwise the CPU's, over ragged shapes: a bf16 draw is one of 128
    values, and its float32 erfinv rounds to bf16."""
    from repro_torch.utils import prng
    n = 0
    for seed, shape in ((0, (7,)), (1, (1000, 37)), (2, (3, 4097)),
                        (3, (784, 32))):
        k = prng.key(seed)
        got = prng.normal(k, shape, dtype=torch.bfloat16, device="cuda")
        want = prng.normal(k, shape, dtype=torch.bfloat16)
        check(torch.equal(got.cpu(), want), f"bf16 normal {shape} differs "
              f"between the card and the CPU")
        n += got.numel()
    print(f"bf16 normals: card bitwise the CPU over {n:,} draws")


def check_lm_small_reference(torch, FedZOConfig, flat_params=True):
    """Phase 4: 3 train steps of qwen2-0.5b-smoke on the card and on the
    CPU (plain versions) from the same init, on the flat or the pytree
    route."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten

    model, toks = lm_setup("qwen2-0.5b-smoke", "float32")
    fcfg = FedZOConfig(lr=1e-3, mu=1e-2, b2=4, flat_params=flat_params)
    step = fedzo.make_train_step(model.loss, fcfg)
    init = model.init(prng.key(0), device="cpu")
    spec = flat_spec(init)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = unflatten(flatten(init, spec).to(dev), spec)
        rng, key, mets = np.random.default_rng(0), prng.key(1), []
        for _ in range(3):
            batch = lm_batch(torch, toks, rng, 2, 16, dev)
            ks = prng.split(key, 2)
            key, sub = ks[0], ks[1]
            params, m = step(params, batch, sub)
            mets.append((float(m["loss"]), float(m["coeff_norm"])))
        runs[dev] = (flatten(params, spec).cpu(), mets)
    # each coefficient is d.(L+ - L)/mu with d = 361,600: one float32 ulp of
    # the loss (4.8e-7 at 6.3; the card sums the matmuls in another order)
    # moves it by 17, and a step moves each weight by lr/b2 of the
    # coefficient-weighted unit directions (|v_i| <= ~8e-3): ~1e-4 per ulp
    # per step, so 1e-3 over 3 steps; port vs JAX on the CPU reads 2.1e-4
    # (flat route) and 3.2e-4 (pytree route)
    route = "flat" if flat_params else "pytree"
    worst = float((runs["cuda"][0] - runs["cpu"][0]).abs().max())
    check(worst <= 1e-3, f"qwen2-0.5b-smoke {route} card vs CPU: max |diff| "
          f"{worst}")
    print(f"small reference (qwen2-0.5b-smoke, {route}, 3 train steps): card "
          f"vs CPU max |param diff| {worst:.3e}; (loss, coeff_norm) card "
          f"{runs['cuda'][1]} cpu {runs['cpu'][1]}")


def check_lm_round_small_reference(torch, FedZOConfig):
    """Phase 4: one flat round of qwen2-0.5b-smoke (M = 3 clients, H = 2,
    b2 = 4, mu = 1e-2, lr = 1e-3) on the card (the client-batched forward
    with the kernels) and on the CPU (plain versions), from the same
    weights, batches and keys."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten

    model, toks = lm_setup("qwen2-0.5b-smoke", "float32")
    m, h = 3, 2
    cfg = FedZOConfig(n_participating=m, local_iters=h, lr=1e-3, mu=1e-2,
                      b2=4, flat_params=True)
    init = model.init(prng.key(0), device="cpu")
    spec = flat_spec(init)
    rng = np.random.default_rng(0)
    per = [lm_batch(torch, toks, rng, 2, 16, "cpu") for _ in range(m * h)]
    batches = {k: torch.stack([b[k] for b in per]).reshape((m, h, 2, 16))
               for k in ("tokens", "labels")}
    runs = {}
    for dev in ("cuda", "cpu"):
        params = unflatten(flatten(init, spec).to(dev), spec)
        new, met = fedzo.round_simulated(
            model.loss, params, {k: v.to(dev) for k, v in batches.items()},
            prng.split(prng.key(1), m), cfg)
        runs[dev] = (flatten(new, spec).cpu(),
                     float(met["mean_local_loss"]))
    # check_lm_small_reference's argument: a loss ulp moves a coefficient
    # by d.ulp/mu ~ 17 and a weight by ~1e-4 per iterate, so a client's
    # H = 2 iterates at a few ulps each stay within 1e-3; the mean over the
    # clients does not add to it (port vs JAX on the CPU reads 1.1e-4)
    worst = float((runs["cuda"][0] - runs["cpu"][0]).abs().max())
    check(worst <= 1e-3, f"qwen2-0.5b-smoke flat round card vs CPU: max "
          f"|diff| {worst}")
    print(f"small reference (qwen2-0.5b-smoke, flat round, M {m}, H {h}): "
          f"card vs CPU max |param diff| {worst:.3e}; mean local loss card "
          f"{runs['cuda'][1]} cpu {runs['cpu'][1]}")


# ---------------------------------------------------------------------------
# phase "algorithms and uplinks": the strategies, FedAvg, the seed-compressed
# uplink and FedServer


def fedavg_launches(ops, cfg, rounds, L=0):
    """Launches of ``rounds`` FedAvg rounds: no ZO kernel; per local step
    one batched forward of the cohort (2L + 1 RMSNorms, L attentions,
    whatever M is); the backward recomputes the plain versions and
    launches nothing."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    if L:
        steps = rounds * cfg.local_iters
        want.update(rmsnorm=steps * (2 * L + 1), flash_attention=steps * L)
    return want


def run_strategy_rounds(torch, ops, neural, FedZOConfig):
    """Parts (a) and (b) at the other rounds' settings (N = 50, M = 10,
    H = 5, b1 = 25, b2 = 20, size-weighted). Softmax 784x10, 3 rounds each:
    fedprox (prox_mu 0.01), feddyn (dyn_alpha 0.01) and scaffold on the
    flat route, scaffold on the wide route, fedprox with AirComp, and
    fedavg at a first-order lr of 0.05 (FedZOConfig's 1e-3 is a ZO step).
    The transformer track at its lr 5e-3: fedprox on the flat route and
    fedavg, one round each. The hooks add no ZO kernel launch: each
    strategy's counts are the fedzo round's on its route, M-free; fedavg
    launches no ZO kernel, and on the track one batched forward a step.
    Then one client's FedAvg gradient of the track on the card against the
    CPU's. Returns {kernel: launches}."""
    softmax = neural.make_task("softmax", n_features=784, n_classes=10,
                               n_clients=50)
    track = neural.make_task("transformer", n_clients=50)
    base = dict(weight_by_size=True)
    flat = dict(flat_params=True)
    wide = dict(batch_directions=True, direction_conv="block")
    air = dict(aircomp=True, channel_schedule=True, snr_db=5.0)
    prox = dict(strategy="fedprox", prox_mu=0.01)

    def on_track(**kw):
        return neural.default_config(track, n_participating=10, **kw)

    runs = [("softmax_fedprox", softmax, FedZOConfig(**base, **flat, **prox),
             3, "local"),
            ("softmax_feddyn", softmax, FedZOConfig(
                **base, **flat, strategy="feddyn", dyn_alpha=0.01), 3,
             "local"),
            ("softmax_scaffold", softmax, FedZOConfig(
                **base, **flat, strategy="scaffold"), 3, "local"),
            ("softmax_scaffold_wide", softmax, FedZOConfig(
                **base, **wide, strategy="scaffold"), 3, "local"),
            ("softmax_fedprox_aircomp", softmax, FedZOConfig(
                **base, **flat, **air, **prox), 3, "local"),
            ("softmax_fedavg", softmax, FedZOConfig(
                **base, strategy="fedavg", lr=0.05), 3, "mean"),
            ("transformer_fedprox", track, on_track(**flat, **prox), 1,
             None),
            ("transformer_fedavg", track, on_track(strategy="fedavg"), 1,
             None)]

    def want(task, cfg, rounds):
        L = CLS_LAYERS if task is track else 0
        if cfg.strategy == "fedavg":
            return fedavg_launches(ops, cfg, rounds, L)
        return round_launches(ops, cfg, rounds,
                              CLS_LEAVES if task is track else 2, L)

    total = drive_runs(torch, ops, neural, [
        (name, task, cfg, rounds, want(task, cfg, rounds), descend)
        for name, task, cfg, rounds, descend in runs])
    check_fedavg_gradient(torch, ops, neural, track)
    return total


# A FedAvg gradient on the card against the CPU's: the forward kernels
# agree with the plain versions within a relative 1e-5 (attention, float32)
# or bitwise (RMSNorm's order twin), the GEMMs sum in other orders, and the
# backward is the plain version's on both: every leaf within a relative
# 1e-4 of its largest entry. A gradient that skipped the kernels' inputs
# (a launch output with no grad_fn) would leave the attention and norm
# weights at zero, which no tolerance passes.
GRAD_REL = 1e-4


def check_fedavg_gradient(torch, ops, neural, track):
    """One client's FedAvg gradient (``fedavg.value_and_grad`` of the
    track's loss on its first 25 rows) on the card and on the CPU from the
    same weights; the card's forward launches its kernels once."""
    from repro_torch.core import fedavg
    from repro_torch.utils.flatparams import _leaves
    from repro_torch.utils.tree import tree_map
    params = neural.params_init(track, 0)
    batch = {k: v[0, :25] for k, v in track.store.data.items()}
    ops.reset_launches()
    loss, grad = fedavg.value_and_grad(track.loss, params, batch)
    check(ops.LAUNCHES["rmsnorm"] == 2 * CLS_LAYERS + 1
          and ops.LAUNCHES["flash_attention"] == CLS_LAYERS,
          f"track gradient: launches {dict(ops.LAUNCHES)}")
    loss_c, grad_c = fedavg.value_and_grad(
        track.loss, tree_map(lambda v: v.cpu(), params),
        {k: v.cpu() for k, v in batch.items()})
    want = dict(_leaves(grad_c))
    worst = 0.0
    for path, g in _leaves(grad):
        big = float(want[path].abs().max())
        check(big > 0, f"track gradient {path}: zero on the CPU")
        rel = float((g.cpu() - want[path]).abs().max()) / big
        check(rel <= GRAD_REL, f"track gradient {path}: card vs CPU "
              f"relative {rel} > {GRAD_REL}")
        worst = max(worst, rel)
    check(abs(float(loss) - float(loss_c)) <= 1e-5 * abs(float(loss_c)),
          f"track loss card {float(loss)} cpu {float(loss_c)}")
    print(f"transformer_fedavg gradient: {len(want)} leaves, card vs CPU "
          f"largest relative difference {worst:.3e} (limit {GRAD_REL}); "
          f"loss {float(loss)} vs {float(loss_c)}")


def backward_inputs(torch, kind, shape, dtype, gen):
    """Random inputs and a cotangent on the card for a backward check:
    ``rmsnorm`` shape (x shape, groups), ``attention`` shape (B, S, Hq,
    Hkv, D, window)."""
    def rnd(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)
    if kind == "rmsnorm":
        xs, groups = shape
        d = xs[-1]
        ins = [rnd(*xs), 1 + 0.1 * rnd(*((d,) if groups == 1
                                         else (groups, d)))]
        return ins, rnd(*xs), {}
    b, s, hq, hkv, d, window = shape
    ins = [rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d)]
    return ins, rnd(b, s, hq, d), {"window": window}


def check_backward(torch, ops, kind, shape, dtype, gen, time_reps=0):
    """``ops.rmsnorm``/``ops.attention`` with inputs that require a
    gradient on the card: the forward is the kernel (one launch, bitwise
    the direct call's output) and the gradients are bitwise autograd of
    the plain version on the same card tensors, and not all zero. With
    ``time_reps``, the backward's device time (ms, the recompute and
    ``autograd.grad``). Returns (max |grad|, ms or None)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    fwd = ops.rmsnorm if kind == "rmsnorm" else ops.attention
    plain = rmsnorm_plain if kind == "rmsnorm" else flash_attention_plain
    ins, g, kw = backward_inputs(torch, kind, shape, dtype, gen)
    name = "rmsnorm" if kind == "rmsnorm" else "flash_attention"
    leaves = [t.clone().requires_grad_() for t in ins]
    before = ops.LAUNCHES[name]
    out = fwd(*leaves, **kw)
    check(ops.LAUNCHES[name] == before + 1 and out.grad_fn is not None,
          f"{kind} {shape}: the forward did not launch through autograd")
    check(torch.equal(out, fwd(*ins, **kw)),
          f"{kind} {shape}: forward differs from the kernel's")
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    ref = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(plain(*ref, **kw), ref, g)
    for a, b in zip(got, want):
        check(a.shape == b.shape and torch.equal(a, b),
              f"{kind} {shape} {dtype}: gradient differs from the plain "
              f"version's autograd")
    big = max(float(a.abs().max()) for a in got)
    check(big > 0, f"{kind} {shape}: zero gradient")
    ms = (median_ms(torch, lambda: torch.autograd.grad(
        out, leaves, g, retain_graph=True), time_reps)
        if time_reps else None)
    return big, ms


# backward checks: Qwen2-0.5B's shapes at batch 1 x seq 16 (d_model 896,
# 14 q heads over 2 kv heads of 64), the transformer track's ([250, 8]
# rows of d_model 32 in 10 client groups, 2 heads of 16 or 8), the [G, D]
# scale, and every head dim the attention builds (8 in float32 only)
BACKWARD_CASES = (
    [("rmsnorm", ((1, 16, LM_DM), 1), dt) for dt in ("float32", "bfloat16")]
    + [("attention", (1, 16, LM_HQ, LM_HKV, LM_HD, 0), dt)
       for dt in ("float32", "bfloat16")]
    + [("rmsnorm", ((4, 2, 3, 64), 4), "float32"),
       ("rmsnorm", ((10, 25, 8, 32), 10), "bfloat16"),
       ("attention", (250, 8, 2, 2, 8, 0), "float32"),
       ("attention", (250, 8, 2, 2, 16, 0), "float32")]
    + [("attention", (2, 70, 4, 2, d, w), dt) for d in (16, 32, 128, 256)
       for dt in ("float32", "bfloat16") for w in (0, 24)])
# the backward timed at the shapes a step runs: the Qwen2-0.5B FedAvg step
# (batch 4 x seq 128) and the track's FedAvg round (M.b1 = 250 rows)
BACKWARD_TIMED = (
    ("qwen rmsnorm", "rmsnorm", ((LM_B, LM_S, LM_DM), 1)),
    ("qwen attention", "attention", (LM_B, LM_S, LM_HQ, LM_HKV, LM_HD, 0)),
    ("track rmsnorm", "rmsnorm", ((10, 25, 8, 32), 10)),
    ("track attention", "attention", (250, 8, 2, 2, 16, 0)))


def check_backwards(torch, ops):
    """Part (c)'s backward check over ``BACKWARD_CASES``, then the
    backward's device time at ``BACKWARD_TIMED`` (float32). Returns {name:
    ms}."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    for kind, shape, dt in BACKWARD_CASES:
        check_backward(torch, ops, kind, shape, getattr(torch, dt), gen)
    times = {}
    for name, kind, shape in BACKWARD_TIMED:
        _, times[name] = check_backward(torch, ops, kind, shape,
                                        torch.float32, gen, time_reps=20)
    print(f"backward (plain recompute + autograd.grad): "
          f"{len(BACKWARD_CASES)} cases bitwise the plain version's "
          f"autograd on the card; device ms {json.dumps(times)}")
    return times


def run_qwen_fedavg_cli(torch, ops, bwd_ms, steps=3):
    """Part (c): ``repro_torch.launch.train --algo fedavg --opt adam`` on
    Qwen2-0.5B at full width in float32, batch 4 x seq 128, 3 steps: per
    step one forward (2L + 1 RMSNorms and L attentions through the
    kernels), the backward through the plain versions (no launch), one
    Adam step. Prints ms per step, peak memory, the losses, and the
    backward recompute's share of a step estimated from ``bwd_ms`` (its
    device time at the step's shapes, times the calls a step makes).
    Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_leaves

    L = get_config("qwen2-0.5b").n_layers
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(rmsnorm=2 * L + 1, flash_attention=L)
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.main(["--arch", "qwen2-0.5b", "--override", "dtype=float32",
                      "--algo", "fedavg", "--opt", "adam", "--steps",
                      str(steps), "--batch", str(LM_B), "--seq", str(LM_S),
                      "--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    prev = dict.fromkeys(ops.LAUNCHES, 0)
    for i, cum in enumerate(res.launches):
        per = {k: cum[k] - prev[k] for k in cum}
        check(per == want, f"fedavg CLI step {i}: launches {per} != {want}")
        prev = cum
    check(all(map(math.isfinite, res.history)),
          f"fedavg CLI: loss {res.history}")
    leaves = tree_leaves(res.params)
    check(all(bool(torch.isfinite(t).all()) and not t.requires_grad
              for t in leaves), "fedavg CLI: parameters not finite or "
          "still requiring a gradient")
    steady = sorted(res.step_ms[1:]) or res.step_ms
    med = steady[len(steady) // 2]
    recompute = L * bwd_ms["qwen attention"] \
        + (2 * L + 1) * bwd_ms["qwen rmsnorm"]
    print(f"qwen2_0_5b_fedavg_adam_cli: ms/step "
          f"{[round(t, 1) for t in res.step_ms]} (median after step 1 "
          f"{med:.1f}); whole CLI {wall:.1f} s; peak memory "
          f"{peak / 2**30:.2f} GiB; loss {res.history}; launches per step "
          f"{want}; backward recompute of RMSNorm and attention "
          f"{recompute:.2f} ms of device time a step "
          f"({recompute / med:.3f} of the step)")
    return dict(res.launches[-1])


def qwen_round_inputs(torch):
    """Qwen2-0.5B in float32 from seed 0, the flat round's M x H batches of
    4 x 128 tokens (as phase "qwen flat round") and the M client keys."""
    import numpy as np
    from repro_torch.utils import prng
    model, toks = lm_setup("qwen2-0.5b", "float32")
    params = model.init(prng.key(0), device="cuda")
    rng = np.random.default_rng(1)
    per = [lm_batch(torch, toks, rng, LM_B, LM_S, "cuda")
           for _ in range(QWEN_M * QWEN_H)]
    batches = {k: torch.stack([b[k] for b in per]).reshape(
        (QWEN_M, QWEN_H, LM_B, LM_S)) for k in ("tokens", "labels")}
    return model, params, batches


def seed_ulps(torch, got, want):
    """Largest |got - want| of each leaf in ulps of that leaf's largest
    |weight|: the worst over the leaves."""
    from repro_torch.utils.flatparams import _leaves
    worst = 0.0
    w = dict(_leaves(want))
    for path, g in _leaves(got):
        big = w[path].abs().max()
        ulp = float(torch.nextafter(big, big + 1) - big)
        worst = max(worst, float((g - w[path]).abs().max()) / ulp)
    return worst


def run_qwen_seed_round(torch, ops, FedZOConfig):
    """Part (d): ``run_seed_compressed_round`` on Qwen2-0.5B, flat route, M
    = 4, H = 2, b2 = 8, against a dense ``fedzo.round_simulated`` on the
    same batches and keys. Both run the same cohort phase (the same
    coefficients and updates); the dense round rounds each weight once per
    iterate, the replay sums a client's updates first, and both round the
    mean and the final add once: each weight within H + 2 ulps of its
    leaf's largest weight (2.x ulps by that count; the CPU test reads 3 at
    softmax size). The seed round's launches are the dense round's plus
    the aggregate's: exactly 1 zo_dirnorms and M.H zo_replay. Wire bytes
    M.(8 + 4.H.b2 + 4). Returns the launches of both rounds."""
    from repro_torch.core import fedzo
    from repro_torch.fed.server import run_seed_compressed_round
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_bytes

    model, params, batches = qwen_round_inputs(torch)
    L, m, h = model.cfg.n_layers, QWEN_M, QWEN_H
    keys = prng.split(prng.key(1), m)
    cfg = FedZOConfig(n_participating=m, local_iters=h, lr=1e-4, mu=1e-3,
                      b2=QWEN_B2, estimator="sphere", flat_params=True)
    counts, ms, out = {}, {}, {}
    for name in ("dense", "seed"):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "dense":
            out[name], _ = fedzo.round_simulated(model.loss, params, batches,
                                                 keys, cfg)
        else:
            out[name], wire, dense_bytes = run_seed_compressed_round(
                model.loss, params, batches, keys, cfg)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        counts[name] = dict(ops.LAUNCHES)
        print(f"qwen seed round, {name}: ms {ms[name]:.1f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {counts[name]}")
        torch.cuda.empty_cache()
    want = round_launches(ops, cfg, 1, L=L)
    check(counts["dense"] == want, f"qwen dense round: launches "
          f"{counts['dense']} != {want}")
    agg = {k: counts["seed"][k] - counts["dense"][k] for k in want}
    want_agg = dict.fromkeys(ops.LAUNCHES, 0)
    want_agg.update(zo_dirnorms=1, zo_replay=m * h)
    check(agg == want_agg, f"qwen seed aggregate: launches {agg} != "
          f"{want_agg}")
    msg_bytes = 8 + 4 * h * cfg.b2 + 4
    check(wire == m * msg_bytes, f"wire bytes {wire} != {m * msg_bytes}")
    check(dense_bytes == m * tree_bytes(params), "dense bytes")
    ulps = seed_ulps(torch, out["seed"], out["dense"])
    check(ulps <= h + 2, f"qwen seed replay vs dense round: {ulps} ulps "
          f"> {h + 2}")
    print(f"qwen seed round: wire {wire} bytes for M = {m} "
          f"({msg_bytes} a client), dense {dense_bytes} bytes: compression "
          f"{dense_bytes / wire:.4e}x; replay vs dense round {ulps:.2f} "
          f"ulps of each leaf's largest weight (limit {h + 2}); aggregate "
          f"launches {agg}")
    return {k: counts["dense"][k] + counts["seed"][k] for k in want}


def run_qwen_fedprox_round(torch, ops, FedZOConfig):
    """Part (e): one ZO-FedProx flat round on Qwen2-0.5B (prox_mu 0.01; M =
    4, H = 2, b2 = 8, the flat round's batches) through the strategy's
    ``run_round``: ms, peak memory, and launches equal to the fedzo
    round's (the proximal term is tree ops over the cohort's rows).
    Returns the launches."""
    from repro_torch.core import strategy
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves

    model, params, batches = qwen_round_inputs(torch)
    cfg = FedZOConfig(n_participating=QWEN_M, local_iters=QWEN_H, lr=1e-4,
                      mu=1e-3, b2=QWEN_B2, estimator="sphere",
                      flat_params=True, strategy="fedprox", prox_mu=0.01)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, met, _, _ = strategy.get("fedprox").run_round(
        model.loss, params, batches, prng.key(1), cfg)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = dict(ops.LAUNCHES)
    want = round_launches(ops, cfg, 1, L=model.cfg.n_layers)
    check(counts == want, f"qwen fedprox round: launches {counts} != "
          f"{want}")
    mets = {k: float(v) for k, v in met.items()}
    check(all(map(math.isfinite, mets.values())), f"qwen fedprox {mets}")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(new)),
          "qwen fedprox round: parameters not finite")
    print(f"qwen fedprox round: M {QWEN_M}, H {QWEN_H}, b2 {QWEN_B2}: "
          f"ms/round {ms:.1f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; metrics "
          f"{json.dumps(mets)}; launches {counts} (the fedzo round's)")
    return counts


LEDGER_COLUMNS = ("wire_bytes", "dense_bytes", "downlink_bytes",
                  "wire_bytes_total", "downlink_bytes_total",
                  "compression_ratio")


def run_fedserver(torch, ops, neural, FedZOConfig):
    """Part (f): ``FedServer`` on the card, softmax 784x10 on 50 clients,
    flat route, 2 rounds: the host loop with fedzo and fedavg (numpy
    sampling, batches moved to the card), the store path with all five
    strategies (``run``: the engine's round loop). Exact launch counts,
    finite rows numbered 0 and 1 with the ledger's columns. Returns the
    launches."""
    from repro_torch.fed.server import FedServer
    softmax = neural.make_task("softmax", n_features=784, n_classes=10,
                               n_clients=50)
    total = dict.fromkeys(ops.LAUNCHES, 0)
    runs = [("host", "fedzo"), ("host", "fedavg")] + [
        ("store", s) for s in ("fedzo", "fedavg", "fedprox", "feddyn",
                               "scaffold")]
    for driver, name in runs:
        kw = dict(flat_params=True, weight_by_size=True, prox_mu=0.01,
                  dyn_alpha=0.01, lr=0.05 if name == "fedavg" else 1e-3)
        cfg = FedZOConfig(**kw)
        srv = FedServer(softmax.loss, neural.params_init(softmax, 0),
                        softmax.clients, cfg, strategy=name,
                        store=softmax.store if driver == "store" else None)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = srv.run(2)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 2
        counts = dict(ops.LAUNCHES)
        want = (fedavg_launches(ops, cfg, 2) if name == "fedavg"
                else round_launches(ops, cfg, 2, 2))
        check(counts == want, f"FedServer {driver} {name}: launches "
              f"{counts} != {want}")
        check([r["round"] for r in hist] == [0, 1],
              f"FedServer {driver} {name}: rows {hist}")
        for r in hist:
            check(all(c in r for c in LEDGER_COLUMNS),
                  f"FedServer {driver} {name}: ledger columns missing {r}")
            check(all(math.isfinite(v) for v in r.values()
                      if isinstance(v, float)),
                  f"FedServer {driver} {name}: row not finite {r}")
        print(f"FedServer {driver} {name}: {ms:.1f} ms/round; losses "
              f"{[round(r['mean_local_loss'], 5) for r in hist]}; wire "
              f"{hist[-1]['wire_bytes']} bytes/round; launches {counts}")
        for k in total:
            total[k] += counts[k]
    return total


def check_strategy_small_reference(torch, ops, neural, FedZOConfig, name):
    """Phase "algorithms and uplinks": one round of the transformer track
    at its test size (head dim 8) on the card and on the CPU, under
    fedprox (flat route), scaffold (wide route) or fedavg; exact launch
    counts on the card. ZO rounds within the trajectory tolerance 1e-3
    (``check_track_small_reference``); FedAvg within 1e-5: its gradients
    agree to float32 reordering (the card's forward kernels within 1e-5
    relative of the plain versions) and lr.H = 0.04 scales them down."""
    from repro_torch.utils.tree import tree_leaves
    over = {"fedprox": dict(flat_params=True, flat_block_rows=4,
                            strategy="fedprox", prox_mu=0.1),
            "scaffold": dict(batch_directions=True, direction_conv="block",
                             strategy="scaffold"),
            "fedavg": dict(strategy="fedavg")}
    cfg = FedZOConfig(n_devices=6, n_participating=3, local_iters=2, b1=6,
                      b2=3, lr=2e-2, mu=1e-3, seed=7, **over[name])
    out = {}
    for dev in ("cuda", "cpu"):
        task = neural.make_task("transformer", device=dev, **TRACK_SMALL)
        ops.reset_launches()
        res = neural.run(task, cfg, 1, eval_every=0)
        if dev == "cuda":
            want = (fedavg_launches(ops, cfg, 1, CLS_LAYERS)
                    if name == "fedavg" else
                    round_launches(ops, cfg, 1, CLS_LEAVES, CLS_LAYERS))
            check(dict(ops.LAUNCHES) == want, f"transformer {name}: "
                  f"launches {dict(ops.LAUNCHES)} != {want}")
        out[dev] = [t.cpu() for t in tree_leaves(res.params)]
    worst = max(float((a - b).abs().max()) for a, b in zip(*out.values()))
    limit = 1e-5 if name == "fedavg" else 1e-3
    check(worst <= limit, f"transformer {name} card vs CPU: max |diff| "
          f"{worst} > {limit}")
    print(f"small reference (transformer track at its test size, {name}, "
          f"1 round): card vs CPU max |diff| {worst:.3e} (limit {limit})")


def run_algorithms(torch, ops, neural, FedZOConfig):
    """Phase "algorithms and uplinks", parts (a)-(f) and the card-against-
    CPU references. Prints each part's seconds and peak memory; returns
    {kernel: launches} of its counted runs."""
    total = dict.fromkeys(ops.LAUNCHES, 0)
    bwd = {}

    def part(name, fn):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        got = fn()
        print(f"part {name}: {time.perf_counter() - t:.1f} s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
        return got

    for name, fn in (
            ("strategy rounds", lambda: run_strategy_rounds(
                torch, ops, neural, FedZOConfig)),
            ("backward checks", lambda: bwd.update(check_backwards(
                torch, ops)) or {}),
            ("qwen fedavg cli", lambda: run_qwen_fedavg_cli(torch, ops,
                                                            bwd)),
            ("qwen seed round", lambda: run_qwen_seed_round(
                torch, ops, FedZOConfig)),
            ("qwen fedprox round", lambda: run_qwen_fedprox_round(
                torch, ops, FedZOConfig)),
            ("fedserver", lambda: run_fedserver(torch, ops, neural,
                                                FedZOConfig))):
        for k, n in part(name, fn).items():
            total[k] += n
    part("references", lambda: [check_strategy_small_reference(
        torch, ops, neural, FedZOConfig, s)
        for s in ("fedprox", "scaffold", "fedavg")])
    return total


# Phase "faults, channel and durability": the fault processes, the
# wireless chain and the durable segment runner on the card. The neural
# run is softmax 784x10 at phase 3's N = 50, M = 10, H = 5 with AirComp,
# under these processes (FAULT_KW: dropout, stragglers, NaN uploads).
FAULT_KW = dict(p_fail=0.1, p_recover=0.5, deadline=2.0, p_corrupt=0.1)
CHANNEL_KW = dict(rho=0.9, battery=20.0, tx_cost=1.0)
FAULT_ROUNDS = 6


def _leaves_equal(torch, a, b):
    """Whether two parameter trees are bitwise equal (b may be on the
    CPU)."""
    from repro_torch.utils.tree import tree_leaves
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def run_faulted_qwen_round(torch, ops, FedZOConfig):
    """Part (a): the flat AirComp round on Qwen2-0.5B (M = 4, H = 2, b2 =
    8, 5 dB; ``qwen_round_inputs``) under a ``RoundChannel`` from
    ``ChannelModel(rho=0.9, battery=3.0, tx_cost=1.0).step`` over the 4
    clients (its key chosen so that the chain masks client 3 and client 2
    transmits) and a ``RoundFaults`` that poisons client 2 with NaN (guard
    on). Five rounds: the plain AirComp round (the i.i.d. channel draw, no
    faults; a warm-up), the round with client 2 masked, the poisoned
    round, the poisoned round with the guard off, and the plain round
    again, which the poisoned round's time is set beside. Checks: the
    poisoned round's weights bitwise the masked round's; ``m_effective``
    the chain's transmitting clients other than client 2 and
    ``m_corrupt`` 1; the guard off leaves non-finite weights; every
    round's launches exactly the plain round's; the poisoned round's peak
    memory at most one [n_pad] float32 row above the plain round's.
    Returns the launches."""
    from repro_torch.core import fedzo
    from repro_torch.sim import ChannelModel, FaultModel, RoundFaults
    from repro_torch.sim.channel import init_key
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves

    model, params, batches = qwen_round_inputs(torch)
    m = QWEN_M
    keys = prng.split(prng.key(1), m)
    cfg = FedZOConfig(n_participating=m, local_iters=QWEN_H, lr=1e-4,
                      mu=1e-3, b2=QWEN_B2, estimator="sphere",
                      flat_params=True, aircomp=True, channel_schedule=True,
                      snr_db=5.0)
    cm = ChannelModel(rho=0.9, battery=3.0, tx_cost=1.0)
    _, chan = cm.step(prng.key(8), cm.init_state(m, init_key(prng.key(0))),
                      torch.arange(m), h_min=cfg.h_min,
                      schedule=cfg.channel_schedule)
    check(chan.mask.tolist() == [True, True, True, False],
          f"qwen faulted round: channel mask {chan.mask.tolist()}")
    poison = torch.tensor([False, False, True, False])
    up, none = torch.ones(m, dtype=torch.bool), torch.zeros(
        m, dtype=torch.bool)
    runs = {"aircomp": {},
            "masked": dict(channel=chan, faults=RoundFaults(
                FaultModel(), ~poison, none)),
            "poisoned": dict(channel=chan, faults=RoundFaults(
                FaultModel(p_corrupt=0.5), up, poison)),
            "guard off": dict(channel=chan, faults=RoundFaults(
                FaultModel(p_corrupt=0.5, guard=False), up, poison)),
            "aircomp again": {}}
    want = round_launches(ops, cfg, 1, L=model.cfg.n_layers)
    total = dict.fromkeys(ops.LAUNCHES, 0)
    ms, peak, kept = {}, {}, None
    m_eff = float((chan.mask & ~poison).sum())
    for name, kw in runs.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, met = fedzo.round_simulated(model.loss, params, batches, keys,
                                         cfg, channel_rng=prng.key(2), **kw)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        peak[name] = torch.cuda.max_memory_allocated()
        counts = dict(ops.LAUNCHES)
        check(counts == want, f"qwen faulted round {name}: launches "
              f"{counts} != {want}")
        for k in total:
            total[k] += counts[k]
        mets = {k: float(v) for k, v in met.items()}
        finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))
        if name == "guard off":
            check(not finite, "qwen round with the guard off: the poison "
                  "did not reach the weights")
        else:
            check(finite, f"qwen faulted round {name}: weights not finite")
        if name == "masked":
            kept = [t.cpu() for t in tree_leaves(new)]
        if name == "poisoned":
            check(all(torch.equal(a.cpu(), b) for a, b in
                      zip(tree_leaves(new), kept)),
                  "qwen poisoned round: weights differ from the masked "
                  "round's")
        if name in ("masked", "poisoned"):
            check(mets["m_effective"] == m_eff and mets["m_corrupt"] == (
                1.0 if name == "poisoned" else 0.0),
                f"qwen faulted round {name}: m_effective "
                f"{mets['m_effective']} (want {m_eff}), m_corrupt "
                f"{mets['m_corrupt']}")
        print(f"qwen faulted round {name}: ms/round {ms[name]:.1f}; peak "
              f"memory {peak[name] / 2**30:.2f} GiB; metrics "
              f"{json.dumps(mets)}; launches {counts}")
        del new
    extra = peak["poisoned"] - peak["aircomp again"]
    check(extra <= 4 * QWEN_N_PAD, f"qwen poisoned round: peak "
          f"{extra / 2**30:.3f} GiB above the plain AirComp round's")
    plain = ms["aircomp again"]
    print(f"qwen faulted round: channel mask {chan.mask.tolist()}, poisoned "
          f"client 2; poisoned = masked bitwise; poisoned {ms['poisoned']:.1f}"
          f" ms against the plain AirComp round's {plain:.1f} "
          f"({ms['poisoned'] / plain - 1:+.2%}); peak {extra / 2**30:+.3f} "
          f"GiB (limit +{4 * QWEN_N_PAD / 2**30:.2f})")
    return total


def _same_run(torch, a, b):
    """Whether two engine results are bitwise equal: weights, metrics,
    evals, key, fault and channel state."""
    pairs = [(a.key, b.key), (a.fault_state, b.fault_state),
             *zip(a.channel_state, b.channel_state)]
    pairs += [(a.metrics[k], b.metrics[k]) for k in a.metrics]
    pairs += [(a.evals[k], b.evals[k]) for k in a.evals]
    return (sorted(a.metrics) == sorted(b.metrics)
            and _leaves_equal(torch, a.params, b.params)
            and all(torch.equal(x.cpu(), y.cpu()) for x, y in pairs))


def faulted_softmax(neural, FedZOConfig, device):
    """The softmax task, config and fault model of part (b)."""
    from repro_torch.sim import ChannelModel, FaultModel
    task = neural.make_task("softmax", n_features=784, n_classes=10,
                            n_clients=50, device=device)
    cfg = FedZOConfig(flat_params=True, weight_by_size=True, aircomp=True,
                      channel_schedule=True, snr_db=5.0,
                      channel_model=ChannelModel(**CHANNEL_KW))
    return task, cfg, FaultModel(**FAULT_KW)


def run_neural_durability(torch, ops, neural, FedZOConfig, tmp):
    """Part (b): softmax 784x10 (N = 50, M = 10, H = 5, flat, AirComp,
    size-weighted) under ``FAULT_KW`` and ``ChannelModel(**CHANNEL_KW)``
    for 6 rounds with the eval every 2, taps into a ``JsonlSink`` every 2
    rounds: exact launches; the tap rows equal ``history()``'s; the same
    run in 2-round segments (``checkpoint_every=2``) and killed after 2
    segments then resumed are bitwise the single-shot run; the manifest
    is written and read back (its config hash the snapshot's). A
    divergence drill (lr 1e6 on an exploding loss) rolls back once and
    finishes, and with no lr backoff ends in ``DivergenceError``. One
    pytree round (H = 1) with client 3 poisoned is bitwise the round with
    it masked (``scrub_tree``, the ``zo_axpy`` leaves). Returns (the
    6-round result, the launches)."""
    from repro_torch import obs
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import fedzo
    from repro_torch.data.synthetic import make_classification, noniid_shards
    from repro_torch.sim import (DivergenceError, FaultModel, RoundFaults,
                                 build_store, run_experiment)
    from repro_torch.sim.channel import battery
    from repro_torch.sim.store import sample_batches, sample_participants
    from repro_torch.utils import prng

    total = dict.fromkeys(ops.LAUNCHES, 0)

    def add():
        for k in total:
            total[k] += ops.LAUNCHES[k]
        ops.reset_launches()

    task, cfg, faults = faulted_softmax(neural, FedZOConfig, "cuda")
    path = os.path.join(tmp, "taps.jsonl")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.JsonlSink(path) as sink:
        one = neural.run(task, cfg, FAULT_ROUNDS, faults=faults, sink=sink,
                         tap_every=2)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / FAULT_ROUNDS
    want = round_launches(ops, cfg, FAULT_ROUNDS)
    check(dict(ops.LAUNCHES) == want, f"faulted softmax: launches "
          f"{dict(ops.LAUNCHES)} != {want}")
    add()
    hist = one.history()
    rows = obs.read_jsonl(path)
    check([r["round"] for r in rows] == [0, 2, 4] and all(
        v == hist[r["round"]][k] for r in rows for k, v in r.items()),
        f"faulted softmax: tap rows {rows} differ from history")
    check(all(math.isfinite(v) for r in hist for v in r.values()
              if isinstance(v, float)), "faulted softmax: rows not finite")
    print(f"faulted softmax: {ms:.1f} ms/round (6 rounds with evals, taps "
          f"and the manifest); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"m_effective {[r['m_effective'] for r in hist]}; m_corrupt "
          f"{[r['m_corrupt'] for r in hist]}; energy "
          f"{[r['energy_spent'] for r in hist]}; batteries "
          f"{battery(one.channel_state).tolist()}; test_acc "
          f"{[round(r['test_acc'], 4) for r in hist if 'test_acc' in r]}")
    ck = os.path.join(tmp, "chunked")
    chunked = neural.run(task, cfg, FAULT_ROUNDS, faults=faults,
                         checkpoint_every=2, checkpoint_dir=ck)
    check(_same_run(torch, one, chunked), "faulted softmax: 2-round "
          "segments differ from the single-shot run")
    kill = os.path.join(tmp, "killed")
    part = neural.run(task, cfg, FAULT_ROUNDS, faults=faults,
                      checkpoint_every=2, checkpoint_dir=kill,
                      max_segments=2)
    check(part.rounds == 4, f"killed run stopped at {part.rounds}")
    resumed = neural.run(task, cfg, FAULT_ROUNDS, faults=faults,
                         checkpoint_every=2, checkpoint_dir=kill,
                         resume=True)
    check(_same_run(torch, one, resumed), "faulted softmax: the resumed "
          "run differs from the single-shot run")
    add()
    man = obs.read_manifest(ck)
    side = ckpt.read_sidecar(ckpt.latest_run_state(ck))
    check(man["config_hash"] == side["config_hash"]
          and man["rounds_done"] == FAULT_ROUNDS and "faults" in man
          and man["channel"]["energy_gated"]
          and obs.read_manifest(f"{path}.manifest.json")["tap_every"] == 2,
          f"manifest {man}")
    print(f"faulted softmax: chunked = killed-and-resumed = single-shot, "
          f"bitwise; manifest {man['config_hash']} on "
          f"{man['topology']['devices']}, snapshots "
          f"{sorted(os.listdir(ck))}")

    x, y = make_classification(320, 4, 2, seed=1)
    store = build_store(noniid_shards(x, y, 8), device="cuda")

    def explode(p, b):
        return torch.exp(torch.sum(torch.square(p["x"] - 0.1)))

    dcfg = FedZOConfig(n_devices=8, n_participating=4, local_iters=2,
                       lr=1e6, mu=1e-3, b1=8, b2=4, seed=3)
    res = run_experiment(explode, {"x": torch.zeros(4, device="cuda")},
                         store, dcfg, 4, checkpoint_every=2,
                         checkpoint_dir=os.path.join(tmp, "drill"),
                         lr_backoff=1e-8)
    check([e["event"] for e in res.events] == ["rollback"]
          and bool(torch.isfinite(res.params["x"]).all()),
          f"divergence drill: events {res.events}")
    try:
        run_experiment(explode, {"x": torch.zeros(4, device="cuda")}, store,
                       dcfg, 4, checkpoint_every=2,
                       checkpoint_dir=os.path.join(tmp, "drill2"),
                       max_retries=2, lr_backoff=1.0)
        check(False, "divergence drill: no DivergenceError")
    except DivergenceError as e:
        check(e.retries == 2 and e.round == 2, f"divergence drill: {e}")
        print(f"divergence drill: rollback events {res.events}; then "
              f"DivergenceError: {e}")
    add()

    pcfg = FedZOConfig(weight_by_size=True, local_iters=1)
    ks = prng.split(prng.key(5), 3)
    idx = sample_participants(ks[0], task.store.n_clients,
                              pcfg.n_participating)
    batches = sample_batches(task.store, idx, ks[1], 1, pcfg.b1)
    rngs = prng.split(ks[2], pcfg.n_participating)
    p0 = neural.params_init(task, 0)
    bad = torch.zeros(pcfg.n_participating, dtype=torch.bool)
    bad[3] = True
    out = {}
    for name, rf in (("poisoned", RoundFaults(FaultModel(p_corrupt=0.5),
                                              ~torch.zeros_like(bad), bad)),
                     ("masked", RoundFaults(FaultModel(), ~bad,
                                            torch.zeros_like(bad)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fedzo.round_simulated(task.loss, p0, batches, rngs,
                                          pcfg, faults=rf)
        torch.cuda.synchronize()
        want = round_launches(ops, pcfg, 1, 2)
        check(dict(ops.LAUNCHES) == want, f"pytree faulted round {name}: "
              f"launches {dict(ops.LAUNCHES)} != {want}")
        add()
        print(f"pytree softmax round (H = 1) {name}: "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms; metrics "
              f"{ {k: float(v) for k, v in out[name][1].items()} }")
    check(_leaves_equal(torch, out["poisoned"][0], out["masked"][0]),
          "pytree poisoned round differs from the masked round")
    return one, total


def run_attack(torch, ops, tmp):
    """Part (c): the paper's Sec. V-A federated black-box attack at the
    reference task's width (32x32x3 images, d = 3,072; 10 clients with
    uneven shards, 512 attack images): ``attack.make_task`` on the card
    (300 SGD steps), then ``attack.run`` on the flat route (H = 20, b2 =
    20, full participation) for 5 rounds with the eval every 5 (exact
    launches), then ``attack.run_sweep`` over SNR {0, 10, 20} dB x seeds
    {0, 1}, 3 rounds each, into a CSV that must cover every scenario,
    round and metric. Returns the launches."""
    from repro_torch.workloads import attack

    total = dict.fromkeys(ops.LAUNCHES, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task = attack.make_task(device="cuda")
    torch.cuda.synchronize()
    print(f"attack task: classifier trained in "
          f"{time.perf_counter() - t0:.1f} s; clean accuracy "
          f"{task.clean_accuracy:.4f}; shards "
          f"{[len(c['y']) for c in task.clients]}")
    cfg = attack.default_config(task, flat_params=True)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = attack.run(task, cfg, 5, eval_every=5)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 5
    want = round_launches(ops, cfg, 5)
    check(dict(ops.LAUNCHES) == want, f"attack: launches "
          f"{dict(ops.LAUNCHES)} != {want}")
    for k in total:
        total[k] += ops.LAUNCHES[k]
    hist = res.history()
    check(all(math.isfinite(v) for r in hist for v in r.values()
              if isinstance(v, float)), f"attack: rows not finite {hist}")
    print(f"attack (flat, H {cfg.local_iters}, b2 {cfg.b2}, M "
          f"{cfg.n_participating}): {ms:.1f} ms/round; losses "
          f"{[round(r['mean_local_loss'], 5) for r in hist]}; "
          f"attack_success {float(res.evals['attack_success'][0]):.4f}, "
          f"eval CW loss {float(res.evals['eval_cw_loss'][0]):.5f} after "
          f"round 0; launches {dict(ops.LAUNCHES)}")
    out = os.path.join(tmp, "attack_snr.csv")
    ops.reset_launches()
    t0 = time.perf_counter()
    recs = attack.run_sweep(task, cfg, snr_dbs=(0.0, 10.0, 20.0),
                            seeds=(0, 1), rounds=3, eval_every=1,
                            out_csv=out)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    for k in total:
        total[k] += ops.LAUNCHES[k]
    with open(out) as f:
        lines = f.read().splitlines()
    n_rows = sum(3 * (len(r["metrics"]) + len(r["evals"])) for r in recs)
    tags = {ln.split(",")[0] for ln in lines[1:]}
    check(len(recs) == 6 and lines[0] == "scenario,round,metric,value"
          and len(lines) == 1 + n_rows and len(tags) == 6,
          f"attack sweep CSV: {len(lines)} lines, {len(tags)} scenarios")
    noise = {s: sum(float(r["metrics"]["aircomp_noise_std"].mean())
                    for r in recs if r["scenario"]["snr_db"] == s) / 2
             for s in (0.0, 10.0, 20.0)}
    check(noise[0.0] > noise[10.0] > noise[20.0] > 0,
          f"attack sweep: AirComp noise by SNR {noise}")
    succ = {s: [round(float(r["evals"]["attack_success"][-1]), 4)
                for r in recs if r["scenario"]["snr_db"] == s]
            for s in (0.0, 10.0, 20.0)}
    print(f"attack sweep: 6 scenarios x 3 rounds in {sweep_s:.1f} s; "
          f"noise std by SNR {json.dumps(noise)}; attack_success after "
          f"round 2 by SNR (seeds 0, 1) {json.dumps(succ)}; {len(lines)} "
          f"CSV lines")
    return total


def run_faults_channel(torch, ops, neural, FedZOConfig):
    """Phase "faults, channel and durability", parts (a)-(c). Prints each
    part's seconds and peak memory; returns (the 6-round faulted softmax
    result, {kernel: launches})."""
    import tempfile
    total = dict.fromkeys(ops.LAUNCHES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (
                ("qwen faulted round", lambda: run_faulted_qwen_round(
                    torch, ops, FedZOConfig)),
                ("neural durability", lambda: run_neural_durability(
                    torch, ops, neural, FedZOConfig, tmp)),
                ("attack", lambda: run_attack(torch, ops, tmp))):
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            got = fn()
            if isinstance(got, tuple):
                one, got = got
            print(f"part {name}: {time.perf_counter() - t:.1f} s, peak "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                  f"GiB")
            torch.cuda.empty_cache()
            for k in total:
                total[k] += got[k]
    return one, total


def check_faulted_reference(torch, neural, FedZOConfig, card):
    """References: the 6-round faulted softmax run of part (b) on the CPU
    against the card's: the fault and channel chains bitwise (they run on
    the CPU either way), the surviving and poisoned counts equal every
    round, the weights within the flat route's trajectory tolerance 1e-3
    (a loss ulp moves a ZO coefficient by d.ulp/mu)."""
    task, cfg, faults = faulted_softmax(neural, FedZOConfig, "cpu")
    cpu = neural.run(task, cfg, FAULT_ROUNDS, faults=faults)
    check(torch.equal(cpu.fault_state, card.fault_state) and all(
        torch.equal(a, b) for a, b in zip(cpu.channel_state,
                                          card.channel_state)),
        "faulted softmax card vs CPU: chains differ")
    for k in ("m_effective", "m_corrupt"):
        check(torch.equal(cpu.metrics[k], card.metrics[k].cpu()),
              f"faulted softmax card vs CPU: {k} differs")
    worst = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        card.params.values(), cpu.params.values()))
    check(worst <= 1e-3, f"faulted softmax card vs CPU: max |diff| {worst}")
    print(f"small reference (faulted softmax 784x10, 6 rounds, faults and "
          f"channel): card vs CPU max |diff| {worst:.3e} (limit 1e-3); "
          f"chains and masks equal")


def profile_call(torch, fn, out_dir, tag, timeline=True):
    """torch.profiler trace of one ``fn()`` after a warm-up call: kernel
    time by name and the device busy share (kernel time over wall time),
    written to ``out_dir/<tag>_profile.txt`` and, with ``timeline``, the
    chrome trace ``<tag>_trace.json`` (left out for calls of hundreds of
    thousands of launches, whose trace is larger than the run may bring
    back)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    if timeline:
        prof.export_chrome_trace(os.path.join(out_dir, f"{tag}_trace.json"))
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=25)
    with open(os.path.join(out_dir, f"{tag}_profile.txt"), "w") as f:
        f.write(table)
    # kernels are the events on the CUDA device; aten ops on the CPU carry a
    # copy of their kernels' time and are left out so nothing counts twice
    device_us = sum(e.self_device_time_total for e in avgs
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profile {tag}: wall {wall * 1e3:.3f} ms, kernel time "
          f"{device_us / 1e3:.3f} ms, device busy share "
          f"{device_us / 1e3 / (wall * 1e3):.3f}")
    # the port's own kernels, which the table may leave below its cut
    for e in avgs:
        if e.device_type == torch.autograd.DeviceType.CUDA and any(
                k in e.key for k in PORT_KERNELS):
            print(f"profile {tag}: {e.key[:72]}: "
                  f"{e.self_device_time_total / 1e3:.3f} ms in {e.count} "
                  f"launches")
    print(table)


def profile_round(torch, neural, FedZOConfig, out_dir):
    """One softmax round (no eval) under the profiler, on each route."""
    task = neural.make_task("softmax", n_features=784, n_classes=10,
                            n_clients=50)
    cfg = FedZOConfig(flat_params=True, weight_by_size=True)
    profile_call(torch, lambda: neural.run(task, cfg, 1, eval_every=0),
                 out_dir, "softmax_round")
    cfg = FedZOConfig(weight_by_size=True)
    profile_call(torch, lambda: neural.run(task, cfg, 1, eval_every=0),
                 out_dir, "softmax_pytree_round", timeline=False)


def profile_pytree_step(torch, FedZOConfig, out_dir):
    """One pytree Qwen2-0.5B train step (the CLI's configuration) under the
    profiler: kernel time by name and the busy share."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.utils import prng

    model, toks = lm_setup("qwen2-0.5b", "float32")
    params = model.init(prng.key(0), device="cuda")
    step = fedzo.make_train_step(model.loss, FedZOConfig(
        lr=1e-4, mu=1e-3, b2=QWEN_B2))
    batch = lm_batch(torch, toks, np.random.default_rng(0), 4, 128, "cuda")
    profile_call(torch, lambda: step(params, batch, prng.key(2)), out_dir,
                 "qwen2_pytree_step", timeline=False)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile a softmax round and a Qwen2-0.5B "
                    "train step on each route into DIR")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        die("chip_smoke: no CUDA device; this script runs the port on a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        die("chip_smoke: src/repro_torch not found; run from a checkout")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.base import FedZOConfig
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import (flash_attention, rmsnorm, zo_aircomp,
                                     zo_axpy)
    from repro_torch.workloads import neural

    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.BUILD_LOG.get('seconds', 0.0):.1f} s)")
    spills = []
    for src, log in build.BUILD_LOG.items():
        if src != "seconds":
            for line in log.splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill")):
                    print(f"ptxas {src}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores", line)
                if m and int(m.group(1)):
                    spills.append(f"{src}: {line.strip()}")
    print(f"ptxas spills: {spills or 'none'}")

    def timed(name, fn):
        """Run one phase, free its cached blocks, print its time."""
        t = time.perf_counter()
        out = fn()
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    rows = timed("kernels", lambda: check_kernels(torch, ops, zo_axpy,
                                                  zo_aircomp))
    rows.update(timed("lm kernels", lambda: check_lm_kernels(
        torch, ops, rmsnorm, flash_attention)))
    for name, f in timed("full width", lambda: check_full_width(
            torch, ops, zo_axpy, zo_aircomp)).items():
        rows[name]["full_width"] = f
    rows.update(timed("axpy kernels", lambda: check_axpy_kernels(
        torch, ops, zo_axpy)))
    launches = timed("rounds", lambda: run_main_path(torch, ops, neural,
                                                     FedZOConfig))
    for k, n in timed("transformer and wide rounds", lambda: run_track_rounds(
            torch, ops, neural, FedZOConfig)).items():
        launches[k] += n
    for name, phase in (
            ("qwen flat", lambda: run_qwen_train(torch, ops, FedZOConfig,
                                                 profile_dir=args.profile)),
            ("qwen flat round", lambda: run_qwen_flat_round(
                torch, ops, FedZOConfig)),
            ("tree_axpy2", lambda: run_tree_axpy2(torch, ops, zo_axpy)),
            ("qwen pytree cli", lambda: run_qwen_pytree_cli(torch, ops))):
        for k, n in timed(name, phase).items():
            launches[k] += n
    timed("references", lambda: (
        check_small_reference(torch, neural, FedZOConfig),
        check_pytree_small_reference(torch, neural, FedZOConfig),
        check_lm_small_reference(torch, FedZOConfig),
        check_lm_small_reference(torch, FedZOConfig, flat_params=False),
        check_lm_round_small_reference(torch, FedZOConfig),
        check_bf16_draws(torch),
        *(check_track_small_reference(torch, ops, neural, FedZOConfig, route)
          for route in ("flat", "pytree", "pytree bf16 sphere",
                        "pytree bf16 gaussian", "wide"))))
    for k, n in timed("algorithms and uplinks", lambda: run_algorithms(
            torch, ops, neural, FedZOConfig)).items():
        launches[k] += n
    faulted, counts = timed("faults, channel and durability",
                            lambda: run_faults_channel(torch, ops, neural,
                                                       FedZOConfig))
    for k, n in counts.items():
        launches[k] += n
    timed("faults references", lambda: check_faulted_reference(
        torch, neural, FedZOConfig, faulted))
    if args.profile:
        timed("profiles", lambda: (
            profile_round(torch, neural, FedZOConfig, args.profile),
            profile_pytree_step(torch, FedZOConfig, args.profile)))
    print(f"total: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name in ("zo_walk", "zo_replay", "zo_dirnorms", "aircomp_reduce",
                 "zo_axpy2", "zo_axpy", "rmsnorm", "flash_attention"):
        check(launches[name] > 0, f"{name} never launched on the main path")
        kernels.append({"name": name, "route": "cuda", **rows[name],
                        "launches": launches[name]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
