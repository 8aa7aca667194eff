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
     against SDPA at [4, 128, 14 or 8, D].
   - zo_axpy and zo_axpy2, bitwise, for float32 and bfloat16 x with u, v
     in x's dtype or float32: ragged n (1, 7, 65,537), views at odd element
     offsets, and Qwen2-0.5B's largest leaves (the tied embedding
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
   The launch counters are set to 0 before each run (each train step) and
   must equal exactly what it implies.
4. Small-input references: a short softmax run on each route, 3 train
   steps of qwen2-0.5b-smoke on each route and one flat round of it over 3
   clients, each on the card against the same run on the CPU (plain
   versions), within the float32 tolerance of a ZO trajectory.

The line before the last is the JSON kernel table, the last line
``{"ok": true, "device": {...}}``. ``--profile DIR`` adds torch.profiler
traces of one softmax round and one Qwen2-0.5B train step (kernel time by
name, device busy share), written to DIR, and the kernel table (no
timeline) of one pytree softmax round and one pytree Qwen2-0.5B step.
"""
from __future__ import annotations

import argparse
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
    for dts in ((f32, f32, f32), (bf16, bf16, bf16), (bf16, f32, f32),
                (bf16, bf16, f32)):
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
                 f"cases (dtypes, ragged, offsets, Qwen2 leaves)")
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
    xb = x.bfloat16()
    ms_b = median_ms(torch, lambda: ops.axpy(xb, u, mu), 20)
    bound_b = bound(8 * n, 2 * n, "fp32")["bound_ms"]
    lines.append("zo_axpy bf16 x, f32 u {}: ms {:.5f} plain {:.5f} library "
                 "{:.5f} bound {:.5f} ({:.1%} of it)".format(
                     list(QWEN_EMBED), ms_b,
                     median_ms(torch, lambda: plain.zo_axpy_plain(xb, u, mu),
                               5),
                     median_ms(torch, lambda: torch.add(xb, u, alpha=1e-3),
                               20),
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


def route_launches(ops, cfg, rounds, n_leaves):
    """Launches of ``rounds`` simulated rounds: the flat route's walks,
    replays and norms per iterate (one launch covers the cohort), or the
    pytree route's zo_axpy per client, iterate, direction end and leaf."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    iters = rounds * cfg.local_iters
    if cfg.flat_params:
        want.update(zo_walk=iters * cfg.b2 + (rounds if cfg.aircomp else 0),
                    zo_replay=iters, zo_dirnorms=iters,
                    aircomp_reduce=rounds if cfg.aircomp else 0)
    else:
        want["zo_axpy"] = (iters * cfg.n_participating * 2 * cfg.b2
                           * n_leaves)
    return want


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
    total = {k: 0 for k in ops.LAUNCHES}
    for name, task, cfg, rounds in runs:
        # one round per call, the carry passed back in, so each round is
        # timed on its own; the test set is evaluated once, after the run
        ops.reset_launches()
        params = key = momentum = None
        per_round, mets = [], {}
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = neural.run(task, cfg, 1, eval_every=0, params=params,
                             key=key, momentum=momentum)
            torch.cuda.synchronize()
            per_round.append(1e3 * (time.perf_counter() - t0))
            params, key, momentum = res.params, res.key, res.momentum
            for k, v in res.metrics.items():
                mets.setdefault(k, []).extend(v.cpu().tolist())
        counts = dict(ops.LAUNCHES)
        want = route_launches(ops, cfg, rounds, len(params))
        check(counts == want, f"{name}: launches {counts} != {want}")
        evals = {k: float(v)
                 for k, v in neural.task_eval(task)(params).items()}
        for k, v in list(mets.items()) + [(k, [v]) for k, v in evals.items()]:
            check(all(map(math.isfinite, v)), f"{name}: {k} not finite: {v}")
        for k, p in params.items():
            check(bool(torch.isfinite(p).all()), f"{name}: param {k}")
        check(mets["mean_local_loss"][-1] < mets["first_loss"][0],
              f"{name}: loss did not descend: {mets}")
        # round 1 carries one-time set-up (a one-round run has only it)
        steady = sorted(per_round[1:]) or per_round
        print(f"{name}: ms/round {[round(t, 3) for t in per_round]} "
              f"(median after round 1 {steady[len(steady) // 2]:.3f}); "
              f"launches {counts}")
        print(f"{name}: metrics {json.dumps(mets)}")
        print(f"{name}: evals {json.dumps(evals)}")
        for k in total:
            total[k] += counts[k]
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


def flat_round_launches(ops, cfg, L):
    """Launches of one flat round of the dense LM: per iterate one
    zo_dirnorms, b2 zo_walks, one zo_replay and b2 + 1 batched forwards
    (2L + 1 RMSNorms and L attentions each); AirComp adds its reduction and
    the noise walk. None depends on the number of clients."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    H, b2, air = cfg.local_iters, cfg.b2, int(cfg.aircomp)
    want.update(zo_walk=H * b2 + air, zo_replay=H, zo_dirnorms=H,
                aircomp_reduce=air, rmsnorm=H * (b2 + 1) * (2 * L + 1),
                flash_attention=H * (b2 + 1) * L)
    return want


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
        want = flat_round_launches(ops, cfg, L)
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
        check_lm_round_small_reference(torch, FedZOConfig)))
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
