#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FedZO on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout (it imports ``src/repro_torch``). Phases,
each of which raises on a failure (the script then exits non-zero):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
2. Hold every kernel against its plain PyTorch version on the card, at the
   main path's shapes (M = 10 clients, n_pad = 65,536, d = 7,850, b2 = 20),
   for both direction kinds and a ragged length that is not a multiple of
   the CUDA block. Tolerances: the sign kind bitwise; the normal kind within
   4 ulp of the magnitude of the summed terms; the reductions within a
   relative 1e-5 (another summation order). Each kernel is timed with CUDA
   events beside its plain version and its bound.
3. The main path, through the entry points a user calls: softmax regression
   784x10 (the paper's Sec. V-B model) on 50 clients with the FedZOConfig
   defaults (N=50, M=10, H=5, b1=25, b2=20), flat_params and size-weighted
   aggregation, 5 rounds; the same with AirComp (channel scheduling, 5 dB);
   the SmallCNN (28x28x1, width 8), 2 rounds. The launch counters are set
   to 0 before each run and must equal exactly what the run implies.
4. A small-input reference: a short softmax run on the card against the
   same run on the CPU (plain versions), within the float32 tolerance of a
   ZO trajectory.

The line before the last is the JSON kernel table, the last line
``{"ok": true, "device": {...}}``. ``--profile DIR`` adds a torch.profiler
trace of one softmax round (kernel time by name, device busy share),
written to DIR.
"""
from __future__ import annotations

import argparse
import json
import math
import os
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
    k = keys(M)
    # stage 1 runs 256 threads on each zo_norm_chunk()-long chunk of [0, d)
    norm_chunk = ops.build.load()["zo_axpy"].zo_norm_chunk()
    ms = median_ms(torch, lambda: ops.zo_dirnorms(k, D, b2=B2), 50)
    plain_ms = median_ms(torch, lambda: plain.zo_dirnorms_plain(k, D, b2=B2),
                         3)
    rows["zo_dirnorms"] = dict(
        source="src/repro_torch/kernels/csrc/zo_axpy.cu",
        replaces="src/repro/kernels/zo_axpy.py:302", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(M * 16 + M * B2 * 4,
                threefry_ops(M * B2 * D, M * B2 * -(-D // norm_chunk) * 256),
                "int"))

    # aircomp_reduce: (sum_m s[m].x[m], |x[m, :d]|^2)
    errs = []
    for n in (N_PAD, RAGGED):
        x, s = rnd(M, n) * 1e-3, torch.rand(M, generator=g, device=dev)
        mean, sq = ops.aircomp_reduce(x, s, D)
        pmean, psq = plain_air.aircomp_reduce_plain(x, s, D)
        check(torch.equal(mean, pmean), f"aircomp_reduce mean n={n} differs")
        rel = float(((sq - psq).abs() / psq.abs()).max())
        check(rel <= 1e-5, f"aircomp_reduce sq n={n}: rel {rel}")
        errs.append(max(float((mean - pmean).abs().max()),
                        float((sq - psq).abs().max())))
        lines.append(f"aircomp_reduce n={n}: mean bitwise, sq rel {rel:.2e}")
    x, s = rnd(M, N_PAD) * 1e-3, torch.rand(M, generator=g, device=dev)
    ms = median_ms(torch, lambda: ops.aircomp_reduce(x, s, D), 50)
    plain_ms = median_ms(torch,
                         lambda: plain_air.aircomp_reduce_plain(x, s, D), 5)
    # yardstick only, never called by the port: one matvec + one row norm
    library_ms = median_ms(
        torch, lambda: (s @ x, x[:, :D].square().sum(1)), 50)
    rows["aircomp_reduce"] = dict(
        source="src/repro_torch/kernels/csrc/zo_aircomp.cu",
        replaces="src/repro/kernels/zo_aircomp.py:75", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(M * N_PAD * 4 + N_PAD * 4 + M * 8,
                2 * M * N_PAD + 2 * M * D, "fp32"))
    for line in lines:
        print(line)
    return rows


def threefry_ops(evals, threads):
    """int32 operations of ``evals`` Threefry evaluations made by
    ``threads`` threads."""
    return evals * THREEFRY_EVAL_OPS + threads * THREEFRY_THREAD_OPS


def bound(nbytes, ops, kind):
    """Least time: the larger of bytes over HBM rate and operations over the
    peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (INT32_OP_PER_S if kind == "int" else FP32_FLOP_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def run_main_path(torch, ops, neural, FedZOConfig):
    """Phase 3. Returns {kernel: launches summed over the runs}."""
    softmax = neural.make_task("softmax", n_features=784, n_classes=10,
                               n_clients=50)
    cnn = neural.make_task("cnn", image_shape=(28, 28, 1), width=8,
                           n_clients=50)
    base = dict(flat_params=True, weight_by_size=True)
    runs = [("softmax_flat", softmax, FedZOConfig(**base), 5),
            ("softmax_aircomp", softmax,
             FedZOConfig(**base, aircomp=True, channel_schedule=True,
                         snr_db=5.0), 5),
            ("cnn_flat", cnn, FedZOConfig(**base), 2)]
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
        iters = rounds * cfg.local_iters
        want = {"zo_walk": iters * cfg.b2 + (rounds if cfg.aircomp else 0),
                "zo_replay": iters, "zo_dirnorms": iters,
                "aircomp_reduce": rounds if cfg.aircomp else 0}
        check(counts == want, f"{name}: launches {counts} != {want}")
        evals = {k: float(v)
                 for k, v in neural.task_eval(task)(params).items()}
        for k, v in list(mets.items()) + [(k, [v]) for k, v in evals.items()]:
            check(all(map(math.isfinite, v)), f"{name}: {k} not finite: {v}")
        for k, p in params.items():
            check(bool(torch.isfinite(p).all()), f"{name}: param {k}")
        check(mets["mean_local_loss"][-1] < mets["first_loss"][0],
              f"{name}: loss did not descend: {mets}")
        steady = sorted(per_round[1:])  # round 1 carries one-time set-up
        print(f"{name}: ms/round {[round(t, 3) for t in per_round]} "
              f"(median after round 1 {steady[len(steady) // 2]:.3f}); "
              f"launches {counts}")
        print(f"{name}: metrics {json.dumps(mets)}")
        print(f"{name}: evals {json.dumps(evals)}")
        for k in total:
            total[k] += counts[k]
    return total


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


def profile_round(torch, neural, FedZOConfig, out_dir):
    from torch.profiler import ProfilerActivity, profile
    task = neural.make_task("softmax", n_features=784, n_classes=10,
                            n_clients=50)
    cfg = FedZOConfig(flat_params=True, weight_by_size=True)
    neural.run(task, cfg, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        neural.run(task, cfg, 1, eval_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          "softmax_round_trace.json"))
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=25)
    with open(os.path.join(out_dir, "softmax_round_profile.txt"), "w") as f:
        f.write(table)
    # kernels are the events on the CUDA device; aten ops on the CPU carry a
    # copy of their kernels' time and are left out so nothing counts twice
    device_us = sum(e.self_device_time_total for e in avgs
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profile: one softmax round (no eval) wall {wall * 1e3:.3f} ms, "
          f"kernel time {device_us / 1e3:.3f} ms, device busy share "
          f"{device_us / 1e3 / (wall * 1e3):.3f}")
    print(table)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one softmax round into DIR")
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
    from repro_torch.kernels import zo_aircomp, zo_axpy
    from repro_torch.workloads import neural

    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.BUILD_LOG.get('seconds', 0.0):.1f} s)")
    for src, log in build.BUILD_LOG.items():
        if src != "seconds":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {src}: {line.strip()}")

    rows = check_kernels(torch, ops, zo_axpy, zo_aircomp)
    launches = run_main_path(torch, ops, neural, FedZOConfig)
    check_small_reference(torch, neural, FedZOConfig)
    if args.profile:
        profile_round(torch, neural, FedZOConfig, args.profile)

    kernels = []
    for name in ("zo_walk", "zo_replay", "zo_dirnorms", "aircomp_reduce"):
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
