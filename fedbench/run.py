"""Run one cell of the port's benchmark once and print its result line.

    python3 fedbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port's package under ``src/``. The last line of standard output
is one JSON object: ``correct``, ``attempted`` (rounds in the window),
``failed`` (of those, rounds whose mean local loss is not finite),
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check
compares, with its limit (also the last lines of standard error).

Exits 2 without a result when there is no card or fewer than the cell
asks for, 3 when the port cannot be imported, 4 when a module of the JAX
reference or of its benchmarks was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# this folder's modules are imported as fedbench.*, never as top-level
# names that could shadow the standard library's
sys.path = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# build and kernel caches of the program and of torch, at fixed paths
# inside the checkout (git ignores build/)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "nv_compute"}


def banned_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(BANNED))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "fedbench", sub)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

    import torch
    torch.set_num_threads(2)
    from fedbench import cell as fcell
    c = fcell.load(args.workload, os.path.join(ROOT, "BENCHMARK.json"))
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"fedbench: {args.workload} needs {c.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"fedbench: the port is not importable from {ROOT}/src: {e}",
              file=sys.stderr)
        return 3
    from fedbench import check, harness
    out = harness.run(c, args.seed, args.seconds, args.trace, t0=T0)
    values = check.readings(c, args.seed, out, "cuda")
    found = banned_modules()
    if found:
        print(f"fedbench: modules loaded that the benchmark must not load: "
              f"{found}", file=sys.stderr)
        return 4
    correct, checks = check.judge(values, c.limits)
    correct = correct and out.failed == 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": c.chips, "memory_peak_bytes": int(out.peak_bytes)}
    if args.trace:
        metrics = {}
        for m in c.per_layer:
            v = fcell.reader(m["name"])(out.window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=out.window.busy_s, window_s=out.window.window_s)
    else:
        e2e = {"round_ms": 1e3 * out.window_s / out.rounds,
               "peak_gib": out.peak_bytes / 2 ** 30,
               "setup_s": out.setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in c.end_to_end}
    result = {"correct": bool(correct), "attempted": out.rounds,
              "failed": out.failed, "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = out.breakdown
    result["checks"] = checks
    print(f"fedbench: set-up seconds {json.dumps(out.setup_parts)}; window "
          f"{out.window_s:.3f} s, {out.rounds} rounds", file=sys.stderr)
    print(f"fedbench: {args.workload} seed {args.seed}: worst loss gap at "
          f"{values['loss_gap_at']}", file=sys.stderr)
    for name, ch in checks.items():
        print(f"check {name} {ch['value']!r} limit {ch['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
