"""The readings a cell's correctness limits are set from, on the chip.

    python3 fedbench/readings.py --workload <name> --seeds <a,b,...> \
        [--runs sound,control,half_batch,token]

For each seed and each kind of run, in one process: the harness's set-up,
round 0 and one window round, with the round below in the program's
place, then the check's four numbers against the sound reference on the
true inputs (``check.readings``), at the cell's own size:

- ``sound``: the program as the configuration states it (the lower
  readings);
- ``control``: the program with TF32 on in every round, the precision
  below the configuration's float32 with TF32 off;
- ``half_batch``: every client's rows halved as the round is fed, the
  mean taken over the rest;
- ``token``: the first client's first label altered as the round is fed.

A round that returns its state unchanged reads 1 by ``update_norm_gap``,
``update_sample_gap`` and ``walk_gap`` (no change against the
reference's) and needs no run. One JSON line a run on standard output.
The benchmark's own runs never run this.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path = [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def _round(loss, params, batches, keys, cfg, **kw):
    from repro_torch.core import fedzo
    return fedzo.round_simulated(loss, params, batches, keys, cfg, **kw)


def control(cell):
    """The program's round with TF32 on."""
    def round_fn(*args, **kw):
        cell.family.set_tf32(True)
        try:
            return _round(*args, **kw)
        finally:
            cell.family.set_tf32(False)
    return round_fn


def half_batch(cell):
    """The program's round with every client's rows halved."""
    def round_fn(loss, params, batches, *args, **kw):
        half = {k: v[:, :, : v.shape[2] // 2] for k, v in batches.items()}
        return _round(loss, params, half, *args, **kw)
    return round_fn


def token(cell):
    """The program's round with the first client's first label altered."""
    def round_fn(loss, params, batches, *args, **kw):
        labels = batches["labels"].clone()
        labels[0, 0, 0, 0] = (labels[0, 0, 0, 0] + 1) % cell.cfg["vocab"]
        return _round(loss, params, dict(batches, labels=labels), *args,
                      **kw)
    return round_fn


RUNS = {"sound": None, "control": control, "half_batch": half_batch,
        "token": token}


def run_readings(cell, seed, kind, device="cuda"):
    """The check's numbers of one run of ``kind`` (a key of ``RUNS``) and
    whether the check judges it correct."""
    from fedbench import check, harness
    make = RUNS[kind]
    out = harness.run(cell, seed, 0.0, 0, device=device,
                      round_fn=make and make(cell))
    vals = check.readings(cell, seed, out, device)
    ok, _ = check.judge(vals, cell.limits)
    return vals, ok and out.failed == 0


def main(argv=None):
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--runs", default=",".join(RUNS))
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    from fedbench import cell as fcell
    c = fcell.load(args.workload, os.path.join(ROOT, "BENCHMARK.json"))
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind in args.runs.split(","):
            vals, ok = run_readings(c, seed, kind)
            torch.cuda.empty_cache()
            print(json.dumps({"workload": c.name, "seed": seed, "run": kind,
                              "correct": ok, **vals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
