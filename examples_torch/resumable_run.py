"""Survive a preemption on the PyTorch port: durable checkpoints and
resume.

The engine runs in k-round segments; after each one the full carry
(params, momentum, key, fault chains, metrics ring, eval buffer) is
snapshotted atomically to disk. Kill the process at any point and resume
finishes the run bitwise the uninterrupted one. Client faults (an
availability chain, stragglers, corrupted uploads) show the finite guard
and ``m_effective``; the run uses ``sim.fast_sim_config``.

    # 24 rounds, a snapshot every 4
    PYTHONPATH=src python examples_torch/resumable_run.py --dir /tmp/fedzo_ck
    # a preemption drill: SIGKILL after 2 segments, then resume and check
    PYTHONPATH=src python examples_torch/resumable_run.py --dir /tmp/fedzo_ck \\
        --fresh --kill-after 2
    PYTHONPATH=src python examples_torch/resumable_run.py --dir /tmp/fedzo_ck \\
        --resume --reference-check

``--smoke`` runs 8 rounds and the reference check.
"""
import argparse
import os
import shutil
import signal
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch                                                # noqa: E402

from repro_torch import sim                                 # noqa: E402
from repro_torch.configs.base import FedZOConfig            # noqa: E402
from repro_torch.data.synthetic import (make_classification,  # noqa: E402
                                        noniid_shards)
from repro_torch.models.simple import (softmax_accuracy,    # noqa: E402
                                       softmax_init, softmax_loss)
from repro_torch.utils.tree import tree_leaves              # noqa: E402


def build(device):
    x, y = make_classification(2000, 64, 8, seed=0)
    clients = noniid_shards(x[:1600], y[:1600], 16)
    test = {"x": torch.from_numpy(x[1600:]).to(device),
            "y": torch.from_numpy(y[1600:]).to(device)}
    cfg = sim.fast_sim_config(
        FedZOConfig(n_devices=16, n_participating=6, local_iters=3,
                    lr=5e-3, mu=1e-3, b1=16, b2=8))
    faults = sim.FaultModel(p_fail=0.1, p_recover=0.5, deadline=3.0,
                            p_corrupt=0.05)
    return (softmax_loss, softmax_init(64, 8, device=device),
            sim.build_store(clients, device=device), cfg, faults, test)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--checkpoint-every", type=int, default=4)
    ap.add_argument("--dir", default="/tmp/fedzo_resumable")
    ap.add_argument("--fresh", action="store_true",
                    help="wipe the checkpoint dir before starting")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest snapshot in --dir")
    ap.add_argument("--kill-after", type=int, default=0, metavar="N",
                    help="SIGKILL this process after N snapshotted segments")
    ap.add_argument("--reference-check", action="store_true",
                    help="rerun uninterrupted and check the resumed run is "
                         "bitwise equal")
    ap.add_argument("--smoke", action="store_true",
                    help="8 rounds from a fresh dir, with the reference "
                         "check")
    args = ap.parse_args(argv)
    if args.smoke:
        args.rounds, args.fresh, args.reference_check = 8, True, True

    if args.fresh and os.path.isdir(args.dir):
        shutil.rmtree(args.dir)
    loss, p0, store, cfg, faults, test = build(args.device)

    def on_segment(t, total):
        print(f"  snapshot @ round {t}/{total} -> {args.dir}")
        if args.kill_after and t >= args.kill_after * args.checkpoint_every:
            print("  simulating preemption: SIGKILL")
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)

    def ev(p):
        return {"test_acc": softmax_accuracy(p, test)}

    res = sim.run_experiment(
        loss, p0, store, cfg, args.rounds, faults=faults, eval_fn=ev,
        eval_every=4, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.dir, resume=args.resume,
        segment_callback=on_segment)

    rows = sim.history(res)
    acc = [r["test_acc"] for r in rows if "test_acc" in r]
    print(f"finished {res.rounds} rounds; m_effective last round: "
          f"{rows[-1].get('m_effective'):.0f}; "
          f"test_acc: {acc[-1] if acc else float('nan'):.3f}")

    if args.reference_check:
        ref = sim.run_experiment(loss, p0, store, cfg, args.rounds,
                                 faults=faults, eval_fn=ev, eval_every=4)
        for a, b in zip(tree_leaves(res.params), tree_leaves(ref.params)):
            assert torch.equal(a, b)
        for k in ref.metrics:
            assert torch.equal(res.metrics[k], ref.metrics[k]), k
        print("reference check: resumed run is bitwise the uninterrupted "
              "one")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
