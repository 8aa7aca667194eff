"""Train a CNN with FedZO on the PyTorch port (the Sec. V-B neural track,
DESIGN.md §11).

    PYTHONPATH=src python examples_torch/train_cnn.py               # card
    PYTHONPATH=src python examples_torch/train_cnn.py --smoke --device cpu
    PYTHONPATH=src python examples_torch/train_cnn.py --task transformer

A trainable LeNet-style SmallCNN on Dirichlet-label-skewed synthetic
image shards, through ``workloads.neural.run``: participation draws,
minibatch sampling, the H·b2 forward-only ZO queries per client, the
size-weighted aggregation and the top-1 test accuracy every 2 rounds.
``--task softmax`` or ``--task transformer`` swaps the model; no gradient
of the model is ever taken.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import sim                                 # noqa: E402
from repro_torch.workloads import neural                    # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="a test-sized run")
    ap.add_argument("--task", default="cnn",
                    choices=("softmax", "cnn", "transformer"))
    ap.add_argument("--rounds", type=int, default=0)
    args = ap.parse_args(argv)
    if args.smoke:
        task = neural.make_task(
            args.task, device=args.device, n_train=400, n_test=96,
            n_clients=6, n_classes=4,
            **({"image_shape": (12, 12, 1), "width": 4}
               if args.task == "cnn" else {"n_features": 32}))
        cfg = neural.default_config(task, local_iters=4, b1=16, b2=8,
                                    lr=2e-2 if args.task == "cnn" else 5e-2)
        rounds = args.rounds or 6
    else:
        task = neural.make_task(args.task, device=args.device, n_train=2000,
                                n_test=512, n_clients=10)
        cfg = neural.default_config(task, lr=5e-2)
        rounds = args.rounds or 30
    # the untrained baseline: the run's eval at round 0 follows the first
    # round's update
    acc0 = float(task.accuracy(neural.params_init(task, cfg.seed),
                               task.test))
    res = neural.run(task, cfg, rounds, eval_every=2)
    evals = [row for row in sim.history(res) if "test_acc" in row]
    for row in evals:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in row.items()})
    print(f"final test accuracy: {evals[-1]['test_acc']:.3f} "
          f"(untrained: {acc0:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
