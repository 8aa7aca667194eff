"""End-to-end LM training on the PyTorch port: ``repro_torch.launch.train``
on a decoder-only model over a synthetic token stream.

    PYTHONPATH=src python examples_torch/train_lm.py               # card
    PYTHONPATH=src python examples_torch/train_lm.py --full --steps 300
    PYTHONPATH=src python examples_torch/train_lm.py --smoke --device cpu

The default is FedAvg with Adam on ``qwen2-0.5b-smoke`` (batch 8 × 128
tokens, 60 steps); ``--full`` trains the full-width ``qwen2-0.5b`` (batch
4 × 256, 300 steps, lr 1e-3); ``--smoke`` runs 4 steps at batch 2 × 32.
Any other flag goes to the CLI as it is (``--algo fedzo`` for the
zeroth-order step). ``--device`` defaults to the card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch import train                        # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the full-width qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="4 steps at batch 2 x 32 tokens")
    args, rest = ap.parse_known_args(argv)
    arch, batch, seq, lr, steps, every = (
        ("qwen2-0.5b", 4, 256, 1e-3, 300, 10) if args.full else
        ("qwen2-0.5b-smoke", 2, 32, 3e-3, 4, 1) if args.smoke else
        ("qwen2-0.5b-smoke", 8, 128, 3e-3, 60, 10))
    cmd = ["--arch", arch, "--batch", str(batch), "--seq", str(seq),
           "--algo", "fedavg", "--opt", "adam", "--lr", str(lr),
           "--steps", str(steps), "--log-every", str(every),
           "--device", args.device, *rest]
    print("running: repro_torch.launch.train", " ".join(cmd))
    train.main(cmd)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
