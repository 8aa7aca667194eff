"""Batched serving example on the PyTorch port: one prefill, then a
streaming greedy decode against the ring KV cache (and, for the ssm and
hybrid families, the recurrent state).

    PYTHONPATH=src python examples_torch/serve_lm.py [--arch hymba-1.5b-smoke]
    PYTHONPATH=src python examples_torch/serve_lm.py --smoke --device cpu

Runs ``repro_torch.launch.serve`` (the reference example's
``repro.launch.serve``) on ``--arch`` (default ``qwen2-0.5b-smoke``) with 4
requests of 32 prompt tokens and 16 decode steps; ``--smoke`` serves 2
requests of 16 tokens for 4 steps. Any other flag goes to the CLI as it
is. ``--device`` defaults to the card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch import serve                        # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b-smoke")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="2 requests of 16 prompt tokens, 4 decode steps")
    args, rest = ap.parse_known_args(argv)
    batch, prompt, gen = (2, 16, 4) if args.smoke else (4, 32, 16)
    cmd = ["--arch", args.arch, "--device", args.device, "--batch",
           str(batch), "--prompt-len", str(prompt), "--gen", str(gen), *rest]
    print("running: repro_torch.launch.serve", " ".join(cmd))
    serve.main(cmd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
