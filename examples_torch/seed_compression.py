"""Seed-compressed FedZO uplink on the PyTorch port (DESIGN.md §3.4).

    PYTHONPATH=src python examples_torch/seed_compression.py          # card
    PYTHONPATH=src python examples_torch/seed_compression.py --smoke --device cpu

Each client uploads (PRNG key, H×b2 coefficients) instead of a dense model
delta, and the server replays the seeds
(``fed.server.run_seed_compressed_round``): the dense round's update with
an uplink ~75× smaller even for the softmax model. 4 of 10 clients of 784
features a round, H = 5, b2 = 20, for 5 rounds; ``--smoke`` runs 64
features, H = 2, b2 = 4 for 2 rounds.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np                                          # noqa: E402
import torch                                                # noqa: E402

from repro_torch.configs.base import FedZOConfig            # noqa: E402
from repro_torch.data.synthetic import (make_classification,  # noqa: E402
                                        noniid_shards,
                                        sample_local_batches)
from repro_torch.fed.server import run_seed_compressed_round  # noqa: E402
from repro_torch.models.simple import softmax_init, softmax_loss  # noqa: E402
from repro_torch.utils import prng                          # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="64 features, H = 2, b2 = 4, 2 rounds")
    args = ap.parse_args(argv)
    feats, h, b2, rounds = (64, 2, 4, 2) if args.smoke else (784, 5, 20, 5)
    dev = torch.device(args.device)
    x, y = make_classification(4000, feats, 10, seed=0)
    clients = noniid_shards(x, y, 10)
    cfg = FedZOConfig(local_iters=h, lr=1e-3, mu=1e-3, b1=25, b2=b2)
    params = softmax_init(feats, 10, device=dev)
    full = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}
    rng = np.random.default_rng(0)
    key = prng.key(0)
    for t in range(rounds):
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                    sample_local_batches(clients[i], rng, h, cfg.b1).items()}
                   for i in range(4)]
        ks = prng.split(key, 5)
        key = ks[0]
        params, wire, dense = run_seed_compressed_round(
            softmax_loss, params, batches, ks[1:], cfg)
        print(f"round {t}: loss {float(softmax_loss(params, full)):.4f} "
              f"uplink {wire} B vs dense {dense} B "
              f"({dense / wire:.0f}x smaller)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
