"""Scale past device memory on the PyTorch port: the tiered ``HostStore``
and its prefetched cohort stream.

The resident ``ClientStore`` pads every client to the largest and keeps
the whole ``[N, cap, ...]`` federation on the card. The tiered store keeps
the population in host memory, bucketed by size, and stages only each
segment's sampled cohorts (plus one prefetch buffer) on the device,
bitwise the resident run. The run uses ``sim.fast_sim_config``.

    PYTHONPATH=src python examples_torch/tiered_scale.py --smoke --device cpu
    PYTHONPATH=src python examples_torch/tiered_scale.py --clients 100000

It prints the residency split (host bytes against the peak staged segment)
and the prefetch stall share; ``--smoke`` (50,000 clients) also checks the
run bitwise against the resident store.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch                                                # noqa: E402

from repro_torch import sim                                 # noqa: E402
from repro_torch.configs.base import FedZOConfig            # noqa: E402
from repro_torch.data.synthetic import make_classification  # noqa: E402
from repro_torch.models.simple import (softmax_init,        # noqa: E402
                                       softmax_loss)
from repro_torch.utils.tree import tree_leaves              # noqa: E402


def ragged_population(n_clients, lo=6, hi=13, seed=1):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, size=n_clients)
    x, y = make_classification(int(sizes.sum()), 24, 4, seed=seed)
    ends = np.cumsum(sizes)
    return [{"x": x[e - s:e], "y": y[e - s:e]} for s, e in zip(sizes, ends)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, default=100_000)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="50k clients and the bitwise resident check")
    ap.add_argument("--no-crosscheck", action="store_true",
                    help="skip the resident bitwise check")
    args = ap.parse_args(argv)
    n = 50_000 if args.smoke else args.clients

    print(f"building N={n} ragged federation ...")
    clients = ragged_population(n)
    host = sim.build_host_store(clients, n_buckets=4)
    cfg = sim.fast_sim_config(FedZOConfig(
        n_devices=n, n_participating=32, local_iters=2, lr=1e-2, mu=1e-3,
        b1=4, b2=4, seed=7))
    p0 = softmax_init(24, 4, device=args.device)
    caps = [(b.cap, len(b.ids)) for b in host.buckets]
    print(f"host store: {host.n_buckets} buckets (cap, n): {caps}, "
          f"{host.nbytes / 1e6:.1f} MB host-resident")

    tier = sim.run_experiment(softmax_loss, p0, host, cfg, args.rounds)
    pf = tier.prefetch
    print(f"tiered run: {tier.rounds} rounds, "
          f"{pf['wall_s'] / tier.rounds * 1e3:.1f} ms/round | "
          f"device segment peak {pf['device_segment_bytes_max'] / 1e6:.2f} "
          f"MB vs {pf['host_bytes'] / 1e6:.1f} MB host | "
          f"prefetch stall {pf['stall_pct']:.1f}%")
    loss = float(tier.metrics["mean_local_loss"][-1])
    assert np.isfinite(loss), "diverged"
    print(f"final mean local loss: {loss:.4f}")

    if args.smoke and not args.no_crosscheck:
        print("cross-checking against the resident store ...")
        res = sim.run_experiment(
            softmax_loss, p0, sim.build_store(clients, device=args.device),
            cfg, args.rounds)
        for k in res.metrics:
            assert torch.equal(res.metrics[k], tier.metrics[k]), k
        for a, b in zip(tree_leaves(res.params), tree_leaves(tier.params)):
            assert torch.equal(a, b)
        assert torch.equal(res.key, tier.key)
        print(f"bitwise tiered == resident at N={n}: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
