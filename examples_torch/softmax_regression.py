"""Paper Sec. V-B on the PyTorch port: softmax regression on a non-iid
split, FedZO against FedAvg, with and without AirComp (Figs. 3-5 in one
script).

    PYTHONPATH=src python examples_torch/softmax_regression.py          # card
    PYTHONPATH=src python examples_torch/softmax_regression.py --smoke --device cpu

50 clients of 784 features, 20 sampled per round, 15 rounds each of
FedZO at H = 5 and H = 20, FedAvg at H = 5 and FedZO with AirComp at 0
dB, all through ``FedServer`` on a device ``ClientStore``. ``--smoke``
runs 20 clients of 32 features, 4 sampled, b2 = 4, for 2 rounds.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch                                                # noqa: E402

from repro_torch import sim                                 # noqa: E402
from repro_torch.configs.base import FedZOConfig            # noqa: E402
from repro_torch.data.synthetic import (make_classification,  # noqa: E402
                                        noniid_shards)
from repro_torch.fed.server import FedServer                # noqa: E402
from repro_torch.models.simple import (softmax_accuracy,    # noqa: E402
                                       softmax_init, softmax_loss)

RUNS = (("FedZO  H=5 ", dict(strategy="fedzo", local_iters=5)),
        ("FedZO  H=20", dict(strategy="fedzo", local_iters=20)),
        ("FedAvg H=5 ", dict(strategy="fedavg", local_iters=5)),
        ("FedZO  H=5 AirComp 0dB", dict(strategy="fedzo", local_iters=5,
                                        aircomp=True, snr_db=0.0)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="20 clients of 32 features, 2 rounds")
    args = ap.parse_args(argv)
    feats, n_clients, m, b2, rounds = ((32, 20, 4, 4, 2) if args.smoke
                                       else (784, 50, 20, 20, 15))
    n_train = 120 * n_clients
    x, y = make_classification(n_train + 1000, feats, 10, seed=0)
    clients = noniid_shards(x[:n_train], y[:n_train], n_clients)
    test = {"x": torch.from_numpy(x[n_train:]).to(args.device),
            "y": torch.from_numpy(y[n_train:]).to(args.device)}
    store = sim.build_store(clients, device=args.device)
    for name, kw in RUNS:
        cfg = FedZOConfig(n_devices=n_clients, n_participating=m, lr=1e-3,
                          mu=1e-3, b1=25, b2=b2, **kw)
        srv = FedServer(softmax_loss, softmax_init(feats, 10,
                                                   device=args.device),
                        clients, cfg, store=store)
        srv.run(rounds)
        print(f"{name}: test acc "
              f"{float(softmax_accuracy(srv.params, test)):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
