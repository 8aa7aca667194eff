"""Quickstart on the PyTorch port: FedZO (paper Algorithm 1) on non-iid
softmax regression under the engine's fast execution strategy
(``sim.fast_sim_config``: the wide ``block`` route with unsafe_rbg keys,
every direction block one ``philox_bits`` launch).

    PYTHONPATH=src python examples_torch/quickstart.py              # card
    PYTHONPATH=src python examples_torch/quickstart.py --smoke --device cpu

50 clients, 10 sampled per round, H = 5 local zeroth-order steps: the
synthetic separable problem is learned in about 20 rounds without a
gradient. The client datasets live on the device in a ``ClientStore``, and
``FedServer.run`` drives the engine's experiment function (the
counterpart of the reference's one compiled scan). ``--smoke`` runs a small
federation for a few rounds.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="20 clients of 64 features, 4 rounds")
    args = ap.parse_args(argv)
    feats, n_clients, rounds = (64, 20, 4) if args.smoke else (784, 50, 20)
    n_train = 120 * n_clients
    x, y = make_classification(n_train + 1000, feats, 10, seed=0)
    clients = noniid_shards(x[:n_train], y[:n_train], n_clients)
    test = {"x": torch.from_numpy(x[n_train:]).to(args.device),
            "y": torch.from_numpy(y[n_train:]).to(args.device)}

    cfg = sim.fast_sim_config(
        FedZOConfig(n_devices=n_clients, n_participating=10, local_iters=5,
                    lr=1e-3, mu=1e-3, b1=25, b2=20))
    server = FedServer(softmax_loss, softmax_init(feats, 10,
                                                  device=args.device),
                       clients, cfg,
                       store=sim.build_store(clients, device=args.device),
                       jit_eval=lambda p: {
                           "test_acc": softmax_accuracy(p, test)},
                       eval_every=5)
    server.run(rounds, log_every=5)
    acc = float(softmax_accuracy(server.params, test))
    print(f"final test accuracy: {acc:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
