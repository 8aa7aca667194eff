"""A city of moving devices on the PyTorch port: correlated fading and
energy budgets (``sim.ChannelModel``).

Each of the N devices carries a time-correlated AR(1) fading chain set by
a Doppler knob (``from_doppler``) and a battery debited by the Eq.-15
transmit budget every round it transmits; drained devices drop out of the
aggregate like deep-fade ones, and ``m_effective`` reports the survivors.
The scenario advances inside the round loop, under the engine's fast
execution strategy (``sim.fast_sim_config``).

    PYTHONPATH=src python examples_torch/wireless_scenario.py            # card
    PYTHONPATH=src python examples_torch/wireless_scenario.py --smoke --device cpu

``--smoke`` also checks that the energy ledger balances exactly and that
the tiered store lands on the resident run's bits, chain and batteries
included.
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
from repro_torch.sim import channel as channel_lib          # noqa: E402
from repro_torch.utils.tree import tree_leaves              # noqa: E402


def population(n_clients, n=4000, seed=0):
    x, y = make_classification(n, 24, 4, seed=seed)
    per = n // n_clients
    return [{"x": x[i * per:(i + 1) * per], "y": y[i * per:(i + 1) * per]}
            for i in range(n_clients)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run and the bitwise tiered check")
    args = ap.parse_args(argv)
    n = 16 if args.smoke else args.clients
    rounds = 10 if args.smoke else args.rounds

    clients = population(n, n=80 * n)
    store = sim.build_store(clients, device=args.device)
    p0 = softmax_init(24, 4, device=args.device)

    # a pedestrian city block: fd·T = 0.02, the channel stays coherent for
    # about 8 rounds; every device starts with a finite transmit budget
    city = sim.ChannelModel.from_doppler(0.02, battery=float(rounds) * 0.6,
                                         tx_cost=1.0)
    print(f"scenario: rho={city.rho:.3f} "
          f"(coherence ≈ {city.coherence_rounds:.1f} rounds), "
          f"battery covers {city.battery / city.tx_cost:.0f} transmissions")

    cfg = sim.fast_sim_config(FedZOConfig(
        n_devices=n, n_participating=max(4, n // 4), local_iters=2,
        lr=1e-2, mu=1e-3, b1=8, b2=4, seed=11,
        channel_schedule=True, h_min=0.3, channel_model=city))
    res = sim.run_experiment(softmax_loss, p0, store, cfg, rounds)

    hist = sim.history(res)
    m_eff = res.metrics["m_effective"].cpu().numpy()
    batt = channel_lib.battery(res.channel_state).cpu().numpy()
    print(f"m_effective per round: {m_eff.astype(int).tolist()}")
    print(f"energy ledger: {sum(r['energy_spent'] for r in hist):.0f} "
          f"units spent, fleet charge left {batt.sum():.0f} "
          f"({(batt >= city.tx_cost).mean():.0%} of devices can still "
          f"transmit)")
    loss = [r["mean_local_loss"] for r in hist]
    print(f"mean local loss: {loss[0]:.4f} -> {loss[-1]:.4f}")
    assert all(np.isfinite(v) for v in loss)

    if args.smoke:
        spent = sum(r["energy_spent"] for r in hist)
        assert spent == float(n) * city.battery - float(batt.sum()), \
            (spent, batt.sum())
        print(f"energy ledger balances: {spent:.0f} spent == "
              f"{n}x{city.battery:.0f} initial - {batt.sum():.0f} left")
        host = sim.build_host_store(clients, n_buckets=2)
        tier = sim.run_experiment(softmax_loss, p0, host, cfg, rounds)
        for a, b in zip(tree_leaves(res.params), tree_leaves(tier.params)):
            assert torch.equal(a, b)
        for a, b in zip(res.channel_state, tier.channel_state):
            assert torch.equal(a, b)
        print("bitwise tiered == resident with the scenario on: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
