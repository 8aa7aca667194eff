"""AirComp over-the-air aggregation on the PyTorch port (paper Sec. IV):
the explicit complex channel against the Eq.-17 closed form, FedZO trained
through the noisy channel at several SNRs (the SNR family as one batched
sweep, ``sim.run_sweep``), and channel-truncation scheduling end to end.

    PYTHONPATH=src python examples_torch/aircomp_demo.py              # card
    PYTHONPATH=src python examples_torch/aircomp_demo.py --smoke --device cpu

Under ``sim.fast_sim_config`` every AirComp round on the card launches one
``aircomp_reduce`` (the masked mean and the row norms in one read) and one
``zo_walk`` (the Eq.-17 noise, from words 0–1 of the unsafe_rbg channel
key), and every direction block is one ``philox_bits`` draw.
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
from repro_torch.core.aircomp import (aircomp_simulate_channel,  # noqa: E402
                                      schedule_by_channel)
from repro_torch.data.synthetic import (make_classification,  # noqa: E402
                                        noniid_shards)
from repro_torch.fed.server import FedServer                # noqa: E402
from repro_torch.models.simple import (softmax_accuracy,    # noqa: E402
                                       softmax_init, softmax_loss)
from repro_torch.utils import prng                          # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="64 features, a few rounds, 4-row flat blocks")
    args = ap.parse_args(argv)
    dev = args.device
    feats, rounds, sched_rounds = (64, 3, 2) if args.smoke else (784, 15, 8)
    # the aggregation's flat geometry: 512-row blocks (n_pad 65,536) by
    # default; 4-row blocks keep the smoke run's buffers small
    geo = {"flat_block_rows": 4} if args.smoke else {}

    # 1. channel anatomy
    deltas = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 256)).astype(np.float32)).to(dev)
    y, diag = aircomp_simulate_channel(deltas, prng.key(0), snr_db=0.0,
                                       h_min=0.8)
    mean = deltas.mean(0)
    err = float(torch.linalg.norm(y - mean) / torch.linalg.norm(mean))
    print(f"recovered mean delta with relative error {err:.3f} at 0 dB SNR")
    _, mask = schedule_by_channel(prng.key(1), 1000, 0.8)
    print(f"channel-threshold scheduling keeps "
          f"{float(mask.float().mean()):.2%} of devices "
          f"(theory: {np.exp(-0.64):.2%})")

    # 2. FedZO through the noisy channel: the SNR family as one batched
    # sweep (one round loop over the [S, M] cohort)
    x, yl = make_classification(5000, feats, 10, seed=0)
    clients = noniid_shards(x[:4000], yl[:4000], 50)
    test = {"x": torch.from_numpy(x[4000:]).to(dev),
            "y": torch.from_numpy(yl[4000:]).to(dev)}
    store = sim.build_store(clients, device=dev)
    p0 = softmax_init(feats, 10, device=dev)

    base = sim.fast_sim_config(
        FedZOConfig(n_devices=50, n_participating=20, local_iters=5,
                    lr=1e-3, mu=1e-3, b1=25, b2=20, aircomp=True, h_min=0.8,
                    **geo))
    recs = sim.run_sweep(softmax_loss, p0, store, base,
                         sim.scenario_grid(snr_db=(0.0, -5.0)), rounds,
                         eval_fn=lambda p: {"acc": softmax_accuracy(p, test)},
                         eval_every=rounds - 1)
    noise_free = sim.run_experiment(
        softmax_loss, p0, store, sim.fast_sim_config(
            FedZOConfig(n_devices=50, n_participating=20, local_iters=5,
                        lr=1e-3, mu=1e-3, b1=25, b2=20)), rounds)
    print(f"SNR noise-free: test acc "
          f"{float(softmax_accuracy(noise_free.params, test)):.3f}")
    for rec in recs:
        print(f"SNR {rec['scenario']['snr_db']:+5.0f} dB: "
              f"test acc {float(rec['evals']['acc'][-1]):.3f}")

    # 3. channel-truncation scheduling end to end on the flat route: of the
    # M sampled clients only those with |h_i| >= h_min transmit
    cfg = FedZOConfig(n_devices=50, n_participating=10, local_iters=5,
                      lr=1e-3, mu=1e-3, b1=25, b2=10, aircomp=True,
                      snr_db=0.0, h_min=0.8, channel_schedule=True,
                      flat_params=True, **geo)
    srv = FedServer(softmax_loss, p0, clients, cfg, store=store)
    hist = srv.run(sched_rounds)
    m_eff = [m["m_effective"] for m in hist]
    print(f"channel-truncated AirComp: test acc "
          f"{float(softmax_accuracy(srv.params, test)):.3f}, m_effective "
          f"per round min/mean/max = {min(m_eff):.0f}/{np.mean(m_eff):.1f}/"
          f"{max(m_eff):.0f} of 10 (theory keeps {np.exp(-0.64):.0%})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
