"""The federated black-box attack (paper Sec. V-A) on the PyTorch port:
FedZO finds one adversarial perturbation from classifier outputs alone
(CW loss, Eq. 21), then an SNR × seed AirComp sweep gives the Fig.-4-style
curve family as long-format CSV in results/.

    PYTHONPATH=src python examples_torch/blackbox_attack.py            # card
    PYTHONPATH=src python examples_torch/blackbox_attack.py --smoke --device cpu

Both runs use ``sim.fast_sim_config`` (the wide ``block`` route, unsafe_rbg
keys); the sweep is one batched round loop over its six scenarios.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import sim                                 # noqa: E402
from repro_torch.workloads import attack                    # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--sweep-rounds", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized task and round counts")
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--out", default=os.path.join("results",
                                                  "attack_snr_curve.csv"))
    args = ap.parse_args(argv)

    if args.smoke:
        task = attack.make_task(n_train=400, n_attack=96, n_clients=5,
                                train_steps=120, device=args.device)
        cfg = attack.default_config(task, local_iters=3, b2=6, b1=8)
        args.rounds, args.sweep_rounds = min(args.rounds, 4), 2
    else:
        task = attack.make_task(device=args.device)
        cfg = attack.default_config(task)
    print(f"black-box classifier accuracy: {task.clean_accuracy:.3f} "
          f"(client sizes {[len(c['y']) for c in task.clients]})")

    res = attack.run(task, sim.fast_sim_config(cfg), args.rounds,
                     eval_every=5)
    hist = sim.history(res)
    for h in hist:
        if "attack_success" in h:
            print(f"round {h['round']:3d}  attack_success "
                  f"{h['attack_success']:.3f}  loss "
                  f"{h.get('mean_local_loss', float('nan')):.4f}")
    final = attack.attack_eval(task)(res.params)
    print(f"attack success rate: {float(final['attack_success']):.3f} "
          f"(loss {hist[-1]['mean_local_loss']:.4f})")

    if not args.no_sweep:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        recs = attack.run_sweep(task, sim.fast_sim_config(cfg),
                                snr_dbs=(-10.0, 0.0, 10.0), seeds=(0, 1),
                                rounds=args.sweep_rounds, eval_every=2,
                                out_csv=args.out)
        print(f"SNR sweep: {len(recs)} scenarios x {args.sweep_rounds} "
              f"rounds -> {args.out}")
        for r in recs:
            s = r["scenario"]
            print(f"  snr_db={s['snr_db']:+.0f} seed={s['seed']}  final "
                  f"attack_success "
                  f"{float(r['evals']['attack_success'][-1]):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
