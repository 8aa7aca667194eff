"""The reference's FedZO round (paper Algorithm 1, the sphere estimator,
the mean or the Eq.-17 AirComp aggregate), following the program's run.

At the users' μ = 1e-3 a perturbation moves each weight by about μ/√d, a
few float32 ulps, and a loss L(x + μv) − L(x) by a fraction of one ulp of
the loss: each coefficient d·(L(x + μv_n) − L(x))/μ is decided by the
forward's rounding. Two correct forwards that round differently give
other coefficients, so no independent reference can reproduce the
program's. The reference therefore takes the program's recorded losses as
the loss differences, and computes everything else itself:

- the forward: every loss the program reported for round 0 (each
  client's H base losses and H·b2 perturbed losses) and the next round's
  first, at points the reference builds itself;
- the estimator: the directions (Threefry-2x32 counters, Box-Muller), the
  sphere norms, the coefficients from the recorded losses, the H updates
  of each client, and every perturbation of the walk (the point each
  perturbed forward read, less its iterate's base point), held against
  the program's at a sample of indices;
- the aggregation: the mean, or AirComp with the channel's transmit mask
  and the Eq.-17 noise σ² = σ_w²·Δ_max/(m²·d·h_min²) drawn from the
  noise key's direction 0.

It imports nothing of the program: its inputs are the benchmark's (the
weights made again from the seed, the tokens, the keys) and the
program's outputs, which it judges.
"""
from __future__ import annotations

import math

import torch

from fedbench.inputs import unflatten
from fedbench.reference import keys as rkeys
from fedbench.reference import threefry

P_TX = 1.0


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def _sample(x, idx):
    return x[idx].double()


def follow(family, cfg, traffic, x0, shapes, batches, client_keys,
           channel_key, rec, idx):
    """Readings of the program's first round (and the next round's first
    losses) against the reference.

    ``x0`` the weights [d] (float32, on the device); ``shapes`` their
    layout; ``batches`` ``[(tokens, labels)]`` of rounds 0 and 1, each
    ``[M, H, rows, seq]``; ``client_keys`` ``[M, 2]`` and ``channel_key``
    ``[2]`` of round 0; ``rec`` the program's record (``harness.Record``,
    its ``points`` sampled at ``idx``);
    ``idx`` the sample's flat indices (on the device). Returns the
    numbers compared and what they were read from."""
    M, H = traffic["clients"], traffic["local_iters"]
    b2, mu, lr = traffic["directions"], traffic["mu"], traffic["lr"]
    d = x0.numel()
    dev = x0.device
    losses = rec.losses.tolist()              # [H·(b2 + 1)][M] floats
    next_base = rec.next_base.tolist()

    def loss_at(x, r, m, h):
        toks, labs = batches[r]
        return float(family.loss(unflatten(x, shapes), cfg, toks[m, h],
                                 labs[m, h]))

    gaps = []                                 # (what, program, reference)
    walk_gaps = []
    air = traffic["aggregation"] == "aircomp"
    if air:
        mask, k_noise = rkeys.channel(channel_key.tolist(), M,
                                      traffic["h_min"])
        maskf = mask.to(torch.float64)
        m_div = max(float(maskf.sum()), 1.0)
        weight = [float(maskf[m]) / m_div for m in range(M)]
    else:
        weight = [1.0 / M] * M
    agg = torch.zeros(d, dtype=torch.float32, device=dev)
    sq = []
    points = rec.points.to(dev)
    g = torch.empty(d, dtype=torch.float32, device=dev)
    for m in range(M):
        x = x0.clone()
        iter_keys = rkeys.iterate_keys(client_keys[m].tolist(), H)
        for h in range(H):
            c0 = h * (b2 + 1)
            base = losses[c0][m]
            gaps.append((f"client {m} iterate {h} base",
                         base, loss_at(x, 0, m, h)))
            base_s = points[c0, m].double()
            acc = torch.zeros_like(x)
            for n in range(b2):
                threefry.direction(*iter_keys[h], n, d, device=dev, out=g)
                inv = threefry.inv_norm(g)
                lp = losses[c0 + 1 + n][m]
                step = g * (mu * inv)
                ref_s = _sample(step, idx)
                prog_s = points[c0 + 1 + n, m].double() - base_s
                walk_gaps.append(float(torch.linalg.vector_norm(
                    prog_s - ref_s) / torch.linalg.vector_norm(ref_s)))
                gaps.append((f"client {m} iterate {h} direction {n}", lp,
                             loss_at(x + step, 0, m, h)))
                del step
                coeff = d * (lp - base) / mu
                acc.add_(g, alpha=-lr / b2 * coeff * inv)
            x += acc
            del acc
        delta = x - x0
        sq.append(threefry.sq_norm(delta))
        agg.add_(delta, alpha=weight[m])
        del x, delta
    if air:
        sigma_w2 = P_TX / (10.0 ** (traffic["snr_db"] / 10.0))
        delta_max = max([s for s, w in zip(sq, weight) if w > 0],
                        default=0.0)
        std = math.sqrt(sigma_w2 * delta_max
                        / (m_div ** 2 * d * P_TX * traffic["h_min"] ** 2))
        threefry.direction(*k_noise, 0, d, device=dev, out=g)
        agg.add_(g, alpha=std)
    del g
    x1 = x0 + agg
    del agg
    change = x1 - x0
    off, ref_norms = 0, []
    for _, shape in shapes:
        n = math.prod(shape)
        ref_norms.append(math.sqrt(threefry.sq_norm(change[off:off + n])))
        off += n
    ref_s = _sample(change, idx)
    del change
    for m in range(M):
        gaps.append((f"client {m} next round base", next_base[m],
                     loss_at(x1, 1, m, 0)))
    return readings(gaps, ref_norms, rec.change_norms, ref_s,
                    rec.change_sample, walk_gaps)


def readings(gaps, ref_norms, prog_norms, ref_s, prog_s, walk_gaps):
    """The four numbers the check compares, from the pairs of readings."""
    rel = [(_rel(p, r), what) for what, p, r in gaps]
    worst = max(rel)
    med = sorted(ref_norms)[len(ref_norms) // 2]
    norm_gap = 0.0
    for p, r in zip(prog_norms, ref_norms):
        den = max(r, med)
        norm_gap = max(norm_gap, abs(p - r) / den if den > 0
                       else (0.0 if p == 0 else math.inf))
    den = float(torch.linalg.vector_norm(ref_s))
    num = float(torch.linalg.vector_norm(prog_s.to(ref_s.device) - ref_s))
    sample_gap = num / den if den > 0 else (0.0 if num == 0 else math.inf)
    return {"loss_gap": worst[0], "loss_gap_at": worst[1],
            "update_norm_gap": norm_gap,
            "update_sample_gap": sample_gap,
            "walk_gap": max(walk_gaps) if walk_gaps else 0.0}
