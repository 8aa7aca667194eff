"""How ``correct`` is decided: the program's first round against the plain
reference (``reference/fedzo.follow``), each number against its limit.

The numbers, each a worst case and each 0 for a perfect match:

- ``loss_gap``: the largest relative gap between a loss the program's
  cohort forward returned and the reference's forward at the point the
  reference reached (every loss of round 0: each client's H base and H·b2
  perturbed losses; and each client's first base loss of round 1, which
  reads the weights round 0 left);
- ``update_norm_gap``: the largest gap between the program's and the
  reference's norm of a leaf's change over round 0, against the larger of
  the reference's norm of that leaf and of the median leaf;
- ``update_sample_gap``: ‖program − reference‖ / ‖reference‖ of the
  round's change at the sample of flat indices;
- ``walk_gap``: the same for every perturbation of round 0 (the point a
  perturbed forward read, less the point its iterate's base forward
  read), the worst client, iterate and direction.

The limits of a cell are in ``limits/<workload>.json``, set from the
readings that file lists beside them. A number with no limit fails.
"""
from __future__ import annotations

import math

import torch

from fedbench import inputs
from fedbench.reference import fedzo as rfedzo

NUMBERS = ("loss_gap", "update_norm_gap", "update_sample_gap", "walk_gap")


def readings(cell, seed, outcome, device):
    """The numbers of one run (the reference's work)."""
    fam, cfg = cell.family, cell.cfg
    fam.set_tf32(False)
    w = inputs.Weights(fam, cfg, seed, device)
    held = outcome.held
    with torch.no_grad():
        return rfedzo.follow(fam, cfg, cell.traffic, w.flat, w.shapes,
                             held["batches"], held["client_keys"],
                             held["channel_key"], outcome.record,
                             held["idx"])


def judge(values, limits):
    """(correct, {number: {"value", "limit"}}) for the numbers."""
    checks, ok = {}, True
    for name in NUMBERS:
        v, lim = values[name], limits.get(name)
        checks[name] = {"value": v, "limit": lim}
        if lim is None or not math.isfinite(v) or v > lim:
            ok = False
    return ok, checks
