"""FedZO hyperparameters: a jax-free copy of the reference's FedZOConfig
(``repro/configs/base.py``).

The field set and defaults are the reference's, so a config built for one
package means the same run in the other. The port implements the flat-buffer
route (``flat_params=True``) of the fedzo strategy; fields that select a route
it does not have yet are rejected at the round (``core/fedzo.py``), never
silently ignored.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class FedZOConfig:
    """Paper Algorithm 1 hyperparameters."""
    n_devices: int = 50        # N
    n_participating: int = 10  # M (<= N); == N means full participation
    local_iters: int = 5       # H
    lr: float = 1e-3           # eta
    mu: float = 1e-3           # smoothing step size
    b1: int = 25               # data minibatch size
    b2: int = 20               # number of perturbation directions
    estimator: str = "sphere"  # sphere (paper) | gaussian | rademacher | coordinate
    central: bool = False      # two-sided difference (O(mu^2) bias, +1 query)
    direction_dtype: str = "float32"
    # flat-buffer hot path: perturb/update fused into streaming kernels over
    # one padded 1-D parameter buffer, directions regenerated in-kernel from
    # the counter convention
    flat_params: bool = False
    direction_conv: str = "tree"
    batch_directions: bool = False
    prng_impl: str = "threefry2x32"
    flat_block_rows: int = 0   # pad granularity in 128-lane rows; 0 = 512
    server_momentum: float = 0.0  # FedOpt-style momentum on aggregated deltas
    seed: int = 0
    # AirComp (Section IV)
    aircomp: bool = False
    snr_db: float = 0.0        # P / sigma_w^2
    h_min: float = 0.8
    # channel-truncation scheduling (Sec. IV-A)
    channel_schedule: bool = False
    channel_model: object = None
    # FedAvg-style n_i/n weighting of the sampled clients' deltas
    weight_by_size: bool = False
    delta_compression: str = "dense"  # dense | seed
    strategy: str = "fedzo"
    prox_mu: float = 0.0
    dyn_alpha: float = 0.0
    surrogate_beta: float = 0.5
    surrogate_fraction: float = 0.5
