"""The federation simulation engine (counterpart of ``repro/sim``): the
client store, the round loop, faults, the wireless channel, scenario
sweeps, the tiered store, the sharded client fan-out over
``torch.distributed`` ranks (``make_clients_mesh``, ``make_sharded_round``)
and ``fast_sim_config``, the reference's fast execution strategy."""
import dataclasses

from repro_torch.configs.base import FedZOConfig
from repro_torch.sim.channel import ChannelModel, RoundChannel
from repro_torch.sim.engine import (ExperimentResult, experiment_key, history,
                                    make_cohort_round_step,
                                    make_experiment_fn, make_round_step,
                                    round_keys, run_experiment,
                                    split_round_keys, stream_core)
from repro_torch.sim.faults import DivergenceError, FaultModel, RoundFaults
from repro_torch.sim.shard import make_clients_mesh, make_sharded_round
from repro_torch.sim.store import (ClientStore, CohortBatch, build_store,
                                   sample_batches, sample_cohort_batches,
                                   sample_participants)
from repro_torch.sim.sweep import run_sweep, scenario_grid
from repro_torch.sim.tiered import (CohortStream, HostStore,
                                    build_host_store, resolve_store,
                                    run_tiered_experiment)

__all__ = ["ChannelModel", "ClientStore", "CohortBatch", "CohortStream",
           "DivergenceError", "ExperimentResult", "FaultModel", "HostStore",
           "RoundChannel", "RoundFaults", "build_host_store", "build_store",
           "experiment_key", "fast_sim_config", "history",
           "make_clients_mesh", "make_cohort_round_step",
           "make_experiment_fn", "make_round_step", "make_sharded_round",
           "resolve_store", "round_keys",
           "run_experiment", "run_sweep", "run_tiered_experiment",
           "sample_batches", "sample_cohort_batches", "sample_participants",
           "scenario_grid", "split_round_keys", "stream_core"]


def fast_sim_config(cfg: FedZOConfig) -> FedZOConfig:
    """The engine's fast execution strategy for a config (the reference's
    ``repro/sim/__init__.py:37-45``): batched-direction local phases (one
    ``[b2, n_pad]`` block and one batched forward per iterate) and the
    rbg bit generator for the direction streams (``prng_impl=
    "unsafe_rbg"``, Philox on the ``philox_bits`` kernel). The algorithm
    and its distributions are the same; the execution plan and the PRNG
    streams change."""
    return dataclasses.replace(cfg, batch_directions=True,
                               direction_conv="block",
                               prng_impl="unsafe_rbg")
