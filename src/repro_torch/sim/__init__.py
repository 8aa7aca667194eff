from repro_torch.sim.channel import ChannelModel, RoundChannel
from repro_torch.sim.engine import (ExperimentResult, experiment_key, history,
                                    make_cohort_round_step, make_round_step,
                                    round_keys, run_experiment,
                                    split_round_keys, stream_core)
from repro_torch.sim.faults import DivergenceError, FaultModel, RoundFaults
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
           "experiment_key", "history", "make_cohort_round_step",
           "make_round_step", "resolve_store", "round_keys",
           "run_experiment", "run_sweep", "run_tiered_experiment",
           "sample_batches", "sample_cohort_batches", "sample_participants",
           "scenario_grid", "split_round_keys", "stream_core"]
