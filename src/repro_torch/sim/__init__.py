from repro_torch.sim.channel import ChannelModel, RoundChannel
from repro_torch.sim.engine import (ExperimentResult, history,
                                    make_round_step, round_keys,
                                    run_experiment, split_round_keys)
from repro_torch.sim.faults import DivergenceError, FaultModel, RoundFaults
from repro_torch.sim.store import (ClientStore, build_store, sample_batches,
                                   sample_participants)
from repro_torch.sim.sweep import run_sweep, scenario_grid

__all__ = ["ChannelModel", "ClientStore", "DivergenceError",
           "ExperimentResult", "FaultModel", "RoundChannel", "RoundFaults",
           "build_store", "history", "make_round_step", "round_keys",
           "run_experiment", "run_sweep", "sample_batches",
           "sample_participants", "scenario_grid", "split_round_keys"]
