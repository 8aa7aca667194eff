from repro_torch.sim.engine import (ExperimentResult, make_round_step,
                                   run_experiment, split_round_keys)
from repro_torch.sim.store import (ClientStore, build_store, sample_batches,
                                   sample_participants)

__all__ = ["ClientStore", "ExperimentResult", "build_store",
           "make_round_step", "run_experiment", "sample_batches",
           "sample_participants", "split_round_keys"]
