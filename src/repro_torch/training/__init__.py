"""Training loops of the port: the classic (paper-experiment) runner, the
LM trainer with SCAR fault tolerance (``TrainLoop``) and the LM server
(``serve.Server``)."""
from repro_torch.training.classic_runner import (iterations_to_converge,
                                                 run_clean, run_with_failure,
                                                 run_with_perturbation,
                                                 run_with_trace)
from repro_torch.training.train_loop import TrainLoop, TrainLoopConfig
from repro_torch.training.train_state import ArenaTrainState, TrainState

__all__ = ["run_clean", "run_with_failure", "run_with_perturbation",
           "run_with_trace", "iterations_to_converge", "TrainLoop",
           "TrainLoopConfig", "TrainState", "ArenaTrainState"]
