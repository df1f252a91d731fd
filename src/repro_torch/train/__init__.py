"""Training: optimizer, microbatched step, gradient compression (port of
``repro.train``; the mesh placements are ROADMAP A11.7)."""
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         adamw_update, global_norm,
                                         init_opt_state, lr_at)
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)

__all__ = ["OptimizerConfig", "OptState", "adamw_update", "init_opt_state",
           "lr_at", "global_norm", "TrainState", "init_train_state",
           "make_train_step"]
