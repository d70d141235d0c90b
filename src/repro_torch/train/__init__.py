"""Optimizers, the train step on one device or a mesh, a zoo model's serve
steps, the GPipe schedule and the int8 all-reduce over 'pod' (counterpart
of ``repro.train``)."""
from .optimizers import (OptConfig, apply_update, clip_by_global_norm,
                         cosine_lr, global_norm, init_opt_state)
from .trainer import (TrainSetup, TrainState, make_serve_steps,
                      make_train_step)

__all__ = ["OptConfig", "apply_update", "clip_by_global_norm", "cosine_lr",
           "global_norm", "init_opt_state", "TrainSetup", "TrainState",
           "make_serve_steps", "make_train_step"]
