"""Optimizers, the one-device train step and a zoo model's serve steps
(counterpart of ``repro.train``; the pipeline and gradient compression
wait for ROADMAP queue 1 item 14)."""
from .optimizers import (OptConfig, apply_update, clip_by_global_norm,
                         cosine_lr, global_norm, init_opt_state)
from .trainer import (TrainSetup, TrainState, make_serve_steps,
                      make_train_step)

__all__ = ["OptConfig", "apply_update", "clip_by_global_norm", "cosine_lr",
           "global_norm", "init_opt_state", "TrainSetup", "TrainState",
           "make_serve_steps", "make_train_step"]
