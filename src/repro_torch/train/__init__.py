"""Optimizers and the one-device train step (counterpart of
``repro.train``; ``make_serve_steps``, the pipeline and gradient compression
serve the LM zoo and wait for ROADMAP queue 1 item 14)."""
from .optimizers import (OptConfig, apply_update, clip_by_global_norm,
                         cosine_lr, global_norm, init_opt_state)
from .trainer import TrainSetup, TrainState, make_train_step

__all__ = ["OptConfig", "apply_update", "clip_by_global_norm", "cosine_lr",
           "global_norm", "init_opt_state", "TrainSetup", "TrainState",
           "make_train_step"]
