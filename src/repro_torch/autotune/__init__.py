"""AutoML scheduler subsystem driven by LKGP learning-curve prediction
(counterpart of ``repro.autotune``).

Layered as predictor -> schedulers:

* :mod:`~repro_torch.autotune.predictor` - the shared
  :class:`CurvePredictor` (extend -> warm refit -> ``Posterior.final``) and
  the :class:`RunPool` execution harness;
* :mod:`~repro_torch.autotune.scheduler` - :class:`FreezeThawScheduler`
  (confidence-based early stopping, no fixed kill schedule);
* :mod:`~repro_torch.autotune.sh` - :class:`SuccessiveHalvingScheduler` and
  :class:`HyperbandScheduler` (rung-based promotion, LKGP-ranked or
  classic rank-based).

The model runs on the device the schedulers are given (``device=None``: the
GPU); the policy is numpy on the host.
"""
from .predictor import CurvePredictor, RunPool
from .scheduler import AutotuneConfig, FreezeThawScheduler
from .sh import HyperbandScheduler, SHConfig, SuccessiveHalvingScheduler

__all__ = [
    "CurvePredictor", "RunPool",
    "AutotuneConfig", "FreezeThawScheduler",
    "SHConfig", "SuccessiveHalvingScheduler", "HyperbandScheduler",
]
