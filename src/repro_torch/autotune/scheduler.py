"""LKGP-driven early-stopping scheduler (the paper's AutoML application).

Counterpart of ``repro.autotune.scheduler``. Freeze-thaw-style loop over a
pool of training runs:
  1. every ``refit_every`` epochs, fold the new partial-curve observations
     into the shared :class:`~repro_torch.autotune.predictor.CurvePredictor`
     (``extend`` + warm-started ``refit`` - no model is rebuilt);
  2. predict each run's final-epoch metric via ``Posterior.final`` (exact
     mean from the cached solve + Matheron variance);
  3. stop runs whose predicted final value is below the best observed /
     predicted value with high confidence (UCB rule), reallocating their
     remaining budget to survivors.

Bad hyper-parameter configurations are detected from partial learning
curves and preempted. Works with any trainer exposing (advance one epoch ->
metric). Unlike :class:`~repro_torch.autotune.sh.SuccessiveHalvingScheduler`
it never *commits* to a kill schedule - every run survives until the model
is confident it will lose.

Where the reference draws the Matheron normals from
``jax.random.PRNGKey(seed + epochs_done)`` (and ``PRNGKey(seed + 999)`` for
the summary), this one passes a ``torch.Generator`` on the model's device
seeded from the same integers by the posterior's stream rule (tag 0, an
explicit key's stream; the posterior's own default streams are tags 1 and 2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..core import LKGPConfig, LKGPState
from ..core.posterior import _stream
from .predictor import CurvePredictor, RunPool

__all__ = ["AutotuneConfig", "FreezeThawScheduler"]


@dataclass
class AutotuneConfig:
    max_epochs: int = 20
    refit_every: int = 2
    min_epochs_before_stop: int = 3
    ucb_beta: float = 1.0          # stop if pred + beta*std < best estimate
    maximize: bool = True
    gp: LKGPConfig = field(default_factory=lambda: LKGPConfig(lbfgs_iters=30))
    # L-BFGS budget for warm-started refits; None -> gp.lbfgs_iters. With
    # gp.polish_steps >= 0 every refit runs the fixed-budget polish instead.
    refit_lbfgs_iters: int | None = None
    # Explicit repro_torch.amortize.Amortizer; passing one opts every fit and
    # refit into amortized inits with it (None defers to gp.hyper_init).
    amortizer: object | None = None


class FreezeThawScheduler:
    """Drives n runs; ``step_fns[i]() -> float`` advances run i one epoch.
    The model lives on ``device`` (``None``: the GPU)."""

    def __init__(self, X: np.ndarray, step_fns: list[Callable[[], float]],
                 cfg: AutotuneConfig | None = None, seed: int = 0, t=None, *,
                 device=None):
        self.X = np.asarray(X, np.float64)
        self.step_fns = step_fns
        self.cfg = cfg or AutotuneConfig()
        n, m = len(step_fns), self.cfg.max_epochs
        self.pool = RunPool(step_fns, m)
        self.active = np.ones(n, bool)
        self.seed = seed
        self.history: list[dict] = []
        # ``t`` carries a real dataset's (possibly non-uniform) budget grid
        # into the model; scheduling still counts epoch indices.
        self.predictor = CurvePredictor(
            self.X, m, gp=self.cfg.gp, maximize=self.cfg.maximize,
            refit_lbfgs_iters=self.cfg.refit_lbfgs_iters, seed=seed, t=t,
            amortizer=self.cfg.amortizer, device=device)

    @property
    def state(self) -> LKGPState | None:
        """The predictor's fitted model state (None before the first refit)."""
        return self.predictor.state

    @property
    def Y(self) -> np.ndarray:
        return self.pool.Y

    @property
    def mask(self) -> np.ndarray:
        return self.pool.mask

    def _key(self, offset: int):
        """The stream the reference's ``PRNGKey(seed + offset)`` names."""
        return _stream(self.seed + offset, 0, self.predictor.device)

    # -- core loop -----------------------------------------------------------
    def run(self, total_epoch_budget: int | None = None) -> dict:
        cfg = self.cfg
        n, m = self.pool.n, self.pool.max_epochs
        self.pool.budget = (total_epoch_budget
                            if total_epoch_budget is not None else n * m)
        epoch = 0
        while not self.pool.exhausted() and self.active.any() and epoch < m:
            for i in range(n):
                if self.active[i]:
                    # no-op for configs already past this epoch (preloaded
                    # history curves ride along for free)
                    self.pool.advance_to(i, epoch + 1)
            if (epoch + 1) % cfg.refit_every == 0 \
                    and epoch + 1 >= cfg.min_epochs_before_stop \
                    and epoch + 1 < m:
                self._refit_and_stop(epoch + 1)
            epoch += 1
        return self.summary(self.pool.spent)

    def _refit_and_stop(self, epochs_done: int):
        cfg = self.cfg
        self.predictor.update(self.Y, self.mask)
        mean, std = self.predictor.predict_final(self._key(epochs_done))
        best = float(np.max(mean[self.active]))
        stopped = []
        for i in range(len(mean)):
            if self.active[i] and mean[i] + cfg.ucb_beta * std[i] < best:
                self.active[i] = False
                stopped.append(i)
        self.history.append({
            "epoch": epochs_done, "stopped": stopped,
            "active": int(self.active.sum()),
            "pred_best": best,
        })

    def summary(self, spent: int) -> dict:
        obs_best = self.pool.observed_best(self.cfg.maximize)
        # final prediction pass for reporting (back in raw metric units)
        pred_mean = None
        if self.predictor.state is not None:
            mean, _ = self.predictor.predict_final(self._key(999))
            pred_mean = self.predictor.to_raw(mean).tolist()
        return {
            "epochs_spent": spent,
            "observed_best": obs_best,
            "survivors": np.where(self.active)[0].tolist(),
            "stop_events": self.history,
            "predicted_final": pred_mean,
        }
