"""Shared LKGP curve-prediction layer for every AutoML scheduler.

Counterpart of ``repro.autotune.predictor``. All schedulers (freeze-thaw,
Successive Halving, Hyperband) need the same model loop over a pool of
partially observed learning curves:

  1. fold new observations into the state - cold
     :func:`~repro_torch.core.fit` on first contact,
     :func:`~repro_torch.core.extend` afterwards (incremental conditioning,
     hyper-parameters carried over as a warm start);
  2. re-optimise hyper-parameters with a warm-started, budget-capped
     :func:`~repro_torch.core.refit`;
  3. read each config's predicted final-epoch metric from
     ``Posterior.final`` (exact mean from the cached solve + Matheron
     variance).

:class:`CurvePredictor` owns that loop so scheduler classes only contain
promotion/stopping policy. Predictions live in *score space* - the raw
metric mapped through an invertible
:class:`~repro_torch.data.transforms.AffineTransform` (default: a +-1 sign
flip from ``maximize``) so that larger is always better; ``to_raw`` inverts
the transform for reporting. The model lives on one device, given to the
predictor (``None`` is the GPU).

:class:`RunPool` is the matching execution-side helper: it drives the
user-supplied ``step_fns`` (one "advance one epoch -> metric" callable per
config), records curves/masks, and enforces a total epoch budget.
:meth:`RunPool.replay` builds the pool straight from a loaded dataset
task, stepping through its recorded curves.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from ..core import LKGPConfig, LKGPState, extend, fit, posterior, refit
from ..data.curves import CurveTask, replay_step_fns
from ..data.transforms import AffineTransform

__all__ = ["CurvePredictor", "RunPool"]


def _norm_ppf(q: float) -> float:
    """Standard-normal quantile (the reference's erfinv form, in float64)."""
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    return NormalDist().inv_cdf(q)


class CurvePredictor:
    """LKGP over a fixed pool of configs: extend -> warm refit -> final mean/std.

    Parameters
    ----------
    X : (n, d) hyper-parameter configurations (the whole pool).
    max_epochs : grid length m; progressions default to epochs ``1..m``.
    gp : model/inference config for the cold fit (``precond_rank`` et al.
        flow straight through to the engines).
    maximize : if False the metric is negated internally so score space is
        always "larger is better" (ignored when ``metric_tf`` is given).
    refit_lbfgs_iters : L-BFGS budget for warm-started refits
        (None -> ``gp.lbfgs_iters``). Only the host-L-BFGS path reads it:
        with ``gp.polish_steps >= 0`` every fit/refit instead runs the
        fixed-budget polish from the init ``gp.hyper_init`` selects
        (``"default"`` or ``"amortized"``; refits warm-start from the current
        optimum unless ``hyper_init="amortized"``, which re-amortizes on each
        round's extended data).
    t : explicit progression grid (length ``max_epochs``; positive,
        strictly increasing) - e.g. a real dataset's log-spaced budget
        fidelities. The GP's progression kernel sees these values; the
        scheduler's epoch indices keep addressing positions ``0..m-1``.
    metric_tf : invertible transform raw metric -> score space. Default:
        the +-1 sign flip derived from ``maximize``.
    amortizer : an explicit :class:`repro_torch.amortize.Amortizer`
        forwarded to ``fit`` / ``refit``; passing one opts every fit and
        refit into amortized inits with this encoder. None leaves the choice
        to ``gp.hyper_init`` (whose ``"amortized"`` resolves the registered
        or packaged encoder).
    engine : an explicit inference engine for the cold fit, which the
        state then keeps for its refits and posteriors (as ``fit``'s).
    device : where the model lives (``None``: the GPU; raises without one).
    """

    def __init__(self, X, max_epochs: int | None = None,
                 gp: LKGPConfig | None = None,
                 maximize: bool = True, refit_lbfgs_iters: int | None = None,
                 seed: int = 0, t=None, metric_tf=None, amortizer=None,
                 *, engine=None, device=None):
        self.X = np.asarray(X, np.float64)
        if t is not None:
            self.t = np.asarray(t, np.float64)
            if self.t.ndim != 1 or np.any(np.diff(self.t) <= 0) \
                    or self.t[0] <= 0:
                raise ValueError("t must be a positive strictly-increasing "
                                 f"1-D grid, got {self.t}")
            if max_epochs is not None and max_epochs != self.t.shape[0]:
                raise ValueError(f"max_epochs={max_epochs} disagrees with "
                                 f"len(t)={self.t.shape[0]}")
        elif max_epochs is not None:
            self.t = np.arange(1.0, max_epochs + 1.0)
        else:
            raise ValueError("give max_epochs or an explicit t grid")
        self.gp = gp if gp is not None else LKGPConfig(lbfgs_iters=30)
        self.metric_tf = (metric_tf if metric_tf is not None
                          else AffineTransform.sign(maximize))
        self.refit_lbfgs_iters = refit_lbfgs_iters
        self.amortizer = amortizer
        self.seed = seed
        self.engine = engine
        self.device = resolve_device(device)
        self.state: LKGPState | None = None
        self.n_refits = 0
        self._final_cache: tuple | None = None   # (n_refits, mean, std)

    @property
    def max_epochs(self) -> int:
        return self.t.shape[0]

    def update(self, Y, mask) -> None:
        """Fold the pool's current (n, m) curves in and re-optimise.

        ``mask`` must grow monotonically between calls (``extend`` enforces
        it) - schedulers only ever add observations.
        """
        Y = np.asarray(self.metric_tf(np.asarray(Y, np.float64)), np.float64)
        mask = np.asarray(mask, np.float64)
        if self.state is None:
            self.state = fit(self.X, self.t, Y, mask, self.gp,
                             engine=self.engine, amortizer=self.amortizer,
                             device=self.device)
        else:
            self.state = extend(self.state, Y, mask)
            self.state = refit(self.state,
                               lbfgs_iters=self.refit_lbfgs_iters,
                               amortizer=self.amortizer)
        self.n_refits += 1

    def predict_final(self, generator: torch.Generator | None = None, *,
                      normals=None):
        """(mean, std) of each config's final-epoch metric in score space,
        as numpy arrays.

        ``generator`` and ``normals`` pass straight through to
        ``posterior(state).final``. A default call (neither given) goes
        through the state-keyed posterior cache and its cached default
        sample stream, and its numpy conversion is cached per refit, so a
        scheduler reading the same prediction twice - rung scoring, then
        the run summary - runs no second solve. ``extend``/``refit`` in
        :meth:`update` produce fresh state objects, which is what
        invalidates both layers.
        """
        if self.state is None:
            raise RuntimeError("predict_final before any update()")
        default = generator is None and normals is None
        if default and self._final_cache is not None \
                and self._final_cache[0] == self.n_refits:
            return self._final_cache[1], self._final_cache[2]
        mean, var = posterior(self.state, device=self.device).final(
            generator, normals=normals)
        mean = mean.cpu().numpy()
        std = np.sqrt(np.maximum(var.cpu().numpy(), 0.0))
        if default:
            self._final_cache = (self.n_refits, mean, std)
        return mean, std

    def scores(self, rule: str = "ucb", ucb_beta: float = 1.0,
               quantile: float = 0.75,
               generator: torch.Generator | None = None) -> np.ndarray:
        """Per-config promotion scores (score space, larger = better).

        ``"ucb"``: mean + beta * std - optimistic, keeps configs whose
        upside is still plausible. ``"quantile"``: the q-quantile of the
        predictive final-value distribution (q < 0.5 is conservative,
        q > 0.5 optimistic).
        """
        mean, std = self.predict_final(generator)
        if rule == "ucb":
            return mean + ucb_beta * std
        if rule == "quantile":
            return mean + _norm_ppf(quantile) * std
        raise ValueError(f"unknown promotion rule {rule!r}; "
                         "expected 'ucb' or 'quantile'")

    def to_raw(self, scores: np.ndarray) -> np.ndarray:
        """Map score-space values back to raw metric units."""
        return np.asarray(self.metric_tf.inverse(np.asarray(scores)))


class RunPool:
    """Execution state over a pool of runs: curves, masks, epoch accounting.

    ``step_fns[i]() -> float`` advances run i by one epoch and returns the
    metric. The pool never re-runs an epoch: ``advance_to`` is a no-op for
    configs already at (or past) the target, which lets Hyperband brackets
    share one pool without double-charging epochs. Plain numpy on the host.
    """

    def __init__(self, step_fns: list[Callable[[], float]], max_epochs: int,
                 budget: int | None = None):
        n = len(step_fns)
        self.step_fns = step_fns
        self.max_epochs = max_epochs
        self.Y = np.zeros((n, max_epochs))
        self.mask = np.zeros((n, max_epochs))
        self.epochs_done = np.zeros(n, np.int64)
        self.spent = 0
        self.budget = budget

    @classmethod
    def replay(cls, task: CurveTask, budget: int | None = None,
               seed: int = 0, obs_noise: float = 0.0,
               spike_prob: float = 0.0,
               censored: bool | None = None) -> "RunPool":
        """Replay mode: a pool stepping through a loaded task's real curves
        (:func:`repro_torch.data.curves.replay_step_fns`: exact replay of
        the recorded ``Y_full`` by default, censored configs holding their
        last observed value, optional observation noise on top).
        ``max_epochs`` is the task's grid length."""
        return cls(replay_step_fns(task, seed=seed, obs_noise=obs_noise,
                                   spike_prob=spike_prob,
                                   censored=censored),
                   max_epochs=np.asarray(task.t).shape[0], budget=budget)

    @property
    def n(self) -> int:
        return len(self.step_fns)

    def exhausted(self) -> bool:
        return self.budget is not None and self.spent >= self.budget

    def advance_to(self, i: int, target_epochs: int,
                   charge: bool = True) -> None:
        """Run config i until it has ``target_epochs`` epochs (budget-capped).

        ``charge=False`` records the epochs without counting them against
        ``spent`` - used to preload completed curves from *previous*
        experiments ("history"), which every scheduler gets for free.
        """
        target = min(int(target_epochs), self.max_epochs)
        while self.epochs_done[i] < target \
                and not (charge and self.exhausted()):
            e = int(self.epochs_done[i])  # lint: disable=RT103 (numpy)
            # one epoch of the run: its loss is the curve's next value
            self.Y[i, e] = float(self.step_fns[i]())  # lint: disable=RT103 (a run's loss)
            self.mask[i, e] = 1.0
            self.epochs_done[i] += 1
            if charge:
                self.spent += 1

    def observed_last(self, i: int) -> float:
        """Most recent observed metric of config i (nan if never run)."""
        e = int(self.epochs_done[i])
        return float(self.Y[i, e - 1]) if e > 0 else float("nan")

    def observed_best(self, maximize: bool = True):
        if not self.mask.any():
            return None
        vals = self.Y[self.mask > 0]
        return float(np.max(vals) if maximize else np.min(vals))
