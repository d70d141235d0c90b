"""Successive Halving and Hyperband with LKGP-ranked promotion.

Counterpart of ``repro.autotune.sh``. Successive Halving (Jamieson &
Talwalkar, 2016) runs a pool of configs in rungs: every config reaches
``min_epochs * eta^k`` epochs at rung k, then only the top ``1/eta``
fraction is promoted. The classic promotion rule ranks configs by their
*current* observed metric - which systematically kills slow starters.
Following Lin et al. 2025 (arXiv:2508.14818), the LKGP mode instead ranks by
the model's predicted *final-epoch* metric (UCB or quantile of the
predictive distribution from
:class:`~repro_torch.autotune.predictor.CurvePredictor`), so curves that
cross later are promoted on their extrapolated value.

:class:`HyperbandScheduler` (Li et al., 2018) hedges over the
aggressiveness of early stopping by running several Successive Halving
brackets with different initial resources against one shared
:class:`~repro_torch.autotune.predictor.RunPool` and one shared model state
- epochs already spent on a config in an earlier bracket are never
re-charged, and every bracket's observations sharpen the same LKGP.

The policy is plain numpy on the host; only the predictor touches the
device, given as ``device`` (``None``: the GPU). The rank mode builds no
model and needs no device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..core import LKGPConfig
from .predictor import CurvePredictor, RunPool

__all__ = ["SHConfig", "SuccessiveHalvingScheduler", "HyperbandScheduler"]


@dataclass
class SHConfig:
    """Successive Halving / Hyperband policy + model configuration."""
    max_epochs: int = 27            # R: full-fidelity resource per config
    min_epochs: int = 1             # r: resource of the first rung
    eta: int = 3                    # promotion fraction 1/eta per rung
    promotion: str = "lkgp"         # "lkgp" (predicted final) | "rank" (observed)
    rule: str = "ucb"               # lkgp scoring: "ucb" | "quantile"
    ucb_beta: float = 1.0
    quantile: float = 0.75
    maximize: bool = True
    gp: LKGPConfig = field(default_factory=lambda: LKGPConfig(lbfgs_iters=30))
    # Host L-BFGS budget for warm refits; ignored when gp.polish_steps >= 0.
    refit_lbfgs_iters: int | None = 10
    # Explicit repro_torch.amortize.Amortizer; passing one opts every fit and
    # refit into amortized inits with it (None defers to gp.hyper_init).
    amortizer: object | None = None


def _predictor(X, cfg: SHConfig, seed: int, t, device) -> CurvePredictor:
    return CurvePredictor(
        X, cfg.max_epochs, gp=cfg.gp, maximize=cfg.maximize,
        refit_lbfgs_iters=cfg.refit_lbfgs_iters, seed=seed, t=t,
        amortizer=cfg.amortizer, device=device)


class SuccessiveHalvingScheduler:
    """One Successive Halving race over a pool of runs.

    ``step_fns[i]() -> float`` advances config i one epoch. With
    ``cfg.promotion == "lkgp"`` every rung folds the pool's curves into the
    shared :class:`CurvePredictor` (extend + warm refit) and promotes by
    predicted final value; ``"rank"`` is the classic observed-metric
    baseline and never touches the model.
    """

    def __init__(self, X, step_fns, cfg: SHConfig | None = None, seed: int = 0,
                 pool: RunPool | None = None,
                 predictor: CurvePredictor | None = None, t=None, *,
                 device=None):
        self.X = np.asarray(X, np.float64)
        self.cfg = cfg or SHConfig()
        self.seed = seed
        self.pool = pool if pool is not None else RunPool(
            step_fns, self.cfg.max_epochs)
        if predictor is None and self.cfg.promotion == "lkgp":
            # ``t`` carries a real dataset's (possibly non-uniform) budget
            # grid into the model; rung resources stay epoch *indices*.
            predictor = _predictor(self.X, self.cfg, seed, t, device)
        self.predictor = predictor
        self.history: list[dict] = []

    # -- scoring -----------------------------------------------------------
    def _scores(self, active: list[int]) -> np.ndarray:
        """Score-space promotion scores for the active subset."""
        cfg = self.cfg
        sign = 1.0 if cfg.maximize else -1.0
        if cfg.promotion == "rank":
            vals = np.array([sign * self.pool.observed_last(i)
                             for i in active])
            # never-run configs (NaN under an exhausted budget) rank worst -
            # argmax/argsort would otherwise propagate the NaN as a max
            return np.where(np.isnan(vals), -np.inf, vals)
        if cfg.promotion != "lkgp":
            raise ValueError(f"unknown promotion mode {cfg.promotion!r}; "
                             "expected 'lkgp' or 'rank'")
        self.predictor.update(self.pool.Y, self.pool.mask)
        scores = self.predictor.scores(rule=cfg.rule, ucb_beta=cfg.ucb_beta,
                                       quantile=cfg.quantile)
        return scores[np.asarray(active)]

    # -- core loop ---------------------------------------------------------
    def run(self, subset: list[int] | None = None,
            min_epochs: int | None = None) -> dict:
        """Race ``subset`` (default: the whole pool) through the rungs.

        ``min_epochs`` overrides the first-rung resource (used by Hyperband
        brackets). Returns a summary dict; ``selected`` is the surviving
        config with the best score.
        """
        cfg = self.cfg
        active = list(range(self.pool.n)) if subset is None else list(subset)
        r = int(min_epochs if min_epochs is not None else cfg.min_epochs)
        # clamp to [1, max_epochs]: r > R would make the rung count
        # non-positive; r == R degenerates to one full-fidelity rung
        r = max(1, min(r, cfg.max_epochs))
        num_rungs = int(math.floor(
            math.log(cfg.max_epochs / r) / math.log(cfg.eta))) + 1

        scores = None
        for k in range(num_rungs):
            target = (cfg.max_epochs if k == num_rungs - 1
                      else min(cfg.max_epochs, r * cfg.eta ** k))
            for i in active:
                self.pool.advance_to(i, target)
            scores = self._scores(active)
            rung = {"rung": k, "target_epochs": int(target),
                    "active": list(active),
                    "scores": [float(s) for s in scores],
                    "epochs_spent": int(self.pool.spent)}
            if k < num_rungs - 1 and len(active) > 1:
                keep = max(1, int(math.ceil(len(active) / cfg.eta)))
                order = np.argsort(-scores, kind="stable")[:keep]
                active = [active[j] for j in sorted(order)]
                scores = scores[np.sort(order)]
                rung["promoted"] = list(active)
            self.history.append(rung)
            if self.pool.exhausted():
                break

        best = int(active[int(np.argmax(scores))])
        summary = {
            "epochs_spent": int(self.pool.spent),
            "selected": best,
            "survivors": list(active),
            "rungs": self.history,
            "observed_best": self.pool.observed_best(cfg.maximize),
        }
        if self.predictor is not None and self.predictor.state is not None:
            mean, _ = self.predictor.predict_final()
            summary["predicted_final"] = self.predictor.to_raw(mean).tolist()
        return summary


class HyperbandScheduler:
    """Hyperband: Successive Halving brackets over one shared pool + model.

    Bracket s starts ``n_s = ceil((s_max+1)/(s+1) * eta^s)`` configs at
    resource ``R * eta^-s``; s runs from most-aggressive (s_max) down to
    plain full-resource evaluation (0). Configs are drawn without
    replacement per bracket from the finite pool, favouring the
    least-trained so brackets spread coverage. The shared
    :class:`RunPool` never re-charges epochs a config already ran, and in
    ``"lkgp"`` mode every bracket re-uses (and further sharpens) the same
    warm-started model state.
    """

    def __init__(self, X, step_fns, cfg: SHConfig | None = None,
                 seed: int = 0, candidates: list[int] | None = None,
                 t=None, *, device=None):
        self.X = np.asarray(X, np.float64)
        self.cfg = cfg or SHConfig()
        self.seed = seed
        # brackets sample (and may select) only from `candidates`; other
        # pool rows - e.g. completed curves from previous experiments -
        # still inform the shared model through the config kernel.
        self.candidates = (list(range(len(step_fns)))
                           if candidates is None else list(candidates))
        self.pool = RunPool(step_fns, self.cfg.max_epochs)
        self.predictor = None
        if self.cfg.promotion == "lkgp":
            self.predictor = _predictor(self.X, self.cfg, seed, t, device)
        self.brackets: list[dict] = []

    def run(self) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(self.seed)
        s_max = int(math.floor(math.log(cfg.max_epochs) / math.log(cfg.eta)))
        candidates: list[tuple[int, float]] = []   # (config, score)

        cand = np.asarray(self.candidates)
        for s in range(s_max, -1, -1):
            n_s = int(math.ceil((s_max + 1) / (s + 1) * cfg.eta ** s))
            n_s = min(n_s, len(cand))
            # least-trained first; random tie-break inside equal counts
            jitter = rng.random(len(cand))
            order = np.lexsort((jitter, self.pool.epochs_done[cand]))
            subset = sorted(int(i) for i in cand[order[:n_s]])
            r_s = max(1, int(round(cfg.max_epochs * cfg.eta ** (-s))))

            sh = SuccessiveHalvingScheduler(
                self.X, self.pool.step_fns, cfg, seed=self.seed + s,
                pool=self.pool, predictor=self.predictor)
            summary = sh.run(subset=subset, min_epochs=r_s)
            last = summary["rungs"][-1]
            sel = summary["selected"]
            sel_score = last["scores"][last["active"].index(sel)]
            candidates.append((sel, float(sel_score)))
            self.brackets.append({"bracket": s, "n_configs": n_s,
                                  "min_epochs": r_s, **summary})

        best = max(candidates, key=lambda cs: cs[1])[0]
        return {
            "epochs_spent": int(self.pool.spent),
            "selected": int(best),
            "bracket_selections": candidates,
            "brackets": self.brackets,
            "observed_best": self.pool.observed_best(cfg.maximize),
        }
