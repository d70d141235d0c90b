"""Head-to-head evaluation: LKGP against the amortized transformer baseline
(counterpart of ``repro.baselines.evaluate``).

Both models see *identical* held-out tasks and identical observation masks
(an observed-prefix cutoff at a given fraction of the epochs, with one
fully observed anchor curve per task: the freeze-thaw setting), and are
scored on the cells the mask hides:

* ``nll``       - mean Gaussian negative log-likelihood on unobserved cells;
* ``mae``       - mean absolute error of the predicted mean on those cells;
* ``rank_corr`` - Spearman correlation of predicted and true final-epoch
                  values across configs (what AutoML promotion ranks on);
* ``fit_s`` / ``predict_s`` - wall clock, each ending in a host read of the
  result. The transformer's ``fit_s`` is 0 by construction (amortized); its
  pre-training cost is reported once, not per task.

The LKGP fits on ``device`` (``None``: the GPU); the transformer predicts
on its parameters' device.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..core import LKGPConfig, fit, posterior
from ..data.curves import CurveTask
from .curve_transformer import (CurveTransformerConfig, gaussian_nll,
                                predict_task)

__all__ = ["cutoff_masks", "eval_lkgp", "eval_transformer",
           "score_predictions", "head_to_head"]


def cutoff_masks(task: CurveTask, cutoffs, seed: int) -> dict:
    """Per-cutoff observation masks: each curve observed up to
    ``round(frac * m)`` epochs; one (seed-deterministic) anchor curve stays
    fully observed. Identical masks are fed to every model under test."""
    n, m = task.Y.shape
    anchor = int(np.random.default_rng(seed).integers(0, n))
    out = {}
    for frac in cutoffs:
        lens = np.full(n, max(1, round(frac * m)), np.int64)
        lens[anchor] = m
        out[frac] = (np.arange(m)[None, :] < lens[:, None]).astype(np.float64)
    return out


def _rank_with_ties(x: np.ndarray) -> np.ndarray:
    """Average-tie ranks (1-based), matching scipy.stats.rankdata."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and x[order[j + 1]] == x[order[i]]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def _spearman(a, b) -> float:
    """Spearman rank correlation via Pearson on average-tie ranks; constant
    input gives nan, as scipy's does."""
    ra, rb = _rank_with_ties(np.asarray(a, np.float64)), \
        _rank_with_ties(np.asarray(b, np.float64))
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    if denom == 0.0:
        return float("nan")
    return float((ra * rb).sum() / denom)


def score_predictions(mean, var, task: CurveTask, mask, valid=None) -> dict:
    """NLL / MAE on unobserved cells + final-value rank correlation.

    ``valid`` (optional (n, m) 0/1 array) restricts scoring to cells whose
    ``task.Y_full`` is real ground truth (censored dataset artifacts); the
    rank correlation likewise ranks only configs whose *final* cell is
    valid. With no scorable hidden cell, NLL and MAE come back NaN.
    """
    truth = task.Y_full
    unobs = np.asarray(mask) == 0
    if valid is not None:
        unobs = unobs & (np.asarray(valid) > 0)
    var = np.maximum(np.asarray(var, np.float64), 1e-8)
    mean = np.asarray(mean, np.float64)
    resid = mean - truth
    nll_cells = gaussian_nll(torch.from_numpy(mean),
                             torch.from_numpy(var).sqrt(),
                             torch.from_numpy(np.asarray(truth, np.float64))
                             ).numpy()
    final_ok = (np.ones(truth.shape[0], bool) if valid is None
                else np.asarray(valid)[:, -1] > 0)
    rho = (_spearman(mean[final_ok, -1], truth[final_ok, -1])
           if int(final_ok.sum()) >= 2 else float("nan"))
    if not np.isfinite(rho):     # constant predictions -> undefined rank
        rho = 0.0
    any_cell = bool(np.any(unobs))
    return {
        "nll": float(np.mean(nll_cells[unobs])) if any_cell else float("nan"),
        "mae": (float(np.mean(np.abs(resid[unobs]))) if any_cell
                else float("nan")),
        "rank_corr": float(rho),
    }


def eval_lkgp(task: CurveTask, mask, gp_cfg: LKGPConfig | None = None,
              seed: int = 0, device=None) -> dict:
    """Fit the LKGP on the masked task; predict mean / var over the grid."""
    dev = resolve_device(device)
    gp_cfg = gp_cfg or LKGPConfig(lbfgs_iters=40, seed=seed)
    Y_obs = task.Y_full * mask
    t0 = time.time()
    state = fit(task.X, task.t, Y_obs, mask, gp_cfg, device=dev)
    fit_s = time.time() - t0      # fit reads its objective: the card is done
    t0 = time.time()
    post = posterior(state, device=dev)
    mean = post.mean.cpu().numpy()
    var = post.variance.cpu().numpy()     # Matheron MC + observation noise
    predict_s = time.time() - t0
    return {"mean": mean, "var": var, "fit_s": fit_s, "predict_s": predict_s}


def eval_transformer(params, model_cfg: CurveTransformerConfig,
                     task: CurveTask, mask) -> dict:
    """One amortized forward pass (no per-task fitting)."""
    t0 = time.time()
    mean, var = predict_task(params, model_cfg, task.X, task.t,
                             task.Y_full * mask, mask)
    predict_s = time.time() - t0
    return {"mean": mean, "var": var, "fit_s": 0.0, "predict_s": predict_s}


def head_to_head(params, model_cfg: CurveTransformerConfig, tasks,
                 cutoffs=(0.2, 0.4, 0.7), gp_cfg: LKGPConfig | None = None,
                 seed: int = 0, suite: str = "heldout",
                 valid_masks=None, device=None) -> list[dict]:
    """Score both models on identical (task, cutoff) cells; one row each.

    ``valid_masks`` (optional, one (n, m) array per task) marks the cells
    whose ``Y_full`` is genuine ground truth; cutoff masks are intersected
    with it and scoring is restricted to it. The LKGP runs on ``device``
    (``None``: the GPU).
    """
    dev = resolve_device(device)
    rows = []
    if tasks:
        # Untimed warm-up: the first fit / forward otherwise charges one-time
        # set-up (the card's libraries, allocator growth) to the first row.
        warm = cutoff_masks(tasks[0], cutoffs[:1], seed=seed * 10_007)
        warm_mask = warm[cutoffs[0]]
        eval_transformer(params, model_cfg, tasks[0], warm_mask)
        eval_lkgp(tasks[0], warm_mask, gp_cfg, seed=seed, device=dev)
    for ti, task in enumerate(tasks):
        masks = cutoff_masks(task, cutoffs, seed=seed * 10_007 + ti)
        valid = None
        if valid_masks is not None:
            valid = np.asarray(valid_masks[ti])  # lint: disable=RT103 (numpy)
        for frac, mask in masks.items():
            if valid is not None:
                mask = mask * valid
                if not np.any((mask == 0) & (valid > 0)):
                    continue   # nothing scorable: every valid cell observed
            preds = {
                "lkgp": eval_lkgp(task, mask, gp_cfg, seed=seed, device=dev),
                "transformer": eval_transformer(params, model_cfg, task,
                                                mask),
            }
            for name, p in preds.items():
                row = {"suite": suite, "task": ti,
                       "cutoff": float(frac),  # lint: disable=RT103 (a key)
                       "model": name,
                       "fit_s": round(p["fit_s"], 4),
                       "predict_s": round(p["predict_s"], 4)}
                row.update({k: round(v, 5) for k, v in
                            score_predictions(p["mean"], p["var"], task,
                                              mask, valid=valid).items()})
                rows.append(row)
    return rows
