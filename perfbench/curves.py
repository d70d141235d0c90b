"""Synthetic learning curves at LCBench's shapes: the benchmark's frozen copy.

Copied from ``src/repro_torch/data/curves.py`` (``CurveTask``,
``_curve_family``, ``sample_task``) as that file stood when the benchmark was
defined, so that a change to the program cannot change the yardstick's
traffic. For the same arguments it returns the same arrays as the original
did then. NumPy only.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["CurveTask", "sample_task"]


class CurveTask(NamedTuple):
    X: np.ndarray       # (n, d) hyper-parameters in [0, 1]
    t: np.ndarray       # (m,) progression grid: epochs 1..m, or any
                        # positive strictly-increasing budgets (log-spaced
                        # fidelities, step counts, ...)
    Y: np.ndarray       # (n, m) validation-accuracy-like curves
    mask: np.ndarray    # (n, m) 1.0 where observed
    Y_full: np.ndarray  # ground truth (n, m)


def _curve_family(rng, x, t_norm, crossing: bool = False):
    """One curve as a function of its hyper-parameters x (d >= 4 used).

    ``crossing`` anti-correlates convergence rate with the asymptote
    (high-asymptote configs are slow starters — the small-learning-rate
    regime), so curves cross and early rankings mislead rank-based
    promotion. In crossing mode the family is also a deterministic
    function of x (real HPO response surfaces are; a per-curve coin flip
    is irreducible noise no surrogate could transfer across configs).
    """
    kind = min(3, int(4.0 * x[2])) if crossing else rng.integers(0, 4)
    # config-dependent asymptote / rate / delay
    asym = 0.55 + 0.4 * (0.6 * x[0] + 0.4 * x[1]) - 0.1 * (x[2] - 0.5) ** 2
    if crossing:
        rate = 0.5 + 6.0 * (1.0 - x[0]) + 2.0 * (1.0 - x[1])
    else:
        rate = 0.5 + 6.0 * x[2] + 2.0 * x[0]
    delay = 0.05 + 0.3 * x[3]
    lo = 0.08 + 0.15 * x[1]
    tt = np.maximum(t_norm - 0.02 * delay, 1e-4)
    if kind == 0:      # pow3: asym - a * t^-alpha
        a = (asym - lo)
        pow_p = 0.3 + 1.5 * ((1.0 - x[0]) if crossing else x[2])
        y = asym - a * np.power(tt * 50 + 1, -pow_p)
    elif kind == 1:    # log-power
        y = asym / (1 + np.power(tt * 30 / np.exp(delay), -(0.8 + rate / 4)))
        y = lo + (asym - lo) * (y / max(asym, 1e-3))
    elif kind == 2:    # exponential saturation
        y = asym - (asym - lo) * np.exp(-rate * tt * 3)
    else:              # Janoschek
        y = asym - (asym - lo) * np.exp(-rate * np.power(tt, 1.2) * 2.5)
    return np.clip(y, 0.0, 1.0)


def sample_task(seed: int, n: int = 32, m: int = 20, d: int = 7,
                observed_fraction: tuple[float, float] = (0.1, 0.9),
                noise: float = 0.01, spike_prob: float = 0.05,
                diverge_prob: float = 0.03,
                crossing: bool = False, t: np.ndarray | None = None) -> CurveTask:
    """Sample one task from the prior; ``t`` overrides the epoch grid.

    With ``t`` given (positive, strictly increasing — e.g. log-spaced
    budget fidelities), curves are evaluated at those progressions and
    ``m = len(t)``; the default remains epochs ``1..m``.
    """
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d))
    if t is None:
        t = np.arange(1.0, m + 1.0)
    else:
        t = np.asarray(t, np.float64)
        if t.ndim != 1 or t.shape[0] < 1 or np.any(np.diff(t) <= 0) \
                or t[0] <= 0:
            raise ValueError("t must be a positive strictly-increasing 1-D "
                             f"grid, got {t}")
        m = t.shape[0]
    t_norm = ((t - t[0]) / (t[-1] - t[0]) if m > 1 and t[-1] > t[0]
              else t * 0 + 1.0)
    Y = np.stack([_curve_family(rng, X[i], t_norm, crossing=crossing)
                  for i in range(n)])

    # noise, spikes, divergence (Fig 1 right panel regimes)
    Y = Y + rng.normal(0, noise * (0.5 + X[:, :1]), Y.shape)
    spikes = rng.random(Y.shape) < spike_prob
    Y = np.where(spikes, Y - rng.uniform(0.05, 0.3, Y.shape), Y)
    diverges = rng.random(n) < diverge_prob
    for i in np.where(diverges)[0]:
        start = rng.integers(m // 2, m)
        Y[i, start:] -= np.linspace(0, 0.3, m - start)
    Y = np.clip(Y, 0.0, 1.0)

    Y_full = Y.copy()
    lens = rng.integers(max(1, int(observed_fraction[0] * m)),
                        max(2, int(observed_fraction[1] * m)) + 1, n)
    lens[rng.integers(0, n)] = m  # keep one fully observed curve
    mask = (np.arange(m)[None, :] < lens[:, None]).astype(np.float64)
    return CurveTask(X=X, t=t, Y=Y * mask, mask=mask, Y_full=Y_full)
