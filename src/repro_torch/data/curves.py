"""Synthetic learning-curve generator (LCBench-like prior), numpy only.

Counterpart of ``repro.data.curves`` (a copy: the port imports nothing of
the reference); for the same arguments every function returns identical
arrays. Tasks are sampled from the
parametric families the DPL / ifBO priors use (pow3, log-power,
exponential-saturation, Janoschek), with hyper-parameter-driven coefficients,
heteroskedastic noise, occasional spikes and divergent curves.

A "task" = n configs x of dim d, curves over m epochs, plus an
early-stopping mask (each curve observed up to a random cutoff). Suites of
tasks stack for the batched ``fit_batch`` / ``posterior_batch`` path; the
step functions are the schedulers' observation models.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np

__all__ = ["CurveTask", "sample_task", "sample_suite", "stack_suite",
           "noisy_step_fns", "replay_step_fns", "benchmark_cutoffs"]


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


def sample_suite(seed: int, num_tasks: int, n: int = 16, m: int = 12,
                 d: int = 7, **task_kwargs) -> list[CurveTask]:
    """A suite of independent tasks with shared shapes (one noise regime).

    All tasks share (n, m, d) so the suite can be stacked for the batched
    ``fit_batch`` / ``posterior_batch`` path; ``task_kwargs`` forward to
    :func:`sample_task` (noise, spike_prob, diverge_prob, ...).
    """
    return [sample_task(seed * 1000 + b, n=n, m=m, d=d, **task_kwargs)
            for b in range(num_tasks)]


def _pad_grid(t: np.ndarray, m_pad: int) -> np.ndarray:
    """Extend a strictly-increasing grid by repeating its last step."""
    m = t.shape[0]
    if m_pad <= m:
        return t
    step = float(t[-1] - t[-2]) if m >= 2 else 1.0
    extra = t[-1] + step * np.arange(1, m_pad - m + 1)
    return np.concatenate([t, extra])


def stack_suite(tasks: list[CurveTask], pad: bool = False):
    """Stack a suite into (X, t, Y, mask, Y_full) batch arrays.

    Shape-aligned suites (e.g. from :func:`sample_suite`) stack directly
    and return a shared 1-D ``t``. Real artifact suites are usually ragged
    (each task its own (n, m)); with ``pad=True`` they are zero-padded to
    the max shape instead of raising: padded curve cells carry ``mask=0``
    (so they never enter a masked likelihood), padded config rows repeat
    the task's last config (keeping input-transform statistics in range)
    with an all-zero mask, and each grid is extended by its own last step.
    Padded/ragged suites return ``t`` of shape (B, m_max). Hyper-parameter
    dimension ``d`` must match — it cannot be padded meaningfully.
    """
    if not tasks:
        raise ValueError("stack_suite needs at least one task")
    shapes = [(tk.X.shape, tk.Y.shape) for tk in tasks]
    ds = {tk.X.shape[1] for tk in tasks}
    if len(ds) != 1:
        detail = ", ".join(f"task {i}: d={tk.X.shape[1]}"
                           for i, tk in enumerate(tasks))
        raise ValueError("stack_suite cannot align tasks with different "
                         f"hyper-parameter dimensions ({detail})")
    if len(set(shapes)) != 1:
        if not pad:
            ref = max(set(shapes), key=shapes.count)
            offending = [f"task {i}: X{sh[0]} Y{sh[1]}"
                         for i, sh in enumerate(shapes) if sh != ref]
            raise ValueError(
                "stack_suite needs shape-aligned tasks; majority shape is "
                f"X{ref[0]} Y{ref[1]} but {'; '.join(offending)}. Pass "
                "pad=True to zero-pad ragged tasks, or use sample_suite "
                "for aligned synthetic suites.")
        n_max = max(tk.X.shape[0] for tk in tasks)
        m_max = max(tk.t.shape[0] for tk in tasks)
        Xs, ts, Ys, masks, fulls = [], [], [], [], []
        for tk in tasks:
            n, m = tk.Y.shape
            Xs.append(np.concatenate(
                [tk.X, np.repeat(tk.X[-1:], n_max - n, axis=0)], axis=0))
            ts.append(_pad_grid(np.asarray(tk.t, np.float64), m_max))
            grid_pad = ((0, n_max - n), (0, m_max - m))
            Ys.append(np.pad(tk.Y, grid_pad))
            masks.append(np.pad(tk.mask, grid_pad))
            fulls.append(np.pad(tk.Y_full, grid_pad))
        return (np.stack(Xs), np.stack(ts), np.stack(Ys), np.stack(masks),
                np.stack(fulls))
    t0 = np.asarray(tasks[0].t)
    ragged_t = any(not np.array_equal(np.asarray(tk.t), t0) for tk in tasks)
    t = np.stack([tk.t for tk in tasks]) if ragged_t else tasks[0].t
    return (np.stack([tk.X for tk in tasks]),
            t,
            np.stack([tk.Y for tk in tasks]),
            np.stack([tk.mask for tk in tasks]),
            np.stack([tk.Y_full for tk in tasks]))


def noisy_step_fns(task: CurveTask, seed: int, obs_noise: float = 0.02,
                   spike_prob: float = 0.03):
    """Per-config ``step() -> observed metric`` callables over a task.

    The scheduler-facing observation model: the clean curve ``Y_full`` plus
    Gaussian eval noise and occasional downward spikes — noise lives in the
    *observation stream* (as in real eval pipelines), so ``Y_full`` remains
    the ground truth that regret is measured against. The reference's
    scheduler benchmark, example and tests share this model.
    """
    rng = np.random.default_rng(seed)
    counters = [0] * len(task.X)

    def mk(i):
        def step():
            e = counters[i]
            counters[i] += 1
            v = task.Y_full[i, e] + rng.normal(0, obs_noise)
            if rng.random() < spike_prob:
                v -= rng.uniform(0.05, 0.3)
            return float(v)
        return step

    return [mk(i) for i in range(len(task.X))]


def replay_step_fns(task: CurveTask, seed: int = 0, obs_noise: float = 0.0,
                    spike_prob: float = 0.0, censored: bool | None = None):
    """``noisy_step_fns``-compatible callables replaying a *loaded* task.

    Drives schedulers through a real (artifact) task's recorded curves:
    ``step()`` for config i returns the next value of ``Y_full[i]``. For a
    censored config (artifact without post-cutoff ground truth — the
    loader stores ``Y_full = Y`` zeroed past the early-stop mask), steps
    beyond the observed prefix hold the last observed value rather than
    replaying the padding zeros. ``obs_noise`` / ``spike_prob`` optionally
    re-add an observation-stream noise model on top of the recorded
    values (default: exact replay).

    ``censored`` is the authoritative flag (pass ``not has_full[i]`` from
    :class:`~repro_torch.data.lcbench.LCBenchArtifact`): ``False`` means
    ``Y_full`` is trusted everywhere (a genuinely recorded all-zero tail
    replays as zeros), ``True`` holds the last observed value past every
    early-stop point. ``None`` falls back to a per-config heuristic —
    an exact-zero tail past the mask is treated as loader padding.
    """
    rng = np.random.default_rng(seed)
    Y_full = np.asarray(task.Y_full, np.float64)
    mask = np.asarray(task.mask, np.float64)
    m = Y_full.shape[1]
    lens = mask.sum(axis=1).astype(np.int64)
    if censored is None:
        # Heuristic: no information past the early-stop mask (exact zeros
        # are the loader's fallback padding).
        cens = [int(lens[i]) < m and not np.any(Y_full[i, int(lens[i]):])
                for i in range(Y_full.shape[0])]
    else:
        cens = [bool(censored) and int(lens[i]) < m
                for i in range(Y_full.shape[0])]
    counters = [0] * Y_full.shape[0]

    def mk(i):
        def step():
            e = counters[i]
            counters[i] += 1
            if cens[i]:
                if lens[i] == 0:
                    # Nothing was ever recorded; replaying the loader's
                    # padding zeros would hand schedulers fabricated (and,
                    # for minimized metrics, unbeatable) observations.
                    raise RuntimeError(
                        f"replay_step_fns: config {i} is censored with no "
                        "observed values — nothing to replay")
                e = min(e, int(lens[i]) - 1)
            else:
                e = min(e, m - 1)
            v = Y_full[i, e]
            if obs_noise:
                v = v + rng.normal(0, obs_noise)
            if spike_prob and rng.random() < spike_prob:
                v -= rng.uniform(0.05, 0.3)
            return float(v)
        return step

    return [mk(i) for i in range(Y_full.shape[0])]


def benchmark_cutoffs(n_train_examples: int, n: int, m: int,
                      seed: int) -> np.ndarray:
    """ifBO-style protocol: a budget of observed values spread over configs."""
    rng = np.random.default_rng(seed)
    lens = np.zeros(n, np.int64)
    order = rng.permutation(n)
    budget = n_train_examples
    if budget > n * m:
        # Without the clamp the while loop below never terminates once
        # every lens[c] == m (no step can decrement the budget).
        warnings.warn(f"benchmark_cutoffs: budget {n_train_examples} exceeds "
                      f"the grid size n*m = {n * m}; clamping",
                      stacklevel=2)
        budget = n * m
    i = 0
    while budget > 0:
        c = order[i % n]
        if lens[c] < m:
            lens[c] += 1
            budget -= 1
        i += 1
    return lens
