"""L-BFGS with two-loop recursion and strong-Wolfe line search.

Counterpart of ``repro.core.lbfgs``, with the same rules: the curvature-pair
skip in the two-loop recursion and a line search that never hands back a
non-finite objective. The optimiser is a host loop on numpy float64 vectors;
each objective evaluation (a CG solve on the device) is one call of
``value_and_grad``, and every Wolfe / curvature decision needs its scalar on
the host anyway.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

__all__ = ["lbfgs_minimize", "LBFGSResult"]


class LBFGSResult(NamedTuple):
    x: np.ndarray
    fun: float
    n_iters: int
    n_evals: int
    converged: bool


def _two_loop(g, s_list, y_list):
    """H * g via the standard two-loop recursion.

    Pairs with non-positive curvature ``y.s <= 0`` (or non-finite products)
    are skipped; clamping them would turn a curvature violation into
    ``rho ~ 1/eps`` and an exploding direction.
    """
    pairs = []
    for s, y in zip(s_list, y_list):
        ys = float(np.dot(y, s))
        if np.isfinite(ys) and ys > 0:
            pairs.append((s, y, 1.0 / ys))
    q = g.copy()
    alphas = []
    for s, y, rho in reversed(pairs):
        a = rho * float(np.dot(s, q))
        alphas.append(a)
        q -= a * y
    if pairs:
        s, y, _ = pairs[-1]
        gamma = float(np.dot(s, y)) / max(float(np.dot(y, y)), 1e-300)
        q *= gamma
    for (s, y, rho), a in zip(pairs, reversed(alphas)):
        b = rho * float(np.dot(y, q))
        q += (a - b) * s
    return q


def _wolfe_line_search(fg, x, f0, g0, d, c1=1e-4, c2=0.9, max_evals=25):
    """Strong-Wolfe line search (bracket + zoom, Nocedal & Wright alg. 3.5/3.6)."""
    dg0 = float(np.dot(g0, d))
    if dg0 >= 0:  # not a descent direction; caller resets
        return None, 0

    def phi(a):
        f, g = fg(x + a * d)
        return float(f), g, float(np.dot(g, d))

    evals = 0
    a_prev, f_prev, dg_prev = 0.0, f0, dg0
    a = 1.0
    a_max = 1e10
    for _ in range(max_evals):
        f, g, dg = phi(a)
        evals += 1
        if not np.isfinite(f):
            a_max = a
            a = 0.5 * (a_prev + a)
            continue
        if f > f0 + c1 * a * dg0 or (evals > 1 and f >= f_prev):
            lo, f_lo, dg_lo, hi = a_prev, f_prev, dg_prev, a
            break
        if abs(dg) <= -c2 * dg0:
            return (a, f, g), evals
        if dg >= 0:
            lo, f_lo, dg_lo, hi = a, f, dg, a_prev
            break
        a_prev, f_prev, dg_prev = a, f, dg
        a = min(2.0 * a, a_max)
    else:
        # Best effort: only hand back a finite decrease; a non-finite f here
        # would poison the (s, y) pair and the next iterate. (f, g) belong to
        # a_prev: the loop body doubles `a` past the last evaluated point.
        if np.isfinite(f) and f < f0 and a_prev > 0:
            return (a_prev, f, g), evals
        return None, evals

    # zoom
    best = None
    for _ in range(max_evals):
        a = 0.5 * (lo + hi)
        f, g, dg = phi(a)
        evals += 1
        if np.isfinite(f) and f < f0 and (best is None or f < best[1]):
            best = (a, f, g)
        if not np.isfinite(f) or f > f0 + c1 * a * dg0 or f >= f_lo:
            hi = a
        else:
            if abs(dg) <= -c2 * dg0:
                return (a, f, g), evals
            if dg * (hi - lo) >= 0:
                hi = lo
            lo, f_lo, dg_lo = a, f, dg
        if abs(hi - lo) < 1e-14:
            break
    return best, evals  # best finite decrease seen, or None (caller resets)


def lbfgs_minimize(value_and_grad: Callable, x0, max_iters: int = 100,
                   history: int = 10, gtol: float = 1e-6,
                   ftol: float = 1e-10) -> LBFGSResult:
    """Minimise a smooth objective. ``value_and_grad(x) -> (f, g)`` takes a
    numpy float64 vector (its own copy) and returns a float and a vector."""

    def fg(x):
        f, g = value_and_grad(np.array(x, dtype=np.float64))
        return float(f), np.asarray(g, dtype=np.float64)

    x = np.asarray(x0, dtype=np.float64).copy()
    f, g = fg(x)
    n_evals = 1
    s_list: list[np.ndarray] = []
    y_list: list[np.ndarray] = []
    converged = False
    it = 0
    for it in range(1, max_iters + 1):
        if np.max(np.abs(g)) < gtol:
            converged = True
            break
        d = -_two_loop(g, s_list, y_list)
        res, ev = _wolfe_line_search(fg, x, f, g, d)
        n_evals += ev
        if res is None:  # bad direction: reset memory, steepest descent
            s_list.clear()
            y_list.clear()
            d = -g
            res, ev = _wolfe_line_search(fg, x, f, g, d)
            n_evals += ev
            if res is None:
                break
        a, f_new, g_new = res
        x_new = x + a * d
        s = x_new - x
        y = g_new - g
        if float(np.dot(s, y)) > 1e-10 * float(np.linalg.norm(s)) * float(np.linalg.norm(y)):
            s_list.append(s)
            y_list.append(y)
            if len(s_list) > history:
                s_list.pop(0)
                y_list.pop(0)
        if abs(f - f_new) < ftol * max(1.0, abs(f)):
            x, f, g = x_new, f_new, g_new
            converged = True
            break
        x, f, g = x_new, f_new, g_new
    # The gradient tolerance is checked on the final iterate too, so a run
    # that reaches it on its last iteration reports converged=True.
    if not converged and np.max(np.abs(g)) < gtol:
        converged = True
    return LBFGSResult(x=x, fun=f, n_iters=it, n_evals=n_evals, converged=converged)
