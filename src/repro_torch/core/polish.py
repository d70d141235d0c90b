"""Fixed-budget L-BFGS "polish" for warm-started hyper-parameters.

Counterpart of ``repro.core.polish``. :func:`repro_torch.core.lbfgs.lbfgs_minimize`
is a host loop: every Wolfe and curvature decision reads a scalar back from
the device. When the starting point is already good (the previous round's
optimum), a handful of L-BFGS steps suffice, and :func:`make_polish` runs them
with fixed shapes and data-independent control flow: a two-loop recursion
over fixed-size history buffers and an Armijo search over a fixed geometric
step ladder, every decision a ``torch.where`` on device tensors.

That buys the reference's two properties:

* **deterministic cost**: exactly ``1 + steps * n_backtracks`` objective
  evaluations; every rung of the ladder is evaluated, in order, whether or
  not an earlier one was accepted;
* **bitwise batch invariance**: batching is done by calling the ONE
  single-task polish once per task, so ``fit`` (one task) and ``fit_batch``
  (a coalesced batch) polish to the same bits at every batch size.

The optimizer's own arithmetic reads nothing back from the device. The
objective may: on the iterative engines every CG iteration reads its
convergence test on the host (``solvers/cg.py``), and the exact engine's
Cholesky checks its factorisation. A trial point whose objective cannot be
evaluated at all (a Cholesky that fails, a CG solve that breaks down) counts
as a non-finite value and is rejected, as the reference's traced objective
returns NaN there.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["PolishResult", "make_polish"]


class PolishResult(NamedTuple):
    """Polish outcome; every field is a tensor on the objective's device."""
    x: torch.Tensor           # (P,) final iterate
    fun: torch.Tensor         # () final objective value
    grad_inf: torch.Tensor    # () inf-norm of the final gradient
    n_accepted: torch.Tensor  # () number of steps whose line search accepted


def _first_true(flags: torch.Tensor) -> torch.Tensor:
    """Index of the first True in a 1-D bool tensor (0 if none), on device:
    ``torch.argmax`` returns the first of equal maxima."""
    return torch.argmax(flags.to(torch.int32))


def _pick(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 0-d device index, without a host read."""
    return a.index_select(0, i.reshape(1))[0]


def _two_loop(g, S, Yb, rho, valid):
    """H @ g via the two-loop recursion over fixed-size masked history.

    ``S`` / ``Yb`` are (h, P) with the most recent pair at index ``h - 1``;
    ``valid`` masks skipped pairs (curvature condition failed) out of both
    loops, reproducing the standard skip rule without dynamic shapes.
    """
    h = S.shape[0]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    q = g
    alphas = [zero] * h
    for i in range(h - 1, -1, -1):
        a = torch.where(valid[i], rho[i] * torch.dot(S[i], q), zero)
        q = q - a * Yb[i]
        alphas[i] = a
    sy = (S * Yb).sum(dim=1)
    yy = (Yb * Yb).sum(dim=1)
    i_last = h - 1 - _first_true(torch.flip(valid, (0,)))  # most recent valid
    tiny = torch.tensor(1e-30, dtype=g.dtype, device=g.device)
    gamma = torch.where(valid.any(),
                        _pick(sy, i_last) / torch.maximum(_pick(yy, i_last),
                                                          tiny),
                        torch.ones((), dtype=g.dtype, device=g.device))
    q = gamma * q
    for i in range(h):
        b = torch.where(valid[i], rho[i] * torch.dot(Yb[i], q), zero)
        q = q + (alphas[i] - b) * S[i]
    return q


def _shift_in(buf: torch.Tensor, new: torch.Tensor, take: torch.Tensor):
    """``buf`` with its oldest entry dropped and ``new`` appended, where
    ``take``; ``buf`` unchanged elsewhere."""
    return torch.where(take, torch.cat([buf[1:], new[None]]), buf)


def _evaluate(vg, x, args):
    """``vg(x, *args)``; an objective that cannot be evaluated at ``x`` (its
    Cholesky fails, or its CG solve breaks down) gives a NaN value and
    gradient, so the candidate is rejected."""
    from .engines import DegradedSolveError   # engines imports state
    try:
        return vg(x, *args)
    except (torch.linalg.LinAlgError, DegradedSolveError):
        nan = torch.full_like(x, float("nan"))
        return nan[0], nan


def make_polish(vg: Callable, steps: int, history: int = 5,
                c1: float = 1e-4, n_backtracks: int = 4) -> Callable:
    """Build ``polish(x0, *args) -> PolishResult`` running ``steps`` L-BFGS
    steps of the objective whose value and gradient is ``vg(x, *args)``
    (``x`` a flat (P,) tensor; ``vg`` returns a 0-d value and a (P,)
    gradient, both detached).

    Each step evaluates all ``n_backtracks`` Armijo candidates
    ``x + 0.5**j * d``, in order, and takes the first with sufficient
    decrease; if none qualifies the iterate stays put (that step is spent,
    keeping the cost fixed). Iterates are detached between steps, so the
    autograd graph of one evaluation never reaches the next.
    """
    if steps < 1:
        raise ValueError(f"make_polish needs steps >= 1, got {steps}")
    ladder = [0.5 ** j for j in range(n_backtracks)]   # host-side: dtype-free

    def polish(x0, *args):
        x0 = x0.detach()
        dtype, dev = x0.dtype, x0.device
        P = x0.shape[0]
        alphas = torch.tensor(ladder, dtype=dtype, device=dev)
        f0, g0 = vg(x0, *args)
        x, f, g = x0, f0.detach(), g0.detach()
        S = torch.zeros((history, P), dtype=dtype, device=dev)
        Yb = torch.zeros((history, P), dtype=dtype, device=dev)
        rho = torch.zeros((history,), dtype=dtype, device=dev)
        valid = torch.zeros((history,), dtype=torch.bool, device=dev)
        n_acc = torch.zeros((), dtype=torch.int32, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)
        one = torch.ones((), dtype=dtype, device=dev)
        for _ in range(steps):
            d = -_two_loop(g, S, Yb, rho, valid)
            dg = torch.dot(d, g)
            descent = dg < 0
            d = torch.where(descent, d, -g)
            dg = torch.where(descent, dg, -torch.dot(g, g))

            cand = [_evaluate(vg, (x + a * d).detach(), args)
                    for a in ladder]
            fs = torch.stack([c[0].detach() for c in cand])
            gs = torch.stack([c[1].detach() for c in cand])
            ok = torch.isfinite(fs) & (fs <= f + c1 * alphas * dg)
            any_ok = ok.any()
            j = _first_true(ok)                   # first passing candidate
            x_new = torch.where(any_ok, x + _pick(alphas, j) * d, x)
            f_new = torch.where(any_ok, _pick(fs, j), f)
            g_new = torch.where(any_ok, _pick(gs, j), g)

            s = x_new - x
            y = g_new - g
            sy = torch.dot(s, y)
            good = any_ok & (sy > 1e-10 * torch.linalg.vector_norm(s)
                             * torch.linalg.vector_norm(y))
            rho_new = torch.where(good, one / torch.where(good, sy, one),
                                  zero)
            S = _shift_in(S, s, good)
            Yb = _shift_in(Yb, y, good)
            rho = _shift_in(rho, rho_new, good)
            valid = _shift_in(valid, good, good)
            n_acc = n_acc + any_ok.to(torch.int32)
            x, f, g = x_new.detach(), f_new.detach(), g_new.detach()
        return PolishResult(x=x, fun=f, grad_inf=g.abs().max(),
                            n_accepted=n_acc)

    return polish
