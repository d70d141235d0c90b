"""Stochastic-gradient linear solver with Polyak iterate averaging.

Counterpart of ``repro.core.solvers.sgd`` (the follow-up paper "Scalable
Gaussian Processes with Latent Kronecker Structure", arXiv 2506.06895, for
large n). Each sweep is one operator application, the cost of a CG sweep,
but the iteration is a plain heavy-ball step on f(x) = 1/2 x^T A x - b^T x:

    v <- momentum * v + r
    x <- x + lr * v

with ``lr ~ 1 / lambda_max(A)`` from power iteration when not given. It
tolerates low precision and never breaks down on an indefinite
``p^T A p``. Polyak (tail) averaging: the running mean of the iterates past a
burn-in is tracked beside the running mean of their residuals (free, by
linearity of ``r = b - A x``), and the averaged iterate is returned per
system wherever its residual beats the last iterate's.

The diagnostics are :class:`~.cg.CGResult`'s: per-column convergence
freezing, ``col_iters``, active-column ``matvecs``, the TRUE final residual
(from ``A.accurate`` where the operator has one, as in CG). ``breakdown``
flags non-finite iterates (divergence). As in :mod:`.cg`, the loop runs on
the host with one device-to-host read per iteration (the loop condition).
"""
from __future__ import annotations

from typing import Callable

import torch

from .cg import CGResult, _dot

__all__ = ["sgd_solve", "estimate_lmax"]


@torch.no_grad()
def estimate_lmax(A: Callable, b: torch.Tensor, iters: int = 8
                  ) -> torch.Tensor:
    """Largest eigenvalue of SPD ``A`` by power iteration started at ``b``.

    ``b`` (..., n, m) may carry leading system dims; every system runs its
    own power iteration (sharing the batched operator sweeps) and the max
    over systems is returned: one 0-d tensor, since all systems share the
    operator. All-zero systems contribute 0.
    """
    nrm = torch.sqrt(_dot(b, b))
    v = b / torch.where(nrm == 0, torch.ones_like(nrm), nrm)[..., None, None]
    lam = torch.zeros(b.shape[:-2], dtype=b.dtype, device=b.device)
    for _ in range(iters):
        w = A(v)
        lam = torch.sqrt(_dot(w, w))
        safe = torch.where(lam == 0, torch.ones_like(lam), lam)
        v = w / safe[..., None, None]
    return lam.max()


@torch.no_grad()
def sgd_solve(A: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
              tol: float = 0.01, max_iters: int = 500,
              x0: torch.Tensor | None = None, momentum: float = 0.9,
              lr: float = 0.0, lr_iters: int = 8,
              avg_frac: float = 0.5) -> CGResult:
    """Solve SPD ``A x = b`` by heavy-ball gradient descent with Polyak tail
    averaging, on grid-form (..., n, m) right-hand-side stacks.

    ``lr <= 0`` takes the step size ``1 / lambda_max(A)`` from ``lr_iters``
    power-iteration sweeps (stable for any momentum in [0, 1)). Averaging
    starts after ``avg_frac * max_iters`` sweeps; the averaged iterate is
    used per system only where its (exactly tracked) residual beats the last
    iterate's. Otherwise as :func:`~.cg.cg_solve`: converged columns freeze
    and stop counting toward ``matvecs``, and ``rel_residual`` is the true
    final ``||b - A x|| / ||b||``.
    """
    dev, dt = b.device, b.dtype
    if x0 is None:
        x0 = torch.zeros_like(b)
    b_norm = torch.sqrt(_dot(b, b))
    safe_b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)
    sys_shape = b.shape[:-2]

    if lr and lr > 0:
        step_size = torch.tensor(lr, dtype=dt, device=dev)
    else:
        lam = estimate_lmax(A, b, iters=lr_iters)
        step_size = 1.0 / torch.where(lam == 0, torch.ones_like(lam), lam)

    avg_start = int(max_iters * avg_frac)
    x, v, r = x0, torch.zeros_like(b), b - A(x0)
    breakdown = torch.zeros(sys_shape, dtype=torch.bool, device=dev)
    col_iters = torch.zeros(sys_shape, dtype=torch.int32, device=dev)
    matvecs = torch.zeros((), dtype=torch.int32, device=dev)
    x_sum, r_sum = torch.zeros_like(b), torch.zeros_like(b)
    avg_cnt = torch.zeros(sys_shape, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters:
        rel = torch.sqrt(_dot(r, r)) / safe_b_norm
        active = (rel > tol) & ~breakdown
        # the one device-to-host read of the iteration
        if not active.any().item():  # lint: disable=RT103 (designed)
            break
        am = active[..., None, None]
        v = torch.where(am, momentum * v + r, v)
        x = torch.where(am, x + step_size * v, x)
        r = torch.where(am, b - A(x), r)
        # Divergence shows up as inf/nan in the residual: flag it as
        # breakdown (freezing the column) rather than looping to max_iters.
        blew_up = active & ~torch.isfinite(r).all(dim=-1).all(dim=-1)
        do_avg = active & (it + 1 > avg_start)
        davg = do_avg[..., None, None]
        breakdown = breakdown | blew_up
        col_iters = torch.where(active, it + 1, col_iters)
        matvecs = matvecs + active.sum(dtype=torch.int32)
        x_sum = torch.where(davg, x_sum + x, x_sum)
        r_sum = torch.where(davg, r_sum + r, r_sum)
        avg_cnt = avg_cnt + do_avg.to(torch.int32)
        it += 1
    # Polyak average: the mean of the tail iterates; by linearity of
    # r = b - A(x) its residual is the mean of the tail residuals, so the
    # averaged-vs-last choice costs no extra operator sweep.
    cnt = torch.clamp(avg_cnt, min=1)[..., None, None].to(dt)
    x_avg, r_avg = x_sum / cnt, r_sum / cnt
    use_avg = (avg_cnt > 0) & (_dot(r_avg, r_avg) < _dot(r, r))
    x = torch.where(use_avg[..., None, None], x_avg, x)
    A_acc = getattr(A, "accurate", None)
    r_true = b - (A_acc if A_acc is not None else A)(x)
    return CGResult(
        x=x, iters=torch.tensor(it, dtype=torch.int32, device=dev),
        rel_residual=torch.sqrt(_dot(r_true, r_true)) / safe_b_norm,
        breakdown=breakdown, col_iters=col_iters, matvecs=matvecs)
