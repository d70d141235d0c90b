"""Preconditioned block CG.

Counterpart of ``repro.core.solvers.pcg``: the preconditioned variant of
:mod:`.cg`, with the same per-column freezing, breakdown flags, warm starts
and TRUE-final-residual reporting, and an ``M_inv`` approximate inverse
applied to the whole right-hand-side stack once per sweep (see
:mod:`repro_torch.core.precond` for the pivoted-Cholesky / Woodbury
construction). It is the CG loop itself (``cg._cg_loop`` with ``M_inv``), so
an operator with ``accurate`` gets CG's residual replacement here too: true
residuals from it at the start, every ``REPLACE_EVERY`` iterations and at the
end, each followed by ``z = M^-1 r`` and the line-minimum step along the kept
direction. A float32 sweep under a float64 state therefore stops on float64
residuals, as CG does.
"""
from __future__ import annotations

from typing import Callable

import torch

from .cg import CGResult, _cg_loop

__all__ = ["pcg_solve"]


def _on_grid(f: Callable) -> Callable:
    """A map of packed vectors (..., N) as one of (..., N, 1) grid views."""
    return lambda u: f(u[..., 0])[..., None]


def pcg_solve(A: Callable, b: torch.Tensor, M_inv: Callable,
              tol: float = 0.01, max_iters: int = 10_000,
              x0: torch.Tensor | None = None) -> CGResult:
    """Preconditioned block CG on packed vectors (..., N).

    ``M_inv`` approximates A^{-1} and is applied to the whole RHS stack in
    one batched sweep per iteration. The stopping rule monitors the
    unpreconditioned (recursively updated) residual, as :func:`cg_solve`
    does; the reported ``rel_residual`` is the true final
    ``||b - Ax|| / ||b||``. Converged columns freeze, ``pAp <= 0`` flags
    breakdown per system, and ``x0`` warm-starts. It runs the grid loop on
    (..., N, 1) views; an ``accurate`` on ``A`` goes along.
    """
    A_grid = _on_grid(A)
    if getattr(A, "accurate", None) is not None:
        A_grid.accurate = _on_grid(A.accurate)
    res, _ = _cg_loop(A_grid, b[..., None], tol, max_iters,
                      None if x0 is None else x0[..., None], record=0,
                      M_inv=_on_grid(M_inv))
    return res._replace(x=res.x[..., 0])


def pcg_solve_grid(A: Callable, b: torch.Tensor, M_inv_packed: Callable,
                   tol: float = 0.01, max_iters: int = 10_000,
                   x0: torch.Tensor | None = None) -> CGResult:
    """:func:`pcg_solve` on grid-form vectors (..., n, m), with a
    preconditioner that acts on packed (..., n*m) ones (the Woodbury apply of
    the operator's ``preconditioner``). The operator, and its ``accurate``,
    see grid-form vectors as in CG; only the preconditioner flattens."""
    def M_inv(r: torch.Tensor) -> torch.Tensor:
        return M_inv_packed(r.reshape(*r.shape[:-2], -1)).reshape(r.shape)

    res, _ = _cg_loop(A, b, tol, max_iters, x0, record=0, M_inv=M_inv)
    return res
