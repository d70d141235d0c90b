"""Solver protocol + registry: pluggable linear solvers for the engines.

Counterpart of ``repro.core.solvers.base``. Engines realise the projected
latent-Kronecker operator; *solvers* decide how ``A x = b`` is driven against
it. Three are built in:

* ``cg``  - batched block CG, with the fused CG-Lanczos/SLQ log-det on
            stacked probe solves;
* ``pcg`` - CG preconditioned by the rank-r pivoted Cholesky of the masked
            latent covariance; it needs an operator exposing ``.mask`` and
            ``.preconditioner(rank)`` (``LatentKroneckerOperator`` does) and
            falls back to plain CG otherwise;
* ``sgd`` - heavy-ball stochastic-gradient solves with Polyak averaging.

``LKGPConfig.solver`` selects by name; ``"auto"`` means PCG iff
``precond_rank > 0`` and the operator can be preconditioned, plain CG
otherwise. Register custom solvers with :func:`register_solver`.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Protocol, runtime_checkable

import torch

from ..slq import slq_logdet_from_tridiag, tridiag_from_cg
from .cg import CGResult, cg_solve, cg_solve_tridiag
from .pcg import pcg_solve_grid
from .sgd import sgd_solve

__all__ = [
    "Solver", "SOLVERS", "register_solver", "get_solver", "list_solvers",
    "resolve_solver", "StackedSolveResult", "CGSolver", "PCGSolver",
    "SGDSolver",
]

# Rank used when solver="pcg" is asked for by name but the config left
# precond_rank at 0 (the "auto" route only picks pcg when rank > 0).
_DEFAULT_PCG_RANK = 15


class StackedSolveResult(NamedTuple):
    """One consolidated multi-RHS solve: solutions + (optional) log-det.

    ``x`` are the stacked solutions; ``logdet`` is the SLQ estimate from the
    probe columns' CG-Lanczos tridiagonals (None when it could not be fused:
    a preconditioned solve iterates in M^-1 A's Krylov space, not A's, and
    SGD has no Lanczos correspondence; callers then run SLQ separately);
    ``result`` carries the block solver's per-column diagnostics.
    """
    x: torch.Tensor
    logdet: torch.Tensor | None
    result: CGResult

    @property
    def breakdown(self) -> torch.Tensor | None:
        """Per-RHS-column breakdown flags of the underlying block solve."""
        return None if self.result is None else self.result.breakdown

    @property
    def col_iters(self) -> torch.Tensor | None:
        """Per-RHS-column iteration counts of the underlying block solve."""
        return None if self.result is None else self.result.col_iters

    @property
    def trace(self) -> Any:
        """Escalation trace of the guarded solve that produced this result
        (None for an unguarded solve)."""
        return None if self.result is None else self.result.trace


@runtime_checkable
class Solver(Protocol):
    """Linear-solver strategy driven against an engine operator."""

    name: str

    def solve(self, A: Callable, b: torch.Tensor, config: Any,
              x0: torch.Tensor | None = None) -> CGResult:
        """Solve A x = b for a (stack of) grid-form RHS with diagnostics."""
        ...

    def solve_stacked(self, A: Callable, rhs: torch.Tensor, config: Any, *,
                      probe_cols: int = 0, subspace_dim: Any = None,
                      x0: torch.Tensor | None = None) -> StackedSolveResult:
        """One batched sweep over a whole RHS stack."""
        ...


SOLVERS: dict[str, type] = {}


def register_solver(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        cls.name = name
        SOLVERS[name] = cls
        return cls
    return deco


_SOLVER_SINGLETONS: dict[str, "Solver"] = {}


def get_solver(name: str) -> "Solver":
    """Solver by registry name; solvers are stateless singletons."""
    try:
        cls = SOLVERS[name]
    except KeyError:
        raise ValueError(f"unknown solver {name!r}; "
                         f"available: {sorted(SOLVERS)}") from None
    solver = _SOLVER_SINGLETONS.get(name)
    if solver is None:
        solver = _SOLVER_SINGLETONS[name] = cls()
    return solver


def list_solvers() -> list[str]:
    return sorted(SOLVERS)


def _preconditionable(A: Any) -> bool:
    return hasattr(A, "preconditioner") and hasattr(A, "mask")


def resolve_solver(config: Any, A: Any = None) -> "Solver":
    """Map ``config.solver`` (default ``"auto"``) to a registered solver.

    ``"auto"`` keeps the reference's routing: preconditioned CG iff
    ``precond_rank > 0`` and the operator carries Kronecker factors to
    factorise, plain CG otherwise.
    """
    name = getattr(config, "solver", "auto") or "auto"
    if name == "auto":
        rank = getattr(config, "precond_rank", 0)
        ok = A is None or _preconditionable(A)
        name = "pcg" if (rank and ok) else "cg"
    return get_solver(name)


@register_solver("cg")
class CGSolver:
    """Batched block CG; stacked solves fuse the SLQ log-det via CG-Lanczos."""

    def solve(self, A: Callable, b: torch.Tensor, config: Any,
              x0: torch.Tensor | None = None) -> CGResult:
        return cg_solve(A, b, tol=config.cg_tol,
                        max_iters=config.cg_max_iters, x0=x0)

    def solve_stacked(self, A: Callable, rhs: torch.Tensor, config: Any, *,
                      probe_cols: int = 0, subspace_dim: Any = None,
                      x0: torch.Tensor | None = None) -> StackedSolveResult:
        if probe_cols and x0 is not None:
            # A warm start changes the Krylov starting vectors from the
            # probes to rhs - A x0, breaking the CG-Lanczos correspondence
            # the fused log-det relies on: solve warm, report no logdet (the
            # caller falls back to the separate SLQ pass).
            probe_cols = 0
        if probe_cols:
            res, tri = cg_solve_tridiag(
                A, rhs, max_rank=config.slq_iters, tol=config.cg_tol,
                max_iters=config.cg_max_iters, x0=x0)
            diag, off = tridiag_from_cg(tri.alphas[-probe_cols:],
                                        tri.betas[-probe_cols:],
                                        tri.steps[-probe_cols:])
            logdet = slq_logdet_from_tridiag(diag, off, subspace_dim)
        else:
            res = cg_solve(A, rhs, tol=config.cg_tol,
                           max_iters=config.cg_max_iters, x0=x0)
            logdet = None
        return StackedSolveResult(x=res.x, logdet=logdet, result=res)


@register_solver("pcg")
class PCGSolver:
    """Pivoted-Cholesky preconditioned CG through the operator's factors.

    Preconditions with the Woodbury-inverted rank-r pivoted Cholesky of the
    masked latent covariance, built and cached by the operator
    (``A.preconditioner(rank)``, on packed vectors). The solve stays on grid
    form, so the operator's ``accurate`` takes the true residuals as in CG;
    only the preconditioner flattens. The whole RHS stack shares one
    Woodbury apply per iteration. Operators without ``.preconditioner``
    (bare closures, the distributed operator) fall back to plain CG.
    """

    def solve(self, A: Callable, b: torch.Tensor, config: Any,
              x0: torch.Tensor | None = None) -> CGResult:
        if not _preconditionable(A):
            return get_solver("cg").solve(A, b, config, x0=x0)
        rank = getattr(config, "precond_rank", 0) or _DEFAULT_PCG_RANK
        return pcg_solve_grid(A, b, A.preconditioner(rank),
                              tol=config.cg_tol,
                              max_iters=config.cg_max_iters, x0=x0)

    def solve_stacked(self, A: Callable, rhs: torch.Tensor, config: Any, *,
                      probe_cols: int = 0, subspace_dim: Any = None,
                      x0: torch.Tensor | None = None) -> StackedSolveResult:
        # The preconditioned Krylov space is M^-1 A's, not A's, so the
        # CG-Lanczos log-det cannot be fused; callers run SLQ separately.
        res = self.solve(A, rhs, config, x0=x0)
        return StackedSolveResult(x=res.x, logdet=None, result=res)


@register_solver("sgd")
class SGDSolver:
    """Heavy-ball SGD solves with Polyak tail averaging (large-n regime)."""

    def solve(self, A: Callable, b: torch.Tensor, config: Any,
              x0: torch.Tensor | None = None) -> CGResult:
        return sgd_solve(
            A, b, tol=config.cg_tol,
            max_iters=getattr(config, "sgd_iters", 500), x0=x0,
            momentum=getattr(config, "sgd_momentum", 0.9),
            lr=getattr(config, "sgd_lr", 0.0))

    def solve_stacked(self, A: Callable, rhs: torch.Tensor, config: Any, *,
                      probe_cols: int = 0, subspace_dim: Any = None,
                      x0: torch.Tensor | None = None) -> StackedSolveResult:
        # SGD iterates have no Lanczos correspondence: no fused log-det.
        res = self.solve(A, rhs, config, x0=x0)
        return StackedSolveResult(x=res.x, logdet=None, result=res)
