"""Solver protocol + registry: pluggable linear solvers for the engines.

Counterpart of ``repro.core.solvers.base``. Engines realise the projected
latent-Kronecker operator; *solvers* decide how ``A x = b`` is driven against
it. ``LKGPConfig.solver`` selects by name; ``"auto"`` means preconditioned CG
iff ``precond_rank > 0``, plain CG otherwise. Only ``cg`` is ported: asking
for ``pcg`` / ``sgd`` (by name or through ``precond_rank``) raises
``NotImplementedError`` rather than quietly running something else.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Protocol, runtime_checkable

import torch

from ..slq import slq_logdet_from_tridiag, tridiag_from_cg
from .cg import CGResult, cg_solve, cg_solve_tridiag

__all__ = [
    "Solver", "SOLVERS", "register_solver", "get_solver", "list_solvers",
    "resolve_solver", "StackedSolveResult", "CGSolver",
]

# Solvers of the reference that have no port yet, with the ROADMAP item that
# holds them.
_NOT_PORTED = {
    "pcg": "ROADMAP queue 1 items 3 and 4 (pcg.py, precond.py)",
    "sgd": "ROADMAP queue 1 item 3 (sgd.py)",
}


class StackedSolveResult(NamedTuple):
    """One consolidated multi-RHS solve: solutions + (optional) log-det.

    ``x`` are the stacked solutions; ``logdet`` is the SLQ estimate from the
    probe columns (None when the solve carried none); ``result`` carries the
    block solver's per-column diagnostics.
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
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"solver {name!r} is not ported yet: {_NOT_PORTED[name]}"
            ) from None
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
