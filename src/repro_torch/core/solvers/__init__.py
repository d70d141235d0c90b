"""Pluggable linear-solver stack for the latent-Kronecker engines.

Counterpart of ``repro.core.solvers``: the solver functions
(:func:`cg_solve`, :func:`cg_solve_tridiag`, :func:`pcg_solve`,
:func:`sgd_solve`), their diagnostics types (:class:`CGResult`,
:class:`CGTridiag`, :class:`StackedSolveResult`), the strategy registry
(:class:`Solver`, :func:`get_solver` / :func:`resolve_solver` /
:func:`register_solver` / :func:`list_solvers`) and the guarded escalation
ladder. ``repro_torch.core.cg`` is a deprecation shim re-exporting the
functions.
"""
from .base import (SOLVERS, CGSolver, PCGSolver, SGDSolver, Solver,
                   StackedSolveResult, get_solver, list_solvers,
                   register_solver, resolve_solver)
from .cg import CGResult, CGTridiag, cg_solve, cg_solve_tridiag
from .guarded import (SOLVE_POLICIES, EscalationStep, GuardedSolveError,
                      GuardedSolver, escalation_tally, guarded_solve,
                      guarded_solve_stacked, reset_escalation_tally)
from .pcg import pcg_solve
from .sgd import estimate_lmax, sgd_solve

__all__ = [
    "CGResult", "CGTridiag", "cg_solve", "cg_solve_tridiag", "pcg_solve",
    "sgd_solve", "estimate_lmax",
    "Solver", "SOLVERS", "register_solver", "get_solver", "list_solvers",
    "resolve_solver", "StackedSolveResult",
    "CGSolver", "PCGSolver", "SGDSolver",
    "GuardedSolver", "GuardedSolveError", "EscalationStep", "SOLVE_POLICIES",
    "guarded_solve", "guarded_solve_stacked", "escalation_tally",
    "reset_escalation_tally",
]
