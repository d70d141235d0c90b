"""Linear-solver stack for the latent-Kronecker engines (CG so far)."""
from .base import (SOLVERS, CGSolver, Solver, StackedSolveResult, get_solver,
                   list_solvers, register_solver, resolve_solver)
from .cg import CGResult, CGTridiag, cg_solve, cg_solve_tridiag

__all__ = [
    "CGResult", "CGTridiag", "cg_solve", "cg_solve_tridiag",
    "Solver", "SOLVERS", "register_solver", "get_solver", "list_solvers",
    "resolve_solver", "StackedSolveResult", "CGSolver",
]
