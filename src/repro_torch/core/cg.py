"""Deprecated location of the solver functions (moved to core.solvers).

Counterpart of ``repro.core.cg``: re-exports the old public names so that
imports of this module keep working. Import from
``repro_torch.core.solvers`` (or ``repro_torch.core``) instead.
"""
from __future__ import annotations

import warnings

from .solvers.cg import CGResult, CGTridiag, cg_solve, cg_solve_tridiag
from .solvers.pcg import pcg_solve

__all__ = ["cg_solve", "cg_solve_tridiag", "pcg_solve", "CGResult",
           "CGTridiag"]

warnings.warn(
    "repro_torch.core.cg is deprecated; import from repro_torch.core.solvers "
    "(cg_solve/cg_solve_tridiag/pcg_solve and the Solver registry) instead.",
    DeprecationWarning, stacklevel=2)
