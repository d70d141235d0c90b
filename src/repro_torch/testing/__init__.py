"""Test-support utilities shipped with the port (counterpart of
``repro.testing``): :mod:`repro_torch.testing.faults`, composable fault
injectors that drive the escalation ladder's tests and ``chip_smoke.py``."""
from .faults import (FaultSchedule, FlakySolver, NegatedOperator,
                     arm_flaky_solver, crash_and_restore, evict_session,
                     near_singular_problem, poison_nan)

__all__ = [
    "NegatedOperator", "FlakySolver", "arm_flaky_solver", "poison_nan",
    "near_singular_problem", "evict_session", "crash_and_restore",
    "FaultSchedule",
]
