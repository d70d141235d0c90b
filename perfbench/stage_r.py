"""The work of K2a, the MVM's stage R ``T = (mask * U) @ K2``, for its
roofline share ``k2a_roofline``.

The counts are what the stage needs, whatever its kernel moves: for each
active column (``matvecs``, an active-column MVM) an (n, m) by (m, m)
product, U read once and T written once as its two TF32 halves; K2 and the
mask read once a sweep. The bound takes them at the card's published peaks
(``perfbench/peaks.py``): the larger of the operations at TF32's rate and
the bytes at HBM's.
"""
from __future__ import annotations

from .peaks import least_seconds

__all__ = ["KERNEL", "stage_r_flops", "stage_r_bytes", "stage_r_seconds"]

# Substring of K2a's device kernel name.
KERNEL = "stage_right_kernel"


def stage_r_flops(n: int, m: int, columns: int) -> float:
    """Operations of ``columns`` products ``(mask * U) @ K2`` at (n, m)."""
    return 2.0 * columns * n * m * m


def stage_r_bytes(n: int, m: int, sweeps: int, columns: int) -> float:
    """Bytes of ``sweeps`` stage-R passes over ``columns`` columns in all:
    K2 and the mask once a sweep (float32), each column's U read once and
    its T written once in two float32 planes."""
    return 4.0 * sweeps * (n * m + m * m) + 12.0 * columns * n * m


def stage_r_seconds(n: int, m: int, sweeps: int, columns: int) -> float:
    """The least time the card could take for that work."""
    return least_seconds(stage_r_flops(n, m, columns),
                         stage_r_bytes(n, m, sweeps, columns))
