"""Typed errors for bad observation payloads.

Counterpart of ``repro.core.errors`` (a copy: the port imports nothing of the
reference). :func:`~repro_torch.core.state.fit` validates its payload eagerly
on the host and rejects a bad one with :class:`ObservationError`, a
``ValueError`` subclass, carrying the offending indices. Both checks take
anything ``numpy.asarray`` accepts; the caller brings tensors to the host.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ObservationError", "check_observed_finite", "check_grid_columns"]

_MAX_NAMED = 8   # cap on indices spelled out in an error message


class ObservationError(ValueError):
    """An observation payload is invalid.

    ``indices`` names the offending cells/columns (possibly truncated in
    the message, never in the attribute).
    """

    def __init__(self, message: str, indices=()):
        super().__init__(message)
        self.indices = tuple(map(tuple, indices)) if np.ndim(indices) > 1 \
            else tuple(indices)


def _named(indices) -> str:
    shown = list(indices[:_MAX_NAMED])
    more = len(indices) - len(shown)
    return f"{shown}" + (f" (+{more} more)" if more > 0 else "")


def check_observed_finite(Y, mask, what: str = "Y") -> None:
    """Raise :class:`ObservationError` on non-finite values at observed cells.

    Unobserved cells may hold anything (they are masked out of every
    product); observed cells must be finite or the solves propagate NaNs.
    """
    Y = np.asarray(Y)
    mask = np.asarray(mask)
    bad = np.logical_and(mask > 0, ~np.isfinite(Y))
    if np.any(bad):
        cells = np.argwhere(bad)
        raise ObservationError(
            f"non-finite {what} at {int(cells.shape[0])} observed "
            f"cell(s): {_named([tuple(map(int, c)) for c in cells])}",
            indices=[tuple(map(int, c)) for c in cells])


def check_grid_columns(mask, m: int, what: str = "mask") -> None:
    """Reject masks marking cells outside the budget grid ``t``.

    A mask wider than ``m`` that marks any column ``>= m`` refers to
    progression values the grid does not contain; name the offending
    column indices instead of failing later with an opaque shape error.
    """
    mask = np.asarray(mask)
    m_got = mask.shape[-1]
    if m_got == m:
        return
    if m_got > m:
        extra = mask[..., m:]
        marked = np.argwhere(np.any(extra > 0, axis=tuple(
            range(extra.ndim - 1)))) + m
        cols = [int(c) for c in marked.reshape(-1)]
        if cols:
            raise ObservationError(
                f"{what} marks observed cells outside the budget grid "
                f"(m={m}): columns {_named(cols)}", indices=cols)
    raise ObservationError(
        f"{what} has {m_got} budget columns but the session grid has "
        f"m={m}", indices=[])
