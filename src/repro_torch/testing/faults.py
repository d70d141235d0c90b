"""Composable fault injectors for the reliability tests.

Counterpart of ``repro.testing.faults``. Each injector produces exactly ONE
kind of failure the reliability layer claims to survive, deterministically,
so a test can assert which detection point fired:

* :class:`NegatedOperator` - wraps an SPD operator as ``u -> -A(u)``: every
  CG / PCG iteration sees ``p^T A p < 0`` and flags ``breakdown``
  (detection: solver diagnostics -> the guarded-solve ladder).
* :class:`FlakySolver` (registry name ``"flaky"``) - an armed solver that
  returns an instant fake breakdown for the next N calls, then delegates to
  plain CG: escalation succeeds on the first rung at about the cost of one
  clean CG solve.
* :func:`poison_nan` - plants NaNs at newly observed cells of an ``extend``
  payload (detection: ``check_observed_finite`` at the streaming boundary).
* :func:`near_singular_problem` - duplicated rows and tiny noise make the
  Gram factors near-singular (detection: the ladder's jitter retries).
* :func:`evict_session` - drops a session from a
  :class:`~repro_torch.serving.PredictionService`'s store mid-workload.
* :func:`crash_and_restore` - abandons a service and rebuilds its warm
  sessions in a fresh one from its checkpoint directory.
* :class:`FaultSchedule` - maps workload rounds to injector thunks.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

import numpy as np
import torch

from .._device import resolve_device
from ..core.solvers import (CGResult, StackedSolveResult, get_solver,
                            register_solver)

__all__ = [
    "NegatedOperator", "FlakySolver", "arm_flaky_solver", "poison_nan",
    "near_singular_problem", "evict_session", "crash_and_restore",
    "FaultSchedule",
]


class NegatedOperator:
    """``u -> -A(u)``: a maximally indefinite wrapper around an SPD operator.

    Attribute access (mask, Kronecker factors, preconditioner) delegates to
    the base operator, so solver routing and the guarded dense fallback see
    the INTENDED model matrix: a broken operator realisation over healthy
    factors, the situation the fallback exists for. The base's ``accurate``
    is negated too, so CG's true residuals belong to the matrix it iterates.
    """

    def __init__(self, base: Callable) -> None:
        self._base = base
        accurate = getattr(base, "accurate", None)
        self.accurate = (None if accurate is None
                         else NegatedOperator(accurate))

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return -self._base(u)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._base, name)


def _fake_breakdown(b: torch.Tensor) -> CGResult:
    """Instant all-columns-broke result (no operator applications at all)."""
    sys_shape, dev = b.shape[:-2], b.device
    return CGResult(
        x=torch.zeros_like(b),
        iters=torch.zeros((), dtype=torch.int32, device=dev),
        rel_residual=torch.ones(sys_shape, dtype=b.dtype, device=dev),
        breakdown=torch.ones(sys_shape, dtype=torch.bool, device=dev),
        col_iters=torch.zeros(sys_shape, dtype=torch.int32, device=dev),
        matvecs=torch.zeros((), dtype=torch.int32, device=dev))


@register_solver("flaky")
class FlakySolver:
    """Armed fault: fake breakdown for the next N solves, then plain CG.

    The fake failure costs no operator sweep, so an escalated solve through
    it pays about one clean CG solve plus the ladder's bookkeeping.
    """

    def __init__(self) -> None:
        self._armed = 0
        self._lock = threading.Lock()

    def arm(self, n: int) -> None:
        with self._lock:
            self._armed = int(n)

    def _trip(self) -> bool:
        with self._lock:
            if self._armed > 0:
                self._armed -= 1
                return True
            return False

    def solve(self, A: Callable, b: torch.Tensor, config: Any,
              x0: torch.Tensor | None = None) -> CGResult:
        if self._trip():
            return _fake_breakdown(b)
        return get_solver("cg").solve(A, b, config, x0=x0)

    def solve_stacked(self, A: Callable, rhs: torch.Tensor, config: Any, *,
                      probe_cols: int = 0, subspace_dim: Any = None,
                      x0: torch.Tensor | None = None) -> StackedSolveResult:
        if self._trip():
            res = _fake_breakdown(rhs)
            return StackedSolveResult(x=res.x, logdet=None, result=res)
        return get_solver("cg").solve_stacked(
            A, rhs, config, probe_cols=probe_cols,
            subspace_dim=subspace_dim, x0=x0)


def arm_flaky_solver(n: int) -> FlakySolver:
    """Arm the registered ``"flaky"`` solver singleton for the next N solves."""
    solver = get_solver("flaky")
    solver.arm(n)
    return solver


def poison_nan(Y, mask, cells: int = 1):
    """Extend-payload poisoner: mark ``cells`` new cells observed, value NaN.

    Grows each poisoned row's mask by one cell (still a superset of the
    input mask, so only the finiteness guard can be the detector) and puts
    ``nan`` there. Returns (Y_poisoned, mask_poisoned) as numpy arrays.
    """
    Y = np.array(Y, copy=True)
    mask = np.array(mask, copy=True)
    planted = 0
    seen_per_row = mask.sum(axis=1).astype(np.int64)
    for row in range(mask.shape[0]):
        if planted >= cells:
            break
        seen = seen_per_row[row]
        if seen < mask.shape[1]:
            mask[row, seen] = 1.0
            Y[row, seen] = np.nan
            planted += 1
    if planted == 0:
        raise ValueError("mask is already full; nowhere to plant a NaN")
    return Y, mask


def near_singular_problem(n: int = 8, m: int = 6, d: int = 3,
                          noise: float = 1e-10, seed: int = 0, device=None):
    """An ill-conditioned LKGP system: duplicated configs and ~zero noise.

    Every config row is (near-)duplicated, so ``K1`` has (near-)repeated
    columns and the masked system's condition number blows up; the tiny
    noise removes the diagonal regularisation that normally hides it.
    Returns ``(K1, K2, mask, Y, noise)`` (float64, on ``device``; ``None``
    is the GPU), drawn from a ``torch.Generator`` seeded with ``seed``: other
    draws than the reference's from the same seed.
    """
    from ..core.state import gram_matrices, init_params

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f64 = torch.float64
    half = torch.rand(((n + 1) // 2, d), generator=gen, dtype=f64, device=dev)
    X = torch.cat([half, half + 1e-9], dim=0)[:n]
    t = torch.linspace(0.05, 1.0, m, dtype=f64, device=dev)
    K1, K2 = gram_matrices(init_params(d, f64, dev), X, t, jitter=0.0)
    mask = torch.ones((n, m), dtype=f64, device=dev)
    Y = torch.randn((n, m), generator=gen, dtype=f64, device=dev)
    return K1, K2, mask, Y, torch.tensor(noise, dtype=f64, device=dev)


def evict_session(service, tenant: str, task: str) -> bool:
    """Mid-workload eviction: drop a session from the store (LRU-style)."""
    from ..serving.store import SessionKey

    return service.store.drop(SessionKey(tenant, task))


def crash_and_restore(service, step: int | None = None):
    """Simulated crash: fresh service over the same checkpoint directory,
    on the same device.

    The old service object is abandoned exactly as a killed process would
    abandon its memory; the replacement rebuilds warm sessions via
    ``restore()``. Returns ``(new_service, sessions_restored)``.
    """
    from ..serving.service import PredictionService

    if service.checkpointer is None:
        raise RuntimeError("service has no checkpoint_dir; nothing to "
                           "restore a crash from")
    replacement = PredictionService(service.config, device=service.device)
    restored = replacement.restore(step)
    return replacement, restored


class FaultSchedule:
    """Declarative round -> injectors mapping for chaos scenarios.

    ``add(round, fn)`` registers an injector thunk; ``fire(round, **ctx)``
    runs every injector registered for that round (in registration order)
    and returns their results. Injectors receive the context kwargs
    ``fire`` is given (e.g. ``service=...``).
    """

    def __init__(self) -> None:
        self._by_round: dict[int, list[Callable]] = {}

    def add(self, round_idx: int, injector: Callable) -> "FaultSchedule":
        self._by_round.setdefault(int(round_idx), []).append(injector)
        return self

    def rounds(self) -> list[int]:
        return sorted(self._by_round)

    def fire(self, round_idx: int, **ctx: Any) -> list:
        return [fn(**ctx) for fn in self._by_round.get(int(round_idx), [])]
