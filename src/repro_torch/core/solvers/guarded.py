"""Guarded solves: a deterministic escalation ladder over the solver stack.

Counterpart of ``repro.core.solvers.guarded``. The block solvers *report*
degradation (per-column ``breakdown`` flags, TRUE final residuals) but never
act on it. This module reads those diagnostics and escalates
deterministically when a solve degrades:

1. **retry with jitter** - re-solve against ``A + eps*I``, ``eps`` starting
   at ``10 * config.jitter`` and growing x10 per retry up to
   ``config.guard_jitter_max`` (at most ``config.guard_retries`` retries);
2. **switch solver** - walk the registry ladder ``sgd -> cg -> pcg`` (the
   solvers after the failing one; custom solvers escalate to ``cg`` then
   ``pcg``), each on the ORIGINAL operator;
3. **dense Cholesky fallback** - when the operator exposes its Kronecker
   factors (``K1`` / ``K2`` / ``mask`` / ``noise``) and the grid is small
   (``mask.numel() <= config.guard_dense_max``), assemble the masked dense
   matrix and solve exactly.

``LKGPConfig.solve_policy`` selects what happens around the ladder:
``"strict"`` raises :class:`GuardedSolveError` on a degraded solve without
escalating; ``"escalate"`` walks the ladder and returns the first healthy
result, raising if it is exhausted; ``"best_effort"`` walks it and never
raises, returning the attempt with the smallest worst-column residual.

A solve is *degraded* iff a column flags ``breakdown`` or a final residual
is non-finite; a residual above ``tol`` (a max-iters stop) is not. Its
health costs ONE device-to-host read (breakdown, finiteness and the worst
residual fused into one transfer). Every guarded result carries its
escalation ``trace`` (a tuple of :class:`EscalationStep`) on
``CGResult.trace``, which reaches ``Posterior.solve_info``; ladder activity
is counted per stage (:func:`escalation_tally`).

**Pass-through.** The reference's guard passes a traced solve through
untouched: its fit objective is jitted, so the objective's solves are never
guarded. The port's objective is eager and says so explicitly: the MLL's
forward runs its solve inside :func:`pass_through`, where the guard returns
the base solver's result as it is (``trace=None``). The objective keeps its
own strict check (``engines.DegradedSolveError``, a
:class:`GuardedSolveError`), so ``fit``, ``refit``, the polish and
``fit_batch`` evaluate what they did before the ladder existed. Guards act
on the eager paths: posterior solves and direct ``engine.solve*`` calls.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, NamedTuple

import torch

from ..mvm import masked_dense
from .base import Solver, StackedSolveResult, get_solver, resolve_solver
from .cg import CGResult

__all__ = [
    "EscalationStep", "GuardedSolveError", "GuardedSolver", "SOLVE_POLICIES",
    "guarded_solve", "guarded_solve_stacked", "escalation_tally",
    "reset_escalation_tally",
]

SOLVE_POLICIES = ("strict", "escalate", "best_effort")

# Escalation order: SGD solves are the flakiest, plain CG is the workhorse,
# preconditioned CG the most robust iterative option.
_LADDER = ("sgd", "cg", "pcg")
_FACTOR_ATTRS = ("K1", "K2", "mask", "noise")


class EscalationStep(NamedTuple):
    """One rung of the escalation ladder, as executed."""
    stage: str            # "attempt" | "retry_jitter" | "switch_solver"
    #                     # | "dense_fallback"
    solver: str           # solver name the attempt ran with
    jitter: float         # extra diagonal jitter applied (0.0 = none)
    ok: bool              # attempt came back healthy
    worst_residual: float  # max per-column relative residual (nan -> inf)


class GuardedSolveError(RuntimeError):
    """Every rung of the escalation ladder degraded (or policy="strict"
    forbade escalation). Carries the executed ``trace``."""

    def __init__(self, message: str, trace: tuple = ()) -> None:
        super().__init__(message)
        self.trace = trace


# -- ladder activity counters (process-wide, as engines.solve_tally) -------
_TALLY_LOCK = threading.Lock()
_TALLY: dict[str, int] = {
    "retry_jitter": 0, "switch_solver": 0, "dense_fallback": 0,
    "degraded_returns": 0, "strict_failures": 0,
}


def escalation_tally() -> dict[str, int]:
    """Counts of escalation-ladder activity in this process, by stage."""
    with _TALLY_LOCK:
        return dict(_TALLY)


def reset_escalation_tally() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


def _bump(stage: str) -> None:
    with _TALLY_LOCK:
        _TALLY[stage] = _TALLY.get(stage, 0) + 1


# -- pass-through (the reference's "traced" rule) --------------------------
_LOCAL = threading.local()


@contextlib.contextmanager
def pass_through():
    """Solves in this block (on this thread) are not guarded: the base
    solver's result is returned as it is, with ``trace=None``."""
    before = getattr(_LOCAL, "on", False)
    _LOCAL.on = True
    try:
        yield
    finally:
        _LOCAL.on = before


def _passing_through() -> bool:
    return getattr(_LOCAL, "on", False)


# -- health ----------------------------------------------------------------
def health(res: CGResult) -> tuple[bool, float]:
    """``(degraded, worst residual)`` of a solve in one device-to-host read.

    Degraded: a breakdown flag, or a non-finite final residual (the solvers
    report the TRUE ``||b - Ax|| / ||b||``, so a non-finite solution shows
    here). The worst residual maps nan to inf.
    """
    rel = res.rel_residual
    bad = ~torch.isfinite(rel).all()
    if res.breakdown is not None:
        bad = bad | res.breakdown.any()
    inf = float("inf")
    worst = (torch.nan_to_num(rel, nan=inf, posinf=inf, neginf=inf).max()
             if rel.numel() else torch.zeros((), dtype=rel.dtype,
                                             device=rel.device))
    bad_h, worst_h = torch.stack([bad.to(rel.dtype),
                                  worst.to(rel.dtype)]).tolist()
    return bool(bad_h), float(worst_h)


class _JitteredOperator:
    """``u -> A(u) + eps * u``: the base operator with extra diagonal jitter.

    Attribute access (``mask``, ``preconditioner``, the factors) delegates
    to the base operator, so solver routing is unchanged (the base
    preconditioner remains a valid one for the jittered system). The base's
    ``accurate`` is jittered too: CG takes its true residuals from it, and
    they must be residuals of the matrix it iterates on.
    """

    def __init__(self, base: Callable, eps: float) -> None:
        self._base = base
        self.eps = eps
        accurate = getattr(base, "accurate", None)
        self.accurate = (None if accurate is None
                         else _JitteredOperator(accurate, eps))

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self._base(u) + self.eps * u

    def __getattr__(self, name: str) -> Any:
        return getattr(self._base, name)


def _jitter_ladder(config: Any) -> list[float]:
    eps = 10.0 * max(float(getattr(config, "jitter", 1e-6)), 1e-12)
    cap = float(getattr(config, "guard_jitter_max", 1e-2))
    retries = int(getattr(config, "guard_retries", 3))
    out: list[float] = []
    while eps <= cap * (1.0 + 1e-9) and len(out) < retries:
        out.append(eps)
        eps *= 10.0
    return out


def _switch_candidates(base_name: str) -> list[str]:
    if base_name in _LADDER:
        return list(_LADDER[_LADDER.index(base_name) + 1:])
    return ["cg", "pcg"]


def _dense_eligible(A: Any, config: Any) -> bool:
    if not all(hasattr(A, a) for a in _FACTOR_ATTRS):
        return False
    return A.mask.numel() <= int(getattr(config, "guard_dense_max", 4096))


@torch.no_grad()
def _dense_solve(A: Any, b: torch.Tensor, config: Any) -> CGResult:
    """Exact masked-grid Cholesky solve from the operator's factors.

    Residuals are measured against the assembled dense matrix (the model's
    intended SPD system): the fallback exists for operators whose
    *realisation* broke (a bad MVM, an indefinite wrapper), so measuring
    against the broken realisation would mark a correct solve degraded. A
    factor that fails even with ``guard_jitter_max`` on the diagonal is NaN,
    as the reference's, so the attempt reports itself degraded.
    """
    K = masked_dense(A.K1, A.K2, A.mask, A.noise)
    mv = A.mask.reshape(-1)
    L, info = torch.linalg.cholesky_ex(K)
    if bool(((info != 0) | ~torch.isfinite(L).all()).item()):
        cap = float(getattr(config, "guard_jitter_max", 1e-2))
        L, info = torch.linalg.cholesky_ex(
            K + cap * torch.eye(K.shape[0], dtype=K.dtype, device=K.device))
        L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    N = mv.shape[0]
    sys_shape = b.shape[:-2]
    bb = (b * A.mask).reshape(-1, N)
    x = torch.cholesky_solve(bb.T, L).T * mv
    r = bb - x @ K.T
    norm = torch.sqrt((bb * bb).sum(-1))
    rel = (torch.sqrt((r * r).sum(-1))
           / torch.where(norm == 0, torch.ones_like(norm), norm))
    dev = b.device
    return CGResult(
        x=x.reshape(b.shape), iters=torch.zeros((), dtype=torch.int32,
                                                device=dev),
        rel_residual=rel.reshape(sys_shape),
        breakdown=torch.zeros(sys_shape, dtype=torch.bool, device=dev),
        col_iters=torch.zeros(sys_shape, dtype=torch.int32, device=dev),
        matvecs=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def _dense_logdet(A: Any) -> torch.Tensor:
    """Exact observed-subspace log-determinant (unobserved diagonal 1 ->
    log 0); NaN where the Cholesky fails."""
    L, info = torch.linalg.cholesky_ex(
        masked_dense(A.K1, A.K2, A.mask, A.noise))
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return torch.where(info == 0, logdet, torch.full_like(logdet, math.nan))


# -- the ladder ------------------------------------------------------------
def _policy(config: Any) -> str:
    policy = getattr(config, "solve_policy", "escalate") or "escalate"
    if policy not in SOLVE_POLICIES:
        raise ValueError(f"unknown solve_policy {policy!r}; "
                         f"expected one of {SOLVE_POLICIES}")
    return policy


def _run_ladder(attempt: Callable[[Solver, Callable], CGResult],
                dense_attempt: Callable[[], CGResult] | None,
                A: Callable, base: Solver, config: Any, what: str,
                first: CGResult, first_health: tuple[bool, float]
                ) -> tuple[CGResult, tuple]:
    """The ladder shared by both guarded solves; returns (result, trace) or
    raises.

    ``first`` is the base attempt the caller already ran (and
    ``first_health`` its health): the ladder's first rung, not run twice.
    """
    policy = _policy(config)
    trace: list[EscalationStep] = []
    best: CGResult | None = None
    best_score = math.inf

    def record(stage: str, solver: str, eps: float, res: CGResult,
               res_health: tuple[bool, float]) -> bool:
        nonlocal best, best_score
        bad, score = res_health
        trace.append(EscalationStep(stage=stage, solver=solver, jitter=eps,
                                    ok=not bad, worst_residual=score))
        if best is None or score < best_score:
            best, best_score = res, score
        return not bad

    if record("attempt", base.name, 0.0, first, first_health):
        return first, tuple(trace)
    if policy == "strict":
        _bump("strict_failures")
        raise GuardedSolveError(
            f"{what}: solver {base.name!r} degraded "
            f"(worst residual {trace[0].worst_residual:.3g}) and "
            "solve_policy='strict' forbids escalation", tuple(trace))

    for eps in _jitter_ladder(config):
        _bump("retry_jitter")
        res = attempt(base, _JitteredOperator(A, eps))
        if record("retry_jitter", base.name, eps, res, health(res)):
            return res, tuple(trace)
    for name in _switch_candidates(base.name):
        _bump("switch_solver")
        res = attempt(get_solver(name), A)
        if record("switch_solver", name, 0.0, res, health(res)):
            return res, tuple(trace)
    if dense_attempt is not None and _dense_eligible(A, config):
        _bump("dense_fallback")
        res = dense_attempt()
        if record("dense_fallback", "dense", 0.0, res, health(res)):
            return res, tuple(trace)

    if policy == "best_effort":
        _bump("degraded_returns")
        return best, tuple(trace)
    raise GuardedSolveError(
        f"{what}: escalation ladder exhausted after {len(trace)} attempts "
        f"(best worst-column residual {best_score:.3g}); trace: "
        + " -> ".join(f"{s.stage}[{s.solver}]" for s in trace), tuple(trace))


def guarded_solve(A: Callable, b: torch.Tensor, config: Any,
                  x0: torch.Tensor | None = None,
                  solver: Solver | None = None) -> CGResult:
    """Solve ``A x = b`` under the configured escalation policy.

    Drop-in for ``resolve_solver(config, A).solve(...)`` with the health
    check and the ladder on top; the result carries the executed
    :class:`EscalationStep` tuple as ``trace``. Inside :func:`pass_through`
    the base result is returned unchanged (``trace=None``).
    """
    base = solver if solver is not None else resolve_solver(config, A)
    res = base.solve(A, b, config, x0=x0)
    if _passing_through():
        return res
    first_health = health(res)
    if _policy(config) != "strict" and not first_health[0]:
        # Fast path: a healthy first attempt, with a one-step trace.
        return res._replace(trace=(EscalationStep(
            "attempt", base.name, 0.0, True, first_health[1]),))

    def attempt(slv: Solver, op: Callable) -> CGResult:
        return slv.solve(op, b, config, x0=x0)

    final, trace = _run_ladder(
        attempt, lambda: _dense_solve(A, b, config), A, base, config,
        what="guarded_solve", first=res, first_health=first_health)
    return final._replace(trace=trace)


def guarded_solve_stacked(A: Callable, rhs: torch.Tensor, config: Any, *,
                          probe_cols: int = 0, subspace_dim: Any = None,
                          x0: torch.Tensor | None = None,
                          solver: Solver | None = None) -> StackedSolveResult:
    """Stacked multi-RHS solve under the escalation policy.

    Escalated attempts keep per-column diagnostics. A solver switch reports
    ``logdet=None`` exactly as if that solver were selected directly; the
    dense fallback reports the exact observed-subspace log-determinant.
    """
    base = solver if solver is not None else resolve_solver(config, A)
    st = base.solve_stacked(A, rhs, config, probe_cols=probe_cols,
                            subspace_dim=subspace_dim, x0=x0)
    if _passing_through():
        return st
    first_health = health(st.result)
    if _policy(config) != "strict" and not first_health[0]:
        res = st.result._replace(trace=(EscalationStep(
            "attempt", base.name, 0.0, True, first_health[1]),))
        return st._replace(result=res)

    results: dict[int, StackedSolveResult] = {id(st.result): st}

    def attempt(slv: Solver, op: Callable) -> CGResult:
        out = slv.solve_stacked(op, rhs, config, probe_cols=probe_cols,
                                subspace_dim=subspace_dim, x0=x0)
        results[id(out.result)] = out
        return out.result

    def dense_attempt() -> CGResult:
        res = _dense_solve(A, rhs, config)
        logdet = _dense_logdet(A) if probe_cols else None
        results[id(res)] = StackedSolveResult(x=res.x, logdet=logdet,
                                              result=res)
        return res

    final, trace = _run_ladder(attempt, dense_attempt, A, base, config,
                               what="guarded_solve_stacked", first=st.result,
                               first_health=first_health)
    return results[id(final)]._replace(result=final._replace(trace=trace))


class GuardedSolver:
    """Solver-protocol wrapper running a base solver under the ladder (the
    engines call the module-level functions directly)."""

    def __init__(self, base: Solver) -> None:
        self._base = base
        self.name = f"guarded[{base.name}]"

    def solve(self, A: Callable, b: torch.Tensor, config: Any,
              x0: torch.Tensor | None = None) -> CGResult:
        return guarded_solve(A, b, config, x0=x0, solver=self._base)

    def solve_stacked(self, A: Callable, rhs: torch.Tensor, config: Any, *,
                      probe_cols: int = 0, subspace_dim: Any = None,
                      x0: torch.Tensor | None = None) -> StackedSolveResult:
        return guarded_solve_stacked(
            A, rhs, config, probe_cols=probe_cols,
            subspace_dim=subspace_dim, x0=x0, solver=self._base)
