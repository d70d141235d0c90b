"""Batched multi-RHS block conjugate gradients on grid-form vectors.

Counterpart of ``repro.core.solvers.cg`` with the same update rules. Matches
the paper's App. B settings: relative residual-norm tolerance 0.01, max
10 000 iterations. The operator is a callable u -> A(u) acting on (..., n, m)
grid vectors; multiple right-hand sides batch over leading dims and every
iteration applies the operator to the WHOLE stack in one batched sweep. On
top of the classic batched loop the solver has:

* **per-column convergence freezing** - a system that has reached ``tol``
  stops updating (``alpha = 0``, its direction is held fixed).
  ``CGResult.matvecs`` accumulates only the *active* columns per sweep, and
  ``CGResult.col_iters`` records the per-system iteration of convergence.
* **breakdown detection** - ``p^T A p <= 0`` for a still-active column
  raises the per-system ``CGResult.breakdown`` flag and freezes the column,
  so the remaining healthy columns still converge.
* **warm starts** - :func:`cg_solve` accepts ``x0``.
* **residual replacement** (not in the reference) - for operators that
  round more coarsely than the recursion: the ``cuda`` engine's MVM is
  float32 under a float64 state, and at n in the thousands its summation
  error alone is a sizeable share of ``tol * ||b||``, so the recursively
  updated residual drifts from the true one and a "true" residual taken
  through the same MVM cannot be trusted either. Such an operator carries
  ``A.accurate``, a slower realisation of the same matrix in the state's
  dtype. The solver then takes ``b - A x`` from it: at the start, every
  ``REPLACE_EVERY`` iterations (the recursion's ``r`` is replaced, its
  direction kept, so the drift never grows past a few dozen sweeps' worth;
  the next step is the line minimum ``<r, p> / <p, Ap>``), and at the end,
  where columns still above ``tol`` get their ``r`` replaced and iterate
  on. ``CGResult.replacements`` counts these. This is
  mixed-precision iterative refinement: all the O(iterations) sweeps stay
  in the fast operator. An operator without ``accurate`` runs the
  reference's loop unchanged.
* **CG-Lanczos tridiagonals** - :func:`cg_solve_tridiag` additionally
  returns the CG step coefficients from which the Lanczos tridiagonal of
  each system's Krylov space is rebuilt (the SLQ log-determinant of the fit
  path reads them).

The reference runs the loop as one compiled ``while_loop``; here it is a
host loop over eager tensor ops, with exactly one device-to-host read per
iteration (the loop condition). With :mod:`repro_torch.tracing` on, a loop is
one ``lkgp.cg`` span and adds, at its end, the host time blocked in those
reads and its swept and active columns to the tracing's counters.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, NamedTuple

import torch

from ... import tracing

__all__ = ["cg_solve", "cg_solve_tridiag", "CGResult", "CGTridiag"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor          # scalar int32: total operator sweeps
    rel_residual: torch.Tensor   # (...,) per-system final relative residual
    breakdown: torch.Tensor | None = None   # (...,) bool: pAp <= 0 observed
    col_iters: torch.Tensor | None = None   # (...,) int32 per-system iters
    matvecs: torch.Tensor | None = None     # scalar int32: active-column MVMs
    # Times the recursion's residual was replaced by ``b - A.accurate(x)``;
    # always 0 for an operator without ``accurate``.
    replacements: int = 0
    # Escalation trace of a guarded solve (``solvers/guarded.py``); None
    # for a solve that was not guarded.
    trace: Any = None


class CGTridiag(NamedTuple):
    """CG-Lanczos tridiagonal coefficients per system (see cg_solve_tridiag).

    ``alphas``/``betas`` are the raw CG step/update coefficients of the
    first ``max_rank`` iterations; ``steps`` is how many were recorded per
    system (recording stops when a column converges or breaks down).
    """
    alphas: torch.Tensor   # (..., max_rank)
    betas: torch.Tensor    # (..., max_rank)
    steps: torch.Tensor    # (...,) int32


# Sweeps of the fast operator between two residual replacements. One accurate
# sweep per 50 fast ones costs a few percent; the drift of 50 float32 sweeps
# is far below any tolerance the engine is asked for.
REPLACE_EVERY = 50


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-system inner product over the trailing (n, m) grid axes."""
    return (a * b).sum(dim=(-2, -1))


@torch.no_grad()
def _cg_loop(A: Callable, b: torch.Tensor, tol: float, max_iters: int,
             x0: torch.Tensor | None, record: int,
             M_inv: Callable | None = None):
    """Shared block-CG loop; ``record > 0`` also carries tridiag arrays.

    ``M_inv`` (an approximate inverse of A on the whole stack) makes it
    preconditioned CG (:mod:`.pcg`): the step and update coefficients come
    from ``<r, M^-1 r>``, the stopping rule still reads the unpreconditioned
    ``||r||``. Without it every ``z`` is ``r`` itself, so plain CG computes
    exactly what it did before PCG shared the loop.
    """
    with tracing.span("lkgp.cg") as sp:
        dev = b.device
        if x0 is None:
            x0 = torch.zeros_like(b)
        b_norm = torch.sqrt(_dot(b, b))
        # Guard all-zero RHS (can occur for fully-unobserved batches).
        safe_b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm),
                                  b_norm)
        sys_shape = b.shape[:-2]
        traced = sp is not None
        wait_ns = 0   # with tracing on: host ns blocked in the reads below

        # Where the operator has a more accurate realisation, every residual
        # b - A x comes from it; the iterations' A(p) never do. A replaced r
        # bends the CG-Lanczos recurrence, so with ``record > 0`` no replacement
        # may fall inside the recorded window (the first ``record`` steps): the
        # periodic ones and the one at the loop's end both wait for
        # ``n_it >= record``. With ``record <= REPLACE_EVERY`` (the MLL's
        # ``slq_iters``, default 25) that leaves the periodic replacements as
        # they are; only a solve that ends inside the window keeps its residual.
        # The start ``b - A(x0)`` is the recurrence's starting vector, not a
        # replacement (with x0 = 0 it is b whichever operator takes it).
        A_acc = getattr(A, "accurate", None)
        A_res = A_acc if A_acc is not None else A

        def precond(r, rs, rz, where):
            """``(z, <r, z>)`` for a new ``r``: ``z = M^-1 r``, and ``<r, z>``
            where ``where`` (``rz`` elsewhere); ``(r, rs)`` without ``M_inv``."""
            if M_inv is None:
                return r, rs
            z = M_inv(r)
            return z, torch.where(where, _dot(r, z), rz)

        x = x0
        r = b - A_res(x0)
        rs = _dot(r, r)
        z, rz = r, rs
        if M_inv is not None:
            z = M_inv(r)
            rz = _dot(r, z)
        p = z
        # The step's numerator <r, p> (<r, z> in PCG). CG's rs = <r, r> equals
        # it until a residual is replaced; after a replacement the direction p
        # is kept, and rs would overshoot along it wherever the replaced
        # residual is far above the recursion's (below the fast operator's
        # floor the solve diverged). <r_true, p> / <p, Ap> is the exact line
        # minimum along p instead.
        rp = rz
        it = torch.zeros((), dtype=torch.int32, device=dev)
        breakdown = torch.zeros(sys_shape, dtype=torch.bool, device=dev)
        col_iters = torch.zeros(sys_shape, dtype=torch.int32, device=dev)
        matvecs = torch.zeros((), dtype=torch.int32, device=dev)
        if record:
            ta = torch.zeros((*sys_shape, record), dtype=b.dtype, device=dev)
            tb = torch.zeros((*sys_shape, record), dtype=b.dtype, device=dev)
            tsteps = torch.zeros(sys_shape, dtype=torch.int32, device=dev)
        one = torch.ones((), dtype=b.dtype, device=dev)
        zero = torch.zeros((), dtype=b.dtype, device=dev)

        n_it = 0   # host mirror of ``it``: the tridiag record's slot index
        replacements = 0
        worst_before = float("inf")
        while True:
            rel = torch.sqrt(rs) / safe_b_norm
            active = (rel > tol) & ~breakdown
            # The ONE device-to-host read of the iteration: "any column active
            # and budget left" is fused into a single 0-d tensor and read once.
            flag = active.any() & (it < max_iters)
            if traced:
                t0 = time.perf_counter_ns()
            go = flag.item()  # lint: disable=RT103 (designed)
            if traced:
                wait_ns += time.perf_counter_ns() - t0
            if not go:
                # The recursion says done (or the budget is spent). What is
                # reported is the TRUE residual ||b - Ax|| / ||b||, not the
                # recursively updated one: on ill-conditioned systems the
                # recursion drifts (it can report convergence the solution
                # never reached).
                r_true = b - A_res(x)
                rs_true = _dot(r_true, r_true)
                rel_true = torch.sqrt(rs_true) / safe_b_norm
                if A_acc is None or n_it < record or n_it >= max_iters:
                    break
                # Columns whose true residual is still above tol take it as
                # their r and go on. One more host read, on this exit path
                # only.
                redo = (rel_true > tol) & ~breakdown
                worst_t = torch.where(redo, rel_true,
                                      torch.zeros_like(rel_true)).max()
                if traced:
                    t0 = time.perf_counter_ns()
                worst = float(worst_t)  # lint: disable=RT103 (exit path)
                if traced:
                    wait_ns += time.perf_counter_ns() - t0
                if worst == 0.0 or worst >= worst_before:
                    break   # all within tol, or no longer improving
                worst_before = worst
                replacements += 1
                r = torch.where(redo[..., None, None], r_true, r)
                rs = torch.where(redo, rs_true, rs)
                _, rz = precond(r, rs, rz, redo)
                rp = torch.where(redo, _dot(r_true, p), rp)
                continue
            Ap = A(p)
            pAp = _dot(p, Ap)
            # Indefinite / numerically broken column: freeze it and flag it
            # instead of silently reporting success on a stalled system.
            broke = active & (pAp <= 0)
            breakdown = breakdown | broke
            step = active & (pAp > 0)
            alpha = torch.where(step, rp / torch.where(pAp == 0, one, pAp),
                                zero)
            x = x + alpha[..., None, None] * p
            r = r - alpha[..., None, None] * Ap
            rs_new = torch.where(step, _dot(r, r), rs)
            z, rz_new = precond(r, rs_new, rz, step)
            beta = torch.where(step, rz_new / torch.where(rz == 0, one, rz),
                               zero)
            # Frozen columns keep their direction fixed (alpha = 0 above makes
            # them no-ops); stepping columns do the standard update.
            p = torch.where(step[..., None, None],
                            z + beta[..., None, None] * p, p)
            if record:
                # Record the CG (alpha, beta) pair of this iteration for the
                # first `record` steps of each still-stepping column.
                slot = min(n_it, record - 1)
                write = step & (it < record)
                ta[..., slot] = torch.where(write, alpha, ta[..., slot])
                tb[..., slot] = torch.where(write, beta, tb[..., slot])
                tsteps = torch.where(write, it + 1, tsteps)
            col_iters = torch.where(step, it + 1, col_iters)
            matvecs = matvecs + active.sum(dtype=torch.int32)
            rs, rz = rs_new, rz_new
            rp = torch.where(step, rz_new, rp)
            it = it + 1
            n_it += 1
            if (A_acc is not None and n_it % REPLACE_EVERY == 0
                    and n_it >= record):
                r_true = b - A_res(x)
                r = torch.where(step[..., None, None], r_true, r)
                rs = torch.where(step, _dot(r_true, r_true), rs)
                _, rz = precond(r, rs, rz, step)
                rp = torch.where(step, _dot(r_true, p), rp)
                replacements += 1

        res = CGResult(
            x=x, iters=it, rel_residual=rel_true,
            breakdown=breakdown, col_iters=col_iters, matvecs=matvecs,
            replacements=replacements)
        tri = None
        if record:
            tri = CGTridiag(alphas=ta, betas=tb, steps=tsteps)
        if traced:
            # One sweep of the whole stack an iteration; the active columns
            # are read once, here, and only with tracing on.
            B = math.prod(sys_shape)
            tracing.count("lkgp.cg.wait_ns", wait_ns)
            tracing.count("lkgp.cg.cols_swept", B * n_it)
            tracing.count("lkgp.cg.cols_active", int(matvecs))
            sp.set(B=B, n=b.shape[-2], m=b.shape[-1], iters=n_it,
                   replacements=replacements)
        return res, tri


def cg_solve(A: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
             tol: float = 0.01, max_iters: int = 10_000,
             x0: torch.Tensor | None = None) -> CGResult:
    """Solve A x = b for SPD A with batched block conjugate gradients.

    b: (..., n, m) grid-form right-hand sides (zeros at unobserved cells);
    all systems share each operator sweep. Returns grid-form solutions of
    the same shape, with per-system convergence/breakdown diagnostics.
    """
    res, _ = _cg_loop(A, b, tol, max_iters, x0, record=0)
    return res


def cg_solve_tridiag(A: Callable, b: torch.Tensor, max_rank: int,
                     tol: float = 0.01, max_iters: int = 10_000,
                     x0: torch.Tensor | None = None
                     ) -> tuple[CGResult, CGTridiag]:
    """Block CG that also returns per-system CG-Lanczos tridiagonals.

    The Lanczos tridiagonal of the Krylov space started at ``b`` falls out
    of the CG coefficients (T_jj = 1/a_j + b_{j-1}/a_{j-1}, T_{j,j+1} =
    sqrt(b_j)/a_j). Only the first ``max_rank`` iterations are recorded.
    """
    if max_rank <= 0:
        raise ValueError("max_rank must be positive for cg_solve_tridiag")
    return _cg_loop(A, b, tol, max_iters, x0, record=int(max_rank))
