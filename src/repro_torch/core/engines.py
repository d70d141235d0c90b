"""Pluggable inference engines behind one front door, and the marginal
likelihood they compute.

Counterpart of ``repro.core.engines``. An :class:`InferenceEngine` realises
the projected latent Kronecker operator

    A(u) = mask * (K1 @ (mask * u) @ K2) + sigma^2 * (mask * u)

and the solves against it. Four implementations are registered:

* ``dense``     - exact Cholesky of the masked joint matrix, O(N^3); the
                  paper's naive baseline and the small-N fast path.
* ``iterative`` - batched block CG + SLQ (the paper's method) on the plain
                  tensor MVM, O(n^2 m + n m^2) per sweep, in the state's dtype.
* ``cuda``      - the iterative engine with every MVM routed through the
                  hand-written GPU kernels on the route the tuner picks
                  (the fused kernel K1 or the two-stage pair K2a + K2b,
                  :mod:`repro_torch.kernels.autotune`), differentiable
                  through :class:`KernelMVMFunction`. It fills the slot
                  the reference calls ``pallas``, and that name is
                  accepted as an alias.
* ``distributed`` - the iterative engine with the grid's rows split over the
                  ranks of a ``torch.distributed`` group: each rank computes
                  its row block of every MVM (float32 operands through the
                  row-shard kernel K3, others through the exact plain body)
                  and one all-gather assembles the result.

:func:`make_mll` builds the marginal likelihood ``mll(params, X, t, Y, mask,
probes)`` on any engine: straight through the Cholesky for ``dense``, as a
``torch.autograd.Function`` around ONE stacked CG solve ``K^-1 [y | probes]``
for the others (:func:`make_mll_iterative` threads any MVM into it).

Eager solves (``solve``, ``solve_result``, ``solve_stacked``: the posterior
path) run under ``LKGPConfig.solve_policy``'s escalation ladder
(:mod:`repro_torch.core.solvers.guarded`). The MLL objective's solve is not
guarded, as the reference's jitted objective is not: it passes through and
raises :class:`DegradedSolveError` on a breakdown or a non-finite residual
(L-BFGS and the polish can do nothing with a NaN objective).
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Protocol, runtime_checkable

import torch

from .. import tracing
from .caching import LRUCache
from .mvm import lk_mvm, masked_dense
from .precond import pivoted_cholesky_grid, woodbury_preconditioner
from .slq import slq_logdet
from .solvers import (CGResult, GuardedSolveError, StackedSolveResult,
                      escalation_tally, guarded_solve, guarded_solve_stacked)
from .solvers.guarded import health, pass_through
from .state import (BACKEND_ALIASES, GPData, LKGPConfig, LKGPParams,
                    gram_matrices)

__all__ = [
    "InferenceEngine", "ENGINES", "register_engine", "get_engine",
    "list_backends", "DenseEngine", "IterativeEngine", "KernelEngine",
    "CustomMVMEngine", "LatentKroneckerOperator", "StackedSolveResult",
    "DegradedSolveError", "solve_tally", "KernelMVMFunction",
    "KernelOperator", "KernelMVM", "DistributedEngine",
    "DistributedOperator", "mll_cholesky", "make_mll", "make_mll_iterative",
    "engine_cache_stats", "escalation_tally",
]

_LOG_2PI = math.log(2.0 * math.pi)

# Process-wide count of engine solve entries: a cache-verification aid ("did
# that posterior() call re-solve?"), not a performance counter. Engines are
# shared singletons and may be driven from several threads, so the
# read-modify-write is lock-guarded.
_solve_tally = 0
_TALLY_LOCK = threading.Lock()


def solve_tally() -> int:
    """Monotonic count of engine solve entries in this process."""
    return _solve_tally


def _bump_tally(n: int = 1) -> None:
    global _solve_tally
    with _TALLY_LOCK:
        _solve_tally += n


def _bump_escalations(res) -> None:
    """Count extra escalation-ladder attempts as solve entries: a guarded
    solve's trace has one step per attempt, the base one included."""
    trace = getattr(res, "trace", None)
    if trace and len(trace) > 1:
        _bump_tally(len(trace) - 1)


class DegradedSolveError(GuardedSolveError):
    """The objective's (unguarded) solve broke down (``p^T A p <= 0``) or
    ended with a non-finite residual. Carries the solver diagnostics as
    ``result``; a :class:`GuardedSolveError`, so one ``except`` catches both.
    """

    def __init__(self, message: str, result: CGResult) -> None:
        super().__init__(message)
        self.result = result


def _raise_if_degraded(res: CGResult, what: str) -> None:
    """The objective's strict check: one host read, then raise or pass.

    Residuals above tolerance do NOT count: hitting ``max_iters`` on a hard
    system is expected behaviour and visible in the diagnostics.
    """
    bad, worst = health(res)
    if bad:
        cols = []
        if res.breakdown is not None:
            cols = torch.nonzero(res.breakdown.reshape(-1)).reshape(-1).tolist()
        raise DegradedSolveError(
            f"{what}: solve degraded (breakdown in columns {cols}, worst "
            f"residual {worst:.3g})", res)


@runtime_checkable
class InferenceEngine(Protocol):
    """Linear-algebra backend: operator construction and solves."""

    name: str
    exact: bool   # True -> solve is exact

    def operator(self, params: LKGPParams, data: GPData,
                 config: LKGPConfig) -> Callable[[torch.Tensor], torch.Tensor]:
        """Build A(u) on grid-form vectors from raw parameters."""
        ...

    def operator_from_grams(self, K1, K2, mask, noise):
        """Build A(u) from precomputed Gram matrices (posterior hot path)."""
        ...

    def solve(self, A, b, config: LKGPConfig, x0=None) -> torch.Tensor:
        """Solve A x = b; b may carry leading batch dimensions."""
        ...

    def logdet(self, A, data: GPData, config: LKGPConfig,
               probes: torch.Tensor | None) -> torch.Tensor:
        """log det of A restricted to the observed subspace."""
        ...


ENGINES: dict[str, type] = {}


def register_engine(name: str):
    def deco(cls):
        cls.name = name
        ENGINES[name] = cls
        return cls
    return deco


# Bounded and instrumented like the objective caches it keys (see
# core.state): the cap is far above the four registered engines, so nothing
# is evicted in practice. An eviction would mint a new engine identity and
# miss every cached objective keyed on the old one, which the counters make
# visible.
_ENGINE_SINGLETONS: LRUCache = LRUCache(16)
_ENGINE_LOCK = threading.Lock()


def engine_cache_stats() -> dict:
    """Hit/miss/eviction counters of the engine singleton map."""
    with _ENGINE_LOCK:
        return _ENGINE_SINGLETONS.stats()


def get_engine(name: str, **kwargs) -> "InferenceEngine":
    """Engine by backend name; kwargs-free lookups return a singleton.

    Engines are stateless, so sharing is safe. ``"pallas"`` names the same
    singleton as ``"cuda"``. Custom-configured engines (``kwargs`` given) are
    built fresh.
    """
    name = BACKEND_ALIASES.get(name, name)
    try:
        cls = ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; "
                         f"available: {sorted(ENGINES)}") from None
    if kwargs:
        return cls(**kwargs)
    with _ENGINE_LOCK:
        engine = _ENGINE_SINGLETONS.get(name)
        if engine is None:
            engine = _ENGINE_SINGLETONS[name] = cls()
    return engine


def list_backends() -> list[str]:
    return sorted(ENGINES)


# --------------------------------------------------------------------------
# dense (exact Cholesky)
# --------------------------------------------------------------------------
class _DenseOperator:
    """Callable A(u) that can also materialise / factorise the dense matrix.

    The construction zeroes unobserved rows/cols and puts a unit diagonal on
    unobserved cells, so the full-grid Cholesky reproduces the observed-block
    solve exactly. The factorisation is cached per instance.
    """

    def __init__(self, K1, K2, mask, noise):
        self.K1, self.K2, self.mask, self.noise = K1, K2, mask, noise
        self._chol: torch.Tensor | None = None

    def __call__(self, u):
        return lk_mvm(self.K1, self.K2, self.mask, u, self.noise)

    def chol(self):
        if self._chol is None:
            self._chol = torch.linalg.cholesky(
                masked_dense(self.K1, self.K2, self.mask, self.noise))
        return self._chol


def _iterative_solve(A, b, config, x0=None) -> CGResult:
    """Registry-resolved solve under the escalation policy, one tally entry
    per attempt, diagnostics (with the ``trace``) stashed on the operator as
    ``A.last_result`` where it accepts attributes."""
    _bump_tally()
    res = guarded_solve(A, b, config, x0=x0)
    _bump_escalations(res)
    _stash_diagnostics(A, res)
    return res


@register_engine("dense")
class DenseEngine:
    exact = True

    def operator(self, params, data, config):
        K1, K2 = gram_matrices(params, data.X, data.t, config.t_kernel,
                               config.jitter)
        return self.operator_from_grams(K1, K2, data.mask,
                                        torch.exp(params.raw_noise))

    def operator_from_grams(self, K1, K2, mask, noise):
        return _DenseOperator(K1, K2, mask, noise)

    def solve(self, A, b, config, x0=None):
        # x0 is accepted for interface uniformity; the exact solve ignores it.
        if not isinstance(A, _DenseOperator):
            # Non-dense operator handed to the dense engine: the guarded
            # iterative solve, diagnostics kept.
            return _iterative_solve(A, b, config, x0=x0).x
        _bump_tally()
        L = A.chol()
        N = A.mask.numel()
        bb = (b * A.mask).reshape(-1, N)          # (batch, N)
        x = torch.cholesky_solve(bb.T, L).T
        return (x * A.mask.reshape(-1)).reshape(b.shape)

    def logdet(self, A, data, config, probes=None):
        L = A.chol()
        return 2.0 * torch.log(torch.diagonal(L)).sum()  # unobserved diag = 1


# --------------------------------------------------------------------------
# iterative (block CG)
# --------------------------------------------------------------------------
class LatentKroneckerOperator:
    """Callable A(u) that remembers its Kronecker factors.

    The iterative-family engines return this instead of a bare closure so
    that a solver can reach the factors: the pivoted-Cholesky preconditioner
    only needs K1 / K2 / mask / noise, never the assembled operator, and the
    guarded ladder's dense fallback assembles them.

    ``accurate``, where given, is a slower realisation of the same matrix in
    a wider dtype. The solvers take their true residuals from it and nothing
    else (see ``solvers/cg.py``, residual replacement).
    """

    def __init__(self, K1, K2, mask, noise, mvm=lk_mvm, accurate=None):
        self.K1, self.K2, self.mask, self.noise = K1, K2, mask, noise
        self._mvm = mvm
        self.accurate = accurate
        self._precond = None    # (rank, M_inv) cache

    def __call__(self, u):
        return self._mvm(self.K1, self.K2, self.mask, u, noise=self.noise)

    def preconditioner(self, rank: int):
        """Woodbury M^-1 (on packed (..., n*m) vectors) from the
        rank-``rank`` pivoted Cholesky, cached per operator and rank.

        It depends only on (K1, K2, mask, noise), fixed for this operator,
        so repeated solves share one factor. It is built without autograd
        from the detached factors in the state's dtype (for the ``cuda``
        engine the float64 ones, never the float32 ``.fast`` copies): a
        preconditioner need not be differentiated, and the pivots are
        found on the device without a host read.
        """
        if self._precond is None or self._precond[0] != rank:
            # the apply outlives this block: it must not hold a graph to noise
            noise = (self.noise.detach()
                     if isinstance(self.noise, torch.Tensor) else self.noise)
            with torch.no_grad():
                L = pivoted_cholesky_grid(self.K1, self.K2, self.mask, rank)
                self._precond = (rank, woodbury_preconditioner(L, noise))
        return self._precond[1]


def _stash_diagnostics(A, res: CGResult) -> None:
    """Best-effort: hang the solve diagnostics on the operator object.

    Operators are created per evaluation, so the attribute has the same
    lifetime as the solve it describes; :class:`Posterior` reads it back as
    ``A.last_result``. Plain callables that reject attributes are skipped.
    """
    try:
        A.last_result = res
    except AttributeError:
        pass


@register_engine("iterative")
class IterativeEngine:
    exact = False

    def operator(self, params, data, config):
        K1, K2 = gram_matrices(params, data.X, data.t, config.t_kernel,
                               config.jitter)
        return self.operator_from_grams(K1, K2, data.mask,
                                        torch.exp(params.raw_noise))

    def operator_from_grams(self, K1, K2, mask, noise):
        return LatentKroneckerOperator(K1, K2, mask, noise)

    def solve(self, A, b, config, x0=None):
        return self.solve_result(A, b, config, x0=x0).x

    def solve_result(self, A, b, config, x0=None) -> CGResult:
        """Like :meth:`solve` but returning the full per-column diagnostics
        (iterations, true residuals, breakdown flags, MVM counts, the
        escalation ``trace``).

        The solve strategy comes from the registry (``config.solver``:
        cg / pcg / sgd; "auto" picks pcg iff ``precond_rank > 0``) and runs
        under the ``config.solve_policy`` escalation guard.
        """
        return _iterative_solve(A, b, config, x0=x0)

    def solve_stacked(self, A, rhs, config, *, probe_cols: int = 0,
                      subspace_dim=None, x0=None) -> StackedSolveResult:
        """ONE batched operator sweep for a whole stack of right-hand sides.

        ``rhs``: (s, n, m) stack (e.g. ``[y | Matheron residuals]``); every
        solver iteration applies the operator to the full stack at once,
        converged columns freeze. When the trailing ``probe_cols`` rows are
        SLQ probes and CG runs, their CG-Lanczos tridiagonals are recorded
        during the SAME solve and turned into the log-determinant estimate
        (``StackedSolveResult.logdet``); PCG / SGD report ``logdet=None``
        and the caller runs SLQ separately. Runs under the escalation guard.
        """
        _bump_tally()
        st = guarded_solve_stacked(A, rhs, config, probe_cols=probe_cols,
                                   subspace_dim=subspace_dim, x0=x0)
        _bump_escalations(st.result)
        _stash_diagnostics(A, st.result)
        return st

    def logdet(self, A, data, config, probes):
        return slq_logdet(A, probes, config.slq_iters, data.mask.sum())


class CustomMVMEngine(IterativeEngine):
    """Iterative engine over a user-supplied ``mvm(K1, K2, mask, u, noise=...)``.

    An ``mvm`` with an ``operator(K1, K2, mask, noise)`` method builds its
    own operator (:class:`KernelMVM` does: float32 copies of the factors made
    once, a float64 ``accurate`` beside them); any other is called per sweep.
    """

    name = "custom"

    def __init__(self, mvm: Callable):
        self._mvm = mvm

    def operator_from_grams(self, K1, K2, mask, noise):
        build = getattr(self._mvm, "operator", None)
        if build is not None:
            return build(K1, K2, mask, noise)
        return LatentKroneckerOperator(K1, K2, mask, noise, mvm=self._mvm)


# --------------------------------------------------------------------------
# cuda (iterative, MVMs through the GPU kernels)
# --------------------------------------------------------------------------
def _kernels():
    """``repro_torch.kernels``, imported at first use: it imports
    ``core.gp_kernels``, so a module-level import here would be circular."""
    from .. import kernels
    return kernels


class KernelMVMFunction(torch.autograd.Function):
    """Differentiable A(u) through the kernel route, in the slot of the
    reference's ``_pallas_mvm`` (``repro/core/engines.py``).

    ``apply(K1, K2, mask, u, noise, launch)``. ``K1, K2, mask, u, noise``
    are tensors in the state's dtype and receive the gradients. ``launch``
    is the operator's :class:`~repro_torch.kernels.lk_mvm.MVMLaunch` for
    ``u``'s batch (over the float32 copies the kernels read, checked and
    planned once): the forward sweep and ``du`` both call it, so the
    backward launches what the forward did, the kernels on a CUDA tensor
    and their float32 plain version on a CPU tensor. ``launch=None`` sends
    the sweeps to ``lk_mvm_op`` by device on the state-dtype tensors
    themselves: the float64 oracle for CPU tensors, which is what a
    finite-difference check needs.

    The MVM is bilinear in (K1, K2, u), so the backward is closed-form, as
    the reference's ``_pallas_mvm_bwd``: ``dK1``, ``dK2`` and ``dnoise`` are
    plain matrix products in the state's dtype (the reference forms them with
    einsums outside any kernel), and ``du = A(g)`` (A is symmetric) goes
    through the kernel again, only when ``u`` needs a gradient. The mask is
    data: no gradient (the reference returns zeros).
    """

    @staticmethod
    def forward(ctx, K1, K2, mask, u, noise, launch):
        ctx.save_for_backward(K1, K2, mask, u, noise)
        if launch is None:
            op = _kernels().ops.lk_mvm_op
            launch = lambda v: op(K1, K2, mask, v, noise, device=v.device)
        ctx.launch = launch
        with tracing.span("lkgp.mvm.launch"):
            return launch(u)

    @staticmethod
    def backward(ctx, g):
        K1, K2, mask, u, noise = ctx.saved_tensors
        need = ctx.needs_input_grad
        n, m = mask.shape
        gm = (g * mask).reshape(-1, n, m)   # flatten leading batch dims
        um = (u * mask).reshape(-1, n, m)
        dK1 = dK2 = du = dnoise = None
        if need[0]:
            dK1 = torch.einsum("bik,bjk->ij", gm, um @ K2)
        if need[1]:
            dK2 = torch.einsum("bij,bik->jk", K1 @ um, gm)
        if need[3]:
            with tracing.span("lkgp.mvm.launch"):
                du = ctx.launch(g.contiguous())
        if need[4]:
            dnoise = (gm * um).sum().reshape(noise.shape)
        return dK1, dK2, None, du, dnoise, None


class KernelOperator(LatentKroneckerOperator):
    """A(u) with every sweep one launch of the fused kernel (``fused=True``)
    or one launch each of the two-stage kernels (``fused=False``),
    differentiable in K1, K2, u and noise through :class:`KernelMVMFunction`.

    ``fused=None`` (the default) routes by the tuner
    (:func:`repro_torch.kernels.autotune.autotune_route`): the route of each
    batch bucket is resolved ONCE for the operator, at its first sweep of
    that bucket (the batch is not known before), and kept in ``routes``
    (bucket -> fused), so every CG iteration of a solve and the backward's
    sweeps launch the same kernels whatever the tuner's cache does
    meanwhile. A bucket's first sweep on a CUDA device may time the
    candidates (once per process and bucket).

    ``K1, K2, mask, noise`` stay in the state's dtype (the backward's
    products run in it); the kernels compute in float32 whatever that dtype
    is, so their float32 copies are made ONCE, here, as ``fast``. The first
    sweep of each batch size B makes the operator's launch for it
    (:func:`repro_torch.kernels.lk_mvm.mvm_launch`: operands checked, plans
    made, kept; :meth:`launch`); per sweep only ``u`` is cast, the outputs
    allocated, the kernels launched and the result cast back. The noise
    stays a 0-d device tensor, which the kernels read through a pointer: a
    Python float would cost a host sync per sweep.

    A float32 sweep cannot vouch for its own result: at n = 8192 its
    summation error in A(x) is up to half of ``0.01 * ||b||``. So for a
    float64 state the operator also carries the plain float64 MVM on the
    original factors as ``accurate``; CG takes the true residuals it reports
    and corrects itself with (one sweep in ``REPLACE_EVERY``) from that, and
    every other sweep from the kernel.
    """

    def __init__(self, K1, K2, mask, noise, fused: bool | None = None):
        noise = torch.as_tensor(noise, dtype=K1.dtype, device=K1.device)
        accurate = None
        if K1.dtype == torch.float64:
            accurate = LatentKroneckerOperator(
                K1.detach(), K2.detach(), mask.detach(), noise.detach())
        super().__init__(K1, K2, mask, noise, accurate=accurate)
        self.fast = tuple(x.detach().to(torch.float32).contiguous()
                          for x in (K1, K2, mask, noise))
        self.fused = fused
        self.routes: dict[int, bool] = {}
        self._launches: dict = {}

    def launch(self, B: int):
        """The launch of a sweep of B grid vectors, made at the first: on
        the route named, or else on the tuner's route of B's bucket."""
        launch = self._launches.get(B)
        if launch is None:
            kernels = _kernels()
            fused = self.fused
            if fused is None:
                key = kernels.autotune.bucket(B)
                fused = self.routes.get(key)
                if fused is None:
                    n, m = self.mask.shape
                    fused = self.routes[key] = kernels.autotune.autotune_route(
                        n, m, B, precision="f32",
                        device=self.fast[0].device) == "fused"
            launch = self._launches[B] = kernels.lk_mvm.mvm_launch(
                "fused" if fused else "two_stage", *self.fast, B)
        return launch

    def __call__(self, u):
        with tracing.span("lkgp.mvm") as sp:
            n, m = self.mask.shape
            launch = self.launch(u.numel() // (n * m))
            if sp is not None:
                self._trace(sp, launch)
            return KernelMVMFunction.apply(self.K1, self.K2, self.mask, u,
                                           self.noise, launch)

    @staticmethod
    def _trace(sp, launch) -> None:
        """A traced sweep: its route and shape on its ``lkgp.mvm`` span
        (``r_steps``: K2a's ring steps a strip at this m),
        and on the two-stage route K2a's plan in the counters
        ``lkgp.mvm.stage_r_steps`` (strip steps) and ``.stage_r_bytes``
        (bytes its loads and stores move)."""
        plan = launch.stream
        sp.set(route=launch.route, B=launch.B, m=launch.m,
               r_steps=plan.strip_steps)
        if launch.route == "two_stage":
            tracing.count("lkgp.mvm.stage_r_steps",
                          plan.strips * plan.strip_steps)
            tracing.count("lkgp.mvm.stage_r_bytes", plan.nbytes())


class KernelMVM:
    """The differentiable kernel MVM as ``mvm(K1, K2, mask, u, noise=...)``,
    in the slot of the reference's ``_pallas_mvm_kw``. ``fused`` picks the
    kernel: the fused one (K1, ``True``), the two-stage pair (K2a + K2b,
    ``False``) or the tuner's route per operator (``None``, the default).

    ``make_mll_iterative(cfg, mvm_impl=KernelMVM(fused=False))`` threads the
    two-stage kernels into the objective. The engine it builds asks
    :meth:`operator` for its operators, so there too the float32 copies are
    made once per operator and a float64 state has ``accurate`` residuals.
    Called directly, each call builds a :class:`KernelOperator` for itself.
    """

    def __init__(self, fused: bool | None = None):
        self.fused = fused

    def operator(self, K1, K2, mask, noise) -> KernelOperator:
        return KernelOperator(K1, K2, mask, noise, fused=self.fused)

    def __call__(self, K1, K2, mask, u, noise=0.0):
        return self.operator(K1, K2, mask, noise)(u)


@register_engine("cuda")
class KernelEngine(IterativeEngine):
    """CG + SLQ with every operator sweep through the MVM kernels
    (:class:`KernelOperator`, differentiable), on the route the tuner picks
    per operator and batch bucket (K1, or K2a + K2b), as the reference's
    ``PallasEngine`` takes its tuner's blocks. A named route is reached
    through ``make_mll_iterative(cfg, KernelMVM(fused=True or False))``.
    """

    def operator_from_grams(self, K1, K2, mask, noise):
        return KernelOperator(K1, K2, mask, noise, fused=None)


# --------------------------------------------------------------------------
# distributed (rows split over the ranks of a torch.distributed group)
# --------------------------------------------------------------------------
_NO_K3_GRADIENT = (
    "the row-shard kernel K3 (lk_mvm_fused_rows) has no backward, as in the "
    "reference, whose float32 fit on its distributed engine fails the same "
    "way (ROADMAP, reference caveats); differentiate through float64 "
    "operands or DistributedEngine(fused=False)")


class DistributedOperator:
    """A(u) on whole (..., n, m) grid vectors, every rank computing its own
    row block and one all-gather joining them.

    Like the reference's distributed operator, a bare closure, it exposes
    no Kronecker factors (they are kept privately): it has no
    ``preconditioner``, so ``solver="auto"`` with ``precond_rank > 0`` and
    ``solver="pcg"`` both run plain CG, and the guarded ladder's dense
    fallback is not eligible.

    ``K1, K2, mask, noise`` and every ``u`` are held whole on every rank
    (replicated), as the reference's engine holds K1. Rank r of a world of p
    takes rows ``r * n/p ... (r+1) * n/p`` (n must divide by p) and per call:

    * ``fused``: forms ``um_full = mask * u`` itself (u is whole here, so no
      collective is needed for it) and launches kernel K3 once for its rows
      and the whole batch (:func:`repro_torch.kernels.lk_mvm.lk_mvm_fused_rows`);
    * otherwise: the exact body in the factors' dtype, ``mask_r * (K1_r @
      ((mask * u) @ K2)) + noise * (mask_r * u_r)``;

    then all-gathers the (..., n/p, m) output rows: one collective per
    sweep. Everything after it is replicated, so the host-side decisions of
    the solvers are the same on every rank.

    The fused operator has no gradient (raises ``NotImplementedError``). The
    exact body differentiates: at a world size above 1 the gather's backward
    takes the rank's slice and the operator's inputs sum their gradients over
    the group (:class:`~repro_torch.distributed.lkgp_dist.SumGrads`), so
    every rank gets the whole gradient, the same as a world of one.
    """

    def __init__(self, K1, K2, mask, noise, *, fused: bool, group=None,
                 rank: int = 0, world: int = 1):
        n = mask.shape[0]
        if n % world:
            raise ValueError(f"the distributed engine splits the n = {n} grid "
                             f"rows evenly over {world} ranks: n must be "
                             "divisible by the world size")
        if fused:
            noise = torch.as_tensor(noise, dtype=K1.dtype, device=K1.device)
        self._factors = (K1, K2, mask, noise)
        self.fused = fused
        self.group, self.rank, self.world = group, rank, world
        n_local = n // world
        self.rows = slice(rank * n_local, (rank + 1) * n_local)

    def __call__(self, u):
        from ..distributed.lkgp_dist import GatherRows, SumGrads, gather_rows
        rows = self.rows
        K1, K2, mask, noise = self._factors
        grad = torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in (K1, K2, noise, u))
        if self.fused:
            if grad:
                raise NotImplementedError(_NO_K3_GRADIENT)
            out_rows = _kernels().lk_mvm.lk_mvm_fused_rows(
                K1[rows], K2, mask[rows], u[..., rows, :].contiguous(),
                (mask * u).contiguous(), noise)
            return gather_rows(out_rows, self.group, self.world)
        if grad and self.world > 1:
            K1, K2, u = (SumGrads.apply(x, self.group) for x in (K1, K2, u))
            if isinstance(noise, torch.Tensor):
                noise = SumGrads.apply(noise, self.group)
        mk = mask[rows]
        out_rows = mk * (K1[rows] @ ((mask * u) @ K2)) \
            + noise * (mk * u[..., rows, :])
        if grad:
            return GatherRows.apply(out_rows, self.group, self.rank,
                                    self.world)
        return gather_rows(out_rows, self.group, self.world)


@register_engine("distributed")
class DistributedEngine(IterativeEngine):
    """CG + SLQ with the grid's rows split over a ``torch.distributed`` group
    (:class:`DistributedOperator`: one all-gather per sweep).

    ``group=None`` takes the default group when one is initialised when an
    operator is built, else a world of one rank and no collective. Every
    rank runs the same solves on the same (replicated) vectors; its tensors
    live on its own device (``cuda:{local_rank}`` under NCCL, set by the
    caller).

    ``fused`` keeps the reference's gate: ``"auto"`` takes the row-shard
    kernel K3 for float32 Gram factors and the exact plain body for any
    other dtype (float64 states stay exact: no cast to float32 here, unlike
    the ``cuda`` engine); ``True`` insists on K3 and raises ``ValueError`` on
    non-float32 factors; ``False`` always takes the plain body. K3 has no
    gradient, so a float32 ``fit`` on this engine raises (as the reference's
    does); a float64 one differentiates through the plain body.
    """

    def __init__(self, group=None, fused="auto"):
        if fused not in ("auto", True, False):
            raise ValueError(f"fused must be 'auto', True or False, got "
                             f"{fused!r}")
        self.group = group
        self.fused = fused

    def _use_kernel(self, K1) -> bool:
        if self.fused is False:
            return False
        if K1.dtype != torch.float32:
            if self.fused is True:
                raise ValueError(
                    "DistributedEngine(fused=True) needs float32 (f32) "
                    "operands: the row-shard kernel K3 computes in float32, "
                    f"got {K1.dtype}")
            return False
        return True

    def operator_from_grams(self, K1, K2, mask, noise):
        from ..distributed.lkgp_dist import group_layout
        group, rank, world = group_layout(self.group)
        return DistributedOperator(K1, K2, mask, noise,
                                   fused=self._use_kernel(K1), group=group,
                                   rank=rank, world=world)


# --------------------------------------------------------------------------
# marginal likelihood
# --------------------------------------------------------------------------
def mll_cholesky(params: LKGPParams, X, t, Y, mask, t_kernel: str = "matern12",
                 jitter: float = 1e-6) -> torch.Tensor:
    """Exact MLL of the observed block: the paper's NAIVE baseline.

    O(n^3 m^3) time / O(n^2 m^2) space, via the dynamic-mask construction
    (see :class:`_DenseOperator`). Differentiable through the Cholesky.
    """
    K1, K2 = gram_matrices(params, X, t, t_kernel, jitter)
    y = (Y * mask).reshape(-1)
    L = torch.linalg.cholesky(
        masked_dense(K1, K2, mask, torch.exp(params.raw_noise)))
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    N = mask.sum()
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return -0.5 * torch.dot(y, alpha) - 0.5 * logdet - 0.5 * N * _LOG_2PI


class _IterativeMLL(torch.autograd.Function):
    """The iterative MLL with its closed-form gradient (the reference's
    ``custom_vjp`` in ``make_mll``).

    ``apply(engine, config, X, t, Y, mask, probes, *raw_params)``. The
    forward is ONE stacked solve ``K^-1 [y | probes]`` whose probe
    tridiagonals give the SLQ log-det; it keeps ``alpha``, ``W`` and the
    probes. The backward differentiates

        h(theta) = 1/2 alpha^T A(theta) alpha - 1/2 mean_p w_p^T A(theta) z_p

    with respect to the raw parameters, on a fresh operator built from
    detached copies of them: two operator sweeps (``A(alpha)`` and
    ``A(probes)``), and no ``du`` because alpha and the probes are constants.
    X, t, Y, mask and the probes get no gradient.
    """

    @staticmethod
    def forward(ctx, engine, config, X, t, Y, mask, probes, *raw):
        data = GPData(X, t, None, mask)
        A = engine.operator(LKGPParams(*raw), data, config)
        Ym = Y * mask
        rhs = torch.cat([Ym[None], probes], dim=0)
        N = mask.sum()
        # Not guarded, as the reference's traced objective is not (so the
        # objective is the same function under every solve_policy): a
        # breakdown or a non-finite residual raises DegradedSolveError
        # (L-BFGS can do nothing with a NaN objective), a residual above
        # cg_tol does not.
        stacked = getattr(engine, "solve_stacked", None)
        logdet = None
        with pass_through():
            if stacked is not None and getattr(config, "slq_via_cg", True):
                st = stacked(A, rhs, config, probe_cols=probes.shape[0],
                             subspace_dim=N)
                sol, logdet, res = st.x, st.logdet, st.result
            else:
                sol = engine.solve(A, rhs, config)
                res = getattr(A, "last_result", None)
        if res is not None:
            _raise_if_degraded(res, "the objective's stacked solve")
        if logdet is None:
            logdet = engine.logdet(A, data, config, probes)
        alpha, W = sol[0], sol[1:]
        ctx.save_for_backward(X, t, mask, alpha, W, probes, *raw)
        ctx.engine, ctx.config = engine, config
        return -0.5 * (Ym * alpha).sum() - 0.5 * logdet - 0.5 * N * _LOG_2PI

    @staticmethod
    def backward(ctx, gbar):
        X, t, mask, alpha, W, probes, *raw = ctx.saved_tensors
        p = probes.shape[0]
        with torch.enable_grad():
            leaves = [r.detach().requires_grad_() for r in raw]
            A = ctx.engine.operator(LKGPParams(*leaves),
                                    GPData(X, t, None, mask), ctx.config)
            h = (0.5 * (alpha * A(alpha)).sum()
                 - 0.5 * (W * A(probes)).sum() / p)
            grads = torch.autograd.grad(h, leaves, allow_unused=True)
        grads = [torch.zeros_like(r) if g is None else gbar * g
                 for r, g in zip(raw, grads)]
        return (None,) * 7 + tuple(grads)


def make_mll(config: LKGPConfig, engine: "InferenceEngine") -> Callable:
    """MLL as ``mll(params, X, t, Y, mask, probes)`` for any engine.

    Exact engines ignore ``probes`` and differentiate through the Cholesky.
    Iterative-family engines share fixed Rademacher probes between the SLQ
    log-det estimate and the stochastic trace gradients; fixing them makes
    the objective deterministic, which the L-BFGS line search requires.
    """
    if engine.exact:
        # For DenseEngine this is exactly mll_cholesky: one cached Cholesky
        # shared by solve and log-det.
        def mll_exact(params, X, t, Y, mask, probes=None):
            data = GPData(X, t, None, mask)
            A = engine.operator(params, data, config)
            Ym = Y * mask
            alpha = engine.solve(A, Ym, config)
            N = mask.sum()
            logdet = engine.logdet(A, data, config, probes)
            return (-0.5 * (Ym * alpha).sum() - 0.5 * logdet
                    - 0.5 * N * _LOG_2PI)
        return mll_exact

    def mll(params, X, t, Y, mask, probes):
        return _IterativeMLL.apply(engine, config, X, t, Y, mask, probes,
                                   *params)
    return mll


def make_mll_iterative(cfg: LKGPConfig, mvm_impl=None):
    """Iterative MLL (the reference's entry for threading an MVM into it).

    Returns ``mll(params, X, t, Y, mask, probes)``. With ``mvm_impl`` given
    (``mvm(K1, K2, mask, u, noise=...)``), every MVM (CG, SLQ and the
    quadratic-form gradients) goes through it; ``KernelMVM(fused=False)``
    puts the two-stage kernels there.
    """
    engine = IterativeEngine() if mvm_impl is None else CustomMVMEngine(mvm_impl)
    return make_mll(cfg, engine)
