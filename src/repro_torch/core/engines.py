"""Pluggable inference engines behind one front door.

Counterpart of the solve half of ``repro.core.engines``. An
:class:`InferenceEngine` realises the projected latent Kronecker operator

    A(u) = mask * (K1 @ (mask * u) @ K2) + sigma^2 * (mask * u)

and the solves against it. Three implementations are registered:

* ``dense``     - exact Cholesky of the masked joint matrix, O(N^3); the
                  paper's naive baseline and the small-N fast path.
* ``iterative`` - batched block CG (the paper's method) on the plain tensor
                  MVM, O(n^2 m + n m^2) per sweep, in the state's dtype.
* ``cuda``      - the iterative engine with every MVM routed through the
                  hand-written fused GPU kernel
                  (:func:`repro_torch.kernels.lk_mvm.lk_mvm_fused`). It fills
                  the slot the reference calls ``pallas``, and that name is
                  accepted as an alias.

The marginal likelihood (``make_mll``, ``mll_cholesky``), the log-determinant
and the guarded escalation ladder belong to the fit path and are not ported
yet. Until the ladder exists every eager solve follows the ``strict`` policy:
a solve that reports a breakdown or a non-finite residual raises
:class:`DegradedSolveError`; it is never returned as if it were healthy.
"""
from __future__ import annotations

import threading
from typing import Callable, Protocol, runtime_checkable

import torch

from .mvm import kron_dense, lk_mvm
from .solvers import CGResult, StackedSolveResult, resolve_solver
from .state import (BACKEND_ALIASES, GPData, LKGPConfig, LKGPParams,
                    gram_matrices)

__all__ = [
    "InferenceEngine", "ENGINES", "register_engine", "get_engine",
    "list_backends", "DenseEngine", "IterativeEngine", "KernelEngine",
    "CustomMVMEngine", "LatentKroneckerOperator", "StackedSolveResult",
    "DegradedSolveError", "solve_tally",
]

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


class DegradedSolveError(RuntimeError):
    """An eager solve broke down (``p^T A p <= 0``) or ended with a
    non-finite residual. Carries the solver diagnostics as ``result``."""

    def __init__(self, message: str, result: CGResult) -> None:
        super().__init__(message)
        self.result = result


def _raise_if_degraded(res: CGResult, what: str) -> None:
    """The ``strict`` solve policy: one host read, then raise or pass.

    Residuals above tolerance do NOT count: hitting ``max_iters`` on a hard
    system is expected behaviour and visible in the diagnostics.
    """
    bad = ~torch.isfinite(res.rel_residual).all()
    if res.breakdown is not None:
        bad = bad | res.breakdown.any()
    if bool(bad.item()):
        cols = []
        if res.breakdown is not None:
            cols = torch.nonzero(res.breakdown.reshape(-1)).reshape(-1).tolist()
        raise DegradedSolveError(
            f"{what}: solve degraded (breakdown in columns {cols}, worst "
            f"residual {float(res.rel_residual.max()):.3g}); the escalation "
            "ladder is not ported yet, so this is an error", res)


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


ENGINES: dict[str, type] = {}


def register_engine(name: str):
    def deco(cls):
        cls.name = name
        ENGINES[name] = cls
        return cls
    return deco


_ENGINE_SINGLETONS: dict[str, "InferenceEngine"] = {}
_ENGINE_LOCK = threading.Lock()


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
        if name == "distributed":
            raise NotImplementedError(
                "backend 'distributed' is not ported yet "
                "(ROADMAP queue 1 item 12, kernel K3)") from None
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
            mv = self.mask.reshape(-1)
            K = kron_dense(self.K1, self.K2) * (mv[:, None] * mv[None, :])
            K = K + torch.diag(self.noise * mv + (1.0 - mv))
            self._chol = torch.linalg.cholesky(K)
        return self._chol


def _iterative_solve(A, b, config, x0=None) -> CGResult:
    """Registry-resolved solve under the strict policy, diagnostics stashed
    on the operator as ``A.last_result`` where it accepts attributes."""
    _bump_tally()
    res = resolve_solver(config, A).solve(A, b, config, x0=x0)
    _stash_diagnostics(A, res)
    _raise_if_degraded(res, "solve")
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
            # Non-dense operator handed to the dense engine: iterate on it.
            return _iterative_solve(A, b, config, x0=x0).x
        _bump_tally()
        L = A.chol()
        N = A.mask.numel()
        bb = (b * A.mask).reshape(-1, N)          # (batch, N)
        x = torch.cholesky_solve(bb.T, L).T
        return (x * A.mask.reshape(-1)).reshape(b.shape)


# --------------------------------------------------------------------------
# iterative (block CG)
# --------------------------------------------------------------------------
class LatentKroneckerOperator:
    """Callable A(u) that remembers its Kronecker factors.

    The iterative-family engines return this instead of a bare closure so
    that a solver can reach the factors (the pivoted-Cholesky preconditioner
    of the fit path only needs K1 / K2 / mask, never the assembled operator).

    ``accurate``, where given, is a slower realisation of the same matrix in
    a wider dtype. The solvers take their true residuals from it and nothing
    else (see ``solvers/cg.py``, residual replacement).
    """

    def __init__(self, K1, K2, mask, noise, mvm=lk_mvm, accurate=None):
        self.K1, self.K2, self.mask, self.noise = K1, K2, mask, noise
        self._mvm = mvm
        self.accurate = accurate

    def __call__(self, u):
        return self._mvm(self.K1, self.K2, self.mask, u, noise=self.noise)

    def preconditioner(self, rank: int):
        raise NotImplementedError(
            "the pivoted-Cholesky preconditioner is not ported yet "
            "(ROADMAP queue 1 item 4, precond.py)")


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
        (iterations, true residuals, breakdown flags, MVM counts).

        The solve strategy comes from the registry (``config.solver``). A
        degraded solve raises :class:`DegradedSolveError`.
        """
        return _iterative_solve(A, b, config, x0=x0)

    def solve_stacked(self, A, rhs, config, *, probe_cols: int = 0,
                      subspace_dim=None, x0=None) -> StackedSolveResult:
        """ONE batched operator sweep for a whole stack of right-hand sides.

        ``rhs``: (s, n, m) stack (e.g. ``[y | Matheron residuals]``); every
        solver iteration applies the operator to the full stack at once,
        converged columns freeze. ``probe_cols > 0`` (the fused SLQ log-det)
        raises until SLQ is ported.
        """
        _bump_tally()
        st = resolve_solver(config, A).solve_stacked(
            A, rhs, config, probe_cols=probe_cols, subspace_dim=subspace_dim,
            x0=x0)
        _stash_diagnostics(A, st.result)
        _raise_if_degraded(st.result, "stacked solve")
        return st


class CustomMVMEngine(IterativeEngine):
    """Iterative engine over a user-supplied ``mvm(K1, K2, mask, u, noise=...)``."""

    name = "custom"

    def __init__(self, mvm: Callable):
        self._mvm = mvm

    def operator_from_grams(self, K1, K2, mask, noise):
        return LatentKroneckerOperator(K1, K2, mask, noise, mvm=self._mvm)


# --------------------------------------------------------------------------
# cuda (iterative, MVMs through the fused GPU kernel)
# --------------------------------------------------------------------------
def _kernel_mvm(K1, K2, mask, u, noise=0.0):
    # Import at call time: repro_torch.kernels imports core.gp_kernels, so a
    # module-level import here would be circular. force_kernel=True takes the
    # kernel wrapper on every device: on a CUDA tensor it launches the kernel
    # or raises, on a CPU tensor it runs the kernel's plain version, so the
    # engine exercises the same rounding points everywhere.
    from ..kernels import ops
    return ops.lk_mvm_op(K1, K2, mask, u, noise, force_kernel=True,
                         device=u.device)


@register_engine("cuda")
class KernelEngine(IterativeEngine):
    """CG with every operator sweep one launch of ``lk_mvm_fused``.

    The kernel computes in float32 whatever the state's dtype is. The
    factors, the mask and the noise scalar are cast to float32 ONCE, here,
    when the operator is built; per sweep only ``u`` is cast and the result
    cast back. The noise stays a 0-d device tensor, which the kernel reads
    through a pointer: a Python float would cost a host sync per sweep.

    A float32 sweep cannot vouch for its own result: at n = 8192 its
    summation error in A(x) is up to half of ``0.01 * ||b||``. So for a
    float64 state the operator also carries the plain float64 MVM on the
    original factors as ``accurate``; CG takes the true residuals it reports
    and corrects itself with (one sweep in ``REPLACE_EVERY``) from that, and
    every other sweep from the kernel.
    """

    def operator_from_grams(self, K1, K2, mask, noise):
        f32 = torch.float32
        noise = torch.as_tensor(noise, device=K1.device)
        if any(x.requires_grad for x in (K1, K2, mask, noise)):
            raise NotImplementedError(
                "the differentiable kernel MVM is not ported yet "
                "(ROADMAP queue 2 item K5)")
        accurate = None
        if K1.dtype == torch.float64:
            accurate = LatentKroneckerOperator(K1, K2, mask, noise)
        return LatentKroneckerOperator(
            K1.to(f32).contiguous(), K2.to(f32).contiguous(),
            mask.to(f32).contiguous(), noise.to(f32), mvm=_kernel_mvm,
            accurate=accurate)
