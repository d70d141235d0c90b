"""Posterior sampling via Matheron's rule with latent Kronecker structure.

Counterpart of ``repro.core.matheron``.

    (f | Y)(.) = f(.) + k(., train) P^T (P (K1 (x) K2) P^T + s^2 I)^{-1}
                                        (vec(Y) - f(X x t) - eps)

* Prior samples on the joint grid use the Kronecker factorisation
  (L1 (x) L2) Z  ==  L1 @ Z @ L2^T  at O((n+n*)^3 + m^3) cost.
* The inverse-matrix-vector product is a batched solve against the masked
  latent-Kronecker operator (grid form, zero-padded residuals).
* The correction is zero-padding -> Kronecker MVM -> evaluation at test rows:
  K1[joint, train] @ u @ K2.

The pieces are exposed separately so that
:class:`repro_torch.core.posterior.Posterior` can stack the Matheron residuals
together with ``Y * mask`` into ONE multi-RHS block solve. The large products
here are plain ``torch.matmul`` / ``torch.linalg`` calls, as the reference
leaves them to its compiler outside any hand-written kernel.
"""
from __future__ import annotations

from typing import Callable

import torch

from .mvm import lk_operator
from .solvers import get_solver

__all__ = ["sample_posterior_grid", "prior_residual_draws",
           "kronecker_correction"]


def prior_residual_draws(generator, K1_joint: torch.Tensor, K2: torch.Tensor,
                         n_train: int, noise, n_samples: int,
                         jitter: float = 1e-6, *, normals=None):
    """Draw the Matheron prior part: joint-grid prior samples + noise.

    Returns ``(F, eps)`` with ``F`` of shape (s, n+n*, m) - prior samples over
    the full joint grid via the Kronecker factorisation - and ``eps`` of
    shape (s, n, m), the observation-noise draws on the training block. The
    solve RHS is then ``mask * (F[:, :n] + eps)``.

    The standard-normal draws come from ``generator`` (a ``torch.Generator``
    on the factors' device), or are given outright as ``normals=(Z, E)`` with
    shapes (s, n+n*, m) and (s, n, m): PyTorch and JAX produce different bits
    from one seed, so a test that compares the two hands both the same draws.
    """
    dtype, dev = K1_joint.dtype, K1_joint.device
    na = K1_joint.shape[0]
    m = K2.shape[0]
    L1 = torch.linalg.cholesky(
        K1_joint + jitter * torch.eye(na, dtype=dtype, device=dev))
    L2 = torch.linalg.cholesky(
        K2 + jitter * torch.eye(m, dtype=dtype, device=dev))

    if normals is None:
        Z = torch.randn((n_samples, na, m), dtype=dtype, device=dev,
                        generator=generator)
        E = torch.randn((n_samples, n_train, m), dtype=dtype, device=dev,
                        generator=generator)
    else:
        Z, E = (torch.as_tensor(x, dtype=dtype, device=dev) for x in normals)
        if Z.shape != (n_samples, na, m) or E.shape != (n_samples, n_train, m):
            raise ValueError(
                f"normals must have shapes {(n_samples, na, m)} and "
                f"{(n_samples, n_train, m)}, got {tuple(Z.shape)} and "
                f"{tuple(E.shape)}")
    # Prior samples on the joint grid: vec(F) ~ N(0, K1_joint (x) K2).
    F = L1 @ Z @ L2.T
    eps = torch.sqrt(torch.as_tensor(noise, dtype=dtype, device=dev)) * E
    return F, eps


def kronecker_correction(K1_joint: torch.Tensor, u: torch.Tensor,
                         K2: torch.Tensor, n_train: int) -> torch.Tensor:
    """Matheron correction (k1(., X) (x) k2(., t)) P^T u == K1[:, :n] @ u @ K2."""
    return K1_joint[:, :n_train] @ u @ K2


def sample_posterior_grid(generator, K1_joint: torch.Tensor, K2: torch.Tensor,
                          n_train: int, Y: torch.Tensor, mask: torch.Tensor,
                          noise, n_samples: int, cg_tol: float = 0.01,
                          cg_max_iters: int = 10_000, jitter: float = 1e-6,
                          mvm: Callable | None = None,
                          solve: Callable | None = None,
                          alpha: torch.Tensor | None = None,
                          solver: str | None = None,
                          config=None, *, normals=None) -> torch.Tensor:
    """Draw posterior samples over the full (train + test configs) x t grid.

    K1_joint: ((n+n*), (n+n*)) config kernel over [X_train; X_test].
    K2: (m, m) progression kernel on the shared t grid.
    Y, mask: (n, m) observed learning curves (grid form).
    mvm: optional raw MVM ``mvm(K1, K2, mask, u, noise=...)`` for the CG
      operator; solve: optional batched solver ``solve(rhs) -> K^{-1} rhs``
      overriding the solver entirely; alpha: optional cached
      ``K^{-1}(Y * mask)``; solver: registry name for the residual solves;
      config: optional LKGPConfig supplying the solver settings (tolerances
      default to ``cg_tol`` / ``cg_max_iters`` otherwise).
    Returns samples of shape (n_samples, n+n*, m); rows [:n] are posterior
    curves for the training configs (continuations), rows [n:] for test.
    """
    F, eps = prior_residual_draws(generator, K1_joint, K2, n_train, noise,
                                  n_samples, jitter, normals=normals)

    if solve is None:
        K1_tt = K1_joint[:n_train, :n_train]
        if mvm is None:
            A = lk_operator(K1_tt, K2, mask, noise)
        else:
            A = lambda u: mvm(K1_tt, K2, mask, u, noise=noise)
        if config is None:
            # Duck-config carrying just what the solver strategies read.
            from .state import LKGPConfig
            config = LKGPConfig(cg_tol=cg_tol, cg_max_iters=cg_max_iters,
                                solver=solver or "auto")
        elif solver is not None and getattr(config, "solver", None) != solver:
            import dataclasses
            config = dataclasses.replace(config, solver=solver)
        strategy = get_solver(config.solver if config.solver != "auto"
                              else "cg")
        solve = lambda rhs: strategy.solve(A, rhs, config).x

    if alpha is None:
        u = solve(mask * (Y[None] - F[:, :n_train, :] - eps))  # (s, n, m)
    else:
        # Reuse the cached K^{-1}(Y*mask): solve only for the (F + eps) part.
        u = alpha[None] - solve(mask * (F[:, :n_train, :] + eps))

    return F + kronecker_correction(K1_joint, u, K2, n_train)
