"""Stochastic Lanczos quadrature (SLQ) for log-determinants.

Counterpart of ``repro.core.slq``. Estimates log det(A|_S) of the masked
joint operator restricted to the observed subspace S, using Rademacher probes
drawn inside S (probes stay in S because the operator maps S to itself): the
machinery behind GPyTorch's iterative marginal likelihood [Gardner et al.,
2018], on grid-form (p, n, m) vectors.

Random draws come from an explicit ``torch.Generator``. It gives other bits
than ``jax.random`` from the same seed, so tests hand the reference's probes
across as numpy arrays.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["lanczos", "slq_logdet", "slq_logdet_from_tridiag",
           "tridiag_from_cg", "rademacher_probes"]


def rademacher_probes(gen: torch.Generator, n_probes: int,
                      mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(p, n, m) +-1 probes restricted to the observed subspace, drawn from
    ``gen`` (which must live on ``mask``'s device)."""
    bits = torch.randint(0, 2, (n_probes, *mask.shape), generator=gen,
                         device=mask.device)
    return (2 * bits - 1).to(dtype) * mask


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=(-2, -1))


@torch.no_grad()
def lanczos(A: Callable, v0: torch.Tensor, num_iters: int):
    """Batched Lanczos tridiagonalisation with full reorthogonalisation.

    v0: (p, n, m) initial probes (not necessarily normalised).
    Returns (alphas (p, k), betas (p, k-1)) of the tridiagonal T per probe.
    """
    p, k = v0.shape[0], num_iters
    norm0 = torch.sqrt(_dot(v0, v0))[:, None, None]
    v = v0 / norm0.clamp_min(1e-30)
    V = torch.zeros((k, *v.shape), dtype=v.dtype, device=v.device)
    alphas = torch.zeros((p, k), dtype=v.dtype, device=v.device)
    betas = torch.zeros((p, k), dtype=v.dtype, device=v.device)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((p,), dtype=v.dtype, device=v.device)
    for j in range(k):
        V[j] = v
        w = A(v) - beta_prev[:, None, None] * v_prev
        alpha = _dot(w, v)
        w = w - alpha[:, None, None] * v
        # Full reorthogonalisation against the basis so far (stays in S).
        coeffs = torch.einsum("kpnm,pnm->kp", V[:j + 1], w)
        w = w - torch.einsum("kp,kpnm->pnm", coeffs, V[:j + 1])
        beta = torch.sqrt(_dot(w, w).clamp_min(0.0))
        live = (beta > 1e-12)[:, None, None]
        v_next = torch.where(live, w / beta[:, None, None].clamp_min(1e-30),
                             torch.zeros_like(w))
        alphas[:, j] = alpha
        betas[:, j] = beta
        v_prev, v, beta_prev = v, v_next, beta
    return alphas, betas[:, :k - 1]


def _gauss_quadrature_logdet(diag: torch.Tensor, off: torch.Tensor,
                             subspace_dim) -> torch.Tensor:
    """subspace_dim * mean_p e1^T log(T_p) e1 over (p, k) / (p, k-1)
    tridiagonals, from their eigen-decompositions."""
    T = (torch.diag_embed(diag) + torch.diag_embed(off, 1)
         + torch.diag_embed(off, -1))
    lam, U = torch.linalg.eigh(T)
    lam = lam.clamp_min(1e-30)   # guard breakdown zeros
    quad = (U[..., 0, :] ** 2 * torch.log(lam)).sum(-1)
    return subspace_dim * quad.mean()


def slq_logdet(A: Callable, probes: torch.Tensor, num_iters: int,
               subspace_dim) -> torch.Tensor:
    """log det estimate of A restricted to the probe subspace.

    probes: (p, n, m) Rademacher probes already masked; every probe has
    squared norm == subspace_dim.
    """
    alphas, betas = lanczos(A, probes, num_iters)
    return _gauss_quadrature_logdet(alphas, betas, subspace_dim)


def tridiag_from_cg(cg_alphas: torch.Tensor, cg_betas: torch.Tensor,
                    steps: torch.Tensor):
    """Lanczos tridiagonal (diag, offdiag) from CG step coefficients.

    The Krylov space CG explores from ``b`` is the Lanczos space of
    ``v0 = b/||b||``, and the tridiagonal falls out of the CG (alpha, beta)
    sequences (Saad 2003 §6.7; the mBCG trick of Gardner et al., 2018):

        T[j, j]   = 1/alpha_j + beta_{j-1}/alpha_{j-1}        (beta_{-1}=0)
        T[j, j+1] = sqrt(beta_j) / alpha_j

    ``cg_alphas``/``cg_betas``: (..., k) per-system coefficient arrays;
    ``steps``: (...,) number of valid entries per system. Entries at or
    beyond ``steps`` are padded to an identity block (diag 1, offdiag 0),
    which decouples from e1 and so contributes exactly log(1) = 0.
    """
    k = cg_alphas.shape[-1]
    idx = torch.arange(k, device=cg_alphas.device)
    valid = idx < steps[..., None]
    one = torch.ones((), dtype=cg_alphas.dtype, device=cg_alphas.device)
    safe_a = torch.where(valid & (cg_alphas > 0), cg_alphas, one)
    inv_a = 1.0 / safe_a
    prev_ratio = torch.zeros_like(cg_alphas)
    prev_ratio[..., 1:] = cg_betas[..., :-1] / safe_a[..., :-1]
    diag = torch.where(valid, inv_a + prev_ratio, one)
    # offdiag j couples steps j and j+1; valid only when step j+1 exists.
    off_valid = idx[:-1] < (steps[..., None] - 1)
    off = torch.where(off_valid,
                      torch.sqrt(cg_betas[..., :-1].clamp_min(0.0))
                      * inv_a[..., :-1], torch.zeros_like(inv_a[..., :-1]))
    return diag, off


def slq_logdet_from_tridiag(diag: torch.Tensor, off: torch.Tensor,
                            subspace_dim) -> torch.Tensor:
    """log det estimate from per-probe Lanczos tridiagonals (p, k)/(p, k-1).

    Same Gauss quadrature as :func:`slq_logdet`, but starting from
    tridiagonal coefficients recovered from a (stacked) CG solve: the
    probes' solves and the log-det then share ONE set of operator sweeps.
    Assumes probes with squared norm == subspace_dim (masked Rademacher).
    """
    return _gauss_quadrature_logdet(diag, off, subspace_dim)
