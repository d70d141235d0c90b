"""Partial pivoted-Cholesky preconditioner for the latent-Kronecker CG.

Counterpart of ``repro.core.precond``. A rank-r pivoted Cholesky
approximation L_r of the masked latent covariance is built from the
Kronecker factors: entries of K1 (x) K2 are formed lazily as
K1[i1, j1] * K2[i2, j2], so the factorisation costs O(N r^2) time and
O(N r) memory for N cells and never materialises the joint matrix. The
preconditioner is the Woodbury-inverted (L_r L_r^T + sigma^2 I)^{-1},
applied in O(N r) per iteration.

Two factorisation entry points:

* :func:`pivoted_cholesky_latent` - host NumPy over the *packed* observed
  cells (float64; reference / offline use).
* :func:`pivoted_cholesky_grid` - torch over the flattened *grid* cells
  (unobserved cells carry a zero diagonal and are never pivots), on the
  factors' device. It reads nothing back to the host: each pivot is an
  ``argmax`` on the device and its column is taken with ``index_select`` on
  the 0-d index, so building it costs no sync per pivot (the reference runs
  the same loop inside ``jit``). This is what the engines' operators use when
  ``LKGPConfig.precond_rank > 0``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["pivoted_cholesky_latent", "pivoted_cholesky_grid",
           "woodbury_preconditioner"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def pivoted_cholesky_latent(K1, K2, mask, rank: int,
                            jitter: float = 1e-12) -> torch.Tensor:
    """Rank-``rank`` pivoted Cholesky of (P (K1 x K2) P^T) via lazy entries.

    Returns L (N, rank) over the packed observed cells (row-major order of
    ``mask``'s nonzeros), float64, on the CPU: a host-side setup cost, not
    an inner loop. Stops early (fewer columns) when the residual diagonal
    falls to ``jitter``.
    """
    K1 = _host(K1).astype(np.float64)
    K2 = _host(K2).astype(np.float64)
    rows, cols = np.nonzero(_host(mask))
    N = len(rows)
    rank = min(rank, N)

    d = K1[rows, rows] * K2[cols, cols]
    L = np.zeros((N, rank))
    perm = np.arange(N)
    for k in range(rank):
        # pivot: the largest remaining diagonal
        j = k + int(np.argmax(d[perm[k:]]))  # lint: disable=RT103 (numpy)
        perm[[k, j]] = perm[[j, k]]
        p = perm[k]
        pivot = d[p]
        if pivot <= jitter:
            L = L[:, :k]
            break
        lkk = np.sqrt(pivot)
        L[p, k] = lkk
        rest = perm[k + 1:]
        # the lazy row of the joint covariance at the pivot
        row = K1[rows[rest], rows[p]] * K2[cols[rest], cols[p]]
        if k > 0:
            row = row - L[rest, :k] @ L[p, :k]
        L[rest, k] = row / lkk
        d[rest] = d[rest] - L[rest, k] ** 2
    return torch.from_numpy(L)


@torch.no_grad()
def pivoted_cholesky_grid(K1: torch.Tensor, K2: torch.Tensor,
                          mask: torch.Tensor, rank: int,
                          jitter: float = 1e-12) -> torch.Tensor:
    """Rank-``rank`` pivoted Cholesky of the masked latent covariance.

    Works on the flattened (n*m,) grid: the masked joint covariance has the
    diagonal ``mask * diag(K1) (x) diag(K2)``, so unobserved cells carry a
    zero diagonal, are never pivots, and end up with all-zero rows in L:
    the projected operator the solve sees. Each pivot's row is formed
    lazily from the factors (``mask * K1[:, j1] K2[:, j2]^T``), O(nm) per
    step. Returns L (n*m, rank) in K1's dtype on K1's device; if the
    residual diagonal is exhausted before ``rank`` steps, the remaining
    columns are zero (harmless in Woodbury).
    """
    mask = mask.to(K1.dtype)
    n, m = mask.shape
    N = n * m
    dev, dt = K1.device, K1.dtype
    d = (mask * (torch.diagonal(K1)[:, None]
                 * torch.diagonal(K2)[None, :])).reshape(N)
    mask_flat = mask.reshape(N)
    L = torch.zeros((N, rank), dtype=dt, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for k in range(rank):
        dm = torch.where(done, neg_inf, d)
        j = torch.argmax(dm).reshape(1)          # first of equal maxima
        pivot = dm.index_select(0, j)[0]
        valid = pivot > jitter
        lkk = torch.sqrt(torch.clamp(pivot, min=jitter))
        col1 = K1.index_select(1, torch.div(j, m, rounding_mode="floor"))
        col2 = K2.index_select(1, torch.remainder(j, m)).reshape(1, m)
        row = (mask * (col1 * col2)).reshape(N)
        row = row - L @ L.index_select(0, j)[0]
        col = torch.where(done, zero, row / lkk)
        col = col.index_put((j,), lkk.reshape(1))
        col = torch.where(valid, col * mask_flat, zero)
        L[:, k] = col
        d = torch.clamp(d - col * col, min=0.0)
        done = done.index_put((j,), torch.ones((1,), dtype=torch.bool,
                                               device=dev))
    return L


def woodbury_preconditioner(L: torch.Tensor, noise) -> Callable:
    """M^{-1} v for M = L L^T + noise I, via Woodbury in O(N r).

    Returns a function on packed vectors (..., N):
    M^{-1} = I/s - L (s I_r + L^T L)^{-1} L^T / s,  s = noise. One
    (r, r) Cholesky serves every right-hand side.
    """
    r = L.shape[1]
    eye = torch.eye(r, dtype=L.dtype, device=L.device)
    chol = torch.linalg.cholesky(noise * eye + L.T @ L)    # (r, r), SPD

    def apply(v: torch.Tensor) -> torch.Tensor:
        w = torch.einsum("nr,...n->...r", L, v)
        # fold the leading dims into the columns: one factor, every RHS
        z = torch.cholesky_solve(w.reshape(-1, r).T, chol).T.reshape(w.shape)
        return v / noise - torch.einsum("nr,...r->...n", L, z) / noise

    return apply
