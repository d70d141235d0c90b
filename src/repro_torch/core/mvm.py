"""Latent-Kronecker matrix-vector multiplication (the paper's core primitive).

Counterpart of ``repro.core.mvm``. The latent grid is (n configs) x
(m progressions). A vector in the observed subspace is stored in *grid* form:
an (n, m) tensor that is zero at unobserved cells (``mask`` is 1.0 where
observed). The projection P of the paper is slice indexing (grid -> packed)
and P^T is zero padding (packed -> grid); neither is materialised.

The masked joint operator (K_joint + sigma^2 I) applied to a grid vector is

    A(u) = mask * (K1 @ (mask * u) @ K2) + sigma^2 * (mask * u)   (K2 symmetric)

at O(n^2 m + n m^2) time and O(nm) space (Section 2 of the paper).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

__all__ = [
    "lk_mvm",
    "lk_operator",
    "packed_to_grid",
    "grid_to_packed",
    "kron_dense",
    "joint_cov_packed",
]


def lk_mvm(K1: torch.Tensor, K2: torch.Tensor, mask: torch.Tensor,
           u: torch.Tensor, noise=0.0) -> torch.Tensor:
    """Apply A(u) = mask * (K1 @ (mask*u) @ K2) + noise * (mask*u).

    u may have leading batch dimensions: (..., n, m). The inner ``mask*u`` is
    a no-op for vectors already in the subspace but keeps the operator
    symmetric-PSD on the full grid space, which the iterative solvers rely on.
    """
    um = u * mask
    t = um @ K2
    s = K1 @ t
    return mask * s + noise * um


def lk_operator(K1, K2, mask, noise):
    """Partial application returning ``A(u)`` for the CG solver."""
    return partial(lk_mvm, K1, K2, mask, noise=noise)


def _observed_index(mask) -> np.ndarray:
    mask_np = mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor) \
        else np.asarray(mask)
    return np.flatnonzero(mask_np.ravel())


def grid_to_packed(grid: torch.Tensor, mask) -> torch.Tensor:
    """P: select observed entries. Only used by the O(N^3) reference paths."""
    idx = torch.as_tensor(_observed_index(mask), device=grid.device)
    return grid.reshape(*grid.shape[:-2], -1)[..., idx]


def packed_to_grid(packed: torch.Tensor, mask) -> torch.Tensor:
    """P^T: zero padding back onto the latent grid."""
    idx = torch.as_tensor(_observed_index(mask), device=packed.device)
    shape = tuple(mask.shape)
    flat = packed.new_zeros((*packed.shape[:-1], shape[0] * shape[1]))
    flat[..., idx] = packed
    return flat.reshape(*packed.shape[:-1], *shape)


def kron_dense(K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    """Dense Kronecker product (naive baseline only; O(n^2 m^2) memory)."""
    n, m = K1.shape[0], K2.shape[0]
    return (K1[:, None, :, None] * K2[None, :, None, :]).reshape(n * m, n * m)


def masked_dense(K1: torch.Tensor, K2: torch.Tensor, mask: torch.Tensor,
                 noise) -> torch.Tensor:
    """The dense (nm, nm) matrix of ``A`` on the whole grid: unobserved rows
    and columns zeroed and a unit diagonal there, so its Cholesky is the
    observed block's (the dense engine, the exact MLL and the guarded
    solves' dense fallback all factor it)."""
    mv = mask.reshape(-1)
    K = kron_dense(K1, K2) * (mv[:, None] * mv[None, :])
    return K + torch.diag(noise * mv + (1.0 - mv))


def joint_cov_packed(K1: torch.Tensor, K2: torch.Tensor, mask) -> torch.Tensor:
    """K_joint = P (K1 (x) K2) P^T for the naive Cholesky baseline."""
    idx = torch.as_tensor(_observed_index(mask), device=K1.device)
    full = kron_dense(K1, K2)
    return full[idx][:, idx]
