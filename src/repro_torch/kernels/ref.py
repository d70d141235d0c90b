"""Plain tensor oracles for the kernels (used by tests and for CPU tensors)."""
from __future__ import annotations

from ..core.gp_kernels import rbf_ard
from ..core.mvm import lk_mvm

__all__ = ["lk_mvm_ref", "rbf_gram_ref"]


def lk_mvm_ref(K1, K2, mask, u, noise=0.0):
    """out = mask * (K1 @ (mask*u) @ K2) + noise * (mask*u), in u's dtype."""
    return lk_mvm(K1, K2, mask, u, noise)


def rbf_gram_ref(x1, x2, lengthscale, outputscale=1.0):
    return rbf_ard(x1, x2, lengthscale, outputscale)
