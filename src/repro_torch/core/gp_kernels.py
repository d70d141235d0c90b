"""Stationary GP kernel functions on tensors (dtype-polymorphic).

Counterpart of ``repro.core.gp_kernels``: an RBF-ARD kernel over
hyper-parameters x (one lengthscale per dimension) and Matern-1/2, -3/2,
-5/2 kernels over the learning-curve progression t (scalar lengthscale and
outputscale). All functions take positive parameter values; the caller has
already exponentiated the raw log-space parameters.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "sq_dist",
    "abs_dist",
    "rbf_ard",
    "matern12",
    "matern32",
    "matern52",
    "KERNELS_1D",
]


def sq_dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distance. x1: (n, d), x2: (p, d) -> (n, p).

    Uses the matmul expansion and clamps tiny negatives from cancellation.
    """
    n1 = (x1 * x1).sum(-1)[:, None]
    n2 = (x2 * x2).sum(-1)[None, :]
    d2 = n1 + n2 - 2.0 * (x1 @ x2.T)
    return d2.clamp_min(0.0)


def abs_dist(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """Pairwise absolute distance for 1-D inputs. t1: (n,), t2: (p,) -> (n, p)."""
    return (t1[:, None] - t2[None, :]).abs()


def rbf_ard(x1: torch.Tensor, x2: torch.Tensor, lengthscale: torch.Tensor,
            outputscale=1.0) -> torch.Tensor:
    """k(x, x') = outputscale * exp(-0.5 * sum_d ((x_d - x'_d) / l_d)^2)."""
    z1 = x1 / lengthscale
    z2 = x2 / lengthscale
    return outputscale * torch.exp(-0.5 * sq_dist(z1, z2))


def matern12(t1, t2, lengthscale, outputscale=1.0) -> torch.Tensor:
    """Matern-1/2 (exponential / Ornstein-Uhlenbeck) kernel on 1-D inputs."""
    r = abs_dist(t1, t2) / lengthscale
    return outputscale * torch.exp(-r)


def matern32(t1, t2, lengthscale, outputscale=1.0) -> torch.Tensor:
    r = abs_dist(t1, t2) * (math.sqrt(3.0) / lengthscale)
    return outputscale * (1.0 + r) * torch.exp(-r)


def matern52(t1, t2, lengthscale, outputscale=1.0) -> torch.Tensor:
    r = abs_dist(t1, t2) * (math.sqrt(5.0) / lengthscale)
    return outputscale * (1.0 + r + r * r / 3.0) * torch.exp(-r)


KERNELS_1D = {
    "matern12": matern12,
    "matern32": matern32,
    "matern52": matern52,
}
