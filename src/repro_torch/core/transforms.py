"""Input / output transformations (paper App. B).

Counterpart of ``repro.core.transforms``:

* x in R^d  -> unit hypercube via per-dimension min/max of the training data.
* t         -> log t, shifted/scaled so [t_1, t_m] maps to [0, 1].
* Y         -> subtract max(Y_observed), divide by std over observed elements.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["XTransform", "TTransform", "YTransform"]


class XTransform(NamedTuple):
    lo: torch.Tensor  # (d,)
    hi: torch.Tensor  # (d,)

    @staticmethod
    def fit(X: torch.Tensor) -> "XTransform":
        lo = X.min(dim=0).values
        hi = X.max(dim=0).values
        # Constant dimensions map to 0.5 instead of dividing by zero.
        hi = torch.where(hi == lo, lo + 1.0, hi)
        return XTransform(lo=lo, hi=hi)

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        return (X - self.lo) / (self.hi - self.lo)


class TTransform(NamedTuple):
    log_t1: torch.Tensor
    log_tm: torch.Tensor

    @staticmethod
    def fit(t: torch.Tensor) -> "TTransform":
        lt = torch.log(t)
        lo, hi = lt[0], lt[-1]
        hi = torch.where(hi == lo, lo + 1.0, hi)
        return TTransform(log_t1=lo, log_tm=hi)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return (torch.log(t) - self.log_t1) / (self.log_tm - self.log_t1)


class YTransform(NamedTuple):
    shift: torch.Tensor  # max over observed values
    scale: torch.Tensor  # std over observed values

    @staticmethod
    def fit(Y: torch.Tensor, mask: torch.Tensor) -> "YTransform":
        big_neg = torch.full_like(Y, -torch.inf)
        shift = torch.where(mask > 0, Y, big_neg).max()
        cnt = mask.sum()
        mean = (Y * mask).sum() / cnt
        var = (mask * (Y - mean) ** 2).sum() / cnt
        scale = torch.sqrt(var.clamp_min(1e-12))
        return YTransform(shift=shift, scale=scale)

    def __call__(self, Y: torch.Tensor) -> torch.Tensor:
        return (Y - self.shift) / self.scale

    def inverse(self, Z: torch.Tensor) -> torch.Tensor:
        return Z * self.scale + self.shift

    def inverse_var(self, V: torch.Tensor) -> torch.Tensor:
        return V * self.scale**2
