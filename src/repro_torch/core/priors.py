"""Hyper-parameter priors (paper App. B), on tensors.

Counterpart of ``repro.core.priors``. Parameters are optimised in log space
(raw = log value). A LogNormal(mu, s) prior on a positive parameter is a
Normal(mu, s) density on its log, which is what is evaluated on the raw
parameter.

* x lengthscales: LogNormal(sqrt(2) + 0.5 log d, sqrt(3))   [Hvarfner et al.]
* noise variance: LogNormal(-4, 1)
* t lengthscale / outputscale: no prior.
"""
from __future__ import annotations

import math

import torch

__all__ = ["normal_logpdf", "x_lengthscale_prior_logpdf", "noise_prior_logpdf"]

_LOG_2PI = math.log(2.0 * math.pi)


def normal_logpdf(x: torch.Tensor, mu: float, sigma: float) -> torch.Tensor:
    z = (x - mu) / sigma
    return -0.5 * (z * z + _LOG_2PI) - math.log(sigma)


def x_lengthscale_prior_logpdf(raw_lengthscale: torch.Tensor,
                               d: int) -> torch.Tensor:
    mu = math.sqrt(2.0) + 0.5 * math.log(d)
    return normal_logpdf(raw_lengthscale, mu, math.sqrt(3.0)).sum()


def noise_prior_logpdf(raw_noise: torch.Tensor) -> torch.Tensor:
    return normal_logpdf(raw_noise, -4.0, 1.0).sum()
