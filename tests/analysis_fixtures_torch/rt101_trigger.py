"""Must trigger RT101: one seed expression seeds two generators."""
import numpy as np
import torch


def draws(cfg):
    a = torch.Generator().manual_seed(cfg.seed + 1)
    b = torch.Generator().manual_seed(cfg.seed + 1)   # the stream of a
    return torch.randn(3, generator=a), torch.rand(3, generator=b)


def host(state):
    x = np.random.default_rng(state.config.seed).normal(size=3)
    y = np.random.default_rng(state.config.seed).uniform(size=3)   # x's
    return x, y
