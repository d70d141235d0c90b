"""Must NOT trigger RT101: one generator drawn twice, distinct seeds."""
import numpy as np
import torch


def draws(cfg):
    gen = torch.Generator().manual_seed(cfg.seed)
    return torch.randn(3, generator=gen), torch.rand(3, generator=gen)


def offsets(cfg):
    a = torch.Generator().manual_seed(cfg.seed + 1)
    b = torch.Generator().manual_seed(cfg.seed + 2)
    return a, b


def mixed(seed):
    torch.manual_seed(seed)
    return np.random.default_rng(seed)   # another PRNG: no shared stream
