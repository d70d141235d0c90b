"""Must trigger RT104: float64 where float32 was meant."""
import numpy as np
import torch


def promote(x, values):
    a = torch.zeros(3, dtype=float)            # builtin float: float64
    b = x.to(np.float64)                       # np.float64 as a tensor dtype
    c = torch.as_tensor(np.linspace(0, 1, 5))  # numpy's default float64
    d = torch.from_numpy(np.asarray(values))   # inherits numpy's dtype
    e = np.zeros(3).astype(float)              # builtin float
    return a, b, c, d, e
