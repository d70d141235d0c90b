"""Must NOT trigger RT104: named dtypes, float64 where it is meant."""
import numpy as np
import torch


def explicit(x, values):
    a = torch.zeros(3, dtype=torch.float32)
    b = x.to(torch.float64)                              # named: meant
    c = torch.as_tensor(np.linspace(0, 1, 5), dtype=torch.float32)
    d = torch.from_numpy(np.asarray(values, np.float32))
    e = np.zeros(3, dtype=np.float64)                    # numpy on the host
    f = torch.tensor(np.arange(4).astype(np.float32))
    return a, b, c, d, e, f
