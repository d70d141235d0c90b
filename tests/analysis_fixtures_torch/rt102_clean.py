"""Must NOT trigger RT102: decisions on the device or on host values."""
import torch


def solve(A, b, iters, M=None):
    x = torch.zeros_like(b)
    for i in range(iters):
        r = b - A(x)
        if M is None:                            # static test
            step = r
        else:
            step = M(r)
        x = torch.where(torch.isfinite(step), x + step, x)   # on the device
        if isinstance(step, torch.Tensor) and i > 3:          # host values
            x = x * 1
        if torch.cuda.is_available():            # a host value
            x = x + 0
    if torch.linalg.norm(x) > 1:                 # outside any loop: one read
        x = x / torch.linalg.norm(x)
    return x
