"""Must trigger RT102: Python control flow on a tensor inside a loop."""
import torch


def solve(A, b, iters):
    x = torch.zeros_like(b)
    for _ in range(iters):
        r = b - A(x)
        if torch.linalg.norm(r) < 1e-6:      # implicit bool(): a read a step
            break
        x = x + r
    while (x.abs() > 1).any():               # a read a pass
        x = x / 2
    for v in x:
        assert torch.isfinite(v).all()       # a read an element
    return x
