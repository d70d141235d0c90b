"""Must NOT trigger RT103: syncs outside loops, a suppressed designed read."""
import torch


def solve(step, x0, iters):
    x = x0
    for _ in range(iters):
        x = step(x)
    return float(x.mean())          # one sync, outside any loop


def stepper(step, x0, iters):
    x = x0
    for _ in range(iters):
        x = step(x)
        if not x.any().item():  # lint: disable=RT103 (the one read a pass)
            break
    for v in x.tolist():            # the iterable is read once
        print(v)
    return x
