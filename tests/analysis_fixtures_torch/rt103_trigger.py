"""Must trigger RT103: host syncs inside Python loops in a torch module."""
import numpy as np
import torch


def solver_loop(step, x0, iters):
    x = x0
    history = []
    for _ in range(iters):
        x = step(x)
        history.append(float(x.mean()))     # sync per iteration
        arr = np.asarray(x)                 # sync per iteration
        torch.cuda.synchronize()            # sync per iteration
    return history, arr
