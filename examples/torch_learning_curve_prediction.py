"""Fig. 1 on the PyTorch/CUDA port: posterior samples over learning-curve
continuations.

    PYTHONPATH=src python examples/torch_learning_curve_prediction.py
    PYTHONPATH=src python examples/torch_learning_curve_prediction.py --device cpu

Fits the LKGP to 16 partially observed curves and draws Matheron posterior
samples; prints an ASCII panel per curve showing the observed prefix, the
posterior band and the ground-truth continuation. The same task,
configuration and assertion as ``examples/learning_curve_prediction.py``;
the draws come from a ``torch.Generator`` (seed 0) on the device.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import LKGPConfig, fit, posterior
from repro_torch.data import sample_task


def ascii_panel(t, y_obs, mask, samples, y_true, width=64, height=12):
    lo = min(float(np.min(samples)), float(np.min(y_true))) - 0.02
    hi = max(float(np.max(samples)), float(np.max(y_true))) + 0.02
    grid = [[" "] * width for _ in range(height)]
    m = len(t)
    q05, q95 = np.quantile(samples, [0.05, 0.95], axis=0)

    def put(x, y, ch):
        col = int(x / (m - 1) * (width - 1))
        row = height - 1 - int((y - lo) / (hi - lo) * (height - 1))
        row = min(max(row, 0), height - 1)
        grid[row][col] = ch

    for j in range(m):
        for q in np.linspace(q05[j], q95[j], 6):
            put(j, q, ".")
    for j in range(m):
        if mask[j] > 0:
            put(j, y_obs[j], "#")           # observed
        else:
            put(j, y_true[j], "o")          # ground-truth continuation
    return "\n".join("".join(r) for r in grid)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    task = sample_task(seed=3, n=16, m=20, d=7,
                       observed_fraction=(0.15, 0.85))
    state = fit(task.X, task.t, task.Y, task.mask,
                LKGPConfig(lbfgs_iters=50, posterior_samples=128), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    samples = posterior(state, device=dev).samples(gen).cpu().numpy()

    inside = []
    show = [int(np.argmax(task.mask.sum(1))), int(np.argmin(task.mask.sum(1)))]
    for i in range(task.Y.shape[0]):
        s = samples[:, i, :]
        q02, q98 = np.quantile(s, [0.02, 0.98], axis=0)
        unobs = task.mask[i] == 0
        if unobs.any():
            frac = np.mean((task.Y_full[i, unobs] >= q02[unobs])
                           & (task.Y_full[i, unobs] <= q98[unobs]))
            inside.append(frac)
        if i in show:
            kind = "long prefix" if i == show[0] else "short prefix"
            print(f"\ncurve {i} ({kind}, {int(task.mask[i].sum())}/20 epochs "
                  f"observed)  [#=observed o=truth .=posterior band]")
            print(ascii_panel(task.t, task.Y_full[i], task.mask[i], s,
                              task.Y_full[i]))
    cov = float(np.mean(inside))
    print(f"\nground-truth continuations inside 2-98% posterior band: "
          f"{cov:.0%} (Fig 1 claim: spread covers the truth)")
    assert cov > 0.75, cov


if __name__ == "__main__":
    main()
