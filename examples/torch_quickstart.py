"""Quickstart on the PyTorch/CUDA port: fit a Latent Kronecker GP to partial
learning curves and predict their continuations.

    PYTHONPATH=src python examples/torch_quickstart.py               # the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The same task, configuration and assertion as ``examples/quickstart.py``,
through ``repro_torch``.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import LKGPConfig, fit, posterior
from repro_torch.data import sample_task


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()

    # 16 hyper-parameter configs, 20 epochs, curves observed partially
    task = sample_task(seed=7, n=16, m=20, d=7)
    print(f"task: X {task.X.shape}, curves {task.Y.shape}, "
          f"{int(task.mask.sum())}/{task.mask.size} values observed")

    state = fit(task.X, task.t, task.Y, task.mask, LKGPConfig(lbfgs_iters=50),
                device=args.device)
    res = state.fit_result
    print(f"fit on {state.device}: {res.n_iters} L-BFGS iters, "
          f"{res.n_evals} evals, objective {res.fun:.4f} "
          f"(backend: {state.backend_used})")
    print(f"learned noise sigma^2 = "
          f"{float(torch.exp(state.params.raw_noise)):.2e}")

    mean, var = posterior(state, device=args.device).final()
    mean, var = mean.cpu().numpy(), var.cpu().numpy()
    truth = task.Y_full[:, -1]
    err = np.abs(mean - truth)
    z = err / np.sqrt(var)
    print("\nconfig | observed | predicted final | true final | |z|")
    for i in range(len(truth)):
        n_obs = int(task.mask[i].sum())
        print(f"  {i:3d}  | {n_obs:2d}/20 ep | {float(mean[i]):.4f}        "
              f"| {truth[i]:.4f}    | {z[i]:.2f}")
    rmse = float(np.sqrt(np.mean(err ** 2)))
    cover = float(np.mean(z < 2.0))
    print(f"\nRMSE(final) = {rmse:.4f};  |z|<2 coverage = {cover:.0%}")
    assert rmse < 0.1, "quickstart regression: rmse too high"


if __name__ == "__main__":
    main()
