"""Transformer learning-curve baseline against the LKGP on the PyTorch/CUDA
port.

Pre-trains a small amortized curve-prediction transformer on streams of
synthetic tasks, then scores it head to head against the LKGP on held-out
tasks at three observation cutoffs: the paper's "our GP model can match the
performance of a Transformer" experiment at demo scale.

    PYTHONPATH=src python examples/torch_transformer_baseline.py               # the GPU
    PYTHONPATH=src python examples/torch_transformer_baseline.py --device cpu

The same configuration, tasks and assertion as
``examples/transformer_baseline.py``, through ``repro_torch``.
"""
import argparse

import numpy as np

from repro_torch.baselines import (CurveTransformerConfig, PretrainConfig,
                                   head_to_head, pretrain)
from repro_torch.core import LKGPConfig
from repro_torch.data import sample_suite


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()

    model_cfg = CurveTransformerConfig(d_model=32, num_layers=2,
                                       num_heads=2, d_ff=64)
    pre_cfg = PretrainConfig(steps=150, tasks_per_step=4, n=10, m=9,
                             log_every=50)
    print(f"pre-training ({pre_cfg.steps} steps on streamed synthetic "
          f"tasks, curriculum over observed-prefix fraction)...")
    params, info = pretrain(model_cfg, pre_cfg, device=args.device)
    print(f"pretrain nll {info['first_loss']} -> {info['final_loss']} "
          f"in {info['train_s']}s\n")

    tasks = sample_suite(777, 2, n=10, m=9, d=7, crossing=True)
    rows = head_to_head(params, model_cfg, tasks, cutoffs=(0.2, 0.4, 0.7),
                        gp_cfg=LKGPConfig(lbfgs_iters=30), seed=0,
                        device=args.device)

    print("model       | cutoff | NLL     | MAE    | rank corr | fit+pred s")
    for model in ("lkgp", "transformer"):
        for cut in (0.2, 0.4, 0.7):
            sel = [r for r in rows
                   if r["model"] == model and r["cutoff"] == cut]
            nll = np.mean([r["nll"] for r in sel])
            mae = np.mean([r["mae"] for r in sel])
            rho = np.mean([r["rank_corr"] for r in sel])
            sec = np.mean([r["fit_s"] + r["predict_s"] for r in sel])
            print(f"{model:11s} |  {cut:.1f}   | {nll:7.3f} | {mae:.4f} | "
                  f"{rho:9.3f} | {sec:.2f}")

    lk = np.mean([r["mae"] for r in rows if r["model"] == "lkgp"])
    tf = np.mean([r["mae"] for r in rows if r["model"] == "transformer"])
    print(f"\nmean MAE: lkgp {lk:.4f} vs transformer {tf:.4f} "
          f"(amortized over the exact task prior)")
    assert np.isfinite(lk) and np.isfinite(tf)
    return rows


if __name__ == "__main__":
    main()
