"""End-to-end driver on the PyTorch/CUDA port: LKGP-driven early stopping
over a pool of REAL LM training runs (the paper's AutoML use case, complete
loop).

    PYTHONPATH=src python examples/torch_automl_early_stopping.py               # the GPU
    PYTHONPATH=src python examples/torch_automl_early_stopping.py --device cpu

The same pool, schedule and assertions as
``examples/automl_early_stopping.py``, through ``repro_torch``: 8
hyper-parameter configurations (learning rate x weight decay) of the reduced
RWKV-6 arch train on the synthetic token pipeline; after every 2 "epochs"
the FreezeThawScheduler folds the new observations into its LKGP state
(``extend`` + warm-started ``refit``) and stops runs predicted to end badly,
reallocating budget. ``--gp-backend cuda`` runs the refits through the
hand-written MVM kernels. The runs' initial parameters come from
``torch.Generator`` seeds, so they differ from the reference's draws.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.autotune import AutotuneConfig, FreezeThawScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.core import LKGPConfig
from repro_torch.data import TokenPipeline
from repro_torch.models import build_model
from repro_torch.train import OptConfig, make_train_step

STEPS_PER_EPOCH = 8
BATCH, SEQ = 8, 32
MAX_EPOCHS = 10
LRS = [1e-5, 3e-3, 1e-3, 3e-4, 1e-2, 3e-2, 3e-5, 1e-4]
WDS = [0.0, 0.1, 0.0, 0.1, 0.0, 0.1, 0.1, 0.0]


class Run:
    """One training run = one hyper-parameter configuration."""

    def __init__(self, idx, lr, wd, device):
        self.cfg = get_smoke_config("rwkv6_1b6")
        self.model = build_model(self.cfg)
        self.device = device
        opt = OptConfig(name="adamw", peak_lr=lr, weight_decay=wd,
                        warmup_steps=4, decay_steps=200)
        self.setup = make_train_step(self.model, opt_cfg=opt, device=device)
        self.state = self.setup.init_state(idx)
        self.pipe = TokenPipeline(self.cfg.vocab_size, BATCH, SEQ, seed=0)
        self.step = 0
        self.eval_batch = self._batch(10_000)
        self.seconds = 0.0       # training and evaluation, device included

    def _batch(self, step):
        tokens, labels = self.pipe.batch_at(step)
        return {"tokens": torch.from_numpy(tokens).to(self.device),
                "labels": torch.from_numpy(labels).to(self.device)}

    def train_one_epoch(self) -> float:
        t0 = time.perf_counter()
        for _ in range(STEPS_PER_EPOCH):
            self.state, _ = self.setup.step_fn(self.state,
                                               self._batch(self.step))
            self.step += 1
        # validation "accuracy" proxy: exp(-eval loss); the one device read
        # of the epoch
        with torch.no_grad():
            loss = self.model.loss(self.state.params, self.eval_batch)
        acc = float(np.exp(-float(loss)))
        self.seconds += time.perf_counter() - t0
        return acc


def run_pool(device=None, gp_backend: str | None = None) -> dict:
    """Train the pool under the scheduler; returns the scheduler's summary
    with the budget, the best observed config and the seconds spent."""
    dev = resolve_device(device)
    gp = LKGPConfig(lbfgs_iters=25) if gp_backend is None else \
        LKGPConfig(lbfgs_iters=25, backend=gp_backend)
    X = np.array([[np.log10(lr), wd] for lr, wd in zip(LRS, WDS)])
    t0 = time.perf_counter()
    runs = [Run(i, lr, wd, dev) for i, (lr, wd) in enumerate(zip(LRS, WDS))]
    sched = FreezeThawScheduler(
        X, [r.train_one_epoch for r in runs],
        AutotuneConfig(max_epochs=MAX_EPOCHS, refit_every=2,
                       min_epochs_before_stop=4, ucb_beta=1.5, gp=gp),
        device=dev)
    full_budget = len(runs) * MAX_EPOCHS
    summary = sched.run(total_epoch_budget=full_budget)
    seconds = time.perf_counter() - t0
    train_seconds = sum(r.seconds for r in runs)
    return dict(summary, full_budget=full_budget,
                best_cfg=int(np.argmax([max(sched.Y[i])
                                        for i in range(len(runs))])),
                seconds=seconds, train_seconds=train_seconds,
                gp_seconds=seconds - train_seconds,
                train_steps=sum(r.step for r in runs), device=str(dev))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--gp-backend", default=None,
                    help="LKGPConfig.backend of the scheduler's model "
                         "(default: LKGPConfig's)")
    args = ap.parse_args()
    print("pool: 8 configs of reduced rwkv6_1b6, "
          f"{STEPS_PER_EPOCH} steps/epoch, batch {BATCH}x{SEQ}")
    out = run_pool(args.device, args.gp_backend)
    full_budget = out["full_budget"]

    print("\nstop events:")
    for ev in out["stop_events"]:
        print(f"  after epoch {ev['epoch']}: stopped {ev['stopped']} "
              f"({ev['active']} remain)")
    print(f"epochs spent: {out['epochs_spent']} / {full_budget} "
          f"(saved {1 - out['epochs_spent']/full_budget:.0%})")
    print(f"survivors: {out['survivors']}")
    print(f"best observed accuracy-proxy: {out['observed_best']:.4f}")
    print(f"on {out['device']}: {out['seconds']:.1f} s, of which training "
          f"{out['train_seconds']:.1f} s ({out['train_steps']} steps), "
          f"LKGP refits {out['gp_seconds']:.1f} s")

    # the scheduler must have kept at least one of the best-LR configs
    if out["best_cfg"] not in out["survivors"]:
        raise AssertionError(
            f"scheduler stopped the best config {out['best_cfg']}")
    if out["epochs_spent"] >= full_budget:
        raise AssertionError("no budget was saved")
    print("\nOK: best config survived; budget saved by early stopping.")


if __name__ == "__main__":
    main()
