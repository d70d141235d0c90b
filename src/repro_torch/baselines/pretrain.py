"""Amortized pre-training of the curve transformer on synthetic task streams
(counterpart of ``repro.baselines.pretrain``).

Every step samples a fresh batch of tasks from the LCBench-like prior
(:func:`repro_torch.data.curves.sample_suite`) with randomized regimes
(noise level, spike probability, divergent-curve fraction, the ``crossing``
family), flattens them into curves, and takes one optimizer step on the
weighted Gaussian NLL. The observed-prefix fraction follows a curriculum:
early steps see mostly complete curves, then the floor anneals down so late
training is dominated by the short-prefix extrapolation the evaluation
scores. The batches are host numpy, equal to the reference's bit for bit;
the step is :func:`repro_torch.train.trainer.make_train_step` on one device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..data.curves import sample_suite, stack_suite
from ..train.optimizers import OptConfig
from ..train.trainer import make_train_step
from .curve_transformer import (CurveTransformerConfig, build_curve_model,
                                normalize_t)

__all__ = ["PretrainConfig", "sample_stream_batch", "pretrain"]


@dataclass(frozen=True)
class PretrainConfig:
    steps: int = 1500
    tasks_per_step: int = 6
    n: int = 12                # configs per task
    m: int = 12                # epochs per task (fixed per pretrain run)
    d: int = 7
    # Optional explicit progression grid (a tuple, so the config hashes;
    # positive, strictly increasing, len == m), e.g. a real dataset's budget
    # grid; None keeps epochs 1..m.
    t: tuple | None = None
    seed: int = 0
    # Curriculum: the lower bound of the observed-prefix fraction anneals
    # from floor_start to floor_end over the first curriculum_frac of steps.
    prefix_floor_start: float = 0.5
    prefix_floor_end: float = 0.05
    prefix_cap: float = 0.95
    curriculum_frac: float = 0.6
    peak_lr: float = 3e-3
    log_every: int = 200


def _prefix_floor(cfg: PretrainConfig, step: int) -> float:
    prog = min(1.0, step / max(1.0, cfg.curriculum_frac * cfg.steps))
    return (cfg.prefix_floor_start
            + (cfg.prefix_floor_end - cfg.prefix_floor_start) * prog)


def sample_stream_batch(cfg: PretrainConfig, step: int) -> dict:
    """One training batch of flattened curves, all regimes randomized, as
    float32 numpy arrays (``t_norm`` (m,), the rest (tasks * n, ...))."""
    rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
    floor = _prefix_floor(cfg, step)
    tasks = sample_suite(
        int(rng.integers(0, 2**31 - 1)), cfg.tasks_per_step,
        n=cfg.n, m=cfg.m, d=cfg.d,
        t=None if cfg.t is None else np.asarray(cfg.t, np.float64),
        observed_fraction=(floor, cfg.prefix_cap),
        noise=float(rng.uniform(0.003, 0.03)),
        spike_prob=float(rng.uniform(0.0, 0.08)),
        diverge_prob=float(rng.uniform(0.0, 0.08)),
        crossing=bool(rng.random() < 0.5))
    X, t, Y, mask, Y_full = stack_suite(tasks)
    B = cfg.tasks_per_step * cfg.n
    return {
        "hp": X.reshape(B, cfg.d).astype(np.float32),
        "y": Y.reshape(B, cfg.m).astype(np.float32),
        "mask": mask.reshape(B, cfg.m).astype(np.float32),
        "target": Y_full.reshape(B, cfg.m).astype(np.float32),
        "t_norm": normalize_t(t),
    }


def to_device(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def pretrain(model_cfg: CurveTransformerConfig,
             cfg: PretrainConfig | None = None,
             opt_cfg: OptConfig | None = None, device=None, out=print):
    """Pre-train the curve transformer on ``device`` (``None``: the GPU);
    returns (params, info). ``info`` has the steps, the seconds, and the
    mean loss of the first and of the last 20 steps."""
    cfg = cfg or PretrainConfig()
    model = build_curve_model(model_cfg)
    opt = opt_cfg or OptConfig(peak_lr=cfg.peak_lr,
                               warmup_steps=max(5, cfg.steps // 20),
                               decay_steps=cfg.steps)
    setup = make_train_step(model, opt_cfg=opt, device=device)
    t0 = time.time()
    state = setup.init_state(cfg.seed)
    losses = []
    for step in range(cfg.steps):
        batch = to_device(sample_stream_batch(cfg, step), setup.device)
        state, metrics = setup.step_fn(state, batch)
        # Keep the device scalar: a host read here would wait on the card
        # every step.
        losses.append(metrics["loss"])
        if cfg.log_every and (step + 1) % cfg.log_every == 0:
            recent = torch.stack(losses[-cfg.log_every:]).mean()
            recent = recent.item()  # lint: disable=RT103 (a log line)
            out(f"pretrain step {step + 1:5d}  nll {recent:.4f}  "
                f"prefix_floor {_prefix_floor(cfg, step):.2f}")
    losses = torch.stack(losses).cpu().numpy()
    info = {
        "steps": cfg.steps,
        "train_s": round(time.time() - t0, 3),
        "first_loss": round(float(np.mean(losses[:20])), 5),
        "final_loss": round(float(np.mean(losses[-20:])), 5),
    }
    return state.params, info
