"""Self-supervised amortizer training on synthetic task streams (counterpart
of ``repro.amortize.train``).

The loss needs NO ground-truth hyper-parameters: for every sampled task the
encoder predicts LKGP parameters and is scored by the same per-observation
negative penalised marginal likelihood ``fit`` optimises,
``-(MLL + log prior) / n_obs`` through the exact Cholesky MLL
(:func:`repro_torch.core.engines.mll_cholesky`), differentiated by
autograd. Every step draws a fresh batch of tasks from the LCBench-like
prior with randomized regimes, applies the per-task transforms ``fit``
applies, and takes one step of :func:`repro_torch.train.trainer
.make_train_step`. The reference maps the per-task loss over the tasks with
``vmap``; here the encoder runs on all tasks of the batch at once
(:func:`~repro_torch.amortize.encoder.forward_tasks`) and the Cholesky MLL
task by task.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..baselines.pretrain import to_device
from ..core.engines import mll_cholesky
from ..core.state import LKGPConfig, _unflatten_params, log_prior
from ..core.transforms import TTransform, XTransform, YTransform
from ..data.curves import sample_suite, stack_suite
from ..models.transformer import table_logical
from ..train.optimizers import OptConfig
from ..train.trainer import make_train_step
from .encoder import (Amortizer, AmortizerConfig, forward, forward_tasks,
                      init_amortizer, param_table)

__all__ = ["AmortizeTrainConfig", "AmortizerModel", "build_amortizer_model",
           "sample_amortize_batch", "train_amortizer"]


@dataclass(frozen=True)
class AmortizeTrainConfig:
    steps: int = 400
    tasks_per_step: int = 8
    n: int = 8                 # configs per task
    m: int = 9                 # epochs per task
    seed: int = 0
    peak_lr: float = 1e-3
    prefix_lo: float = 0.15    # observed-fraction window (uniform per curve)
    prefix_hi: float = 0.9
    log_every: int = 50


class AmortizerModel(NamedTuple):
    """The model shape :func:`make_train_step` takes."""
    cfg: AmortizerConfig
    param_table: dict
    logical: dict
    init: Callable
    loss: Callable
    predict: Callable


def build_amortizer_model(acfg: AmortizerConfig,
                          gp_cfg: LKGPConfig | None = None) -> AmortizerModel:
    """The trainable model; ``gp_cfg`` fixes the MLL's kernel and jitter so
    training optimises the objective surface ``fit`` will polish on."""
    gp = gp_cfg or LKGPConfig()
    table = param_table(acfg)

    def loss(params, batch):
        flats = forward_tasks(params, batch["Xn"], batch["tn"], batch["Yn"],
                              batch["mask"], acfg)
        per_task = []
        for i in range(flats.shape[0]):
            p = _unflatten_params(flats[i], acfg.d)
            Xn, tn, Yn, mask = (batch[k][i] for k in ("Xn", "tn", "Yn",
                                                      "mask"))
            n_obs = torch.clamp_min(torch.sum(mask), 1.0)
            mll = mll_cholesky(p, Xn, tn, Yn, mask, gp.t_kernel, gp.jitter)
            per_task.append(-(mll + log_prior(p, acfg.d)) / n_obs)
        return torch.mean(torch.stack(per_task))

    return AmortizerModel(
        cfg=acfg, param_table=table, logical=table_logical(table),
        init=lambda generator: init_amortizer(generator, acfg),
        loss=loss,
        predict=lambda p, Xn, tn, Yn, mask: forward(p, Xn, tn, Yn, mask,
                                                    acfg))


def sample_amortize_batch(acfg: AmortizerConfig, cfg: AmortizeTrainConfig,
                          step: int) -> dict:
    """One batch of TRANSFORMED tasks, all regimes randomized, as float32
    numpy arrays. The transforms are fitted per task in float64 exactly as
    ``fit`` fits them, so the encoder trains on the distribution it is
    queried on."""
    rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
    tasks = sample_suite(
        int(rng.integers(0, 2**31 - 1)), cfg.tasks_per_step,
        n=cfg.n, m=cfg.m, d=acfg.d,
        observed_fraction=(cfg.prefix_lo, cfg.prefix_hi),
        noise=float(rng.uniform(0.003, 0.03)),
        spike_prob=float(rng.uniform(0.0, 0.08)),
        diverge_prob=float(rng.uniform(0.0, 0.08)),
        crossing=bool(rng.random() < 0.5))
    X, t, Y, mask, _ = stack_suite(tasks)
    B = cfg.tasks_per_step
    dt = np.float32
    Xn = np.empty((B, cfg.n, acfg.d), dt)
    Yn = np.empty((B, cfg.n, cfg.m), dt)
    tn = np.empty((B, cfg.m), dt)
    for b in range(B):
        Xb = torch.from_numpy(X[b])
        tb = torch.as_tensor(t, dtype=Xb.dtype)
        Yb = torch.as_tensor(Y[b], dtype=Xb.dtype)
        mb = torch.as_tensor(mask[b], dtype=Xb.dtype)
        Yb = torch.where(mb > 0, Yb, torch.zeros_like(Yb))
        # CPU tensors made from the numpy inputs: no device read
        Xn[b] = XTransform.fit(Xb)(Xb).numpy()  # lint: disable=RT103 (CPU)
        tn[b] = TTransform.fit(tb)(tb).numpy()  # lint: disable=RT103 (CPU)
        Yn[b] = YTransform.fit(Yb, mb)(Yb).numpy()  # lint: disable=RT103 (CPU)
    return {"Xn": Xn, "tn": tn, "Yn": Yn, "mask": mask.astype(dt)}


def train_amortizer(acfg: AmortizerConfig | None = None,
                    cfg: AmortizeTrainConfig | None = None,
                    gp_cfg: LKGPConfig | None = None,
                    opt_cfg: OptConfig | None = None, device=None,
                    out: Any = print):
    """Train an amortizer from scratch on ``device`` (``None``: the GPU);
    returns ``(Amortizer, info)``."""
    acfg = acfg or AmortizerConfig()
    cfg = cfg or AmortizeTrainConfig()
    model = build_amortizer_model(acfg, gp_cfg)
    opt = opt_cfg or OptConfig(peak_lr=cfg.peak_lr,
                               warmup_steps=max(5, cfg.steps // 20),
                               decay_steps=cfg.steps)
    setup = make_train_step(model, opt_cfg=opt, device=device)
    t0 = time.time()
    state = setup.init_state(cfg.seed)
    losses = []
    for step in range(cfg.steps):
        batch = to_device(sample_amortize_batch(acfg, cfg, step),
                          setup.device)
        state, metrics = setup.step_fn(state, batch)
        # Keep the device scalar: a host read here would wait on the card
        # every step.
        losses.append(metrics["loss"])
        if cfg.log_every and (step + 1) % cfg.log_every == 0:
            recent = torch.stack(losses[-cfg.log_every:]).mean()
            recent = recent.item()  # lint: disable=RT103 (a log line)
            out(f"amortize step {step + 1:5d}  obj {recent:.4f}")
    losses = torch.stack(losses).cpu().numpy()
    info = {
        "steps": cfg.steps,
        "train_s": round(time.time() - t0, 3),
        "first_loss": round(float(np.mean(losses[:20])), 5),
        "final_loss": round(float(np.mean(losses[-20:])), 5),
    }
    return Amortizer(acfg, state.params), info
