"""Training driver: config -> restore-or-init -> step loop, on one device
or a device mesh (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_1b6 \
        --smoke --steps 20 --ckpt-dir /tmp/ckpt --ckpt-every 10

Fault tolerance: atomic keep-K checkpoints (async), deterministic data keyed
by step (a run resumed at step k trains on exactly the batches an
uninterrupted run would have), and ``--simulate-preempt N`` kills the
process at step N to exercise the restart. The step updates the state in
place (``make_train_step(donate=True)``), as the reference's launcher
donates its state: the loop never reads a state it has passed on, and a
checkpoint copies the state to the host before the next step. The step's
loss stays on the device inside the loop and is read once at the end (and
at each log line). A VLM config gets zero float32 patch embeddings as its
prefix, and the encoder-decoder zero float32 frames, as the reference's
launcher gives them.

``--mesh`` picks the device mesh (``launch/mesh.py``) over the process
group the environment names (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and
``--dist-init``, default ``$DIST_INIT_METHOD``): NCCL with each rank on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``::

    for r in 0 1 2 3; do WORLD_SIZE=4 RANK=$r LOCAL_RANK=$r \
        DIST_INIT_METHOD=file:///tmp/rdv PYTHONPATH=src \
        python -m repro_torch.launch.train --arch stablelm_12b --smoke \
        --mesh debug --device cpu --steps 8 & done; wait

``debug`` is (world / 2, 2) over ("data", "model"), or (world, 1) for an
odd world; ``single`` / ``multi`` are the production meshes, which name
the ranks they need when the world does not fit. Without a group
``debug`` runs on one device. On a mesh the state is placed by
``rules_for`` (``make_train_step(mesh=...)``), the step cuts the batch by
its ``batch_shardings``, and a checkpoint holds every leaf's whole value
(written by rank 0), so a run resumes on any mesh or on one device. Only
rank 0 prints, since every rank has the same losses.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import TokenPipeline
from ..models import build_model
from ..train.optimizers import OptConfig
from ..train.trainer import TrainState, make_train_step
from .mesh import make_mesh_from_args
from .serve import init_process_group_from_env

__all__ = ["TrainResult", "main"]


class TrainResult(NamedTuple):
    losses: list            # one float per step this run took
    start_step: int         # the step the run started (or resumed) at
    first_step_ms: float    # the first step of this run, set-up included
    ms_per_step: float      # the mean of the later steps (nan with one step)
    state: TrainState       # the final state, on the device (or the mesh)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--mesh", default="debug",
                    choices=["debug", "single", "multi"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--simulate-preempt", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--dist-init", default=os.environ.get("DIST_INIT_METHOD"),
                    help="init method of the process group that WORLD_SIZE "
                         "names (e.g. file:///tmp/rdv)")
    ap.add_argument("--metrics-out", default="",
                    help="write this run's start step and every loss, in "
                         "full precision, as JSON (rank 0)")
    args = ap.parse_args(argv)

    owned = not dist.is_initialized()
    device = init_process_group_from_env(args.device, args.dist_init)
    try:
        return _train(args, device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, device) -> TrainResult:
    mesh = make_mesh_from_args(args)
    lead = mesh is None or dist.get_rank() == 0

    def say(*a, **k):
        if lead:
            print(*a, **k)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    dev = resolve_device(device)
    opt = OptConfig(name=args.optimizer, peak_lr=args.lr,
                    warmup_steps=max(2, args.steps // 20),
                    decay_steps=args.steps)
    setup = make_train_step(model, opt_cfg=opt, grad_accum=args.grad_accum,
                            device=dev, donate=True, mesh=mesh)

    ckpt = CheckpointManager(args.ckpt_dir, keep=args.keep, mesh=mesh) \
        if args.ckpt_dir else None
    start_step = 0
    state = setup.init_state(0)
    if ckpt and ckpt.latest_step() is not None:
        state = ckpt.restore(state, shardings=setup.state_shardings)
        start_step = int(state.step)
        say(f"restored checkpoint at step {start_step}", flush=True)

    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq)
    losses = []
    first_step_ms = ms_per_step = float("nan")
    _sync(dev)
    t_start = t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        tokens, labels = pipe.batch_at(step)
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        if cfg.family in ("audio", "encdec"):
            batch["frames"] = torch.zeros(
                (args.batch, cfg.enc_frames, cfg.d_model),
                dtype=torch.float32, device=dev)
        if cfg.family == "vlm":
            batch["prefix_embeds"] = torch.zeros(
                (args.batch, cfg.num_patch_tokens, cfg.d_model),
                dtype=torch.float32, device=dev)
        state, metrics = setup.step_fn(state, batch)
        # A device scalar: reading it here would wait for the device every
        # step. Read in bulk after the loop.
        losses.append(metrics["loss"])
        if step == start_step:
            _sync(dev)
            t_first = time.perf_counter()
            first_step_ms = (t_first - t_start) * 1e3
        if (step + 1) % args.log_every == 0:
            dt = (time.perf_counter() - t0) / args.log_every
            loss = float(losses[-1])  # lint: disable=RT103 (a log line)
            say(f"step {step+1:5d} loss {loss:.4f} "
                f"({dt*1e3:.0f} ms/step)", flush=True)
            t0 = time.perf_counter()
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
        if args.simulate_preempt == step + 1:
            say(f"SIMULATED PREEMPTION at step {step+1}", flush=True)
            if ckpt:
                ckpt.wait()
            os._exit(42)
    _sync(dev)
    if len(losses) > 1:
        ms_per_step = (time.perf_counter() - t_first) * 1e3 / (len(losses)
                                                              - 1)
    if ckpt:
        ckpt.save(args.steps, state)
        ckpt.wait()
    losses = [float(x) for x in losses]
    if losses:
        say(f"final loss: {losses[-1]:.4f} (first: {losses[0]:.4f})")
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            json.dump({"start_step": start_step, "losses": losses}, f)
    return TrainResult(losses=losses, start_step=start_step,
                       first_step_ms=first_step_ms, ms_per_step=ms_per_step,
                       state=state)


if __name__ == "__main__":
    main()
