"""Serving entry points: LM decode on one device or a mesh, or the LKGP curve
service (counterpart of ``repro.launch.serve``).

LM mode (default; batched prefill + greedy decode)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_1b6 \
        --smoke --batch 8 --prompt-len 32 --gen 32

prints the prefill's milliseconds, the decode's milliseconds per token and
tokens per second, timed on the host clock around work that ends in
``torch.cuda.synchronize()`` on the card. A VLM config (``llava_next_
mistral_7b``) gets zero float32 patch embeddings as its prefix and the
encoder-decoder (``whisper_tiny``) zero float32 frames, as the reference's
launcher gives them; :func:`serve_lm` is the same loop for a config built by
the caller. Every decode step returns a new cache (the reference donates
its cache instead).

``--mesh`` picks the device mesh (``launch/mesh.py``) over the process
group the environment names: ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and
``--dist-init`` (default ``$DIST_INIT_METHOD``, e.g. ``file:///tmp/rdv``:
no network). NCCL on the card (each rank on ``cuda:LOCAL_RANK``), gloo with
``--device cpu``::

    for r in 0 1 2 3; do WORLD_SIZE=4 RANK=$r LOCAL_RANK=$r \
        DIST_INIT_METHOD=file:///tmp/rdv PYTHONPATH=src \
        python -m repro_torch.launch.serve --arch stablelm_12b --smoke \
        --mesh debug --device cpu & done; wait

``debug`` is (world / 2, 2) over ("data", "model") (one device without a
group), ``single`` / ``multi`` the production meshes, which name the ranks
they need when the world does not fit. On a mesh each rank draws its
blocks of the keyed stream by ``SERVE_RULES``, and the steps run on
``DTensor`` s (``train.trainer.make_serve_steps``); the tokens equal the
one-device serve's.

Curve-prediction mode drives :class:`repro_torch.serving.PredictionService`
- multi-tenant streaming observes with warm refits, coalesced predictions::

    PYTHONPATH=src python -m repro_torch.launch.serve --service curves \
        --tenants 8 --rounds 4

Both run on the GPU unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..configs import get_config, get_smoke_config
from ..models import build_model
from ..distributed.sharding import (SERVE_RULES, full_value, mesh_shape,
                                    param_placer)
from ..train.trainer import make_serve_steps
from .mesh import make_mesh_from_args

__all__ = ["ServeResult", "main", "main_curves", "serve_lm"]


class ServeResult(NamedTuple):
    tokens: np.ndarray          # (batch, gen) generated token ids
    prefill_ms: float
    decode_ms_per_token: float
    tokens_per_s: float
    logits: np.ndarray | None = None   # (batch, vocab) float32, last step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main_curves(args):
    """Streaming LKGP curve-service driver (synthetic tenants)."""
    from ..core import LKGPConfig
    from ..data.curves import sample_task
    from ..serving import PredictionService, ServiceConfig

    svc = PredictionService(ServiceConfig(
        gp=LKGPConfig(lbfgs_iters=args.lbfgs_iters, backend="dense"),
        capacity=max(args.tenants, 1),
        refit_every=args.refit_every), device=args.device)
    tasks = {f"tenant-{i}": sample_task(args.seed + i, n=args.n, m=args.m,
                                        d=4)
             for i in range(args.tenants)}

    # Cold fits, coalesced across tenants into one batched L-BFGS.
    svc.observe_batch([
        dict(tenant=name, task="run", X=task.X, t=task.t,
             Y=task.Y, mask=task.mask)
        for name, task in tasks.items()])

    masks = {name: np.asarray(task.mask).copy()
             for name, task in tasks.items()}
    for rnd in range(args.rounds):
        for name, task in tasks.items():   # reveal one more epoch per curve
            mask = masks[name]
            for i in range(mask.shape[0]):
                k = int(mask[i].sum())  # lint: disable=RT103 (numpy)
                if k < mask.shape[1]:
                    mask[i, k] = 1.0
            Y = np.where(mask > 0, np.asarray(  # lint: disable=RT103 (numpy)
                task.Y_full), 0.0)
            svc.observe(name, "run", Y, mask)
        preds = svc.predict_many([(name, "run") for name in tasks])
        # Prediction.mean is host numpy already: no device read here.
        best = {p.tenant: float(  # lint: disable=RT103 (numpy)
            np.max(p.mean)) for p in preds}
        print(f"round {rnd}: coalesced batch={preds[0].batch_size} "
              f"best-final={max(best.values()):.4f}")

    # Per-request repeats ride the warm state-keyed posterior cache.
    t0 = time.perf_counter()
    for name in tasks:
        svc.predict(name, "run")
    print(f"warm per-request sweep: "
          f"{(time.perf_counter() - t0) / max(len(tasks), 1) * 1e3:.2f} "
          f"ms/req")
    m = svc.metrics()
    print(f"store={m['store']} counters={m['counters']}")
    print(f"predict p50={m['predict_latency']['p50_ms']:.2f} ms "
          f"p99={m['predict_latency']['p99_ms']:.2f} ms")
    return m


def main(argv=None):
    """LM mode returns a :class:`ServeResult`; curve mode the service's
    metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--service", default="lm", choices=["lm", "curves"],
                    help="lm: decode loop (default); curves: LKGP service")
    ap.add_argument("--arch")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mesh", default="debug",
                    choices=["debug", "single", "multi"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--dist-init", default=os.environ.get("DIST_INIT_METHOD"),
                    help="init method of the process group that WORLD_SIZE "
                         "names (e.g. file:///tmp/rdv)")
    # curve-service knobs
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--refit-every", type=int, default=4)
    ap.add_argument("--lbfgs-iters", type=int, default=10)
    args = ap.parse_args(argv)

    if args.service == "curves":
        return main_curves(args)
    if args.arch is None:
        ap.error("--arch is required for --service lm")

    owned = not dist.is_initialized()
    device = init_process_group_from_env(args.device, args.dist_init)
    try:
        mesh = make_mesh_from_args(args)
        cfg = get_smoke_config(args.arch) if args.smoke \
            else get_config(args.arch)
        res = serve_lm(cfg, args.batch, args.prompt_len, args.gen, args.seed,
                       device, mesh)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    gen = res.tokens
    where = "" if mesh is None else f" mesh={mesh_shape(mesh)}"
    print(f"arch={args.arch} batch={args.batch} prompt={args.prompt_len} "
          f"generated={gen.shape[1]}{where}")
    print(f"prefill: {res.prefill_ms:.1f} ms; decode: "
          f"{res.decode_ms_per_token:.1f} ms/token "
          f"({res.tokens_per_s:.0f} tok/s)")
    for i, row in enumerate(gen[:min(2, args.batch), :10].tolist()):
        print(f"  req {i}: {row} ...")
    return res


def init_process_group_from_env(device=None, init_method=None):
    """Join the process group ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``
    name, once (NCCL with each rank on ``cuda:LOCAL_RANK``, gloo when
    ``device`` is the CPU), and return this rank's device (``device``, or
    its card under NCCL). Without ``WORLD_SIZE``, or with a group already
    up, nothing is started."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    cpu = device is not None and torch.device(device).type == "cpu"
    if init_method is None:
        raise ValueError("WORLD_SIZE is set: name the process group's init "
                         "method with --dist-init or DIST_INIT_METHOD")
    if not cpu:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=init_method,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device


def serve_lm(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
             device=None, mesh=None) -> ServeResult:
    """Batched prefill + greedy decode of ``cfg`` from parameters drawn at
    ``seed``, on ``device`` (``None``: the GPU), timed. On ``mesh`` each
    rank draws its blocks of the parameters by ``SERVE_RULES`` (the same
    values as on one device, ``build_params``' keyed stream), and the steps
    run on the mesh."""
    model = build_model(cfg)
    dev = resolve_device(device)
    # Only VLM configs carry patch tokens; they count toward the cache.
    num_patch = getattr(cfg, "num_patch_tokens", 0) or 0
    serve = make_serve_steps(model, max_len=prompt_len + gen + num_patch,
                             device=dev, mesh=mesh)
    place = None if mesh is None else param_placer(model.param_table, mesh,
                                                   SERVE_RULES)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        place=place)
    inputs = {"tokens": torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), dtype=torch.int32,
        device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed + 1))}
    if cfg.family in ("audio", "encdec"):
        inputs["frames"] = torch.zeros(
            (batch, cfg.enc_frames, cfg.d_model), dtype=torch.float32,
            device=dev)
    if cfg.family == "vlm":
        inputs["prefix_embeds"] = torch.zeros(
            (batch, cfg.num_patch_tokens, cfg.d_model), dtype=torch.float32,
            device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = serve["prefill"](params, inputs)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(full_value(logits), -1)[:, None].to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = serve["decode_step"](params, cache, tok)
        tok = torch.argmax(full_value(logits), -1)[:, None].to(torch.int32)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    tokens = torch.cat(out, dim=1).cpu().numpy()
    decode_ms = t_decode / max(gen - 1, 1) * 1e3
    tok_s = batch * (gen - 1) / max(t_decode, 1e-9)
    return ServeResult(tokens=tokens, prefill_ms=t_prefill * 1e3,
                       decode_ms_per_token=decode_ms, tokens_per_s=tok_s,
                       logits=full_value(logits).float().cpu().numpy())


if __name__ == "__main__":
    main()
