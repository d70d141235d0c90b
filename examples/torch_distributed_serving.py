"""Serve a small model with batched requests on a device mesh (the port's
counterpart of ``examples/distributed_serving.py``).

The serving path end to end: each rank draws its blocks of the parameters
by ``TP_RULES`` as ``DTensor`` s, the prefill's KV cache in its sharded
layout, then batched greedy decode. On the CPU four gloo ranks, each a
process of this script, serve on a (data 2, model 2) mesh::

    PYTHONPATH=src python examples/torch_distributed_serving.py --device cpu

On the card it is a world of one NCCL rank on a (1, 1) mesh::

    PYTHONPATH=src python examples/torch_distributed_serving.py

Under a launcher that sets ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` and
``DIST_INIT_METHOD`` (a ``file://`` path) it joins that group instead.
"""
import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.sharding import (TP_RULES,  # noqa: E402
                                              full_value, mesh_shape,
                                              param_placer)
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.serve import init_process_group_from_env  # noqa
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.trainer import make_serve_steps  # noqa: E402

CPU_RANKS = 4


def serve(arch="recurrentgemma_2b", batch=8, prompt_len=16, gen_len=24,
          device=None):
    """One rank's part: the reference example's mesh rule over the group's
    ranks, its sizes, its lines printed by rank 0."""
    n = dist.get_world_size()
    mesh = make_debug_mesh(data=max(1, n // 2), model=min(2, n))
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    steps = make_serve_steps(model, max_len=prompt_len + gen_len,
                             device=device, mesh=mesh, rules=TP_RULES)
    dev = steps["device"]
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        place=param_placer(model.param_table, mesh,
                                           TP_RULES))
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(1))
    logits, cache = steps["prefill"](params, {"tokens": prompts})
    tok = torch.argmax(full_value(logits), -1)[:, None].to(torch.int32)
    out = [tok]
    for _ in range(gen_len - 1):
        logits, cache = steps["decode_step"](params, cache, tok)
        tok = torch.argmax(full_value(logits), -1)[:, None].to(torch.int32)
        out.append(tok)
    gen = torch.cat(out, dim=1).cpu().numpy()
    if dist.get_rank() == 0:
        print(f"arch={arch} mesh={mesh_shape(mesh)} served batch={batch}")
        print(f"prompt_len={prompt_len} generated={gen.shape[1]} "
              f"tokens/request")
        for i in range(min(3, batch)):
            print(f"  request {i}: {gen[i, :12].tolist()} ...")
    assert gen.shape == (batch, gen_len)
    assert np.all(gen >= 0) and np.all(gen < cfg.vocab_size)
    if dist.get_rank() == 0:
        print("OK: batched serving on the mesh.")
    return gen


def _spawn_cpu_ranks(argv) -> int:
    """Start CPU_RANKS copies of this script as the ranks of a gloo group
    (a ``file://`` rendezvous in a temporary directory) and wait for them."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, WORLD_SIZE=str(CPU_RANKS),
                   DIST_INIT_METHOD=f"file://{tmp}/rendezvous",
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, __file__, *argv],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
            for r in range(CPU_RANKS)]
        codes = [p.wait() for p in procs]
    return max(codes, key=abs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="recurrentgemma_2b")
    ap.add_argument("--device", default=None,
                    help="cpu: four gloo ranks; default: the GPU, one rank")
    args = ap.parse_args(argv)
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if "WORLD_SIZE" in os.environ:
        return _rank(args)
    if cpu:
        sys.exit(_spawn_cpu_ranks(sys.argv[1:] if argv is None else argv))
    with tempfile.TemporaryDirectory() as tmp:
        os.environ.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                          DIST_INIT_METHOD=f"file://{tmp}/rendezvous")
        return _rank(args)


def _rank(args):
    device = init_process_group_from_env(args.device,
                                         os.environ["DIST_INIT_METHOD"])
    try:
        return serve(args.arch, device=device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
