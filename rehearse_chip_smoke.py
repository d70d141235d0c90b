#!/usr/bin/env python3
"""Rehearse phases of ``chip_smoke.py`` on the CPU, without a GPU.

    python3 rehearse_chip_smoke.py fit --n 300
    python3 rehearse_chip_smoke.py kernels
    python3 rehearse_chip_smoke.py distributed --n 300
    python3 rehearse_chip_smoke.py gram
    python3 rehearse_chip_smoke.py routes
    python3 rehearse_chip_smoke.py warm --n 300
    python3 rehearse_chip_smoke.py batch

``chip_smoke.py`` runs only on a CUDA device. This script drives the same
phase functions on the CPU at a small size, so their control flow, their
checks and the numbers that do not depend on the card (CG iterations, MLL
gaps between the float64 and the float32 routes, L-BFGS evaluation counts)
can be seen before a run on the card. The kernel wrappers run their plain
versions on CPU tensors; here each plain version also counts as a launch of
its wrapper, so the launch checks run too. The distributed phase runs in a
``gloo`` process group of one rank (the card's run uses NCCL), and the gram
phase sends ``rbf_gram_op`` to the kernel wrapper as the card does. The
device's limits are the H100's of the budget model, and the route tuner
answers by its CPU rule (the fused kernel), so the launch checks of the
routed cuda engine run as on the card with that route. Timings printed here
are CPU times of the plain versions, never a device metric.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CPU = torch.device("cpu")


def _patch_cuda_for_cpu() -> None:
    """Let chip_smoke import, and make its device calls no-ops on the CPU."""
    torch.cuda.is_available = lambda: True
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0


def _patch_port_for_cpu() -> None:
    """device=None means the CPU, and each plain version counts a launch."""
    import repro_torch._device as device_mod
    real = device_mod.resolve_device

    def resolve(device=None):
        return CPU if device is None else real(device)

    for mod in ("repro_torch._device", "repro_torch.core.state",
                "repro_torch.core.posterior", "repro_torch.kernels.ops",
                "repro_torch.convert"):
        importlib.import_module(mod)
        sys.modules[mod].resolve_device = resolve
    lk = importlib.import_module("repro_torch.kernels.lk_mvm")
    gram = importlib.import_module("repro_torch.kernels.gram")
    for mod, plain, wrapper in (
            (lk, "lk_mvm_fused_plain", "lk_mvm_fused"),
            (lk, "lk_mvm_stage_right_plain", "lk_mvm_stage_right"),
            (lk, "lk_mvm_stage_left_plain", "lk_mvm_stage_left"),
            (lk, "lk_mvm_fused_rows_plain", "lk_mvm_fused_rows"),
            (gram, "rbf_gram_plain", "rbf_gram_cuda")):
        fn, counted = getattr(mod, plain), getattr(mod, wrapper)

        def counting(*a, _fn=fn, _counted=counted, **k):
            _counted.launches += 1
            return _fn(*a, **k)
        setattr(mod, plain, counting)


def _cpu_time_ms(fn, **_):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", choices=("fit", "kernels", "distributed",
                                      "gram", "routes", "warm", "batch"))
    ap.add_argument("--n", type=int, default=300,
                    help="configurations of the fit and warm phases "
                         "(m=52, d=7), of the distributed phase's serving "
                         "(m=64, d=7) and of the gram phase")
    args = ap.parse_args()
    _patch_cuda_for_cpu()
    _patch_port_for_cpu()
    import chip_smoke as cs
    from repro_torch.kernels.budget import H100_SXM
    cs.DEV = CPU
    cs.time_ms = cs.device_ms = _cpu_time_ms
    cs.device_limits = lambda device: H100_SXM
    if args.phase == "fit":
        cs.reset_launch_counts()
        out = cs.phase_fit(n=args.n, m=52, d=7)
        out["launches"] = cs.launch_counts()
        out.pop("config")
        for part in ("mll", "fit"):
            for row in out[part].values():
                row.pop("grad", None)
                row.pop("raw_params", None)
        print(json.dumps(out))
    elif args.phase == "distributed":
        cs.FIT_SHAPE = dict(n=args.n, m=52, d=7)
        path = cs.init_process_group("gloo")
        try:
            cs.reset_launch_counts()
            out = cs.phase_distributed(n=args.n, m=64, d=7, n_new=32)
            out["launches"] = cs.launch_counts()
        finally:
            cs.close_process_group(path)
        print(json.dumps(out))
    elif args.phase == "gram":
        # On the card rbf_gram_op takes the kernel by device; here it is told.
        cs.rbf_gram_op = functools.partial(cs.rbf_gram_op, force_kernel=True)
        cs.reset_launch_counts()
        out = cs.phase_gram(shapes=((args.n, 64), (args.n // 2, 52)))
        out["launches"] = cs.launch_counts()
        print(json.dumps(out))
    elif args.phase == "routes":
        print(json.dumps(cs.phase_routes()))
    elif args.phase == "warm":
        cs.reset_launch_counts()
        out = cs.phase_warm(n=args.n, m=52, d=7, n_new=32)
        out["launches"] = cs.launch_counts()
        for row in out["steps"]:
            row.pop("cg_iters", None)
        print(json.dumps(out))
    elif args.phase == "batch":
        print(json.dumps(cs.phase_batch()))
    else:
        cs.KERNEL_SHAPES = [(1, 5, 3), (3, 50, 21), (2, 130, 257),
                            (17, 40, 52)]
        cs.TIMED_SHAPES = [(17, 40, 52)]
        cs.ROWS_SHAPES = [(3, 65, 130, 70), (2, 50, 100, 21),
                          (17, 40, 80, 52)]
        cs.ROWS_TIMED = [(17, 40, 80, 52)]
        cs.GRAM_SHAPES = [(130, 70, 10), (16, 16, 260), (200, 200, 7)]
        cs.GRAM_TIMED = [(200, 200, 7)]
        rows = cs.phase_kernels() + cs.fused_rows_rows() + cs.gram_rows()
        rows += cs.reference_rows()
        print(json.dumps({"phase": "kernels", "rows": len(rows),
                          "worst_err_over_tol": max(
                              r["max_err"] / r["tol"] for r in rows
                              if r["tol"] > 0)}))


if __name__ == "__main__":
    main()
