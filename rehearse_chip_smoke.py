#!/usr/bin/env python3
"""Rehearse phases of ``chip_smoke.py`` on the CPU, without a GPU.

    python3 rehearse_chip_smoke.py fit --n 300
    python3 rehearse_chip_smoke.py kernels
    python3 rehearse_chip_smoke.py distributed --n 300
    python3 rehearse_chip_smoke.py gram
    python3 rehearse_chip_smoke.py routes
    python3 rehearse_chip_smoke.py warm --n 300
    python3 rehearse_chip_smoke.py batch
    python3 rehearse_chip_smoke.py solvers --n 200
    python3 rehearse_chip_smoke.py exact
    python3 rehearse_chip_smoke.py automl --n 200
    python3 rehearse_chip_smoke.py service
    python3 rehearse_chip_smoke.py amortize --n 200
    python3 rehearse_chip_smoke.py curvepred
    python3 rehearse_chip_smoke.py zoo
    python3 rehearse_chip_smoke.py decoder
    python3 rehearse_chip_smoke.py griffin
    python3 rehearse_chip_smoke.py encdec
    python3 rehearse_chip_smoke.py sharded
    python3 rehearse_chip_smoke.py sharded_train
    python3 rehearse_chip_smoke.py plan
    python3 rehearse_chip_smoke.py analysis --n 64

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
import dataclasses
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
sys.path.insert(0, str(ROOT / "examples"))

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
                "repro_torch.convert", "repro_torch.train.trainer",
                "repro_torch.baselines.evaluate",
                "repro_torch.amortize.encoder", "repro_torch.models.rwkv",
                "repro_torch.models.transformer",
                "repro_torch.models.griffin", "repro_torch.models.encdec",
                "repro_torch.launch.serve", "repro_torch.launch.train",
                "torch_automl_early_stopping"):
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
    # On the CPU lk_mvm_two_stage runs its float32 plain version whole: one
    # launch of each stage.
    pair = lk.lk_mvm_two_stage_plain

    def counting_pair(*a, **k):
        lk.lk_mvm_stage_right.launches += 1
        lk.lk_mvm_stage_left.launches += 1
        return pair(*a, **k)
    lk.lk_mvm_two_stage_plain = counting_pair


def _cpu_time_ms(fn, **_):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _with_config(get_config, fn):
    """``fn()`` with chip_smoke's ``get_config`` set to ``get_config``."""
    import chip_smoke as cs
    patched, cs.get_config = cs.get_config, get_config
    try:
        return fn()
    finally:
        cs.get_config = patched


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", choices=("fit", "kernels", "distributed",
                                      "gram", "routes", "warm", "batch",
                                      "solvers", "exact", "automl",
                                      "service", "amortize", "curvepred",
                                      "zoo", "decoder", "griffin",
                                      "encdec", "sharded", "sharded_train",
                                      "plan", "analysis"))
    ap.add_argument("--n", type=int, default=300,
                    help="configurations of the fit, warm and automl "
                         "phases (m=52, d=7; the automl phase's Hyperband "
                         "pool stays 243 x 27), of the distributed and "
                         "solvers phases' serving (m=64, d=7; the solvers "
                         "phase's objective at m=52), of the amortize "
                         "phase's freeze-thaw (m=52, d=7), of the gram "
                         "phase and of the analysis phase's CG reads (m=20, "
                         "d=7)")
    ap.add_argument("--steps", type=int, default=40,
                    help="training steps of the amortize phase's amortizer "
                         "and of the curvepred phase's transformer (the "
                         "card runs 400 and 1000); the zoo phase's training "
                         "steps per epoch of the example's runs are "
                         "--steps // 20 (the card runs 8)")
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
    elif args.phase == "solvers":
        cs.FIT_SHAPE = dict(n=args.n, m=52, d=7)
        cs.reset_launch_counts()
        out = cs.phase_solvers(n=args.n, m=64, d=7, n_new=32)
        out["launches"] = cs.launch_counts()
        print(json.dumps(out))
    elif args.phase == "automl":
        cs.reset_launch_counts()
        with cs.unescalated("automl"):
            out = cs.phase_automl(n=args.n, m=52, d=7)
        out["launches"] = cs.launch_counts()
        print(json.dumps(out))
    elif args.phase == "service":
        cs.reset_launch_counts()
        with cs.unescalated("service"):
            out = cs.phase_service()
        out["launches"] = cs.launch_counts()
        print(json.dumps(out))
    elif args.phase == "amortize":
        cs.AMORTIZE_TRAIN = cs.AmortizeTrainConfig(steps=args.steps)
        cs.reset_launch_counts()
        with cs.unescalated("amortize"):
            out = cs.phase_amortize(n=args.n, m=52, d=7)
        out["launches"] = cs.launch_counts()
        print(json.dumps(out))
    elif args.phase == "curvepred":
        cs.CURVEPRED_PRETRAIN = dataclasses.replace(cs.CURVEPRED_PRETRAIN,
                                                    steps=args.steps)
        cs.CURVEPRED_TASKS = 1
        with cs.unescalated("curvepred"):
            print(json.dumps(cs.phase_curvepred()))
    elif args.phase == "zoo":
        # The published width does not fit the CPU: the smoke config with
        # the published config's numerics (bf16, remat, chunk-parallel WKV).
        smoke = cs.get_smoke_config(cs.ZOO_ARCH).replace(
            rwkv_chunk=16, dtype_act=torch.bfloat16,
            dtype_param=torch.bfloat16, remat=True)
        cs.get_config = lambda arch: smoke
        for mod in ("repro_torch.launch.serve", "repro_torch.launch.train"):
            sys.modules[mod].get_config = cs.get_config
        cs.automl_example.STEPS_PER_EPOCH = max(1, args.steps // 20)
        with cs.unescalated("zoo"):
            print(json.dumps(cs.phase_zoo()))
    elif args.phase == "decoder":
        # The published widths do not fit the CPU: each smoke config with
        # the published config's numerics (bf16, remat); the cut configs
        # keep the smoke depth.
        def smoke(arch):
            return cs.get_smoke_config(arch).replace(
                dtype_act=torch.bfloat16, dtype_param=torch.bfloat16,
                remat=True)
        cs.get_config = smoke
        sys.modules["repro_torch.launch.serve"].get_config = smoke
        cs.DECODER_CUT = {arch: smoke(arch).num_layers
                          for arch in cs.DECODER_CUT}
        with cs.unescalated("decoder"):
            print(json.dumps(cs.phase_decoder()))
    elif args.phase in ("griffin", "encdec"):
        # The published widths do not fit the CPU: the smoke config with the
        # published config's numerics (bf16, remat); the float32 checks at
        # the smoke widths and depth (the Griffin one at S = 2048 / window 8
        # on the chunked path), the scan at the smoke width over 2049 steps.
        def smoke(arch):
            return cs.get_smoke_config(arch).replace(
                dtype_act=torch.bfloat16, dtype_param=torch.bfloat16,
                remat=True)
        cs.get_config = smoke
        for mod in ("repro_torch.launch.serve", "repro_torch.launch.train"):
            sys.modules[mod].get_config = smoke
        cs.GRIFFIN_SERVE = ((2, 24, 6), (2, 6, 4))
        cs.GRIFFIN_CONSISTENCY = dict(layers=3, batch=2,
                                      cases=((2048, 1), (6, 4)))
        cs.GRIFFIN_SCAN_SEQ = 2049
        cs.GRIFFIN_ATTN_SEQ = 2048
        cs.ENCDEC_SERVE = (2, 8, 6)
        cs.LM_TRAIN_ARGS = ["--steps", str(cs.LM_TRAIN_STEPS), "--batch",
                            "2", "--seq", "16", "--lr", "3e-5",
                            "--log-every", "100"]
        phase = cs.phase_griffin if args.phase == "griffin" \
            else cs.phase_encdec
        with cs.unescalated(args.phase):
            print(json.dumps(phase()))
    elif args.phase == "sharded":
        # The published widths do not fit the CPU: each smoke config with
        # the published config's numerics (bf16, remat) served on a (1, 1)
        # mesh in a gloo world of one; float32 and the MoE functions at the
        # smoke widths; the plan rows as on the card (nothing allocated).
        def smoke(arch):
            return cs.get_smoke_config(arch).replace(
                dtype_act=torch.bfloat16, dtype_param=torch.bfloat16,
                remat=True)
        plan_config = cs.get_config
        cs.get_config = smoke
        sys.modules["repro_torch.launch.serve"].get_config = smoke
        cs.sharded_plan_rows = functools.partial(_with_config, plan_config,
                                                 cs.sharded_plan_rows)
        cs.SHARDED_SERVE = tuple((arch, None, 2, 12, 6)
                                 for arch, *_ in cs.SHARDED_SERVE)
        cs.SHARDED_F32 = tuple((arch, None) for arch, _ in cs.SHARDED_F32)
        cs.SHARDED_MOE_TOKENS = {"moe_ffn_sharded": (4, 12),
                                 "moe_ffn_sharded_decode": (4, 1)}
        cs.nvidia_smi_line = lambda: "CPU rehearsal, no card"
        with cs.unescalated("sharded"):
            print(json.dumps(cs.phase_sharded("gloo")))
    elif args.phase == "sharded_train":
        # The published widths do not fit the CPU: each smoke config with
        # the published config's numerics (bf16, remat, the chunked WKV)
        # trained on a (1, 1) mesh in a gloo world of one at 2 x 16, the
        # restart rows through launch/train.py --smoke --device cpu (gloo),
        # the pipeline over 2 microbatches; the plan rows as on the card
        # (nothing allocated).
        plan_config = cs.get_config

        def smoke(arch):
            return cs.get_smoke_config(arch).replace(
                dtype_act=torch.bfloat16, dtype_param=torch.bfloat16,
                remat=True, rwkv_chunk=plan_config(arch).rwkv_chunk)
        cs.get_config = smoke
        cs.sharded_train_plan_rows = functools.partial(
            _with_config, plan_config, cs.sharded_train_plan_rows)
        cs.SHARDED_TRAIN_SHAPE = (2, 16)
        cs.SHARDED_PIPE = (cs.SHARDED_PIPE[0], cs.SHARDED_PIPE[1], 2)
        cs.SHARDED_RESTART_ARGS = ["--arch", cs.SHARDED_RESTART_ARCH,
                                   "--smoke", "--steps", "6", "--batch", "2",
                                   "--seq", "16", "--lr", "3e-5",
                                   "--ckpt-every", "2", "--log-every", "100",
                                   "--device", "cpu"]
        cs.nvidia_smi_line = lambda: "CPU rehearsal, no card"
        with cs.unescalated("sharded_train"):
            print(json.dumps(cs.phase_sharded_train("gloo")))
    elif args.phase == "plan":
        # The published widths do not fit the CPU: the keyed init of each
        # smoke config with the published numerics (bf16) on the CPU, at
        # the card's meshes; the dry run at a world of one at the smoke
        # widths (no measured rows: ratios None); the multi-rank cells at
        # published width (meta tensors: nothing allocated).
        def smoke(arch):
            return cs.get_smoke_config(arch).replace(
                dtype_act=torch.bfloat16, dtype_param=torch.bfloat16,
                remat=True)
        cs.get_config = smoke
        cs.nvidia_smi_line = lambda: "CPU rehearsal, no card"
        # the blocks' peak: live bytes counted op by op (the dry run's
        # counter) in place of the card's allocator
        from repro_torch.launch.dryrun import StepCounter
        blocks, peak = cs.keyed_blocks, [0]

        def counted_blocks(*a):
            counter = StepCounter()
            with counter:
                out = blocks(*a)
            peak[0] = counter.peak
            return out
        cs.keyed_blocks = counted_blocks
        torch.cuda.max_memory_allocated = lambda *a, **k: peak[0]
        with cs.unescalated("plan"):
            print(json.dumps(cs.phase_plan()))
    elif args.phase == "analysis":
        # the CG loop's reads at n = --n (m=20, d=7), the audits on the
        # CPU's plain versions, the budget against the H100's data sheet
        cs.nvidia_smi_line = lambda: "CPU rehearsal, no card"
        cs.ANALYSIS_CG = dict(n=args.n, m=20, d=7)
        with cs.unescalated("analysis"):
            print(json.dumps(cs.phase_analysis()))
    elif args.phase == "exact":
        with cs.unescalated("exact"):
            print(json.dumps(cs.phase_exact()))
    else:
        cs.KERNEL_SHAPES = [(1, 5, 3), (3, 50, 21), (2, 130, 257),
                            (1, 24, 16), (1, 64, 32), (1, 8, 6),
                            (17, 40, 52)]
        cs.TIMED_SHAPES = [(17, 40, 52)]
        cs.LAUNCH_SHAPES = [(65, 40, 52), (65, 40, 200), (1, 40, 52)]
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
