#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout (one
nvcc per source, started together), holds each against its plain PyTorch
version on the card (the MVM kernels K1, K2a, K2b and K3 also against a
second launch of themselves, bit for bit, with the grid they launched
reported), then drives the port's paths at full width and checks that they
ran through the kernels:

* the route tuner (K6): the route of every (n, m, B) bucket the main paths
  sweep on the ``cuda`` engine, K1 or K2a + K2b, timed on the card, printed
  with its times before the paths run; the budget model of every kernel
  instantiation held against ``cudaFuncGetAttributes`` in the build phase;
* serving (fitted state -> ``posterior(state)`` -> ``final`` / ``mean`` /
  ``samples``) through the ``cuda`` engine: every CG iteration one sweep of
  the routed kernels (one launch of K1, or one each of K2a and K2b);
* fitting (``fit`` -> MLL value and gradient -> L-BFGS) at the paper's
  LCBench shape, through the routed ``cuda`` engine, and through K1 and the
  two-stage kernels K2a + K2b by name (``make_mll_iterative(cfg,
  KernelMVM(fused=True / False))``): every objective evaluation costs the
  stacked solve's CG iterations plus 2 sweeps;
* the freeze-thaw loop at the same shape on the routed ``cuda`` engine:
  ``fit`` with the fixed-budget polish (twice: the same bits), ``extend``
  with more epochs and ``refit``, ``extend`` with new configurations and
  ``refit``, each evaluation's launches held to its CG iterations;
* the batched dense path (``fit_batch``, ``stack_states``,
  ``posterior_batch``) on 16 tasks: per-task ``fit`` and ``fit_batch``
  bitwise equal, a task's posterior bitwise equal at batch sizes 1 and 16,
  and the committed LCBench-format fixture through ``get_source``;
* the ``distributed`` engine inside an NCCL process group of one rank (so
  its all-gather runs): a float32 state served with every CG sweep one launch
  of the row-shard kernel K3, a float64 fit through its exact body, and the
  row-sharded ``dist_mll_value``;
* ``rbf_gram_op``, the RBF Gram matrix through kernel K4, written by the
  kernel in the caller's float64;
* the reference's own TPU kernels: ``tests/fixtures/reference_kernels.npz``
  holds their outputs (Pallas, interpret mode) at small ragged shapes, and
  K1, K2a + K2b and K4 are held against it.

Any failed check raises; nothing is caught, so the exit code is non-zero.
Without a CUDA device the script exits non-zero before printing any result.

Phases, one JSON line each: device, build (with the budget model against
the runtime), kernels, reference (the .npz), routes, serve (n=8192, m=64,
``final`` and ``mean`` also timed on the float64 ``iterative`` engine),
serve_lcbench (n=2000, m=52, also against the ``iterative`` engine), exact
(n=24, m=16 against the ``dense`` engine), fit (n=2000, m=52, d=7), warm
(n=2000 -> 2048, m=52, d=7), batch (16 tasks of n=48, m=20, d=4; the
fixture), distributed (n=8192, m=64 float32 serving; n=2000, m=52 float64
fit), gram
(n=8192 and n=2000, d=7), routes_used (every bucket the tuner resolved).
Then a summary line ``{"kernels": [...]}``, the card's name and power limit
as ``nvidia-smi`` gives them, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is False")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch.distributed as dist  # noqa: E402
from repro_torch import state_from_reference  # noqa: E402
from repro_torch.core import (DistributedEngine, LKGPConfig,  # noqa: E402
                              extend, fit, fit_batch, get_engine,
                              gram_matrices, init_params, lk_mvm, log_prior,
                              make_mll, make_mll_iterative, posterior,
                              posterior_batch, rademacher_probes, refit,
                              stack_states, unstack)
from repro_torch.core.engines import (IterativeEngine,  # noqa: E402
                                      KernelEngine, KernelMVM,
                                      LatentKroneckerOperator)
from repro_torch.core.matheron import prior_residual_draws  # noqa: E402
from repro_torch.core.posterior import joint_grams  # noqa: E402
from repro_torch.core.state import (_fit_transforms,  # noqa: E402
                                    _flatten_params, _unflatten_params)
from repro_torch.core.transforms import (TTransform, XTransform,  # noqa: E402
                                         YTransform)
from repro_torch.data import (get_source, sample_suite,  # noqa: E402
                              sample_task, stack_suite)
from repro_torch.distributed import dist_mll_value  # noqa: E402
from repro_torch.kernels import rbf_gram_op  # noqa: E402
from repro_torch.kernels._build import build_log, load_library  # noqa: E402
from repro_torch.kernels.autotune import (autotune_route,  # noqa: E402
                                          cache_contents)
from repro_torch.kernels.budget import (INSTANTIATIONS,  # noqa: E402
                                        device_limits, kernel_attributes)
from repro_torch.kernels.gram import (plan_gram, rbf_gram_cuda,  # noqa: E402
                                      rbf_gram_plain)
from repro_torch.kernels.lk_mvm import (  # noqa: E402
    lk_mvm_fused, lk_mvm_fused_plain, lk_mvm_fused_rows,
    lk_mvm_fused_rows_plain, lk_mvm_stage_left, lk_mvm_stage_left_plain,
    lk_mvm_stage_right, lk_mvm_stage_right_plain, lk_mvm_two_stage,
    lk_mvm_two_stage_plain, TC_COLS, TC_K, TC_ROWS, plan_launch, plan_stream)
from repro_torch.kernels.ref import lk_mvm_ref  # noqa: E402

SEED = 0
DEV = torch.device("cuda", 0)

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): the
# yardstick of bound_ms whatever card this runs on. Each datapath's rate: the
# float32 FMA pipes (K4), three TF32 tensor-core products per float32 product
# (K1 and K3 in f32 mode, K2a and K2b), the BF16 tensor cores (bf16 mode).
PEAK_FLOPS = {"f32 FMA": 67e12, "3xTF32": 495e12 / 3, "bf16 MMA": 989e12}
# The datapath of K1 and K3 in each precision mode.
TC_DATAPATH = {"f32": "3xTF32", "bf16": "bf16 MMA"}
PEAK_BYTES_PER_S = 3.35e12

# Kernel against its plain version. Both round at the same points, so what is
# left is the order of summation (and, in bf16 mode, an intermediate that
# lands on the other side of a bf16 rounding boundary now and then).
KERNEL_TOL = {"f32": 1e-4, "bf16": 2e-2}     # times max|plain|
# Ragged small shapes, then the shapes the serving path hands the kernel:
# B = 65 (y and 64 Matheron residuals), 16 (samples on demand), 1 (mean
# only); the fit path at n = 2000: B = 17 (y and 16 probes, the stacked
# solve), 16 (A(probes) in the gradient), 1 (A(alpha)); and the same three
# at n = 2048, where the warm phase's refit on new configurations and its
# mean run.
KERNEL_SHAPES = [(1, 5, 3), (3, 50, 21), (2, 130, 257),
                 (1, 2000, 52), (16, 2000, 52), (17, 2000, 52),
                 (65, 2000, 52),
                 (1, 2048, 52), (16, 2048, 52), (17, 2048, 52),
                 (1, 8192, 64), (16, 8192, 64), (65, 8192, 64)]
TIMED_SHAPES = KERNEL_SHAPES[3:]
MAIN_SHAPE = (65, 8192, 64)
FIT_MAIN_SHAPE = (17, 2000, 52)
KERNEL_SOURCES = ("lk_mvm_fused", "lk_mvm_two_stage", "lk_mvm_fused_rows",
                  "rbf_gram")
# Kernel K3, the row-shard MVM, as (B, n_local, n, m): a world of one rank
# (n_local = n) at the serving shapes of the distributed phase (B = 65 for
# final(), 1 for a mean); one rank's share of a 4-way split of n = 8192; the
# fit path's shape; and two ragged row shards (not the first shard, whose
# rows would line up with the k sweep). Checked in f32 and bf16 each.
ROWS_SHAPES = [(3, 65, 130, 70), (2, 50, 100, 21), (17, 2000, 2000, 52),
               (1, 8192, 8192, 64), (65, 2048, 8192, 64), (65, 8192, 8192, 64)]
ROWS_TIMED = ROWS_SHAPES[2:]
ROWS_MAIN_SHAPE = (65, 8192, 8192, 64)
# Kernel K4, the RBF Gram matrix, as (n, p, d): the serving task's configs,
# the LCBench shape, a ragged tile and d spanning several chunks.
GRAM_SHAPES = [(130, 70, 10), (16, 16, 260), (2000, 2000, 7),
               (8192, 8192, 7)]
GRAM_TIMED = GRAM_SHAPES[2:]
GRAM_MAIN_SHAPE = (8192, 8192, 7)
# Each shape with float32 inputs (K in float32) and float64 inputs (K in
# float64, written by the kernel).
GRAM_DTYPES = (torch.float32, torch.float64)
# K4 against its plain version and against the float64 oracle: float32 with
# another summation order, as the reference holds its kernel (3e-5), in units
# of max|K|.
GRAM_TOL = 3e-5
# The reference's TPU kernels' outputs (tests/fixtures/make_reference_kernels.py)
# and the tolerances the CPU tests hold the plain versions to against them.
REFERENCE_NPZ = (Path(__file__).resolve().parent / "tests" / "fixtures"
                 / "reference_kernels.npz")
# Every (n, m, B) the main paths sweep on the cuda engine, whose route the
# tuner resolves before they run: serve (n=8192, m=64) and serve_lcbench
# (n=2000, m=52): final() B=65, mean B=1, samples B=16; fit (n=2000, m=52):
# the stacked solve B=17, A(probes) B=16, A(alpha) B=1; exact (24, 16, 1).
ROUTE_SHAPES = [(8192, 64, 65), (8192, 64, 1), (8192, 64, 16),
                (2000, 52, 65), (2000, 52, 1), (2000, 52, 16),
                (2000, 52, 17), (24, 16, 1)]
# The wrappers each route launches per sweep.
ROUTE_KERNELS = {"fused": ("lk_mvm_fused",),
                 "two_stage": ("lk_mvm_stage_right", "lk_mvm_stage_left")}
# Largest gap between the posterior means of the cuda and the iterative
# engine, in units of cg_tol * max|mean|. CG bounds the 2-norm of each solve's
# residual by cg_tol * ||y||, not the largest of ~10^5 cell-wise gaps between
# two such solves, which is a few times cg_tol * max|mean|: the phase prints
# the gap it observed, and shows that it shrinks with cg_tol.
MEAN_TOL_VS_ITERATIVE = 5.0


# The fit phase: the paper's LCBench shape, float64 state, the paper's CG
# tolerance and SLQ settings, prior-mean init, 10 L-BFGS iterations.
FIT_SHAPE = dict(n=2000, m=52, d=7)
FIT_CONFIG = dict(cg_tol=0.01, slq_probes=16, slq_iters=25, seed=SEED)
FIT_LBFGS_ITERS = 10
# MLL value and gradient through a float32 kernel against the float64
# iterative engine, same probes. Each CG solve (y and 16 probes) stops with
# its true residual within cg_tol, at a different point for each MVM, so the
# two objectives differ by stopping error, a fraction of cg_tol of each term
# (rehearse_chip_smoke.py shows it on the CPU). Held to 5 cg_tol * |mll| and
# 10 cg_tol * max|grad|; fixed before the first run on the card (PERF.md).
MLL_VALUE_TOL = 5.0     # times cg_tol, relative to |mll|
MLL_GRAD_TOL = 10.0     # times cg_tol, relative to max|grad|


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, message: str) -> None:
    if not cond:
        raise AssertionError(message)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, repeats: int = 10, warmup: int = 2) -> float:
    """Median over ``repeats`` of one call's device time, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# Clock cycles of the spin kernel that device_ms queues its calls behind:
# ~5 ms on an H100, longer than the host takes to enqueue them.
SPIN_CYCLES = 10_000_000


def device_ms(fn, repeats: int = 10, warmup: int = 2) -> float:
    """One call's device time with the host out of it: ``repeats`` calls
    queued behind a spin kernel, so that they run back to back, between two
    CUDA events; the mean. (``time_ms`` times single calls from an idle
    device, so it also counts the host's time to launch them: tens of µs.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def _bound(flops: float, nbytes: float, datapath: str) -> tuple[float, str]:
    """The larger of the operations at the datapath's peak and the bytes at
    the memory's, and which of the two it is."""
    t_ops = flops / PEAK_FLOPS[datapath] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_ms(B: int, n: int, m: int,
             datapath: str = "f32 FMA") -> tuple[float, str]:
    """Least time the card could take for the fused MVM: operations at the
    datapath's rate or bytes, whichever is larger. Each input is read once
    and the output written once (float32)."""
    flops = 2.0 * B * (n * n * m + n * m * m)
    nbytes = 4.0 * (n * n + m * m + n * m + 2 * B * n * m + 1)
    return _bound(flops, nbytes, datapath)


def tc_bounds(bound_fn, *shape, precision: str) -> dict:
    """A tensor-core kernel's bound on its datapath (``bound_by`` names it)
    and, as ``bound_fma_ms``, on the float32 FMA pipes of the earlier FMA
    kernels, so the rows compare with theirs."""
    datapath = TC_DATAPATH[precision]
    bound, by = bound_fn(*shape, datapath)
    fma, _ = bound_fn(*shape, "f32 FMA")
    if by == "operations":
        by = f"operations ({datapath})"
    return {"bound_ms": bound, "bound_by": by, "datapath": datapath,
            "bound_fma_ms": fma}


def plan_row(B: int, n_local: int, n: int, m: int,
             narrow: bool = False) -> dict:
    """The wrapper's launch plan at this shape, which is the grid the kernel
    launched (its launcher rejects any other): the split of the k sweep, the
    cluster (1, 1, splits), the blocks on the card and the panel's width
    (``narrow``: K2b's plan)."""
    plan = plan_launch(B, n_local, n, m, sms=device_limits(DEV).sms,
                       narrow=narrow)
    return {"splits": plan.splits, "cluster": [1, 1, plan.splits],
            "grid": [plan.panels, plan.row_tiles, plan.splits],
            "blocks": plan.blocks, "tiles": plan.tiles,
            "panel_cols": plan.panel_cols}


def check_fills_card(row: dict) -> None:
    """At B = 1 and n = 8192 the split k puts a block on every SM."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    check(row["blocks"] >= sms, f"{row['name']} {row['precision']} at "
          f"{tuple(row['shape'])}: {row['blocks']} blocks for {sms} SMs")


def bound_two_stage_ms(stage: str, B: int, n: int, m: int,
                       datapath: str = "f32 FMA") -> tuple[float, str]:
    """bound_ms of one stage alone; T counts as that stage's output (R) or
    input (L), each read or written once."""
    if stage == "R":    # u, mask, K2 in; T out
        flops = 2.0 * B * n * m * m
        nbytes = 4.0 * (2 * B * n * m + n * m + m * m)
    else:               # K1, T, mask, u, noise in; out
        flops = 2.0 * B * n * n * m
        nbytes = 4.0 * (n * n + 3 * B * n * m + n * m + 1)
    return _bound(flops, nbytes, datapath)


def bound_pair_ms(B: int, n: int, m: int,
                  datapath: str = "f32 FMA") -> tuple[float, str]:
    """bound_ms of K2a then K2b: the sum of the stages' bounds (T goes
    through device memory), named after the larger one."""
    (r, r_by), (l, l_by) = (bound_two_stage_ms(st, B, n, m, datapath)
                            for st in "RL")
    return r + l, l_by if l >= r else r_by


def stream_row(B: int, n: int, m: int) -> dict:
    """K2a's plan at this shape, which is the grid it launched (its
    launcher rejects any other): persistent blocks over strips of rows."""
    limits = device_limits(DEV)
    plan = plan_stream(B, n, m, sms=limits.sms, limits=limits)
    return {"grid": [plan.blocks], "blocks": plan.blocks,
            "strips": plan.strips, "strip_rows": plan.strip_rows}


WRAPPERS = {"lk_mvm_fused": lk_mvm_fused,
            "lk_mvm_stage_right": lk_mvm_stage_right,
            "lk_mvm_stage_left": lk_mvm_stage_left,
            "lk_mvm_fused_rows": lk_mvm_fused_rows,
            "rbf_gram": rbf_gram_cuda}


def launch_counts(since: dict | None = None) -> dict:
    """Each kernel wrapper's launch count (minus ``since``)."""
    return {k: w.launches - (since or {}).get(k, 0)
            for k, w in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def bound_rows_ms(B: int, n_local: int, n: int, m: int,
                  datapath: str = "f32 FMA") -> tuple[float, str]:
    """bound_ms of the row-shard kernel K3: um_full @ K2 over all n rows,
    then the (n_local, n) product; K1_rows, um_full, mask_rows, u_rows and
    K2 read once, the output written once."""
    flops = 2.0 * B * (n * m * m + n_local * n * m)
    nbytes = 4.0 * (n_local * n + B * n * m + 3 * B * n_local * m + m * m)
    return _bound(flops, nbytes, datapath)


def bound_gram_ms(n: int, p: int, d: int, in_bytes: int = 4,
                  out_bytes: int = 4) -> tuple[float, str]:
    """bound_ms of the Gram kernel K4: 2 n p d flops (float32 FMAs); x1,
    x2 and the lengthscales read once at their itemsize, K written once at
    its itemsize."""
    flops = 2.0 * n * p * d
    nbytes = out_bytes * n * p + in_bytes * (n + p + 1) * d
    return _bound(flops, nbytes, "f32 FMA")


def mvm_problem(B: int, n: int, m: int, gen: torch.Generator):
    """Random SPD K1/K2, a prefix (early-stopping) mask, masked u, noise."""
    f32 = torch.float32
    A = torch.randn((n, n), generator=gen, device=DEV, dtype=f32)
    K1 = A @ A.T / n + 0.5 * torch.eye(n, device=DEV, dtype=f32)
    del A
    Bm = torch.randn((m, m), generator=gen, device=DEV, dtype=f32)
    K2 = Bm @ Bm.T / m + 0.5 * torch.eye(m, device=DEV, dtype=f32)
    lens = torch.randint(1, m + 1, (n,), generator=gen, device=DEV)
    mask = (torch.arange(m, device=DEV)[None, :] < lens[:, None]).to(f32)
    u = torch.randn((B, n, m), generator=gen, device=DEV, dtype=f32) * mask
    noise = torch.tensor(0.1, device=DEV, dtype=f32)
    return K1, K2, mask, u, noise


def library_mvm(K1, K2, mask, u, noise):
    """The same function as one composition of library matrix products
    (float32 torch.matmul). A yardstick only: the port never calls it."""
    um = mask * u
    return mask * torch.matmul(K1, torch.matmul(um, K2)) + noise * um


def phase_kernels() -> list[dict]:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    rows = []
    for (B, n, m) in KERNEL_SHAPES:
        K1, K2, mask, u, noise = mvm_problem(B, n, m, gen)
        for precision in ("f32", "bf16"):
            ref = lk_mvm_fused_plain(K1, K2, mask, u, noise,
                                     precision=precision)
            out = lk_mvm_fused(K1, K2, mask, u, noise, precision=precision)
            again = lk_mvm_fused(K1, K2, mask, u, noise, precision=precision)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"lk_mvm_fused {precision} at "
                  f"{(B, n, m)}: two launches gave different bits")
            check(out.shape == u.shape and out.dtype == u.dtype,
                  f"kernel output {out.shape}/{out.dtype} at {(B, n, m)}")
            check(bool(torch.isfinite(out).all()), "kernel output not finite")
            scale = float(ref.abs().max())
            err = float((out - ref).abs().max())
            tol = KERNEL_TOL[precision] * scale
            row = {"name": "lk_mvm_fused",
                   "tpu": "repro/kernels/lk_mvm.py:lk_mvm_fused",
                   "precision": precision, "shape": [B, n, m],
                   "max_err": err, "tol": tol, "ref_scale": scale,
                   "bitwise_repeat": True, **plan_row(B, n, n, m)}
            if B == 1 and n >= 8192:
                check_fills_card(row)
            if (B, n, m) in TIMED_SHAPES:
                row.update(
                    ms=time_ms(lambda: lk_mvm_fused(
                        K1, K2, mask, u, noise, precision=precision)),
                    plain_ms=time_ms(lambda: lk_mvm_fused_plain(
                        K1, K2, mask, u, noise, precision=precision)),
                    library_ms=time_ms(lambda: library_mvm(
                        K1, K2, mask, u, noise)),
                    device_ms=device_ms(lambda: lk_mvm_fused(
                        K1, K2, mask, u, noise, precision=precision)),
                    library_device_ms=device_ms(lambda: library_mvm(
                        K1, K2, mask, u, noise)),
                    **tc_bounds(bound_ms, B, n, m, precision=precision))
            if precision == "f32":
                # Independent truth: the float64 oracle on the same inputs.
                truth = lk_mvm_ref(K1.double(), K2.double(), mask.double(),
                                   u.double(), noise.double())
                row["max_err_vs_float64"] = float(
                    (out.double() - truth).abs().max())
                check(row["max_err_vs_float64"] <= tol,
                      f"lk_mvm_fused f32 vs float64 oracle at {(B, n, m)}: "
                      f"{row['max_err_vs_float64']:.3e} > {tol:.3e}")
                del truth
            rows.append(row)
            check(err <= tol, f"lk_mvm_fused {precision} at {(B, n, m)}: "
                              f"max err {err:.3e} > tol {tol:.3e}")
        rows.extend(two_stage_rows(K1, K2, mask, u, noise))
        # float64 u: computed in float32, returned as float64.
        u64 = u.double()
        out64 = lk_mvm_fused(K1, K2, mask, u64, noise)
        ref64 = lk_mvm_fused_plain(K1, K2, mask, u64, noise)
        torch.cuda.synchronize()
        check(out64.dtype == torch.float64, "float64 u must give float64")
        err64 = float((out64 - ref64).abs().max())
        tol64 = KERNEL_TOL["f32"] * float(ref64.abs().max())
        rows.append({"name": "lk_mvm_fused", "precision": "f32",
                     "u_dtype": "float64", "shape": [B, n, m],
                     "max_err": err64, "tol": tol64})
        check(err64 <= tol64, f"lk_mvm_fused float64 u at {(B, n, m)}: "
                              f"max err {err64:.3e} > tol {tol64:.3e}")
        del K1, K2, mask, u, u64, out, ref, out64, ref64
        torch.cuda.empty_cache()
    return rows


def two_stage_rows(K1, K2, mask, u, noise) -> list[dict]:
    """K2a, K2b and the pair against their plain versions (K2b on the plain
    T, so each kernel is held alone) and against a second launch of
    themselves, bit for bit; K2b and the pair also against the float64
    oracle. Each row carries the grid its kernel launched; timed at the main
    paths' shapes, with the 3xTF32 bound and the FMA bound beside it."""
    B, n, m = u.shape
    T = lk_mvm_stage_right_plain(u, mask, K2)
    plan_R, plan_L = stream_row(B, n, m), plan_row(B, n, n, m, narrow=True)
    cases = [
        ("lk_mvm_stage_right", "src/repro/kernels/lk_mvm.py:170",
         lambda: lk_mvm_stage_right(u, mask, K2),
         lambda: lk_mvm_stage_right_plain(u, mask, K2),
         lambda: torch.matmul(mask * u, K2),
         functools.partial(bound_two_stage_ms, "R"), plan_R),
        ("lk_mvm_stage_left", "src/repro/kernels/lk_mvm.py:185",
         lambda: lk_mvm_stage_left(K1, T, mask, u, noise),
         lambda: lk_mvm_stage_left_plain(K1, T, mask, u, noise),
         lambda: mask * torch.matmul(K1, T) + noise * mask * u,
         functools.partial(bound_two_stage_ms, "L"), plan_L),
        ("lk_mvm_two_stage", "src/repro/kernels/lk_mvm.py:170,185",
         lambda: lk_mvm_two_stage(K1, K2, mask, u, noise),
         lambda: lk_mvm_two_stage_plain(K1, K2, mask, u, noise),
         lambda: library_mvm(K1, K2, mask, u, noise),
         bound_pair_ms, {"plans": {"lk_mvm_stage_right": plan_R,
                                   "lk_mvm_stage_left": plan_L}}),
    ]
    truth = None
    rows = []
    for name, tpu, kernel, plain, library, bound_fn, grid in cases:
        ref = plain()
        out = kernel()
        again = kernel()
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"{name} at {(B, n, m)}: two launches "
              f"gave different bits")
        check(out.shape == ref.shape and out.dtype == torch.float32,
              f"{name} output {out.shape}/{out.dtype} at {(B, n, m)}")
        check(bool(torch.isfinite(out).all()), f"{name} output not finite")
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        tol = KERNEL_TOL["f32"] * scale
        row = {"name": name, "tpu": tpu, "precision": "f32",
               "shape": [B, n, m], "max_err": err, "tol": tol,
               "ref_scale": scale, "bitwise_repeat": True, **grid}
        if name == "lk_mvm_two_stage":
            # whether the route changes the answer's bits (recorded: K2a
            # rounds T as K1's stage R does, and K2b is K1's stage L)
            row["bitwise_equal_to_fused"] = bool(torch.equal(
                out, lk_mvm_fused(K1, K2, mask, u, noise)))
        if name == "lk_mvm_stage_left" and B == 1 and n >= 8192:
            check_fills_card(row)
        if name != "lk_mvm_stage_right":
            # Independent truth: the float64 oracle of the whole function.
            if truth is None:
                truth = lk_mvm_ref(K1.double(), K2.double(), mask.double(),
                                   u.double(), noise.double())
            row["max_err_vs_float64"] = float(
                (out.double() - truth).abs().max())
            check(row["max_err_vs_float64"] <= tol,
                  f"{name} vs float64 oracle at {(B, n, m)}: "
                  f"{row['max_err_vs_float64']:.3e} > {tol:.3e}")
        if (B, n, m) in TIMED_SHAPES:
            row.update(ms=time_ms(kernel), plain_ms=time_ms(plain),
                       library_ms=time_ms(library),
                       device_ms=device_ms(kernel),
                       library_device_ms=device_ms(library),
                       **tc_bounds(bound_fn, B, n, m, precision="f32"))
        rows.append(row)
        check(err <= tol, f"{name} at {(B, n, m)}: max err {err:.3e} > "
                          f"tol {tol:.3e}")
    return rows


def fused_rows_rows() -> list[dict]:
    """Kernel K3 against its plain version on the card at ROWS_SHAPES, f32
    and bf16, timed at ROWS_TIMED. The shard is the last n_local rows of an
    (n, m) grid; um_full is the whole grid's mask * u."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 10)
    rows_out = []
    for (B, n_local, n, m) in ROWS_SHAPES:
        K1, K2, mask, u, noise = mvm_problem(B, n, m, gen)
        rows = slice(n - n_local, n)
        K1r, mask_r = K1[rows], mask[rows].contiguous()
        u_r = u[:, rows].contiguous()
        um_full = mask * u
        del K1
        for precision in ("f32", "bf16"):
            args = (K1r, K2, mask_r, u_r, um_full, noise)
            ref = lk_mvm_fused_rows_plain(*args, precision=precision)
            out = lk_mvm_fused_rows(*args, precision=precision)
            again = lk_mvm_fused_rows(*args, precision=precision)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"lk_mvm_fused_rows {precision} "
                  f"at {(B, n_local, n, m)}: two launches gave different bits")
            check(out.shape == u_r.shape and out.dtype == torch.float32,
                  f"lk_mvm_fused_rows output {out.shape}/{out.dtype}")
            check(bool(torch.isfinite(out).all()),
                  "lk_mvm_fused_rows output not finite")
            scale = float(ref.abs().max())
            err = float((out - ref).abs().max())
            tol = KERNEL_TOL[precision] * scale
            row = {"name": "lk_mvm_fused_rows",
                   "tpu": "src/repro/kernels/lk_mvm.py:371",
                   "precision": precision, "shape": [B, n_local, n, m],
                   "max_err": err, "tol": tol, "ref_scale": scale,
                   "bitwise_repeat": True, **plan_row(B, n_local, n, m)}
            if B == 1 and n_local >= 8192:
                check_fills_card(row)
            if precision == "f32":
                truth = (mask_r.double() * (K1r.double() @ (
                    um_full.double() @ K2.double()))
                    + float(noise) * mask_r.double() * u_r.double())
                row["max_err_vs_float64"] = float(
                    (out.double() - truth).abs().max())
                check(row["max_err_vs_float64"] <= tol,
                      f"lk_mvm_fused_rows f32 vs float64 at "
                      f"{(B, n_local, n, m)}: {row['max_err_vs_float64']:.3e}")
                del truth
            if (B, n_local, n, m) in ROWS_TIMED:
                def library():
                    return (mask_r * torch.matmul(K1r, torch.matmul(
                        um_full, K2)) + noise * mask_r * u_r)
                row.update(
                    ms=time_ms(lambda: lk_mvm_fused_rows(
                        *args, precision=precision)),
                    plain_ms=time_ms(lambda: lk_mvm_fused_rows_plain(
                        *args, precision=precision)),
                    library_ms=time_ms(library),
                    device_ms=device_ms(lambda: lk_mvm_fused_rows(
                        *args, precision=precision)),
                    library_device_ms=device_ms(library),
                    **tc_bounds(bound_rows_ms, B, n_local, n, m,
                                precision=precision))
            rows_out.append(row)
            check(err <= tol, f"lk_mvm_fused_rows {precision} at "
                              f"{(B, n_local, n, m)}: max err {err:.3e} > "
                              f"tol {tol:.3e}")
        del K1r, K2, mask, u, mask_r, u_r, um_full, out, ref
        torch.cuda.empty_cache()
    return rows_out


def gram_inputs(n: int, p: int, d: int, gen: torch.Generator,
                dtype: torch.dtype = torch.float32):
    """Configurations in [0, 1), lengthscales around 1, in ``dtype``."""
    x1 = torch.rand((n, d), generator=gen, device=DEV, dtype=torch.float64)
    x2 = torch.rand((p, d), generator=gen, device=DEV, dtype=torch.float64)
    ls = torch.exp(0.3 * torch.randn((d,), generator=gen, device=DEV,
                                     dtype=torch.float64))
    return x1.to(dtype), x2.to(dtype), ls.to(dtype)


def gram_no_cast(x1, x2, ls, os_) -> dict:
    """One call's peak of newly allocated device memory against its output's
    bytes: the kernel writes K in x1's dtype itself, so nothing of the size
    of K but K is allocated (a float32 K cast afterwards would add n p 4
    bytes). Returns the numbers; the caller checks them."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = rbf_gram_cuda(x1, x2, ls, os_)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - out.numel() \
        * out.element_size()
    return {"out_bytes": out.numel() * out.element_size(),
            "extra_bytes": extra, "float32_K_bytes": out.numel() * 4}


def gram_rows() -> list[dict]:
    """Kernel K4 against its plain version and the float64 oracle on the
    card at GRAM_SHAPES, float32 and float64 inputs (K in the inputs' dtype,
    outputscale a device tensor), against a second launch bit for bit; timed
    at GRAM_TIMED, where the float64 call is also shown to allocate nothing
    beside K (no cast pass)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 11)
    out_rows = []
    for (n, p, d) in GRAM_SHAPES:
        base = gram_inputs(n, p, d, gen, torch.float64)
        for dtype in GRAM_DTYPES:
            x1, x2, ls = (x.to(dtype) for x in base)
            truth = 1.7 * torch.exp(-0.5 * torch.cdist(
                x1.double() / ls.double(), x2.double() / ls.double()) ** 2)
            os_ = torch.tensor(1.7, device=DEV)
            ref = rbf_gram_plain(x1, x2, ls, os_)
            out = rbf_gram_cuda(x1, x2, ls, os_)
            again = rbf_gram_cuda(x1, x2, ls, os_)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"rbf_gram {dtype} at {(n, p, d)}:"
                  " two launches gave different bits")
            check(out.shape == (n, p) and out.dtype == dtype,
                  f"rbf_gram output {out.shape}/{out.dtype} for {dtype} x")
            check(bool(torch.isfinite(out).all()), "rbf_gram output not finite")
            scale = float(ref.abs().max())
            err = float((out - ref).abs().max())
            err64 = float((out.double() - truth).abs().max())
            tol = GRAM_TOL * scale
            item = torch.empty((), dtype=dtype).element_size()
            plan = plan_gram(n, p, d, sms=device_limits(DEV).sms,
                             limits=device_limits(DEV))
            row = {"name": "rbf_gram", "tpu": "src/repro/kernels/gram.py:81",
                   "precision": "f32", "out_dtype": str(dtype)[6:],
                   "shape": [n, p, d], "max_err": err, "tol": tol,
                   "ref_scale": scale, "max_err_vs_float64": err64,
                   "bitwise_repeat": True,
                   "grid": [plan.blocks], "col_tiles": plan.col_tiles,
                   "row_chunks": plan.row_chunks}
            if (n, p, d) in GRAM_TIMED:
                bound, bound_by = bound_gram_ms(n, p, d, item, item)
                z1, z2 = x1 / ls, x2 / ls
                library = lambda: os_ * torch.exp(  # noqa: E731
                    -0.5 * torch.cdist(z1, z2) ** 2)
                kernel = lambda: rbf_gram_cuda(x1, x2, ls, os_)  # noqa: E731
                row.update(
                    ms=time_ms(kernel), device_ms=device_ms(kernel),
                    plain_ms=time_ms(lambda: rbf_gram_plain(x1, x2, ls, os_)),
                    library_ms=time_ms(library),
                    library_device_ms=device_ms(library),
                    bound_ms=bound, bound_by=bound_by)
                row["store_TBps"] = n * p * item / row["device_ms"] / 1e9
                row["bound_share"] = bound / row["device_ms"]
                del z1, z2
                if dtype == torch.float64:
                    row["no_cast"] = gram_no_cast(x1, x2, ls, os_)
                    check(row["no_cast"]["extra_bytes"] < (1 << 20),
                          f"rbf_gram float64 at {(n, p, d)} allocated "
                          f"{row['no_cast']['extra_bytes']} bytes beside K")
            out_rows.append(row)
            check(err <= tol, f"rbf_gram {dtype} at {(n, p, d)}: max err "
                              f"{err:.3e} > tol {tol:.3e}")
            check(err64 <= tol, f"rbf_gram {dtype} vs float64 at {(n, p, d)}:"
                                f" {err64:.3e} > tol {tol:.3e}")
            del x1, x2, ls, ref, out, again, truth
            torch.cuda.empty_cache()
        del base
    return out_rows


def reference_rows(kernels=("lk_mvm_fused", "lk_mvm_two_stage",
                            "rbf_gram")) -> list[dict]:
    """The CUDA kernels against the reference's own TPU kernels: the inputs
    and outputs of ``tests/fixtures/reference_kernels.npz`` (Pallas in
    interpret mode, ragged small shapes), K1 and K2a + K2b within
    KERNEL_TOL, K4 within GRAM_TOL (float32 and float64 K)."""
    rows = []
    with np.load(REFERENCE_NPZ) as z:
        ref = dict(z)
    dev = lambda a: torch.from_numpy(a).to(DEV)  # noqa: E731
    noise = torch.tensor(float(ref["noise"]), device=DEV)
    i = 0
    while f"mvm{i}_u" in ref:
        K1, K2, mask, u = (dev(ref[f"mvm{i}_{k}"])
                           for k in ("K1", "K2", "mask", "u"))
        for name, fn, key in (("lk_mvm_fused", lk_mvm_fused, "fused"),
                              ("lk_mvm_two_stage", lk_mvm_two_stage,
                               "two_stage")):
            if name not in kernels:
                continue
            want = dev(ref[f"mvm{i}_{key}"])
            got = fn(K1, K2, mask, u, noise)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = KERNEL_TOL["f32"] * float(want.abs().max())
            rows.append({"name": name, "reference": f"lk_mvm_{key}",
                         "shape": list(u.shape), "max_err": err, "tol": tol})
            check(got.dtype == want.dtype and err <= tol,
                  f"{name} vs the reference's kernel at {tuple(u.shape)}: "
                  f"{err:.3e} > {tol:.3e}")
        i += 1
    i = 0
    while "rbf_gram" in kernels and f"gram{i}_x1" in ref:
        x1, x2, ls = (dev(ref[f"gram{i}_{k}"]) for k in ("x1", "x2", "ls"))
        want = dev(ref[f"gram{i}_out"])
        got = rbf_gram_cuda(x1, x2, ls, float(ref["outputscale"]))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = GRAM_TOL * float(want.abs().max())
        rows.append({"name": "rbf_gram", "reference": "rbf_gram_pallas",
                     "shape": [x1.shape[0], x2.shape[0], x1.shape[1]],
                     "dtype": str(got.dtype)[6:], "max_err": err, "tol": tol})
        check(got.dtype == want.dtype and err <= tol,
              f"rbf_gram vs the reference's kernel at {tuple(x1.shape)}: "
              f"{err:.3e} > {tol:.3e}")
        i += 1
    return rows


def make_state(task_seed: int, n: int, m: int, d: int,
               dtype: torch.dtype = torch.float64, **config):
    """A serving state at the prior-mean parameters: synthetic task, the
    transforms fitted to it, carried across through state_from_reference."""
    task = sample_task(task_seed, n=n, m=m, d=d)
    X, t = torch.as_tensor(task.X), torch.as_tensor(task.t)
    Y, mask = torch.as_tensor(task.Y), torch.as_tensor(task.mask)
    x_tf, t_tf, y_tf = XTransform.fit(X), TTransform.fit(t), \
        YTransform.fit(Y, mask)
    params = init_params(d, device="cpu")
    arrays = {"X": task.X, "t": task.t, "Y": task.Y, "mask": task.mask,
              "x_tf.lo": x_tf.lo, "x_tf.hi": x_tf.hi,
              "t_tf.log_t1": t_tf.log_t1, "t_tf.log_tm": t_tf.log_tm,
              "y_tf.shift": y_tf.shift, "y_tf.scale": y_tf.scale}
    arrays.update({f"params.{k}": v for k, v in params._asdict().items()})
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return state_from_reference(arrays, config, dtype=dtype, device=DEV)


class PlainFloat32Engine(IterativeEngine):
    """The cuda engine with the kernel's plain version (float32 library
    products) in the kernel's place: same float32 factors, same float64
    ``accurate`` operator. Tells float32 rounding from the kernel's doing."""

    name = "plain_f32"

    def operator_from_grams(self, K1, K2, mask, noise):
        A = get_engine("cuda").operator_from_grams(K1, K2, mask, noise)
        return LatentKroneckerOperator(*A.fast, mvm=lk_mvm_fused_plain,
                                       accurate=A.accurate)


def sweeps(launched: dict) -> int:
    """MVM sweeps of the cuda engine in a launch count: one launch of K1, or
    one of K2b (each after one of K2a), per sweep."""
    check(launched["lk_mvm_stage_right"] == launched["lk_mvm_stage_left"],
          f"K2a and K2b launched unequally: {launched}")
    return launched["lk_mvm_fused"] + launched["lk_mvm_stage_left"]


class Request:
    """Times one request and holds its solves against the launch counts:
    ``launches`` is the cuda engine's sweeps (K1 or K2a + K2b, whichever the
    tuner routed), or one wrapper's launches when one is given; ``by_kernel``
    each wrapper's."""

    def __init__(self, name: str, wrapper=None):
        self.name = name
        self.wrapper = wrapper

    def __enter__(self):
        torch.cuda.synchronize()
        self.before = launch_counts()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.by_kernel = launch_counts(since=self.before)
        if exc[0] is None:
            self.launches = (sweeps(self.by_kernel) if self.wrapper is None
                             else self.by_kernel[self.wrapper.__name__])
        return False


def route_rows() -> list[dict]:
    """Every bucket the tuner has resolved in this process: the route, how,
    and the candidates' times (ms, one whole wrapper call from an idle
    device, median of 7) and errors against the float64 oracle."""
    return [{"bucket_B_n_m": [k[2], k[0], k[1]], "precision": k[3],
             "device": k[4], "sms": k[5], "route": c.route, "mode": c.mode,
             "times_ms": c.times_ms, "errors": c.errors, "tol": c.tol}
            for k, c in cache_contents().items()]


def phase_routes() -> dict:
    """The route of every (n, m, B) of ROUTE_SHAPES, tuned on the card
    before the paths run (so no request below pays for the timing), with
    the seconds each resolution took."""
    rows = []
    for n, m, B in ROUTE_SHAPES:
        t0 = time.perf_counter()
        route = autotune_route(n, m, B, device=DEV)
        torch.cuda.synchronize()
        rows.append({"shape_B_n_m": [B, n, m], "route": route,
                     "seconds": time.perf_counter() - t0})
    return {"phase": "routes", "resolved": rows, "buckets": route_rows()}


def routed(n: int, m: int, B: int) -> str:
    """The route the cuda engine takes at (B, n, m): the tuner's cached
    choice (resolved in phase_routes)."""
    return autotune_route(n, m, B, device=DEV)


def check_route(req: Request, n: int, m: int, B: int) -> None:
    """The request's sweeps all went through the route the tuner chose at
    (B, n, m), and through nothing else."""
    want = ROUTE_KERNELS[routed(n, m, B)]
    for name, count in req.by_kernel.items():
        expected = req.launches if name in want else 0
        check(count == expected, f"{req.name} at (B, n, m) = {(B, n, m)}: "
              f"{count} launches of {name}, expected {expected} "
              f"(route {routed(n, m, B)})")


def float32_sweep_error(state, x) -> dict:
    """How far one float32 kernel sweep A(x) is from the float64 MVM at a
    solution x, per column, in units of ||A x|| (which is ||b|| to within
    cg_tol). It is why the cuda operator carries ``accurate``: a true
    residual taken through the kernel would be off by this much."""
    K1a, K2 = joint_grams(state)
    A = get_engine("cuda").operator_from_grams(
        K1a[:state.n, :state.n], K2, state.mask,
        torch.exp(state.params.raw_noise))
    want = A.accurate(x)
    gap = A(x) - want
    rel = (torch.sqrt((gap * gap).sum((-2, -1)))
           / torch.sqrt((want * want).sum((-2, -1))))
    return {"max": float(rel.max()), "median": float(rel.median())}


def check_solve(post, req: Request, cg_tol: float) -> dict:
    """Diagnostics of the request's CG solve: every column's TRUE residual
    ||b - A x|| / ||b||, taken through the float64 MVM, held to cg_tol. Every
    iteration is one sweep of the kernel; the true residuals (start, end,
    ``replacements``) are the only sweeps that are not."""
    info = post.solve_info
    check(info is not None, f"{req.name}: no solve diagnostics")
    worst = float(info.rel_residual.max())
    check(not bool(info.breakdown.any()), f"{req.name}: CG breakdown")
    check(worst <= cg_tol, f"{req.name}: residual {worst:.3e} > {cg_tol}")
    return {"iters": int(info.iters), "replacements": info.replacements,
            "worst_rel_residual": worst,
            "columns": int(info.rel_residual.numel()),
            "active_column_mvms": int(info.matvecs)}


def phase_serve(phase: str, n: int, m: int, d: int, n_new: int,
                compare_iterative: bool, time_iterative: bool = False):
    """Returns the phase's record and a closure that measures the float32
    sweep's error at the first request's solution (it launches the kernel,
    so the caller runs it after the launch count has been read).
    ``time_iterative`` also serves ``final()`` and the mean at the new
    configurations through the plain float64 ``iterative`` engine on the same
    state (no kernel), timed beside the ``cuda`` engine's requests."""
    cfg = dict(backend="cuda", posterior_samples=64, seed=SEED)
    state = make_state(SEED, n, m, d, **cfg)
    cg_tol = state.config.cg_tol
    torch.cuda.reset_peak_memory_stats()
    out = {"phase": phase, "n": n, "m": m, "d": d, "dtype": "float64",
           "backend": "cuda", "cg_tol": cg_tol, "requests": []}

    # Request 1: final-value prediction. One stacked solve [y | 64 residuals].
    with Request("final") as req:
        post = posterior(state)
        mean, var = post.final()
    s = check_solve(post, req, cg_tol)
    check(post.solve_count == 1, "final() must be ONE stacked solve")
    check(s["columns"] == 65, "stacked solve must carry 65 columns")
    check(req.launches == s["iters"],
          f"final: {req.launches} sweeps for {s['iters']} CG iterations")
    check_route(req, n, m, 65)
    check(mean.shape == (n,) and var.shape == (n,), "final() shapes")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()
               and (var > 0).all()), "final() values")
    out["requests"].append({"request": "final", "seconds": req.seconds,
                            "launches": req.launches,
                            "route": routed(n, m, 65), **s})
    x_final = post.solve_info.x

    # Request 2: the same again. State cache hit: no solve, no launch.
    with Request("final_again") as req:
        post2 = posterior(state)
        mean2, var2 = post2.final()
    check(post2 is post and post.solve_count == 1, "state cache missed")
    check(req.launches == 0, "cached request launched the kernel")
    check(torch.equal(mean, mean2) and torch.equal(var, var2),
          "cached request changed its answer")
    out["requests"].append({"request": "final_again", "seconds": req.seconds,
                            "launches": 0})

    # Request 3: new configs. Mean (one solve, B=1), then 16 samples (one
    # solve of the 16 residuals; alpha is reused).
    rng = np.random.default_rng(SEED + 1)
    Xs = rng.uniform(0, 1, (n_new, d))
    with Request("new_configs_mean") as req:
        post3 = posterior(state, Xs=Xs)
        mean3 = post3.mean
    answers = {"final": (mean, var), "new_configs_mean": mean3}
    s = check_solve(post3, req, cg_tol)
    check(req.launches == s["iters"], "mean: sweeps != CG iterations")
    check_route(req, n, m, 1)
    check(mean3.shape == (n + n_new, m) and bool(torch.isfinite(mean3).all()),
          "mean at new configs")
    out["requests"].append({"request": "new_configs_mean",
                            "seconds": req.seconds, "launches": req.launches,
                            "route": routed(n, m, 1), **s})
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 2)
    with Request("new_configs_samples") as req:
        samp = post3.samples(gen, 16)
    s = check_solve(post3, req, cg_tol)
    check(post3.solve_count == 2, "samples after mean must be one more solve")
    check(req.launches == s["iters"], "samples: sweeps != CG iterations")
    check_route(req, n, m, 16)
    check(samp.shape == (16, n + n_new, m)
          and bool(torch.isfinite(samp).all()), "samples at new configs")
    out["requests"].append({"request": "new_configs_samples",
                            "seconds": req.seconds, "launches": req.launches,
                            "route": routed(n, m, 16), **s})
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if time_iterative:
        out["iterative"] = iterative_requests(state, Xs, answers)

    if compare_iterative:
        # The same state through the plain float64 MVM on the card, mean
        # only, at the serving tolerance and at a tenth of it. The engines
        # stop after different numbers of iterations (one MVM is float32),
        # each within a small multiple of cg_tol of the exact mean, so the
        # gap must shrink with cg_tol: it is stopping error, not kernel error.
        # "plain_f32" runs the same CG over the kernel's plain version
        # (float32 library products, same operator): if it needs the cuda
        # engine's iterations and not the iterative engine's, the difference
        # is float32 rounding of the MVM, not the hand-written kernel.
        plain_f32 = PlainFloat32Engine()
        out["vs_iterative"] = []
        for tol in (cg_tol, cg_tol / 10):
            means, row = {}, {"cg_tol": tol}
            for backend in ("cuda", "iterative", "plain_f32"):
                st = dataclasses.replace(state, config=dataclasses.replace(
                    state.config, cg_tol=tol,
                    backend="iterative" if backend == "plain_f32" else backend))
                with Request(f"{backend}_mean") as req:
                    p = posterior(st, engine=plain_f32
                                  if backend == "plain_f32" else None)
                    means[backend] = p.mean
                check((req.launches > 0) == (backend == "cuda"),
                      f"{backend} engine: {req.launches} kernel launches")
                row[backend] = {
                    "seconds": req.seconds, "iters": int(p.solve_info.iters),
                    "replacements": p.solve_info.replacements,
                    "rel_residual": float(p.solve_info.rel_residual.max())}
                check(row[backend]["rel_residual"] <= tol,
                      f"{backend} engine at cg_tol={tol}: residual "
                      f"{row[backend]['rel_residual']:.3e}")
            scale = float(means["iterative"].abs().max())
            gap = float((means["cuda"] - means["iterative"]).abs().max())
            row.update(mean_gap=gap, tol=MEAN_TOL_VS_ITERATIVE * tol * scale,
                       scale=scale, mean_gap_plain_f32=float(
                           (means["cuda"] - means["plain_f32"]).abs().max()))
            out["vs_iterative"].append(row)
            check(gap <= row["tol"], f"cuda vs iterative mean at cg_tol={tol}:"
                                     f" gap {gap:.3e} > {row['tol']:.3e}")
    return out, lambda: float32_sweep_error(state, x_final), answers


def iterative_requests(state, Xs, answers) -> list[dict]:
    """``final()`` (B = 65) and the mean at the new configurations through
    the plain float64 ``iterative`` engine (library products, no kernel) on
    the state the ``cuda`` engine just served, at the serving ``cg_tol``:
    seconds, CG iterations, ms per iteration, true residual. Each mean is
    held against the ``cuda`` engine's answer by the MEAN_TOL_VS_ITERATIVE
    rule; neither request may launch a kernel."""
    cg_tol = state.config.cg_tol
    st = dataclasses.replace(state, config=dataclasses.replace(
        state.config, backend="iterative"))
    rows = []
    before = launch_counts()
    for request in ("final", "new_configs_mean"):
        with Request(f"iterative_{request}") as req:
            if request == "final":
                # uncached: a posterior cached on `st` would form a cycle
                # with it and hold its buffers into the next phase
                p = posterior(st, cache=False)
                mean, var = p.final()
                want = answers["final"][0]
            else:
                p = posterior(st, Xs=Xs)
                mean = p.mean
                want = answers["new_configs_mean"]
        info = p.solve_info
        iters = int(info.iters)
        row = {"request": request, "backend": "iterative", "dtype": "float64",
               "seconds": req.seconds, "iters": iters,
               "ms_per_iter": req.seconds / iters * 1e3,
               "replacements": info.replacements,
               "rel_residual": float(info.rel_residual.max()),
               "columns": int(info.rel_residual.numel())}
        scale = float(mean.abs().max())
        row.update(mean_gap_vs_cuda=float((mean - want).abs().max()),
                   tol=MEAN_TOL_VS_ITERATIVE * cg_tol * scale, scale=scale)
        rows.append(row)
        check(not bool(info.breakdown.any()),
              f"iterative {request}: CG breakdown")
        check(row["rel_residual"] <= cg_tol,
              f"iterative {request}: residual {row['rel_residual']:.3e}")
        check(row["mean_gap_vs_cuda"] <= row["tol"],
              f"iterative {request} vs cuda: gap "
              f"{row['mean_gap_vs_cuda']:.3e} > {row['tol']:.3e}")
    launched = launch_counts(since=before)
    check(not any(launched.values()),
          f"the iterative engine launched kernels: {launched}")
    return rows


def phase_exact() -> dict:
    n, m, d, cg_tol = 24, 16, 7, 1e-4
    # An f32 MVM cannot drive the true residual much below 1e-4..1e-5; a
    # tighter tolerance would spin to cg_max_iters.
    state = make_state(SEED + 3, n, m, d, backend="cuda", cg_tol=cg_tol,
                       seed=SEED)
    dense = dataclasses.replace(
        state, config=dataclasses.replace(state.config, backend="dense"))
    with Request("exact") as req:
        post = posterior(state)
        got = post.mean
    check_solve(post, req, cg_tol)
    ref = posterior(dense).mean
    rel = float((got - ref).abs().max() / ref.abs().max())
    check(rel <= 1e-2, f"cuda vs dense mean: relative gap {rel:.3e} > 1e-2")
    return {"phase": "exact", "n": n, "m": m, "cg_tol": cg_tol,
            "rel_gap_vs_dense": rel, "tol": 1e-2, "launches": req.launches}


def solve_summary(res) -> dict:
    return {"iters": int(res.iters), "replacements": res.replacements,
            "worst_rel_residual": float(res.rel_residual.max())}


class SolveLog:
    """Mixin for an engine: keeps a summary of every stacked solve (the
    objective's forward; the gradient solves nothing), not the operators,
    whose autograd graphs would pile up over a fit."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.solves = []

    def solve_stacked(self, *args, **kwargs):
        st = super().solve_stacked(*args, **kwargs)
        self.solves.append(solve_summary(st.result))
        return st


class LoggedIterativeEngine(SolveLog, IterativeEngine):
    pass


class LoggedKernelEngine(SolveLog, KernelEngine):
    pass


class LoggedKernelMVM(KernelMVM):
    """KernelMVM for make_mll_iterative, keeping a summary of the stacked
    solve of each operator it built (read off ``last_result``)."""

    def __init__(self, fused: bool):
        super().__init__(fused=fused)
        self.built = []

    def operator(self, *args):
        self.built.append(super().operator(*args))
        return self.built[-1]

    @property
    def solves(self) -> list:
        return [solve_summary(A.last_result) for A in self.built
                if hasattr(A, "last_result")]


def evaluation_launches(n: int, m: int, iters: list[int],
                        route: str = "cuda") -> dict:
    """Launches of each kernel over MLL evaluations whose stacked solves
    took ``iters`` CG iterations: per evaluation, one sweep per iteration
    at B = slq_probes + 1 and two in the gradient (A(alpha) at B = 1,
    A(probes) at B = slq_probes), each on the route named or, for "cuda",
    the tuner's route of its bucket."""
    probes = FIT_CONFIG["slq_probes"]
    out = {}
    for B, count in ((probes + 1, sum(iters)), (1, len(iters)),
                     (probes, len(iters))):
        r = routed(n, m, B) if route == "cuda" else route
        for name in ROUTE_KERNELS[r]:
            out[name] = out.get(name, 0) + count
    return out


def phase_fit(n: int, m: int, d: int) -> dict:
    """The fit path at full width. (1) MLL value and gradient at the init on
    one set of probes through four MVMs: the float64 iterative engine, the
    routed cuda engine, K1 and K2a + K2b by name; (2) fit with 10 L-BFGS
    iterations on the float64 iterative engine and on the routed cuda
    engine, with the probes fit() draws itself, which are the same: the
    same seeded generator on the same device."""
    task = sample_task(SEED, n=n, m=m, d=d)
    cfg = LKGPConfig(backend="iterative", lbfgs_iters=FIT_LBFGS_ITERS,
                     **FIT_CONFIG)
    cg_tol = cfg.cg_tol
    torch.cuda.reset_peak_memory_stats()
    # The transformed data and the probe draw of fit().
    X, t, Y, mask = (torch.as_tensor(a, device=DEV)
                     for a in (task.X, task.t, task.Y, task.mask))
    Y = torch.where(mask > 0, Y, torch.zeros_like(Y))
    x_tf, t_tf, y_tf = _fit_transforms(X, t, Y, mask)
    data = (x_tf(X), t_tf(t), y_tf(Y), mask)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(cfg.seed)
    probes = rademacher_probes(gen, cfg.slq_probes, mask, torch.float64)
    N = float(mask.sum())
    flat0 = _flatten_params(init_params(d, device=DEV))
    out = {"phase": "fit", **FIT_SHAPE, "n_obs": int(N), "dtype": "float64",
           "config": dataclasses.asdict(cfg), "mll": {}, "fit": {}}

    def value_and_grad(mll, flat):
        x = flat.clone().requires_grad_()
        v = mll(_unflatten_params(x, d), *data, probes)
        (g,) = torch.autograd.grad(v, x)
        return float(v.detach()), g

    # (1) the MLL at the init
    engines = {"iterative": LoggedIterativeEngine(),
               "cuda": LoggedKernelEngine()}
    named = {"fused": LoggedKernelMVM(fused=True),
             "two_stage": LoggedKernelMVM(fused=False)}
    routes = {"iterative": (make_mll(cfg, engines["iterative"]),
                            engines["iterative"]),
              "cuda": (make_mll(cfg, engines["cuda"]), engines["cuda"]),
              **{r: (make_mll_iterative(cfg, mvm_impl=mvm), mvm)
                 for r, mvm in named.items()}}
    values = {}
    for route, (mll, log) in routes.items():
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        v, g = value_and_grad(mll, flat0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts(since=before)
        (solve,) = log.solves
        iters = solve["iters"]
        want = ({} if route == "iterative"
                else evaluation_launches(n, m, [iters], route))
        for name, count in launches.items():
            check(count == want.get(name, 0),
                  f"mll via {route}: {count} launches of {name}, expected "
                  f"{want.get(name, 0)} ({iters} CG iterations + 2)")
        values[route] = (v, g)
        out["mll"][route] = {
            "value": v, "grad": g.tolist(), "seconds": seconds,
            "cg_iters": iters, "replacements": solve["replacements"],
            "worst_rel_residual": solve["worst_rel_residual"],
            "launches": launches}
        check(np.isfinite(v) and bool(torch.isfinite(g).all()),
              f"mll via {route} not finite")
    v64, g64 = values["iterative"]
    for route in ("cuda", "fused", "two_stage"):
        v, g = values[route]
        row = out["mll"][route]
        row["value_gap"] = abs(v - v64) / abs(v64)
        row["grad_gap"] = float((g - g64).abs().max() / g64.abs().max())
        row["value_tol"] = MLL_VALUE_TOL * cg_tol
        row["grad_tol"] = MLL_GRAD_TOL * cg_tol
        check(row["value_gap"] <= row["value_tol"],
              f"mll via {route}: value {v} vs float64 {v64}")
        check(row["grad_gap"] <= row["grad_tol"],
              f"mll via {route}: gradient off by {row['grad_gap']:.3e} of "
              f"max|grad|")

    # (2) fit, 10 L-BFGS iterations, from the same init with the same probes
    objective64 = make_mll(cfg, get_engine("iterative"))

    def f64_objective(params) -> float:
        with torch.no_grad():
            mll = objective64(params, *data, probes)
            return float(-(mll + log_prior(params, d)) / N)

    f_init = f64_objective(_unflatten_params(flat0, d))
    for backend in ("iterative", "cuda"):
        engine = (LoggedIterativeEngine() if backend == "iterative"
                  else LoggedKernelEngine())
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        state = fit(task.X, task.t, task.Y, task.mask,
                    dataclasses.replace(cfg, backend=backend), engine=engine)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts(since=before)
        res = state.fit_result
        solves = engine.solves
        iters = [sv["iters"] for sv in solves]
        check(len(solves) == res.n_evals,
              f"fit via {backend}: {len(solves)} solves, {res.n_evals} evals")
        want = evaluation_launches(n, m, iters) if backend == "cuda" else {}
        for name, count in launches.items():
            check(count == want.get(name, 0),
                  f"fit via {backend}: {count} launches of {name}, expected "
                  f"{want.get(name, 0)}")
        flat = _flatten_params(state.params)
        row = {"seconds": seconds, "n_iters": res.n_iters,
               "n_evals": res.n_evals, "converged": res.converged,
               "ms_per_cg_iter": seconds / sum(iters) * 1e3,
               "fun": res.fun, "f_init": f_init,
               "raw_params": flat.tolist(),
               "cg_iters_per_eval": statistics.mean(iters),
               "cg_iters_total": sum(iters),
               "worst_rel_residual": max(sv["worst_rel_residual"]
                                         for sv in solves),
               "launches": launches}
        if backend == "cuda":
            # the cuda fit's parameters on the float64 iterative objective
            row["fun_float64_objective"] = f64_objective(state.params)
        out["fit"][backend] = row
        check(np.isfinite(res.fun) and bool(torch.isfinite(flat).all()),
              f"fit via {backend}: not finite")
        check(res.fun < f_init and row.get("fun_float64_objective",
                                           res.fun) < f_init,
              f"fit via {backend}: objective {res.fun} not below the "
              f"init's {f_init}")
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


# The warm phase: the freeze-thaw loop at the fit phase's LCBench shape on the
# routed cuda engine (float64 state): a polished fit from the default init
# (twice, for the bits), then more epochs and a polished refit, then new
# configurations and a polished refit. Depth cut: 3 and 2 polish steps.
WARM_POLISH_STEPS = 3
WARM_REFIT_STEPS = 2
WARM_MORE_EPOCHS = 4
WARM_NEW_CONFIGS = 48   # n = 2000 + 48 = 2048: the same tuner bucket


class WarmStep(Request):
    """A Request over a polish on a logging engine: also the evaluations
    (stacked solves) it ran and their CG iterations, and its launches held
    to ``evaluation_launches`` of those iterations."""

    def __init__(self, name: str, engine, n: int, m: int):
        super().__init__(name)
        self.engine, self.n, self.m = engine, n, m

    def __enter__(self):
        self.first = len(self.engine.solves)
        return super().__enter__()

    def row(self, res=None) -> dict:
        iters = [sv["iters"] for sv in self.engine.solves[self.first:]]
        want = evaluation_launches(self.n, self.m, iters)
        for name, count in self.by_kernel.items():
            check(count == want.get(name, 0),
                  f"{self.name}: {count} launches of {name}, expected "
                  f"{want.get(name, 0)} for CG iterations {iters}")
        if res is not None:
            check(len(iters) == res.n_evals,
                  f"{self.name}: {len(iters)} solves, {res.n_evals} evals")
        B = FIT_CONFIG["slq_probes"]
        return {"step": self.name, "seconds": self.seconds,
                "evaluations": len(iters),
                "cg_iters_per_eval": (statistics.mean(iters) if iters
                                      else 0.0),
                "cg_iters": iters, "launches": self.by_kernel,
                "routes": {f"B={b}": routed(self.n, self.m, b)
                           for b in (B + 1, 1, B)}}


def start_memory() -> int:
    """Free what earlier phases left in reference cycles (a state and the
    posterior cached on it), reset the peak, and return the device memory
    still allocated: a phase's ``peak_memory_bytes`` includes it."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def grown_mask(task, extra: int) -> tuple[np.ndarray, np.ndarray]:
    """The task's curves each ``extra`` epochs further (capped at m)."""
    m = task.mask.shape[1]
    lens = np.minimum(task.mask.sum(1).astype(np.int64) + extra, m)
    mask = (np.arange(m)[None, :] < lens[:, None]).astype(np.float64)
    return task.Y_full * mask, mask


def f64_objective(state) -> float:
    """The state's parameters on the float64 iterative objective of its own
    data, with the probes fit() draws for it (same seeded generator)."""
    cfg = state.config
    data = state.data
    gen = torch.Generator(device=DEV)
    gen.manual_seed(cfg.seed)
    probes = rademacher_probes(gen, cfg.slq_probes, data.mask, torch.float64)
    mll = make_mll(dataclasses.replace(cfg, backend="iterative"),
                   get_engine("iterative"))
    with torch.no_grad():
        v = mll(state.params, data.X, data.t, data.Y, data.mask, probes)
        return float(-(v + log_prior(state.params, state.d))
                     / data.mask.sum())


def phase_warm(n: int, m: int, d: int, n_new: int = 256) -> dict:
    """The freeze-thaw loop through the routed cuda engine: (1) ``fit`` with
    ``polish_steps=3`` from the default init (13 evaluations, each the
    stacked solve's CG iterations plus 2 sweeps); (2) the same again, which
    must give the same bits; (3) ``extend`` with every cut-off curve 4 epochs
    longer, ``refit(polish_steps=2)``, ``final()`` held against the
    ``iterative`` engine's; (4) ``extend`` with 48 new configurations,
    ``refit(polish_steps=2)``, the mean at ``n_new`` new configurations held
    against the ``iterative`` engine's, and the polished parameters scored
    on the float64 objective."""
    task = sample_task(SEED, n=n, m=m, d=d)
    cfg = LKGPConfig(backend="cuda", **FIT_CONFIG)
    cg_tol = cfg.cg_tol
    out = {"phase": "warm", "n": n, "m": m, "d": d, "dtype": "float64",
           "backend": "cuda", "cg_tol": cg_tol, "steps": [],
           "allocated_at_start_bytes": start_memory()}

    # (1) and (2): the polished fit, twice from the same inputs
    fits = []
    for name in ("polish_fit", "polish_fit_again"):
        engine = LoggedKernelEngine()
        with WarmStep(name, engine, n, m) as req:
            state = fit(task.X, task.t, task.Y, task.mask, cfg,
                        engine=engine, polish_steps=WARM_POLISH_STEPS)
        res = state.fit_result
        row = req.row(res)
        row.update(fun=res.fun, optimizer=res.optimizer,
                   n_evals=res.n_evals, converged=res.converged)
        check(res.optimizer == "polish" and res.n_evals ==
              1 + 4 * WARM_POLISH_STEPS, f"{name}: {res.optimizer}, "
              f"{res.n_evals} evaluations")
        fits.append(state)
        out["steps"].append(row)
    state, again = fits
    f_init = f64_objective(dataclasses.replace(
        state, params=init_params(d, device=DEV)))
    f_fit = f64_objective(state)
    res = state.fit_result
    out["steps"][0].update(f_init_float64=f_init, fun_float64_objective=f_fit)
    check(np.isfinite(res.fun) and res.fun < f_init and f_fit < f_init,
          f"polish fit: objective {res.fun} (float64 {f_fit}) not below "
          f"the init's {f_init}")
    check(np.array_equal(res.x, again.fit_result.x),
          "two polishes from the same inputs gave different bits")
    out["polish_bitwise_repeat"] = True
    del again, fits

    # (3) more epochs, refit, final() against the iterative engine
    new_Y, new_mask = grown_mask(task, WARM_MORE_EPOCHS)
    grown = extend(state, new_Y, new_mask)
    check(grown.fit_result is None and grown.engine is state.engine,
          "extend must clear the fit and carry the engine")
    engine = state.engine
    with WarmStep("more_epochs_refit", engine, n, m) as req:
        state = refit(grown, polish_steps=WARM_REFIT_STEPS)
    row = req.row(state.fit_result)
    row.update(fun=state.fit_result.fun,
               observed=int(new_mask.sum()), observed_before=int(
                   task.mask.sum()))
    check(state.config == cfg and np.isfinite(state.fit_result.fun),
          "refit: config persisted or objective not finite")
    out["steps"].append(row)
    with Request("more_epochs_final") as req:
        post = posterior(state)
        mean, var = post.final()
    s = check_solve(post, req, cg_tol)
    check(req.launches == s["iters"], "final: sweeps != CG iterations")
    check_route(req, n, m, cfg.posterior_samples + 1)
    st_it = dataclasses.replace(state, config=dataclasses.replace(
        state.config, backend="iterative"))
    with Request("more_epochs_final_iterative") as req_it:
        post_it = posterior(st_it, cache=False)
        mean_it, var_it = post_it.final()
    check(not any(req_it.by_kernel.values()),
          "the iterative engine launched kernels")
    scale = float(mean_it.abs().max())
    gap = float((mean - mean_it).abs().max())
    tol = MEAN_TOL_VS_ITERATIVE * cg_tol * scale
    out["steps"].append({
        "step": "more_epochs_final", "seconds": req.seconds,
        "launches": req.by_kernel, "route": routed(
            n, m, cfg.posterior_samples + 1), **s,
        "iterative": {"seconds": req_it.seconds,
                      "iters": int(post_it.solve_info.iters)},
        "mean_gap_vs_iterative": gap, "tol": tol, "scale": scale,
        "var_gap_vs_iterative": float((var - var_it).abs().max())})
    check(bool(torch.isfinite(mean).all() and (var > 0).all()),
          "final() after refit: values")
    check(gap <= tol, f"final() after refit vs iterative: gap {gap:.3e} > "
                      f"{tol:.3e}")
    del post, post_it, st_it

    # (4) new configurations, refit, mean at new configurations
    extra = sample_task(SEED + 5, n=WARM_NEW_CONFIGS, m=m, d=d)
    wider = extend(state, extra.Y, extra.mask, new_X=extra.X)
    f_start = f64_objective(wider)
    n2 = wider.n
    with WarmStep("new_configs_refit", engine, n2, m) as req:
        state = refit(wider, polish_steps=WARM_REFIT_STEPS)
    row = req.row(state.fit_result)
    f_end = f64_objective(state)
    row.update(n=n2, fun=state.fit_result.fun,
               f_start_float64=f_start, fun_float64_objective=f_end)
    check(np.isfinite(state.fit_result.fun) and np.isfinite(f_end),
          "refit on new configurations: objective not finite")
    out["steps"].append(row)
    Xs = np.random.default_rng(SEED + 6).uniform(0, 1, (n_new, d))
    with Request("new_configs_mean") as req:
        post = posterior(state, Xs=Xs)
        mean = post.mean
    s = check_solve(post, req, cg_tol)
    check(req.launches == s["iters"], "mean: sweeps != CG iterations")
    check_route(req, n2, m, 1)
    check(mean.shape == (n2 + n_new, m) and bool(torch.isfinite(mean).all()),
          "mean at new configurations after refit")
    st_it = dataclasses.replace(state, config=dataclasses.replace(
        state.config, backend="iterative"))
    with Request("new_configs_mean_iterative") as req_it:
        post_it = posterior(st_it, Xs=Xs, cache=False)
        mean_it = post_it.mean
    check(not any(req_it.by_kernel.values()),
          "the iterative engine launched kernels")
    scale = float(mean_it.abs().max())
    gap = float((mean - mean_it).abs().max())
    tol = MEAN_TOL_VS_ITERATIVE * cg_tol * scale
    out["steps"].append({
        "step": "new_configs_mean", "n": n2, "seconds": req.seconds,
        "launches": req.by_kernel, "route": routed(n2, m, 1), **s,
        "iterative": {"seconds": req_it.seconds,
                      "iters": int(post_it.solve_info.iters)},
        "mean_gap_vs_iterative": gap, "tol": tol, "scale": scale})
    check(gap <= tol, f"mean at new configurations after refit vs "
                      f"iterative: gap {gap:.3e} > {tol:.3e}")
    del post, post_it, st_it
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


# The batch phase: 16 synthetic tasks, float64, the exact dense path.
BATCH_TASKS = 16
BATCH_SHAPE = dict(n=48, m=20, d=4)
BATCH_POLISH_STEPS = 3
BATCH_LBFGS_ITERS = 20   # depth cut (default 100)
BATCH_POSTERIOR_TOL = 1e-9   # relative, against the lazy dense Posterior
LCBENCH_FIXTURE = "tests/fixtures/lcbench_mini.npz"


def phase_batch() -> dict:
    """The batched dense path on the card: (1) ``fit_batch`` with the polish,
    every task bitwise equal to ``fit(task, backend="dense")`` with the same
    polish; (2) ``fit_batch`` with L-BFGS beside the sum of the per-task
    fits; (3) ``posterior_batch`` of all 16 tasks against each task alone
    (``stack_states([s_i])``): mean and exact final bitwise equal; (4) each
    task against the lazy ``Posterior`` on ``dense``; (5) the LCBench
    fixture through ``get_source``, ``stack_suite(pad=True)``,
    ``fit_batch`` and ``posterior_batch``. No MVM kernel runs here."""
    root = Path(__file__).resolve().parent
    out = {"phase": "batch", "tasks": BATCH_TASKS, **BATCH_SHAPE,
           "N": BATCH_SHAPE["n"] * BATCH_SHAPE["m"], "dtype": "float64",
           "allocated_at_start_bytes": start_memory()}
    before = launch_counts()
    t_phase = time.perf_counter()
    tasks = sample_suite(SEED, BATCH_TASKS, **BATCH_SHAPE)
    X, t, Y, mask, _ = stack_suite(tasks)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, time.perf_counter() - t0

    # (1) polish: batch against per task, bit for bit
    cfg = LKGPConfig()
    batch, sec_batch = timed(lambda: fit_batch(
        X, t, Y, mask, cfg, polish_steps=BATCH_POLISH_STEPS))
    singles, sec_single = timed(lambda: [
        fit(tk.X, tk.t, tk.Y, tk.mask, LKGPConfig(backend="dense"),
            polish_steps=BATCH_POLISH_STEPS) for tk in tasks])
    equal = [bool(np.array_equal(batch.fit_result.x[i], s.fit_result.x)
                  and all(torch.equal(a, b) for a, b in zip(b_i.params,
                                                            s.params)))
             for i, (b_i, s) in enumerate(zip(unstack(batch), singles))]
    out["polish"] = {"seconds_fit_batch": sec_batch,
                     "seconds_per_task_fits": sec_single,
                     "fun": batch.fit_result.fun,
                     "n_evals": batch.fit_result.n_evals,
                     "bitwise_equal_to_fit": equal}
    check(all(equal), f"fit_batch polish != per-task fit polish: {equal}")
    check(batch.fit_result.fun == float(sum(s.fit_result.fun
                                            for s in singles)),
          "fit_batch polish objective != the sum of the per-task fits'")

    # (2) L-BFGS on the summed objective, beside the per-task fits
    lb_cfg = LKGPConfig(lbfgs_iters=BATCH_LBFGS_ITERS)
    lb, sec_lb = timed(lambda: fit_batch(X, t, Y, mask, lb_cfg))
    per, sec_per = timed(lambda: [
        fit(tk.X, tk.t, tk.Y, tk.mask, dataclasses.replace(
            lb_cfg, backend="dense")) for tk in tasks])
    out["lbfgs"] = {"lbfgs_iters": BATCH_LBFGS_ITERS,
                    "seconds_fit_batch": sec_lb, "fun": lb.fit_result.fun,
                    "n_evals": lb.fit_result.n_evals,
                    "n_iters": lb.fit_result.n_iters,
                    "seconds_per_task_fits": sec_per,
                    "fun_sum_per_task": float(sum(s.fit_result.fun
                                                  for s in per)),
                    "n_evals_sum_per_task": sum(s.fit_result.n_evals
                                                for s in per)}
    check(np.isfinite(lb.fit_result.fun), "fit_batch L-BFGS: not finite")
    del per, lb

    # (3) posterior_batch: B = 16 against B = 1, bit for bit
    states = unstack(batch)
    full, sec_full = timed(lambda: posterior_batch(stack_states(states)))
    (mean16, var16), sec_final = timed(full.final)
    sec_one, bitwise = 0.0, []
    for i, st in enumerate(states):
        one, sec = timed(lambda: posterior_batch(stack_states([st])))
        (m1, v1), sec2 = timed(one.final)
        sec_one += sec + sec2
        bitwise.append(bool(torch.equal(one.mean[0], full.mean[i])
                            and torch.equal(m1[0], mean16[i])
                            and torch.equal(v1[0], var16[i])))
    out["posterior_batch"] = {"seconds_B16": sec_full + sec_final,
                              "seconds_16_times_B1": sec_one,
                              "bitwise_B1_equals_B16": bitwise}
    check(all(bitwise), f"posterior_batch B=1 != B=16: {bitwise}")
    check(bool(torch.isfinite(mean16).all() and (var16 > 0).all()),
          "posterior_batch final(): values")

    # (4) each task against the lazy dense posterior
    gaps = []
    for i, st in enumerate(states):
        lazy = posterior(dataclasses.replace(st, config=dataclasses.replace(
            st.config, backend="dense")), cache=False)
        want = lazy.mean
        gaps.append(float((full.mean[i] - want).abs().max()
                          / want.abs().max()))
    out["vs_lazy_dense"] = {"max_rel_gap": max(gaps),
                            "tol": BATCH_POSTERIOR_TOL}
    check(max(gaps) <= BATCH_POSTERIOR_TOL,
          f"posterior_batch vs dense Posterior: {max(gaps):.3e}")

    # (5) the LCBench fixture, padded
    src = get_source(f"lcbench:{root / LCBENCH_FIXTURE}")
    Xl, tl, Yl, ml, _ = stack_suite(src.tasks(), pad=True)
    fixture, sec_fix = timed(lambda: fit_batch(
        Xl, tl, Yl, ml, cfg, polish_steps=BATCH_POLISH_STEPS))
    (fm, fv), sec_fix_post = timed(lambda: posterior_batch(fixture).final())
    out["lcbench"] = {"dataset_id": src.dataset_id,
                      "shape": list(Xl.shape[:2]) + [tl.shape[-1]],
                      "seconds_fit_batch": sec_fix,
                      "seconds_final": sec_fix_post,
                      "fun": fixture.fit_result.fun}
    check(fm.shape == (Xl.shape[0], Xl.shape[1])
          and bool(torch.isfinite(fm).all() and (fv > 0).all()),
          "LCBench fixture: final() values")
    launched = launch_counts(since=before)
    check(not any(launched.values()),
          f"the batched dense path launched MVM kernels: {launched}")
    out["seconds"] = time.perf_counter() - t_phase
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


# The distributed phase (its tolerances fixed before the first run on the
# card, PERF.md). A float32 state of the serve task is served through the
# distributed engine, every CG sweep one launch of K3; the float32 CG has no
# float64 operator to take its residuals from, so it stops on its own
# recursion, and its answer is held against the cuda engine's on the float64
# state (the same draws) within a few times the stopping error of two
# correct solves. Mean: 3.8 cg_tol * max|mean| measured between the cuda and
# iterative engines at n = 2000 on an H100 (phase serve_lcbench). Variance: a
# solve stopped at cg_tol moves each Matheron sample by about cg_tol times
# the prior's scale, so the variance moves by up to ~2 sqrt(var) * cg_tol *
# prior std, far more than cg_tol * var where the posterior is narrow;
# measured on the CPU at n = 1000: 6 of these units between the float32
# distributed and the float64 engines, 5.4 between two float64 engines.
DIST_MEAN_TOL = 10.0    # times cg_tol * max|mean| of the float64 answer
DIST_VAR_TOL = 20.0     # times cg_tol * sqrt(max var) * prior std (y units)
# The float64 fit through the distributed engine's exact body against the
# iterative engine's fit (same probes, same init): the same arithmetic in
# another layout, so the same objective up to rounding.
DIST_FIT_TOL = 1e-6     # relative gap of the final objectives
# dist_mll_value (its own CG, the reference's, to 1e-6) against the
# iterative engine's solve to the same tolerance.
DIST_MLL_CG_TOL = 1e-6
DIST_MLL_TOL = 1e-4     # relative gap of -1/2 y^T K^-1 y
RENDEZVOUS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


def init_process_group(backend: str = "nccl") -> Path:
    """One rank, rendezvous through a file inside the checkout (no ports, no
    network). Raises if the backend cannot start: there is no fallback."""
    RENDEZVOUS_DIR.mkdir(parents=True, exist_ok=True)
    path = RENDEZVOUS_DIR / f"rendezvous-{os.getpid()}-{time.time_ns()}"
    if backend == "nccl":
        torch.cuda.set_device(DEV)
    dist.init_process_group(backend, init_method=f"file://{path}", rank=0,
                            world_size=1)
    return path


def close_process_group(path: Path) -> None:
    dist.destroy_process_group()
    path.unlink(missing_ok=True)


def default_draws(n: int, m: int, s: int, seed: int):
    """The standard normals (Z, E) of a state's default posterior samples:
    stream (seed, 1), float64, as ``Posterior`` draws them."""
    stream = sys.modules["repro_torch.core.posterior"]._stream
    gen = stream(seed, 1, DEV)
    Z = torch.randn((s, n, m), dtype=torch.float64, device=DEV, generator=gen)
    E = torch.randn((s, n, m), dtype=torch.float64, device=DEV, generator=gen)
    return Z, E


def float64_residuals(state, x, normals) -> torch.Tensor:
    """||b - A x|| / ||b|| per column of the stacked solve [y | residuals] of
    a float32 state's final(), with A and b taken in float64 from the same
    float32 Gram factors and draws (made as ``Posterior`` makes them, from
    float64 Grams): the float32 CG's own error."""
    cfg = state.config
    n = state.n
    K1a, K2 = joint_grams(state)
    K1d, K2d = joint_grams(state, dtype=torch.float64)
    noise = torch.exp(state.params.raw_noise)
    F, eps = prior_residual_draws(None, K1d, K2d, n, noise.double(),
                                  x.shape[0] - 1, jitter=cfg.jitter,
                                  normals=normals)
    del K1d, K2d
    resid = state.mask * (F[:, :n].to(K1a.dtype) + eps.to(K1a.dtype))
    b = torch.cat([(state.y_tf(state.Y) * state.mask)[None], resid]).double()
    del F, eps, resid
    r = b - lk_mvm(K1a[:n, :n].double(), K2.double(), state.mask.double(),
                   x.double(), noise.double())
    return torch.linalg.vector_norm(r, dim=(-2, -1)) \
        / torch.linalg.vector_norm(b, dim=(-2, -1))


def phase_distributed(n: int, m: int, d: int, n_new: int,
                      reference: dict | None = None,
                      reference_fit: dict | None = None) -> dict:
    """The distributed engine inside the initialised process group.

    (1) A float32 state of the serve task (prior-mean parameters) served
    through ``posterior(state, engine=DistributedEngine())``: ``final()``
    (one stacked solve, B = 65; its default draws are the float64 state's,
    both made in float64 from stream (seed, 1)) and the
    mean at ``n_new`` new configurations, every CG sweep one launch of K3
    (iterations + 2: the float32 CG's start and end residuals go through the
    same operator). Held against the cuda engine on the float64 state
    (``reference``: the serve phase's answers, recomputed when absent).
    (2) ``fit`` with ``backend="distributed"`` on the float64 LCBench task
    (exact body, no kernel) against the iterative engine's fit
    (``reference_fit``, recomputed when absent). (3) ``dist_mll_value`` at
    the same shape."""
    from repro_torch.distributed import gather_rows, group_layout
    group, _, world = group_layout()
    check(group is not None and world == 1,
          "the distributed phase needs a process group of one rank")
    out = {"phase": "distributed", "backend": dist.get_backend(group),
           "world_size": world, "n": n, "m": m, "d": d, "dtype": "float32"}
    # The one collective per sweep, alone: the all-gather of the output rows
    # at the serving sweep's shape (float32) and the fit's (float64).
    out["all_gather_ms"] = {}
    for B, gn, gm, dt in ((65, n, m, torch.float32),
                          (FIT_CONFIG["slq_probes"] + 1, FIT_SHAPE["n"],
                           FIT_SHAPE["m"], torch.float64)):
        x = torch.zeros((B, gn, gm), dtype=dt, device=DEV)
        out["all_gather_ms"][f"{(B, gn, gm)} {dt}".replace("torch.", "")] = \
            time_ms(lambda: gather_rows(x, group, world))
        del x
    s = 64
    st32 = make_state(SEED, n, m, d, dtype=torch.float32, backend="distributed",
                      posterior_samples=s, seed=SEED)
    cg_tol = st32.config.cg_tol
    rng = np.random.default_rng(SEED + 1)
    Xs = rng.uniform(0, 1, (n_new, d))
    if reference is None:
        st64 = make_state(SEED, n, m, d, backend="cuda", posterior_samples=s,
                          seed=SEED)
        reference = {"final": posterior(st64).final(),
                     "new_configs_mean": posterior(st64, Xs=Xs).mean}
        del st64
    normals = default_draws(n, m, s, SEED)
    engine = DistributedEngine()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold: peak_memory_bytes includes it
    out["allocated_at_start_bytes"] = torch.cuda.memory_allocated()
    before = launch_counts()

    with Request("final", lk_mvm_fused_rows) as req:
        post = posterior(st32, engine=engine)
        mean, var = post.final()
    info = post.solve_info
    iters = int(info.iters)
    check(post._operator.fused, "float32 state: the operator must take K3")
    check(post.solve_count == 1 and info.x.shape[0] == s + 1,
          "final() must be ONE stacked solve of 65 columns")
    check(req.launches == iters + 2,
          f"final: {req.launches} K3 launches for {iters} CG iterations + 2")
    check(not bool(info.breakdown.any()), "final: CG breakdown")
    check(mean.shape == (n,) and var.shape == (n,)
          and bool(torch.isfinite(mean).all() and torch.isfinite(var).all()
                   and (var > 0).all()), "final() values")
    rel64 = float64_residuals(st32, info.x, normals)
    mean64, var64 = reference["final"]
    row = {"request": "final", "seconds": req.seconds,
           "launches": req.launches, "iters": iters,
           "columns": int(info.rel_residual.numel()),
           "cg_rel_residual_max": float(info.rel_residual.max()),
           "cg_rel_residual_median": float(info.rel_residual.median()),
           "float64_rel_residual_max": float(rel64.max()),
           "float64_rel_residual_median": float(rel64.median()),
           "mean_gap": float((mean.double() - mean64).abs().max()),
           "mean_scale": float(mean64.abs().max()),
           "var_gap": float((var.double() - var64).abs().max()),
           "var_scale": float(var64.abs().max())}
    prior_std = float(torch.sqrt(st32.y_tf.inverse_var(
        torch.exp(st32.params.raw_outputscale.double()))))
    row["mean_tol"] = DIST_MEAN_TOL * cg_tol * row["mean_scale"]
    row["var_tol"] = (DIST_VAR_TOL * cg_tol * row["var_scale"] ** 0.5
                      * prior_std)
    row["prior_std"] = prior_std
    out["requests"] = [row]
    check(row["mean_gap"] <= row["mean_tol"],
          f"distributed final mean vs cuda float64: {row['mean_gap']:.3e} > "
          f"{row['mean_tol']:.3e}")
    check(row["var_gap"] <= row["var_tol"],
          f"distributed final variance vs cuda float64: {row['var_gap']:.3e} "
          f"> {row['var_tol']:.3e}")
    del post, info, rel64

    with Request("new_configs_mean", lk_mvm_fused_rows) as req:
        post3 = posterior(st32, Xs=Xs, engine=engine)
        mean3 = post3.mean
    info = post3.solve_info
    iters = int(info.iters)
    check(req.launches == iters + 2,
          f"mean: {req.launches} K3 launches for {iters} CG iterations + 2")
    check(mean3.shape == (n + n_new, m) and bool(torch.isfinite(mean3).all()),
          "mean at new configs")
    want = reference["new_configs_mean"]
    row = {"request": "new_configs_mean", "seconds": req.seconds,
           "launches": req.launches, "iters": iters,
           "cg_rel_residual": float(info.rel_residual.max()),
           "mean_gap": float((mean3.double() - want).abs().max()),
           "mean_scale": float(want.abs().max())}
    row["mean_tol"] = DIST_MEAN_TOL * cg_tol * row["mean_scale"]
    out["requests"].append(row)
    check(row["mean_gap"] <= row["mean_tol"],
          f"distributed mean at new configs vs cuda float64: "
          f"{row['mean_gap']:.3e} > {row['mean_tol']:.3e}")
    served = launch_counts(since=before)
    out["serve_launches"] = served
    check(all(v == 0 for k, v in served.items() if k != "lk_mvm_fused_rows"),
          f"the float32 distributed path launched other kernels: {served}")
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del post3, mean3, st32
    torch.cuda.empty_cache()

    # (2) float64 fit through the exact body, at the fit phase's shape
    fn, fm, fd = FIT_SHAPE["n"], FIT_SHAPE["m"], FIT_SHAPE["d"]
    task = sample_task(SEED, n=fn, m=fm, d=fd)
    cfg = LKGPConfig(backend="distributed", lbfgs_iters=FIT_LBFGS_ITERS,
                     **FIT_CONFIG)
    if reference_fit is None:
        ref_state = fit(task.X, task.t, task.Y, task.mask,
                        dataclasses.replace(cfg, backend="iterative"))
        reference_fit = {"fun": ref_state.fit_result.fun,
                         "n_evals": ref_state.fit_result.n_evals}
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    state = fit(task.X, task.t, task.Y, task.mask, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts(since=before)
    res = state.fit_result
    gap = abs(res.fun - reference_fit["fun"]) / abs(reference_fit["fun"])
    out["fit"] = {"n": fn, "m": fm, "d": fd, "dtype": "float64",
                  "seconds": seconds, "n_iters": res.n_iters,
                  "n_evals": res.n_evals, "fun": res.fun,
                  "fun_iterative": reference_fit["fun"],
                  "n_evals_iterative": reference_fit["n_evals"],
                  "fun_gap": gap, "fun_tol": DIST_FIT_TOL,
                  "launches": launches}
    check(state.backend_used == "distributed", "fit did not use the engine")
    check(all(v == 0 for v in launches.values()),
          f"the float64 distributed fit launched a kernel: {launches}")
    check(np.isfinite(res.fun) and gap <= DIST_FIT_TOL,
          f"distributed fit objective {res.fun} vs iterative "
          f"{reference_fit['fun']}: gap {gap:.3e}")

    # (3) dist_mll_value at the same shape, prior-mean parameters
    X, t, Y, mask = (torch.as_tensor(a, device=DEV)
                     for a in (task.X, task.t, task.Y, task.mask))
    Y = torch.where(mask > 0, Y, torch.zeros_like(Y))
    x_tf, t_tf, y_tf = _fit_transforms(X, t, Y, mask)
    Xn, tn, Yn = x_tf(X), t_tf(t), y_tf(Y)
    p0 = init_params(fd, device=DEV)
    pos = [torch.exp(r) for r in p0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quad, q_iters, q_rel = dist_mll_value(*pos, Xn, tn, Yn, mask,
                                          cg_tol=DIST_MLL_CG_TOL)
    torch.cuda.synchronize()
    q_seconds = time.perf_counter() - t0
    K1, K2 = gram_matrices(p0, Xn, tn)
    ref_cfg = LKGPConfig(cg_tol=DIST_MLL_CG_TOL)
    A = IterativeEngine().operator_from_grams(K1, K2, mask, pos[3])
    alpha = IterativeEngine().solve(A, Yn * mask, ref_cfg)
    quad_ref = float(-0.5 * (Yn * mask * alpha).sum())
    q_gap = abs(float(quad) - quad_ref) / abs(quad_ref)
    out["dist_mll_value"] = {"quad": float(quad), "iters": q_iters,
                             "rel_residual": float(q_rel),
                             "seconds": q_seconds, "quad_iterative": quad_ref,
                             "cg_tol": DIST_MLL_CG_TOL, "gap": q_gap,
                             "tol": DIST_MLL_TOL}
    check(float(q_rel) <= DIST_MLL_CG_TOL and q_gap <= DIST_MLL_TOL,
          f"dist_mll_value {float(quad)} vs iterative {quad_ref}: gap "
          f"{q_gap:.3e}, residual {float(q_rel):.3e}")
    return out


def phase_gram(shapes=((8192, 64), (2000, 52))) -> dict:
    """``rbf_gram_op`` (kernel K4) on the serve task's normalised configs
    (n = 8192) and at the LCBench shape (n = 2000), d = 7, prior-mean
    lengthscales, float64 as the state holds them: K comes back in float64
    from the kernel itself (nothing of K's size allocated beside it), equal
    bit for bit over two calls, against the plain version and against K1 of
    ``gram_matrices`` (float64, exact) minus its jitter; then K4 against the
    reference's TPU kernel's outputs (the .npz)."""
    out = {"phase": "gram", "shapes": []}
    for n, m in shapes:
        state = make_state(SEED, n, m, 7)
        Xn, tn = state.x_tf(state.X), state.t_tf(state.t)
        ls = torch.exp(state.params.raw_x_lengthscale)
        cfg = state.config
        before = rbf_gram_cuda.launches
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        K = rbf_gram_op(Xn, Xn, ls)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        extra = torch.cuda.max_memory_allocated() - base \
            - K.numel() * K.element_size()
        launches = rbf_gram_cuda.launches - before
        again = rbf_gram_op(Xn, Xn, ls)
        K1, _ = gram_matrices(state.params, Xn, tn, cfg.t_kernel, cfg.jitter)
        K1 = K1 - cfg.jitter * torch.eye(n, dtype=K1.dtype, device=DEV)
        plain = rbf_gram_plain(Xn, Xn, ls)
        tol = GRAM_TOL * float(K1.abs().max())
        row = {"n": n, "d": 7, "dtype": str(K.dtype).replace("torch.", ""),
               "seconds": seconds, "launches": launches,
               "extra_bytes_beside_K": extra,
               "max_err_vs_plain": float((K - plain).abs().max()),
               "max_err_vs_gram_matrices": float((K - K1).abs().max()),
               "tol": tol}
        out["shapes"].append(row)
        check(launches == 1, f"rbf_gram_op at n={n}: {launches} launches")
        check(K.shape == (n, n) and K.dtype == torch.float64,
              f"rbf_gram_op output {K.shape}/{K.dtype}")
        check(extra < (1 << 20), f"rbf_gram_op at n={n} allocated {extra} "
                                 f"bytes beside its float64 K")
        check(torch.equal(K, again), f"rbf_gram_op at n={n}: two calls gave "
                                     "different bits")
        check(row["max_err_vs_plain"] <= tol
              and row["max_err_vs_gram_matrices"] <= tol,
              f"rbf_gram_op at n={n}: {row}")
        del K, again, K1, plain, state
        torch.cuda.empty_cache()
    out["reference"] = reference_rows(("rbf_gram",))
    return out


def build_all() -> dict:
    """Compile every kernel source at once (one nvcc process each)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for lib in pool.map(load_library, KERNEL_SOURCES):
            check(lib is not None, "library did not load")
    logs = {}
    for name in KERNEL_SOURCES:
        log = build_log(name)
        logs[name] = {
            "nvcc_seconds": log["seconds"], "cached": log["cached"],
            "ptxas": [ln for ln in log["compiler_output"].splitlines()
                      if "registers" in ln or "spill" in ln]}
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "tc_tile": [TC_ROWS, TC_COLS, TC_K], "libraries": logs,
            **budget_rows()}


def budget_rows() -> dict:
    """The budget model (kernels/budget.py) of every kernel instantiation
    against what the CUDA runtime reports for it at its launch: shared
    memory (static and dynamic) and threads equal, registers within the
    ``__launch_bounds__`` cap, and the model's blocks per SM at the
    registers the compiler used equal to the runtime's occupancy (at the
    cap, at most it: that is what the planners size their grids by). The
    device's limits are read through the runtime and its SM count through
    PyTorch; the two must agree."""
    limits = device_limits(DEV)
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    check(limits.sms == sms, f"SM count {limits.sms} != PyTorch's {sms}")
    rows = []
    for b in INSTANTIATIONS.values():
        a = kernel_attributes(b)
        at_regs = b.blocks_per_sm(limits, regs=a["num_regs"])
        row = {"name": b.name, "regs": a["num_regs"], "reg_cap": b.reg_cap,
               "spill_bytes": a["local_bytes"],
               "smem": [a["static_smem"], a["dynamic_smem"]],
               "model_smem": [b.static_smem, b.dynamic_smem],
               "threads": a["threads"], "blocks_per_sm": a["blocks_per_sm"],
               "model_blocks_per_sm": at_regs,
               "model_blocks_at_cap": b.blocks_per_sm(limits)}
        rows.append(row)
        check(row["smem"] == row["model_smem"]
              and a["max_dynamic_smem"] >= b.dynamic_smem,
              f"budget of {b.name}: shared memory {row['smem']} (max dynamic "
              f"{a['max_dynamic_smem']}) != model {row['model_smem']}")
        check(a["threads"] == b.threads <= a["max_threads"],
              f"budget of {b.name}: {a['max_threads']} threads at most")
        check(a["num_regs"] <= b.reg_cap,
              f"budget of {b.name}: {a['num_regs']} registers > cap "
              f"{b.reg_cap}")
        check(at_regs == a["blocks_per_sm"]
              and 1 <= row["model_blocks_at_cap"] <= at_regs,
              f"budget of {b.name}: model {at_regs} (at the cap "
              f"{row['model_blocks_at_cap']}) blocks per SM, runtime "
              f"{a['blocks_per_sm']}")
    return {"device_limits": dataclasses.asdict(limits), "budget": rows}


def summary_row(rows, name, source, replaces, shape, launches) -> dict:
    row = next(r for r in rows if r["name"] == name
               and r["shape"] == list(shape) and r["precision"] == "f32"
               and r.get("out_dtype", "float32") == "float32" and "ms" in r)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": list(shape), "precision": "f32",
            "launches": launches, "max_abs_err": row["max_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"].split()[0],  # "operations" / "bytes"
            "library_ms": row["library_ms"]}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False   # plain/library: full f32
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    emit(build_all())

    rows = phase_kernels() + fused_rows_rows() + gram_rows()
    emit({"phase": "kernels", "kernels": rows})
    emit({"phase": "reference", "npz": str(REFERENCE_NPZ.name),
          "kernels": reference_rows()})

    # K6: the route of every bucket the main paths sweep, timed here.
    emit(phase_routes())

    # Main path 1, serving: launches are counted from zero over this phase.
    reset_launch_counts()
    serve, sweep_error, serve_answers = phase_serve(
        "serve", n=8192, m=64, d=7, n_new=256, compare_iterative=False,
        time_iterative=True)
    serve_launches = launch_counts()
    serve["launches"] = serve_launches
    serve["float32_sweep_error"] = sweep_error()
    emit(serve)
    # every kernel of every route the serving buckets took was launched
    for B in (65, 1, 16):
        for name in ROUTE_KERNELS[routed(8192, 64, B)]:
            check(serve_launches[name] > 0,
                  f"the serving path never launched {name}, the route of "
                  f"B = {B}")
    del serve, sweep_error
    torch.cuda.empty_cache()

    lcbench, sweep_error, _ = phase_serve("serve_lcbench", n=2000, m=52, d=7,
                                          n_new=256, compare_iterative=True)
    lcbench["float32_sweep_error"] = sweep_error()
    emit(lcbench)
    emit(phase_exact())
    torch.cuda.empty_cache()

    # Main path 2, fitting: counted from zero over this phase (which also
    # checks the count of each route it drives).
    reset_launch_counts()
    fit_out = phase_fit(**FIT_SHAPE)
    fit_totals = launch_counts()
    fit_out["launches"] = fit_totals
    emit(fit_out)
    for name in ("lk_mvm_fused", "lk_mvm_stage_right", "lk_mvm_stage_left"):
        check(fit_totals[name] > 0, f"the fit path never launched {name}")
    fit_iterative = {k: fit_out["fit"]["iterative"][k]
                     for k in ("fun", "n_evals")}
    del fit_out
    torch.cuda.empty_cache()

    # Main path 3, the freeze-thaw loop (polished fit, extend, refit):
    # counted from zero over this phase, each step held to its evaluations.
    reset_launch_counts()
    warm_out = phase_warm(**FIT_SHAPE)
    warm_totals = launch_counts()
    warm_out["launches"] = warm_totals
    emit(warm_out)
    for B in (FIT_CONFIG["slq_probes"] + 1, 1, FIT_CONFIG["slq_probes"]):
        for name in ROUTE_KERNELS[routed(FIT_SHAPE["n"], FIT_SHAPE["m"], B)]:
            check(warm_totals[name] > 0, f"the warm path never launched "
                  f"{name}, the route of B = {B}")
    del warm_out
    torch.cuda.empty_cache()

    # Main path 4, the batched dense path (fit_batch, posterior_batch): no
    # MVM kernel, which the phase checks.
    emit(phase_batch())
    torch.cuda.empty_cache()

    # Main path 5, the distributed engine in an NCCL group of one rank.
    rendezvous = init_process_group("nccl")
    reset_launch_counts()
    dist_out = phase_distributed(n=8192, m=64, d=7, n_new=256,
                                 reference=serve_answers,
                                 reference_fit=fit_iterative)
    dist_totals = launch_counts()
    close_process_group(rendezvous)
    dist_out["launches"] = dist_totals
    emit(dist_out)
    check(dist_totals["lk_mvm_fused_rows"] > 0,
          "the distributed path never launched K3")
    del serve_answers
    torch.cuda.empty_cache()

    # Main path 6, the Gram op.
    reset_launch_counts()
    gram_out = phase_gram()
    gram_totals = launch_counts()
    gram_out["launches"] = gram_totals
    emit(gram_out)
    check(gram_totals["rbf_gram"] > 0, "rbf_gram_op never launched K4")

    # Every bucket the tuner resolved in this run, with its route and times.
    emit({"phase": "routes_used", "buckets": route_rows()})

    csrc = "src/repro_torch/kernels/csrc/"
    main_paths = {k: serve_launches[k] + fit_totals[k] + warm_totals[k]
                  for k in ("lk_mvm_fused", "lk_mvm_stage_right",
                            "lk_mvm_stage_left")}
    emit({"kernels": [
        summary_row(rows, "lk_mvm_fused", csrc + "lk_mvm_fused.cu",
                    "src/repro/kernels/lk_mvm.py:253", MAIN_SHAPE,
                    main_paths["lk_mvm_fused"]),
        summary_row(rows, "lk_mvm_stage_right", csrc + "lk_mvm_two_stage.cu",
                    "src/repro/kernels/lk_mvm.py:170", FIT_MAIN_SHAPE,
                    main_paths["lk_mvm_stage_right"]),
        summary_row(rows, "lk_mvm_stage_left", csrc + "lk_mvm_two_stage.cu",
                    "src/repro/kernels/lk_mvm.py:185", FIT_MAIN_SHAPE,
                    main_paths["lk_mvm_stage_left"]),
        summary_row(rows, "lk_mvm_fused_rows", csrc + "lk_mvm_fused_rows.cu",
                    "src/repro/kernels/lk_mvm.py:371", ROWS_MAIN_SHAPE,
                    dist_totals["lk_mvm_fused_rows"]),
        summary_row(rows, "rbf_gram", csrc + "rbf_gram.cu",
                    "src/repro/kernels/gram.py:81", GRAM_MAIN_SHAPE,
                    gram_totals["rbf_gram"])]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
