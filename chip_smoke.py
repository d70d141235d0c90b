#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout (one
nvcc per source, started together), holds each against its plain PyTorch
version on the card, then drives the port's two paths at full width and
checks that they ran through the kernels:

* serving (fitted state -> ``posterior(state)`` -> ``final`` / ``mean`` /
  ``samples``) through the ``cuda`` engine: every CG iteration one launch of
  the fused kernel (K1);
* fitting (``fit`` -> MLL value and gradient -> L-BFGS) at the paper's
  LCBench shape, through K1 (the ``cuda`` engine) and through the two-stage
  kernels K2a + K2b (``make_mll_iterative(cfg, KernelMVM(fused=False))``):
  every objective evaluation costs the stacked solve's CG iterations plus 2
  launches of each.

Any failed check raises; nothing is caught, so the exit code is non-zero.
Without a CUDA device the script exits non-zero before printing any result.

Phases, one JSON line each: device, build, kernels, serve (n=8192, m=64),
serve_lcbench (n=2000, m=52, also against the ``iterative`` engine), exact
(n=24, m=16 against the ``dense`` engine), fit (n=2000, m=52, d=7). Then a
summary line ``{"kernels": [...]}``, the card's name and power limit as
``nvidia-smi`` gives them, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
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

from repro_torch import state_from_reference  # noqa: E402
from repro_torch.core import (LKGPConfig, fit, get_engine,  # noqa: E402
                              init_params, log_prior, make_mll,
                              make_mll_iterative, posterior,
                              rademacher_probes)
from repro_torch.core.engines import (IterativeEngine,  # noqa: E402
                                      KernelEngine, KernelMVM,
                                      LatentKroneckerOperator)
from repro_torch.core.posterior import joint_grams  # noqa: E402
from repro_torch.core.state import (_fit_transforms,  # noqa: E402
                                    _flatten_params, _unflatten_params)
from repro_torch.core.transforms import (TTransform, XTransform,  # noqa: E402
                                         YTransform)
from repro_torch.data import sample_task  # noqa: E402
from repro_torch.kernels._build import build_log, load_library  # noqa: E402
from repro_torch.kernels.lk_mvm import (  # noqa: E402
    lk_mvm_fused, lk_mvm_fused_plain, lk_mvm_stage_left,
    lk_mvm_stage_left_plain, lk_mvm_stage_right, lk_mvm_stage_right_plain,
    lk_mvm_two_stage, lk_mvm_two_stage_plain)
from repro_torch.kernels.ref import lk_mvm_ref  # noqa: E402

SEED = 0
DEV = torch.device("cuda", 0)

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): the
# yardstick of bound_ms whatever card this runs on.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

# Kernel against its plain version. Both round at the same points, so what is
# left is the order of summation (and, in bf16 mode, an intermediate that
# lands on the other side of a bf16 rounding boundary now and then).
KERNEL_TOL = {"f32": 1e-4, "bf16": 2e-2}     # times max|plain|
# Ragged small shapes, then the shapes the serving path hands the kernel:
# B = 65 (y and 64 Matheron residuals), 16 (samples on demand), 1 (mean
# only); and the fit path at n = 2000: B = 17 (y and 16 probes, the stacked
# solve), 16 (A(probes) in the gradient), 1 (A(alpha)).
KERNEL_SHAPES = [(1, 5, 3), (3, 50, 21), (2, 130, 257),
                 (1, 2000, 52), (16, 2000, 52), (17, 2000, 52),
                 (65, 2000, 52),
                 (1, 8192, 64), (16, 8192, 64), (65, 8192, 64)]
TIMED_SHAPES = KERNEL_SHAPES[3:]
MAIN_SHAPE = (65, 8192, 64)
FIT_MAIN_SHAPE = (17, 2000, 52)
KERNEL_SOURCES = ("lk_mvm_fused", "lk_mvm_two_stage")
# Output tile of one thread block (TI, TJ of lk_mvm_fused.cu), for the count
# of blocks a shape gives the card's 132 SMs.
KERNEL_TILE = (128, 64)
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


def bound_ms(B: int, n: int, m: int, precision: str) -> tuple[float, str]:
    """Least time the card could take: operations or bytes, whichever is
    larger. Each input is read once and the output written once (float32)."""
    flops = 2.0 * B * (n * n * m + n * m * m)
    nbytes = 4.0 * (n * n + m * m + n * m + 2 * B * n * m + 1)
    t_ops = flops / PEAK_FLOPS[precision] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_two_stage_ms(stage: str, B: int, n: int, m: int) -> tuple[float, str]:
    """bound_ms of one stage alone; T counts as that stage's output (R) or
    input (L), each read or written once."""
    if stage == "R":    # u, mask, K2 in; T out
        flops = 2.0 * B * n * m * m
        nbytes = 4.0 * (2 * B * n * m + n * m + m * m)
    else:               # K1, T, mask, u, noise in; out
        flops = 2.0 * B * n * n * m
        nbytes = 4.0 * (n * n + 3 * B * n * m + n * m + 1)
    t_ops = flops / PEAK_FLOPS["f32"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def launch_counts(since: dict | None = None) -> dict:
    """Each kernel wrapper's launch count (minus ``since``)."""
    now = {"lk_mvm_fused": lk_mvm_fused.launches,
           "lk_mvm_stage_right": lk_mvm_stage_right.launches,
           "lk_mvm_stage_left": lk_mvm_stage_left.launches}
    return {k: v - (since or {}).get(k, 0) for k, v in now.items()}


def reset_launch_counts() -> None:
    lk_mvm_fused.launches = 0
    lk_mvm_stage_right.launches = 0
    lk_mvm_stage_left.launches = 0


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
            torch.cuda.synchronize()
            check(out.shape == u.shape and out.dtype == u.dtype,
                  f"kernel output {out.shape}/{out.dtype} at {(B, n, m)}")
            check(bool(torch.isfinite(out).all()), "kernel output not finite")
            scale = float(ref.abs().max())
            err = float((out - ref).abs().max())
            tol = KERNEL_TOL[precision] * scale
            row = {"name": "lk_mvm_fused",
                   "tpu": "repro/kernels/lk_mvm.py:lk_mvm_fused",
                   "precision": precision, "shape": [B, n, m],
                   "max_err": err, "tol": tol, "ref_scale": scale}
            if (B, n, m) in TIMED_SHAPES:
                bound, bound_by = bound_ms(B, n, m, precision)
                row.update(
                    blocks=B * -(-n // KERNEL_TILE[0]) * -(-m // KERNEL_TILE[1]),
                    ms=time_ms(lambda: lk_mvm_fused(
                        K1, K2, mask, u, noise, precision=precision)),
                    plain_ms=time_ms(lambda: lk_mvm_fused_plain(
                        K1, K2, mask, u, noise, precision=precision)),
                    library_ms=time_ms(lambda: library_mvm(
                        K1, K2, mask, u, noise)),
                    bound_ms=bound, bound_by=bound_by)
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
    T, so each kernel is held alone), timed at the main paths' shapes."""
    B, n, m = u.shape
    T = lk_mvm_stage_right_plain(u, mask, K2)
    cases = [
        ("lk_mvm_stage_right", "src/repro/kernels/lk_mvm.py:170",
         lambda: lk_mvm_stage_right(u, mask, K2),
         lambda: lk_mvm_stage_right_plain(u, mask, K2),
         lambda: torch.matmul(mask * u, K2),
         bound_two_stage_ms("R", B, n, m)),
        ("lk_mvm_stage_left", "src/repro/kernels/lk_mvm.py:185",
         lambda: lk_mvm_stage_left(K1, T, mask, u, noise),
         lambda: lk_mvm_stage_left_plain(K1, T, mask, u, noise),
         lambda: mask * torch.matmul(K1, T) + noise * mask * u,
         bound_two_stage_ms("L", B, n, m)),
        ("lk_mvm_two_stage", "src/repro/kernels/lk_mvm.py:170,185",
         lambda: lk_mvm_two_stage(K1, K2, mask, u, noise),
         lambda: lk_mvm_two_stage_plain(K1, K2, mask, u, noise),
         lambda: library_mvm(K1, K2, mask, u, noise),
         bound_ms(B, n, m, "f32")),
    ]
    rows = []
    for name, tpu, kernel, plain, library, (bound, bound_by) in cases:
        ref = plain()
        out = kernel()
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == torch.float32,
              f"{name} output {out.shape}/{out.dtype} at {(B, n, m)}")
        check(bool(torch.isfinite(out).all()), f"{name} output not finite")
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        tol = KERNEL_TOL["f32"] * scale
        row = {"name": name, "tpu": tpu, "precision": "f32",
               "shape": [B, n, m], "max_err": err, "tol": tol,
               "ref_scale": scale}
        if (B, n, m) in TIMED_SHAPES:
            row.update(ms=time_ms(kernel), plain_ms=time_ms(plain),
                       library_ms=time_ms(library), bound_ms=bound,
                       bound_by=bound_by)
        rows.append(row)
        check(err <= tol, f"{name} at {(B, n, m)}: max err {err:.3e} > "
                          f"tol {tol:.3e}")
    return rows


def make_state(task_seed: int, n: int, m: int, d: int, **config):
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
    return state_from_reference(arrays, config, dtype=torch.float64,
                                device=DEV)


class PlainFloat32Engine(IterativeEngine):
    """The cuda engine with the kernel's plain version (float32 library
    products) in the kernel's place: same float32 factors, same float64
    ``accurate`` operator. Tells float32 rounding from the kernel's doing."""

    name = "plain_f32"

    def operator_from_grams(self, K1, K2, mask, noise):
        A = get_engine("cuda").operator_from_grams(K1, K2, mask, noise)
        return LatentKroneckerOperator(*A.fast, mvm=lk_mvm_fused_plain,
                                       accurate=A.accurate)


class Request:
    """Times one request and holds its solves against the launch counter."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        torch.cuda.synchronize()
        self.launches0 = lk_mvm_fused.launches
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.launches = lk_mvm_fused.launches - self.launches0
        return False


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
                compare_iterative: bool):
    """Returns the phase's record and a closure that measures the float32
    sweep's error at the first request's solution (it launches the kernel,
    so the caller runs it after the launch count has been read)."""
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
          f"final: {req.launches} launches for {s['iters']} CG iterations")
    check(mean.shape == (n,) and var.shape == (n,), "final() shapes")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()
               and (var > 0).all()), "final() values")
    out["requests"].append({"request": "final", "seconds": req.seconds,
                            "launches": req.launches, **s})
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
    s = check_solve(post3, req, cg_tol)
    check(req.launches == s["iters"], "mean: launches != CG iterations")
    check(mean3.shape == (n + n_new, m) and bool(torch.isfinite(mean3).all()),
          "mean at new configs")
    out["requests"].append({"request": "new_configs_mean",
                            "seconds": req.seconds, "launches": req.launches,
                            **s})
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 2)
    with Request("new_configs_samples") as req:
        samp = post3.samples(gen, 16)
    s = check_solve(post3, req, cg_tol)
    check(post3.solve_count == 2, "samples after mean must be one more solve")
    check(req.launches == s["iters"], "samples: launches != CG iterations")
    check(samp.shape == (16, n + n_new, m)
          and bool(torch.isfinite(samp).all()), "samples at new configs")
    out["requests"].append({"request": "new_configs_samples",
                            "seconds": req.seconds, "launches": req.launches,
                            **s})
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()

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
    return out, lambda: float32_sweep_error(state, x_final)


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


def phase_fit(n: int, m: int, d: int) -> dict:
    """The fit path at full width. (1) MLL value and gradient at the init on
    one set of probes through three MVMs; (2) fit with 10 L-BFGS iterations
    on the float64 iterative engine and on the cuda engine (K1), with the
    probes fit() draws itself, which are the same: the same seeded
    generator on the same device."""
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
    two_stage = LoggedKernelMVM(fused=False)
    routes = {"iterative": (make_mll(cfg, engines["iterative"]),
                            engines["iterative"]),
              "cuda": (make_mll(cfg, engines["cuda"]), engines["cuda"]),
              "two_stage": (make_mll_iterative(cfg, mvm_impl=two_stage),
                            two_stage)}
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
        want = {"iterative": {},
                "cuda": {"lk_mvm_fused": iters + 2},
                "two_stage": {"lk_mvm_stage_right": iters + 2,
                              "lk_mvm_stage_left": iters + 2}}[route]
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
    for route in ("cuda", "two_stage"):
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
        want = sum(i + 2 for i in iters) if backend == "cuda" else 0
        check(launches["lk_mvm_fused"] == want,
              f"fit via {backend}: {launches['lk_mvm_fused']} launches of "
              f"lk_mvm_fused, expected {want}")
        check(launches["lk_mvm_stage_right"] == 0
              and launches["lk_mvm_stage_left"] == 0,
              f"fit via {backend} launched the two-stage kernels")
        flat = _flatten_params(state.params)
        row = {"seconds": seconds, "n_iters": res.n_iters,
               "n_evals": res.n_evals, "converged": res.converged,
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
            "tile": list(KERNEL_TILE), "libraries": logs}


def summary_row(rows, name, source, replaces, shape, launches) -> dict:
    row = next(r for r in rows if r["name"] == name
               and r["shape"] == list(shape) and r["precision"] == "f32"
               and "ms" in r)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": list(shape), "precision": "f32",
            "launches": launches, "max_abs_err": row["max_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False   # plain/library: full f32
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    emit(build_all())

    rows = phase_kernels()
    emit({"phase": "kernels", "kernels": rows})

    # Main path 1, serving: launches are counted from zero over this phase.
    reset_launch_counts()
    serve, sweep_error = phase_serve("serve", n=8192, m=64, d=7, n_new=256,
                                     compare_iterative=False)
    serve_launches = launch_counts()
    serve["launches"] = serve_launches["lk_mvm_fused"]
    serve["float32_sweep_error"] = sweep_error()
    emit(serve)
    check(serve_launches["lk_mvm_fused"] > 0,
          "the serving path never launched the kernel")
    del serve, sweep_error
    torch.cuda.empty_cache()

    lcbench, sweep_error = phase_serve("serve_lcbench", n=2000, m=52, d=7,
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
    for name, count in fit_totals.items():
        check(count > 0, f"the fit path never launched {name}")

    csrc = "src/repro_torch/kernels/csrc/"
    emit({"kernels": [
        summary_row(rows, "lk_mvm_fused", csrc + "lk_mvm_fused.cu",
                    "src/repro/kernels/lk_mvm.py:253", MAIN_SHAPE,
                    serve_launches["lk_mvm_fused"]
                    + fit_totals["lk_mvm_fused"]),
        summary_row(rows, "lk_mvm_stage_right", csrc + "lk_mvm_two_stage.cu",
                    "src/repro/kernels/lk_mvm.py:170", FIT_MAIN_SHAPE,
                    fit_totals["lk_mvm_stage_right"]),
        summary_row(rows, "lk_mvm_stage_left", csrc + "lk_mvm_two_stage.cu",
                    "src/repro/kernels/lk_mvm.py:185", FIT_MAIN_SHAPE,
                    fit_totals["lk_mvm_stage_left"])]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
