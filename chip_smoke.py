#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the hand-written CUDA kernel from the sources in this checkout, holds
it against its plain PyTorch version on the card, then drives the port's
serving path (fitted state -> ``posterior(state)`` -> ``final`` / ``mean`` /
``samples``) at full width through the ``cuda`` inference engine and checks
that every CG iteration was one launch of the kernel. Any failed check raises;
nothing is caught, so the exit code is non-zero. Without a CUDA device the
script exits non-zero before printing any result.

Phases, one JSON line each: device, build, kernels, serve (n=8192, m=64),
serve_lcbench (n=2000, m=52, also against the ``iterative`` engine), exact
(n=24, m=16 against the ``dense`` engine). Then a summary line
``{"kernels": [...]}``, the card's name and power limit as ``nvidia-smi``
gives them, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is False")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import state_from_reference  # noqa: E402
from repro_torch.core import get_engine, init_params, posterior  # noqa: E402
from repro_torch.core.engines import (IterativeEngine,  # noqa: E402
                                      LatentKroneckerOperator)
from repro_torch.core.posterior import joint_grams  # noqa: E402
from repro_torch.core.transforms import (TTransform, XTransform,  # noqa: E402
                                         YTransform)
from repro_torch.data import sample_task  # noqa: E402
from repro_torch.kernels._build import build_log, load_library  # noqa: E402
from repro_torch.kernels.lk_mvm import (lk_mvm_fused,  # noqa: E402
                                        lk_mvm_fused_plain)
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
# B = 65 (y and 64 Matheron residuals), 16 (samples on demand), 1 (mean only).
KERNEL_SHAPES = [(1, 5, 3), (3, 50, 21), (2, 130, 257),
                 (1, 2000, 52), (65, 2000, 52),
                 (1, 8192, 64), (16, 8192, 64), (65, 8192, 64)]
TIMED_SHAPES = KERNEL_SHAPES[3:]
MAIN_SHAPE = (65, 8192, 64)
# Output tile of one thread block (TI, TJ of lk_mvm_fused.cu), for the count
# of blocks a shape gives the card's 132 SMs.
KERNEL_TILE = (128, 64)
# Largest gap between the posterior means of the cuda and the iterative
# engine, in units of cg_tol * max|mean|. CG bounds the 2-norm of each solve's
# residual by cg_tol * ||y||, not the largest of ~10^5 cell-wise gaps between
# two such solves, which is a few times cg_tol * max|mean|: the phase prints
# the gap it observed, and shows that it shrinks with cg_tol.
MEAN_TOL_VS_ITERATIVE = 5.0


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
        return LatentKroneckerOperator(A.K1, A.K2, A.mask, A.noise,
                                       mvm=lk_mvm_fused_plain,
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


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False   # plain/library: full f32
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    load_library("lk_mvm_fused")        # compiles the source, loads it
    log = build_log("lk_mvm_fused")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": log["seconds"], "cached": log["cached"],
          "tile": list(KERNEL_TILE),
          "ptxas": [ln for ln in log["compiler_output"].splitlines()
                    if "registers" in ln or "spill" in ln]})

    rows = phase_kernels()
    emit({"phase": "kernels", "kernels": rows})

    # The main path: launches are counted from zero over this phase alone.
    lk_mvm_fused.launches = 0
    serve, sweep_error = phase_serve("serve", n=8192, m=64, d=7, n_new=256,
                                     compare_iterative=False)
    main_launches = lk_mvm_fused.launches
    serve["launches"] = main_launches
    serve["float32_sweep_error"] = sweep_error()
    emit(serve)
    check(main_launches > 0, "the serving path never launched the kernel")
    del serve, sweep_error
    torch.cuda.empty_cache()

    lcbench, sweep_error = phase_serve("serve_lcbench", n=2000, m=52, d=7,
                                       n_new=256, compare_iterative=True)
    lcbench["float32_sweep_error"] = sweep_error()
    emit(lcbench)
    emit(phase_exact())

    main_row = next(r for r in rows if r["shape"] == list(MAIN_SHAPE)
                    and r["precision"] == "f32" and "ms" in r)
    emit({"kernels": [{
        "name": "lk_mvm_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lk_mvm_fused.cu",
        "replaces": "src/repro/kernels/lk_mvm.py:253",
        "shape": list(MAIN_SHAPE), "precision": "f32",
        "launches": main_launches, "max_abs_err": main_row["max_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
