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
* the solver stack on the serving state: PCG with the rank-15
  pivoted-Cholesky preconditioner (``final`` and the mean, every PCG
  iteration one sweep of the routed kernels, held against CG's answers) and
  SGD for the mean; the MLL and a 5-iteration fit through PCG at the LCBench
  shape (PCG iterations + Lanczos sweeps + 2 launches an evaluation); the
  guarded escalation ladder on cuda operators (a negated operator ending on
  the dense fallback, a near-singular system, an armed flaky solver, the
  strict policy, and PCG's ``final`` under ``strict`` bit for bit the
  default's);
* the freeze-thaw loop at the same shape on the routed ``cuda`` engine:
  ``fit`` with the fixed-budget polish (twice: the same bits), ``extend``
  with more epochs and ``refit``, ``extend`` with new configurations and
  ``refit``, each evaluation's launches held to its CG iterations;
* the AutoML schedulers (``repro_torch.autotune``) at the LCBench shape on
  the routed ``cuda`` engine through rank-15 PCG: successive halving with
  LKGP promotion over 2000 replayed configurations (each rung's update held
  to its evaluations' launches, each ``final()`` read to its PCG iterations,
  a second read to none, rung 0's mean held against the float64
  ``iterative`` engine), rank promotion at the same budget, freeze-thaw,
  and Hyperband over 243 configurations;
* the amortized init (``repro_torch.amortize``): the packaged amortizer
  and the curve transformer held against the reference's outputs in
  ``tests/fixtures/reference_amortizer.npz``, ``bench_automl.py``'s
  amortized MLL-gap rows, a d=7 amortizer trained on the card, and the
  freeze-thaw loop of the automl phase again with every fit and refit
  amortized + polished, and polished from the default init (each update
  held to its launches), beside that phase's host L-BFGS arm; amortized
  ``fit_batch`` bitwise per-task ``fit`` and two amortized polishes the
  same bits;
* the paper's Transformer baseline (``repro_torch.baselines``): the curve
  transformer pre-trained at ``bench_curve_pred.py``'s full configuration,
  then ``head_to_head`` against the LKGP on its three suites;
* the LM zoo's RWKV-6 (``repro_torch.models``, ``repro_torch.launch``):
  ``rwkv6_1b6`` served at its published width in bf16 through
  ``launch/serve.py`` and trained 4 steps through ``launch/train.py``, its
  bf16 checkpoint restored bit for bit; float32 prefill + decode against a
  longer prefill, the chunked WKV against the scan, bf16 against float32
  logits; the smoke config held against ``tests/fixtures/
  reference_rwkv.npz``; and the freeze-thaw example over 8 real RWKV
  training runs, its refits on the routed ``cuda`` engine (plain PyTorch
  otherwise: the reference has no kernel on this path);
* the LM zoo's decoder family (dense, VLM prefix, MoE) in bf16 at published
  width: ``stablelm_12b``, ``nemotron4_15b``, ``phi3_medium_14b`` and
  ``llava_next_mistral_7b`` (2880 patch tokens, the chunked attention)
  served whole through ``launch/serve.py``, and ``qwen2_72b``,
  ``qwen3_moe_235b``, ``arctic_480b`` with their depth cut; float32 prefill
  + decode against a longer prefill, bf16 against float32 logits, the
  chunked attention against the plain one, ``moe_ffn`` against a dense
  per-token sum and its routing ties; the seven smoke configs held against
  ``tests/fixtures/reference_decoder.npz``; donated AdamW steps of
  ``stablelm_12b`` and ``qwen3_moe_235b`` (plain PyTorch: the reference
  writes the decoder in plain jnp);
* the LM zoo's Griffin hybrid and Whisper encoder-decoder in bf16 at
  published width, whole: ``recurrentgemma_2b`` served through
  ``launch/serve.py`` with a prompt past its 2048 window (the chunked
  windowed attention, the rotating buffer wrapped) and one inside it,
  ``whisper_tiny`` with 1500 frames; each trained 4 donated AdamW steps
  through ``launch/train.py``; float32 prefill + decode against a longer
  prefill (Griffin's across the window), the RG-LRU's doubling scan against
  the sequential loop (on the model's gates and on gates near 1, where every
  offset up to 2048 counts), the chunked windowed attention against the plain
  one, bf16 against float32 logits; the smoke configs held against
  ``tests/fixtures/reference_{griffin,encdec}.npz`` (plain PyTorch: the
  reference writes both in plain jnp);
* the LM zoo on a device mesh: the serve steps over ``DTensor`` placements
  by the logical-axis rules on a (1, 1) ``DeviceMesh`` in an NCCL world of
  one rank, one config of each family at published width against the
  one-device path from the same seed (tokens equal, logits bit for bit,
  both paths' ms), float32 against it, the smoke configs against the four
  ``.npz``, the four expert-parallel MoE functions at published width, and
  the per-rank plan of the three configs that need several cards;
* the batched dense path (``fit_batch``, ``stack_states``,
  ``posterior_batch``) on 16 tasks: per-task ``fit`` and ``fit_batch``
  bitwise equal, a task's posterior bitwise equal at batch sizes 1 and 16,
  and the committed LCBench-format fixture through ``get_source``;
* the prediction service (``repro_torch.serving``): coalesced cold fits,
  ``predict_many`` bitwise ``predict``, warm and cold latency, throughput,
  the chaos schedule (a NaN payload quarantined, an eviction, a checkpoint,
  a crash and restore bitwise a control service), and a service on the
  routed ``cuda`` engine whose fits launch the MVM kernels;
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
solvers (PCG and SGD on the serve state; the objective through PCG at
n=2000, m=52; the ladder at n=64, m=32), serve_lcbench (n=2000, m=52, also against the ``iterative`` engine), exact
(n=24, m=16 against the ``dense`` engine), fit (n=2000, m=52, d=7), warm
(n=2000 -> 2048, m=52, d=7), automl (n=2000, m=52, d=7; Hyperband 243 x
27), amortize (the .npz rows; d=5, n=12, m=9 gaps; a d=7 amortizer; the
freeze-thaw at n=2000, m=52), batch (16 tasks of n=48, m=20, d=4; the
fixture), service (8 tenants of n=16, m=12 and of n=8, m=10, dense; 4 of
n=48, m=20 on cuda), curvepred (1000 pretrain steps; 45 cells of n=16,
m=12), zoo (rwkv6_1b6 at full width: serve batch 8 x 64 + 32 tokens, train
4 steps of 8 x 64; the smoke config; freeze-thaw over 8 runs, n=8, m=10),
decoder (seven decoder configs at published width, three of them at a depth
cut: serve batch 8 x 128 + 32 tokens, the VLM 4 x (2880 + 192); float32
checks at 2 layers; the seven smoke configs; train 4 steps of 8 x 64),
griffin (recurrentgemma_2b whole: serve batch 8 x 3072 + 32 and 8 x 1024 +
32 tokens; float32 checks at 3 layers; the smoke config; train 4 steps of 8
x 64), encdec (whisper_tiny whole: serve batch 16 x (1500 frames, 32) + 64
tokens; float32 checks; the smoke config; train 4 steps of 8 x 64),
sharded (a (1, 1) mesh: stablelm_12b, recurrentgemma_2b, rwkv6_1b6,
whisper_tiny whole and qwen3_moe_235b at 4 layers served on the mesh and on
one device; float32 at 2-3 layers; the smoke configs; the MoE functions at
8 x 128 and 8 x 1 tokens; the plan at (1, 4), (1, 8), (2, 8)),
sharded_train (a (1, 1) mesh: rwkv6_1b6, recurrentgemma_2b, whisper_tiny
whole, stablelm_12b at 4 layers (AdamW, and Adafactor with grad_accum 2)
and qwen3_moe_235b at 1 layer trained 4 steps at 8 x 64 on the mesh and on
one device; a whisper_tiny restart across a world of one and one device;
int8 compression; the pipeline with one stage; the plan of the train state
at (w/8, 8) and (2, w/16, 8) for w = 8 ... 64),
plan (the keyed init a rank at a time; the dry run against the mesh
phases' peaks; a decode cell at 8 x 2048 and a train cell at 8 x 4096 per
big config at its mesh; the 30 smoke cells on (2, 2), each checked to
dispatch on the card's PyTorch), analysis (the lint CLI over the port, the
dispatch audits with the kernels at float32, the host reads of the CG loop
on the routed cuda engine at n=2000, m=52, d=7, the budget audit against
the card's limits),
distributed (n=8192, m=64 float32 serving; n=2000, m=52 float64
fit), gram
(n=8192 and n=2000, d=7), routes_used (every bucket the tuner resolved).
Then a summary line ``{"kernels": [...]}``, the card's name and power limit
as ``nvidia-smi`` gives them, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is False")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch.distributed as dist  # noqa: E402
from repro_torch import state_from_reference  # noqa: E402
from repro_torch.core import (DistributedEngine,  # noqa: E402
                              GuardedSolveError, LKGPConfig,
                              escalation_tally, extend, fit, fit_batch,
                              get_engine, gram_matrices, guarded_solve,
                              init_params, lk_mvm, log_prior, make_mll,
                              make_mll_iterative, posterior, posterior_batch,
                              rademacher_probes, refit,
                              reset_escalation_tally, solve_tally,
                              stack_states, unstack)
from repro_torch.core.engines import (IterativeEngine,  # noqa: E402
                                      KernelEngine, KernelMVM,
                                      KernelOperator,
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
    lk_mvm_two_stage_plain, TC_COLS, TC_K, TC_ROWS, TF32Planes, plan_launch,
    plan_stage_left, plan_stream)
from repro_torch.kernels.ref import lk_mvm_ref  # noqa: E402
from repro_torch.testing import (FaultSchedule,  # noqa: E402
                                 NegatedOperator, arm_flaky_solver,
                                 crash_and_restore, evict_session,
                                 near_singular_problem, poison_nan)
from repro_torch.autotune import (AutotuneConfig,  # noqa: E402
                                  CurvePredictor, FreezeThawScheduler,
                                  HyperbandScheduler, RunPool, SHConfig,
                                  SuccessiveHalvingScheduler)
from repro_torch.data import replay_step_fns  # noqa: E402
from repro_torch.serving import (PredictionService,  # noqa: E402
                                 ServiceConfig, SessionKey)
from repro_torch.serving.metrics import percentile  # noqa: E402
from repro_torch import tree_from_numpy  # noqa: E402
from repro_torch.amortize import (FIXTURE_DIR,  # noqa: E402
                                  AmortizeTrainConfig, Amortizer,
                                  AmortizerConfig, register_amortizer,
                                  clear_amortizer_registry, train_amortizer)
from repro_torch.baselines import (CurveTransformerConfig,  # noqa: E402
                                   PretrainConfig, head_to_head, pretrain)
from repro_torch.baselines import forward as curve_forward  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.models import build_model, count_params  # noqa: E402
from repro_torch.models import (encdec, griffin, moe, rope,  # noqa: E402
                                rwkv, transformer)
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models.layers import layer_norm, rms_norm  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.train import OptConfig, make_train_step  # noqa: E402
from repro_torch.train.trainer import make_serve_steps  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    SERVE_RULES, block_ranges, full_value, keyed_block, logical_to_pspec,
    mesh_shape, param_bytes_per_rank, param_placer, rules_for,
    set_active_mesh, shard_params, slab_seed, slabs)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.train.compression import (  # noqa: E402
    dequantize_leaf, make_compressed_allreduce, quantize_leaf)
from repro_torch.train.pipeline import pipelined_forward  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import table_logical  # noqa: E402
from repro_torch.train.optimizers import (tree_leaves,  # noqa: E402
                                          tree_map)

sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
import torch_automl_early_stopping as automl_example  # noqa: E402

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
# mean run. The three small buckets after the ragged ones are those only the
# exact phase (24 x 16) and the escalation ladder (64 x 32, and the
# near-singular 8 x 6 problem) solve at: checked, not timed. Last, the
# benchmark's two final() shapes: LCBench's (65, 4096, 52) and
# NAS-Bench-201's (65, 4096, 200), where K2a takes its wide kernel, and the
# observed prefixes their earlier Successive Halving rungs solve on (L = 1,
# 3, 9 and 27 epochs).
KERNEL_SHAPES = [(1, 5, 3), (3, 50, 21), (2, 130, 257),
                 (1, 24, 16), (1, 64, 32), (1, 8, 6),
                 (1, 2000, 52), (16, 2000, 52), (17, 2000, 52),
                 (65, 2000, 52),
                 (1, 2048, 52), (16, 2048, 52), (17, 2048, 52),
                 (1, 8192, 64), (16, 8192, 64), (65, 8192, 64),
                 (65, 4096, 52), (65, 4096, 200),
                 (65, 4096, 1), (65, 4096, 3), (65, 4096, 9), (65, 4096, 27)]
TIMED_SHAPES = KERNEL_SHAPES[6:]
# The cuda engine's operator against the checked wrappers, bit for bit on
# both routes: the benchmark's two final() shapes and a B = 1 mean.
LAUNCH_SHAPES = [(65, 4096, 52), (65, 4096, 200), (1, 4096, 52)]
MAIN_SHAPE = (65, 8192, 64)
FIT_MAIN_SHAPE = (17, 2000, 52)
KERNEL_SOURCES = ("lk_mvm_fused", "lk_mvm_two_stage", "lk_mvm_stage_left",
                  "lk_mvm_fused_rows", "rbf_gram")
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
# the stacked solve B=17, A(probes) B=16, A(alpha) B=1; exact (24, 16, 1);
# the solvers phase's ladder (64, 32, 1) and near-singular system (8, 6, 1);
# the automl phase's (2000, 52) and Hyperband's (243, 27) at the fit's three
# and final()'s B=65 (B=64: a keyed final() on a posterior whose alpha is
# cached solves only the residuals); the cuda service's fits at (48, 20);
# the zoo phase's freeze-thaw over 8 RWKV runs at (8, 10). A scheduler's
# final() solves on its rung's observed prefix, so the automl and amortize
# phases' reads also sweep (2000, L) at L = 1, 3, 9 (Successive Halving),
# 13, 26 (freeze-thaw), and Hyperband's (243, L) at L = 1, 3, 9.
ROUTE_SHAPES = [(8192, 64, 65), (8192, 64, 1), (8192, 64, 16),
                (2000, 52, 65), (2000, 52, 1), (2000, 52, 16),
                (2000, 52, 17), (24, 16, 1), (64, 32, 1), (8, 6, 1),
                (2000, 52, 64), (243, 27, 65), (243, 27, 17), (243, 27, 16),
                (243, 27, 1), (48, 20, 17), (48, 20, 16), (8, 10, 17),
                (8, 10, 16), (8, 10, 1), (8, 10, 65),
                *((2000, L, B) for L in (1, 3, 9, 26) for B in (65, 64)),
                *((243, L, 65) for L in (1, 3, 9))]
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


@contextlib.contextmanager
def unescalated(phase: str):
    """No solve of the block escalates: the ladder's tally is zero at its
    end. A solve the ladder rescued (a jitter retry, another solver, the
    dense fallback on a small grid) can return the right answer from a
    failing kernel, so outside the ladder's own checks that is a failure."""
    reset_escalation_tally()
    yield
    tally = escalation_tally()
    check(not any(tally.values()), f"{phase}: the escalation ladder ran: "
          f"{tally}")


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


def plan_row(B: int, n_local: int, n: int, m: int) -> dict:
    """The wrapper's launch plan at this shape, which is the grid the kernel
    launched (its launcher rejects any other): the split of the k sweep, the
    cluster (1, 1, splits) and the blocks on the card."""
    plan = plan_launch(B, n_local, n, m, sms=device_limits(DEV).sms)
    return {"splits": plan.splits, "cluster": [1, 1, plan.splits],
            "grid": [plan.panels, plan.row_tiles, plan.splits],
            "blocks": plan.blocks, "tiles": plan.tiles}


def left_plan_row(B: int, n: int, m: int) -> dict:
    """K2b's plan at this shape, which is the grid it launched (its
    launcher rejects any other): persistent blocks over (row tile, column
    tile, split) units, the column tile and its padded slots."""
    plan = plan_stage_left(B, n, m, sms=device_limits(DEV).sms)
    return {"splits": plan.splits, "grid": [plan.blocks],
            "blocks": plan.blocks, "tiles": plan.tiles, "units": plan.units,
            "col_tile": plan.col_tile, "padded_share": plan.padded_share}


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
    return rows + launch_rows()


def launch_rows() -> list[dict]:
    """The cuda engine's operator (float64 factors, float64 u) on each
    route at LAUNCH_SHAPES: its first sweep of a batch, which makes its
    launch, and a second through the cached launch each equal the checked
    wrapper of the route on the operator's float32 operands bit for bit,
    and each sweep launches one K1, or one K2a and one K2b. Not timed."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 20)
    per_sweep = {"fused": {"lk_mvm_fused": 1},
                 "two_stage": {"lk_mvm_stage_right": 1,
                               "lk_mvm_stage_left": 1}}
    rows = []
    for (B, n, m) in LAUNCH_SHAPES:
        K1, K2, mask, u, noise = mvm_problem(B, n, m, gen)
        u64 = u.double()
        for route, wrapper in (("fused", lk_mvm_fused),
                               ("two_stage", lk_mvm_two_stage)):
            A = KernelOperator(K1.double(), K2.double(), mask.double(),
                               noise.double(), fused=route == "fused")
            want = wrapper(*A.fast[:3], u64, A.fast[3])
            before = launch_counts()
            outs = [A(u64), A(u64)]
            torch.cuda.synchronize()
            launched = {k: v for k, v in launch_counts(before).items() if v}
            where = f"operator's {route} launch at {(B, n, m)}"
            check(A.launch(B).route == route, f"{where}: another route")
            check(all(torch.equal(o, want) for o in outs),
                  f"{where}: bits differ from {wrapper.__name__}")
            check(launched == {k: 2 * v for k, v in per_sweep[route].items()},
                  f"{where}: launches {launched} for 2 sweeps")
            rows.append({"name": "mvm_launch", "route": route,
                         "precision": "f32", "shape": [B, n, m],
                         "u_dtype": "float64", "wrapper": wrapper.__name__,
                         "bitwise_equal_to_wrapper": True,
                         "launches_per_sweep": per_sweep[route],
                         "max_err": 0.0, "tol": 0.0})
            del A, want, outs
        del K1, K2, mask, u, u64
        torch.cuda.empty_cache()
    return rows


def _bits(x):
    """A result as one tensor of its bits: T's two planes over their
    columns, side by side, or the tensor itself."""
    if isinstance(x, TF32Planes):
        return torch.cat([x.hi[:, :x.cols], x.lo[:, :x.cols]])
    return x


def _value(x):
    """A result's float32 value: T's planes summed (hi + lo), or the
    tensor itself."""
    return x.value() if isinstance(x, TF32Planes) else x


def two_stage_rows(K1, K2, mask, u, noise) -> list[dict]:
    """K2a (T transposed and split into TF32 halves), K2b and the pair
    against their plain versions (K2b on the plain planes, so each kernel is
    held alone) and against a second launch of themselves, bit for bit; K2b
    and the pair also against the float64 oracle. Each row carries the grid
    its kernel launched; timed at the main paths' shapes, with the 3xTF32
    bound and the FMA bound beside it."""
    B, n, m = u.shape
    T = lk_mvm_stage_right_plain(u, mask, K2)
    T32 = torch.matmul(mask * u, K2)
    plan_R, plan_L = stream_row(B, n, m), left_plan_row(B, n, m)
    cases = [
        ("lk_mvm_stage_right", "src/repro/kernels/lk_mvm.py:170",
         lambda: lk_mvm_stage_right(u, mask, K2),
         lambda: lk_mvm_stage_right_plain(u, mask, K2),
         lambda: torch.matmul(mask * u, K2),
         functools.partial(bound_two_stage_ms, "R"), plan_R),
        ("lk_mvm_stage_left", "src/repro/kernels/lk_mvm.py:185",
         lambda: lk_mvm_stage_left(K1, T, mask, u, noise),
         lambda: lk_mvm_stage_left_plain(K1, T, mask, u, noise),
         lambda: mask * torch.matmul(K1, T32) + noise * mask * u,
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
        ref = _value(plain())
        out = kernel()
        again = kernel()
        torch.cuda.synchronize()
        check(torch.equal(_bits(out), _bits(again)), f"{name} at {(B, n, m)}: "
              f"two launches gave different bits")
        out = _value(out)
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
            # rounds T as K1's stage R does; K2b sums in another order)
            row["bitwise_equal_to_fused"] = bool(torch.equal(
                out, lk_mvm_fused(K1, K2, mask, u, noise)))
        if name == "lk_mvm_stage_left" and B == 1 and n >= 8192:
            # K2b splits k at B = 1: one wave of units past half the card
            sms = torch.cuda.get_device_properties(DEV).multi_processor_count
            check(row["units"] <= sms < row["units"] + row["tiles"],
                  f"{name} at {(B, n, m)}: {row['units']} units of "
                  f"{row['tiles']} tiles for {sms} SMs")
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
    ``replacements``) are the only sweeps that are not. The solve must be
    healthy on its first attempt: a one-step trace (an escalated solve can
    end on the dense fallback, whose answer hides a failing kernel)."""
    info = post.solve_info
    check(info is not None, f"{req.name}: no solve diagnostics")
    check(info.trace is not None and [(s.stage, s.ok) for s in info.trace]
          == [("attempt", True)], f"{req.name}: escalated, trace {info.trace}")
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
    iters = check_solve(post, req, cg_tol)["iters"]
    check(req.launches == iters,
          f"exact: {req.launches} sweeps for {iters} CG iterations")
    ref = posterior(dense).mean
    rel = float((got - ref).abs().max() / ref.abs().max())
    check(rel <= 1e-2, f"cuda vs dense mean: relative gap {rel:.3e} > 1e-2")
    return {"phase": "exact", "n": n, "m": m, "cg_tol": cg_tol,
            "rel_gap_vs_dense": rel, "tol": 1e-2, "launches": req.launches,
            "iters": iters}


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
                        route: str = "cuda", lanczos: int = 0) -> dict:
    """Launches of each kernel over MLL evaluations whose stacked solves
    took ``iters`` CG (or PCG) iterations: per evaluation, one sweep per
    iteration at B = slq_probes + 1, ``lanczos`` Lanczos sweeps at B =
    slq_probes (the separate SLQ of a PCG solve, which fuses no log-det; 0
    for CG) and two in the gradient (A(alpha) at B = 1, A(probes) at B =
    slq_probes), each on the route named or, for "cuda", the tuner's route
    of its bucket."""
    probes = FIT_CONFIG["slq_probes"]
    out = {}
    for B, count in ((probes + 1, sum(iters)), (1, len(iters)),
                     (probes, (1 + lanczos) * len(iters))):
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


# The solvers phase: PCG (the rank-15 pivoted-Cholesky preconditioner, the
# reference's _DEFAULT_PCG_RANK and benchmarks/bench_scaling.py's rank) and
# SGD (500 sweeps, the reference's default) on the serve phase's state
# (n=8192, m=64, d=7, float64, routed cuda, cg_tol=0.01), the objective
# through PCG at the fit phase's shape (depth cut: 5 L-BFGS iterations), and
# the escalation ladder on cuda operators.
SOLVER_PCG_RANK = 15
SOLVER_SGD_ITERS = 500
SOLVER_POWER_SWEEPS = 8     # sgd_solve's lr_iters: power-iteration sweeps
SOLVER_FIT_LBFGS_ITERS = 5
LADDER_SHAPE = dict(n=64, m=32, d=7)   # 2048 cells <= guard_dense_max
LADDER_DENSE_TOL = 1e-10   # dense fallback vs the dense engine, relative


def phase_solvers(n: int, m: int, d: int, n_new: int,
                  reference: dict | None = None) -> dict:
    """PCG and SGD on the card at full width, beside CG on the same state.

    (1) PCG with ``precond_rank=15`` on the serve state: the pivoted
    Cholesky's build time and bytes, then ``final()`` (B = 65) and the mean
    at ``n_new`` new configurations (B = 1), each a PCG solve whose every
    iteration is one sweep of the routed kernels (true residuals and the
    preconditioner run no kernel), held against the serve phase's CG
    answers (``reference``; recomputed when absent) by the
    MEAN_TOL_VS_ITERATIVE rule. (2) SGD (``solver="sgd"``, 500 sweeps) for
    the mean: launches = its sweeps + 8 power-iteration sweeps + 1 (the
    start residual); a finite float64 residual, no breakdown (not reaching
    cg_tol in 500 sweeps is allowed, as in the reference). (3) The MLL value
    and gradient through PCG at the fit phase's shape (separate Lanczos SLQ)
    against the CG objective on the same probes, then ``fit`` with 5 L-BFGS
    iterations through PCG: launches per evaluation = PCG iterations +
    slq_iters Lanczos sweeps + 2. (4) The ladder on cuda operators: a
    negated operator ends on the dense fallback with the dense engine's
    answer, ``near_singular_problem`` ends healthy, the armed flaky solver
    costs one extra attempt, ``strict`` raises with a one-step trace, and
    ``final()`` through PCG at n=8192 under ``strict`` is request (1)'s
    (escalate) bit for bit."""
    t_phase = time.perf_counter()
    cfg = dict(backend="cuda", posterior_samples=64, seed=SEED)
    state = make_state(SEED, n, m, d, **cfg)
    cg_tol = state.config.cg_tol
    rng = np.random.default_rng(SEED + 1)
    Xs = rng.uniform(0, 1, (n_new, d))
    if reference is None:
        reference = {"final": posterior(state, cache=False).final(),
                     "new_configs_mean": posterior(state, Xs=Xs,
                                                   cache=False).mean}
    torch.cuda.reset_peak_memory_stats()
    out = {"phase": "solvers", "n": n, "m": m, "d": d, "dtype": "float64",
           "backend": "cuda", "cg_tol": cg_tol,
           "allocated_at_start_bytes": start_memory()}

    # (1) PCG. The factor alone first, what every PCG request builds: on two
    # operators, the first build paying any one-time library set-up.
    pcg = dataclasses.replace(state, config=dataclasses.replace(
        state.config, precond_rank=SOLVER_PCG_RANK))
    K1a, K2 = joint_grams(state)
    builds = []
    before = launch_counts()
    for _ in range(2):
        A = get_engine("cuda").operator_from_grams(
            K1a[:n, :n], K2, state.mask, torch.exp(state.params.raw_noise))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A.preconditioner(SOLVER_PCG_RANK)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    out["precond"] = {"rank": SOLVER_PCG_RANK, "build_seconds": builds,
                      "L_bytes": n * m * SOLVER_PCG_RANK * 8}
    check(not any(launch_counts(since=before).values()),
          "building the preconditioner launched an MVM kernel")
    del A, K1a, K2
    normals = default_draws(n, m, pcg.config.posterior_samples, SEED)
    out["pcg"] = []
    for request, B in (("final", 65), ("new_configs_mean", 1)):
        with Request(f"pcg_{request}") as req:
            if request == "final":
                post = posterior(pcg, cache=False)
                mean, var = post.final()
            else:
                post = posterior(pcg, Xs=Xs, cache=False)
                mean = post.mean
        info = post.solve_info
        iters = int(info.iters)
        check(post.solve_count == 1, f"pcg {request}: one solve")
        check([(s.stage, s.solver, s.ok) for s in info.trace]
              == [("attempt", "pcg", True)],
              f"pcg {request}: trace {info.trace}")
        check(not bool(info.breakdown.any()), f"pcg {request}: breakdown")
        check(req.launches == iters,
              f"pcg {request}: {req.launches} sweeps for {iters} PCG "
              "iterations")
        check_route(req, n, m, B)
        if request == "final":
            pcg_final = (mean, var)
            rel64 = float64_residuals(pcg, info.x, normals)
            want, want_var = reference["final"]
        else:
            b = (pcg.y_tf(pcg.Y) * pcg.mask)[None]
            r = b - post._operator.accurate(info.x)
            rel64 = (torch.linalg.vector_norm(r, dim=(-2, -1))
                     / torch.linalg.vector_norm(b, dim=(-2, -1)))
            want = reference["new_configs_mean"]
        check(bool(torch.isfinite(mean).all()), f"pcg {request}: values")
        scale = float(want.abs().max())
        row = {"request": request, "seconds": req.seconds,
               "launches": req.by_kernel, "iters": iters,
               "replacements": info.replacements,
               "columns": int(info.rel_residual.numel()),
               "route": routed(n, m, B),
               "pcg_rel_residual": float(info.rel_residual.max()),
               "float64_rel_residual": float(rel64.max()),
               "mean_gap_vs_cg": float((mean - want).abs().max()),
               "tol": MEAN_TOL_VS_ITERATIVE * cg_tol * scale, "scale": scale}
        if request == "final":
            row["var_gap_vs_cg"] = float((var - want_var).abs().max())
        out["pcg"].append(row)
        check(row["pcg_rel_residual"] <= cg_tol
              and row["float64_rel_residual"] <= cg_tol,
              f"pcg {request}: residual {row['pcg_rel_residual']:.3e}, "
              f"float64 {row['float64_rel_residual']:.3e} > {cg_tol}")
        check(abs(row["float64_rel_residual"] - row["pcg_rel_residual"])
              <= 1e-6 * row["pcg_rel_residual"],
              f"pcg {request}: its residual is not the float64 one")
        check(row["mean_gap_vs_cg"] <= row["tol"],
              f"pcg {request} vs cg: gap {row['mean_gap_vs_cg']:.3e} > "
              f"{row['tol']:.3e}")
        del post, info, rel64

    # (2) SGD for the mean at the new configurations
    sgd = dataclasses.replace(state, config=dataclasses.replace(
        state.config, solver="sgd", sgd_iters=SOLVER_SGD_ITERS))
    with Request("sgd_new_configs_mean") as req:
        post = posterior(sgd, Xs=Xs, cache=False)
        mean = post.mean
    info = post.solve_info
    iters = int(info.iters)
    want = reference["new_configs_mean"]
    out["sgd"] = {"request": "new_configs_mean", "seconds": req.seconds,
                  "iters": iters, "power_iteration_sweeps":
                  SOLVER_POWER_SWEEPS, "launches": req.by_kernel,
                  "float64_rel_residual": float(info.rel_residual.max()),
                  "trace": [s._asdict() for s in info.trace],
                  "mean_gap_vs_cg": float((mean - want).abs().max()),
                  "scale": float(want.abs().max())}
    check(np.isfinite(out["sgd"]["float64_rel_residual"])
          and not bool(info.breakdown.any())
          and bool(torch.isfinite(mean).all()),
          f"sgd: residual {out['sgd']['float64_rel_residual']}, breakdown "
          f"{info.breakdown.tolist()}")
    check(req.launches == iters + SOLVER_POWER_SWEEPS + 1,
          f"sgd: {req.launches} sweeps for {iters} iterations + "
          f"{SOLVER_POWER_SWEEPS} power sweeps + 1")
    check_route(req, n, m, 1)
    del post, info

    # (4, last request at n=8192) final() through PCG under strict: the
    # PCG request's answer above (escalate, the default) bit for bit, a
    # one-step trace. (On the PCG state: the same check at a third of the
    # plain-CG request's seconds.)
    strict = dataclasses.replace(pcg, config=dataclasses.replace(
        pcg.config, solve_policy="strict"))
    with Request("strict_final") as req:
        post = posterior(strict, cache=False)
        mean, var = post.final()
    want, want_var = pcg_final
    out["strict_final"] = {"seconds": req.seconds,
                           "iters": int(post.solve_info.iters),
                           "trace": [s._asdict()
                                     for s in post.solve_info.trace],
                           "bitwise_equal_to_escalate": bool(
                               torch.equal(mean, want)
                               and torch.equal(var, want_var))}
    check(out["strict_final"]["bitwise_equal_to_escalate"],
          "final() under strict differs from escalate")
    check([(s.stage, s.ok) for s in post.solve_info.trace]
          == [("attempt", True)], "strict final(): trace")
    del post, mean, var, state, pcg, sgd, strict, reference, pcg_final
    gc.collect()
    torch.cuda.empty_cache()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()

    out["objective"] = solver_objective(**FIT_SHAPE)
    tally = escalation_tally()
    check(not any(tally.values()), f"solvers: the ladder ran before its own "
          f"checks: {tally}")
    out["ladder"] = ladder_checks()
    out["escalation_tally"] = escalation_tally()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def solver_objective(n: int, m: int, d: int) -> dict:
    """The MLL value and gradient through PCG (``precond_rank=15``, SLQ by
    separate Lanczos sweeps) against the CG objective on the same probes,
    both on the routed cuda engine, then ``fit`` through PCG."""
    task = sample_task(SEED, n=n, m=m, d=d)
    cfg = LKGPConfig(backend="cuda", lbfgs_iters=SOLVER_FIT_LBFGS_ITERS,
                     **FIT_CONFIG)
    cfg_pcg = dataclasses.replace(cfg, precond_rank=SOLVER_PCG_RANK)
    X, t, Y, mask = (torch.as_tensor(a, device=DEV)
                     for a in (task.X, task.t, task.Y, task.mask))
    Y = torch.where(mask > 0, Y, torch.zeros_like(Y))
    x_tf, t_tf, y_tf = _fit_transforms(X, t, Y, mask)
    data = (x_tf(X), t_tf(t), y_tf(Y), mask)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(cfg.seed)
    probes = rademacher_probes(gen, cfg.slq_probes, mask, torch.float64)
    flat0 = _flatten_params(init_params(d, device=DEV))
    out = {"n": n, "m": m, "d": d, "precond_rank": SOLVER_PCG_RANK,
           "mll": {}}
    values = {}
    for name, c in (("cg", cfg), ("pcg", cfg_pcg)):
        engine = LoggedKernelEngine()
        mll = make_mll(c, engine)
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        x = flat0.clone().requires_grad_()
        v = mll(_unflatten_params(x, d), *data, probes)
        (g,) = torch.autograd.grad(v, x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts(since=before)
        (solve,) = engine.solves
        lanczos = c.slq_iters if name == "pcg" else 0
        want = evaluation_launches(n, m, [solve["iters"]], lanczos=lanczos)
        for k, count in launches.items():
            check(count == want.get(k, 0),
                  f"mll via {name}: {count} launches of {k}, expected "
                  f"{want.get(k, 0)} ({solve['iters']} iterations + "
                  f"{lanczos} Lanczos sweeps + 2)")
        values[name] = (float(v.detach()), g)
        out["mll"][name] = {"value": values[name][0], "seconds": seconds,
                            "iters": solve["iters"],
                            "replacements": solve["replacements"],
                            "worst_rel_residual": solve["worst_rel_residual"],
                            "launches": launches}
        check(np.isfinite(values[name][0]) and bool(torch.isfinite(g).all()),
              f"mll via {name} not finite")
    (v_cg, g_cg), (v, g) = values["cg"], values["pcg"]
    row = out["mll"]["pcg"]
    row.update(value_gap=abs(v - v_cg) / abs(v_cg),
               grad_gap=float((g - g_cg).abs().max() / g_cg.abs().max()),
               value_tol=MLL_VALUE_TOL * cfg.cg_tol,
               grad_tol=MLL_GRAD_TOL * cfg.cg_tol)
    check(row["value_gap"] <= row["value_tol"],
          f"mll via pcg: value {v} vs cg {v_cg}")
    check(row["grad_gap"] <= row["grad_tol"],
          f"mll via pcg: gradient off by {row['grad_gap']:.3e}")

    engine = LoggedKernelEngine()
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    state = fit(task.X, task.t, task.Y, task.mask, cfg_pcg, engine=engine)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts(since=before)
    res = state.fit_result
    iters = [sv["iters"] for sv in engine.solves]
    check(len(iters) == res.n_evals,
          f"fit via pcg: {len(iters)} solves, {res.n_evals} evaluations")
    want = evaluation_launches(n, m, iters, lanczos=cfg.slq_iters)
    for k, count in launches.items():
        check(count == want.get(k, 0), f"fit via pcg: {count} launches of "
              f"{k}, expected {want.get(k, 0)}")
    out["fit"] = {"seconds": seconds, "n_iters": res.n_iters,
                  "n_evals": res.n_evals, "fun": res.fun,
                  "pcg_iters_per_eval": statistics.mean(iters),
                  "pcg_iters_total": sum(iters),
                  "worst_rel_residual": max(sv["worst_rel_residual"]
                                            for sv in engine.solves),
                  "launches": launches}
    # the init's objective, from its MLL through PCG above
    f_init = -(v + float(log_prior(_unflatten_params(flat0, d), d))) \
        / float(mask.sum())
    out["fit"]["f_init"] = f_init
    check(np.isfinite(res.fun) and res.fun < f_init,
          f"fit via pcg: objective {res.fun} not below the init's {f_init}")
    return out


def ladder_checks() -> dict:
    """The escalation ladder on cuda operators (float32 sweeps, float64
    ``accurate``), each fault ending on the rung the reference's test
    names, and the tally of escalations equal to the steps of these traces
    (nothing else escalated)."""
    reset_escalation_tally()
    n, m, d = LADDER_SHAPE["n"], LADDER_SHAPE["m"], LADDER_SHAPE["d"]
    state = make_state(SEED + 5, n, m, d, backend="cuda")
    K1a, K2 = joint_grams(state)
    factors = (K1a[:n, :n], K2, state.mask, torch.exp(state.params.raw_noise))
    A = get_engine("cuda").operator_from_grams(*factors)
    b = state.y_tf(state.Y) * state.mask
    D = get_engine("dense").operator_from_grams(*factors)
    want = get_engine("dense").solve(D, b, state.config)
    cfg = state.config
    out = {"n": n, "m": m, "cells": n * m,
           "guard_dense_max": cfg.guard_dense_max}

    def steps(trace):
        return [(s.stage, s.solver, s.ok) for s in trace]

    with Request("negated") as req:
        res = guarded_solve(NegatedOperator(A), b, cfg)
    gap = float((res.x - want).abs().max() / want.abs().max())
    out["negated"] = {"trace": steps(res.trace), "gap_vs_dense": gap,
                      "tol": LADDER_DENSE_TOL, "launches": req.launches}
    # the iterative rungs ran on the kernel before the fallback took over
    check(res.trace[-1].stage == "dense_fallback" and res.trace[-1].ok
          and not res.trace[0].ok and req.launches > 0,
          f"negated: trace {res.trace}, {req.launches} sweeps")
    check(gap <= LADDER_DENSE_TOL, f"negated: {gap:.3e} off the dense engine")

    K1, K2n, mask, Y, noise = near_singular_problem(device=DEV)
    with Request("near_singular") as req:
        res = guarded_solve(get_engine("cuda").operator_from_grams(
            K1, K2n, mask, noise), Y, cfg)
    out["near_singular"] = {"trace": steps(res.trace),
                            "rel_residual": float(res.rel_residual.max()),
                            "iters": int(res.iters),
                            "launches": req.launches}
    # the reference's test names no rung, only a healthy, finite end; its
    # own draws end healthy on the first attempt (iterative and pallas), and
    # so must these: a rescue by a later rung would hide a failing kernel
    check(steps(res.trace) == [("attempt", "cg", True)]
          and bool(torch.isfinite(res.x).all())
          and out["near_singular"]["rel_residual"] <= cfg.cg_tol
          and req.launches == int(res.iters),
          f"near-singular: trace {res.trace}, residual "
          f"{out['near_singular']['rel_residual']:.3e}, {req.launches} "
          f"sweeps for {int(res.iters)} CG iterations")

    flaky = dataclasses.replace(cfg, solver="flaky")
    arm_flaky_solver(1)
    before = solve_tally()
    res = get_engine("cuda").solve_result(A, b, flaky)
    out["flaky"] = {"trace": steps(res.trace),
                    "solve_tally": solve_tally() - before}
    check(steps(res.trace) == [("attempt", "flaky", False),
                               ("retry_jitter", "flaky", True)]
          and solve_tally() - before == 2, f"flaky: trace {res.trace}")

    try:
        guarded_solve(NegatedOperator(A), b,
                      dataclasses.replace(cfg, solve_policy="strict"))
        raised = None
    except GuardedSolveError as e:
        raised = e
    check(raised is not None and steps(raised.trace)
          == [("attempt", "cg", False)], f"strict: {raised}")
    out["strict"] = {"raised": type(raised).__name__,
                     "trace": steps(raised.trace)}
    want = {k: 0 for k in escalation_tally()}
    for trace in (out["negated"]["trace"], out["flaky"]["trace"]):
        for stage, _, _ in trace[1:]:
            want[stage] += 1
    want["strict_failures"] += 1
    check(escalation_tally() == want,
          f"ladder: tally {escalation_tally()}, its traces give {want}")
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
    to ``evaluation_launches`` of those iterations (with ``lanczos`` Lanczos
    sweeps an evaluation after a PCG solve)."""

    def __init__(self, name: str, engine, n: int, m: int, lanczos: int = 0):
        super().__init__(name)
        self.engine, self.n, self.m = engine, n, m
        self.lanczos = lanczos

    def __enter__(self):
        self.first = len(self.engine.solves)
        return super().__enter__()

    def row(self, res=None) -> dict:
        iters = [sv["iters"] for sv in self.engine.solves[self.first:]]
        want = evaluation_launches(self.n, self.m, iters,
                                   lanczos=self.lanczos)
        for name, count in self.by_kernel.items():
            check(count == want.get(name, 0),
                  f"{self.name}: {count} launches of {name}, expected "
                  f"{want.get(name, 0)} for solver iterations {iters} + "
                  f"{self.lanczos} Lanczos sweeps + 2 an evaluation")
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


# The automl phase: bench_automl.py's four schedulers at the paper's LCBench
# shape, the data a sample_task replayed through RunPool.replay, every fit
# and refit on the routed cuda engine through rank-15 PCG. Depth cut: the
# cold fit's L-BFGS runs 10 iterations (the schedulers' default 30); the
# refits bench_automl.py's 8. SH: R = 52, eta = 3, min_epochs = 1 (rungs at
# 1, 3, 9 and 52 epochs over 2000, 667, 223 and 75 configurations), UCB with
# beta 0 as bench_automl.py; freeze-thaw refits every m // 4 = 13 epochs;
# Hyperband over 243 configurations, R = 27.
AUTOML_SHAPE = dict(n=2000, m=52, d=7)
AUTOML_GP = dict(backend="cuda", precond_rank=SOLVER_PCG_RANK,
                 lbfgs_iters=10, **FIT_CONFIG)
AUTOML_REFIT_LBFGS_ITERS = 8
AUTOML_HYPERBAND = dict(n=243, m=27, d=7)
AUTOML_ETA = 3


class TracedPredictor(CurvePredictor):
    """The schedulers' CurvePredictor on a logging cuda engine: every update
    (cold fit, or extend + warm refit) is held to its evaluations' launches
    (PCG iterations + slq_iters Lanczos sweeps + 2 each), every
    predict_final that solves to its PCG iterations on the route of its
    bucket with a healthy one-step trace, and a cached read to no launch at
    all. Each gives a row: seconds, evaluations, iterations, launches."""

    def __init__(self, X, max_epochs: int, cfg, seed: int, t, name: str):
        super().__init__(X, max_epochs, gp=cfg.gp, maximize=cfg.maximize,
                         refit_lbfgs_iters=cfg.refit_lbfgs_iters, seed=seed,
                         t=t, amortizer=cfg.amortizer,
                         engine=LoggedKernelEngine(), device=DEV)
        self.name = name
        self.rows: list[dict] = []
        self.first_state = None
        self.first_mean = None

    def update(self, Y, mask) -> None:
        n, m = self.X.shape[0], self.max_epochs
        kind = "fit" if self.state is None else "extend+refit"
        with WarmStep(f"{self.name} {kind} {self.n_refits}", self.engine, n,
                      m, lanczos=self.gp.slq_iters) as req:
            super().update(Y, mask)
        res = self.state.fit_result
        row = req.row(res)
        row.update(update=kind, observed=int(np.sum(mask)),
                   lbfgs_iters=res.n_iters, fun=res.fun,
                   optimizer=res.optimizer, init_source=res.init_source)
        row["pcg_iters_per_eval"] = row.pop("cg_iters_per_eval")
        row["pcg_iters"] = sum(row.pop("cg_iters"))
        check(np.isfinite(res.fun), f"{req.name}: objective {res.fun}")
        self.rows.append(row)
        if self.first_state is None:
            self.first_state = self.state

    def predict_final(self, generator=None, *, normals=None):
        cached = (generator is None and normals is None
                  and self._final_cache is not None
                  and self._final_cache[0] == self.n_refits)
        name = f"{self.name} final {self.n_refits}"
        with Request(name) as req:
            mean, std = super().predict_final(generator, normals=normals)
        check(np.isfinite(mean).all() and np.isfinite(std).all(),
              f"{name}: values not finite")
        if cached:
            check(not any(req.by_kernel.values()),
                  f"{name}: a cached read launched {req.by_kernel}")
            return mean, std
        post = posterior(self.state, device=DEV)
        s = check_solve(post, req, self.gp.cg_tol)
        check(req.launches == s["iters"],
              f"{name}: {req.launches} sweeps for {s['iters']} PCG iterations")
        # the solve ran on the observed prefix of the epoch grid
        n, m = self.X.shape[0], post._prefix
        check_route(req, n, m, s["columns"])
        self.rows.append({"step": f"final {self.n_refits}",
                          "seconds": req.seconds, "launches": req.by_kernel,
                          "route": routed(n, m, s["columns"]),
                          "prefix_cols": m, **s})
        if self.n_refits == 1 and self.first_mean is None:
            self.first_mean = mean
        return mean, std


def freeze_thaw(task, gp: LKGPConfig, amortizer=None,
                name: str = "ft") -> dict:
    """Freeze-thaw over the replayed task on the traced cuda engine (refits
    every m // 4 epochs, UCB beta 1): every update held to its evaluations'
    launches, every read to its PCG iterations; the summary with the regret
    of the configuration it selects."""
    m = task.Y_full.shape[1]
    true_final = task.Y_full[:, -1]
    ft_cfg = AutotuneConfig(max_epochs=m, refit_every=max(2, m // 4),
                            min_epochs_before_stop=1, ucb_beta=1.0, gp=gp,
                            refit_lbfgs_iters=AUTOML_REFIT_LBFGS_ITERS,
                            amortizer=amortizer)
    ft = FreezeThawScheduler(task.X, replay_step_fns(task), ft_cfg,
                             seed=SEED, t=task.t, device=DEV)
    ft.predictor = TracedPredictor(task.X, m, ft_cfg, SEED, task.t, name)
    with Request(name) as req:
        fts = ft.run()
    pred_final = np.asarray(fts["predicted_final"])
    check(np.isfinite(pred_final).all(), f"{name}: predictions")
    surv = fts["survivors"]
    sel = surv[int(np.argmax(pred_final[surv]))]
    check(len(fts["stop_events"]) == (m - 1) // ft_cfg.refit_every,
          f"{name}: {len(fts['stop_events'])} refits")
    return {
        "seconds": req.seconds, "launches": req.by_kernel,
        "epochs_spent": fts["epochs_spent"], "survivors": len(surv),
        "stop_events": [{k: e[k] for k in ("epoch", "active")}
                        for e in fts["stop_events"]],
        "selected": sel, "regret": float(true_final.max() - true_final[sel]),
        "steps": ft.predictor.rows}


def scores_finite(rungs) -> bool:
    return all(np.isfinite(r["scores"]).all() for r in rungs)


def phase_automl(n: int, m: int, d: int) -> dict:
    """The AutoML schedulers through the routed cuda engine at full width:
    (1) SH with LKGP promotion over 2000 configurations replayed from a
    synthetic task (every rung an update and a final() read, each held to
    its launches; a second default read on the unchanged state launches
    nothing; rung 0's predicted final mean held against the float64
    iterative engine's on the same state by MEAN_TOL_VS_ITERATIVE);
    (2) SH with rank promotion at the same budget, for the regret beside it;
    (3) freeze-thaw, keyed final() reads; (4) Hyperband over 243
    configurations. Every score finite."""
    t_phase = time.perf_counter()
    task = sample_task(SEED, n=n, m=m, d=d)
    gp = LKGPConfig(**AUTOML_GP)
    true_final = task.Y_full[:, -1]
    best = float(true_final.max())
    out = {"phase": "automl", "n": n, "m": m, "d": d, "dtype": "float64",
           "backend": "cuda", "precond_rank": gp.precond_rank,
           "lbfgs_iters": gp.lbfgs_iters,
           "refit_lbfgs_iters": AUTOML_REFIT_LBFGS_ITERS,
           "allocated_at_start_bytes": start_memory()}

    def sh_cfg(promotion, max_epochs):
        return SHConfig(max_epochs=max_epochs, min_epochs=1, eta=AUTOML_ETA,
                        promotion=promotion, ucb_beta=0.0, gp=gp,
                        refit_lbfgs_iters=AUTOML_REFIT_LBFGS_ITERS)

    # (1) SH, LKGP promotion
    cfg = sh_cfg("lkgp", m)
    pred = TracedPredictor(task.X, m, cfg, SEED, task.t, "sh")
    sched = SuccessiveHalvingScheduler(task.X, None, cfg, seed=SEED,
                                       pool=RunPool.replay(task),
                                       predictor=pred, t=task.t)
    with Request("sh_lkgp") as req:
        sh = sched.run()
    with Request("sh_second_read") as again:
        pred.predict_final()
    check(not any(again.by_kernel.values()),
          f"a second predict_final() launched {again.by_kernel}")
    check(scores_finite(sh["rungs"]), "sh lkgp: a score is not finite")
    sizes, targets = [n], [1]
    while targets[-1] * AUTOML_ETA <= m:
        targets.append(targets[-1] * AUTOML_ETA)
        sizes.append(-(-sizes[-1] // AUTOML_ETA))
    targets[-1] = m      # the last rung runs to full fidelity: 1, 3, 9, 52
    check([len(r["active"]) for r in sh["rungs"]] == sizes
          and [r["target_epochs"] for r in sh["rungs"]] == targets,
          f"sh lkgp rungs: {[len(r['active']) for r in sh['rungs']]} at "
          f"{[r['target_epochs'] for r in sh['rungs']]}, expected {sizes} "
          f"at {targets}")
    # rung 0's final mean against the float64 iterative engine (plain CG)
    st_it = dataclasses.replace(pred.first_state, config=dataclasses.replace(
        gp, backend="iterative", precond_rank=0))
    with Request("rung0_iterative") as req_it:
        mean_it = posterior(st_it, cache=False, device=DEV).mean[:, -1]
    check(not any(req_it.by_kernel.values()),
          "the iterative engine launched kernels")
    mean_it = mean_it.cpu().numpy()
    scale = float(np.abs(mean_it).max())
    gap = float(np.abs(pred.first_mean - mean_it).max())
    tol = MEAN_TOL_VS_ITERATIVE * gp.cg_tol * scale
    check(gap <= tol, f"rung 0 final mean vs iterative: gap {gap:.3e} > "
                      f"{tol:.3e}")
    del st_it
    regret_lkgp = best - float(true_final[sh["selected"]])
    out["sh_lkgp"] = {
        "seconds": req.seconds, "launches": req.by_kernel,
        "epochs_spent": sh["epochs_spent"], "selected": sh["selected"],
        "regret": regret_lkgp,
        "rungs": [{"target_epochs": r["target_epochs"],
                   "active": len(r["active"]),
                   "epochs_spent": r["epochs_spent"]} for r in sh["rungs"]],
        "steps": pred.rows,
        "rung0_vs_iterative": {"mean_gap": gap, "tol": tol, "scale": scale,
                               "seconds": req_it.seconds}}
    del pred, sched

    # (2) SH, rank promotion, same rung schedule and budget
    rank = SuccessiveHalvingScheduler(task.X, None, sh_cfg("rank", m),
                                      seed=SEED, pool=RunPool.replay(task))
    with Request("sh_rank") as req:
        rk = rank.run()
    check(not any(req.by_kernel.values()), "rank promotion launched kernels")
    check(rk["epochs_spent"] == sh["epochs_spent"],
          f"budgets differ: rank {rk['epochs_spent']}, "
          f"lkgp {sh['epochs_spent']}")
    out["sh_rank"] = {"seconds": req.seconds,
                      "epochs_spent": rk["epochs_spent"],
                      "selected": rk["selected"],
                      "regret": best - float(true_final[rk["selected"]])}
    out["regret_lkgp_minus_rank"] = regret_lkgp - out["sh_rank"]["regret"]

    # (3) freeze-thaw
    out["freeze_thaw"] = freeze_thaw(task, gp)

    # (4) Hyperband over 243 configurations, R = 27
    hb_task = sample_task(SEED + 1, **AUTOML_HYPERBAND)
    hb_m = AUTOML_HYPERBAND["m"]
    hb_cfg = sh_cfg("lkgp", hb_m)
    hb = HyperbandScheduler(hb_task.X, replay_step_fns(hb_task), hb_cfg,
                            seed=SEED, t=hb_task.t, device=DEV)
    hb.predictor = TracedPredictor(hb_task.X, hb_m, hb_cfg, SEED, hb_task.t,
                                   "hyperband")
    with Request("hyperband") as req:
        hbs = hb.run()
    check(all(scores_finite(b["rungs"]) for b in hbs["brackets"]),
          "hyperband: a score is not finite")
    hb_true = hb_task.Y_full[:, -1]
    out["hyperband"] = {
        **{k: v for k, v in AUTOML_HYPERBAND.items()},
        "seconds": req.seconds, "launches": req.by_kernel,
        "brackets": [{"bracket": b["bracket"], "n_configs": b["n_configs"],
                      "min_epochs": b["min_epochs"],
                      "epochs_spent": b["epochs_spent"]}
                     for b in hbs["brackets"]],
        "epochs_spent": hbs["epochs_spent"], "selected": hbs["selected"],
        "regret": float(hb_true.max() - hb_true[hbs["selected"]]),
        "updates": hb.predictor.n_refits, "steps": hb.predictor.rows}
    del hb
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# The service phase: bench_serving.py's full sizes (8 tenants of n=16, m=12,
# d=4 on the dense engine, 12 L-BFGS iterations, a warm refit of 3 every 4th
# observe; 200 warm and cold requests; 6 rounds of throughput at n=8, m=10),
# test_reliability.py's chaos schedule, and a service whose gp is the routed
# cuda engine (4 tenants at n=48, m=20; depth cut: 5 cold L-BFGS iterations
# where the default is 100, warm refits of 2).
SERVICE_TENANTS = 8
SERVICE_SHAPE = dict(n=16, m=12, d=4)
SERVICE_LBFGS_ITERS = 12
SERVICE_REQUESTS = 200
SERVICE_ROUNDS = 6
SERVICE_THROUGHPUT_SHAPE = dict(n=8, m=10, d=4)
CUDA_SERVICE_TENANTS = 4
CUDA_SERVICE_SHAPE = dict(n=48, m=20, d=4)
CUDA_SERVICE_LBFGS_ITERS = 5
CUDA_SERVICE_REFIT_LBFGS_ITERS = 2
CHAOS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


def reveal_one_epoch(mask: np.ndarray) -> np.ndarray:
    """Every curve's observed prefix one epoch longer."""
    mask = mask.copy()
    for i in range(mask.shape[0]):
        k = int(mask[i].sum())
        if k < mask.shape[1]:
            mask[i, k] = 1.0
    return mask


def latency_summary(seconds: list[float]) -> dict:
    """p50 / p99 / mean in ms, the service's own (interpolated) percentiles."""
    xs = sorted(seconds)
    return {"count": len(xs), "p50_ms": 1e3 * percentile(xs, 50.0),
            "p99_ms": 1e3 * percentile(xs, 99.0),
            "mean_ms": 1e3 * statistics.mean(xs)}


def dense_service(n: int, m: int, d: int, refit_every: int = 4, **config):
    """A service on the card with SERVICE_TENANTS tenants cold-fitted through
    one coalesced observe_batch."""
    svc = PredictionService(ServiceConfig(
        gp=LKGPConfig(lbfgs_iters=SERVICE_LBFGS_ITERS, backend="dense"),
        capacity=SERVICE_TENANTS, refit_every=refit_every,
        refit_lbfgs_iters=3, **config), device=DEV)
    tasks = {f"tenant-{i}": sample_task(seed=i, n=n, m=m, d=d)
             for i in range(SERVICE_TENANTS)}
    infos = svc.observe_batch([
        dict(tenant=name, task="run", X=tk.X, t=tk.t, Y=tk.Y, mask=tk.mask)
        for name, tk in tasks.items()])
    return svc, tasks, infos


def phase_service() -> dict:
    """PredictionService on the card. (1) Cold fits coalesced through
    observe_batch; predict_many bitwise predict for every tenant; warm
    (cache hit) and cold (cache bypassed) latency over 200 requests.
    (2) Throughput of per-request against coalesced predictions, 6 rounds
    at n=8, m=10, each after one more observed epoch. (3) The reliability
    suite's chaos schedule in a temporary directory: a NaN payload
    quarantined, evict_session, a checkpoint, crash_and_restore; the
    restored predictions bitwise a control service's. (4) A service on the
    routed cuda engine: its cold fits and refits launch the MVM kernels."""
    t_phase = time.perf_counter()
    out = {"phase": "service", "device": str(DEV),
           "allocated_at_start_bytes": start_memory()}

    # (1) coalesced cold fits, bitwise coalescing, latency
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc, tasks, infos = dense_service(**SERVICE_SHAPE)
    torch.cuda.synchronize()
    cold_fit_s = time.perf_counter() - t0
    counters = {k: c.value for k, c in svc.counters.items()}
    check([i["action"] for i in infos] == ["fit_batch"] * SERVICE_TENANTS
          and counters["coalesced_groups"] == 1
          and counters["coalesced_requests"] == SERVICE_TENANTS,
          f"cold fits not coalesced: {counters}")
    names = list(tasks)
    singles = {name: svc.predict(name, "run") for name in names}
    coalesced = svc.predict_many([(name, "run") for name in names])
    check(all(p.batch_size == SERVICE_TENANTS for p in coalesced)
          and all(np.array_equal(singles[p.tenant].mean, p.mean)
                  and np.array_equal(singles[p.tenant].var, p.var)
                  for p in coalesced),
          "predict_many is not bitwise predict")
    check(all(np.isfinite(p.mean).all() and (p.var > 0).all()
              for p in coalesced), "service predictions: values")
    stream = [names[i % SERVICE_TENANTS] for i in range(SERVICE_REQUESTS)]
    cold, warm = [], []
    for name in stream:
        session = svc.store.get(SessionKey(name, "run"))
        t0 = time.perf_counter()
        mean, var = posterior_batch(session.stacked(), cache=False,
                                    device=DEV).final()
        mean.cpu().numpy(), var.cpu().numpy()
        cold.append(time.perf_counter() - t0)
    for name in stream:
        t0 = time.perf_counter()
        svc.predict(name, "run")
        warm.append(time.perf_counter() - t0)
    out["latency"] = {**SERVICE_SHAPE, "tenants": SERVICE_TENANTS,
                      "cold_fit_seconds": cold_fit_s,
                      "cold": latency_summary(cold),
                      "warm": latency_summary(warm)}
    out["coalesced_bitwise_per_request"] = True
    del svc

    # (2) throughput, per request against coalesced
    svc, tasks, _ = dense_service(**SERVICE_THROUGHPUT_SHAPE, refit_every=0)
    keys = [(name, "run") for name in tasks]
    masks = {name: np.asarray(tk.mask).copy() for name, tk in tasks.items()}

    def observe_round():
        for name, tk in tasks.items():
            masks[name] = reveal_one_epoch(masks[name])
            Y = np.where(masks[name] > 0, np.asarray(tk.Y_full), 0.0)
            svc.observe(name, "run", Y, masks[name])

    observe_round()
    for name, _ in keys:
        svc.predict(name, "run")
    svc.predict_many(keys)
    per_request = coalesced_s = 0.0
    for _ in range(SERVICE_ROUNDS):
        observe_round()
        t0 = time.perf_counter()
        for name, _ in keys:
            svc.predict(name, "run")
        per_request += time.perf_counter() - t0
        observe_round()
        t0 = time.perf_counter()
        svc.predict_many(keys)
        coalesced_s += time.perf_counter() - t0
    total = SERVICE_ROUNDS * SERVICE_TENANTS
    out["throughput"] = {**SERVICE_THROUGHPUT_SHAPE, "rounds": SERVICE_ROUNDS,
                         "per_request_rps": total / per_request,
                         "coalesced_rps": total / coalesced_s,
                         "coalesced_speedup": per_request / coalesced_s}
    out["metrics"] = {k: v for k, v in svc.metrics().items()
                      if k in ("counters", "compiled_caches",
                               "predict_latency", "observe_latency")}
    del svc

    # (3) the chaos schedule
    out["chaos"] = chaos_schedule()

    # (4) a service on the routed cuda engine
    out["cuda_service"] = cuda_service()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def chaos_schedule() -> dict:
    """test_reliability.py's chaos schedule on the card."""
    CHAOS_DIR.mkdir(parents=True, exist_ok=True)
    tasks = [sample_task(seed=i, n=6, m=8, d=4) for i in range(4)]
    with tempfile.TemporaryDirectory(dir=CHAOS_DIR) as tmp:
        def make(name):
            return PredictionService(ServiceConfig(
                gp=LKGPConfig(lbfgs_iters=5, backend="dense"), refit_every=0,
                checkpoint_dir=os.path.join(tmp, name), checkpoint_every=0),
                device=DEV)

        control, chaos = make("control"), make("chaos")
        for svc in (control, chaos):
            for i, task in enumerate(tasks):
                check(svc.observe(f"tenant{i}", "job", Y=task.Y,
                                  mask=task.mask, X=task.X,
                                  t=task.t)["action"] == "fit", "cold fit")
        schedule = FaultSchedule()
        schedule.add(0, lambda service: service.observe(
            "tenant0", "job", *poison_nan(tasks[0].Y, tasks[0].mask)))
        schedule.add(1, lambda service: evict_session(service, "tenant3",
                                                      "job"))
        schedule.add(2, lambda service: service.checkpoint())
        grids = {i: (tasks[i].Y, tasks[i].mask) for i in (1, 2)}
        fired = []
        for rnd in range(3):
            for i in (1, 2):
                Y, mask = grids[i]
                mask = reveal_one_epoch(np.asarray(mask))
                Y = np.where(mask > np.asarray(grids[i][1]),
                             0.1 * (rnd + 1), np.asarray(Y))
                grids[i] = (Y, mask)
                for svc in (control, chaos):
                    check(svc.observe(f"tenant{i}", "job", Y=Y,
                                      mask=mask)["action"] == "extend",
                          "healthy extend")
            fired.append(schedule.fire(rnd, service=chaos))
        check(fired[0][0]["action"] == "quarantined", "NaN not quarantined")
        check(fired[1][0] is True, "eviction failed")
        chaos, restored = crash_and_restore(chaos)
        check(restored == 3 and SessionKey("tenant3", "job")
              not in chaos.store, f"restored {restored} sessions")
        bitwise = True
        for i in (1, 2):
            want = control.predict(f"tenant{i}", "job")
            got = chaos.predict(f"tenant{i}", "job")
            bitwise &= (np.array_equal(want.mean, got.mean)
                        and np.array_equal(want.var, got.var)
                        and want.generation == got.generation)
        check(bitwise, "restored predictions differ from the control's")
        check(chaos.predict("tenant0", "job").generation == 0,
              "the quarantined tenant lost its last good state")
        counters = chaos.metrics()["counters"]
        return {"quarantined": 1, "evicted": 1, "checkpoint_step": fired[2][0],
                "restored_sessions": restored, "restored_bitwise": bitwise,
                "restores": counters["restores"],
                "device": str(chaos.device)}


def cuda_service() -> dict:
    """A service whose gp is the routed cuda engine: cold fits one by one
    (a coalesced cold fit is the exact dense fit_batch), then two rounds of
    one more epoch (an extend, then an extend with a warm refit); launches
    by step. An extend swaps transforms only and launches nothing."""
    svc = PredictionService(ServiceConfig(
        gp=LKGPConfig(backend="cuda", lbfgs_iters=CUDA_SERVICE_LBFGS_ITERS),
        capacity=CUDA_SERVICE_TENANTS, refit_every=2,
        refit_lbfgs_iters=CUDA_SERVICE_REFIT_LBFGS_ITERS),
        device=DEV)
    tasks = {f"tenant-{i}": sample_task(seed=100 + i, **CUDA_SERVICE_SHAPE)
             for i in range(CUDA_SERVICE_TENANTS)}
    rows = {}
    with Request("cuda_service_cold_fits") as req:
        for name, tk in tasks.items():
            check(svc.observe(name, "run", tk.Y, tk.mask, X=tk.X,
                              t=tk.t)["action"] == "fit", "cold fit")
    rows["cold_fits"] = {"seconds": req.seconds, "launches": req.by_kernel}
    masks = {name: np.asarray(tk.mask) for name, tk in tasks.items()}
    for step in ("extend", "extend+refit"):
        with Request(f"cuda_service_{step}") as req:
            for name, tk in tasks.items():
                masks[name] = reveal_one_epoch(masks[name])
                Y = np.where(masks[name] > 0, np.asarray(tk.Y_full), 0.0)
                check(svc.observe(name, "run", Y, masks[name])["action"]
                      == step, f"cuda service: not an {step}")
        rows[step] = {"seconds": req.seconds, "launches": req.by_kernel}
    preds = svc.predict_many([(name, "run") for name in tasks])
    check(all(np.isfinite(p.mean).all() and (p.var > 0).all()
              for p in preds), "cuda service predictions: values")
    for step in ("cold_fits", "extend+refit"):
        check(sweeps(rows[step]["launches"]) > 0,
              f"the cuda service's {step} launched no MVM kernel")
    check(not any(rows["extend"]["launches"].values()),
          "an extend launched kernels")
    return {**CUDA_SERVICE_SHAPE, "tenants": CUDA_SERVICE_TENANTS,
            "lbfgs_iters": CUDA_SERVICE_LBFGS_ITERS,
            "refit_lbfgs_iters": CUDA_SERVICE_REFIT_LBFGS_ITERS, "steps": rows,
            "backend_used": svc.store.get(
                SessionKey("tenant-0", "run")).state.backend_used}


# The amortize phase. Reference outputs: tests/fixtures/reference_amortizer.npz
# (tests/fixtures/make_reference_amortizer.py, JAX on the CPU), held within
# AMORTIZE_TOL of max|reference|. The MLL-gap rows are bench_automl.py's
# amortized rows (d=5, n=12, m=9, seeds 0-3, the packaged d=5 fixture), each
# gap within GAP_TOL of the reference's (per-observation objective units).
# The d=7 amortizer trains at AmortizeTrainConfig()'s defaults (400 steps of
# 8 tasks, n=8, m=9). Its freeze-thaw is the automl phase's (n=2000, m=52,
# d=7, rank-15 PCG on the routed cuda engine) with every fit and refit
# amortized + AMORTIZE_POLISH_STEPS polish steps.
REFERENCE_AMORTIZER_NPZ = (Path(__file__).resolve().parent / "tests"
                           / "fixtures" / "reference_amortizer.npz")
AMORTIZE_TOL = 1e-4
GAP_TOL = 1e-4
AMORTIZE_TRAIN = AmortizeTrainConfig()
AMORTIZE_POLISH_STEPS = 2
AMORTIZE_BATCH = dict(tasks=4, n=16, m=12)
CT_CONFIG = dict(d_in=7, d_model=32, num_layers=2, num_heads=2, d_ff=64)


def check_full_f32_matmuls(phase: str) -> dict:
    """float32 matmuls in full float32 (the amortizer's and the curve
    transformer's parity with the reference rests on it), not TF32."""
    setting = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
               "float32_matmul_precision":
                   torch.get_float32_matmul_precision()}
    check(setting == {"allow_tf32": False,
                      "float32_matmul_precision": "highest"},
          f"{phase}: float32 matmuls may run in TF32: {setting}")
    return setting


def relative_gap(got: torch.Tensor, want: np.ndarray) -> tuple[float, float]:
    err = float(np.abs(got.detach().cpu().numpy() - want).max())
    return err, AMORTIZE_TOL * float(np.abs(want).max())


def amortizer_reference_rows() -> list[dict]:
    """The packaged d=5 fixture's init_flat (n=40, and n=2048 through the
    chunked attention) and curve_transformer.forward with the reference's
    parameters at two shapes, on the card, against the reference's outputs
    in the .npz."""
    with np.load(REFERENCE_AMORTIZER_NPZ) as z:
        ref = dict(z)
    rows = []
    am = Amortizer.load(FIXTURE_DIR / "amortizer_d5.npz", device=DEV)
    i = 0
    while f"am{i}_out" in ref:
        args = [torch.from_numpy(ref[f"am{i}_{k}"]).to(DEV)
                for k in ("Xn", "tn", "Yn", "mask")]
        with Request(f"init_flat {i}") as req:
            got = am.init_flat(*args)
        err, tol = relative_gap(got, ref[f"am{i}_out"])
        rows.append({"name": "amortizer.init_flat",
                     "shape": list(args[3].shape), "max_err": err,
                     "tol": tol, "seconds": req.seconds})
        check(err <= tol and not any(req.by_kernel.values()),
              f"init_flat at {tuple(args[3].shape)}: {err:.3e} > {tol:.3e}")
        i += 1
    params = tree_from_numpy({k.split("/", 1)[1]: v for k, v in ref.items()
                              if k.startswith("ct_params/")}, device=DEV)
    cfg = CurveTransformerConfig(**CT_CONFIG)
    i = 0
    while f"ct{i}_mu" in ref:
        args = [torch.from_numpy(ref[f"ct{i}_{k}"]).to(DEV)
                for k in ("hp", "y", "mask", "t_norm")]
        with Request(f"curve forward {i}"), torch.no_grad():
            mu, sigma = curve_forward(params, *args, cfg)
        for got, key in ((mu, "mu"), (sigma, "sigma")):
            err, tol = relative_gap(got, ref[f"ct{i}_{key}"])
            rows.append({"name": f"curve_transformer.forward {key}",
                         "shape": list(args[1].shape), "max_err": err,
                         "tol": tol})
            check(err <= tol, f"curve forward {key} at "
                              f"{tuple(args[1].shape)}: {err:.3e} > {tol:.3e}")
        i += 1
    return rows


def mll_gap_rows() -> list[dict]:
    """bench_automl.py's amortized MLL-gap rows on the card (dense float64
    fits, the packaged d=5 amortizer): the converged objective (60 L-BFGS
    iterations) and the gaps of the default, the one-shot amortized and the
    polished amortized init, each within GAP_TOL of the reference's."""
    with np.load(REFERENCE_AMORTIZER_NPZ) as z:
        ref = dict(z)
    clear_amortizer_registry()
    register_amortizer(Amortizer.load(FIXTURE_DIR / "amortizer_d5.npz",
                                      device=DEV))
    rows = []
    for j, seed in enumerate(ref["gap_seeds"].tolist()):
        task = sample_task(seed=900 + seed, n=12, m=9, d=5, noise=0.005,
                           crossing=True)
        args = (task.X, task.t, task.Y, task.mask)

        def fun(**cfg):
            return fit(*args, LKGPConfig(**cfg)).fit_result.fun

        t0 = time.perf_counter()
        conv = fun(lbfgs_iters=60)
        row = {"seed": seed, "fun_converged": conv,
               "gap_default": fun(polish_steps=0) - conv,
               "gap_amortized": fun(hyper_init="amortized",
                                    polish_steps=0) - conv,
               "gap_polished": fun(hyper_init="amortized",
                                   polish_steps=2) - conv,
               "seconds": time.perf_counter() - t0}
        for key, ref_key in (("fun_converged", "gap_converged"),
                             ("gap_default", "gap_default"),
                             ("gap_amortized", "gap_amortized"),
                             ("gap_polished", "gap_polished")):
            want = float(ref[ref_key][j])
            check(abs(row[key] - want) <= GAP_TOL,
                  f"MLL gap seed {seed} {key}: {row[key]:.6f} against the "
                  f"reference's {want:.6f}")
        rows.append(row)
    clear_amortizer_registry()
    return rows


def refit_summary(ft: dict) -> dict:
    """Per update of a traced freeze-thaw: seconds, evaluations, PCG
    iterations, launches (already held to those iterations)."""
    ups = [r for r in ft["steps"] if "update" in r]
    reads = [r for r in ft["steps"] if "iters" in r]
    return {"seconds": ft["seconds"], "regret": ft["regret"],
            "selected": ft["selected"],
            "updates": [{k: r[k] for k in ("step", "seconds", "evaluations",
                                           "pcg_iters", "launches", "fun",
                                           "optimizer", "init_source")}
                        for r in ups],
            "reads": [{k: r[k] for k in ("step", "seconds", "iters")}
                      for r in reads],
            "update_seconds": sum(r["seconds"] for r in ups),
            "evaluations": sum(r["evaluations"] for r in ups),
            "pcg_iters": sum(r["pcg_iters"] for r in ups)}


def phase_amortize(n: int, m: int, d: int, lbfgs_arm: dict | None = None
                   ) -> dict:
    """The amortized init on the card: (1) the reference's outputs from the
    .npz; (2) bench_automl.py's MLL-gap rows; (3) a d=7 amortizer trained on
    the card; (4) the automl phase's freeze-thaw again with it (amortized +
    polish on every fit and refit), and with the same polish from the
    default init, beside that phase's host L-BFGS arm;
    (5) fit_batch with the amortized init bitwise per-task fit, and two
    amortized polishes at n=2000 the same bits."""
    t_phase = time.perf_counter()
    out = {"phase": "amortize", "n": n, "m": m, "d": d,
           "matmul": check_full_f32_matmuls("amortize"),
           "allocated_at_start_bytes": start_memory()}
    out["reference"] = amortizer_reference_rows()
    out["mll_gap"] = mll_gap_rows()

    # (3) a d-dimensional amortizer trained here
    acfg = AmortizerConfig(d=d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    am, info = train_amortizer(acfg, AMORTIZE_TRAIN, device=DEV,
                               out=lambda *_: None)
    seconds = time.perf_counter() - t0
    check(np.isfinite(info["first_loss"]) and np.isfinite(info["final_loss"])
          and info["final_loss"] < info["first_loss"],
          f"amortizer training did not converge: {info}")
    out["train"] = {**info, "seconds": seconds,
                    "steps_per_second": info["steps"] / seconds,
                    "tasks_per_step": AMORTIZE_TRAIN.tasks_per_step,
                    "task_shape": [AMORTIZE_TRAIN.n, AMORTIZE_TRAIN.m]}

    # (4) freeze-thaw with it, every update amortized + polished
    task = sample_task(SEED, n=n, m=m, d=d)
    gp = dataclasses.replace(LKGPConfig(**AUTOML_GP), hyper_init="amortized",
                             polish_steps=AMORTIZE_POLISH_STEPS)
    ft = freeze_thaw(task, gp, amortizer=am, name="ft_amortized")
    for r in ft["steps"]:
        if "update" in r:
            check(r["init_source"] == "amortized"
                  and r["optimizer"] == "polish"
                  and r["evaluations"] == 1 + 4 * AMORTIZE_POLISH_STEPS,
                  f"amortized freeze-thaw update: {r}")
    # the same polish from the default init (refits warm-started from the
    # previous optimum): what the polish buys without the amortizer
    plain = dataclasses.replace(gp, hyper_init="default")
    ft_plain = freeze_thaw(task, plain, name="ft_default_polish")
    for r in ft_plain["steps"]:
        if "update" in r:
            check(r["init_source"] in ("default", "params")
                  and r["evaluations"] == 1 + 4 * AMORTIZE_POLISH_STEPS,
                  f"default-init freeze-thaw update: {r}")
    out["freeze_thaw"] = {"amortized_polish": refit_summary(ft),
                          "default_polish": refit_summary(ft_plain)}
    if lbfgs_arm is not None:
        out["freeze_thaw"]["host_lbfgs"] = refit_summary(lbfgs_arm)

    # (5) bitwise: fit_batch = per-task fit; two polishes at full width
    tasks = sample_suite(SEED + 3, AMORTIZE_BATCH["tasks"], d=d,
                         n=AMORTIZE_BATCH["n"], m=AMORTIZE_BATCH["m"])
    X, t, Y, mask, _ = stack_suite(tasks)
    cfg = LKGPConfig(hyper_init="amortized")
    batch = fit_batch(X, t, Y, mask, cfg, polish_steps=AMORTIZE_POLISH_STEPS,
                      amortizer=am)
    singles = [fit(tk.X, tk.t, tk.Y, tk.mask, LKGPConfig(backend="dense"),
                   init="amortized", polish_steps=AMORTIZE_POLISH_STEPS,
                   amortizer=am) for tk in tasks]
    equal = [all(torch.equal(a, b) for a, b in zip(s.params, b_i.params))
             for s, b_i in zip(singles, unstack(batch))]
    check(all(equal), f"amortized fit_batch != per-task fit: {equal}")
    engine = LoggedKernelEngine()
    polishes = []
    for k in range(2):
        with WarmStep(f"amortized polish {k}", engine, n, m,
                      lanczos=gp.slq_iters) as req:
            st = fit(task.X, task.t, task.Y, task.mask, gp, engine=engine,
                     amortizer=am)
        row = req.row(st.fit_result)
        row.pop("cg_iters")
        polishes.append((st, row))
    (a, ra), (b, rb) = polishes
    same = all(torch.equal(x, y) for x, y in zip(a.params, b.params))
    check(same, "two amortized polishes gave different bits")
    out["bitwise"] = {"fit_batch_equals_fit": equal,
                      "fit_batch_tasks": AMORTIZE_BATCH,
                      "two_polishes_equal": same,
                      "polish": [ra, rb]}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# The curvepred phase: bench_curve_pred.py's full configuration, the
# transformer CurveTransformerConfig(d_in=7) (d_model 64, 3 layers, 4 heads,
# d_ff 128) pre-trained on the card, then head_to_head on its three suites
# (5 tasks each, n=16, m=12, cutoffs 0.2 / 0.4 / 0.7) against the LKGP with
# 40 L-BFGS iterations; the paper's tolerance band as bench_curve_pred.py
# gates it (reported). The pretraining is cut from the benchmark's 2000
# steps to 1000 (tasks_per_step=6, n=16, m=12): the host-bound steps took
# 74 s of a run at 88 % of the script's time limit.
CURVEPRED_PRETRAIN = PretrainConfig(steps=1000, tasks_per_step=6, n=16, m=12,
                                    log_every=0)
CURVEPRED_TASKS = 5
CURVEPRED_CUTOFFS = (0.2, 0.4, 0.7)
CURVEPRED_TOL = {"mae": 0.08, "nll": 1.5, "rank": 0.35}


def curvepred_suites() -> list[dict]:
    base = dict(d=7, noise=0.01, spike_prob=0.03)
    return [
        dict(name="mixed", seed=901, diverge_prob=0.03, crossing=False,
             **base),
        dict(name="crossing", seed=902, diverge_prob=0.0, crossing=True,
             **base),
        dict(name="noisy-divergent", seed=903, diverge_prob=0.08,
             crossing=False, **dict(base, noise=0.03)),
    ]


def phase_curvepred() -> dict:
    """The paper's headline comparison on the card: pre-train the curve
    transformer, then score it and the LKGP on identical held-out cells."""
    t_phase = time.perf_counter()
    out = {"phase": "curvepred",
           "matmul": check_full_f32_matmuls("curvepred"),
           "allocated_at_start_bytes": start_memory()}
    model_cfg = CurveTransformerConfig(d_in=7)
    pre = CURVEPRED_PRETRAIN
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, info = pretrain(model_cfg, pre, device=DEV, out=lambda *_: None)
    seconds = time.perf_counter() - t0
    out["pretrain"] = {**info, "seconds": seconds,
                       "steps_per_second": info["steps"] / seconds,
                       "tasks_per_step": pre.tasks_per_step, "n": pre.n,
                       "m": pre.m}
    check(info["final_loss"] < info["first_loss"],
          f"pretraining did not converge: {info}")
    gp = LKGPConfig(lbfgs_iters=40, seed=SEED)
    rows = []
    for suite in curvepred_suites():
        tasks = sample_suite(suite["seed"], CURVEPRED_TASKS, n=pre.n, m=pre.m,
                             d=suite["d"], noise=suite["noise"],
                             spike_prob=suite["spike_prob"],
                             diverge_prob=suite["diverge_prob"],
                             crossing=suite["crossing"])
        rows += head_to_head(params, model_cfg, tasks,
                             cutoffs=CURVEPRED_CUTOFFS, gp_cfg=gp, seed=SEED,
                             suite=suite["name"], device=DEV)
    check(len(rows) == 3 * CURVEPRED_TASKS * len(CURVEPRED_CUTOFFS) * 2,
          f"curvepred: {len(rows)} rows")
    summary = {}
    for model in ("lkgp", "transformer"):
        sel = [r for r in rows if r["model"] == model]
        for r in sel:
            check(all(np.isfinite(r[k]) for k in ("nll", "mae",
                                                   "rank_corr")),
                  f"curvepred row not finite: {r}")
        summary[model] = {k: float(np.mean([r[k] for r in sel]))
                          for k in ("nll", "mae", "rank_corr", "fit_s",
                                    "predict_s")}
    lk, tf = summary["lkgp"], summary["transformer"]
    out["summary"] = summary
    out["tolerances"] = CURVEPRED_TOL
    out["acceptance"] = {
        "lkgp_matches_transformer_mae":
            lk["mae"] <= tf["mae"] + CURVEPRED_TOL["mae"],
        "lkgp_matches_transformer_nll":
            lk["nll"] <= tf["nll"] + CURVEPRED_TOL["nll"],
        "lkgp_matches_transformer_rank":
            lk["rank_corr"] >= tf["rank_corr"] - CURVEPRED_TOL["rank"],
        "transformer_pretrain_converged":
            info["final_loss"] < info["first_loss"]}
    out["by_suite"] = {
        name: {model: {k: float(np.mean([r[k] for r in rows
                                         if r["suite"] == name
                                         and r["model"] == model]))
                       for k in ("nll", "mae", "rank_corr")}
               for model in ("lkgp", "transformer")}
        for name in [s["name"] for s in curvepred_suites()]}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# The zoo phase: the LM zoo's RWKV-6 at its published width (rwkv6_1b6:
# 24 layers, d_model 2048, d_ff 7168, vocabulary 65,536), served and trained
# through the entry points a user calls, and the paper's AutoML loop over
# real (reduced) RWKV training runs. Its bands, fixed before the first run on
# the card:
ZOO_ARCH = "rwkv6_1b6"
ZOO_SERVE = ["--arch", ZOO_ARCH, "--batch", "8", "--prompt-len", "64",
             "--gen", "32"]
ZOO_TRAIN_STEPS = 4
ZOO_TRAIN = ["--arch", ZOO_ARCH, "--steps", str(ZOO_TRAIN_STEPS), "--batch",
             "8", "--seq", "64", "--optimizer", "adamw", "--log-every",
             "1000", "--ckpt-every", "1000"]
ZOO_CONSISTENCY = dict(batch=2, seq=64)
# prefill(S) + one decode step against prefill(S + 1): the reference's band
# (tests/test_models_smoke.py: rtol = atol = 2e-3), element by element.
ZOO_CONSISTENCY_TOL = 2e-3
# _wkv_chunked against _wkv_scan: the reference's band (tests/
# test_substrate.py: rtol = atol = 2e-4) element by element, on the model's
# own layer-0 inputs and at the reference test's decay scales 0.5 and 8.0.
ZOO_WKV_TOL = 2e-4
ZOO_WKV_SCALES = (0.5, 8.0)
# bf16 against float32 logits of the same parameters: max error over
# max|logit|.
ZOO_BF16_BAND = 0.1
# The smoke config against the reference's outputs: times max|reference|.
ZOO_REFERENCE_TOL = 1e-4
REFERENCE_RWKV_NPZ = (Path(__file__).resolve().parent / "tests" / "fixtures"
                      / "reference_rwkv.npz")
ZOO_CKPT_DIR = RENDEZVOUS_DIR / "zoo_ckpt"


def quiet(fn, *args):
    """``fn(*args)`` with its printed lines captured: (result, lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def zoo_serve() -> dict:
    """launch.serve at the published config in bf16: a short warm-up call
    (the library handles' first use), then the timed call."""
    cfg = get_config(ZOO_ARCH)
    n_params = count_params(cfg)
    warm, _ = quiet(lm_serve.main, ZOO_SERVE[:-1] + ["2"])
    torch.cuda.reset_peak_memory_stats()
    res, printed = quiet(lm_serve.main, ZOO_SERVE)
    check(res.tokens.shape == (8, 32) and (res.tokens >= 0).all()
          and (res.tokens < cfg.vocab_size).all(),
          f"zoo serve: generated tokens {res.tokens.shape}")
    weight_bytes = n_params * torch.finfo(cfg.dtype_param).bits // 8
    bound_ms = weight_bytes / PEAK_BYTES_PER_S * 1e3
    return {"dtype": str(cfg.dtype_param), "params": n_params,
            "weight_bytes": weight_bytes, "batch": 8, "prompt_len": 64,
            "gen": 32, "wkv_path": "chunked (rwkv_chunk 16)",
            "prefill_ms": res.prefill_ms,
            "prefill_ms_first_call": warm.prefill_ms,
            "decode_ms_per_token": res.decode_ms_per_token,
            "tokens_per_s": res.tokens_per_s,
            "decode_bound_ms": bound_ms, "bound_by": "bytes",
            "decode_bound_share": bound_ms / res.decode_ms_per_token,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "printed": printed}


def elementwise_excess(got: torch.Tensor, want: torch.Tensor,
                       tol: float) -> float:
    """max(|got - want| - tol * |want|): <= tol is numpy's
    assert_allclose(rtol=atol=tol)."""
    return float(((got - want).abs() - tol * want.abs()).max())


def zoo_consistency() -> dict:
    """Float32 at full width (TF32 off): prefill(S) + decode against
    prefill(S + 1); the chunked WKV against the scan at H=32, N=64, S=64;
    the bf16 logits of the same parameters against the float32 ones."""
    out = {"matmul": check_full_f32_matmuls("zoo")}
    base = get_config(ZOO_ARCH)
    cfg = base.replace(dtype_act=torch.float32, dtype_param=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    B, S = ZOO_CONSISTENCY["batch"], ZOO_CONSISTENCY["seq"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), dtype=torch.int32,
                           device=DEV, generator=torch.Generator(
                               device=DEV).manual_seed(SEED + 1))
    with torch.no_grad():
        logits_s, cache = model.prefill(params, {"tokens": tokens[:, :S]})
        logits_a, _ = model.decode_step(params, cache, tokens[:, S:])
        logits_b, _ = model.prefill(params, {"tokens": tokens})
    excess = elementwise_excess(logits_a, logits_b, ZOO_CONSISTENCY_TOL)
    out["prefill_decode"] = {
        "S": S, "max_abs_err": float((logits_a - logits_b).abs().max()),
        "max_abs_logit": float(logits_b.abs().max()),
        "excess_over_rtol": excess, "tol": ZOO_CONSISTENCY_TOL,
        "paths": "chunked prefill(64) + scan decode vs scan prefill(65)"}
    check(excess <= ZOO_CONSISTENCY_TOL and bool(torch.isfinite(
        logits_b).all()), f"zoo: prefill + decode against a longer "
          f"prefill: {out['prefill_decode']}")

    # the chunked WKV against the scan on the model's own layer-0 inputs
    H, N = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    with torch.no_grad():
        lp = rwkv._layer(params["layers"], 0)
        x = rwkv._embed(params, tokens[:, :S], cfg)
        hn = layer_norm(x, 1.0 + lp["ln1"], lp["ln1_b"])
        xr, xk, xv, xw, _ = rwkv._ddlerp(hn, rwkv._shift(hn), lp["tm"])
        r, k, v = (rwkv._mm("bsd,dh->bsh", a, lp["tm"][w])
                   for a, w in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
        cases = [("model_layer0", (r, k, v, rwkv._decay(xw, lp["tm"]),
                                   lp["tm"]["u"], None))]
        gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
        for scale in ZOO_WKV_SCALES:
            rnd = [torch.randn((B, S, cfg.d_model), device=DEV,
                               generator=gen) for _ in range(4)]
            w = torch.exp(-torch.exp(scale * rnd[3] - 2))
            u = 0.3 * torch.randn(cfg.d_model, device=DEV, generator=gen)
            s0 = torch.randn((B, H, N, N), device=DEV, generator=gen)
            cases.append((f"decay_scale_{scale}", (*rnd[:3], w, u, s0)))
        rows = []
        for name, (r, k, v, w, u, s0) in cases:
            y_s, st_s = rwkv._wkv_scan(r, k, v, w, u, H, N, s0)
            y_c, st_c = rwkv._wkv_chunked(r, k, v, w, u, H, N,
                                          cfg.rwkv_chunk, s0)
            row = {"case": name, "H": H, "N": N, "S": S,
                   "chunk": cfg.rwkv_chunk}
            for part, got, want in (("y", y_c, y_s), ("state", st_c, st_s)):
                row[part] = {
                    "max_abs_err": float((got - want).abs().max()),
                    "max_abs": float(want.abs().max()),
                    "excess_over_rtol": elementwise_excess(got, want,
                                                           ZOO_WKV_TOL)}
                check(row[part]["excess_over_rtol"] <= ZOO_WKV_TOL,
                      f"zoo: chunked WKV against the scan: {row}")
            rows.append(row)
    out["wkv_chunked_vs_scan"] = rows

    # bf16 logits of the same parameters
    params16 = tree_map(lambda p: p.to(base.dtype_param), params)
    del params
    with torch.no_grad():
        logits16, _ = build_model(base).prefill(params16,
                                                {"tokens": tokens[:, :S]})
    gap = float((logits16.float() - logits_s).abs().max())
    scale = float(logits_s.abs().max())
    out["bf16_vs_float32"] = {"max_abs_err": gap, "max_abs_logit": scale,
                              "relative": gap / scale, "band": ZOO_BF16_BAND}
    check(gap / scale <= ZOO_BF16_BAND, f"zoo: bf16 logits against float32: "
          f"{out['bf16_vs_float32']}")
    return out


def zoo_reference_rows() -> list[dict]:
    """The smoke config on the card against the reference's outputs in
    ``reference_rwkv.npz`` (no JAX): forward logits, loss, prefill logits
    and cache, two decode steps, on both WKV paths."""
    with np.load(REFERENCE_RWKV_NPZ) as z:
        ref = {k: z[k] for k in z.files}
    params = tree_from_numpy({k.split("/", 1)[1]: v for k, v in ref.items()
                              if k.startswith("params/")}, device=DEV)
    rows = []
    for path, chunk in (("scan", 0), ("chunk", 16)):
        cfg = get_smoke_config(ZOO_ARCH).replace(rwkv_chunk=chunk)
        model = build_model(cfg)
        r = {k.split("/", 1)[1]: v for k, v in ref.items()
             if k.startswith(path + "/")}
        tokens = torch.from_numpy(r["tokens"]).to(DEV)
        labels = torch.from_numpy(r["labels"]).to(DEV)
        with torch.no_grad():
            hidden = rwkv.rwkv_forward(params, tokens, cfg)
            got = {"logits": torch.einsum("bsd,dv->bsv", hidden,
                                          params["head"]),
                   "loss": model.loss(params, {"tokens": tokens,
                                               "labels": labels})}
            logits, cache = model.prefill(params, {"tokens": tokens})
            got["prefill_logits"] = logits
            for field in cache._fields:
                got[f"cache_{field}"] = getattr(cache, field)
            dec = []
            for fed in r["decode_tokens"]:
                logits, cache = model.decode_step(
                    params, cache, torch.from_numpy(fed).to(DEV))
                dec.append(logits)
            got["decode_logits"] = torch.stack(dec)
        for name, value in got.items():
            want = r[name]
            err = float(np.abs(value.detach().cpu().numpy().astype(
                np.float64) - want).max())
            tol = ZOO_REFERENCE_TOL * float(np.abs(want).max())
            row = {"path": path, "output": name, "max_abs_err": err,
                   "tol": tol}
            rows.append(row)
            check(value.shape == want.shape and err <= tol,
                  f"zoo: the smoke config against reference_rwkv.npz: "
                  f"{row}")
    return rows


def zoo_train() -> dict:
    """launch.train at the published config (bf16 parameters, remat on),
    AdamW, batch 8 x 64; the checkpoint it writes restored bit for bit."""
    shutil.rmtree(ZOO_CKPT_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    res, printed = quiet(lm_train.main, ZOO_TRAIN + ["--ckpt-dir",
                                                     str(ZOO_CKPT_DIR)])
    out = {"steps": ZOO_TRAIN_STEPS, "batch": 8, "seq": 64,
           "optimizer": "adamw", "remat": get_config(ZOO_ARCH).remat,
           "losses": res.losses, "first_step_ms": res.first_step_ms,
           "ms_per_step": res.ms_per_step,
           "tokens_per_s": 8 * 64 / (res.ms_per_step / 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "printed": printed}
    check(len(res.losses) == ZOO_TRAIN_STEPS
          and all(np.isfinite(res.losses)), f"zoo train: losses {res.losses}")
    state = res.state
    del res
    t0 = time.perf_counter()
    restored = CheckpointManager(str(ZOO_CKPT_DIR)).restore(state)
    torch.cuda.synchronize()
    saved, back = tree_leaves(state.params) + tree_leaves(state.opt_state), \
        tree_leaves(restored.params) + tree_leaves(restored.opt_state)
    bf16 = [a for a in saved if a.dtype == torch.bfloat16]
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(saved, back)) and torch.equal(state.step,
                                                            restored.step)
    out["checkpoint"] = {
        "bytes": sum(f.stat().st_size for f in ZOO_CKPT_DIR.rglob("*")
                     if f.is_file()),
        "restore_seconds": time.perf_counter() - t0, "leaves": len(saved),
        "bf16_leaves": len(bf16), "restored_bit_for_bit": same,
        "step": int(restored.step)}
    check(same and len(saved) == len(back) and bf16,
          f"zoo: the checkpoint did not restore bit for bit: "
          f"{out['checkpoint']}")
    del state, restored, saved, back, bf16
    shutil.rmtree(ZOO_CKPT_DIR, ignore_errors=True)
    return out


def zoo_freeze_thaw() -> dict:
    """The port's AutoML example on the card: 8 reduced RWKV runs under the
    freeze-thaw scheduler, its refits on the routed cuda engine."""
    reset_launch_counts()
    res = automl_example.run_pool(device=DEV, gp_backend="cuda")
    launches = launch_counts()
    out = {k: res[k] for k in ("stop_events", "epochs_spent", "full_budget",
                               "survivors", "best_cfg", "observed_best",
                               "seconds", "train_seconds", "gp_seconds",
                               "train_steps")}
    out["launches"] = launches
    check(res["best_cfg"] in res["survivors"],
          f"zoo: the scheduler stopped the best config {res['best_cfg']}")
    check(res["epochs_spent"] < res["full_budget"],
          "zoo: no budget was saved")
    check(sum(launches[k] for k in ("lk_mvm_fused", "lk_mvm_stage_right",
                                    "lk_mvm_stage_left")) > 0,
          f"zoo: the refits launched no MVM kernel: {launches}")
    return out


def phase_zoo() -> dict:
    """The LM zoo's RWKV-6 at full width (serve, consistency, train), the
    smoke config against the reference, then freeze-thaw over real runs
    (its MVM launches in ``out["freeze_thaw"]["launches"]``)."""
    t_phase = time.perf_counter()
    out = {"phase": "zoo", "arch": ZOO_ARCH,
           "allocated_at_start_bytes": start_memory()}
    for part, fn in (("serve", zoo_serve), ("consistency", zoo_consistency),
                     ("reference", zoo_reference_rows), ("train", zoo_train)):
        t0 = time.perf_counter()
        out[part] = fn()
        if isinstance(out[part], dict):
            out[part]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["freeze_thaw"] = zoo_freeze_thaw()
    out["freeze_thaw"]["phase_seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    return out


# The decoder phase: the LM zoo's decoder family (dense, VLM prefix, MoE) in
# bf16, at published width. The three dense configs and the VLM fit one H100
# whole and are served through launch/serve.py; qwen2_72b, qwen3_moe_235b and
# arctic_480b do not (143, 469 and 953 GB in bf16) and are served at full
# width with their depth cut (DECODER_CUT: the layers kept). Its bands,
# fixed before the first run on the card:
DECODER_SERVE = {   # arch: (batch, prompt_len, gen)
    "stablelm_12b": (8, 128, 32), "nemotron4_15b": (8, 128, 32),
    "phi3_medium_14b": (8, 128, 32),
    # 2880 patch tokens + 192 text tokens = 3072: the chunked attention
    "llava_next_mistral_7b": (4, 192, 32)}
DECODER_CUT = {"qwen2_72b": 8, "qwen3_moe_235b": 4, "arctic_480b": 1}
DECODER_CUT_SERVE = (8, 128, 32)
# prefill(S) + one decode step against prefill(S + 1) at 2 layers, float32:
# max |difference| over max|logit|. The MoE runs at capacity_factor
# E / top_k, where no token is dropped: at 1.25 a longer prefill drops late
# tokens that a one-token decode step keeps (the reference's own behaviour;
# tests/test_torch_decoder.py).
DECODER_CONSISTENCY = dict(archs=("stablelm_12b", "qwen3_moe_235b"),
                           layers=2, batch=2, seq=64)
DECODER_CONSISTENCY_TOL = 2e-3
# _chunked_attention against _plain_attention on the model's own layer-0
# q, k, v (stablelm_12b, float32, S = 2048): the reference's band
# (tests/test_substrate.py: atol 2e-5), times max(1, max|plain|).
DECODER_ATTN_SEQ = 2048
DECODER_ATTN_TOL = 2e-5
# bf16 against float32 logits of the same parameters: max error over
# max|logit|.
DECODER_BF16_BAND = 0.1
# moe_ffn at capacity_factor 8.0 (dropless: 16 groups of 8 tokens, C = 8)
# against each token's top-k experts computed densely: the reference's
# band (tests/test_models_smoke.py: rtol = atol = 2e-4), element by element.
DECODER_MOE_DENSE_TOL = 2e-4
# The smoke configs against the reference's outputs: times max|reference|.
DECODER_REFERENCE_TOL = 1e-4
REFERENCE_DECODER_NPZ = (Path(__file__).resolve().parent / "tests"
                         / "fixtures" / "reference_decoder.npz")
# Train: make_train_step with AdamW in place (donate=True), batch 8 x 64,
# at a peak lr of 3e-5, a hundredth of launch.train's 3e-3 (which made the
# RWKV losses rise at full width; so did 3e-4 here: AdamW's first steps move
# every weight by about the lr, and at d_model 4096-5120 that is a large
# change of each layer's output).
DECODER_TRAIN = {"stablelm_12b": 4, "qwen3_moe_235b": 2}   # layers kept
DECODER_TRAIN_STEPS = 4
DECODER_TRAIN_OPT = OptConfig(name="adamw", peak_lr=3e-5, warmup_steps=2,
                              decay_steps=DECODER_TRAIN_STEPS)


def attention_path(cfg, seq: int) -> str:
    """Which path ``layers.attention`` takes for a prefill of ``seq``."""
    chunked = seq > max(cfg.q_chunk, 1024) and not seq % cfg.q_chunk \
        and not seq % cfg.kv_chunk
    return "chunked" if chunked else "plain"


def decoder_serve_row(arch: str, layers: int | None = None) -> dict:
    """Serve ``arch`` in bf16 at published width: through launch/serve.py
    when it fits whole (``layers`` None), else ``serve_lm`` on the config
    with ``layers`` layers. First the parameters alone (their peak memory:
    the bf16 tree plus the largest leaf's float32 draw), then a 2-token
    warm-up call, then the timed call."""
    batch, prompt, gen = DECODER_SERVE.get(arch, DECODER_CUT_SERVE)
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    n_params = count_params(cfg)
    weight_bytes = n_params * torch.finfo(cfg.dtype_param).bits // 8
    start = start_memory()
    params = build_model(cfg).init(
        torch.Generator(device=DEV).manual_seed(SEED))
    init_peak = torch.cuda.max_memory_allocated() - start
    del params
    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt), "--gen"]
    if layers is None:
        def run(g):
            return quiet(lm_serve.main, argv + [str(g)])
    else:
        def run(g):
            return lm_serve.serve_lm(cfg, batch, prompt, g, SEED), []
    warm, _ = run(2)
    start_memory()
    res, printed = run(gen)
    check(res.tokens.shape == (batch, gen) and (res.tokens >= 0).all()
          and (res.tokens < cfg.vocab_size).all(),
          f"decoder serve {arch}: generated tokens {res.tokens.shape}")
    bound_ms = weight_bytes / PEAK_BYTES_PER_S * 1e3
    num_patch = cfg.num_patch_tokens
    return {"arch": arch, "layers": cfg.num_layers,
            "published_layers": get_config(arch).num_layers,
            "dtype": str(cfg.dtype_param), "params": n_params,
            "weight_bytes": weight_bytes, "batch": batch,
            "prompt_len": prompt, "patch_tokens": num_patch, "gen": gen,
            "prefill_attention": attention_path(cfg, prompt + num_patch),
            "prefill_ms": res.prefill_ms,
            "prefill_ms_first_call": warm.prefill_ms,
            "decode_ms_per_token": res.decode_ms_per_token,
            "tokens_per_s": res.tokens_per_s,
            "decode_bound_ms": bound_ms, "bound_by": "bytes",
            "decode_bound_share": bound_ms / res.decode_ms_per_token,
            "init_peak_bytes": init_peak,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "printed": printed}


def decoder_consistency() -> dict:
    """Float32 at published width and 2 layers (TF32 off): prefill(S) +
    decode against prefill(S + 1); bf16 against float32 logits of the same
    parameters; the chunked attention against the plain one on stablelm's
    layer-0 q, k, v; moe_ffn against a dense per-token computation, its
    routing ties and two bf16 runs bit for bit."""
    out = {"matmul": check_full_f32_matmuls("decoder"), "models": []}
    B, S = DECODER_CONSISTENCY["batch"], DECODER_CONSISTENCY["seq"]
    for arch in DECODER_CONSISTENCY["archs"]:
        base = get_config(arch)
        over = ({"capacity_factor": base.num_experts / base.moe_top_k}
                if base.moe else {})
        cfg = base.replace(num_layers=DECODER_CONSISTENCY["layers"],
                           dtype_act=torch.float32,
                           dtype_param=torch.float32, **over)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
        tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                               dtype=torch.int32, device=DEV,
                               generator=torch.Generator(
                                   device=DEV).manual_seed(SEED + 1))
        with torch.no_grad():
            logits_s, cache = model.prefill(params, {"tokens": tokens[:, :S]},
                                            S + 1)
            logits_a, _ = model.decode_step(params, cache, tokens[:, S:])
            logits_b, _ = model.prefill(params, {"tokens": tokens}, S + 1)
        scale = float(logits_b.abs().max())
        row = {"arch": arch, "layers": cfg.num_layers, "S": S, **over,
               "prefill_decode": {
                   "max_abs_err": float((logits_a - logits_b).abs().max()),
                   "max_abs_logit": scale, "tol": DECODER_CONSISTENCY_TOL}}
        row["prefill_decode"]["relative"] =             row["prefill_decode"]["max_abs_err"] / scale
        check(row["prefill_decode"]["relative"] <= DECODER_CONSISTENCY_TOL
              and bool(torch.isfinite(logits_b).all()),
              f"decoder: prefill + decode against a longer prefill: {row}")
        if arch == "stablelm_12b":
            row["attention"] = attention_paths_row(params, cfg)
        if base.moe:
            row["moe"] = moe_rows(params, cfg)
        # bf16 logits of the same parameters
        params16 = tree_map(lambda p: p.to(base.dtype_param), params)
        del params
        with torch.no_grad():
            logits16, _ = build_model(base.replace(
                num_layers=cfg.num_layers, **over)).prefill(
                    params16, {"tokens": tokens[:, :S]}, S)
        gap = float((logits16.float() - logits_s).abs().max())
        scale = float(logits_s.abs().max())
        row["bf16_vs_float32"] = {"max_abs_err": gap, "max_abs_logit": scale,
                                  "relative": gap / scale,
                                  "band": DECODER_BF16_BAND}
        check(gap / scale <= DECODER_BF16_BAND, f"decoder: bf16 logits "
              f"against float32: {row['bf16_vs_float32']}")
        if base.moe:
            row["moe"]["bf16_two_runs_bitwise"] = moe_bits(params16, base)
        del params16, cache
        gc.collect()
        torch.cuda.empty_cache()
        out["models"].append(row)
    return out


def attention_paths_row(params, cfg) -> dict:
    """The chunked attention against the plain one on the model's own
    layer-0 q, k, v at S = DECODER_ATTN_SEQ (batch 2, float32)."""
    S = DECODER_ATTN_SEQ
    tokens = torch.randint(0, cfg.vocab_size, (2, S), dtype=torch.int32,
                           device=DEV, generator=torch.Generator(
                               device=DEV).manual_seed(SEED + 3))
    with torch.no_grad():
        x = transformer._embed(params, tokens, cfg)
        cos, sin = rope(torch.arange(S, device=DEV), cfg.head_dim,
                        cfg.rope_theta)
        q, k, v = transformer._qkv_rope(
            x, transformer._layer(params["layers"], 0), cfg, cos, sin)
        plain = layers_mod._plain_attention(q, k, v, True, None, 0)
        chunked = layers_mod._chunked_attention(q, k, v, True, None,
                                                cfg.q_chunk, cfg.kv_chunk)
    err = float((chunked - plain).abs().max())
    tol = DECODER_ATTN_TOL * max(1.0, float(plain.abs().max()))
    row = {"S": S, "head_dim": cfg.head_dim, "q_chunk": cfg.q_chunk,
           "kv_chunk": cfg.kv_chunk, "max_abs_err": err, "tol": tol,
           "dispatch": attention_path(cfg, S)}
    check(err <= tol, f"decoder: chunked against plain attention: {row}")
    return row


def moe_rows(params, cfg) -> dict:
    """moe_ffn (float32, layer 0, 2 x 64 tokens) at capacity_factor 8.0
    against each token's top-k experts computed densely, one expert at a
    time; and a zero router's ties: experts 0..K-1 for every token."""
    lp = transformer._layer(params["layers"], 0)["moe"]
    mcfg = cfg.replace(capacity_factor=8.0)
    x = torch.randn((2, 64, cfg.d_model), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(SEED))
    T = x.shape[0] * x.shape[1]
    G = moe.moe_groups(T, mcfg.num_moe_groups)
    C = moe.moe_capacity(T // G, mcfg.num_experts, mcfg.moe_top_k,
                         mcfg.capacity_factor)
    check(C >= T // G, f"decoder: the dense check needs a dropless dispatch "
          f"(C {C}, {T // G} tokens a group)")
    with torch.no_grad():
        got = moe.moe_ffn(x, lp, mcfg, mcfg.num_moe_groups)
        xf = x.reshape(T, -1)
        probs = torch.softmax(xf @ lp["router"], dim=-1)
        top_p, top_e = moe._top_k(probs, mcfg.moe_top_k)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        want = torch.zeros_like(xf)
        for e in range(mcfg.num_experts):
            tok, j = torch.nonzero(top_e == e, as_tuple=True)
            if tok.numel():
                xe = xf[tok]
                h = F.silu(xe @ lp["wi_0"][e]) * (xe @ lp["wi_1"][e])
                want.index_add_(0, tok, top_p[tok, j, None]
                                * (h @ lp["wo"][e]))
        want = want.reshape(x.shape)
        zero = torch.softmax(torch.zeros((4, mcfg.num_experts), device=DEV),
                             -1)
        _, tied = moe._top_k(zero, mcfg.moe_top_k)
    excess = elementwise_excess(got, want, DECODER_MOE_DENSE_TOL)
    row = {"capacity_factor": 8.0, "groups": G, "capacity": C,
           "max_abs_err": float((got - want).abs().max()),
           "max_abs": float(want.abs().max()), "excess_over_rtol": excess,
           "tol": DECODER_MOE_DENSE_TOL,
           "zero_router_experts": tied[0].tolist()}
    check(excess <= DECODER_MOE_DENSE_TOL, f"decoder: moe_ffn against a "
          f"dense per-token computation: {row}")
    check(bool((tied == torch.arange(mcfg.moe_top_k, device=DEV)).all()),
          f"decoder: a zero router's ties went to {tied.tolist()}")
    return row


def moe_bits(params16, base) -> bool:
    """moe_ffn in bf16 at published width (layer 0, batch 8 x 128 tokens,
    capacity_factor 1.25 as published) twice: the same bits."""
    lp = transformer._layer(params16["layers"], 0)["moe"]
    x = torch.randn((8, 128, base.d_model), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(
                        SEED)).to(torch.bfloat16)
    with torch.no_grad():
        a = moe.moe_ffn(x, lp, base, base.num_moe_groups)
        b = moe.moe_ffn(x, lp, base, base.num_moe_groups)
    same = bool(torch.equal(a, b))
    check(same and bool(torch.isfinite(a.float()).all()),
          "decoder: two bf16 moe_ffn runs differ")
    return same


def decoder_reference_rows() -> list[dict]:
    """The seven smoke configs on the card against the reference's outputs
    in ``reference_decoder.npz`` (no JAX): the forward's hidden states, the
    loss, the prefill's logits and cache, three decode steps."""
    with np.load(REFERENCE_DECODER_NPZ) as z:
        ref = {k: z[k] for k in z.files}
    rows = []
    for arch in sorted({k.split("/", 1)[0] for k in ref}):
        sub = {k.split("/", 1)[1]: v for k, v in ref.items()
               if k.startswith(arch + "/")}
        params = tree_from_numpy({k.split("/", 1)[1]: v
                                  for k, v in sub.items()
                                  if k.startswith("params/")}, device=DEV)
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        data = {k: torch.from_numpy(sub[k]).to(DEV)
                for k in ("tokens", "labels", "prefix_embeds") if k in sub}
        prompt = {k: v for k, v in data.items() if k != "labels"}
        with torch.no_grad():
            got = {"hidden": transformer.decoder_forward(
                       params, data["tokens"], cfg,
                       prefix_embeds=data.get("prefix_embeds")),
                   "loss": model.loss(params, data)}
            logits, cache = model.prefill(params, prompt,
                                          sub["cache_k"].shape[2])
            got.update(prefill_logits=logits, cache_k=cache.k,
                       cache_v=cache.v, cache_length=cache.length)
            dec = []
            for fed in sub["decode_tokens"]:
                logits, cache = model.decode_step(
                    params, cache, torch.from_numpy(fed).to(DEV))
                dec.append(logits)
            got["decode_logits"] = torch.stack(dec)
        for name, value in got.items():
            want = sub[name]
            err = float(np.abs(value.detach().cpu().numpy().astype(
                np.float64) - want).max())
            tol = DECODER_REFERENCE_TOL * max(float(np.abs(want).max()),
                                              1e-30)
            row = {"arch": arch, "output": name, "max_abs_err": err,
                   "tol": tol}
            rows.append(row)
            check(tuple(value.shape) == want.shape and err <= tol,
                  f"decoder: the smoke config against "
                  f"reference_decoder.npz: {row}")
    return rows


def decoder_train_row(arch: str, layers: int) -> dict:
    """``make_train_step`` (AdamW in place) on ``arch`` at published width
    and ``layers`` layers, bf16 parameters, remat on: 4 steps at 8 x 64."""
    cfg = get_config(arch).replace(num_layers=layers)
    start = start_memory()
    setup = make_train_step(build_model(cfg), opt_cfg=DECODER_TRAIN_OPT,
                            device=DEV, donate=True)
    state = setup.init_state(SEED)
    pipe = TokenPipeline(cfg.vocab_size, 8, 64)
    losses, times = [], []
    for step in range(DECODER_TRAIN_STEPS):
        tokens, labels = pipe.batch_at(step)
        batch = {"tokens": torch.from_numpy(tokens).to(DEV),
                 "labels": torch.from_numpy(labels).to(DEV)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = setup.step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    row = {"arch": arch, "layers": layers, "params": count_params(cfg),
           "batch": 8, "seq": 64, "optimizer": "adamw (donated)",
           "peak_lr": DECODER_TRAIN_OPT.peak_lr, "remat": cfg.remat,
           "losses": losses, "first_step_ms": times[0],
           "ms_per_step": statistics.mean(times[1:]),
           "allocated_at_start_bytes": start,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    row["tokens_per_s"] = 8 * 64 / (row["ms_per_step"] / 1e3)
    check(len(losses) == DECODER_TRAIN_STEPS and all(np.isfinite(losses)),
          f"decoder train {arch}: losses {losses}")
    del state, setup, metrics
    return row


def timed_row(fn, *args):
    """``fn(*args)`` with its seconds, then the memory it left freed."""
    t0 = time.perf_counter()
    row = fn(*args)
    if isinstance(row, dict):
        row["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_decoder() -> dict:
    """The decoder family at published width: the three dense configs and
    the VLM served whole, qwen2_72b / qwen3_moe_235b / arctic_480b at a depth
    cut; the float32 checks; the smoke configs against the reference; the
    train steps."""
    t_phase = time.perf_counter()
    out = {"phase": "decoder", "allocated_at_start_bytes": start_memory(),
           "serve": [], "train": []}
    for arch in DECODER_SERVE:
        out["serve"].append(timed_row(decoder_serve_row, arch))
    for arch, layers in DECODER_CUT.items():
        out["serve"].append(timed_row(decoder_serve_row, arch, layers))
    out["consistency"] = timed_row(decoder_consistency)
    out["reference"] = timed_row(decoder_reference_rows)
    for arch, layers in DECODER_TRAIN.items():
        out["train"].append(timed_row(decoder_train_row, arch, layers))
    out["seconds"] = time.perf_counter() - t_phase
    return out


# The griffin phase: the LM zoo's Griffin hybrid (recurrentgemma_2b, 3.42 B
# table parameters: every layer holds both branches) whole at published
# width in bf16. Served through launch/serve.py twice: a prompt of 3072
# runs past the 2048 window (the buffer wraps) and takes the chunked
# attention with the window (3072 divides into the 512 / 1024 chunks); a
# prompt of 1024 takes the plain path and leaves the window part-filled.
# Its bands, fixed before the first run on the card:
GRIFFIN_ARCH = "recurrentgemma_2b"
GRIFFIN_SERVE = ((8, 3072, 32), (8, 1024, 32))   # (batch, prompt, gen)
# Float32 at published width, 3 layers (rec, rec, attn), batch 2:
# prefill(S) + k decode steps against prefill(S + k), elementwise within the
# reference's band (rtol = atol = 2e-3); (2046, 4) crosses the window.
GRIFFIN_CONSISTENCY = dict(layers=3, batch=2, cases=((3072, 1), (2046, 4)))
GRIFFIN_CONSISTENCY_TOL = 2e-3
# The doubling scan and the sequential loop (float32) against the loop in
# float64 at (2, 3072, 2560), on the model's own layer-0 gates and on gates
# near 1 (1 - a down to 1e-4, the long memory of a trained RG-LRU, where every
# doubling offset up to 2048 counts): max |difference| over max|h|.
GRIFFIN_SCAN_SEQ = 3072
GRIFFIN_SCAN_TOL = 1e-5
# The chunked windowed attention against the plain one on the model's own
# attention-layer q, k, v (10 q heads, 1 kv head, Dh 256) at S = 4096,
# window 2048, batch 1: the reference's band, times max(1, max|plain|).
GRIFFIN_ATTN_SEQ = 4096
GRIFFIN_ATTN_TOL = 2e-5
GRIFFIN_BF16_BAND = 0.1
# The smoke config against the reference's outputs: times max|reference|.
GRIFFIN_REFERENCE_TOL = 1e-4
REFERENCE_GRIFFIN_NPZ = (Path(__file__).resolve().parent / "tests"
                         / "fixtures" / "reference_griffin.npz")
# Train: 4 donated AdamW steps of the whole model through launch/train.py
# at 8 x 64, lr 3e-5 (3e-4 made the decoder's losses rise at full width).
LM_TRAIN_STEPS = 4
LM_TRAIN_ARGS = ["--steps", str(LM_TRAIN_STEPS), "--batch", "8", "--seq",
                 "64", "--lr", "3e-5", "--log-every", "100"]
# The encdec phase: whisper_tiny whole (4 + 4 layers, 49.06 M table
# parameters, 32768 rows of dec_pos) at published width in bf16, served
# through launch/serve.py at batch 16 x (1500 zero frames, prompt 32) + 64
# tokens: the encoder's 1500 frames take the plain attention (1500 is not a
# multiple of 512). Float32 checks whole, on standard normal frames.
ENCDEC_ARCH = "whisper_tiny"
ENCDEC_SERVE = (16, 32, 64)
ENCDEC_CONSISTENCY = dict(batch=2, seq=32, steps=3)
ENCDEC_CONSISTENCY_TOL = 2e-3
ENCDEC_BF16_BAND = 0.1
ENCDEC_REFERENCE_TOL = 1e-4
REFERENCE_ENCDEC_NPZ = (Path(__file__).resolve().parent / "tests"
                        / "fixtures" / "reference_encdec.npz")


def tensor_bytes(tree) -> int:
    leaves = tree_leaves(tree) if isinstance(tree, dict) else [
        t for t in tree if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in leaves)


def table_bytes(table: dict, names, dtype) -> int:
    """Bytes of the table's entries ``names`` stored in ``dtype``."""
    size = torch.finfo(dtype).bits // 8
    return sum(math.prod(table[n][0]) for n in names) * size


def griffin_decode_bytes(cfg, batch: int) -> dict:
    """What one decode step reads: each layer's branch (18 rec, 8 attn for
    the published config) and its MLP, the tied embedding once for the
    logits, the final norm, and the cache state the layers read (the
    attention layers' window K, V and positions, the recurrent layers' h
    and conv tail). Per layer, a slice of the stacked leaf."""
    table = griffin.griffin_param_table(cfg)
    L = cfg.num_layers
    size = torch.finfo(cfg.dtype_param).bits // 8
    per_layer = {n: math.prod(s[1:]) * size for n, (s, _, _) in table.items()
                 if n.startswith("layers/")}
    attn = [li for li in range(L) if griffin._is_attn(cfg, li)]
    rec = [li for li in range(L) if li not in attn]

    def branch(prefix):
        return sum(b for n, b in per_layer.items()
                   if n.startswith(f"layers/{prefix}"))
    act = torch.finfo(cfg.dtype_act).bits // 8
    W, Hkv, Dh, R = cfg.window, cfg.num_kv_heads, cfg.head_dim, cfg.rnn_width
    out = {"rec_branches": len(rec) * branch("rec/"),
           "attn_branches": len(attn) * branch("attn/"),
           "mlps": L * (branch("mlp/") + branch("mlp_ln")),
           "embed_and_final_norm": table_bytes(table, ("embed",
                                                       "final_norm"),
                                               cfg.dtype_param),
           "window_kv": len(attn) * 2 * batch * W * Hkv * Dh * act,
           "window_pos": len(attn) * batch * W * 4,
           "recurrent_state": len(rec) * batch * R * (
               4 + (cfg.conv_width - 1) * act)}
    out["total"] = sum(out.values())
    out["layers"] = {"rec": len(rec), "attn": len(attn)}
    return out


def encdec_decode_bytes(cfg, batch: int, max_len: int) -> dict:
    """What one decode step reads: the decoder's weights but the cross
    attention's K / V projections (the cross cache holds their output), one
    row of dec_pos, the tied embedding once, the self-attention cache of
    ``max_len`` positions and the cross K / V cache over all frames."""
    table = encdec.encdec_param_table(cfg)
    skip = ("dec_layers/xattn/wk", "dec_layers/xattn/wv",
            "dec_layers/xattn/bv")
    names = [n for n in table if (n.startswith("dec_layers/")
                                  and n not in skip)
             or n in ("embed", "dec_ln", "dec_ln_b")]
    act = torch.finfo(cfg.dtype_act).bits // 8
    kv = cfg.num_layers * 2 * batch * cfg.num_heads * cfg.head_dim * act
    out = {"decoder_weights": table_bytes(
               table, [n for n in names if n != "embed"], cfg.dtype_param)
           + cfg.d_model * torch.finfo(cfg.dtype_param).bits // 8,
           "embed": table_bytes(table, ["embed"], cfg.dtype_param),
           "self_kv_cache": kv * max_len,
           "cross_kv_cache": kv * cfg.enc_frames}
    out["total"] = sum(out.values())
    return out


def lm_serve_row(arch: str, batch: int, prompt: int, gen: int,
                 decode_bytes: dict, cache) -> dict:
    """``arch`` whole in bf16 through launch/serve.py: the parameters alone
    first (their init peak), then a 2-token warm-up call, then the timed
    call. ``cache`` is the served cache's layout (meta tensors)."""
    cfg = get_config(arch)
    n_params = count_params(cfg)
    start = start_memory()
    params = build_model(cfg).init(
        torch.Generator(device=DEV).manual_seed(SEED))
    init_peak = torch.cuda.max_memory_allocated() - start
    del params
    start_memory()
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt), "--gen"]
    warm, _ = quiet(lm_serve.main, argv + ["2"])
    start_memory()
    res, printed = quiet(lm_serve.main, argv + [str(gen)])
    check(res.tokens.shape == (batch, gen) and (res.tokens >= 0).all()
          and (res.tokens < cfg.vocab_size).all(),
          f"{arch} serve: generated tokens {res.tokens.shape}")
    bound_ms = decode_bytes["total"] / PEAK_BYTES_PER_S * 1e3
    return {"arch": arch, "layers": cfg.num_layers,
            "dtype": str(cfg.dtype_param), "params": n_params,
            "weight_bytes": n_params * torch.finfo(
                cfg.dtype_param).bits // 8,
            "batch": batch, "prompt_len": prompt, "gen": gen,
            "prefill_attention": attention_path(cfg, prompt),
            "cache_bytes": tensor_bytes(cache),
            "prefill_ms": res.prefill_ms,
            "prefill_ms_first_call": warm.prefill_ms,
            "decode_ms_per_token": res.decode_ms_per_token,
            "tokens_per_s": res.tokens_per_s,
            "decode_bytes": decode_bytes,
            "decode_bound_ms": bound_ms, "bound_by": "bytes",
            "decode_bound_share": bound_ms / res.decode_ms_per_token,
            "init_peak_bytes": init_peak,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "printed": printed}


def logits_gap(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """The elementwise excess over rtol = atol = tol (<= tol passes) and
    the largest difference beside max|want|."""
    return {"max_abs_err": float((got - want).abs().max()),
            "max_abs_logit": float(want.abs().max()),
            "excess_over_rtol": elementwise_excess(got, want, tol),
            "tol": tol}


def f32_config(arch: str, **over):
    return get_config(arch).replace(dtype_act=torch.float32,
                                    dtype_param=torch.float32, **over)


def bf16_gap(params, cfg32, cfg16, run, band: float) -> dict:
    """``run(params, cfg)`` (logits) in float32, then on the same parameters
    in bf16: max error over max|logit|."""
    with torch.no_grad():
        want = run(params, cfg32)
        got = run(tree_map(lambda p: p.to(cfg16.dtype_param), params), cfg16)
    gap = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    return {"max_abs_err": gap, "max_abs_logit": scale,
            "relative": gap / scale, "band": band}


def near_one_gates(shape) -> tuple[torch.Tensor, torch.Tensor]:
    """Gates of a trained RG-LRU, float32 on the card: a near 1, with 1 - a
    drawn per channel log-uniform in [1e-4, 1e-1] and jittered per step, so
    the slowest channels keep most of what they held 2048 steps back; b =
    sqrt(1 - a^2) x, as ``_rglru_gates`` builds it."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    B, S, R = shape
    rate = 10.0 ** (-4 + 3 * torch.rand((1, 1, R), dtype=torch.float64,
                                        device=DEV, generator=gen))
    a = 1 - rate * (0.5 + torch.rand(shape, dtype=torch.float64, device=DEV,
                                     generator=gen))
    x = torch.randn(shape, dtype=torch.float64, device=DEV, generator=gen)
    return a.float(), (torch.sqrt(1 - a * a) * x).float()


def griffin_scan_row(what: str, a: torch.Tensor, b: torch.Tensor,
                     long_range: bool = False) -> dict:
    """The doubling scan and the sequential loop on float32 gates (B, S, R),
    timed, both against the loop in float64 on the same gates within
    ``GRIFFIN_SCAN_TOL`` of max|h|. ``tail_effect`` (S > 2048) is how far h
    moves past step 2048 when what came before is dropped; with
    ``long_range`` it must exceed 1e3 tolerances, so that a fault at any
    offset up to 2048 shows."""
    S = a.shape[1]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan = griffin._doubling_scan(a, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loop = griffin._rglru_loop(a, b)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want = griffin._rglru_loop(a.double(), b.double())
        tail = None
        if S > 2048:
            cut = griffin._rglru_loop(a[:, 2048:].double(),
                                      b[:, 2048:].double())
            tail = float((cut - want[:, 2048:]).abs().max())
    tol = GRIFFIN_SCAN_TOL * float(want.abs().max())
    row = {"gates": what, "shape": list(a.shape),
           "max_abs_h": float(want.abs().max()),
           "max_abs_err": float((scan.double() - want).abs().max()),
           "loop_max_abs_err": float((loop.double() - want).abs().max()),
           "tail_effect": tail,
           "tol": tol, "doubling_steps": math.ceil(math.log2(S)),
           "doubling_ms": (t1 - t0) * 1e3, "loop_ms": (t2 - t1) * 1e3}
    check(row["max_abs_err"] <= tol and row["loop_max_abs_err"] <= tol,
          f"griffin: the doubling scan against the loop: {row}")
    if long_range and tail is not None:
        check(tail > 1e3 * tol, f"griffin: gates near 1 that forget what "
              f"came 2048 steps back: {row}")
    return row


def griffin_consistency() -> dict:
    """Float32 at published width, 3 layers (TF32 off): prefill + decode
    against a longer prefill (once across the window); the doubling scan
    against the loop on the model's own gates and on gates near 1; the
    chunked windowed attention against the plain one; bf16 against float32
    logits."""
    out = {"matmul": check_full_f32_matmuls("griffin"), "prefill_decode": []}
    spec = GRIFFIN_CONSISTENCY
    cfg = f32_config(GRIFFIN_ARCH, num_layers=spec["layers"])
    check([griffin._is_attn(cfg, li) for li in range(cfg.num_layers)]
          == [False, False, True], "griffin: the 3 layers are not rec, rec, "
          "attn")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    B = spec["batch"]
    longest = max(s + k for s, k in spec["cases"])
    tokens = torch.randint(0, cfg.vocab_size, (B, longest),
                           dtype=torch.int32, device=DEV,
                           generator=torch.Generator(
                               device=DEV).manual_seed(SEED + 1))
    for S, steps in spec["cases"]:
        with torch.no_grad():
            a, cache = model.prefill(params, {"tokens": tokens[:, :S]})
            for i in range(steps):
                a, cache = model.decode_step(params, cache,
                                             tokens[:, S + i:S + i + 1])
            b, full = model.prefill(params, {"tokens": tokens[:, :S + steps]})
        row = {"S": S, "steps": steps, "window": cfg.window,
               "prefill_attention": attention_path(cfg, S),
               "longer_prefill_attention": attention_path(cfg, S + steps),
               **logits_gap(a, b, GRIFFIN_CONSISTENCY_TOL),
               "positions_equal": bool(torch.equal(cache.pos, full.pos))}
        out["prefill_decode"].append(row)
        check(row["excess_over_rtol"] <= GRIFFIN_CONSISTENCY_TOL
              and row["positions_equal"]
              and bool(torch.isfinite(b).all()),
              f"griffin: prefill + decode against a longer prefill: {row}")
        del cache, full
    lp = transformer._layer(params["layers"], 0)
    S = GRIFFIN_SCAN_SEQ
    with torch.no_grad():
        x = griffin._embed(params, tokens[:, :S], cfg)
        xn = rms_norm(x, lp["rec"]["ln"], cfg.norm_eps)
        z, _ = griffin._causal_conv(xn @ lp["rec"]["wx"], lp["rec"]["conv_w"],
                                    lp["rec"]["conv_b"])
        a, b = griffin._rglru_gates(z, lp["rec"])
    del z, xn, x
    out["scan"] = griffin_scan_row("the model's gates", a, b)
    out["scan_near_one"] = griffin_scan_row("gates near 1",
                                            *near_one_gates(a.shape),
                                            long_range=True)
    del a, b
    li = [i for i in range(cfg.num_layers) if griffin._is_attn(cfg, i)][0]
    ap = transformer._layer(params["layers"], li)["attn"]
    S = GRIFFIN_ATTN_SEQ
    attn_tokens = torch.randint(0, cfg.vocab_size, (1, S), dtype=torch.int32,
                                device=DEV, generator=torch.Generator(
                                    device=DEV).manual_seed(SEED + 3))
    with torch.no_grad():
        x = rms_norm(griffin._embed(params, attn_tokens, cfg), ap["ln"],
                     cfg.norm_eps)
        cos, sin = rope(torch.arange(S, device=DEV), cfg.head_dim,
                        cfg.rope_theta)
        q, k, v = griffin._qkv(x, ap, cfg, cos, sin)
        plain = layers_mod._plain_attention(q, k, v, True, cfg.window, 0)
        chunked = layers_mod._chunked_attention(q, k, v, True, cfg.window,
                                                cfg.q_chunk, cfg.kv_chunk)
    err = float((chunked - plain).abs().max())
    tol = GRIFFIN_ATTN_TOL * max(1.0, float(plain.abs().max()))
    out["attention"] = {"S": S, "window": cfg.window,
                        "q_heads": cfg.num_heads,
                        "kv_heads": cfg.num_kv_heads,
                        "head_dim": cfg.head_dim, "max_abs_err": err,
                        "tol": tol, "dispatch": attention_path(cfg, S)}
    check(err <= tol and out["attention"]["dispatch"] == "chunked",
          f"griffin: chunked against plain windowed attention: "
          f"{out['attention']}")
    del q, k, v, plain, chunked, x
    S = spec["cases"][0][0]
    out["bf16_vs_float32"] = bf16_gap(
        params, cfg, get_config(GRIFFIN_ARCH).replace(
            num_layers=cfg.num_layers),
        lambda p, c: build_model(c).prefill(p, {"tokens": tokens[:, :S]})[0],
        GRIFFIN_BF16_BAND)
    check(out["bf16_vs_float32"]["relative"] <= GRIFFIN_BF16_BAND,
          f"griffin: bf16 logits against float32: {out['bf16_vs_float32']}")
    return out


def npz_rows(phase: str, npz: Path, got: dict, ref: dict, tol: float,
             exact=()) -> list[dict]:
    """Each output against the file's: within ``tol`` of max|reference|,
    the ``exact`` ones equal."""
    rows = []
    for name, value in got.items():
        want = ref[name]
        value = value.detach().cpu().numpy()
        err = float(np.abs(value.astype(np.float64) - want).max())
        bound = 0.0 if name in exact else tol * max(
            float(np.abs(want).max()), 1e-30)
        row = {"output": name, "max_abs_err": err, "tol": bound}
        rows.append(row)
        check(value.shape == want.shape and err <= bound,
              f"{phase}: the smoke config against {npz.name}: {row}")
    return rows


def griffin_reference_rows() -> list[dict]:
    """The smoke config on the card against ``reference_griffin.npz`` (no
    JAX): the forward, the loss, the prefill's logits and every cache
    field, three decode steps across the window and the cache after them."""
    with np.load(REFERENCE_GRIFFIN_NPZ) as z:
        ref = {k: z[k] for k in z.files}
    params = tree_from_numpy({k.split("/", 1)[1]: v for k, v in ref.items()
                              if k.startswith("params/")}, device=DEV)
    cfg = get_smoke_config(GRIFFIN_ARCH)
    model = build_model(cfg)
    data = {k: torch.from_numpy(ref[k]).to(DEV) for k in ("tokens",
                                                          "labels")}
    prompt = int(ref["cache_length"])
    fields = ("h", "conv", "k", "v", "pos", "length")
    with torch.no_grad():
        got = {"hidden": griffin.griffin_forward(params, data["tokens"], cfg),
               "loss": model.loss(params, data)}
        logits, cache = model.prefill(
            params, {"tokens": data["tokens"][:, :prompt]})
        got["prefill_logits"] = logits
        got.update({f"cache_{f}": getattr(cache, f) for f in fields})
        dec = []
        for fed in ref["decode_tokens"]:
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(fed).to(DEV))
            dec.append(logits)
        got["decode_logits"] = torch.stack(dec)
        got.update({f"final_cache_{f}": getattr(cache, f) for f in fields})
    return npz_rows("griffin", REFERENCE_GRIFFIN_NPZ, got, ref,
                    GRIFFIN_REFERENCE_TOL,
                    exact=("cache_pos", "cache_length", "final_cache_pos",
                           "final_cache_length"))


def lm_train_row(arch: str) -> dict:
    """launch/train.py on ``arch`` whole (bf16 parameters, remat on): 4
    donated AdamW steps at 8 x 64 (``LM_TRAIN_ARGS``)."""
    start = start_memory()
    res, printed = quiet(lm_train.main, ["--arch", arch] + LM_TRAIN_ARGS)
    opt = dict(zip(LM_TRAIN_ARGS[::2], LM_TRAIN_ARGS[1::2]))
    batch, seq = int(opt["--batch"]), int(opt["--seq"])
    out = {"arch": arch, "params": count_params(get_config(arch)),
           "steps": LM_TRAIN_STEPS, "batch": batch, "seq": seq,
           "optimizer": "adamw (donated)", "peak_lr": float(opt["--lr"]),
           "remat": get_config(arch).remat, "losses": res.losses,
           "first_step_ms": res.first_step_ms,
           "ms_per_step": res.ms_per_step,
           "tokens_per_s": batch * seq / (res.ms_per_step / 1e3),
           "allocated_at_start_bytes": start,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "printed": printed}
    check(len(res.losses) == LM_TRAIN_STEPS
          and all(np.isfinite(res.losses)),
          f"{arch} train: losses {res.losses}")
    return out


def phase_griffin() -> dict:
    """recurrentgemma_2b whole at published width: two serves, the float32
    checks at 3 layers, the smoke config against the reference, 4 train
    steps."""
    t_phase = time.perf_counter()
    out = {"phase": "griffin", "allocated_at_start_bytes": start_memory(),
           "serve": []}
    cfg = get_config(GRIFFIN_ARCH)
    for batch, prompt, gen in GRIFFIN_SERVE:
        cache = build_model(cfg).init_cache(batch, device="meta")
        out["serve"].append(timed_row(
            lm_serve_row, GRIFFIN_ARCH, batch, prompt, gen,
            griffin_decode_bytes(cfg, batch), cache))
    out["consistency"] = timed_row(griffin_consistency)
    out["reference"] = timed_row(griffin_reference_rows)
    out["train"] = timed_row(lm_train_row, GRIFFIN_ARCH)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def encdec_consistency() -> dict:
    """Float32 at published width, whole (TF32 off), standard normal
    frames: prefill + decode steps against a longer prefill; bf16 against
    float32 logits."""
    out = {"matmul": check_full_f32_matmuls("encdec")}
    spec = ENCDEC_CONSISTENCY
    cfg = f32_config(ENCDEC_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    B, S, steps = spec["batch"], spec["seq"], spec["steps"]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + steps),
                           dtype=torch.int32, device=DEV, generator=gen)
    frames = torch.randn((B, cfg.enc_frames, cfg.d_model), device=DEV,
                         generator=gen)
    max_len = S + steps
    with torch.no_grad():
        a, cache = model.prefill(params, {"tokens": tokens[:, :S],
                                          "frames": frames}, max_len)
        for i in range(steps):
            a, cache = model.decode_step(params, cache,
                                         tokens[:, S + i:S + i + 1])
        b, _ = model.prefill(params, {"tokens": tokens, "frames": frames},
                             max_len)
    out["prefill_decode"] = {"S": S, "steps": steps,
                             "frames": cfg.enc_frames,
                             "encoder_attention": attention_path(
                                 cfg, cfg.enc_frames),
                             **logits_gap(a, b, ENCDEC_CONSISTENCY_TOL)}
    check(out["prefill_decode"]["excess_over_rtol"] <= ENCDEC_CONSISTENCY_TOL
          and bool(torch.isfinite(b).all()),
          f"encdec: prefill + decode against a longer prefill: "
          f"{out['prefill_decode']}")
    del cache
    out["bf16_vs_float32"] = bf16_gap(
        params, cfg, get_config(ENCDEC_ARCH),
        lambda p, c: build_model(c).prefill(
            p, {"tokens": tokens[:, :S], "frames": frames}, S)[0],
        ENCDEC_BF16_BAND)
    check(out["bf16_vs_float32"]["relative"] <= ENCDEC_BF16_BAND,
          f"encdec: bf16 logits against float32: {out['bf16_vs_float32']}")
    return out


def encdec_reference_rows() -> list[dict]:
    """The smoke config on the card against ``reference_encdec.npz`` (no
    JAX; its dec_pos padded back with zero rows, which no output reads):
    the encoder, the decoder's hidden states, the loss, the prefill's
    logits and cache, three decode steps."""
    with np.load(REFERENCE_ENCDEC_NPZ) as z:
        ref = {k: z[k] for k in z.files}
    cfg = get_smoke_config(ENCDEC_ARCH)
    model = build_model(cfg)
    flat = {k.split("/", 1)[1]: v for k, v in ref.items()
            if k.startswith("params/")}
    rows = model.param_table["dec_pos"][0][0]
    flat["dec_pos"] = np.concatenate([flat["dec_pos"], np.zeros(
        (rows - flat["dec_pos"].shape[0], cfg.d_model), np.float32)])
    params = tree_from_numpy(flat, device=DEV)
    data = {k: torch.from_numpy(ref[k]).to(DEV) for k in ("frames", "tokens",
                                                          "labels")}
    with torch.no_grad():
        enc = encdec.encode(params, data["frames"], cfg)
        got = {"encoded": enc,
               "hidden": encdec.decode_train(params, enc, data["tokens"],
                                             cfg),
               "loss": model.loss(params, data)}
        logits, cache = model.prefill(
            params, {k: v for k, v in data.items() if k != "labels"},
            ref["cache_k"].shape[2])
        got["prefill_logits"] = logits
        got.update({f"cache_{f}": getattr(cache, f) for f in cache._fields})
        dec = []
        for fed in ref["decode_tokens"]:
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(fed).to(DEV))
            dec.append(logits)
        got["decode_logits"] = torch.stack(dec)
    return npz_rows("encdec", REFERENCE_ENCDEC_NPZ, got, ref,
                    ENCDEC_REFERENCE_TOL, exact=("cache_length",))


def phase_encdec() -> dict:
    """whisper_tiny whole at published width: the serve, the float32
    checks, the smoke config against the reference, 4 train steps."""
    t_phase = time.perf_counter()
    out = {"phase": "encdec", "allocated_at_start_bytes": start_memory()}
    cfg = get_config(ENCDEC_ARCH)
    batch, prompt, gen = ENCDEC_SERVE
    cache = build_model(cfg).init_cache(batch, prompt + gen, device="meta")
    out["serve"] = timed_row(
        lm_serve_row, ENCDEC_ARCH, batch, prompt, gen,
        encdec_decode_bytes(cfg, batch, prompt + gen), cache)
    out["consistency"] = timed_row(encdec_consistency)
    out["reference"] = timed_row(encdec_reference_rows)
    out["train"] = timed_row(lm_train_row, ENCDEC_ARCH)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# The sharded phase (its tolerances fixed before the first run on the card,
# PERF.md). The serve steps on a DeviceMesh (DTensor placements by
# SERVE_RULES, the prefill's 'width' cache layout) in an NCCL world of one
# rank, held to the one-device steps on the same parameters: the greedy
# tokens equal; float32 prefill + 3 decode steps within SHARDED_F32_TOL of
# max|logit| (one rank holds whole tensors, so the two paths run the same
# kernels: the band is a few float32 roundings of the logits); the smoke
# configs against the reference's .npz files in the bands of the phases that
# hold them; the expert-parallel MoE functions at published width against
# moe_ffn(num_groups=1) in float32 within SHARDED_MOE_TOL of max|out| (the
# same sums, grouped in other matmul shapes).
SHARDED_SERVE = (   # (arch, layers kept or None for whole, batch, prompt, gen)
    ("stablelm_12b", None, 8, 128, 32),
    ("qwen3_moe_235b", 4, 8, 128, 32),
    ("recurrentgemma_2b", None, 8, 1024, 32),
    ("rwkv6_1b6", None, 8, 64, 32),
    ("whisper_tiny", None, 16, 32, 64),
)
SHARDED_F32 = (("stablelm_12b", 2), ("qwen3_moe_235b", 2),
               ("recurrentgemma_2b", 3), ("rwkv6_1b6", 2),
               ("whisper_tiny", None))
SHARDED_F32_SHAPE = (2, 32, 3)          # batch, prompt, decode steps
SHARDED_F32_TOL = 1e-6
SHARDED_MOE_ARCH = "qwen3_moe_235b"
SHARDED_MOE_TOKENS = {"moe_ffn_sharded": (8, 128),
                      "moe_ffn_sharded_decode": (8, 1)}
SHARDED_MOE_TOL = 1e-5
# Bytes per rank under SERVE_RULES at (data, model), bf16, in GB (1e9 B):
# the reference resolver's numbers on the port's tables.
SHARDED_PLAN = {
    "qwen2_72b": {"whole": 142.9, (1, 4): 35.7, (1, 8): 17.9, (2, 8): 10.6},
    "qwen3_moe_235b": {"whole": 468.9, (1, 4): 117.3, (1, 8): 58.7,
                       (2, 8): 30.3},
    "arctic_480b": {"whole": 953.2, (1, 4): 238.4, (1, 8): 119.2,
                    (2, 8): 60.2},
}
SHARDED_PLAN_MESHES = ((1, 4), (1, 8), (2, 8))
SHARDED_PLAN_CACHE = (8, 2048)          # batch, positions
CARD_BYTES = 80e9                       # one H100's device memory


def sharded_serve_row(mesh, smi: str, arch: str, layers, batch: int,
                      prompt: int, gen: int) -> dict:
    """``arch`` in bf16 at published width served on the mesh (through
    launch/serve.py --mesh debug when whole, else ``serve_lm`` on the cut
    config) and on one device, from the same seed: the placed parameters
    alone first (their init peak), a 2-token warm-up call on the mesh, the
    timed mesh call, then the one-device call. The greedy tokens must be
    equal."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    model = build_model(cfg)
    start = start_memory()
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED),
                        place=param_placer(model.param_table, mesh,
                                           SERVE_RULES))
    init_peak = torch.cuda.max_memory_allocated() - start
    del params
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt), "--mesh", "debug", "--gen"]

    def on_mesh(g):
        if layers is None:
            return quiet(lm_serve.main, argv + [str(g)])[0]
        return lm_serve.serve_lm(cfg, batch, prompt, g, SEED, None, mesh)
    warm = on_mesh(2)
    start = start_memory()
    got = on_mesh(gen)
    serve_peak = torch.cuda.max_memory_allocated() - start
    start_memory()
    want = lm_serve.serve_lm(cfg, batch, prompt, gen, SEED)
    check(np.array_equal(got.tokens, want.tokens),
          f"sharded {arch}: the mesh path's greedy tokens differ from the "
          f"one-device path's")
    gap = float(np.abs(got.logits - want.logits).max())
    return {"arch": arch, "card": smi, "layers": cfg.num_layers,
            "published_layers": get_config(arch).num_layers,
            "dtype": str(cfg.dtype_param), "batch": batch,
            "prompt_len": prompt, "gen": gen,
            "mesh": {"prefill_ms": got.prefill_ms,
                     "prefill_ms_first_call": warm.prefill_ms,
                     "decode_ms_per_token": got.decode_ms_per_token,
                     "tokens_per_s": got.tokens_per_s},
            "one_device": {"prefill_ms": want.prefill_ms,
                           "decode_ms_per_token": want.decode_ms_per_token,
                           "tokens_per_s": want.tokens_per_s},
            "decode_ms_ratio": got.decode_ms_per_token
            / want.decode_ms_per_token,
            "tokens_equal": True, "last_logits_max_abs_err": gap,
            "max_abs_logit": float(np.abs(want.logits).max()),
            "bitwise_equal": bool(np.array_equal(got.logits, want.logits)),
            "init_peak_bytes": init_peak, "serve_peak_bytes": serve_peak}


def lm_inputs(cfg, batch: int, prompt: int, gen: torch.Generator) -> dict:
    """Random prompt tokens, and random frames / patch embeddings where the
    family takes them."""
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt),
                                   dtype=torch.int32, device=DEV,
                                   generator=gen)}
    if cfg.family in ("audio", "encdec"):
        out["frames"] = torch.randn((batch, cfg.enc_frames, cfg.d_model),
                                   device=DEV, generator=gen)
    if cfg.family == "vlm":
        out["prefix_embeds"] = torch.randn(
            (batch, cfg.num_patch_tokens, cfg.d_model), device=DEV,
            generator=gen)
    return out


def sharded_f32_row(mesh, arch: str, layers) -> dict:
    """Float32 at published width (``layers`` kept, whole when None): the
    mesh path's prefill and decode steps against the one-device path's on
    the same parameters (placed without a copy: one rank holds whole
    leaves), the one-device greedy tokens fed to both."""
    over = {} if layers is None else {"num_layers": layers}
    cfg = f32_config(arch, **over)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    placed = shard_params(params, mesh, SERVE_RULES, model.logical)
    batch, prompt, steps = SHARDED_F32_SHAPE
    inputs = lm_inputs(cfg, batch, prompt,
                       torch.Generator(device=DEV).manual_seed(SEED + 1))
    max_len = prompt + steps + (cfg.num_patch_tokens or 0)
    one = make_serve_steps(model, max_len, DEV)
    on_mesh = make_serve_steps(model, max_len, DEV, mesh=mesh)
    want, cache = one["prefill"](params, inputs)
    got, mcache = on_mesh["prefill"](placed, inputs)
    pairs = [(full_value(got), want)]
    for _ in range(steps):
        tok = torch.argmax(want, -1)[:, None].to(torch.int32)
        want, cache = one["decode_step"](params, cache, tok)
        got, mcache = on_mesh["decode_step"](placed, mcache, tok)
        pairs.append((full_value(got), want))
    scale = max(float(w.abs().max()) for _, w in pairs)
    err = max(float((g - w).abs().max()) for g, w in pairs)
    row = {"arch": arch, "layers": cfg.num_layers, "batch": batch,
           "prompt_len": prompt, "decode_steps": steps,
           "max_abs_err": err, "max_abs_logit": scale,
           "relative": err / scale, "tol": SHARDED_F32_TOL,
           "bitwise_equal": all(torch.equal(g, w) for g, w in pairs)}
    check(err <= SHARDED_F32_TOL * scale,
          f"sharded: float32 mesh path against one device: {row}")
    return row


def mesh_serve_outputs(model, mesh, params, prompt: dict, max_len,
                       decode_tokens, final_cache: bool = False) -> dict:
    """The mesh path's prefill logits and cache fields, and the logits of
    the decode steps fed ``decode_tokens`` (and the cache after them)."""
    steps = make_serve_steps(model, max_len, DEV, mesh=mesh)
    placed = shard_params(params, mesh, SERVE_RULES, model.logical)
    logits, cache = steps["prefill"](placed, prompt)
    got = {"prefill_logits": full_value(logits)}
    got.update({f"cache_{f}": full_value(getattr(cache, f))
                for f in cache._fields})
    dec = []
    for fed in decode_tokens:
        logits, cache = steps["decode_step"](placed, cache,
                                             torch.from_numpy(fed).to(DEV))
        dec.append(full_value(logits))
    got["decode_logits"] = torch.stack(dec)
    if final_cache:
        got.update({f"final_cache_{f}": full_value(getattr(cache, f))
                    for f in cache._fields})
    return got


def sharded_reference_rows(mesh) -> dict:
    """Every family's smoke config through the mesh path against the
    reference's .npz (no JAX), in the bands of the phases that hold them:
    the prefill's logits and cache, the decode steps."""
    rows = {}
    with np.load(REFERENCE_DECODER_NPZ) as z:
        ref = {k: z[k] for k in z.files}
    for arch in sorted({k.split("/", 1)[0] for k in ref}):
        sub = {k.split("/", 1)[1]: v for k, v in ref.items()
               if k.startswith(arch + "/")}
        params = tree_from_numpy({k.split("/", 1)[1]: v
                                  for k, v in sub.items()
                                  if k.startswith("params/")}, device=DEV)
        prompt = {k: torch.from_numpy(sub[k]).to(DEV)
                  for k in ("tokens", "prefix_embeds") if k in sub}
        got = mesh_serve_outputs(build_model(get_smoke_config(arch)), mesh,
                                 params, prompt, sub["cache_k"].shape[2],
                                 sub["decode_tokens"])
        rows[arch] = npz_rows("sharded", REFERENCE_DECODER_NPZ, got, sub,
                              DECODER_REFERENCE_TOL)
    with np.load(REFERENCE_RWKV_NPZ) as z:
        ref = {k: z[k] for k in z.files}
    params = tree_from_numpy({k.split("/", 1)[1]: v for k, v in ref.items()
                              if k.startswith("params/")}, device=DEV)
    for path, chunk in (("scan", 0), ("chunk", 16)):
        sub = {k.split("/", 1)[1]: v for k, v in ref.items()
               if k.startswith(path + "/")}
        model = build_model(get_smoke_config(ZOO_ARCH).replace(
            rwkv_chunk=chunk))
        got = mesh_serve_outputs(
            model, mesh, params,
            {"tokens": torch.from_numpy(sub["tokens"]).to(DEV)}, None,
            sub["decode_tokens"])
        rows[f"{ZOO_ARCH}/{path}"] = npz_rows(
            "sharded", REFERENCE_RWKV_NPZ, got, sub, ZOO_REFERENCE_TOL)
    with np.load(REFERENCE_GRIFFIN_NPZ) as z:
        ref = {k: z[k] for k in z.files}
    params = tree_from_numpy({k.split("/", 1)[1]: v for k, v in ref.items()
                              if k.startswith("params/")}, device=DEV)
    prompt = int(ref["cache_length"])
    got = mesh_serve_outputs(
        build_model(get_smoke_config(GRIFFIN_ARCH)), mesh, params,
        {"tokens": torch.from_numpy(ref["tokens"][:, :prompt]).to(DEV)},
        None, ref["decode_tokens"], final_cache=True)
    rows[GRIFFIN_ARCH] = npz_rows(
        "sharded", REFERENCE_GRIFFIN_NPZ, got, ref, GRIFFIN_REFERENCE_TOL,
        exact=("cache_pos", "cache_length", "final_cache_pos",
               "final_cache_length"))
    with np.load(REFERENCE_ENCDEC_NPZ) as z:
        ref = {k: z[k] for k in z.files}
    cfg = get_smoke_config(ENCDEC_ARCH)
    model = build_model(cfg)
    flat = {k.split("/", 1)[1]: v for k, v in ref.items()
            if k.startswith("params/")}
    n_pos = model.param_table["dec_pos"][0][0]
    flat["dec_pos"] = np.concatenate([flat["dec_pos"], np.zeros(
        (n_pos - flat["dec_pos"].shape[0], cfg.d_model), np.float32)])
    got = mesh_serve_outputs(
        model, mesh, tree_from_numpy(flat, device=DEV),
        {k: torch.from_numpy(ref[k]).to(DEV) for k in ("frames", "tokens")},
        ref["cache_k"].shape[2], ref["decode_tokens"])
    rows[ENCDEC_ARCH] = npz_rows("sharded", REFERENCE_ENCDEC_NPZ, got, ref,
                                 ENCDEC_REFERENCE_TOL,
                                 exact=("cache_length",))
    return rows


def sharded_moe_rows(mesh) -> list[dict]:
    """The four expert-parallel functions at one layer of the MoE config at
    published width in float32, against ``moe_ffn(num_groups=1)``:
    ``moe_ffn_sharded`` and its body ``_local_moe`` at 8 x 128 tokens,
    ``moe_ffn_sharded_decode`` and its body ``_local_moe_tokens_gathered``
    at 8 x 1."""
    cfg = f32_config(SHARDED_MOE_ARCH)
    table = moe.moe_param_table(cfg)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    params = transformer.build_params(gen, table, torch.float32)
    placed = shard_params(params, mesh, SERVE_RULES, table_logical(table))
    E = cfg.num_experts
    args = (params["router"], params["wi_0"], params["wi_1"], params["wo"],
            cfg, E)
    bodies = {"moe_ffn_sharded": ("_local_moe", lambda x: moe._local_moe(
                  x, *args)),
              "moe_ffn_sharded_decode": (
                  "_local_moe_tokens_gathered",
                  lambda x: moe._local_moe_tokens_gathered(x, *args))}
    rows = []
    for name, (B, S) in SHARDED_MOE_TOKENS.items():
        x = torch.randn((B, S, cfg.d_model), device=DEV, generator=gen)
        with torch.no_grad():
            want = moe.moe_ffn(x, params, cfg, 1)
            scale = float(want.abs().max())
            body, run_body = bodies[name]
            for fn, got in ((name, full_value(getattr(moe, name)(
                    x, placed, cfg, mesh))), (body, run_body(x))):
                err = float((got - want).abs().max())
                row = {"function": fn, "tokens": [B, S], "experts": E,
                       "top_k": cfg.moe_top_k, "d_model": cfg.d_model,
                       "max_abs_err": err, "max_abs_out": scale,
                       "tol": SHARDED_MOE_TOL}
                rows.append(row)
                check(got.shape == want.shape
                      and err <= SHARDED_MOE_TOL * scale,
                      f"sharded: {fn} against moe_ffn(num_groups=1): {row}")
    return rows


def sharded_plan_rows() -> list[dict]:
    """Per big config and mesh (data, model), from ``launch/dryrun.py``'s
    plan arithmetic (nothing allocated): the bf16 parameter bytes per rank
    under SERVE_RULES (held to the resolver's table), the KV cache bytes per
    rank at 8 x 2048 under both cache layouts, the keyed init's peak per
    rank beside the leaf-by-leaf init's it replaced, and the smallest mesh
    that fits one card."""
    rows = dryrun.serve_plan_rows(SHARDED_PLAN, SHARDED_PLAN_MESHES,
                                  SHARDED_PLAN_CACHE, CARD_BYTES)
    for row in rows:
        want = SHARDED_PLAN[row["arch"]]
        check(round(row["whole_gb"], 1) == want["whole"],
              f"sharded plan {row['arch']}: whole {row['whole_gb']}")
        for shape in SHARDED_PLAN_MESHES:
            entry = row["meshes"]["x".join(map(str, shape))]
            check(round(entry["param_gb"], 1) == want[shape],
                  f"sharded plan {row['arch']} at {shape}: "
                  f"{entry['param_gb']} GB per rank, the resolver's table "
                  f"says {want[shape]}")
    return rows


def phase_sharded(backend: str = "nccl") -> dict:
    """The serve steps on a (data=1, model=1) DeviceMesh inside a process
    group of one rank: one config of each family served at published width
    against the one-device path, float32 against it, the smoke configs
    against the reference's .npz, the expert-parallel MoE functions, and the
    plan rows of the three configs that need several cards."""
    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    out = {"phase": "sharded", "card": smi,
           "allocated_at_start_bytes": start_memory()}
    rendezvous = init_process_group(backend)
    try:
        mesh = make_debug_mesh(data=1, model=1)
        out["mesh"] = {"shape": mesh_shape(mesh),
                       "device_type": mesh.device_type,
                       "backend": dist.get_backend()}
        out["serve"] = [timed_row(sharded_serve_row, mesh, smi, *row)
                        for row in SHARDED_SERVE]
        out["float32"] = [timed_row(sharded_f32_row, mesh, arch, layers)
                          for arch, layers in SHARDED_F32]
        out["reference"] = timed_row(sharded_reference_rows, mesh)
        out["moe"] = timed_row(sharded_moe_rows, mesh)
    finally:
        set_active_mesh(None)
        close_process_group(rendezvous)
    out["plan"] = sharded_plan_rows()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# The sharded_train phase: the train step on a (data 1, model 1) mesh in an
# NCCL world of one rank against the one-device step from the same seed, at
# published width in bf16 with remat, donated, 4 steps at 8 x 64, lr 3e-5
# (the decoder phase's rate). Depth is cut only where one card cannot hold
# the state: stablelm_12b at 4 layers, qwen3_moe_235b at 1.
# (arch, layers kept or None for whole, optimizer, grad_accum)
SHARDED_TRAIN = (("rwkv6_1b6", None, "adamw", 1),
                 ("recurrentgemma_2b", None, "adamw", 1),
                 ("whisper_tiny", None, "adamw", 1),
                 ("stablelm_12b", 4, "adamw", 1),
                 ("qwen3_moe_235b", 1, "adamw", 1),
                 ("stablelm_12b", 4, "adafactor", 2))
SHARDED_TRAIN_STEPS = 4
SHARDED_TRAIN_SHAPE = (8, 64)            # batch, seq
SHARDED_TRAIN_LOSS_TOL = 1e-6            # relative, if not bit for bit
# The restart rows: whisper_tiny whole through launch/train.py, 6 steps at
# 8 x 64, a checkpoint every 2: a world of one preempted at 2, one device
# resuming and preempted at 4, a world of one resuming to the end.
SHARDED_RESTART_ARCH = "whisper_tiny"
SHARDED_RESTART_ARGS = ["--arch", SHARDED_RESTART_ARCH, "--steps", "6",
                        "--batch", "8", "--seq", "64", "--lr", "3e-5",
                        "--ckpt-every", "2", "--log-every", "100"]
SHARDED_RESTART_DIR = Path(__file__).resolve().parent / "build" / \
    "chip_smoke" / "sharded_train_ckpt"
# The pipeline row: stablelm_12b's 4-layer bf16 stack as one stage over a
# 'pod' of one, 4 microbatches of 2 x 64.
SHARDED_PIPE = ("stablelm_12b", 4, 4)    # arch, layers, microbatches
# Plan rows (no allocation): the train state per rank under rules_for at
# (world / 8, 8) and the multi-pod (2, world / 16, 8).
SHARDED_TRAIN_PLAN = ("stablelm_12b", "qwen2_72b", "qwen3_moe_235b",
                      "arctic_480b")
SHARDED_TRAIN_WORLDS = (8, 16, 32, 64)


def lm_batch(cfg, step: int, batch: int, seq: int) -> dict:
    """launch/train.py's batch at ``step``: the token stream, zero float32
    frames or patch embeddings where the family takes them."""
    tokens, labels = TokenPipeline(cfg.vocab_size, batch, seq).batch_at(step)
    out = {"tokens": torch.from_numpy(tokens).to(DEV),
           "labels": torch.from_numpy(labels).to(DEV)}
    if cfg.family in ("audio", "encdec"):
        out["frames"] = torch.zeros((batch, cfg.enc_frames, cfg.d_model),
                                    device=DEV)
    if cfg.family == "vlm":
        out["prefix_embeds"] = torch.zeros(
            (batch, cfg.num_patch_tokens, cfg.d_model), device=DEV)
    return out


def train_run(setup, batches) -> tuple:
    """``setup``'s state from SEED through ``batches``, each step timed on
    the host clock around work ending in a synchronize: (state, losses,
    grad norms, ms per step)."""
    state = setup.init_state(SEED)
    losses, norms, times = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = setup.step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    return state, [float(x) for x in losses], [float(x) for x in norms], \
        times


def state_leaves(state) -> dict:
    """Every tensor of a train state by its checkpoint key."""
    from repro_torch.checkpoint.manager import _flatten
    return {k: v for k, v in _flatten(state).items()
            if isinstance(v, torch.Tensor)}


class PinnedPool:
    """One page-locked host buffer that holds a train state's leaves, row
    after row (the card copies to and from page-locked memory at ~55 GB/s,
    to and from pageable memory at 2-6 GB/s; locking costs ~1 s per 4 GB,
    so it is done once). ``store`` copies a dict of device tensors into it
    and returns host views of them."""

    def __init__(self, nbytes: int):
        t0 = time.perf_counter()
        self.buf = torch.empty(nbytes, dtype=torch.uint8,
                               pin_memory=DEV.type == "cuda")
        self.seconds = time.perf_counter() - t0

    def store(self, leaves: dict) -> dict:
        out, at = {}, 0
        for k, v in leaves.items():
            n = v.numel() * v.element_size()
            at = -(-at // 16) * 16
            host = self.buf[at:at + n].view(v.dtype).view(v.shape)
            host.copy_(v, non_blocking=True)
            out[k] = host
            at += n
        torch.cuda.synchronize()
        return out


def train_state_nbytes(cfg, opt_name: str) -> int:
    """Bytes of a train state's parameters and moments (AdamW's two float32
    moments a parameter; Adafactor's factored ones counted as AdamW's, an
    upper bound), with each leaf's 16-byte alignment."""
    table = build_model(cfg).param_table
    size = torch.finfo(cfg.dtype_param).bits // 8
    return sum(math.prod(shape) * (size + 8) + 48
               for shape, _, _ in table.values())


def sharded_train_row(mesh, smi: str, arch: str, layers, opt_name: str,
                      accum: int, pool: PinnedPool) -> dict:
    """The one-device donated step from SEED, its final state copied to the
    host (``pool``) and freed, then the mesh step from SEED on the same
    batches: both losses and grad norms, ms per step, peaks, and every
    parameter and moment of the two final states compared bit for bit (the
    largest gap of each leaf that is not)."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    model = build_model(cfg)
    opt = OptConfig(name=opt_name, peak_lr=3e-5, warmup_steps=2,
                    decay_steps=SHARDED_TRAIN_STEPS)
    batch, seq = SHARDED_TRAIN_SHAPE
    batches = [lm_batch(cfg, i, batch, seq)
               for i in range(SHARDED_TRAIN_STEPS)]
    row = {"arch": arch, "card": smi, "layers": cfg.num_layers,
           "published_layers": get_config(arch).num_layers,
           "params": count_params(cfg), "dtype": str(cfg.dtype_param),
           "remat": cfg.remat, "optimizer": f"{opt_name} (donated)",
           "grad_accum": accum, "batch": batch, "seq": seq,
           "steps": SHARDED_TRAIN_STEPS, "peak_lr": opt.peak_lr}
    host = None
    for name, kw in (("one_device", {}), ("mesh", {"mesh": mesh})):
        start = start_memory()
        setup = make_train_step(model, opt, accum, DEV, donate=True, **kw)
        state, losses, norms, times = train_run(setup, batches)
        row[name] = {"losses": losses, "grad_norms": norms,
                     "first_step_ms": times[0],
                     "ms_per_step": statistics.mean(times[1:]),
                     "allocated_at_start_bytes": start,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        if host is None:
            t0 = time.perf_counter()
            host = pool.store(state_leaves(state))
            row["host_copy_seconds"] = time.perf_counter() - t0
            del state, setup
            continue
        gaps = {}
        for k, v in state_leaves(state).items():
            got = full_value(v).detach()
            want = host[k].to(DEV, non_blocking=True)
            if not torch.equal(got, want):
                gaps[k] = float((got.float() - want.float()).abs().max())
        row["leaves"] = len(host)
        row["leaves_bit_for_bit"] = len(host) - len(gaps)
        row["gaps"] = gaps
        del state, setup, host
    one, on = row["one_device"], row["mesh"]
    row["losses_bit_for_bit"] = one["losses"] == on["losses"]
    row["grad_norms_bit_for_bit"] = one["grad_norms"] == on["grad_norms"]
    row["ms_ratio"] = on["ms_per_step"] / one["ms_per_step"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(on["losses"],
                                                  one["losses"]))
    row["max_loss_gap_relative"] = rel
    check(all(np.isfinite(one["losses"] + on["losses"])),
          f"sharded_train {arch}: losses {one['losses']} {on['losses']}")
    check(rel <= SHARDED_TRAIN_LOSS_TOL,
          f"sharded_train {arch}: mesh losses {on['losses']} against one "
          f"device {one['losses']}")
    check(not row["gaps"] and row["losses_bit_for_bit"],
          f"sharded_train {arch}: not bit for bit: {row['gaps']}")
    return row


def sharded_restart_chain() -> list[dict]:
    """whisper_tiny whole through ``python -m repro_torch.launch.train``,
    three processes in turn: an NCCL world of one (--mesh debug) preempted
    at step 2 (exit 42), one device (no group) resuming at 2 and preempted
    at 4, a world of one resuming at 4 to the end. Each writes its losses
    (``--metrics-out``); the runs are checked by
    :func:`sharded_restart_rows`."""
    shutil.rmtree(SHARDED_RESTART_DIR, ignore_errors=True)
    SHARDED_RESTART_DIR.mkdir(parents=True)
    ckpt = SHARDED_RESTART_DIR / "ckpt"
    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(root / "src")
    group = dict(env, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    runs = []
    for i, (extra, run_env, want_rc) in enumerate((
            (["--mesh", "debug", "--simulate-preempt", "2"], group, 42),
            (["--simulate-preempt", "4"], env, 42),
            (["--mesh", "debug"], group, 0))):
        metrics = SHARDED_RESTART_DIR / f"run{i}.json"
        run_env = dict(run_env, DIST_INIT_METHOD=(
            f"file://{SHARDED_RESTART_DIR / f'rendezvous{i}'}"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train",
             *SHARDED_RESTART_ARGS, "--ckpt-dir", str(ckpt),
             "--metrics-out", str(metrics), *extra],
            capture_output=True, text=True, env=run_env, cwd=root,
            timeout=300)
        run = {"args": extra, "group": "WORLD_SIZE" in run_env,
               "returncode": proc.returncode, "want_returncode": want_rc,
               "seconds": time.perf_counter() - t0,
               "stdout": [line for line in proc.stdout.splitlines()
                          if line.startswith(("restored", "SIMULATED",
                                              "final loss"))],
               "stderr_tail": proc.stderr[-2000:]
               if proc.returncode != want_rc else ""}
        if metrics.exists():
            run.update(json.loads(metrics.read_text()))
        runs.append(run)
        if proc.returncode != want_rc:
            break
    return runs


def sharded_restart_rows(smi: str, runs: list[dict]) -> dict:
    """The restart chain's runs (:func:`sharded_restart_chain`) checked:
    each exit code and its printed lines, then its last run's losses and
    final checkpoint against an uninterrupted one-device run in this
    process, bit for bit."""
    for i, run in enumerate(runs):
        check(run["returncode"] == run["want_returncode"],
              f"sharded_train restart {i}: exit {run['returncode']}, wanted "
              f"{run['want_returncode']}: {run['stderr_tail']}")
    check(len(runs) == 3, f"sharded_train restart: {runs}")
    for run, want in zip(runs, (
            ["SIMULATED PREEMPTION at step 2"],
            ["restored checkpoint at step 2", "SIMULATED PREEMPTION at step 4"],
            ["restored checkpoint at step 4", "final loss"])):
        check(all(any(w in line for line in run["stdout"]) for w in want),
              f"sharded_train restart: {want} not printed: {run}")
    whole, _ = quiet(lm_train.main, SHARDED_RESTART_ARGS)
    last = runs[-1]
    final = CheckpointManager(str(SHARDED_RESTART_DIR / "ckpt")).restore(
        whole.state)
    same_state = all(torch.equal(a, b) for a, b in zip(
        state_leaves(final).values(), state_leaves(whole.state).values()))
    out = {"arch": SHARDED_RESTART_ARCH, "card": smi, "runs": runs,
           "uninterrupted_losses": whole.losses,
           "resumed_at": last.get("start_step"),
           "final_losses_bit_for_bit":
               last.get("losses") == whole.losses[4:],
           "final_state_bit_for_bit": same_state}
    check(last.get("start_step") == 4 and out["final_losses_bit_for_bit"]
          and same_state,
          f"sharded_train restart: {out}")
    del whole, final
    shutil.rmtree(SHARDED_RESTART_DIR, ignore_errors=True)
    return out


def sharded_compression_row(mesh_pod) -> dict:
    """int8 quantisation of rwkv6_1b6's bf16 gradients at the train row's
    first batch (one-device step's gradient): every leaf's error within its
    scale, and the all-reduce over a 'pod' of one equal to
    dequantize(quantize) bit for bit."""
    cfg = get_config("rwkv6_1b6")
    model = build_model(cfg)
    setup = make_train_step(model, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    loss, grads = setup.grad_fn(params, lm_batch(cfg, 0,
                                                 *SHARDED_TRAIN_SHAPE))
    del params
    errors = tree_map(lambda g: torch.zeros(g.shape, device=DEV), grads)
    worst, same, nbytes = 0.0, True, 0
    reduced, new_err = make_compressed_allreduce(mesh_pod)(grads, errors)
    for g, e, r, ne in zip(tree_leaves(grads), tree_leaves(errors),
                           tree_leaves(reduced), tree_leaves(new_err)):
        q, scale, err = quantize_leaf(g, e)
        worst = max(worst, float((err.abs().max() / scale)))
        same &= torch.equal(dequantize_leaf(q, scale), r) and \
            torch.equal(err, ne)
        nbytes += q.numel()
    row = {"arch": "rwkv6_1b6", "leaves": len(tree_leaves(grads)),
           "grad_dtype": str(tree_leaves(grads)[0].dtype),
           "int8_payload_bytes": nbytes, "loss": float(loss),
           "max_error_over_scale": worst,
           "allreduce_equals_dequantize_quantize": same,
           "pod_ranks": mesh_shape(mesh_pod)["pod"],
           "note": "a 'pod' of one rank runs no collective: no data moves"}
    check(worst <= 1.0 and same, f"sharded_train compression: {row}")
    return row


def sharded_pipeline_row(mesh_pod) -> dict:
    """stablelm_12b's first layers in bf16 as one stage over a 'pod' of
    one: ``pipelined_forward`` (M microbatches) against the stack run on
    the same microbatches in order, bit for bit, and its gap to the stack
    run on the whole batch at once. S >= 2 stages run only on the CPU
    (gloo), since one card holds one rank."""
    arch, layers, M = SHARDED_PIPE
    cfg = get_config(arch).replace(num_layers=layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    batch, seq = SHARDED_TRAIN_SHAPE
    x = torch.randn((batch, seq, cfg.d_model),
                    generator=torch.Generator(device=DEV).manual_seed(SEED),
                    device=DEV).to(cfg.dtype_act)
    cos, sin = rope(torch.arange(seq, device=DEV), cfg.head_dim,
                    cfg.rope_theta)

    def stack(sp, h):
        for l in range(layers):
            h, _, _ = transformer._decoder_layer(
                h, transformer._layer(sp, l), cfg, cos, sin,
                transformer._window(cfg, l))
        return h
    stages = tree_map(lambda a: a[None], params["layers"])
    with torch.no_grad():
        got = pipelined_forward(mesh_pod, stack, M)(stages, x)
        each = torch.cat([stack(params["layers"], xm)
                          for xm in x.chunk(M)])
        whole = stack(params["layers"], x)
    row = {"arch": arch, "layers": layers, "stages": 1,
           "microbatches": M, "batch": batch, "seq": seq,
           "dtype": str(cfg.dtype_act),
           "bit_for_bit_with_the_stack_by_microbatch": torch.equal(got,
                                                                   each),
           "max_abs_gap_to_the_whole_batch": float(
               (got.float() - whole.float()).abs().max()),
           "note": "S >= 2 runs only on the CPU over gloo (one card, one "
                   "rank)"}
    check(row["bit_for_bit_with_the_stack_by_microbatch"]
          and torch.isfinite(got.float()).all(),
          f"sharded_train pipeline: {row}")
    return row


def sharded_train_plan_rows() -> list[dict]:
    """Per big config, from ``launch/dryrun.py``'s plan arithmetic
    (nothing allocated): the train state per rank under ``rules_for`` at
    (world / 8, 8) and (2, world / 16, 8), AdamW with float32 moments and
    Adafactor with bf16 moments, the keyed init's peak per rank, and the
    smallest mesh whose state fits one card (activations not counted)."""
    return dryrun.train_plan_rows(SHARDED_TRAIN_PLAN, SHARDED_TRAIN_WORLDS,
                                  CARD_BYTES)


def phase_sharded_train(backend: str = "nccl") -> dict:
    """The train step on a (data 1, model 1) DeviceMesh inside a process
    group of one rank, each row against the one-device step from the same
    seed; a preempt and restart across a world of one and one device; int8
    compression of real gradients; the pipeline over a 'pod' of one; the
    per-rank plan of the train state of the big configs."""
    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    out = {"phase": "sharded_train", "card": smi,
           "allocated_at_start_bytes": start_memory()}
    # The restart chain's three processes (~30 s each, mostly start-up on
    # the host) run beside the train rows; their GPU work is two whisper_tiny
    # steps each.
    chain = ThreadPoolExecutor(1)
    chain_runs = chain.submit(sharded_restart_chain)
    pool = PinnedPool(max(train_state_nbytes(
        get_config(a).replace(**({} if n is None else {"num_layers": n})), o)
        for a, n, o, _ in SHARDED_TRAIN))
    out["pinned_host_bytes"] = pool.buf.numel()
    out["pinned_alloc_seconds"] = pool.seconds
    rendezvous = init_process_group(backend)
    try:
        mesh = make_debug_mesh(data=1, model=1)
        out["mesh"] = {"shape": mesh_shape(mesh),
                       "device_type": mesh.device_type,
                       "backend": dist.get_backend()}
        out["train"] = [timed_row(sharded_train_row, mesh, smi, *row, pool)
                        for row in SHARDED_TRAIN]
        del pool
        pod = make_debug_mesh(data=1, model=1, pod=1)
        out["compression"] = timed_row(sharded_compression_row, pod)
        out["pipeline"] = timed_row(sharded_pipeline_row, pod)
    finally:
        set_active_mesh(None)
        close_process_group(rendezvous)
        runs = chain_runs.result()
        chain.shutdown()
    out["restart"] = timed_row(sharded_restart_rows, smi, runs)
    out["plan"] = sharded_train_plan_rows()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# The plan phase: the keyed init and the dry run (launch/dryrun.py) on the
# card. stablelm_12b whole in bf16: its one-device init against the blocks
# of the 4 ranks of a (1, 4) SERVE_RULES mesh, drawn by the block function,
# bit for bit, each rank's peak beside its blocks plus one slab. The three
# big configs at their fitting serve meshes: rank 0's and the largest
# rank's blocks drawn on the card, the peak within PLAN_INIT_TOL of the
# dry run's rule and under one card, two leaves slab by slab against direct
# draws. Then the dry run in a fake group of one against the peaks the
# sharded and sharded_train rows measured (within PLAN_DRY_TOL where the
# measured peak reaches PLAN_DRY_FROM), and one multi-rank cell per big
# config at its mesh in a fake group: a decode step at PLAN_CELL (batch,
# cache positions) and its roofline row at the H100's spec-sheet peaks.
PLAN_WHOLE = ("stablelm_12b", (1, 4))
PLAN_BIG = {"qwen2_72b": (1, 4), "qwen3_moe_235b": (1, 8),
            "arctic_480b": (2, 8)}
PLAN_INIT_TOL = 0.05
PLAN_DRY_TOL = 0.20
PLAN_DRY_FROM = 10e9
PLAN_CELL = (8, 2048)
PLAN_TRAIN_CELL = (8, 4096)


def plan_mesh(shape) -> types.SimpleNamespace:
    """A (data, model) mesh's sizes, for the block function and the plan
    arithmetic (no process group)."""
    return types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]})


def keyed_blocks(model, rules, mesh, coords) -> dict:
    """Every leaf's block of the rank at ``coords``, drawn on the card by
    ``sharding.keyed_block`` from SEED in ``build_params``' order."""
    sizes = mesh_shape(mesh)
    out = {}
    for name in sorted(model.param_table):
        shape, logical, fan = model.param_table[name]
        out[name] = keyed_block(
            SEED, name, shape, transformer.init_std(name, fan),
            logical_to_pspec(logical, rules, mesh, shape), sizes, coords,
            model.cfg.dtype_param, DEV)
    torch.cuda.synchronize()
    return out


def leaf_of(params: dict, name: str) -> torch.Tensor:
    for part in name.split("/"):
        params = params[part]
    return params


def block_of(model, rules, mesh, coords, name):
    """(ranges, spec) of the block of leaf ``name`` at ``coords``."""
    shape, logical, _ = model.param_table[name]
    spec = logical_to_pspec(logical, rules, mesh, shape)
    return block_ranges(shape, spec, mesh_shape(mesh), coords)


def slabs_equal_direct(block, model, rules, mesh, coords, name) -> int:
    """The block of leaf ``name`` against a direct draw of each slab it
    meets (a generator seeded by ``slab_seed``, scaled, cast and cut), one
    slab at a time: the number of slabs, all equal or it fails."""
    shape, _, fan = model.param_table[name]
    std = transformer.init_std(name, fan)
    ranges = block_of(model, rules, mesh, coords, name)
    gen = torch.Generator(device=DEV)
    count = 0
    for lead, (r0, r1) in slabs(shape, ranges):
        gen.manual_seed(slab_seed(SEED, name, lead, r0))
        if len(shape) < 2:
            want = torch.randn(shape, generator=gen, device=DEV).mul_(std)
            want = want[tuple(slice(lo, hi) for lo, hi in ranges)]
            got = block
        else:
            want = torch.randn((r1 - r0, shape[-1]), generator=gen,
                               device=DEV).mul_(std)
            (lo, hi), (c0, c1) = ranges[-2:]
            a, b = max(r0, lo), min(r1, hi)
            want = want[a - r0:b - r0, c0:c1]
            at = tuple(i - rl for i, (rl, _) in zip(lead, ranges))
            got = block[at + (slice(a - lo, b - lo),)]
        check(torch.equal(got, want.to(block.dtype)),
              f"plan: {name} slab {lead} {r0} at {coords} differs from "
              f"its direct draw")
        count += 1
    return count


def plan_whole_rows(smi: str) -> dict:
    """stablelm_12b whole in bf16: the one-device keyed init, then each
    rank's blocks of a (1, 4) SERVE_RULES mesh against its leaves."""
    arch, shape = PLAN_WHOLE
    model = build_model(get_config(arch))
    table, dtype = model.param_table, model.cfg.dtype_param
    size = torch.finfo(dtype).bits // 8
    mesh = plan_mesh(shape)
    start = start_memory()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    torch.cuda.synchronize()
    out = {"arch": arch, "card": smi, "mesh": list(shape),
           "one_device": {"seconds": time.perf_counter() - t0,
                          "peak_bytes": torch.cuda.max_memory_allocated()
                          - start,
                          "param_bytes": param_bytes_per_rank(
                              table, SERVE_RULES, plan_mesh((1, 1)), size)},
           "ranks": []}
    for r, coords in enumerate(dryrun.rank_coords(mesh)):
        base = start_memory()
        t0 = time.perf_counter()
        blocks = keyed_blocks(model, SERVE_RULES, mesh, coords)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        equal = all(torch.equal(blocks[name], leaf_of(params, name)[tuple(
            slice(lo, hi) for lo, hi in block_of(model, SERVE_RULES, mesh,
                                                 coords, name))])
            for name in table)
        rule = dryrun.init_peak_per_rank(table, SERVE_RULES, mesh, dtype,
                                         coords)
        out["ranks"].append({
            "rank": r, "coords": coords, "seconds": seconds,
            "peak_bytes": peak,
            "block_bytes": param_bytes_per_rank(table, SERVE_RULES, mesh,
                                                size),
            "blocks_plus_one_slab_bytes": rule, "peak_over_rule": peak / rule,
            "bit_for_bit_with_one_device": equal})
        del blocks
        check(equal, f"plan: {arch} rank {r}'s blocks differ from the "
              f"one-device init")
    del params
    return out


def plan_big_rows(smi: str) -> list[dict]:
    """The three big configs at their fitting serve meshes: rank 0's and
    the largest rank's blocks (by the dry run's rule, the last of equals)
    drawn on the card, their peak against the rule and one card, two
    leaves (the embedding and the largest) slab by slab."""
    rows = []
    for arch, shape in PLAN_BIG.items():
        model = build_model(get_config(arch))
        table, dtype = model.param_table, model.cfg.dtype_param
        size = torch.finfo(dtype).bits // 8
        mesh = plan_mesh(shape)
        coords_all = dryrun.rank_coords(mesh)
        rules = [dryrun.init_peak_per_rank(table, SERVE_RULES, mesh, dtype,
                                           c) for c in coords_all]
        largest = max(range(len(rules)), key=lambda r: (rules[r], r))
        big = max((n for n in table if transformer.init_std(
            n, table[n][2]) > 0), key=lambda n: math.prod(table[n][0]))
        row = {"arch": arch, "card": smi, "mesh": list(shape),
               "leafwise_init_peak_bytes":
                   dryrun.leafwise_init_peak_per_rank(table, SERVE_RULES,
                                                      mesh, dtype),
               "ranks": []}
        for r in sorted({0, largest}):
            coords = coords_all[r]
            base = start_memory()
            t0 = time.perf_counter()
            blocks = keyed_blocks(model, SERVE_RULES, mesh, coords)
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            checked = {n: slabs_equal_direct(blocks[n], model, SERVE_RULES,
                                             mesh, coords, n)
                       for n in ("embed", big)}
            entry = {"rank": r, "coords": coords, "seconds": seconds,
                     "peak_bytes": peak,
                     "init_peak_bytes_per_rank": rules[r],
                     "peak_over_rule": peak / rules[r],
                     "block_bytes": param_bytes_per_rank(
                         table, SERVE_RULES, mesh, size),
                     "slabs_checked": checked}
            row["ranks"].append(entry)
            del blocks
            check(peak <= CARD_BYTES
                  and abs(peak / rules[r] - 1) <= PLAN_INIT_TOL,
                  f"plan: {arch} rank {r}: init peak {peak} against the "
                  f"rule's {rules[r]} (tol {PLAN_INIT_TOL}), card "
                  f"{CARD_BYTES}")
        rows.append(row)
    return rows


def _ratio(predicted, measured):
    return predicted / measured if measured else None


def plan_against_measured(sharded: dict | None,
                          sharded_train: dict | None) -> dict:
    """The dry run in a fake group of one on a (1, 1) mesh, at each row of
    the sharded and sharded_train phases: the predicted per-rank peaks (the
    keyed init's; the serve's: the larger of the init's, the prefill's and
    a decode step's; the train step's, donated, from the placed state)
    beside what the card measured, with their ratio."""
    serve_rows = (sharded or {}).get("serve", [])
    train_rows = (sharded_train or {}).get("train", [])
    out = {"serve": [], "train": []}
    with dryrun.fake_world(1):
        mesh = make_debug_mesh(1, 1, device_type=DEV.type)
        for i, (arch, layers, batch, prompt, gen) in enumerate(SHARDED_SERVE):
            cfg = get_config(arch)
            if layers is not None:
                cfg = cfg.replace(num_layers=layers)
            table = build_model(cfg).param_table
            max_len = prompt + gen + (cfg.num_patch_tokens or 0)
            init = dryrun.init_peak_per_rank(table, SERVE_RULES, mesh,
                                             cfg.dtype_param)
            pre, dec = (dryrun.plan_layers(cfg, lambda c, kind=kind:
                                           dryrun.plan_serve(
                                               c, batch, prompt, mesh, kind,
                                               SERVE_RULES, max_len),
                                           whole=True)[0]
                        for kind in ("prefill", "decode"))
            serve = max(init, pre["memory_analysis"]["peak_bytes_per_device"],
                        dec["memory_analysis"]["peak_bytes_per_device"])
            got = serve_rows[i] if i < len(serve_rows) else {}
            out["serve"].append({
                "arch": arch, "layers": cfg.num_layers,
                "init": {"predicted": init,
                         "measured": got.get("init_peak_bytes"),
                         "ratio": _ratio(init, got.get("init_peak_bytes"))},
                "serve": {"predicted": serve,
                          "measured": got.get("serve_peak_bytes"),
                          "ratio": _ratio(serve,
                                          got.get("serve_peak_bytes"))}})
        for i, (arch, layers, opt_name, accum) in enumerate(SHARDED_TRAIN):
            cfg = get_config(arch)
            if layers is not None:
                cfg = cfg.replace(num_layers=layers)
            opt = OptConfig(name=opt_name)
            batch, seq = SHARDED_TRAIN_SHAPE
            art = dryrun.plan_layers(cfg, lambda c: dryrun.plan_train(
                c, batch, seq, mesh, opt, accum), whole=True)[0]
            step = art["memory_analysis"]["peak_bytes_per_device"]
            got = train_rows[i]["mesh"] if i < len(train_rows) else {}
            measured = got.get("peak_memory_bytes")
            if measured is not None:
                measured -= got["allocated_at_start_bytes"]
            out["train"].append({
                "arch": arch, "layers": cfg.num_layers,
                "optimizer": opt_name, "grad_accum": accum,
                "step": {"predicted": step, "measured": measured,
                         "ratio": _ratio(step, measured)},
                "flops_per_step": art["cost_analysis"]["flops_per_device"]})
    for part in ("serve", "train"):
        for row in out[part]:
            for key in ("init", "serve", "step"):
                cell = row.get(key)
                if cell and cell["measured"] and \
                        cell["measured"] >= PLAN_DRY_FROM:
                    check(abs(cell["ratio"] - 1) <= PLAN_DRY_TOL,
                          f"plan: the dry run's {key} peak of {row['arch']} "
                          f"against the card's: {cell}")
    return out


def plan_cells() -> list[dict]:
    """Two multi-rank cells per big config at its mesh, in a fake group of
    that many ranks: a decode step at PLAN_CELL under SERVE_RULES (the
    plan's rules) and a train step at PLAN_TRAIN_CELL under the reference's
    rules for the cell (ZeRO for the dense config, sequence-parallel layer
    boundaries for the MoE ones): each artifact (argument bytes and planned
    peak a rank) and its roofline row. Each is checked to dispatch on this
    PyTorch (the train cells stopped on the card's before the fixes of
    ROADMAP queue 3)."""
    rows = []
    batch, positions = PLAN_CELL
    decode = types.SimpleNamespace(name=f"decode_{batch}x{positions}",
                                   seq_len=positions, global_batch=batch,
                                   kind="decode")
    batch, seq = PLAN_TRAIN_CELL
    train = types.SimpleNamespace(name=f"train_{batch}x{seq}", seq_len=seq,
                                  global_batch=batch, kind="train")
    for shape, rules in ((decode, SERVE_RULES), (train, None)):
        for arch, (data, model) in PLAN_BIG.items():
            with dryrun.fake_world(data * model):
                mesh = make_debug_mesh(data, model, device_type=DEV.type)
                t0 = time.perf_counter()
                art = dryrun.plan_cell(arch, shape, mesh, f"{data}x{model}",
                                       rules=rules)
            art["seconds"] = time.perf_counter() - t0
            terms = roofline.roofline_terms(art)
            rows.append({"artifact": art, "roofline": terms})
            check(art["cost_analysis"]["flops_per_device"] > 0
                  and art["memory_analysis"]["argument_bytes_per_device"] > 0,
                  f"plan: the {arch} {shape.name} cell counted nothing: "
                  f"{art}")
    return rows


def plan_coverage() -> list[dict]:
    """What this PyTorch's DTensor dispatches on a (2, 2) mesh: the dry
    run of every family's smoke config (prefill, decode and train of 4 x
    16 tokens) in a fake group of 4, each cell's outcome and, where it
    stops, the error and the port's frames. Checked: every cell dispatches
    (on the card's PyTorch 13 of the 30 stopped before the fixes of ROADMAP
    queue 3). The rows are recorded first, so a failure lists them all."""
    rows = []
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        patches = cfg.num_patch_tokens or 0
        for kind in ("prefill", "decode", "train"):
            row = {"arch": arch, "kind": kind}
            try:
                with dryrun.fake_world(4):
                    mesh = make_debug_mesh(2, 2, device_type=DEV.type)
                    if kind == "train":
                        dryrun.plan_train(cfg, 4, 16 + patches, mesh,
                                          OptConfig())
                    else:
                        dryrun.plan_serve(cfg, 4, 16 + patches, mesh, kind,
                                          SERVE_RULES, 32 + patches)
                row["dispatched"] = True
            except RuntimeError as err:
                frames = [f for f in traceback.extract_tb(err.__traceback__)
                          if "repro_torch" in f.filename]
                row.update(dispatched=False,
                           error=str(err).splitlines()[0][:200],
                           at=[f"{Path(f.filename).name}:{f.lineno}"
                               for f in frames[-3:]])
            rows.append(row)
    stopped = [r for r in rows if not r["dispatched"]]
    check(not stopped, f"plan: {len(stopped)} of {len(rows)} (2, 2) cells "
          f"do not dispatch on this PyTorch: {stopped}")
    return rows


def phase_plan(sharded: dict | None = None,
               sharded_train: dict | None = None) -> dict:
    """The keyed init on the card and the dry run against it (the comment
    above PLAN_WHOLE)."""
    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    out = {"phase": "plan", "card": smi,
           "allocated_at_start_bytes": start_memory()}
    out["whole"] = timed_row(plan_whole_rows, smi)
    gc.collect()
    out["big"] = timed_row(plan_big_rows, smi)
    gc.collect()
    out["dry_run_world_of_one"] = timed_row(plan_against_measured, sharded,
                                            sharded_train)
    out["cells"] = timed_row(plan_cells)
    out["coverage_2x2"] = timed_row(plan_coverage)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# The analysis phase: the lint CLI over the port, the dispatch audits on
# the card (the kernels at float32), the CG loop's host reads at the fit
# phase's size on the routed cuda engine, the budget against the card.
ANALYSIS_CG = dict(FIT_SHAPE)


def phase_analysis() -> dict:
    """``repro_torch.analysis`` on the card (``PERF.md`` §3, the analysis
    layer): the lint CLI over ``src/repro_torch`` with the committed empty
    baseline (exit 0), every dispatch audit clean with the real kernels,
    ``audit_cg_reads`` on the routed ``cuda`` engine (one host read a CG
    iteration; MVM sweeps, each through the route of its batch bucket, =
    CG iterations + 2 an objective evaluation; the microseconds a read
    takes), and the budget audit against
    ``device_limits``."""
    from repro_torch.analysis.__main__ import budget_audit
    from repro_torch.analysis.__main__ import main as lint_main
    from repro_torch.analysis.dispatch_audit import (audit_cg_reads,
                                                     run_all_audits)

    t_phase = time.perf_counter()
    out = {"phase": "analysis", "card": nvidia_smi_line()}
    root = Path(__file__).resolve().parent
    report = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(report):
        rc = lint_main([str(root / "src" / "repro_torch"), "--baseline",
                        str(root / "analysis_baseline_torch.json"),
                        "--no-budget"])
    out["lint"] = {"exit": rc, "report": report.getvalue().splitlines(),
                   "seconds": time.perf_counter() - t0}
    check(rc == 0, f"analysis: the lint CLI exits {rc}: {out['lint']}")

    limits = device_limits(DEV)
    rows, failures = budget_audit(limits)
    out["budget"] = {"limits": dataclasses.asdict(limits), "rows": rows,
                     "failures": failures}
    check(not failures, f"analysis: the budget audit: {failures}")

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        failures = run_all_audits(DEV, verbose=True)
    out["audits"] = {"log": log.getvalue().splitlines(),
                     "failures": failures,
                     "seconds": time.perf_counter() - t0}
    check(failures == [], f"analysis: the dispatch audits: {failures}")

    t0 = time.perf_counter()
    rows, failures = audit_cg_reads(DEV, backend="cuda", **ANALYSIS_CG)
    out["cg_reads"] = {"rows": rows, "failures": failures,
                       "seconds": time.perf_counter() - t0}
    check(failures == [], f"analysis: the CG loop's reads: {failures}")
    for row in rows:
        check(row["reads_per_iteration"] == 1.0,
              f"analysis: {row['reads_per_iteration']} host reads a CG "
              f"iteration: {row}")
        check(row["sweeps"] == row["cg_iterations"] + 2,
              f"analysis: {row['sweeps']} sweeps ({row['launches']}) for "
              f"{row['cg_iterations']} CG iterations: {row}")
    out["seconds"] = time.perf_counter() - t_phase
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
    # Outside the ladder's own checks no solve may escalate (`unescalated`).
    reset_launch_counts()
    with unescalated("serve"):
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

    # Main path 1b, the solver stack (PCG, SGD, the objective through PCG,
    # the escalation ladder) on the serve state: counted from zero. The
    # tally is zero up to the ladder's checks, which hold it to their traces.
    reset_launch_counts()
    reset_escalation_tally()
    solvers_out = phase_solvers(n=8192, m=64, d=7, n_new=256,
                                reference=serve_answers)
    solvers_totals = launch_counts()
    solvers_out["launches"] = solvers_totals
    emit(solvers_out)
    for n, m, B in ((8192, 64, 65), (8192, 64, 1), (2000, 52, 17),
                    (2000, 52, 16), (2000, 52, 1)):
        for name in ROUTE_KERNELS[routed(n, m, B)]:
            check(solvers_totals[name] > 0, f"the solver paths never "
                  f"launched {name}, the route of (B, n, m) = {(B, n, m)}")
    del solvers_out
    torch.cuda.empty_cache()

    with unescalated("serve_lcbench"):
        lcbench, sweep_error, _ = phase_serve(
            "serve_lcbench", n=2000, m=52, d=7, n_new=256,
            compare_iterative=True)
        lcbench["float32_sweep_error"] = sweep_error()
    emit(lcbench)
    with unescalated("exact"):
        exact = phase_exact()
    emit(exact)
    torch.cuda.empty_cache()

    # Main path 2, fitting: counted from zero over this phase (which also
    # checks the count of each route it drives).
    reset_launch_counts()
    with unescalated("fit"):
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
    with unescalated("warm"):
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

    # Main path 3b, the AutoML schedulers (SH, rank SH, freeze-thaw,
    # Hyperband) on the routed cuda engine through PCG: counted from zero
    # over this phase, each update and read held to its own launches.
    reset_launch_counts()
    with unescalated("automl"):
        automl_out = phase_automl(**AUTOML_SHAPE)
    automl_totals = launch_counts()
    automl_out["launches"] = automl_totals
    emit(automl_out)
    probes = FIT_CONFIG["slq_probes"]
    for (n, m), Bs in (((AUTOML_SHAPE["n"], AUTOML_SHAPE["m"]),
                        (probes + 1, probes, 1, 65, 64)),
                       ((AUTOML_HYPERBAND["n"], AUTOML_HYPERBAND["m"]),
                        (probes + 1, probes, 1, 65))):
        for B in Bs:
            for name in ROUTE_KERNELS[routed(n, m, B)]:
                check(automl_totals[name] > 0, f"the automl path never "
                      f"launched {name}, the route of (B, n, m) = "
                      f"{(B, n, m)}")
    lbfgs_arm = automl_out["freeze_thaw"]
    del automl_out
    torch.cuda.empty_cache()

    # Main path 3c, the amortized init: the reference's outputs, the MLL
    # gaps, a d=7 amortizer trained here, and the freeze-thaw again with it
    # (amortized + polish), each refit held to its launches; counted from
    # zero over this phase.
    reset_launch_counts()
    with unescalated("amortize"):
        amortize_out = phase_amortize(**AUTOML_SHAPE, lbfgs_arm=lbfgs_arm)
    amortize_totals = launch_counts()
    amortize_out["launches"] = amortize_totals
    emit(amortize_out)
    for B in (probes + 1, probes, 1, 65):
        for name in ROUTE_KERNELS[routed(AUTOML_SHAPE["n"], AUTOML_SHAPE["m"],
                                         B)]:
            check(amortize_totals[name] > 0, f"the amortize path never "
                  f"launched {name}, the route of B = {B}")
    del amortize_out, lbfgs_arm
    torch.cuda.empty_cache()

    # Main path 4, the batched dense path (fit_batch, posterior_batch): no
    # MVM kernel, which the phase checks.
    with unescalated("batch"):
        batch = phase_batch()
    emit(batch)
    torch.cuda.empty_cache()

    # Main path 4b, the prediction service: dense tenants (coalesced cold
    # fits, bitwise coalescing, latency, throughput, the chaos schedule),
    # then a service on the routed cuda engine, whose fits launch the MVM
    # kernels (counted from zero, held > 0 in the phase).
    reset_launch_counts()
    with unescalated("service"):
        service_out = phase_service()
    service_out["launches"] = launch_counts()
    emit(service_out)
    del service_out
    torch.cuda.empty_cache()

    # Main path 4c, the paper's Transformer baseline against the LKGP (dense
    # fits: no MVM kernel).
    with unescalated("curvepred"):
        emit(phase_curvepred())
    torch.cuda.empty_cache()

    # Main path 4d, the LM zoo: RWKV-6 served and trained at its published
    # width through launch/serve.py and launch/train.py (no hand-written
    # kernel: the reference writes it in plain jnp), then freeze-thaw over 8
    # real RWKV runs whose refits run the MVM kernels on the routed cuda
    # engine (counted from zero over the freeze-thaw, held > 0 there).
    with unescalated("zoo"):
        zoo_out = phase_zoo()
    zoo_totals = zoo_out["freeze_thaw"]["launches"]
    emit(zoo_out)
    del zoo_out
    gc.collect()
    torch.cuda.empty_cache()

    # Main path 4e, the LM zoo's decoder family (dense, VLM prefix, MoE) in
    # bf16 at published width: served through launch/serve.py (the depth
    # of the three that do not fit one card cut), the float32 checks, the
    # smoke configs against the reference, train steps. Plain PyTorch: the
    # reference writes the decoder and its MoE in plain jnp, no kernel.
    with unescalated("decoder"):
        emit(phase_decoder())
    gc.collect()
    torch.cuda.empty_cache()

    # Main path 4f, the LM zoo's last two one-card families in bf16 at
    # published width, whole: the Griffin hybrid (recurrentgemma_2b) and the
    # Whisper encoder-decoder (whisper_tiny), served through launch/serve.py
    # and trained through launch/train.py, their float32 checks and smoke
    # configs against the reference. Plain PyTorch: the reference writes
    # the RG-LRU, the rotating window and the encoder-decoder in plain jnp.
    with unescalated("griffin"):
        emit(phase_griffin())
    gc.collect()
    torch.cuda.empty_cache()
    with unescalated("encdec"):
        emit(phase_encdec())
    gc.collect()
    torch.cuda.empty_cache()

    # Main path 4g, the LM zoo on a device mesh: the serve steps over
    # DTensor placements by the logical-axis rules, in an NCCL world of one
    # rank, one config of each family against the one-device path, the
    # smoke configs against the reference, the expert-parallel MoE, and the
    # per-rank plan of the configs that need several cards. Plain PyTorch:
    # the reference's sharded steps are plain jnp under XLA, no kernel.
    with unescalated("sharded"):
        sharded_out = phase_sharded()
    emit(sharded_out)
    gc.collect()
    torch.cuda.empty_cache()

    # Main path 4h, training on a device mesh: the train step over DTensor
    # placements in an NCCL world of one rank against the one-device step,
    # a preempt and restart across a world of one and one device, int8
    # gradient compression and the pipeline over a 'pod' of one, the plan of
    # the train state per rank. Plain PyTorch: the reference's train path is
    # plain jnp under XLA, no kernel.
    with unescalated("sharded_train"):
        sharded_train_out = phase_sharded_train()
    emit(sharded_train_out)
    gc.collect()
    torch.cuda.empty_cache()

    # Main path 4i, the plan: the keyed init of the configs that need
    # several cards drawn a rank at a time on the card, and the dry run
    # (launch/dryrun.py, a fake process group) against the peaks the two
    # mesh phases measured. Plain PyTorch: no kernel.
    with unescalated("plan"):
        emit(phase_plan(sharded_out, sharded_train_out))
    del sharded_out, sharded_train_out
    gc.collect()
    torch.cuda.empty_cache()

    # Main path 4j, the port's analysis: the lint CLI, the dispatch audits
    # with the real kernels, the CG loop's host reads on the routed cuda
    # engine (its MVM launches held to the iterations), the budget audit.
    with unescalated("analysis"):
        emit(phase_analysis())
    gc.collect()
    torch.cuda.empty_cache()

    # Main path 5, the distributed engine in an NCCL group of one rank.
    rendezvous = init_process_group("nccl")
    reset_launch_counts()
    with unescalated("distributed"):
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
    main_paths = {k: serve_launches[k] + solvers_totals[k] + fit_totals[k]
                  + warm_totals[k] + automl_totals[k] + amortize_totals[k]
                  + zoo_totals[k]
                  for k in ("lk_mvm_fused", "lk_mvm_stage_right",
                            "lk_mvm_stage_left")}
    emit({"kernels": [
        summary_row(rows, "lk_mvm_fused", csrc + "lk_mvm_fused.cu",
                    "src/repro/kernels/lk_mvm.py:253", MAIN_SHAPE,
                    main_paths["lk_mvm_fused"]),
        summary_row(rows, "lk_mvm_stage_right", csrc + "lk_mvm_two_stage.cu",
                    "src/repro/kernels/lk_mvm.py:170", FIT_MAIN_SHAPE,
                    main_paths["lk_mvm_stage_right"]),
        summary_row(rows, "lk_mvm_stage_left", csrc + "lk_mvm_stage_left.cu",
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
