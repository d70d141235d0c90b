"""The one traffic generator: a cell's inputs from its configuration, its mix
and the seed.

A mix (``perfbench/traffic/<mix>.json``) is data: which client sends it and
the schedule's parameters. Every mix here is a closed loop of one client
over the rungs of ``races`` Successive Halving races (Jamieson & Talwalkar,
2016), one a dataset, each as the program's scheduler
(``repro_torch.autotune.sh``) runs one over a pool of ``n`` configurations
and ``m`` epochs: at rung k every configuration still racing has reached
``min_epochs * eta^k`` epochs (the last rung: all ``m``), and the best
``ceil(active / eta)`` go on. They are ranked by their observed value at the
rung, the scheduler's ``promotion="rank"`` rule, so a race needs no model to
be drawn.

The run's seed draws the datasets (learning-curve tasks at the
configuration's shape, ``perfbench.curves.sample_task``) and the standard
normals of each rung. A race's snapshot is its first rung: every
configuration observed at ``min_epochs``. Each request applies one rung to
its race's snapshot, the races' rungs in turn, so the work a request asks
for does not depend on how fast the program runs. Every seed gets rungs of
the same sizes (the same number of observations, configurations and
epochs) on other curves; several datasets a run keep the solver's iteration
counts, which the curves set, alike from seed to seed. The same seed gives
the same inputs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .curves import sample_task

__all__ = ["Race", "Traffic", "make_traffic", "sh_masks", "draw_normals"]


class Race(NamedTuple):
    X: np.ndarray            # (n, d) configurations
    Y_full: np.ndarray       # (n, m) whole curves
    rungs: list              # [(Y, mask)] one a rung; the first: the snapshot


class Traffic(NamedTuple):
    t: np.ndarray            # (m,) epochs
    races: list              # [Race] one a dataset


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def sh_masks(Y_full: np.ndarray, min_epochs: int, eta: int) -> list:
    """The observed masks after each rung of one Successive Halving race
    over all of ``Y_full``'s rows, maximising the observed value (the
    program's ``SuccessiveHalvingScheduler.run`` with ``promotion="rank"``:
    the same rung count, targets, promotion count and stable ranking)."""
    n, m = Y_full.shape
    r = max(1, min(int(min_epochs), m))
    num_rungs = int(math.floor(math.log(m / r) / math.log(eta))) + 1
    active = np.arange(n)
    lens = np.zeros(n, dtype=np.int64)
    out = []
    for k in range(num_rungs):
        target = m if k == num_rungs - 1 else min(m, r * eta ** k)
        lens[active] = np.maximum(lens[active], target)
        out.append((np.arange(m)[None, :] < lens[:, None]).astype(np.float64))
        if k < num_rungs - 1 and active.size > 1:
            keep = max(1, int(math.ceil(active.size / eta)))
            scores = Y_full[active, target - 1]
            order = np.argsort(-scores, kind="stable")[:keep]
            active = active[np.sort(order)]
    return out


def make_traffic(config: dict, mix: dict, seed: int) -> Traffic:
    races = []
    for r in range(int(mix["races"])):
        task_seed = int(_rng(seed, 0, r).integers(0, 2**63 - 1))
        task = sample_task(task_seed, n=config["n"], m=config["m"],
                           d=config["d"])
        masks = sh_masks(task.Y_full, mix["min_epochs"], mix["eta"])
        races.append(Race(task.X, task.Y_full,
                          [(task.Y_full * mk, mk) for mk in masks]))
    return Traffic(task.t, races)


def draw_normals(seed: int, slot: int, s: int, n: int, m: int, device):
    """``(Z, E)``, each (s, n, m) float64 on ``device``: the standard
    normals of the Matheron prior draw and of the noise draw."""
    g = torch.Generator(device=device)
    g.manual_seed(int(_rng(seed, 2, slot).integers(0, 2**63 - 1)))
    shape = (s, n, m)
    Z = torch.randn(shape, dtype=torch.float64, device=device, generator=g)
    E = torch.randn(shape, dtype=torch.float64, device=device, generator=g)
    return Z, E
