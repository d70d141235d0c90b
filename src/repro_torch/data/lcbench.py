"""LCBench/ifBO-format curve artifacts: npz + embedded JSON meta on disk.

Counterpart of ``repro.data.lcbench`` (a copy: the port imports nothing of
the reference); both packages read and write the same files.

One artifact holds a set of learning-curve *tasks* (LCBench calls them
datasets): each task is a config table ``X`` (n, d), a progression grid
``t`` (m,) — epochs, steps, or arbitrary non-uniform budget fidelities —
per-config curves ``Y`` (n, m), and an early-stop mask (1.0 where the
curve was actually observed). The on-disk layout is a single ``.npz``:

* ``format``              — the schema tag ``"lcbench-v1"``;
* ``num_tasks``           — T;
* ``X_<i>, t_<i>, Y_<i>, mask_<i>`` for ``i in range(T)``; ``Y`` is stored
  zeroed where unobserved (the :class:`~repro_torch.data.curves.CurveTask` mask
  convention, enforced on load);
* ``Y_full_<i>``          — optional ground-truth curves (present when the
  artifact was exported from a source with post-cutoff values, e.g. the
  synthetic prior or LCBench's complete tables; absent for genuinely
  censored logs, in which case the loader falls back to ``Y`` and records
  ``has_full=False``);
* ``meta_json``           — a JSON string: task names, metric name,
  ``maximize`` convention, free-form extras.

Everything loads with ``allow_pickle=False``; the artifact is hermetic.
"""
from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np

from .curves import CurveTask

__all__ = ["FORMAT", "LCBenchArtifact", "write_artifact", "load_artifact"]

FORMAT = "lcbench-v1"


class LCBenchArtifact(NamedTuple):
    """A loaded artifact: tasks plus their metadata."""

    tasks: list          # list[CurveTask]
    names: list          # list[str], one per task
    metric: str          # e.g. "val_accuracy", "val_loss"
    maximize: bool       # metric convention (True: larger is better)
    has_full: list       # list[bool]: task i carries ground-truth Y_full
    meta: dict           # the full decoded meta_json


def write_artifact(path, tasks, *, names=None, metric: str = "val_accuracy",
                   maximize: bool = True, extra_meta: dict | None = None):
    """Write ``tasks`` (list of :class:`CurveTask`) as one npz artifact.

    ``Y`` is stored masked (zeroed where unobserved). ``Y_full`` is stored
    only when it genuinely differs from the masked observations — an
    artifact round-trips the distinction between "full curves + early-stop
    protocol mask" and "censored logs".
    """
    tasks = list(tasks)
    if not tasks:
        raise ValueError("write_artifact needs at least one task")
    names = ([f"task{i}" for i in range(len(tasks))]
             if names is None else list(names))
    if len(names) != len(tasks):
        raise ValueError(f"{len(names)} names for {len(tasks)} tasks")

    arrays: dict = {"format": np.asarray(FORMAT),
                    "num_tasks": np.asarray(len(tasks), np.int64)}
    has_full = []
    for i, tk in enumerate(tasks):
        X = np.asarray(tk.X, np.float64)
        t = np.asarray(tk.t, np.float64)
        Y = np.asarray(tk.Y, np.float64)
        mask = np.asarray(tk.mask, np.float64)
        if t.ndim != 1 or np.any(np.diff(t) <= 0) or t[0] <= 0:
            raise ValueError(f"task {i}: t must be positive and strictly "
                             f"increasing, got {t}")
        if Y.shape != mask.shape or Y.shape != (X.shape[0], t.shape[0]):
            raise ValueError(f"task {i}: inconsistent shapes X{X.shape} "
                             f"t{t.shape} Y{Y.shape} mask{mask.shape}")
        arrays[f"X_{i}"] = X
        arrays[f"t_{i}"] = t
        arrays[f"Y_{i}"] = Y * mask
        arrays[f"mask_{i}"] = mask
        stored = (tk.Y_full is not None
                  and not np.array_equal(np.asarray(tk.Y_full) * mask,
                                         np.asarray(tk.Y_full)))
        # Y_full differs from its masked view somewhere -> real post-cutoff
        # ground truth worth storing. (A fully-observed task needs no copy:
        # its masked Y already IS complete ground truth, so it still counts
        # as has_full.)
        if stored:
            arrays[f"Y_full_{i}"] = np.asarray(tk.Y_full, np.float64)
        has_full.append(bool(stored or np.all(mask > 0)))

    meta = {"names": names, "metric": metric, "maximize": bool(maximize),
            "has_full": has_full}
    meta.update(extra_meta or {})
    arrays["meta_json"] = np.asarray(json.dumps(meta))
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def load_artifact(path) -> LCBenchArtifact:
    """Load an npz artifact into tasks + metadata.

    Mask semantics are enforced on load: ``Y`` comes back zeroed where
    unobserved even if the file stored raw values there. Tasks without a
    stored ``Y_full`` get ``Y_full = Y`` (masked) and ``has_full=False`` —
    callers scoring against ground truth must restrict to observed cells
    for those tasks.
    """
    with np.load(path, allow_pickle=False) as z:
        fmt = str(z["format"])
        if fmt != FORMAT:
            raise ValueError(f"unknown artifact format {fmt!r} in {path}; "
                             f"expected {FORMAT!r}")
        meta = json.loads(str(z["meta_json"]))
        T = int(z["num_tasks"])
        tasks, has_full = [], []
        for i in range(T):
            X = z[f"X_{i}"]
            t = z[f"t_{i}"]
            mask = z[f"mask_{i}"]
            Y = z[f"Y_{i}"] * mask
            key = f"Y_full_{i}"
            if key in z.files:
                Y_full = z[key]
                has_full.append(True)
            else:
                Y_full = Y.copy()
                # A fully-observed task needs no stored copy: the masked Y
                # already covers every cell, so it still has ground truth.
                has_full.append(bool(np.all(mask > 0)))
            tasks.append(CurveTask(X=X, t=t, Y=Y, mask=mask, Y_full=Y_full))
    return LCBenchArtifact(tasks=tasks,
                           names=list(meta.get("names",
                                               [f"task{i}" for i in range(T)])),
                           metric=str(meta.get("metric", "metric")),
                           maximize=bool(meta.get("maximize", True)),
                           has_full=has_full, meta=meta)
