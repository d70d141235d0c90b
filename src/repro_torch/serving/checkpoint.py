"""Session durability: checkpoint/restore of the serving session store.

Counterpart of ``repro.serving.checkpoint``, writing the same files: built
on :class:`repro_torch.checkpoint.manager.CheckpointManager` (atomic
npz+manifest directories, keep-K GC), one checkpoint snapshots every
resident tenant ``LKGPState`` (as a LIST - list indices keep the flattened
keys unique and order-stable) plus a JSON-serialisable manifest describing
each session (tenant/task/generation/observes, array shapes, dtype, and the
full ``LKGPConfig``) and the monotonic observation log. A checkpoint the
reference's service wrote restores here, and the other way round.

Restore is template-based: the manifest carries enough metadata to build a
correctly-shaped/dtyped template ``LKGPState`` per session on the service's
device, so ``PredictionService.restore()`` can rebuild warm sessions into an
EMPTY store after a crash. The observation log survives alongside, so the
service can tell which observations landed after the snapshot (clients
replay from ``next_seq``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from collections import deque

import torch

from .._device import resolve_device
from ..checkpoint.manager import CheckpointManager
from ..core.state import LKGPConfig, LKGPState, init_params
from ..core.transforms import TTransform, XTransform, YTransform

__all__ = ["ObservationLog", "ServiceCheckpointer", "state_template"]


class ObservationLog:
    """Monotonic, thread-safe log of accepted observations.

    Each accepted ``observe`` appends ``{seq, tenant, task, action}``; the
    sequence number is strictly increasing for the life of the service
    (restores carry it forward), so "which observations post-date this
    checkpoint" is a single integer comparison. Bounded: only the newest
    ``window`` entries are retained (and checkpointed), the counter never
    resets.
    """

    def __init__(self, window: int = 8192) -> None:
        self._entries: deque[dict] = deque(maxlen=window)
        self._next_seq = 0
        self._lock = threading.Lock()

    def append(self, tenant: str, task: str, action: str) -> int:
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._entries.append({"seq": seq, "tenant": tenant,
                                  "task": task, "action": action})
            return seq

    @property
    def next_seq(self) -> int:
        return self._next_seq

    def entries(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._entries]

    def load(self, entries: list[dict], next_seq: int) -> None:
        """Adopt a checkpointed log (restore path)."""
        with self._lock:
            self._entries.clear()
            self._entries.extend(dict(e) for e in entries)
            self._next_seq = max(int(next_seq), self._next_seq)


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.float64`` -> ``"float64"``, the name the manifest carries."""
    return str(dtype).removeprefix("torch.")


def state_template(n: int, m: int, d: int, dtype, config: LKGPConfig,
                   device=None) -> LKGPState:
    """Correctly-shaped/dtyped placeholder state for checkpoint restore.

    Only shapes, dtypes, the device (``None``: the GPU) and the config
    matter - every tensor is overwritten by the restored values. ``dtype``
    is a ``torch.dtype`` or its name (``"float64"``, as the manifest
    writes it). Transform tensors are benign constants (NOT ``.fit`` of
    placeholder data, which would take logs/stds of meaningless values).
    """
    dev = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype.removeprefix("torch."))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return LKGPState(
        params=init_params(d, dtype, dev),
        X=zeros(n, d), t=ones(m), Y=zeros(n, m), mask=ones(n, m),
        x_tf=XTransform(lo=zeros(d), hi=ones(d)),
        t_tf=TTransform(log_t1=zeros(), log_tm=ones()),
        y_tf=YTransform(shift=zeros(), scale=ones()),
        config=config)


class ServiceCheckpointer:
    """Checkpoint/restore of a :class:`~repro_torch.serving.store.SessionStore`.

    Saves are synchronous (``async_save=False``): the service calls this
    from its own observation path and the durability guarantee is "the
    checkpoint exists when ``save`` returns". Atomicity/keep-K come from
    the underlying manager. Restored states live on ``device``.
    """

    def __init__(self, directory: str, keep: int = 3, device=None) -> None:
        self.directory = directory
        self.device = resolve_device(device)
        self._manager = CheckpointManager(directory, keep=keep,
                                          async_save=False)
        self._step = 0
        self._lock = threading.Lock()

    # -- write ------------------------------------------------------------
    def save(self, sessions: list, obs_log: ObservationLog | None = None
             ) -> int:
        """Snapshot the given sessions (+ observation log); returns step.

        ``sessions`` are :class:`~repro_torch.serving.store.Session`
        objects; each is snapshotted under its own lock so a concurrent
        ``observe`` cannot tear a state mid-copy.
        """
        metas, states = [], []
        for s in sessions:
            with s.lock:
                state, gen, obs = s.state, s.generation, s.observes
            metas.append({
                "tenant": s.key.tenant, "task": s.key.task,
                "generation": gen, "observes": obs,
                "n": state.n, "m": state.m, "d": state.d,
                "dtype": _dtype_name(state.Y.dtype),
                "config": dataclasses.asdict(state.config),
            })
            states.append(state)
        extra = {"sessions": metas, "next_seq": 0, "obs_log": []}
        if obs_log is not None:
            extra["obs_log"] = obs_log.entries()
            extra["next_seq"] = obs_log.next_seq
        with self._lock:
            self._step += 1
            step = self._step
        self._manager.save(step, states, extra=extra)
        return step

    # -- read -------------------------------------------------------------
    def latest_step(self) -> int | None:
        return self._manager.latest_step()

    def manifest(self, step: int | None = None) -> dict:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}",
                            "manifest.json")
        with open(path) as f:
            return json.load(f)

    def load(self, step: int | None = None) -> tuple[list[dict],
                                                     list[LKGPState], dict]:
        """Load (session metas, restored states, manifest extra).

        States come back in the same order as the metas, on the
        checkpointer's device; the caller reinstalls them into a store (see
        ``PredictionService.restore``).
        """
        manifest = self.manifest(step)
        extra = manifest["extra"]
        metas = extra["sessions"]
        templates = [
            state_template(meta["n"], meta["m"], meta["d"], meta["dtype"],
                           LKGPConfig(**meta["config"]), device=self.device)
            for meta in metas
        ]
        states: list[LKGPState] = []
        if templates:
            states = self._manager.restore(templates,
                                           step=manifest["step"])
        with self._lock:
            self._step = max(self._step, int(manifest["step"]))
        return metas, states, extra
