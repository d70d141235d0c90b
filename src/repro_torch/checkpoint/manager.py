"""Fault-tolerant checkpointing: atomic, keep-K, async.

Counterpart of ``repro.checkpoint.manager``, with the same on-disk layout,
so a checkpoint one package writes the other restores. A checkpoint is a
directory ``step_%010d`` holding ``state.npz`` (one host array per tensor
leaf of the saved tree) and ``manifest.json`` (``step``, ``time``, the
sorted ``keys``, and the caller's ``extra``). It is written into a temp dir
that is atomically renamed (a crash mid-write can never corrupt the latest
checkpoint); only the newest ``keep`` checkpoints are kept.

The keys are the reference's pytree paths joined with ``//``: a list or
tuple entry by its index (``0``), a dict entry by its key, a NamedTuple or
dataclass field as ``.name``; a dataclass field that holds no tensor (an
``LKGPState``'s ``config``) is static metadata and not saved. So an
``LKGPState``'s noise is ``.params//.raw_noise`` and, in a list of states,
``0//.params//.raw_noise``. Restore rebuilds the structure of a template
tree with the saved values, in the template leaves' dtypes, on ``device``
(default: each template leaf's own device).

A bfloat16 leaf is written as the reference writes it (``np.savez`` of an
``ml_dtypes.bfloat16`` array): 2-byte ``|V2`` records holding the raw bits.
Restore reinterprets such a record's bytes as bfloat16 (numpy has no cast
from ``|V2``), then casts to the template leaf's dtype, so a bfloat16 leaf
comes back bit for bit.

An optional background thread makes saves asynchronous; ``wait()`` joins it.

Checkpoints do not depend on the mesh, as the reference's. A state of
``DTensor`` s (a manager made with ``mesh=``) is saved by every rank at
once: each leaf's whole value is gathered on the calling thread, leaf by
leaf in the keys' order (the same on every rank), before the writer thread
starts, and rank 0 alone writes the files the one-device path writes. The
writer never runs a collective; ``wait()`` joins it on rank 0 and then
holds every rank at a barrier until the write is done. ``restore(...,
shardings=)`` places each leaf by its ``NamedSharding`` (each rank keeps
its block of the whole saved value), so a checkpoint written on one mesh
restores on another, on one device, or the other way round.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["CheckpointManager"]

_SEP = "//"
_ARRAY = (torch.Tensor, np.ndarray, np.generic)


def _has_array(node: Any) -> bool:
    if isinstance(node, _ARRAY):
        return True
    return any(_has_array(child) for _, child in _children(node))


def _children(node: Any) -> list[tuple[str, Any]]:
    """(path entry, child) of an inner node, in the reference's order; a
    leaf has none."""
    if isinstance(node, _ARRAY) or node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        fields = [(f".{f.name}", getattr(node, f.name))
                  for f in dataclasses.fields(node)]
        return [(k, v) for k, v in fields if _has_array(v)]
    return []


def _is_leaf(node: Any) -> bool:
    return isinstance(node, _ARRAY) or (
        not isinstance(node, (dict, list, tuple))
        and not dataclasses.is_dataclass(node) and node is not None)


def _flatten(tree: Any) -> dict[str, Any]:
    """``{path: leaf}`` in the reference's key strings and order."""
    out: dict[str, Any] = {}

    def walk(node, path):
        if _is_leaf(node):
            out[_SEP.join(path)] = node
            return
        for key, child in _children(node):
            walk(child, path + [key])

    walk(tree, [])
    return out


def _rebuild(node: Any, leaf: Callable[[str, Any], Any], path=()) -> Any:
    """``node``'s structure with every leaf replaced by ``leaf(path, old)``."""
    if _is_leaf(node):
        return leaf(_SEP.join(path), node)
    kids = {k: _rebuild(v, leaf, path + (k,)) for k, v in _children(node)}
    if isinstance(node, dict):
        return {k: kids[str(k)] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(kids[f".{f}"] for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(kids[str(i)] for i in range(len(node)))
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{k[1:]: v
                                            for k, v in kids.items()})
    return node


_BF16_RECORD = np.dtype("V2")


def _to_host(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf``: also of a CPU tensor, which a donated train
    step goes on to overwrite while the background thread writes it."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(_BF16_RECORD)
        return host.numpy()
    return np.asarray(leaf)


def _from_host(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == _BF16_RECORD:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.as_tensor(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 mesh=None):
        """``mesh``: the ``DeviceMesh`` of the states saved (every rank of
        its group makes a manager and calls each method at the same
        point); ``None`` for one process."""
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self.mesh = mesh
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _writes(self) -> bool:
        """Whether this process writes: rank 0 of a mesh's group, or the
        only process."""
        return self.mesh is None or dist.get_rank() == 0

    # -- write --------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None):
        """Copy every tensor leaf of ``state`` to the host now, then write
        (on the background thread when ``async_save``). On a mesh every
        rank gathers each leaf's whole value here, and rank 0 writes."""
        host = {}
        for k, v in _flatten(state).items():
            if hasattr(v, "full_tensor"):       # a collective: every rank
                v = v.full_tensor()
            if self._writes():
                host[k] = _to_host(v)
        self.wait()
        if not self._writes():
            return
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra or {})

    def _write(self, step: int, host: dict, extra: dict):
        tmp = os.path.join(self.directory, f".tmp_step_{step}_{os.getpid()}")
        final = os.path.join(self.directory, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"), **host)
        manifest = {"step": step, "time": time.time(),
                    "keys": sorted(host.keys()), "extra": extra}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self):
        """Until the last write is done (on a mesh, on every rank)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None:
            dist.barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- read ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))  # lint: disable=RT103 (a name)
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: int | None = None,
                device=None, shardings: Any = None) -> Any:
        """Restore into the structure of ``target``.

        Every tensor leaf of ``target`` is replaced by the saved array of its
        key, cast to the leaf's dtype and placed on ``device`` (default: the
        leaf's own device, a ``DTensor``'s the device of its block); a numpy
        leaf comes back as a numpy array. ``shardings``: a tree of the same
        structure (``TrainSetup.state_shardings``) whose
        :class:`~repro_torch.distributed.sharding.NamedSharding` leaves
        place their leaves as ``DTensor`` s (this rank's block of the saved
        value); a ``None`` sharding, or no ``shardings``, leaves its leaf a
        plain tensor.
        """
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}")
        with np.load(os.path.join(path, "state.npz")) as data:
            host = {k: data[k] for k in data.files}
        missing = set(_flatten(target)) - set(host)
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}")

        def leaf(key, tgt):
            arr = host[key]
            if isinstance(tgt, torch.Tensor):
                local = tgt.to_local() if hasattr(tgt, "device_mesh") else tgt
                value = _from_host(arr).to(
                    dtype=tgt.dtype,
                    device=local.device if device is None else device)
                return _place(value, _at(shardings, key))
            if hasattr(tgt, "dtype"):
                return arr.astype(tgt.dtype)
            return arr

        return _rebuild(target, leaf)


def _at(tree: Any, key: str) -> Any:
    """The node of ``tree`` at the path ``key`` (``None`` past a ``None``
    node or for no tree)."""
    node = tree
    for part in key.split(_SEP) if key else []:
        if node is None:
            return None
        if part.startswith("."):
            node = getattr(node, part[1:])
        elif isinstance(node, dict):
            key = part if part in node else int(part)  # lint: disable=RT103 (a key)
            node = node[key]
        else:
            node = node[int(part)]  # lint: disable=RT103 (a key)
    return node


def _place(value: torch.Tensor, sharding) -> torch.Tensor:
    """``value`` (the whole saved leaf) laid out by ``sharding``, or plain
    when it is ``None``."""
    from ..distributed.sharding import shard_tensor

    if sharding is None:
        return value
    return shard_tensor(value, sharding.mesh, sharding.spec)
