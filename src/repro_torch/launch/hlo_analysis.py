"""Collective accounting for the dry run (counterpart of
``repro.launch.hlo_analysis``).

There is no HLO here. The reference parses the optimized per-device HLO for
all-gather / all-reduce / reduce-scatter / all-to-all / collective-permute
ops; this module records the collectives a step *dispatches*: a
:class:`CollectiveRecorder` (a ``TorchDispatchMode`` below ``DTensor``)
sees every c10d op of ``torch.distributed`` (the port's own all-reduces and
all-gathers, receives) and every functional collective ``DTensor``'s
redistributions issue, with its result bytes, its group's size and the
mesh axes the group spans. :func:`analyze_collectives` then fills
:class:`CollectiveStats` as the reference does.

Two differences from the reference's caveats:
  * No loop is counted once. The port loops over layers (and microbatches)
    in Python, so every layer's collectives are dispatched and recorded: the
    loop-body multiplier is 1 and ``body`` stays empty.
  * Sizes are RESULT bytes per op, as the reference records them;
    ``wire_bytes`` converts them to bytes crossing links with the same
    ring-algorithm factors, and ``CollectiveStats.axes`` splits them by the
    mesh axes of each op's group.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveStats", "CollectiveRecord", "CollectiveRecorder",
           "analyze_collectives", "DTYPE_BYTES"]

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.bfloat16: 2, torch.float16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
}

# op name (namespace-free) -> the reference's collective kind
_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_":
    "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",     # a send is its peer's receive
}
# c10d ops that write their result into their first argument
_RESULT_IN_ARG0 = {"allgather_", "_allgather_base_",
                   "allgather_into_tensor_coalesced_", "allgather_coalesced_",
                   "reduce_scatter_", "_reduce_scatter_base_",
                   "reduce_scatter_tensor_coalesced_", "alltoall_",
                   "alltoall_base_", "allreduce_", "allreduce_coalesced_",
                   "recv_"}


@dataclass
class CollectiveStats:
    # kind -> [count, result_bytes, wire_bytes] aggregated
    entry: dict = field(default_factory=lambda: defaultdict(lambda: [0, 0, 0]))
    body: dict = field(default_factory=lambda: defaultdict(lambda: [0, 0, 0]))
    # mesh axes ("model", "data+model", ...) -> wire bytes
    axes: dict = field(default_factory=lambda: defaultdict(float))

    def totals(self, body_multiplier: float = 1.0):
        out = {}
        for kind in set(self.entry) | set(self.body):
            e = self.entry.get(kind, [0, 0, 0])
            b = self.body.get(kind, [0, 0, 0])
            out[kind] = {
                "count": e[0] + b[0] * body_multiplier,
                "result_bytes": e[1] + b[1] * body_multiplier,
                "wire_bytes": e[2] + b[2] * body_multiplier,
            }
        return out

    def total_wire_bytes(self, body_multiplier: float = 1.0) -> float:
        return sum(v["wire_bytes"]
                   for v in self.totals(body_multiplier).values())


def _wire_bytes(kind: str, result_bytes: int, p: int) -> float:
    """Ring-algorithm bytes per participating device."""
    if p <= 1:
        return 0.0
    r = (p - 1) / p
    if kind == "all-gather":
        return result_bytes * r              # each device receives (p-1)/p
    if kind == "all-reduce":
        return 2.0 * result_bytes * r        # reduce-scatter + all-gather
    if kind == "reduce-scatter":
        return result_bytes * r * p          # operand = result * p
    if kind == "all-to-all":
        return result_bytes * r
    if kind == "collective-permute":
        return float(result_bytes)
    return float(result_bytes)


class CollectiveRecord(NamedTuple):
    kind: str            # the reference's kind
    result_bytes: int    # per device
    group_size: int
    axis: str            # mesh axes the group spans, "+"-joined


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * DTYPE_BYTES.get(x.dtype, x.element_size())
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _group_of(args):
    """The process group a c10d op runs on: a boxed ``ProcessGroup`` among
    its arguments (raw c10d ops) or the group name, the last string
    (functional collectives)."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a)
            except RuntimeError:
                continue
    names = [a for a in args if isinstance(a, str)]
    return _resolve_process_group(names[-1]) if names else None


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective dispatched inside it as a
    :class:`CollectiveRecord` (``.records``). ``mesh`` names the axes a
    group spans (ranks whose mesh coordinates differ along them); a group
    off the mesh is ``"other"``. ``DTensor`` ops pass through to their
    local ops, which are seen."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.records: list[CollectiveRecord] = []
        self._axes: dict[str, str] = {}

    def _axis(self, pg) -> str:
        import torch.distributed as dist

        if pg.group_name in self._axes:
            return self._axes[pg.group_name]
        axis = "other"
        if self.mesh is not None:
            layout = self.mesh.mesh
            ranks = dist.get_process_group_ranks(pg)
            coords = [(layout == r).nonzero()[0].tolist() for r in ranks
                      if (layout == r).any()]
            if len(coords) == len(ranks):
                names = self.mesh.mesh_dim_names
                axis = "+".join(names[d] for d in range(len(names))
                                if len({c[d] for c in coords}) > 1) or "none"
        self._axes[pg.group_name] = axis
        return axis

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t == DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        if "c10d" in func.namespace and name in _KINDS:
            pg = _group_of(list(args) + list(kwargs.values()))
            if pg is not None:
                res = args[0] if name in _RESULT_IN_ARG0 else out
                self.records.append(CollectiveRecord(
                    _KINDS[name], _tensor_bytes(res), pg.size(),
                    self._axis(pg)))
        return out


def analyze_collectives(records, num_devices: int) -> CollectiveStats:
    """:class:`CollectiveStats` of recorded collectives (every one in
    ``entry``: the port dispatches every loop iteration). A record's group
    size is its own; ``num_devices`` is the default for a record without
    one, as the reference's default group."""
    stats = CollectiveStats()
    for rec in records:
        p = rec.group_size or num_devices
        wire = _wire_bytes(rec.kind, rec.result_bytes, p)
        stats.entry[rec.kind][0] += 1
        stats.entry[rec.kind][1] += rec.result_bytes
        stats.entry[rec.kind][2] += wire
        stats.axes[rec.axis] += wire
    return stats
