"""Spans and counters at the port's layer boundaries.

The request path opens five spans, all named ``lkgp.*``:

* ``lkgp.extend`` - :func:`repro_torch.core.extend`;
* ``lkgp.final`` - :meth:`repro_torch.core.Posterior.final`;
* ``lkgp.cg`` - one CG / PCG loop (``core/solvers/cg.py``), attrs ``B``,
  ``n``, ``m``, ``iters``, ``replacements``;
* ``lkgp.mvm`` - one sweep of the ``cuda`` engine's operator
  (``KernelOperator.__call__``: the launch of the batch, made at its first
  sweep, the autograd wrapper, the launch), attrs ``route``, ``B``, ``m``
  and ``r_steps`` (K2a's ring steps a strip: 1 while m <= 64, else one a
  pass and k chunk);
* ``lkgp.mvm.launch`` - the launch inside it (``u``'s check and casts, the
  outputs' allocation, the kernels' launches), in the forward and in the
  backward's ``du`` sweep.

and the CG loop adds three counters when it ends: ``lkgp.cg.wait_ns`` (host
nanoseconds blocked in the loop's reads of the device), ``lkgp.cg.cols_swept``
(B for each operator sweep) and ``lkgp.cg.cols_active`` (the solve's
active-column MVMs, ``CGResult.matvecs``). A loop's enqueue time is its
span's duration minus its wait. Each two-stage sweep adds K2a's plan to
``lkgp.mvm.stage_r_steps`` (its strips' ring steps) and
``lkgp.mvm.stage_r_bytes`` (the bytes its loads and stores move: U, the
mask, K2 and T's two planes). Each solve of a
:class:`~repro_torch.core.Posterior` adds the epoch columns it swept,
the observed prefix L, to ``lkgp.solve.prefix_cols`` and the grid's m to
``lkgp.solve.grid_cols``.

Tracing is off by default, and then a site costs one flag check: no record,
no clock read, no host read. :func:`enable` switches it on for the process.
Spans are then kept in memory (at most :data:`MAX_RECORDS` records; the
per-name aggregates go on past that), each thread has its own stack of open
spans, durations come from ``time.perf_counter_ns()``, and :func:`spans`
gives their start and end on the Unix clock (ns) that ``torch.profiler``'s
host and device events use, through one anchor pair taken at
:func:`enable`. While a ``torch.profiler`` runs, each span also enters
``torch.profiler.record_function(name)``, so it lands on the profiler's
timeline too.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

from torch.autograd import profiler as _profiler

__all__ = ["span", "count", "request", "enable", "disable", "enabled",
           "reset", "snapshot", "spans", "MAX_RECORDS"]

MAX_RECORDS = 1 << 16

_on = False
_lock = threading.Lock()
_local = threading.local()          # .stack: open spans; .trace: request id
_ids = itertools.count(1)
_records: list = []
_totals: dict = {}                  # name -> [count, total_ns, self_ns]
_counters: dict = {}
_anchor = (0, 0)                    # (perf_counter_ns, time_ns) at enable()


class _Off:
    """What :func:`span` returns while tracing is off: enters as None."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "trace", "start",
                 "child_ns", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only once the span's work has run."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        if parent is not None:
            self.trace = parent.trace
        else:
            rid = getattr(_local, "trace", None)
            self.trace = f"span:{self.id}" if rid is None else rid
        self.child_ns = 0
        self._rf = None
        stack.append(self)
        # Stamped before the profiler's copy opens: its first entry in a
        # profile costs ~1 ms, most of it after the copy's own stamp.
        self.start = time.perf_counter_ns()
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        dur = end - self.start
        if stack:
            stack[-1].child_ns += dur
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        with _lock:
            agg = _totals.get(self.name)
            if agg is None:
                agg = _totals[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - self.child_ns
            if len(_records) < MAX_RECORDS:
                _records.append((self.name, self.start, end, self.id,
                                 self.parent, self.trace, self.attrs))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs):
    """A context manager timing ``name``: enters as the span (whose
    ``set(**attrs)`` adds attributes) while tracing is on, as None while it
    is off."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (nothing while tracing is off)."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def request(rid):
    """Spans opened inside (on this thread, outside any open span) share the
    trace id ``f"request:{rid}"``; a root span outside any request starts
    its own, ``f"span:{id}"``."""
    before = getattr(_local, "trace", None)
    _local.trace = f"request:{rid}"
    try:
        yield
    finally:
        _local.trace = before


def enable() -> None:
    """Switch tracing on, and anchor :func:`spans`' clock to the Unix clock."""
    global _on, _anchor
    p0 = time.perf_counter_ns()
    unix = time.time_ns()
    p1 = time.perf_counter_ns()
    _anchor = ((p0 + p1) // 2, unix)
    _on = True


def disable() -> None:
    """Switch tracing off; what was recorded stays until :func:`reset`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drop every record, aggregate and counter."""
    with _lock:
        _records.clear()
        _totals.clear()
        _counters.clear()


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_ns", "self_ns"}}, "counters":
    {name: value}}``; self time is a span's duration minus its child spans'."""
    with _lock:
        return {"spans": {k: {"count": c, "total_ns": t, "self_ns": s}
                          for k, (c, t, s) in _totals.items()},
                "counters": dict(_counters)}


def spans() -> list[dict]:
    """The kept records in the order they closed: name, start and end (Unix
    ns), id, parent id (None for a root), trace id and attrs."""
    perf0, unix0 = _anchor
    with _lock:
        recs = list(_records)
    return [{"name": name, "start_ns": unix0 + start - perf0,
             "end_ns": unix0 + end - perf0, "id": sid, "parent": parent,
             "trace": trace, "attrs": dict(attrs)}
            for name, start, end, sid, parent, trace, attrs in recs]
