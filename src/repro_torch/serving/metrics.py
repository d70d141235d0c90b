"""Lightweight, dependency-free service metrics.

Counterpart of ``repro.serving.metrics`` (a copy: the port imports nothing
of the reference). A :class:`LatencyRecorder` keeps a bounded window of
samples and reports percentiles over it; :class:`Counter` is a thread-safe
monotonic counter; :class:`EventLog` is a bounded structured log of notable
service events (quarantined observations, escalated solves,
checkpoint/restore activity). All expose ``snapshot()`` dicts that the
service aggregates into one metrics payload.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

__all__ = ["LatencyRecorder", "Counter", "EventLog", "percentile"]


def percentile(sorted_values: list[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted list."""
    if not sorted_values:
        return 0.0
    if len(sorted_values) == 1:
        return sorted_values[0]
    pos = (q / 100.0) * (len(sorted_values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = pos - lo
    return sorted_values[lo] * (1.0 - frac) + sorted_values[hi] * frac


class Counter:
    """Thread-safe monotonic counter."""

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, by: int = 1) -> None:
        with self._lock:
            self._value += by

    @property
    def value(self) -> int:
        return self._value


class EventLog:
    """Bounded, thread-safe structured event log.

    The reliability layer records one entry per notable event — a
    quarantined observation, an escalated solve, a checkpoint written, a
    restore — as a plain dict (``kind`` + free-form fields + monotonic
    ``seq`` + wall-clock ``time``). Bounded so a misbehaving tenant cannot
    grow service memory without limit; ``count(kind)`` stays exact over the
    process lifetime even after old entries roll off the window.
    """

    def __init__(self, window: int = 4096) -> None:
        self._events: deque[dict] = deque(maxlen=window)
        self._counts: dict[str, int] = {}
        self._seq = 0
        self._lock = threading.Lock()

    def record(self, kind: str, **fields: Any) -> dict:
        with self._lock:
            event = {"kind": kind, "seq": self._seq, "time": time.time(),
                     **fields}
            self._seq += 1
            self._events.append(event)
            self._counts[kind] = self._counts.get(kind, 0) + 1
        return event

    def count(self, kind: str) -> int:
        """Total events of ``kind`` recorded (not bounded by the window)."""
        with self._lock:
            return self._counts.get(kind, 0)

    def snapshot(self) -> dict:
        """Per-kind totals plus the most recent window of events."""
        with self._lock:
            return {"counts": dict(self._counts),
                    "recent": [dict(e) for e in self._events]}


class LatencyRecorder:
    """Bounded sliding window of latencies (seconds) with percentiles."""

    def __init__(self, window: int = 8192) -> None:
        self._samples: deque[float] = deque(maxlen=window)
        self._lock = threading.Lock()
        self._count = 0

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self._count += 1

    def snapshot(self) -> dict:
        """count plus p50/p99/mean in milliseconds over the window."""
        with self._lock:
            values = sorted(self._samples)
            count = self._count
        if not values:
            return {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
        return {
            "count": count,
            "p50_ms": 1e3 * percentile(values, 50.0),
            "p99_ms": 1e3 * percentile(values, 99.0),
            "mean_ms": 1e3 * sum(values) / len(values),
        }
