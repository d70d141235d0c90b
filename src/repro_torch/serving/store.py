"""Per-tenant session store: warm ``LKGPState``s behind an LRU cap.

Counterpart of ``repro.serving.store``. A :class:`Session` owns one task's
fitted state plus everything derived from it: a monotonically increasing
``generation`` (bumped on every state swap) and the lazily built
single-task *stacked* view the prediction path evaluates through. Swapping
the state via :meth:`Session.swap_state` clears the stacked view, and
because the posterior cache lives on the state object itself
(:mod:`repro_torch.core.posterior`), dropping the old state is what
invalidates its cached solves - a warm posterior can never serve
pre-``extend`` results.

The :class:`SessionStore` is an ``OrderedDict``-based LRU: ``get`` marks
recency, inserting past ``capacity`` evicts the least-recently-used
session (state, stacked view, and attached posterior cache all go with
it). All store operations are guarded by one lock; per-session mutation is
guarded by the session's own re-entrant lock so tenants stream
observations concurrently without serialising on the store.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Iterator, NamedTuple

from ..core.state import LKGPState, stack_states

__all__ = ["SessionKey", "Session", "SessionStore"]


class SessionKey(NamedTuple):
    """Identity of one streamed learning-curve task."""
    tenant: str
    task: str


@dataclass
class Session:
    """One tenant/task's warm state and its derived prediction view."""

    key: SessionKey
    state: LKGPState
    generation: int = 0
    observes: int = 0
    created_at: float = field(default_factory=time.monotonic)
    lock: threading.RLock = field(default_factory=threading.RLock)
    _stacked: LKGPState | None = field(default=None, repr=False)

    def swap_state(self, state: LKGPState) -> None:
        """Install a new state (post ``extend``/``refit``) atomically.

        Bumps ``generation`` and drops the stacked prediction view; the
        old state object - and with it every posterior cached on it -
        becomes unreachable from the session.
        """
        with self.lock:
            self.state = state
            self.generation += 1
            self._stacked = None

    def stacked(self) -> LKGPState:
        """Batch-of-one view of the state, cached until the next swap.

        Predictions always evaluate through the batched posterior, which
        computes each task alone, so a request served alone and the same
        request served inside a coalesced batch give the same bits. Caching
        the view keeps repeated predictions hitting the SAME stacked state
        object, i.e. the state-keyed posterior cache.
        """
        with self.lock:
            if self._stacked is None:
                self._stacked = stack_states([self.state])
            return self._stacked


class SessionStore:
    """LRU map of :class:`SessionKey` to :class:`Session`."""

    def __init__(self, capacity: int = 64) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._sessions: OrderedDict[SessionKey, Session] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: SessionKey) -> Session | None:
        with self._lock:
            session = self._sessions.get(key)
            if session is None:
                self.misses += 1
                return None
            self._sessions.move_to_end(key)
            self.hits += 1
            return session

    def put(self, key: SessionKey, state: LKGPState) -> Session:
        """Install a fresh session (cold fit), evicting LRU past capacity."""
        session = Session(key=key, state=state)
        with self._lock:
            self._sessions[key] = session
            self._sessions.move_to_end(key)
            while len(self._sessions) > self.capacity:
                self._sessions.popitem(last=False)
                self.evictions += 1
            return session

    def drop(self, key: SessionKey) -> bool:
        with self._lock:
            return self._sessions.pop(key, None) is not None

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def __contains__(self, key: SessionKey) -> bool:
        with self._lock:
            return key in self._sessions

    def keys(self) -> list[SessionKey]:
        """Keys, least- to most-recently-used."""
        with self._lock:
            return list(self._sessions)

    def sessions(self) -> Iterator[Session]:
        with self._lock:
            return iter(list(self._sessions.values()))

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._sessions),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
