"""Cross-tenant request coalescing.

Counterpart of ``repro.serving.batcher``. Independent tenants' prediction
requests can share ONE batched posterior evaluation when their states are
stackable: identical ``LKGPConfig`` and identical data shapes (progression
*values* may differ per task - the grid is data, not metadata).
:func:`coalesce_sessions` partitions a request list into maximal stackable
groups while preserving within-group request order.

:class:`CoalescingBatcher` is the async surface over the same idea:
``submit`` enqueues a request and returns a ``Future``; ``flush`` drains
the queue, groups it, hands each group to the executor callback (the
service's batched-posterior evaluation), and resolves the futures. A
group whose execution raises fails only that group's futures.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Callable, Hashable, Sequence

from .store import Session

__all__ = ["stack_signature", "coalesce_sessions", "CoalescingBatcher"]


def stack_signature(session: Session) -> Hashable:
    """Hashable compatibility key: sessions with equal keys can be stacked.

    ``LKGPConfig`` is frozen (hash by value), so equal configs + equal
    tensor shapes is exactly the precondition of
    :func:`repro_torch.core.state.stack_states`.
    """
    st = session.state
    return (st.config, tuple(st.X.shape), tuple(st.t.shape),
            tuple(st.Y.shape))


def coalesce_sessions(
        sessions: Sequence[Session]) -> list[list[int]]:
    """Partition request indices into stackable groups (order-preserving)."""
    groups: dict[Hashable, list[int]] = {}
    for i, session in enumerate(sessions):
        groups.setdefault(stack_signature(session), []).append(i)
    return list(groups.values())


class CoalescingBatcher:
    """Queue of pending requests resolved in coalesced batches.

    ``execute`` receives a same-signature list of sessions and must return
    one result per session, in order.
    """

    def __init__(self, execute: Callable[[list[Session]], list[Any]]) -> None:
        self._execute = execute
        self._lock = threading.Lock()
        self._pending: list[tuple[Session, Future]] = []

    def submit(self, session: Session) -> "Future[Any]":
        """Enqueue a prediction request; resolved at the next ``flush``."""
        future: "Future[Any]" = Future()
        with self._lock:
            self._pending.append((session, future))
        return future

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def flush(self) -> int:
        """Drain the queue; returns the number of requests resolved."""
        with self._lock:
            batch = self._pending
            self._pending = []
        if not batch:
            return 0
        sessions = [session for session, _ in batch]
        for indices in coalesce_sessions(sessions):
            group = [sessions[i] for i in indices]
            try:
                results = self._execute(group)
            except Exception as exc:  # noqa: BLE001 - fail only this group
                for i in indices:
                    batch[i][1].set_exception(exc)
                continue
            if len(results) != len(indices):
                err = RuntimeError(
                    f"executor returned {len(results)} results for "
                    f"{len(indices)} requests")
                for i in indices:
                    batch[i][1].set_exception(err)
                continue
            for i, result in zip(indices, results):
                batch[i][1].set_result(result)
        return len(batch)
