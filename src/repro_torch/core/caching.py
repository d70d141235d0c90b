"""A small instrumented LRU cache for objective and engine singletons.

Counterpart of ``repro.core.caching`` (a copy: the port imports nothing of
the reference). Both objective caches (``state._VG_CACHE`` /
``state._POLISH_CACHE``) and the engine singleton map
(``engines._ENGINE_SINGLETONS``) hold objects that are keyed by identity
elsewhere: a refit of the same shape must find the objective and the engine
it used before. This class bounds them with true LRU eviction and exposes
hit/miss/eviction counters so cache health is observable.

The interface is deliberately dict-like (``get`` / ``[]`` / ``len`` /
``items`` / ``clear``). Every operation holds the cache's own lock: the
serving layer's tenant threads look the objectives up concurrently, and an
unguarded ``get`` could refresh a key another thread has just evicted.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Iterator

__all__ = ["LRUCache"]


class LRUCache:
    """Bounded mapping with least-recently-used eviction and counters.

    ``get`` / ``__getitem__`` count hits and misses and refresh recency on
    hit (``in`` probes neither); inserting past ``maxsize`` evicts the least
    recently used entry and counts an eviction. ``clear`` drops entries but
    keeps the counters (they describe the cache's lifetime, not its
    contents). Thread-safe: each method is atomic under one re-entrant lock.
    """

    def __init__(self, maxsize: int) -> None:
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._data: OrderedDict[Any, Any] = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Any, default: Any = None) -> Any:
        with self._lock:
            try:
                value = self._data[key]
            except KeyError:
                self.misses += 1
                return default
            self.hits += 1
            self._data.move_to_end(key)
            return value

    def __getitem__(self, key: Any) -> Any:
        with self._lock:
            if key not in self._data:
                self.misses += 1
                raise KeyError(key)
            return self.get(key)

    def __setitem__(self, key: Any, value: Any) -> None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __iter__(self) -> Iterator[Any]:
        with self._lock:
            return iter(list(self._data))

    def items(self):
        with self._lock:
            return list(self._data.items())

    def pop(self, key: Any, *default: Any) -> Any:
        with self._lock:
            return self._data.pop(key, *default)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def stats(self) -> dict:
        """Counters + occupancy as a plain dict (JSON-friendly)."""
        with self._lock:
            return {"size": len(self._data), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}
