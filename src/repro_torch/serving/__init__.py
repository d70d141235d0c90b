"""Multi-tenant streaming prediction service (counterpart of
``repro.serving``).

Layered store -> batcher -> service:

* :mod:`~repro_torch.serving.store`   - :class:`SessionStore`, an LRU of
  warm per-tenant/task :class:`~repro_torch.core.state.LKGPState` sessions;
* :mod:`~repro_torch.serving.batcher` - cross-tenant request coalescing into
  stackable groups, plus the Future-based async surface;
* :mod:`~repro_torch.serving.service` - :class:`PredictionService`: cold
  fit / stream ``extend`` / warm ``refit`` lifecycle, per-request and
  coalesced prediction through one batched posterior, metrics;
* :mod:`~repro_torch.serving.metrics` - latency percentiles, counters, and
  the structured :class:`EventLog` the reliability layer records into;
* :mod:`~repro_torch.serving.checkpoint` - session durability: periodic
  :class:`ServiceCheckpointer` snapshots of the store + observation log
  (the reference's file layout), and the template-based restore behind
  ``PredictionService.restore()``.

Cache semantics in one line: solves are cached on the state object
(:mod:`repro_torch.core.posterior`), sessions cache their stacked prediction
view, and every ``observe`` swaps the state - so invalidation is object
replacement, never bookkeeping. A service's states live on the one device
it is given (``None``: the GPU).
"""
from .batcher import CoalescingBatcher, coalesce_sessions, stack_signature
from .checkpoint import ObservationLog, ServiceCheckpointer, state_template
from .metrics import Counter, EventLog, LatencyRecorder
from .service import Prediction, PredictionService, ServiceConfig
from .store import Session, SessionKey, SessionStore

__all__ = [
    "PredictionService", "ServiceConfig", "Prediction",
    "SessionStore", "SessionKey", "Session",
    "CoalescingBatcher", "coalesce_sessions", "stack_signature",
    "LatencyRecorder", "Counter", "EventLog",
    "ObservationLog", "ServiceCheckpointer", "state_template",
]
