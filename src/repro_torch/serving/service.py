"""Multi-tenant streaming prediction service over warm LKGP states.

Counterpart of ``repro.serving.service``. Request lifecycle per tenant/task
session:

* **cold fit** - the first ``observe`` fits a fresh :class:`LKGPState`
  (optionally coalesced across tenants via ``fit_batch``);
* **stream extend** - subsequent ``observe`` calls fold newly observed
  epochs in via ``extend`` (transforms refit, hyper-parameters carried as
  a warm start);
* **warm refit** - every ``refit_every``-th observation re-optimises
  hyper-parameters for a few L-BFGS steps from the warm start;
* **predict** - evaluates the exact batched posterior of the session's
  state. Repeated predictions on an unchanged session hit the state-keyed
  posterior cache (zero additional solves); any ``observe`` swaps the
  state object, which *is* the invalidation.

Predictions - served alone or coalesced across tenants through
:class:`~repro_torch.serving.batcher.CoalescingBatcher` - always run through
``posterior_batch``, which computes each task by itself, so a request's
results are bitwise identical whichever path served it, at every batch
size.

Every state of a service lives on ONE device, given to the constructor
(``None``: the GPU; without one the service raises). Every call - the batcher's and any tenant
thread's - passes that device down explicitly; nothing reads a thread's
current CUDA device.

Reliability: invalid payloads (non-finite observed values, out-of-grid
masks - :class:`~repro_torch.core.errors.ObservationError`) and exhausted
solver escalation (:class:`~repro_torch.core.solvers.guarded.GuardedSolveError`)
are **quarantined**, never propagated: the offending observation is
rejected, the session keeps serving from its last good state, and the event
lands in the service :class:`~repro_torch.serving.metrics.EventLog`. With
``checkpoint_dir`` set, the session store is periodically snapshotted
(:mod:`repro_torch.serving.checkpoint`) and
:meth:`PredictionService.restore` rebuilds warm sessions after a crash.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .._device import resolve_device
from ..core.engines import engine_cache_stats
from ..core.errors import ObservationError
from ..core.posterior import posterior_batch
from ..core.solvers.guarded import GuardedSolveError
from ..core.state import (LKGPConfig, compiled_cache_stats, extend, fit,
                          fit_batch, refit, stack_states, unstack)
from .batcher import CoalescingBatcher, coalesce_sessions
from .checkpoint import ObservationLog, ServiceCheckpointer
from .metrics import Counter, EventLog, LatencyRecorder
from .store import Session, SessionKey, SessionStore

__all__ = ["ServiceConfig", "Prediction", "PredictionService"]


@dataclass(frozen=True)
class ServiceConfig:
    """Service policy knobs (the GP itself is configured via ``gp``).

    ``gp.hyper_init`` / ``gp.polish_steps`` select the fit strategy for
    every session: the default host L-BFGS, or an amortized or default-init
    start polished by a fixed budget of steps (see
    :mod:`repro_torch.amortize` and :mod:`repro_torch.core.polish`).
    """

    gp: LKGPConfig = field(default_factory=LKGPConfig)
    capacity: int = 64            # LRU cap on resident sessions
    refit_every: int = 4          # warm refit every k-th observe (0 = never)
    refit_lbfgs_iters: int = 5    # L-BFGS budget of a warm refit (host path
    #                               only; ignored when gp.polish_steps >= 0)
    coalesce: bool = True         # allow cross-tenant fit coalescing
    checkpoint_dir: str | None = None   # None: durability off
    checkpoint_every: int = 8     # snapshot every k-th accepted observe
    checkpoint_keep: int = 3      # keep-K checkpoint GC


@dataclass(frozen=True)
class Prediction:
    """Final-progression prediction for every config of one task."""

    tenant: str
    task: str
    mean: np.ndarray        # (n,) final-epoch posterior mean, y units
    var: np.ndarray         # (n,) final-epoch predictive variance
    generation: int         # session generation that produced it
    batch_size: int         # how many requests shared the batched call


class PredictionService:
    """Thread-safe front door: ``observe`` / ``predict`` / ``flush``.

    Every session's state lives on ``device`` (``None``: the GPU), resolved
    once, here.
    """

    def __init__(self, config: ServiceConfig | None = None, *,
                 device=None) -> None:
        self.config = config or ServiceConfig()
        self.device = resolve_device(device)
        self.store = SessionStore(capacity=self.config.capacity)
        self.batcher = CoalescingBatcher(self._execute_group)
        self.predict_latency = LatencyRecorder()
        self.observe_latency = LatencyRecorder()
        self.events = EventLog()
        self.obs_log = ObservationLog()
        self.checkpointer: ServiceCheckpointer | None = None
        if self.config.checkpoint_dir is not None:
            self.checkpointer = ServiceCheckpointer(
                self.config.checkpoint_dir, keep=self.config.checkpoint_keep,
                device=self.device)
        self.counters = {
            "predicts": Counter(),
            "observes": Counter(),
            "cold_fits": Counter(),
            "extends": Counter(),
            "refits": Counter(),
            "coalesced_groups": Counter(),
            "coalesced_requests": Counter(),
            "quarantined": Counter(),
            "checkpoints": Counter(),
            "restores": Counter(),
        }

    # -- observation path --------------------------------------------------
    def observe(self, tenant: str, task: str, Y, mask,
                X=None, t=None) -> dict:
        """Stream observations into a session; creates it on first call.

        First call for a key must carry the task's configs ``X`` (n, d)
        and progression grid ``t`` (m,) alongside the initial observed
        grids ``Y`` / ``mask`` (n, m) - a cold fit. Later calls pass the
        *full updated* ``Y`` / ``mask`` over the same grid (``mask`` a
        superset of what the session has seen) - an ``extend`` plus, every
        ``refit_every``-th time, a warm ``refit``.

        Invalid payloads and exhausted solver escalation are quarantined:
        the call returns ``action="quarantined"`` (with the error message),
        the session - if one exists - keeps serving from its last good
        state, and the event is recorded. Nothing is raised; a misbehaving
        tenant cannot take the service down.
        """
        start = time.perf_counter()
        key = SessionKey(tenant, task)
        session = self.store.get(key)
        try:
            if session is None:
                if X is None or t is None:
                    raise KeyError(
                        f"unknown session {key}: the first observe must "
                        "include X and t for the cold fit")
                state = fit(X, t, Y, mask, self.config.gp,
                            device=self.device)
                session = self.store.put(key, state)
                action = "fit"
                self.counters["cold_fits"].inc()
            else:
                with session.lock:
                    # Build the candidate state FULLY before touching any
                    # session field: an ObservationError / exhausted
                    # escalation below leaves the session exactly as it
                    # was (last good state keeps serving).
                    state = extend(session.state, Y, mask)
                    session.observes += 1
                    action = "extend"
                    self.counters["extends"].inc()
                    every = self.config.refit_every
                    if every > 0 and session.observes % every == 0:
                        state = refit(
                            state, lbfgs_iters=self.config.refit_lbfgs_iters)
                        action = "extend+refit"
                        self.counters["refits"].inc()
                    session.swap_state(state)
        except (ObservationError, GuardedSolveError) as e:
            self.counters["quarantined"].inc()
            self.events.record(
                "quarantine", tenant=tenant, task=task,
                error=type(e).__name__, detail=str(e))
            self.observe_latency.record(time.perf_counter() - start)
            return {"tenant": tenant, "task": task, "action": "quarantined",
                    "error": str(e),
                    "generation": session.generation if session else -1}
        self.counters["observes"].inc()
        self.obs_log.append(tenant, task, action)
        self._maybe_checkpoint()
        self.observe_latency.record(time.perf_counter() - start)
        return {"tenant": tenant, "task": task, "action": action,
                "generation": session.generation}

    def observe_batch(self, requests: Sequence[dict]) -> list[dict]:
        """Coalesced cold fits: one ``fit_batch`` for same-shape new tasks.

        Each request is the kwargs of :meth:`observe` (with ``tenant`` /
        ``task``). Requests for *new* sessions whose shapes match are
        jointly fitted in one ``fit_batch`` (the exact ``dense`` objective);
        everything else falls back to per-request :meth:`observe`. With the
        default host L-BFGS (``gp.polish_steps == -1``) the joint fit shares
        the line search across tasks, so hyper-parameters may differ
        slightly from an individual fit; with ``gp.polish_steps >= 0`` every
        task runs the single-task polish and the coalesced results are
        bitwise those of individual observes on the ``dense`` engine.
        """
        out: list[dict | None] = [None] * len(requests)
        cold: dict[tuple, list[int]] = {}
        for i, req in enumerate(requests):
            key = SessionKey(req["tenant"], req["task"])
            is_cold = (self.config.coalesce and key not in self.store
                       and req.get("X") is not None
                       and req.get("t") is not None)
            if is_cold:
                sig = (np.shape(req["X"]), np.shape(req["t"]),
                       np.shape(req["Y"]))
                cold.setdefault(sig, []).append(i)
            else:
                out[i] = self.observe(**req)
        for indices in cold.values():
            if len(indices) == 1:
                i = indices[0]
                out[i] = self.observe(**requests[i])
                continue
            start = time.perf_counter()
            group = [requests[i] for i in indices]
            X = np.stack([np.asarray(r["X"]) for r in group])
            t = np.stack([np.asarray(r["t"]) for r in group])
            Y = np.stack([np.asarray(r["Y"]) for r in group])
            mask = np.stack([np.asarray(r["mask"]) for r in group])
            try:
                batched = fit_batch(X, t, Y, mask, self.config.gp,
                                    device=self.device)
            except ObservationError:
                # One poisoned payload must not sink the whole coalesced
                # group: fall back to per-request observes, which fit the
                # healthy ones and quarantine the offender individually.
                for i in indices:
                    out[i] = self.observe(**requests[i])
                continue
            states = unstack(batched)
            self.counters["coalesced_groups"].inc()
            self.counters["coalesced_requests"].inc(len(group))
            for i, state in zip(indices, states):
                req = requests[i]
                key = SessionKey(req["tenant"], req["task"])
                session = self.store.put(key, state)
                self.counters["cold_fits"].inc()
                self.counters["observes"].inc()
                self.obs_log.append(req["tenant"], req["task"], "fit_batch")
                out[i] = {"tenant": req["tenant"], "task": req["task"],
                          "action": "fit_batch",
                          "generation": session.generation}
            self._maybe_checkpoint()
            self.observe_latency.record(time.perf_counter() - start)
        return [r for r in out if r is not None]

    # -- durability --------------------------------------------------------
    def _maybe_checkpoint(self) -> None:
        every = self.config.checkpoint_every
        if (self.checkpointer is not None and every > 0
                and self.counters["observes"].value % every == 0):
            self.checkpoint()

    def checkpoint(self) -> int | None:
        """Snapshot every resident session (+ observation log) durably.

        Returns the checkpoint step, or None when durability is off
        (``checkpoint_dir`` unset). Sessions are snapshotted under their
        own locks; the write is atomic (temp dir + rename).
        """
        if self.checkpointer is None:
            return None
        step = self.checkpointer.save(list(self.store.sessions()),
                                      self.obs_log)
        self.counters["checkpoints"].inc()
        self.events.record("checkpoint", step=step, sessions=len(self.store))
        return step

    def restore(self, step: int | None = None) -> int:
        """Rebuild warm sessions from the latest (or given) checkpoint.

        Reinstalls every checkpointed session into the store, on the
        service's device, with its state, ``generation`` and ``observes``
        intact - a restored session serves predictions immediately, bitwise
        identical to the moment it was snapshotted. Also adopts the
        checkpointed observation log so sequence numbers keep increasing
        monotonically across the crash. Returns the number of sessions
        restored.
        """
        if self.checkpointer is None:
            raise RuntimeError("durability is off: ServiceConfig."
                               "checkpoint_dir is not set")
        metas, states, extra = self.checkpointer.load(step)
        for meta, state in zip(metas, states):
            key = SessionKey(meta["tenant"], meta["task"])
            session = self.store.put(key, state)
            session.generation = int(meta["generation"])
            session.observes = int(meta["observes"])
        self.obs_log.load(extra.get("obs_log", []),
                          extra.get("next_seq", 0))
        self.counters["restores"].inc()
        self.events.record("restore", sessions=len(metas),
                           next_seq=self.obs_log.next_seq)
        return len(metas)

    # -- prediction path ---------------------------------------------------
    def _session(self, tenant: str, task: str) -> Session:
        session = self.store.get(SessionKey(tenant, task))
        if session is None:
            raise KeyError(f"no session for {(tenant, task)}; observe first")
        return session

    def _finalize(self, session: Session, mean_row: np.ndarray,
                  var_row: np.ndarray, batch_size: int) -> Prediction:
        return Prediction(
            tenant=session.key.tenant, task=session.key.task,
            mean=mean_row, var=var_row,
            generation=session.generation, batch_size=batch_size)

    def _execute_group(self, group: list[Session]) -> list[Prediction]:
        """One batched posterior evaluation for a stackable session group."""
        if len(group) == 1:
            # A group of one reuses the session's cached stacked view so a
            # repeat request hits the state-keyed posterior cache.
            stacked = group[0].stacked()
        else:
            stacked = stack_states([s.state for s in group])
            self.counters["coalesced_groups"].inc()
            self.counters["coalesced_requests"].inc(len(group))
        bp = posterior_batch(stacked, device=self.device)
        # Warm requests re-read host arrays: the numpy conversion of the
        # default final() is cached on the batched posterior, whose own
        # lifetime is the state's - invalidation stays object replacement.
        final_np = getattr(bp, "_final_np", None)
        if final_np is None:
            mean, var = bp.final()
            final_np = (mean.cpu().numpy(), var.cpu().numpy())
            bp._final_np = final_np
        mean_np, var_np = final_np
        return [self._finalize(s, mean_np[i], var_np[i], len(group))
                for i, s in enumerate(group)]

    def predict(self, tenant: str, task: str) -> Prediction:
        """Final-value prediction for one session (batch of one)."""
        start = time.perf_counter()
        session = self._session(tenant, task)
        result = self._execute_group([session])[0]
        self.counters["predicts"].inc()
        self.predict_latency.record(time.perf_counter() - start)
        return result

    def predict_many(self, keys: Sequence[tuple[str, str]]) -> list[Prediction]:
        """Coalesced predictions: stackable sessions share one batched call.

        Results are bitwise identical to per-request :meth:`predict`: both
        paths run ``posterior_batch``, which computes every task by itself.
        """
        start = time.perf_counter()
        sessions = [self._session(tenant, task) for tenant, task in keys]
        out: list[Prediction | None] = [None] * len(sessions)
        for indices in coalesce_sessions(sessions):
            results = self._execute_group([sessions[i] for i in indices])
            for i, result in zip(indices, results):
                out[i] = result
        self.counters["predicts"].inc(len(keys))
        self.predict_latency.record(time.perf_counter() - start)
        return [r for r in out if r is not None]

    def submit_predict(self, tenant: str, task: str):
        """Async surface: enqueue a request, resolved at :meth:`flush`."""
        return self.batcher.submit(self._session(tenant, task))

    def flush(self) -> int:
        """Resolve all queued :meth:`submit_predict` futures, coalesced."""
        return self.batcher.flush()

    # -- introspection -----------------------------------------------------
    def metrics(self) -> dict:
        return {
            "store": self.store.stats(),
            "predict_latency": self.predict_latency.snapshot(),
            "observe_latency": self.observe_latency.snapshot(),
            "counters": {k: c.value for k, c in self.counters.items()},
            "events": self.events.snapshot(),
            # process-wide objective / engine LRU caches the fit/refit path
            # runs on - a hot service should show hits >> misses and zero
            # evictions; evictions here mean rebuilt objectives.
            "compiled_caches": {**compiled_cache_stats(),
                                "engines": engine_cache_stats()},
        }
