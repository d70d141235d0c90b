"""PyTorch port, the prediction service (``repro_torch.serving``), its
checkpoints (``repro_torch.checkpoint``) and the serving fault injectors.

The reference's serving suite (``tests/test_serving.py``) and the service
tests of its reliability suite (``tests/test_reliability.py``) in the port's
form, on the CPU; then the port held against the reference: the same traffic
through both services gives the same predictions (1e-6 relative on the
dense float64 route), a checkpoint either service writes restores in the
other with the writer's predictions, and the checkpoint manager keeps the
reference's file layout, keep-K and atomic publish.
"""
import jax

jax.config.update("jax_enable_x64", True)

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.serving as ref_serving  # noqa: E402
import repro.testing as ref_testing  # noqa: E402
from repro.checkpoint.manager import _flatten as ref_flatten  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import _flatten  # noqa: E402
from repro_torch.core import (GuardedSolveError, LKGPConfig,  # noqa: E402
                              LRUCache)
from repro_torch.data import sample_task  # noqa: E402
from repro_torch.serving import (CoalescingBatcher, EventLog,  # noqa: E402
                                 PredictionService, ServiceConfig,
                                 SessionKey, SessionStore, coalesce_sessions,
                                 state_template)
from repro_torch.testing import (FaultSchedule, crash_and_restore,  # noqa: E402
                                 evict_session, poison_nan)

CPU = "cpu"
GP = LKGPConfig(lbfgs_iters=5, backend="dense")
# Predictions of the two services on the same traffic, relative to
# max|value|: both fit by host L-BFGS on the dense float64 objective.
PARITY_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes are tiny and the suite's workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_service(tenants, n=6, m=8, capacity=None, refit_every=2,
                 coalesce=True):
    svc = PredictionService(ServiceConfig(
        gp=GP, capacity=capacity or max(len(tenants), 1),
        refit_every=refit_every, refit_lbfgs_iters=2, coalesce=coalesce),
        device=CPU)
    tasks = {name: sample_task(seed=i, n=n, m=m, d=4)
             for i, name in enumerate(tenants)}
    svc.observe_batch([
        dict(tenant=name, task="run", X=tk.X, t=tk.t, Y=tk.Y, mask=tk.mask)
        for name, tk in tasks.items()])
    return svc, tasks


def grow_mask(mask):
    mask = np.asarray(mask).copy()
    for i in range(mask.shape[0]):
        k = int(mask[i].sum())
        if k < mask.shape[1]:
            mask[i, k] = 1.0
    return mask


def _grow(Y, mask, value=0.5):
    """One more observed epoch per row (a healthy extend payload)."""
    Y, mask = np.array(Y), np.array(mask)
    for row in range(mask.shape[0]):
        k = int(mask[row].sum())
        if k < mask.shape[1]:
            mask[row, k] = 1.0
            Y[row, k] = value
    return Y, mask


# --------------------------------------------------------------------------
# tests/test_serving.py, in the port's form
# --------------------------------------------------------------------------
def test_cold_fit_requires_x_and_t():
    svc = PredictionService(ServiceConfig(gp=GP), device=CPU)
    tk = sample_task(seed=0, n=6, m=8, d=4)
    with pytest.raises(KeyError, match="first observe"):
        svc.observe("t0", "run", tk.Y, tk.mask)
    with pytest.raises(KeyError, match="observe first"):
        svc.predict("t0", "run")
    info = svc.observe("t0", "run", tk.Y, tk.mask, X=tk.X, t=tk.t)
    assert info["action"] == "fit"
    pred = svc.predict("t0", "run")
    assert pred.mean.shape == (6,) and np.all(np.isfinite(pred.mean))
    assert np.all(pred.var > 0)
    st = svc.store.get(SessionKey("t0", "run")).state
    assert st.device == torch.device("cpu")


def test_observe_batch_coalesces_cold_fits():
    svc, _ = make_service([f"t{i}" for i in range(4)])
    assert svc.counters["cold_fits"].value == 4
    assert svc.counters["coalesced_groups"].value == 1
    assert svc.counters["coalesced_requests"].value == 4
    assert len(svc.store) == 4


def test_coalesced_predictions_match_per_request_bitwise():
    names = [f"t{i}" for i in range(4)]
    svc, _ = make_service(names)
    singles = {name: svc.predict(name, "run") for name in names}
    coalesced = svc.predict_many([(name, "run") for name in names])
    assert coalesced[0].batch_size == 4
    for p in coalesced:
        assert np.array_equal(singles[p.tenant].mean, p.mean)
        assert np.array_equal(singles[p.tenant].var, p.var)


def test_mixed_shapes_coalesce_into_separate_groups():
    svc = PredictionService(ServiceConfig(gp=GP, capacity=8), device=CPU)
    small = sample_task(seed=0, n=5, m=8, d=4)
    big = sample_task(seed=1, n=6, m=8, d=4)
    svc.observe("a", "run", small.Y, small.mask, X=small.X, t=small.t)
    svc.observe("b", "run", big.Y, big.mask, X=big.X, t=big.t)
    svc.observe("c", "run", small.Y, small.mask, X=small.X, t=small.t)
    preds = svc.predict_many([(t, "run") for t in ("a", "b", "c")])
    by_tenant = {p.tenant: p for p in preds}
    assert by_tenant["a"].batch_size == 2       # a + c stack together
    assert by_tenant["c"].batch_size == 2
    assert by_tenant["b"].batch_size == 1
    assert by_tenant["a"].mean.shape == (5,)
    assert by_tenant["b"].mean.shape == (6,)
    # ... and each row still matches its per-request prediction bitwise.
    assert np.array_equal(svc.predict("a", "run").mean, by_tenant["a"].mean)


def test_observe_invalidates_warm_predictions():
    svc, tasks = make_service(["t0"], refit_every=0)
    tk = tasks["t0"]
    before = svc.predict("t0", "run")
    old_state = svc.store.get(SessionKey("t0", "run")).state

    mask2 = grow_mask(tk.mask)
    Y2 = np.where(mask2 > 0, np.asarray(tk.Y_full), 0.0)
    info = svc.observe("t0", "run", Y2, mask2)
    assert info["action"] == "extend"

    session = svc.store.get(SessionKey("t0", "run"))
    assert session.state is not old_state
    after = svc.predict("t0", "run")
    assert after.generation == before.generation + 1
    # New observations actually entered the served posterior.
    assert not np.array_equal(before.mean, after.mean)
    # Repeats on the unchanged new state are stable (cache, not staleness).
    again = svc.predict("t0", "run")
    assert np.array_equal(after.mean, again.mean)
    assert np.array_equal(after.var, again.var)


def test_refit_every_triggers_warm_refit():
    svc, tasks = make_service(["t0"], refit_every=2)
    tk = tasks["t0"]
    mask = tk.mask
    actions = []
    for _ in range(4):
        mask = grow_mask(mask)
        Y = np.where(mask > 0, np.asarray(tk.Y_full), 0.0)
        actions.append(svc.observe("t0", "run", Y, mask)["action"])
    assert actions == ["extend", "extend+refit", "extend", "extend+refit"]
    assert svc.counters["refits"].value == 2
    # refit re-derives fit metadata on the session's state.
    st = svc.store.get(SessionKey("t0", "run")).state
    assert st.fit_result is not None and st.backend_used is not None


def test_lru_eviction():
    names = [f"t{i}" for i in range(3)]
    svc, tasks = make_service(names, capacity=2, coalesce=False)
    stats = svc.store.stats()
    assert stats["size"] == 2 and stats["evictions"] == 1
    assert SessionKey("t0", "run") not in svc.store   # LRU went first
    with pytest.raises(KeyError):
        svc.predict("t0", "run")
    # Touching t1 makes t2 the LRU victim for the next insert.
    svc.predict("t1", "run")
    tk = tasks["t0"]
    svc.observe("t0", "run", tk.Y, tk.mask, X=tk.X, t=tk.t)
    assert SessionKey("t1", "run") in svc.store
    assert SessionKey("t2", "run") not in svc.store


def test_session_store_validation_and_stats():
    with pytest.raises(ValueError):
        SessionStore(capacity=0)
    store = SessionStore(capacity=2)
    assert store.get(SessionKey("a", "b")) is None
    assert store.stats()["misses"] == 1
    assert len(store) == 0


def test_concurrent_tenants_are_isolated():
    names = [f"t{i}" for i in range(4)]
    svc, tasks = make_service(names, refit_every=0)
    reference = {name: svc.predict(name, "run") for name in names}
    rounds = 4
    errors = []
    results = {name: [] for name in names}

    def worker(name):
        try:
            tk = tasks[name]
            mask = tk.mask
            for _ in range(rounds):
                mask = grow_mask(mask)
                Y = np.where(mask > 0, np.asarray(tk.Y_full), 0.0)
                svc.observe(name, "run", Y, mask)
                results[name].append(svc.predict(name, "run"))
        except Exception as e:  # noqa: BLE001 - surface to the main thread
            errors.append((name, e))

    threads = [threading.Thread(target=worker, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors

    for name in names:
        preds = results[name]
        assert [p.generation for p in preds] == list(
            range(reference[name].generation + 1,
                  reference[name].generation + rounds + 1))
        assert all(p.tenant == name for p in preds)
        # Concurrency must not leak another tenant's solves into this
        # session: replaying the same final state serially reproduces the
        # last concurrent prediction bitwise.
        assert np.array_equal(svc.predict(name, "run").mean, preds[-1].mean)
        st = svc.store.get(SessionKey(name, "run")).state
        assert st.device == svc.device


def test_async_submit_flush():
    names = [f"t{i}" for i in range(3)]
    svc, _ = make_service(names)
    futures = [svc.submit_predict(name, "run") for name in names]
    assert svc.batcher.pending() == 3
    assert not futures[0].done()
    assert svc.flush() == 3
    assert svc.batcher.pending() == 0
    results = [f.result(timeout=1) for f in futures]
    assert all(r.batch_size == 3 for r in results)
    singles = {name: svc.predict(name, "run") for name in names}
    for r in results:
        assert np.array_equal(singles[r.tenant].mean, r.mean)
    assert svc.flush() == 0                      # idempotent when drained


def test_batcher_isolates_group_failures(monkeypatch):
    calls = []

    def execute(group):
        calls.append(len(group))
        if len(group) == 1:
            raise RuntimeError("boom")
        return [f"ok-{s}" for s in group]

    batcher = CoalescingBatcher(execute)

    class FakeSession:
        def __init__(self, sig):
            self._sig = sig

    import repro_torch.serving.batcher as batcher_mod
    monkeypatch.setattr(batcher_mod, "stack_signature", lambda s: s._sig)
    good = [FakeSession("a"), FakeSession("a")]
    bad = FakeSession("b")
    futs = [batcher.submit(s) for s in [good[0], bad, good[1]]]
    assert batcher.flush() == 3
    assert sorted(calls) == [1, 2]
    assert futs[0].result(timeout=1) == f"ok-{good[0]}"
    assert futs[2].result(timeout=1) == f"ok-{good[1]}"
    with pytest.raises(RuntimeError, match="boom"):
        futs[1].result(timeout=1)
    assert coalesce_sessions([]) == []


def test_metrics_shape():
    svc, _ = make_service(["t0", "t1"])
    svc.predict("t0", "run")
    m = svc.metrics()
    assert set(m) == {"store", "predict_latency", "observe_latency",
                      "counters", "events", "compiled_caches"}
    assert m["counters"]["predicts"] == 1
    assert m["counters"]["observes"] == 2
    assert m["predict_latency"]["count"] == 1
    assert m["store"]["size"] == 2
    for cache in ("fit_vg", "polish", "engines"):
        stats = m["compiled_caches"][cache]
        assert {"size", "maxsize", "hits", "misses",
                "evictions"} <= set(stats)


def test_solve_tally_is_thread_safe():
    """The engine solve tally is bumped from every tenant thread; hammer it
    from many threads with an aggressive switch interval and require an
    EXACT count."""
    from repro_torch.core import engines

    n_threads, n_bumps = 8, 2000
    before = engines.solve_tally()
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def hammer():
            for _ in range(n_bumps):
                engines._bump_tally()

        threads = [threading.Thread(target=hammer)
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old_interval)
    assert engines.solve_tally() - before == n_threads * n_bumps


def test_objective_caches_are_thread_safe():
    """The objective and engine caches are looked up from every tenant
    thread. Hammer one small LRU cache with gets and inserts that keep it
    evicting, from more threads than cores under a short switch interval:
    no lookup may fail on a key another thread evicted, and the counters
    must count every lookup exactly (a lost update breaks the sum)."""
    cache = LRUCache(4)
    n_threads, n_ops = 16, 3000
    errors = []
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer(k):
            try:
                for i in range(n_ops):
                    key = (k * 7 + i) % 11
                    if cache.get(key) is None:
                        cache[key] = i
            except Exception as e:  # noqa: BLE001 - surface to the test
                errors.append(e)

        threads = [threading.Thread(target=hammer, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old_interval)
    assert not errors, errors[:3]
    stats = cache.stats()
    assert stats["hits"] + stats["misses"] == n_threads * n_ops
    assert stats["size"] <= 4


def test_service_needs_a_device():
    """Without a GPU a service raises unless it is given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictionService(ServiceConfig(gp=GP))
    assert PredictionService(ServiceConfig(gp=GP), device=CPU).device.type \
        == "cpu"


# --------------------------------------------------------------------------
# tests/test_reliability.py's service tests, in the port's form
# --------------------------------------------------------------------------
def _chaos_service(d):
    return PredictionService(ServiceConfig(
        gp=GP, refit_every=0, checkpoint_dir=str(d), checkpoint_every=0),
        device=CPU)


def test_service_chaos_schedule_no_unhandled_exceptions(tmp_path):
    """The standard injected-fault schedule: NaN payload, mid-workload
    eviction, crash/restore from a checkpoint. Zero unhandled exceptions;
    every healthy tenant's predictions bitwise-match a fault-free control
    service that saw the identical healthy traffic."""
    tasks = [sample_task(seed=i, n=6, m=8, d=4) for i in range(4)]
    control = _chaos_service(tmp_path / "control")
    chaos = _chaos_service(tmp_path / "chaos")
    for svc in (control, chaos):
        for i, task in enumerate(tasks):
            out = svc.observe(f"tenant{i}", "job", Y=task.Y, mask=task.mask,
                              X=task.X, t=task.t)
            assert out["action"] == "fit"

    schedule = FaultSchedule()
    schedule.add(0, lambda service: service.observe(
        "tenant0", "job", *poison_nan(tasks[0].Y, tasks[0].mask)))
    schedule.add(1, lambda service: evict_session(service, "tenant3", "job"))
    schedule.add(2, lambda service: service.checkpoint())

    grids = {i: (tasks[i].Y, tasks[i].mask) for i in (1, 2)}
    for rnd in range(3):
        # healthy tenants stream one more epoch on BOTH services...
        for i in (1, 2):
            grids[i] = _grow(*grids[i], value=0.1 * (rnd + 1))
            for svc in (control, chaos):
                out = svc.observe(f"tenant{i}", "job",
                                  Y=grids[i][0], mask=grids[i][1])
                assert out["action"] == "extend"
        # ...then this round's fault fires on the chaos service only
        results = schedule.fire(rnd, service=chaos)
        if rnd == 0:
            assert results[0]["action"] == "quarantined"

    # crash after the last round; restore from the round-2 checkpoint
    chaos, restored = crash_and_restore(chaos)
    assert restored == 3        # tenant3 was evicted before the snapshot
    assert chaos.device.type == "cpu"
    with pytest.raises(KeyError):
        chaos.predict("tenant3", "job")

    for i in (1, 2):
        want = control.predict(f"tenant{i}", "job")
        got = chaos.predict(f"tenant{i}", "job")
        np.testing.assert_array_equal(want.mean, got.mean)
        np.testing.assert_array_equal(want.var, got.var)
        assert want.generation == got.generation
    # the quarantined tenant still serves from its last good (cold) state
    assert chaos.predict("tenant0", "job").generation == 0
    assert chaos.metrics()["counters"]["restores"] == 1


def test_service_quarantines_guarded_solve_error(monkeypatch):
    """An exhausted escalation ladder inside the observe path (refit) is
    quarantined like any bad payload: no exception escapes, the session
    keeps serving its last good state."""
    import repro_torch.serving.service as service_mod

    svc = PredictionService(ServiceConfig(gp=GP, refit_every=1), device=CPU)
    task = sample_task(seed=0, n=6, m=8, d=4)
    svc.observe("t", "job", Y=task.Y, mask=task.mask, X=task.X, t=task.t)
    before = svc.predict("t", "job")

    def exploding_refit(state, **kwargs):
        raise GuardedSolveError("ladder exhausted (injected)")

    monkeypatch.setattr(service_mod, "refit", exploding_refit)
    Y, mask = _grow(task.Y, task.mask)
    out = svc.observe("t", "job", Y=Y, mask=mask)
    assert out["action"] == "quarantined"
    after = svc.predict("t", "job")
    np.testing.assert_array_equal(before.mean, after.mean)
    assert svc.metrics()["events"]["counts"]["quarantine"] == 1


def test_service_cold_fit_quarantines_bad_payload():
    svc = PredictionService(ServiceConfig(gp=GP), device=CPU)
    task = sample_task(seed=0, n=6, m=8, d=4)
    Y = np.array(task.Y)
    mask = np.array(task.mask)
    mask[0, 0] = 1.0
    Y[0, 0] = np.nan
    out = svc.observe("t", "job", Y=Y, mask=mask, X=task.X, t=task.t)
    assert out["action"] == "quarantined" and out["generation"] == -1
    assert SessionKey("t", "job") not in svc.store
    # the same tenant can onboard with a clean payload afterwards
    out = svc.observe("t", "job", Y=task.Y, mask=task.mask,
                      X=task.X, t=task.t)
    assert out["action"] == "fit"


def test_checkpoint_restore_preserves_session_bookkeeping(tmp_path):
    svc = PredictionService(ServiceConfig(
        gp=GP, refit_every=2, checkpoint_dir=str(tmp_path)), device=CPU)
    task = sample_task(seed=0, n=6, m=8, d=4)
    svc.observe("t", "job", Y=task.Y, mask=task.mask, X=task.X, t=task.t)
    Y, mask = _grow(task.Y, task.mask)
    svc.observe("t", "job", Y=Y, mask=mask)
    Y, mask = _grow(Y, mask, value=0.7)
    svc.observe("t", "job", Y=Y, mask=mask)      # 2nd extend -> warm refit
    svc.checkpoint()
    seq_before = svc.obs_log.next_seq

    svc2, restored = crash_and_restore(svc)
    assert restored == 1
    session = svc2.store.get(SessionKey("t", "job"))
    assert session.observes == 2
    assert session.generation == 2
    assert svc2.obs_log.next_seq == seq_before
    # the restored session accepts further observes and keeps counting
    Y, mask = _grow(Y, mask, value=0.9)
    out = svc2.observe("t", "job", Y=Y, mask=mask)
    assert out["action"] in ("extend", "extend+refit")
    assert svc2.obs_log.next_seq == seq_before + 1


def test_periodic_checkpointing_fires_from_observe(tmp_path):
    svc = PredictionService(ServiceConfig(
        gp=GP, refit_every=0, checkpoint_dir=str(tmp_path),
        checkpoint_every=2), device=CPU)
    task = sample_task(seed=0, n=6, m=8, d=4)
    svc.observe("t", "job", Y=task.Y, mask=task.mask, X=task.X, t=task.t)
    Y, mask = _grow(task.Y, task.mask)
    svc.observe("t", "job", Y=Y, mask=mask)      # 2nd observe -> snapshot
    assert svc.counters["checkpoints"].value == 1
    assert svc.checkpointer.latest_step() is not None


def test_restore_without_checkpoint_dir_is_a_typed_error():
    svc = PredictionService(ServiceConfig(gp=GP), device=CPU)
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        svc.restore()
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        crash_and_restore(svc)


def test_event_log_counts_survive_window_rolloff():
    log = EventLog(window=4)
    for i in range(10):
        log.record("tick", i=i)
    snap = log.snapshot()
    assert snap["counts"]["tick"] == 10
    assert len(snap["recent"]) == 4
    assert log.count("tick") == 10


# --------------------------------------------------------------------------
# the port against the reference
# --------------------------------------------------------------------------
def _traffic(svc, tasks, checkpoint_at=None):
    """The same request stream for either package's service: a coalesced
    cold fit of every tenant, three rounds of one more epoch each (the
    second a warm refit), predictions after every round."""
    svc.observe_batch([
        dict(tenant=name, task="run", X=tk.X, t=tk.t, Y=tk.Y, mask=tk.mask)
        for name, tk in tasks.items()])
    masks = {name: np.asarray(tk.mask) for name, tk in tasks.items()}
    preds = []
    for rnd in range(3):
        for name, tk in tasks.items():
            masks[name] = grow_mask(masks[name])
            Y = np.where(masks[name] > 0, np.asarray(tk.Y_full), 0.0)
            svc.observe(name, "run", Y, masks[name])
        if rnd == checkpoint_at:
            svc.checkpoint()
        preds.append(svc.predict_many([(name, "run") for name in tasks]))
    return preds


def _assert_same_predictions(ours, ref, rtol=PARITY_RTOL):
    for o, r in zip(ours, ref):
        assert (o.tenant, o.task, o.generation, o.batch_size) == \
            (r.tenant, r.task, r.generation, r.batch_size)
        for got, want in ((o.mean, r.mean), (o.var, r.var)):
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=rtol * np.abs(want).max())


def _ref_service(**kw):
    return ref_serving.PredictionService(ref_serving.ServiceConfig(
        gp=ref_core.LKGPConfig(lbfgs_iters=5, backend="dense"),
        capacity=8, refit_every=2, refit_lbfgs_iters=2, **kw))


def _port_service(**kw):
    return PredictionService(ServiceConfig(
        gp=GP, capacity=8, refit_every=2, refit_lbfgs_iters=2, **kw),
        device=CPU)


def test_same_traffic_gives_the_reference_predictions():
    tasks = {f"t{i}": sample_task(seed=10 + i, n=6, m=8, d=4)
             for i in range(3)}
    ours = _traffic(_port_service(), tasks)
    ref = _traffic(_ref_service(), tasks)
    for o, r in zip(ours, ref):
        _assert_same_predictions(o, r)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """A checkpoint one package's service wrote restores in the other's
    service: the same sessions, generations, observation log, and the
    writer's predictions (1e-6 relative; the dense path re-solves them)."""
    tasks = {f"t{i}": sample_task(seed=20 + i, n=6, m=8, d=4)
             for i in range(3)}
    make = {"reference": _ref_service, "port": _port_service}
    reader = "port" if writer == "reference" else "reference"
    src = make[writer](checkpoint_dir=str(tmp_path), checkpoint_every=0)
    preds = _traffic(src, tasks, checkpoint_at=2)[-1]
    dst = make[reader](checkpoint_dir=str(tmp_path), checkpoint_every=0)
    assert dst.restore() == 3
    assert dst.obs_log.next_seq == src.obs_log.next_seq
    assert dst.obs_log.entries() == src.obs_log.entries()
    got = dst.predict_many([(name, "run") for name in tasks])
    if writer == "port":
        got, preds = preds, got
    _assert_same_predictions(got, preds)
    manifest = json.load(open(os.path.join(tmp_path, "step_0000000001",
                                           "manifest.json")))
    assert [s["dtype"] for s in manifest["extra"]["sessions"]] == \
        ["float64"] * 3


def test_checkpoint_keys_are_the_reference_keys():
    """The flattened key strings of a list of states (the service's
    checkpoint) and of nested containers are the reference's pytree paths."""
    cfg = dict(backend="dense")
    st = state_template(3, 4, 4, "float64", LKGPConfig(**cfg), device=CPU)
    ref_st = ref_serving.state_template(3, 4, 4, "float64",
                                        ref_core.LKGPConfig(**cfg))
    assert list(_flatten([st, st])) == list(ref_flatten([ref_st, ref_st])[0])
    assert list(_flatten(st)) == list(ref_flatten(ref_st)[0])
    tree = {"b": {"c": np.zeros(2)}, "a": [1.0, (np.ones(1), 3.0)]}
    assert list(_flatten(tree)) == list(ref_flatten(tree)[0])


def test_checkpoint_manager_round_trip_keep_k_and_atomic(tmp_path):
    """Save / restore bit for bit into the template's dtype and device,
    keep the newest K, never publish a half-written step, and wait for an
    asynchronous save before reading."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    st = state_template(5, 4, 3, torch.float64, LKGPConfig(), device=CPU)
    gen = torch.Generator().manual_seed(0)
    saved = []
    for step in (1, 2, 3):
        tree = {"states": [st.with_params(st.params._replace(
                    raw_noise=torch.tensor(-float(step), dtype=torch.float64))),
                    st],
                "w": torch.randn(3, 2, generator=gen)}
        mgr.save(step, tree, extra={"step": step})
        saved.append(tree)
    mgr.wait()              # the last save runs on the background thread
    assert mgr.latest_step() == 3
    assert mgr.all_steps() == [2, 3]                      # keep-K GC
    template = {"states": [st, st], "w": torch.zeros(3, 2,
                                                     dtype=torch.float32)}
    out = mgr.restore(template, step=2)
    assert out["w"].dtype == torch.float32
    assert torch.equal(out["w"], saved[1]["w"].float())
    got, want = out["states"][0], saved[1]["states"][0]
    assert float(got.params.raw_noise) == -2.0
    assert torch.equal(got.X, want.X) and got.config == want.config
    latest = mgr.restore(template)
    assert float(latest["states"][0].params.raw_noise) == -3.0
    with pytest.raises(KeyError, match="missing keys"):
        mgr.restore({"other": torch.zeros(1)})
    # a crash mid-write leaves a temp dir, never a step: not restorable
    os.makedirs(tmp_path / ".tmp_step_9_123")
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    manifest = json.load(open(tmp_path / "step_0000000003" / "manifest.json"))
    assert manifest["step"] == 3 and manifest["extra"] == {"step": 3}
    assert manifest["keys"] == sorted(_flatten(saved[2]))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(template)


def test_reference_faults_and_the_ports_agree_on_the_chaos_outcome(tmp_path):
    """The reference's chaos schedule on both packages' services: the same
    quarantine, eviction and restore count, and the restored predictions
    within the parity tolerance of each other."""
    tasks = [sample_task(seed=i, n=6, m=8, d=4) for i in range(3)]
    from repro_torch import testing as port_testing

    def ref_service(d):
        return ref_serving.PredictionService(ref_serving.ServiceConfig(
            gp=ref_core.LKGPConfig(lbfgs_iters=5, backend="dense"),
            refit_every=0, checkpoint_dir=str(d), checkpoint_every=0))

    outcomes = {}
    for name, faults, make in (("port", port_testing, _chaos_service),
                               ("ref", ref_testing, ref_service)):
        svc = make(tmp_path / name)
        for i, task in enumerate(tasks):
            svc.observe(f"tenant{i}", "job", Y=task.Y, mask=task.mask,
                        X=task.X, t=task.t)
        q = svc.observe("tenant0", "job",
                        *faults.poison_nan(tasks[0].Y, tasks[0].mask))
        assert faults.evict_session(svc, "tenant2", "job")
        svc.checkpoint()
        svc, restored = faults.crash_and_restore(svc)
        outcomes[name] = (q["action"], restored,
                          svc.predict("tenant1", "job"))
    (qa, ra, pa), (qb, rb, pb) = outcomes["port"], outcomes["ref"]
    assert (qa, ra) == (qb, rb) == ("quarantined", 2)
    _assert_same_predictions([pa], [pb])


def test_cuda_service_cold_fit_steps_back_from_a_degraded_trial(monkeypatch):
    """A tenant on the cuda engine (its kernel's plain float32 version here):
    late in its cold fit a wild L-BFGS step reaches parameters where the
    float32 objective solve breaks down. That trial is a rejected step, as
    the reference's fit (whose traced CG freezes broken columns) goes on;
    it used to abort the fit, and the service quarantined this healthy
    tenant. Its cold fit now completes."""
    from repro_torch.core import engines

    degraded = []
    raise_if_degraded = engines._raise_if_degraded

    def counting(res, what):
        try:
            raise_if_degraded(res, what)
        except engines.DegradedSolveError:
            degraded.append(what)
            raise

    monkeypatch.setattr(engines, "_raise_if_degraded", counting)
    svc = PredictionService(ServiceConfig(
        gp=LKGPConfig(backend="cuda", lbfgs_iters=20), capacity=4),
        device=CPU)
    tk = sample_task(seed=101, n=48, m=20, d=4)
    out = svc.observe("t1", "run", tk.Y, tk.mask, X=tk.X, t=tk.t)
    assert out["action"] == "fit", out
    res = svc.store.get(SessionKey("t1", "run")).state.fit_result
    assert np.isfinite(res.fun) and res.n_iters > 0
    assert degraded, "no trial solve degraded: the case is not exercised"
    assert svc.counters["quarantined"].value == 0
