"""The port's tracing (``repro_torch.tracing``): off by default and then
without effect, the span tree of one ``extend`` + ``final()`` request on the
``cuda`` engine (its plain CPU path), the CG loop's counters against the
solve's own numbers, the span clock against ``torch.profiler``'s, and one
stack of open spans per thread."""
import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import core, tracing
from repro_torch.data.curves import sample_task

F64 = torch.float64
NAMES = ("lkgp.extend", "lkgp.final", "lkgp.cg", "lkgp.mvm",
         "lkgp.mvm.launch")
COUNTERS = ("lkgp.cg.wait_ns", "lkgp.cg.cols_swept", "lkgp.cg.cols_active")


@pytest.fixture(autouse=True)
def tracing_left_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def state():
    task = sample_task(3, n=64, m=12, d=4)
    X, t, Y, mask = (torch.tensor(a, dtype=F64)
                     for a in (task.X, task.t, task.Y, task.mask))
    cfg = core.LKGPConfig(backend="cuda", posterior_samples=8, seed=5)
    params = core.LKGPParams(
        raw_x_lengthscale=torch.zeros(4, dtype=F64),
        raw_t_lengthscale=torch.tensor(0.0, dtype=F64),
        raw_outputscale=torch.tensor(0.0, dtype=F64),
        raw_noise=torch.tensor(-3.0, dtype=F64))
    return core.LKGPState(params=params, X=X, t=t, Y=Y, mask=mask,
                          x_tf=core.XTransform.fit(X),
                          t_tf=core.TTransform.fit(t),
                          y_tf=core.YTransform.fit(Y, mask), config=cfg)


def request(state):
    """One request as a scheduler makes it: ``extend``, then ``final()``."""
    st = core.extend(state, state.Y, state.mask)
    post = core.posterior(st, device="cpu")
    mean, var = post.final()
    return mean, var, post


def traced_request(state, rid=7):
    tracing.enable()
    with tracing.request(rid):
        out = request(state)
    tracing.disable()
    return out


def test_off_records_nothing_and_on_changes_no_bit(state):
    assert not tracing.enabled()
    mean0, var0, _ = request(state)
    assert tracing.spans() == []
    assert tracing.snapshot() == {"spans": {}, "counters": {}}
    tracing.count("lkgp.cg.wait_ns", 5)
    with tracing.span("lkgp.x", a=1) as sp:
        assert sp is None
    assert tracing.snapshot() == {"spans": {}, "counters": {}}
    mean1, var1, _ = traced_request(state)
    assert torch.equal(mean0, mean1) and torch.equal(var0, var1)
    assert set(tracing.snapshot()["spans"]) == set(NAMES)


def test_span_tree_of_a_request(state):
    traced_request(state)
    recs = tracing.spans()
    by_id = {r["id"]: r for r in recs}
    parent_of = {r["name"]: set() for r in recs}
    for r in recs:
        parent_of[r["name"]].add(
            None if r["parent"] is None else by_id[r["parent"]]["name"])
    assert parent_of == {"lkgp.extend": {None}, "lkgp.final": {None},
                         "lkgp.cg": {"lkgp.final"}, "lkgp.mvm": {"lkgp.cg"},
                         "lkgp.mvm.launch": {"lkgp.mvm"}}
    assert {r["trace"] for r in recs} == {"request:7"}
    for r in recs:   # a child lies inside its parent, on one clock
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
    mvm = [r for r in recs if r["name"] == "lkgp.mvm"]
    assert {(r["attrs"]["route"], r["attrs"]["B"]) for r in mvm} == {
        ("fused", 9)}
    cg, = [r for r in recs if r["name"] == "lkgp.cg"]
    assert cg["attrs"]["B"] == 9 and (cg["attrs"]["n"], cg["attrs"]["m"]) \
        == (64, 12)
    assert cg["attrs"]["iters"] == len(mvm)


def test_self_time_is_duration_less_children(state):
    traced_request(state)
    recs = tracing.spans()
    snap = tracing.snapshot()["spans"]
    for name in NAMES:
        own = [r for r in recs if r["name"] == name]
        ids = {r["id"] for r in own}
        total = sum(r["end_ns"] - r["start_ns"] for r in own)
        children = sum(r["end_ns"] - r["start_ns"] for r in recs
                       if r["parent"] in ids)
        assert snap[name]["count"] == len(own)
        assert snap[name]["total_ns"] == total
        assert snap[name]["self_ns"] == total - children


def test_counters_against_the_solve(state):
    _, _, post = traced_request(state)
    info = post.solve_info
    snap = tracing.snapshot()
    c = snap["counters"]
    cg, = [r for r in tracing.spans() if r["name"] == "lkgp.cg"]
    assert c["lkgp.cg.cols_active"] == int(info.matvecs)
    assert c["lkgp.cg.cols_swept"] == 9 * int(info.iters)
    assert cg["attrs"]["replacements"] == info.replacements
    assert 0 < c["lkgp.cg.wait_ns"] <= snap["spans"]["lkgp.cg"]["total_ns"]
    # every sweep swept is counted once, active or frozen
    assert c["lkgp.cg.cols_active"] <= c["lkgp.cg.cols_swept"]


def test_prefix_counters_of_a_request(state):
    """A request on a mask observed up to epoch L < m solves on the (n, L)
    prefix: its counters say L of the grid's m columns, and the CG span's
    ``m`` reads L."""
    L, m = 5, state.mask.shape[-1]
    mask = state.mask * (torch.arange(m) < L).to(F64)
    Y = state.Y * mask
    prefix = dataclasses.replace(state, Y=Y, mask=mask,
                                 y_tf=core.YTransform.fit(Y, mask))
    traced_request(prefix)
    c = tracing.snapshot()["counters"]
    assert (c["lkgp.solve.prefix_cols"], c["lkgp.solve.grid_cols"]) == (L, m)
    cg, = [r for r in tracing.spans() if r["name"] == "lkgp.cg"]
    assert (cg["attrs"]["n"], cg["attrs"]["m"]) == (64, L)
    assert set(tracing.snapshot()["spans"]) == set(NAMES)


def test_spans_on_the_profilers_clock(state):
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        request(state)
    tracing.disable()
    ours = sorted(tracing.spans(), key=lambda r: r["start_ns"])
    theirs = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("lkgp.")))
    assert [r["name"] for r in ours] == [n for _, _, n in theirs]
    # A span is stamped before its copy opens and closes before its copy
    # does, so on one clock a copy may lag (a preempted host lags it by
    # milliseconds) but never leads; a wrong anchor would move every copy.
    lags = [s - r["start_ns"] for r, (s, _, _) in zip(ours, theirs)]
    for r, (s, e, _) in zip(ours, theirs):
        assert s - r["start_ns"] > -1_000_000, r["name"]
        assert e - r["end_ns"] > -1_000_000, r["name"]
    assert abs(sorted(lags)[len(lags) // 2]) < 1_000_000
    # the same nesting on both clocks
    index = {r["id"]: i for i, r in enumerate(ours)}
    for r in ours:
        if r["parent"] is not None:
            ps, pe, _ = theirs[index[r["parent"]]]
            s, e, _ = theirs[index[r["id"]]]
            assert ps <= s and e <= pe


def test_threads_keep_their_own_stacks():
    tracing.enable()
    both_open = threading.Barrier(2, timeout=10)
    inner_open = threading.Barrier(2, timeout=10)
    done = []

    def work(tag):
        with tracing.request(tag):
            with tracing.span("lkgp.outer", tag=tag):
                both_open.wait()
                with tracing.span("lkgp.inner", tag=tag):
                    inner_open.wait()
        done.append(tag)

    threads = [threading.Thread(target=work, args=(k,)) for k in (1, 2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=20)
    assert not any(th.is_alive() for th in threads)
    assert sorted(done) == [1, 2]
    recs = tracing.spans()
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] == "lkgp.inner":
            outer = by_id[r["parent"]]
            assert outer["name"] == "lkgp.outer"
            assert outer["attrs"]["tag"] == r["attrs"]["tag"]
            assert r["trace"] == outer["trace"] == f"request:{r['attrs']['tag']}"
        else:
            assert r["parent"] is None


def test_root_span_outside_a_request_starts_its_own_trace():
    tracing.enable()
    with tracing.span("lkgp.a"):
        with tracing.span("lkgp.b"):
            pass
    with tracing.span("lkgp.c"):
        pass
    a, c = (r for r in tracing.spans() if r["parent"] is None)
    b, = (r for r in tracing.spans() if r["parent"] is not None)
    assert a["trace"] == b["trace"] == f"span:{a['id']}"
    assert c["trace"] == f"span:{c['id']}" != a["trace"]


def test_records_are_bounded_and_aggregates_go_on(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    tracing.enable()
    for _ in range(5):
        with tracing.span("lkgp.x"):
            pass
    tracing.count("lkgp.n", 2)
    tracing.count("lkgp.n", 3)
    assert len(tracing.spans()) == 3
    snap = tracing.snapshot()
    assert snap["spans"]["lkgp.x"]["count"] == 5
    assert snap["counters"] == {"lkgp.n": 5}
    tracing.reset()
    assert tracing.spans() == [] and tracing.snapshot()["counters"] == {}
