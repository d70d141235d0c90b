"""PyTorch port, the warm-start fit family: the fixed-budget polish,
``fit(polish_steps=k)``, ``fit_batch``, ``extend``, ``refit``,
``stack_states`` / ``unstack``, the caches and the ``LKGP`` facade, each held
against the reference on the same numpy inputs (tolerances stated per test).
"""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import state as ref_state
from repro_torch import params_to_numpy
from repro_torch.core import (LKGP, DistributedEngine, LKGPConfig,
                              LRUCache, PolishResult, compiled_cache_stats,
                              engine_cache_stats, extend, fit, fit_batch,
                              get_engine, init_params, make_polish,
                              posterior, refit, stack_states, unstack)
from repro_torch.core import engines as engines_mod
from repro_torch.core import state as state_mod
from repro_torch.data import sample_suite, sample_task, stack_suite

N, M, D = 12, 10, 4
DENSE = dict(backend="dense")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def task():
    return sample_task(3, n=N, m=M, d=D)


def _fit(task, polish_steps, **cfg):
    return fit(task.X, task.t, task.Y, task.mask, LKGPConfig(**cfg),
               polish_steps=polish_steps, device="cpu")


def _ref_fit(task, polish_steps, **cfg):
    return ref_core.fit(task.X, task.t, task.Y, task.mask,
                        ref_core.LKGPConfig(**cfg), polish_steps=polish_steps)


# --------------------------------------------------------------------------
# make_polish
# --------------------------------------------------------------------------
def _quadratic(P=6, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((P, P))
    A = Q @ Q.T / P + 0.2 * np.eye(P)
    b = rng.standard_normal(P)
    return A, b, rng.standard_normal(P)


@pytest.mark.parametrize("steps", [1, 3, 8])
def test_make_polish_on_a_quadratic_matches_reference(steps):
    """f(x) = 1/2 x'Ax - b'x + 0.1 sum x^4 (curved, so the ladder matters):
    the same iterate to 1e-8 relative, the same accepted-step count, and a
    float64 PolishResult of tensors."""
    A, b, x0 = _quadratic()
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)

    def vg_t(x, scale):
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            f = scale * (0.5 * x @ At @ x - bt @ x + 0.1 * (x ** 4).sum())
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g

    def f_j(x, scale):
        return scale * (0.5 * x @ Aj @ x - bj @ x + 0.1 * jnp.sum(x ** 4))

    got = make_polish(vg_t, steps)(torch.from_numpy(x0),
                                   torch.tensor(2.0, dtype=torch.float64))
    want = jax.jit(ref_core.make_polish(jax.value_and_grad(f_j), steps))(
        jnp.asarray(x0), jnp.asarray(2.0))
    assert isinstance(got, PolishResult)
    assert got.x.dtype == torch.float64 and got.x.shape == (6,)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(float(got.fun), float(want.fun), rtol=1e-10)
    np.testing.assert_allclose(float(got.grad_inf), float(want.grad_inf),
                               rtol=1e-6, atol=1e-12)
    assert int(got.n_accepted) == int(want.n_accepted)


def test_make_polish_evaluates_every_rung_and_validates_steps():
    """Cost contract: 1 + steps * n_backtracks evaluations, whatever is
    accepted; steps < 1 raises ValueError as in the reference; a candidate
    whose objective cannot be evaluated is rejected, not raised."""
    A, b, x0 = _quadratic(4)
    calls = []

    def vg(x, scale=1.0):
        calls.append(x.clone())
        if float(x.abs().max()) > 50:      # outside the domain
            raise torch.linalg.LinAlgError("not positive-definite")
        At, bt = scale * torch.from_numpy(A), torch.from_numpy(b)
        return 0.5 * x @ At @ x - bt @ x, At @ x - bt

    res = make_polish(vg, 3, n_backtracks=5)(torch.from_numpy(x0))
    assert len(calls) == 1 + 3 * 5
    assert int(res.n_accepted) >= 1
    for bad in (0, -1):
        with pytest.raises(ValueError, match="steps >= 1"):
            make_polish(vg, bad)
        with pytest.raises(ValueError, match="steps >= 1"):
            ref_core.make_polish(vg, bad)
    # a steep objective: every rung of the first step leaves the domain, is
    # rejected, and the iterate stays put
    calls.clear()
    x = torch.from_numpy(x0)
    res = make_polish(vg, 1)(x, 1e3)
    assert len(calls) == 5 and int(res.n_accepted) == 0
    assert torch.equal(res.x, x) and bool(torch.isfinite(res.fun))


# --------------------------------------------------------------------------
# fit(polish_steps=k)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("steps", [1, 3])
def test_fit_polish_on_dense_matches_reference(task, steps):
    """The dense MLL polished from the default init: FitResult.x within 1e-8
    relative of the reference's (measured ~4e-14), the same objective, and
    the same cost contract (n_evals = 1 + 4 steps) and verdict."""
    state = _fit(task, steps, **DENSE)
    ref = _ref_fit(task, steps, **DENSE)
    res, rres = state.fit_result, ref.fit_result
    np.testing.assert_allclose(res.x, np.asarray(rres.x), rtol=1e-8)
    np.testing.assert_allclose(res.fun, rres.fun, rtol=1e-10)
    assert (res.n_iters, res.n_evals, res.converged, res.budget,
            res.init_source, res.optimizer) == \
        (rres.n_iters, rres.n_evals, rres.converged, rres.budget,
         rres.init_source, rres.optimizer) == \
        (steps, 1 + 4 * steps, False, steps, "default", "polish")
    got = params_to_numpy(state.params)
    for k, v in ref.params._asdict().items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-8)


def test_polish_of_the_dense_objective_accepts_as_the_reference(task):
    """make_polish over the cached dense objective of each package, from the
    same start: the same number of accepted steps and x within 1e-8."""
    cfg, rcfg = LKGPConfig(**DENSE), ref_core.LKGPConfig(**DENSE)
    X, t, Y, mask = (torch.from_numpy(np.asarray(a))
                     for a in (task.X, task.t, task.Y, task.mask))
    x_tf, t_tf, y_tf = state_mod._fit_transforms(X, t, Y, mask)
    data = (x_tf(X), t_tf(t), y_tf(Y), mask)
    rx, rt, ry = ref_state._fit_transforms(*(jnp.asarray(a) for a in (
        task.X, task.t, task.Y, task.mask)))
    rdata = (rx(jnp.asarray(task.X)), rt(jnp.asarray(task.t)),
             ry(jnp.asarray(task.Y)), jnp.asarray(task.mask))
    x0 = np.asarray(ref_state._flatten_params(ref_core.init_params(D)))
    x0 = x0 + np.linspace(-0.3, 0.3, D + 3)
    pol = state_mod._cached_polish(cfg, get_engine("dense"), D, 4)
    rpol = ref_state._cached_polish(rcfg, ref_core.get_engine("dense"), D, 4)
    got = pol(torch.from_numpy(x0), *data, None)
    want = rpol(jnp.asarray(x0), *rdata, None)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8)
    assert int(got.n_accepted) == int(want.n_accepted) >= 1


@pytest.mark.parametrize("backend", ["dense", "iterative", "cuda",
                                     "distributed"])
def test_fit_polish_runs_on_every_engine(task, backend):
    """polish_steps=2 on each engine fit() runs on (CPU tensors: the cuda
    engine through its kernels' plain versions, the distributed engine as a
    world of one): 9 evaluations, a finite objective below the init's."""
    cfg = dict(backend=backend, cg_tol=1e-6, slq_probes=8)
    state = _fit(task, 2, **cfg)
    f0 = _fit(task, 0, **cfg).fit_result.fun
    res = state.fit_result
    assert (res.optimizer, res.n_evals, res.n_iters) == ("polish", 9, 2)
    assert np.isfinite(res.fun) and res.fun < f0
    assert state.backend_used == backend
    assert np.array_equal(res.x, state_mod._flatten_params(
        state.params).numpy())


def test_fit_polish_on_a_float32_distributed_engine_raises(task):
    """K3 has no backward (as in the reference): a float32 fit through the
    distributed engine's kernel raises, polished or not."""
    X = np.asarray(task.X, np.float32)
    with pytest.raises(NotImplementedError, match="no backward"):
        fit(X, task.t, task.Y, task.mask, LKGPConfig(cg_tol=1e-3),
            engine=DistributedEngine(), polish_steps=1, device="cpu")


# --------------------------------------------------------------------------
# fit_batch
# --------------------------------------------------------------------------
B = 3


@pytest.fixture(scope="module")
def suite():
    tasks = sample_suite(5, B, n=8, m=6, d=D)
    return tasks, stack_suite(tasks)


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_fit_batch_polish_is_bitwise_the_per_task_fit(suite, steps):
    """Task i of fit_batch(polish_steps=k) has exactly the bits of
    fit(task_i, backend="dense", polish_steps=k): parameters, FitResult.x
    rows and the summed objective."""
    tasks, (X, t, Y, mask, _) = suite
    batch = fit_batch(X, t, Y, mask, LKGPConfig(), polish_steps=steps,
                      device="cpu")
    res = batch.fit_result
    assert res.x.shape == (B, D + 3)
    assert res.n_evals == B * (1 + 4 * steps) if steps else res.n_evals == B
    funs = []
    for i, (tk, st) in enumerate(zip(tasks, unstack(batch))):
        one = fit(tk.X, tk.t, tk.Y, tk.mask, LKGPConfig(**DENSE),
                  polish_steps=steps, device="cpu")
        assert np.array_equal(res.x[i], one.fit_result.x)
        for a, b in zip(st.params, one.params):
            assert torch.equal(a, b)
        for name in ("x_tf", "t_tf", "y_tf"):
            for a, b in zip(getattr(st, name), getattr(one, name)):
                assert torch.equal(a, b)
        funs.append(one.fit_result.fun)
    assert res.fun == float(sum(funs))
    assert batch.backend_used == "dense"


def test_fit_batch_polish_matches_reference(suite):
    """The same batch polished by the reference: FitResult.x within 1e-8
    relative (measured ~2e-14) and the same counts."""
    tasks, (X, t, Y, mask, _) = suite
    got = fit_batch(X, t, Y, mask, LKGPConfig(), polish_steps=2,
                    device="cpu").fit_result
    want = ref_core.fit_batch(X, t, Y, mask, ref_core.LKGPConfig(),
                              polish_steps=2).fit_result
    np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=1e-8)
    np.testing.assert_allclose(got.fun, want.fun, rtol=1e-10)
    assert (got.n_evals, got.converged, got.optimizer) == \
        (want.n_evals, want.converged, want.optimizer)


def test_fit_batch_lbfgs_matches_reference(suite):
    """polish_steps=-1: one host L-BFGS on the summed per-task dense
    objectives over the reference's flat layout; x within 1e-6 and the same
    iteration and evaluation counts (measured gap ~1e-13), and each task's
    state equals the reference's to 1e-6."""
    tasks, (X, t, Y, mask, _) = suite
    cfg = dict(lbfgs_iters=6)
    got = fit_batch(X, t, Y, mask, LKGPConfig(**cfg), device="cpu")
    want = ref_core.fit_batch(X, t, Y, mask, ref_core.LKGPConfig(**cfg))
    res, rres = got.fit_result, want.fit_result
    assert res.x.shape == (B * (D + 3),)
    np.testing.assert_allclose(res.x, rres.x, atol=1e-6, rtol=0)
    np.testing.assert_allclose(res.fun, rres.fun, rtol=1e-9)
    assert (res.n_iters, res.n_evals, res.converged, res.optimizer) == \
        (rres.n_iters, rres.n_evals, rres.converged, rres.optimizer)
    for k, v in params_to_numpy(got.params).items():
        np.testing.assert_allclose(v, np.asarray(getattr(want.params, k)),
                                   atol=1e-6, rtol=0)
    assert got.t.shape == (B, M - 4) and got.X.shape == (B, 8, D)


def test_fit_batch_inits_and_validation(suite):
    """Explicit batched params round-trip bitwise with polish_steps=0;
    unbatched explicit params, a shape mismatch and NaN at an observed cell
    raise as in the reference."""
    tasks, (X, t, Y, mask, _) = suite
    p = init_params(D, device="cpu")
    pb = type(p)(*(a.expand(B, *a.shape).clone() + 0.1 for a in p))
    out = fit_batch(X, t, Y, mask, LKGPConfig(), init=pb, polish_steps=0,
                    device="cpu")
    assert all(a is b for a, b in zip(out.params, pb))
    assert out.fit_result.init_source == "params"
    with pytest.raises(ValueError, match="expected 2 for this batched fit"):
        fit_batch(X, t, Y, mask, LKGPConfig(), init=p, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        fit_batch(X, t, Y[:, :, :-1], mask, device="cpu")
    Y_bad = Y.copy()
    Y_bad[1, 0, 0] = np.nan
    with pytest.raises(ValueError, match=r"\(1, 0, 0\)"):
        fit_batch(X, t, Y_bad, mask, device="cpu")


# --------------------------------------------------------------------------
# extend / refit
# --------------------------------------------------------------------------
def _grow(task, extra=2):
    """The task with each cut-off curve ``extra`` epochs longer."""
    lens = task.mask.sum(1).astype(int)
    new_lens = np.minimum(lens + extra, M)
    mask = (np.arange(M)[None, :] < new_lens[:, None]).astype(np.float64)
    return task.Y_full * mask, mask


def _assert_close_state(st, ref, tol=1e-12):
    for name in ("X", "t", "Y", "mask"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=tol)
    for name in ("x_tf", "t_tf", "y_tf"):
        for a, b in zip(getattr(st, name), getattr(ref, name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)


@pytest.mark.parametrize("mode", ["epochs", "configs"])
def test_extend_matches_reference_and_clears_the_fit(task, mode):
    """Both modes: the data and refit transforms equal the reference's, the
    parameters carry over bitwise, fit_result / backend_used are cleared, a
    bound engine is carried on and the posterior cache starts cold."""
    engine = get_engine("iterative")
    st = fit(task.X, task.t, task.Y, task.mask, LKGPConfig(lbfgs_iters=2),
             engine=engine, device="cpu")
    ref = ref_core.fit(task.X, task.t, task.Y, task.mask,
                       ref_core.LKGPConfig(lbfgs_iters=2))
    post = posterior(st, device="cpu")
    if mode == "epochs":
        new_Y, new_mask = _grow(task)
        args = (new_Y, new_mask)
    else:
        other = sample_task(9, n=4, m=M, d=D)
        args = (other.Y, other.mask, other.X)
    out = extend(st, *args)
    rout = ref_core.extend(ref.with_params(ref.params), *args)
    rout = dataclasses.replace(rout, params=ref.params)
    _assert_close_state(out, rout)
    assert out.n == (N if mode == "epochs" else N + 4)
    assert all(a is b for a, b in zip(out.params, st.params))
    assert out.fit_result is None and out.backend_used is None
    assert out.engine is engine
    assert getattr(out, "_posterior_cache", None) is None
    assert posterior(out, device="cpu") is not post
    assert out.X.device == st.device and out.Y.dtype == st.Y.dtype


def test_extend_errors_match_reference(task):
    """A mask that drops an observed cell, a wrong grid shape, a mismatched
    pair and NaN at an observed cell: the reference's errors and messages."""
    st = _fit(task, 0, **DENSE)
    ref = _ref_fit(task, 0, **DENSE)
    shrunk = task.mask.copy()
    shrunk[0, 0] = 0
    new_Y, new_mask = _grow(task)
    Y_nan = new_Y.copy()
    Y_nan[2, 1] = np.nan
    cases = [(task.Y, shrunk), (task.Y[:-1], task.mask[:-1]),
             (task.Y, task.mask[:, :-1]), (Y_nan, new_mask)]
    for args in cases:
        msgs = []
        for fn, s in ((extend, st), (ref_core.extend, ref)):
            with pytest.raises(ValueError) as e:
                fn(s, *args)
            msgs.append(str(e.value).replace("torch.Size", "").replace(
                "(", "").replace(")", "").replace("[", "").replace("]", ""))
        assert msgs[0] == msgs[1]


def test_refit_warm_starts_and_does_not_persist_overrides(task):
    """refit starts from state.params (polish_steps=0: bitwise), reuses the
    engine fit bound, keeps the config's lbfgs_iters / polish_steps, and
    matches the reference's refit after extend to 1e-8."""
    engine = get_engine("dense")
    st = fit(task.X, task.t, task.Y, task.mask, LKGPConfig(lbfgs_iters=3),
             engine=engine, device="cpu")
    same = refit(st, polish_steps=0)
    assert all(a is b for a, b in zip(same.params, st.params))
    assert same.fit_result.init_source == "params"
    new_Y, new_mask = _grow(task)
    out = refit(extend(st, new_Y, new_mask), lbfgs_iters=7, polish_steps=2)
    assert out.config == st.config and out.config.lbfgs_iters == 3
    assert out.engine is engine and out.backend_used == "dense"
    assert out.fit_result.optimizer == "polish"
    ref = ref_core.fit(task.X, task.t, task.Y, task.mask,
                       ref_core.LKGPConfig(lbfgs_iters=3))
    rout = ref_core.refit(ref_core.extend(ref, new_Y, new_mask),
                          lbfgs_iters=7, polish_steps=2)
    np.testing.assert_allclose(st.fit_result.x, ref.fit_result.x, atol=1e-8)
    np.testing.assert_allclose(out.fit_result.x, np.asarray(
        rout.fit_result.x), rtol=1e-8, atol=1e-10)
    lb = refit(st, lbfgs_iters=1)
    assert lb.fit_result.budget == 1 and lb.config.lbfgs_iters == 3
    # an amortized refit starts from the encoder's guess on the current data,
    # not from state.params (an untrained encoder: the default init)
    from repro_torch.amortize import (Amortizer, AmortizerConfig,
                                      clear_amortizer_registry,
                                      init_amortizer, register_amortizer)
    acfg = AmortizerConfig(d=D, d_model=8, curve_layers=1, num_heads=2,
                           d_ff=8)
    am = Amortizer(acfg, init_amortizer(torch.Generator().manual_seed(0),
                                        acfg))
    register_amortizer(am)
    try:
        for args, kw in (((), dict(init="amortized")),
                         ((), dict(amortizer=am)),
                         ((LKGPConfig(hyper_init="amortized"),), {})):
            out = refit(st, *args, polish_steps=0, **kw)
            assert out.fit_result.init_source == "amortized"
            assert all(torch.equal(a, b.double()) for a, b in zip(
                out.params, init_params(D, torch.float32, "cpu")))
    finally:
        clear_amortizer_registry()


# --------------------------------------------------------------------------
# stack_states / unstack
# --------------------------------------------------------------------------
def test_stack_and_unstack_round_trip_and_errors(task):
    """stack_states(unstack(s)) is s tensor for tensor; the reference's
    three validation errors, message for message (shapes printed as
    tuples)."""
    s1 = _fit(task, 0, **DENSE)
    s2 = _fit(task, 1, **DENSE)
    stacked = stack_states([s1, s2])
    assert stacked.X.shape == (2, N, D) and stacked.params.raw_noise.shape \
        == (2,)
    assert getattr(stacked, "fit_result", None) is None
    for orig, back in zip((s1, s2), unstack(stacked)):
        for name in ("X", "t", "Y", "mask"):
            assert torch.equal(getattr(orig, name), getattr(back, name))
        for name in ("params", "x_tf", "t_tf", "y_tf"):
            for a, b in zip(getattr(orig, name), getattr(back, name)):
                assert torch.equal(a, b)
        assert back.config == orig.config
    r1 = _ref_fit(task, 0, **DENSE)
    other = sample_task(2, n=5, m=M, d=D)
    small = fit(other.X, other.t, other.Y, other.mask, LKGPConfig(**DENSE),
                polish_steps=0, device="cpu")
    rsmall = ref_core.fit(other.X, other.t, other.Y, other.mask,
                          ref_core.LKGPConfig(**DENSE), polish_steps=0)
    cfg2 = dataclasses.replace(s1, config=LKGPConfig(seed=5))
    rcfg2 = dataclasses.replace(r1, config=ref_core.LKGPConfig(seed=5))
    for ours, theirs in (([], []), ([s1, cfg2], [r1, rcfg2]),
                         ([s1, stacked], [r1, ref_core.stack_states([r1])]),
                         ([s1, small], [r1, rsmall])):
        with pytest.raises(ValueError) as a:
            stack_states(ours)
        with pytest.raises(ValueError) as b:
            ref_core.stack_states(theirs)
        assert str(a.value) == str(b.value)


# --------------------------------------------------------------------------
# caches, the facade
# --------------------------------------------------------------------------
def test_lru_cache_counts_like_the_reference():
    """Hits, misses, evictions, recency and the dict-like interface, the
    same sequence driven through both classes."""
    from repro.core.caching import LRUCache as RefLRU
    stats = []
    for cls in (LRUCache, RefLRU):
        c = cls(2)
        c["a"] = 1
        c["b"] = 2
        assert c.get("a") == 1 and c.get("zz", 7) == 7
        c["c"] = 3                      # evicts b (a was refreshed)
        assert "b" not in c and "a" in c and len(c) == 2
        with pytest.raises(KeyError):
            c["b"]
        assert c["c"] == 3 and list(c) == ["a", "c"]
        assert c.pop("a") == 1 and dict(c.items()) == {"c": 3}
        c.clear()
        stats.append(c.stats())
        with pytest.raises(ValueError):
            cls(0)
    assert stats[0] == stats[1] == {"size": 0, "maxsize": 2, "hits": 2,
                                    "misses": 2, "evictions": 1}


def test_compiled_and_engine_cache_stats(task):
    """A same-shaped refit hits the objective caches; a new config key
    misses; engine lookups hit the singleton map (one miss per backend)."""
    cfg = LKGPConfig(backend="dense", jitter=1.25e-6)   # a fresh cache key
    before = compiled_cache_stats()
    st = fit(task.X, task.t, task.Y, task.mask, cfg, polish_steps=2,
             device="cpu")
    mid = compiled_cache_stats()
    assert mid["fit_vg"]["misses"] == before["fit_vg"]["misses"] + 1
    assert mid["polish"]["misses"] == before["polish"]["misses"] + 1
    refit(st, polish_steps=2)
    after = compiled_cache_stats()
    assert after["polish"]["hits"] == mid["polish"]["hits"] + 1
    assert after["polish"]["misses"] == mid["polish"]["misses"]
    assert set(after) == {"fit_vg", "polish"}
    assert after["fit_vg"]["maxsize"] == after["polish"]["maxsize"] == 64
    e0 = engine_cache_stats()
    assert get_engine("dense") is get_engine("dense")
    e1 = engine_cache_stats()
    assert e1["hits"] >= e0["hits"] + 1 and e1["maxsize"] == 16
    assert isinstance(engines_mod._ENGINE_SINGLETONS, LRUCache)


def test_lkgp_facade_is_deprecated_and_delegates(task):
    """Constructing LKGP warns as the reference's does; it fits through
    fit() and predicts through the posterior."""
    with pytest.warns(DeprecationWarning, match="LKGP is deprecated"):
        model = LKGP(LKGPConfig(lbfgs_iters=2), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model.fit(task.X, task.t, task.Y, task.mask)
    assert model.mll_method_used == "cholesky"
    assert model.fit_result.n_iters <= 2
    mean, var = model.predict_final()
    want = posterior(model.state, device="cpu").final()
    assert torch.equal(mean, want[0])
    assert model.posterior_mean().shape == (N, M)
    assert torch.equal(model._mask, model.state.mask)


# --------------------------------------------------------------------------
# the cuda engine's fit against the reference's pallas fit
# --------------------------------------------------------------------------
def test_cuda_fit_against_the_reference_pallas_fit(monkeypatch, capsys):
    """Both float32 kernel routes fit the same task (n=32, m=10, d=5, 10
    L-BFGS iterations, cg_tol 0.01, the reference's probes handed across):
    the reference's ``pallas`` engine (its kernel in interpret mode) and the
    port's ``cuda`` engine (its kernel's plain float32 version on CPU
    tensors), each beside its package's float64 ``iterative`` fit. The
    evaluation counts agree within 10 % and the end points' objectives, all
    scored on the reference's float64 iterative objective, within 1e-2
    relative. Run with ``-s`` to print the numbers."""
    from repro.core import state as rs
    n, m, d = 32, 10, 5
    task = sample_task(0, n=n, m=m, d=d)
    cfg = dict(lbfgs_iters=10, seed=0)
    z = np.asarray(ref_core.rademacher_probes(
        jax.random.PRNGKey(0), 16, jnp.asarray(task.mask), jnp.float64))
    from repro_torch import probes_from_numpy
    monkeypatch.setattr(state_mod, "rademacher_probes",
                        lambda gen, p, mask, dtype: probes_from_numpy(z, mask))
    fits = {}
    for pkg, backend in (("reference", "pallas"), ("reference", "iterative"),
                         ("port", "cuda"), ("port", "iterative")):
        if pkg == "reference":
            st = ref_core.fit(task.X, task.t, task.Y, task.mask,
                              ref_core.LKGPConfig(backend=backend, **cfg))
        else:
            st = fit(task.X, task.t, task.Y, task.mask,
                     LKGPConfig(backend=backend, **cfg), device="cpu")
        fits[pkg, backend] = st.fit_result
    X, t, Y, mask = (jnp.asarray(a) for a in (task.X, task.t, task.Y,
                                              task.mask))
    xtf, ttf, ytf = rs._fit_transforms(X, t, Y, mask)
    vg = rs._cached_fit_vg(ref_core.LKGPConfig(backend="iterative", **cfg),
                           ref_core.get_engine("iterative"), d)
    f64 = {k: float(vg(rs._unflatten_params(jnp.asarray(r.x), d), xtf(X),
                       ttf(t), ytf(Y), mask, jnp.asarray(z))[0])
           for k, r in fits.items()}
    with capsys.disabled():
        for k, r in fits.items():
            print(f"\n{k[0]:9s} {k[1]:9s} n_evals={r.n_evals} "
                  f"fun={r.fun:.6f} float64_objective={f64[k]:.6f}", end="")
        print()
    ours, theirs = fits["port", "cuda"], fits["reference", "pallas"]
    assert abs(ours.n_evals - theirs.n_evals) <= 0.1 * theirs.n_evals
    assert abs(f64["port", "cuda"] - f64["reference", "pallas"]) <= \
        1e-2 * f64["reference", "pallas"]
