"""PyTorch port, the fit path as a whole: observation errors, priors, the
flat parameter vector, host L-BFGS and ``fit`` itself, each against its
counterpart in the reference on the same numpy inputs. Whole fits are held
against the reference on the ``dense`` engine (no probes) and on the
``iterative`` engine with the reference's probes handed in.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import errors as ref_errors
from repro.core import lbfgs as ref_lbfgs
from repro.core import priors as ref_priors
from repro.core import state as ref_state
from repro_torch import params_from_numpy, params_to_numpy, probes_from_numpy
from repro_torch.core import (FitResult, KernelEngine, LKGPConfig,
                              LKGPParams, fit, get_engine, init_params,
                              lbfgs_minimize, log_prior, posterior)
from repro_torch.core import errors, priors
from repro_torch.core import state as state_mod
from repro_torch.data import sample_task


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# errors, priors, the flat parameter vector
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["ok", "nan_observed", "nan_unobserved",
                                  "wide_marked", "wide_unmarked", "narrow"])
def test_observation_checks_match_reference(case):
    """Same verdict, same message and same indices as the reference."""
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((5, 6))
    mask = np.ones((5, 6))
    mask[2, 4:] = 0
    m = 6
    if case == "nan_observed":
        Y[1, 2] = np.nan
        Y[3, 0] = np.inf
    elif case == "nan_unobserved":
        Y[2, 5] = np.nan
    elif case == "wide_marked":
        mask = np.concatenate([mask, np.zeros((5, 3))], 1)
        mask[4, 7] = 1
    elif case == "wide_unmarked":
        mask = np.concatenate([mask, np.zeros((5, 3))], 1)
    elif case == "narrow":
        m = 8
    outcomes = []
    for mod in (errors, ref_errors):
        try:
            mod.check_grid_columns(mask, m)
            mod.check_observed_finite(Y, mask)
            outcomes.append(None)
        except mod.ObservationError as e:
            assert isinstance(e, ValueError)
            outcomes.append((str(e), e.indices))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (case in ("ok", "nan_unobserved"))


@pytest.mark.parametrize("d", [1, 4, 7])
def test_priors_log_prior_and_flat_params_match_reference(d):
    rng = np.random.default_rng(d)
    raw = rng.normal(0.0, 2.0, d + 3)
    rp = ref_state._unflatten_params(jnp.asarray(raw), d)
    p = state_mod._unflatten_params(_t(raw), d)
    np.testing.assert_allclose(
        float(priors.x_lengthscale_prior_logpdf(p.raw_x_lengthscale, d)),
        float(ref_priors.x_lengthscale_prior_logpdf(rp.raw_x_lengthscale, d)),
        rtol=1e-14)
    np.testing.assert_allclose(
        float(priors.noise_prior_logpdf(p.raw_noise)),
        float(ref_priors.noise_prior_logpdf(rp.raw_noise)), rtol=1e-14)
    np.testing.assert_allclose(float(log_prior(p, d)),
                               float(ref_state.log_prior(rp, d)), rtol=1e-14)
    flat = state_mod._flatten_params(p)
    np.testing.assert_array_equal(flat.numpy(), raw)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(ref_state._flatten_params(rp)))
    back = params_from_numpy(params_to_numpy(p), device="cpu")
    for a, b in zip(back, p):
        assert torch.equal(a, b)
    assert list(params_to_numpy(p)) == list(rp._fields)


# --------------------------------------------------------------------------
# L-BFGS
# --------------------------------------------------------------------------
def _rosenbrock(x):
    x = np.asarray(x, dtype=np.float64)
    f = np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
    g = np.zeros_like(x)
    g[:-1] = -400.0 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2 * (1 - x[:-1])
    g[1:] += 200.0 * (x[1:] - x[:-1] ** 2)
    return f, g


@pytest.mark.parametrize("max_iters", [3, 200])
def test_lbfgs_matches_reference_step_for_step(max_iters):
    """Same iterates, evaluations and verdict as the reference's L-BFGS on
    the Rosenbrock function (same float64 arithmetic on the host)."""
    x0 = np.array([-1.2, 1.0, -0.5, 0.8])
    got = lbfgs_minimize(_rosenbrock, x0, max_iters=max_iters)
    want = ref_lbfgs.lbfgs_minimize(_rosenbrock, x0, max_iters=max_iters)
    np.testing.assert_array_equal(got.x, want.x)
    assert (got.fun, got.n_iters, got.n_evals, got.converged) == \
        (want.fun, want.n_iters, want.n_evals, want.converged)
    assert got.converged == (max_iters == 200)


def test_lbfgs_rejects_non_finite_trial_points():
    """A trial step into a region where f is NaN is shrunk, never taken."""
    def f(x):
        if x[0] > 1.5:
            return np.nan, np.full_like(x, np.nan)
        return float((x[0] - 1.0) ** 2), np.array([2.0 * (x[0] - 1.0)])
    got = lbfgs_minimize(f, np.array([-3.0]), max_iters=50)
    want = ref_lbfgs.lbfgs_minimize(f, np.array([-3.0]), max_iters=50)
    assert np.isfinite(got.fun) and abs(got.x[0] - 1.0) < 1e-6
    assert (got.n_evals, got.fun) == (want.n_evals, want.fun)


# --------------------------------------------------------------------------
# fit
# --------------------------------------------------------------------------
N, M, D = 12, 10, 4


@pytest.fixture(scope="module")
def task():
    return sample_task(3, n=N, m=M, d=D)


def _ref_fit(task, **cfg):
    return ref_core.fit(task.X, task.t, task.Y, task.mask,
                        ref_core.LKGPConfig(**cfg))


def _assert_same_fit(state, ref, tol):
    got, want = params_to_numpy(state.params), ref.params._asdict()
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=tol,
                                   rtol=0)
    res, rres = state.fit_result, ref.fit_result
    assert isinstance(res, FitResult) and res._fields == rres._fields
    np.testing.assert_allclose(res.x, rres.x, atol=tol, rtol=0)
    np.testing.assert_allclose(res.fun, rres.fun, atol=tol, rtol=0)
    assert (res.n_iters, res.n_evals, res.converged, res.budget,
            res.init_source, res.optimizer) == \
        (rres.n_iters, rres.n_evals, rres.converged, rres.budget,
         rres.init_source, rres.optimizer)


def test_fit_dense_matches_reference(task):
    """Exact engine, 5 L-BFGS iterations: fitted raw parameters, FitResult.x
    and the objective to 1e-6, and the same iteration and evaluation counts
    (measured gap ~3e-13)."""
    cfg = dict(backend="dense", lbfgs_iters=5)
    state = fit(task.X, task.t, task.Y, task.mask, LKGPConfig(**cfg),
                device="cpu")
    ref = _ref_fit(task, **cfg)
    _assert_same_fit(state, ref, 1e-6)
    assert state.backend_used == "dense" and ref.backend_used == "dense"
    assert getattr(state, "engine", None) is None
    for name in ("X", "t", "Y", "mask"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    # the fitted state serves: the dense posterior mean of both packages
    np.testing.assert_allclose(posterior(state, device="cpu").mean.numpy(),
                               np.asarray(ref_core.posterior(ref).mean),
                               atol=1e-8)


def test_fit_iterative_with_the_reference_probes_matches_reference(
        task, monkeypatch):
    """Iterative engine (CG + SLQ at cg_tol 1e-6), the reference's probes
    (PRNGKey(seed)) handed in through a patched ``rademacher_probes``: the
    fitted raw parameters to 1e-5 (the two CG runs stop within cg_tol of
    each other; measured gap ~3e-6)."""
    cfg = dict(backend="iterative", lbfgs_iters=5, cg_tol=1e-6,
               slq_probes=8, seed=4)
    z = np.asarray(ref_core.rademacher_probes(
        jax.random.PRNGKey(4), 8, jnp.asarray(task.mask), jnp.float64))
    drawn = []

    def reference_probes(gen, n_probes, mask, dtype):
        drawn.append((n_probes, dtype))
        return probes_from_numpy(z, mask)

    monkeypatch.setattr(state_mod, "rademacher_probes", reference_probes)
    state = fit(task.X, task.t, task.Y, task.mask, LKGPConfig(**cfg),
                device="cpu")
    assert drawn == [(8, torch.float64)]
    _assert_same_fit(state, _ref_fit(task, **cfg), 1e-5)


def test_fit_through_the_kernel_engine_on_the_cpu(task, monkeypatch):
    """backend="cuda" on CPU tensors: every sweep takes the kernel wrapper's
    plain version. Each objective evaluation costs exactly the stacked
    solve's CG iterations plus 2 sweeps (A(alpha), A(probes) in the
    gradient); the result is finite and the objective went down."""
    from repro_torch.kernels.lk_mvm import MVMLaunch

    sweeps = []
    real = MVMLaunch.__call__
    monkeypatch.setattr(MVMLaunch, "__call__",
                        lambda *a, **k: sweeps.append(1) or real(*a, **k))
    built = []

    class Recording(KernelEngine):
        def operator_from_grams(self, *a):
            built.append(super().operator_from_grams(*a))
            return built[-1]

    cfg = LKGPConfig(backend="cuda", lbfgs_iters=4, cg_tol=1e-3)
    engine = Recording()
    state = fit(task.X, task.t, task.Y, task.mask, cfg, engine=engine,
                device="cpu")
    res = state.fit_result
    assert state.backend_used == "cuda" and state.engine is engine
    solves = [A.last_result for A in built if hasattr(A, "last_result")]
    assert len(solves) == res.n_evals == len(built) // 2
    assert len(sweeps) == sum(int(r.iters) + 2 for r in solves)
    assert all(float(r.rel_residual.max()) <= 1e-3 for r in solves)
    assert all(bool(torch.isfinite(p).all()) for p in state.params)
    f0 = fit(task.X, task.t, task.Y, task.mask, cfg, polish_steps=0,
             device="cpu").fit_result.fun
    assert np.isfinite(res.fun) and res.fun < f0
    # the state keeps its engine: posterior() solves through it
    n = len(built)
    posterior(state, device="cpu").mean
    assert len(built) == n + 1


def test_fit_init_options(task):
    """polish_steps=0 returns the init bitwise with one evaluation; explicit
    params, params0 and the reference's precedence; polish_steps > 0 (as an
    argument or from the config) runs the fixed-budget polish; the amortized
    init (an untrained encoder: the default init in float32) by argument, by
    a passed amortizer and by the config, and its error without an
    encoder."""
    cfg = LKGPConfig(backend="dense", lbfgs_iters=3)
    p0 = init_params(D, device="cpu")
    s0 = fit(task.X, task.t, task.Y, task.mask, cfg, polish_steps=0,
             device="cpu")
    r0 = ref_core.fit(task.X, task.t, task.Y, task.mask,
                      ref_core.LKGPConfig(backend="dense", lbfgs_iters=3),
                      polish_steps=0)
    assert all(torch.equal(a, b) for a, b in zip(s0.params, p0))
    res = s0.fit_result
    assert (res.n_iters, res.n_evals, res.converged, res.optimizer,
            res.init_source) == (0, 1, False, "none", "default")
    np.testing.assert_allclose(res.fun, r0.fit_result.fun, rtol=1e-12)
    explicit = p0._replace(raw_noise=torch.tensor(-2.0, dtype=torch.float64))
    for kw in (dict(init=explicit), dict(params0=explicit),
               dict(init=explicit, params0=p0)):
        s = fit(task.X, task.t, task.Y, task.mask, cfg, polish_steps=0,
                device="cpu", **kw)
        assert s.fit_result.init_source == "params"
        assert float(s.params.raw_noise) == -2.0
    with pytest.raises(ValueError, match="unknown init"):
        fit(task.X, task.t, task.Y, task.mask, cfg, init="nope", device="cpu")
    from repro_torch.amortize import (Amortizer, AmortizerConfig,
                                      clear_amortizer_registry,
                                      init_amortizer, register_amortizer)
    acfg = AmortizerConfig(d=D, d_model=8, curve_layers=1, num_heads=2,
                           d_ff=8)
    am = Amortizer(acfg, init_amortizer(torch.Generator().manual_seed(0),
                                        acfg))
    untrained = init_params(D, torch.float32, "cpu")
    clear_amortizer_registry()
    with pytest.raises(ValueError, match="no amortizer registered"):
        fit(task.X, task.t, task.Y, task.mask, cfg, init="amortized",
            device="cpu")
    register_amortizer(am)
    try:
        for c, kw in ((cfg, dict(init="amortized")), (cfg, dict(amortizer=am)),
                      (LKGPConfig(backend="dense", hyper_init="amortized"),
                       {})):
            s = fit(task.X, task.t, task.Y, task.mask, c, polish_steps=0,
                    device="cpu", **kw)
            assert s.fit_result.init_source == "amortized"
            assert all(torch.equal(a, b.double())
                       for a, b in zip(s.params, untrained))
    finally:
        clear_amortizer_registry()
    for state in (fit(task.X, task.t, task.Y, task.mask, cfg, polish_steps=3,
                      device="cpu"),
                  fit(task.X, task.t, task.Y, task.mask,
                      LKGPConfig(backend="dense", polish_steps=3),
                      device="cpu")):
        res = state.fit_result
        assert (res.optimizer, res.n_iters, res.n_evals, res.budget) == \
            ("polish", 3, 13, 3)


def test_fit_validates_observations(task):
    Y = task.Y.copy()
    Y[0, 0] = np.nan
    with pytest.raises(errors.ObservationError, match=r"\(0, 0\)"):
        fit(task.X, task.t, Y, task.mask, device="cpu")
    with pytest.raises(errors.ObservationError, match="does not match"):
        fit(task.X, task.t, task.Y[:, :-1], task.mask, device="cpu")
    # NaN where nothing is observed is legal and zeroed
    Y = task.Y.copy()
    Y[task.mask == 0] = np.nan
    state = fit(task.X, task.t, Y, task.mask, LKGPConfig(lbfgs_iters=1),
                device="cpu")
    assert bool(torch.isfinite(state.Y).all())
    assert state.backend_used == "dense"          # auto, small N
