"""PyTorch port, the solver stack: the pivoted-Cholesky preconditioner, PCG,
SGD, the solver registry through the engines, the MLL and the Matheron draws
through them, and the ``core.cg`` deprecation shim, each against the
reference on the same numpy inputs (float64; random draws made once by the
reference's PRNG and handed across)."""
import jax

jax.config.update("jax_enable_x64", True)

import importlib  # noqa: E402
import sys  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.core as ref_core  # noqa: E402
from repro.core import precond as ref_precond  # noqa: E402
from repro.core.matheron import \
    sample_posterior_grid as ref_sample_grid  # noqa: E402
from repro.core.solvers import estimate_lmax as ref_estimate_lmax  # noqa: E402
from repro.core.solvers import pcg_solve as ref_pcg_solve  # noqa: E402
from repro.core.solvers import sgd_solve as ref_sgd_solve  # noqa: E402
from repro_torch.core import (LKGPConfig, cg_solve, estimate_lmax,  # noqa: E402
                              fit, get_engine, get_solver, grid_to_packed,
                              init_params, lk_operator, make_mll,
                              packed_to_grid, pcg_solve,
                              pivoted_cholesky_grid, pivoted_cholesky_latent,
                              posterior, sgd_solve, woodbury_preconditioner)
from repro_torch.core.matheron import sample_posterior_grid  # noqa: E402
from repro_torch.core.solvers.cg import REPLACE_EVERY  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _lk_problem(n=12, m=10, d=3, seed=0, noise=0.05):
    """The reference solver tests' system (its PRNG's draws), as numpy."""
    key = jax.random.PRNGKey(seed)
    kx, ky, kl = jax.random.split(key, 3)
    X = jax.random.uniform(kx, (n, d), jnp.float64)
    t = jnp.linspace(0.05, 1.0, m).astype(jnp.float64)
    K1, K2 = ref_core.gram_matrices(ref_core.init_params(d, jnp.float64), X, t)
    lens = jax.random.randint(kl, (n,), m // 2, m + 1)
    mask = (jnp.arange(m)[None, :] < lens[:, None]).astype(jnp.float64)
    Y = jax.random.normal(ky, (n, m), jnp.float64) * mask
    return (*(np.asarray(a) for a in (K1, K2, mask, Y)), noise)


def _operators(K1, K2, mask, noise, backend="iterative"):
    """(port operator, reference operator) of one engine slot."""
    A = get_engine(backend).operator_from_grams(_t(K1), _t(K2), _t(mask),
                                                noise)
    RA = ref_core.get_engine("iterative").operator_from_grams(
        *map(jnp.asarray, (K1, K2, mask)), noise)
    return A, RA


def _tie_free(n=10, m=7, seed=0):
    """Kronecker factors with distinct diagonals (no pivot ties, so both
    packages pick the same pivots whatever their rounding) and a ragged
    mask."""
    rng = np.random.default_rng(seed)
    A0, B0 = rng.standard_normal((n, n)), rng.standard_normal((m, m))
    K1 = A0 @ A0.T / n + np.diag(rng.uniform(0.5, 1.5, n))
    K2 = B0 @ B0.T / m + np.diag(rng.uniform(0.5, 1.5, m))
    mask = (np.arange(m)[None] < rng.integers(2, m + 1, n)[:, None]) * 1.0
    return K1, K2, mask


# --------------------------------------------------------------------------
# the preconditioner
# --------------------------------------------------------------------------
@pytest.mark.parametrize("rank", [1, 6, 20, 80])
def test_pivoted_cholesky_matches_reference(rank):
    """Grid and packed factorisations against the reference's (1e-10): the
    grid factor is zero on unobserved cells, and on the observed ones it is
    the packed factor (the same pivots). Past the observed count the packed
    factor stops and the grid factor's extra columns are zero."""
    K1, K2, mask = _tie_free()
    G = pivoted_cholesky_grid(_t(K1), _t(K2), _t(mask), rank)
    RG = ref_precond.pivoted_cholesky_grid(*map(jnp.asarray, (K1, K2, mask)),
                                           rank)
    assert G.shape == (mask.size, rank) and G.dtype == torch.float64
    _close(G, RG, 1e-10)
    P = pivoted_cholesky_latent(_t(K1), _t(K2), mask, rank)
    RP = ref_precond.pivoted_cholesky_latent(K1, K2, mask, rank)
    assert P.shape == RP.shape == (int(mask.sum()), min(rank, int(mask.sum())))
    _close(P, RP, 1e-10)
    obs = mask.reshape(-1) > 0
    assert float(G[torch.from_numpy(~obs)].abs().max()) == 0.0
    _close(G[torch.from_numpy(obs)][:, :P.shape[1]], P, 1e-10)
    if rank > P.shape[1]:
        assert float(G[:, P.shape[1]:].abs().max()) == 0.0


def test_woodbury_preconditioner_matches_reference_and_inverts():
    K1, K2, mask = _tie_free(seed=1)
    noise = 0.3
    L = pivoted_cholesky_grid(_t(K1), _t(K2), _t(mask), 8)
    RL = jnp.asarray(L.numpy())
    M_inv = woodbury_preconditioner(L, noise)
    RM_inv = ref_precond.woodbury_preconditioner(RL, noise)
    v = np.random.default_rng(2).standard_normal((3, mask.size))
    _close(M_inv(_t(v)), RM_inv(jnp.asarray(v)), 1e-10)
    _close(M_inv(_t(v[0])), RM_inv(jnp.asarray(v[0])), 1e-10)
    M = L @ L.T + noise * torch.eye(mask.size, dtype=torch.float64)
    _close(M_inv(_t(v) @ M.T), v, 1e-10)


def test_operator_preconditioner_is_cached_per_rank_from_float64_factors():
    """The engines' operators build M^-1 once per rank from the detached
    factors in the state's dtype (for ``cuda``, not the float32 copies)."""
    K1, K2, mask, Y, noise = _lk_problem()
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, mask.size)))
    want = woodbury_preconditioner(
        pivoted_cholesky_grid(_t(K1), _t(K2), _t(mask), 5),
        torch.tensor(noise, dtype=torch.float64))(v)
    for backend in ("iterative", "cuda"):
        A, _ = _operators(K1, K2, mask, noise, backend)
        M5 = A.preconditioner(5)
        assert A.preconditioner(5) is M5 and A.preconditioner(6) is not M5
        assert A.preconditioner(5) is not M5      # one rank cached at a time
        assert torch.equal(A.preconditioner(5)(v), want)


# --------------------------------------------------------------------------
# PCG
# --------------------------------------------------------------------------
def test_pcg_solve_matches_reference_iteration_for_iteration():
    """Packed PCG with the pivoted-Cholesky preconditioner on a stack with an
    easy and an all-zero column: the same iteration counts, per-column
    freezing and MVM counts as the reference, solutions to 1e-9."""
    K1, K2, mask, Y, noise = _lk_problem(seed=1, noise=1e-3)
    A = lk_operator(_t(K1), _t(K2), _t(mask), noise)
    RA = ref_core.lk_operator(*map(jnp.asarray, (K1, K2, mask)), noise)

    def packed(op, to_packed, to_grid):
        return lambda v: to_packed(op(to_grid(v)))

    from repro.core.mvm import grid_to_packed as r_g2p
    from repro.core.mvm import packed_to_grid as r_p2g
    b = np.stack([Y, 1e-3 * Y, 0.0 * Y])
    bp = grid_to_packed(_t(b), mask)
    M_inv = woodbury_preconditioner(
        pivoted_cholesky_latent(_t(K1), _t(K2), mask, 10), noise)
    RM_inv = ref_precond.woodbury_preconditioner(
        ref_precond.pivoted_cholesky_latent(K1, K2, mask, 10), noise)
    got = pcg_solve(packed(A, lambda g: grid_to_packed(g, mask),
                           lambda p: packed_to_grid(p, mask)),
                    bp, M_inv, tol=1e-9, max_iters=500)
    want = ref_pcg_solve(packed(RA, lambda g: r_g2p(g, mask),
                                lambda p: r_p2g(p, mask)),
                         jnp.asarray(bp.numpy()), RM_inv, tol=1e-9,
                         max_iters=500)
    assert int(got.iters) == int(want.iters) > 0
    np.testing.assert_array_equal(got.col_iters.numpy(),
                                  np.asarray(want.col_iters))
    assert int(got.col_iters[2]) == 0 and got.replacements == 0
    assert int(got.matvecs) == int(want.matvecs)
    assert not bool(got.breakdown.any())
    _close(got.x, want.x, 1e-9 * float(np.abs(np.asarray(want.x)).max()))
    # residuals at tol are rounding-sensitive: each is held to tol and to
    # its own solution's true residual, not to the other's (ROADMAP caveat)
    r = bp - grid_to_packed(A(packed_to_grid(got.x, mask)), mask)
    true = torch.sqrt((r * r).sum(-1)) / torch.sqrt(
        (bp * bp).sum(-1)).clamp_min(1e-300)
    _close(got.rel_residual, true, 1e-12)
    assert float(got.rel_residual.max()) <= 1e-9
    assert float(np.max(np.asarray(want.rel_residual))) <= 1e-9
    # plain CG needs more iterations on this ill-conditioned system
    plain = cg_solve(A, _t(b), tol=1e-9, max_iters=2000)
    assert int(got.iters) < int(plain.iters) / 2


def test_pcg_warm_start_reduces_iterations():
    """As the reference's: a restart from the solution costs at most one
    iteration, a nearby start fewer than a cold one. The system's condition
    number is 1e5, so the counts of the two packages part by a few
    iterations of rounding; the solutions agree."""
    N = 60
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    M = Q @ np.diag(np.logspace(0.0, -5.0, N)) @ Q.T
    b = rng.standard_normal(N)
    A = lambda u: u @ _t(M).T   # noqa: E731
    RA = lambda u: (jnp.asarray(M) @ u[..., None])[..., 0]   # noqa: E731
    M_inv = lambda r: r / _t(np.diag(M))   # noqa: E731
    RM_inv = lambda r: r / jnp.asarray(np.diag(M))   # noqa: E731
    cold = pcg_solve(A, _t(b), M_inv, tol=1e-8, max_iters=2000)
    rcold = ref_pcg_solve(RA, jnp.asarray(b), RM_inv, tol=1e-8,
                          max_iters=2000)
    for x0 in (cold.x, cold.x * (1 + 1e-4)):
        warm = pcg_solve(A, _t(b), M_inv, tol=1e-8, max_iters=2000, x0=x0)
        rwarm = ref_pcg_solve(RA, jnp.asarray(b), RM_inv, tol=1e-8,
                              max_iters=2000, x0=jnp.asarray(x0.numpy()))
        assert int(warm.iters) < int(cold.iters)
        assert int(rwarm.iters) < int(rcold.iters)
        _close(warm.x, cold.x, 1e-6)
        _close(warm.x, rwarm.x, 1e-6)
    assert int(cold.iters) > 1
    _close(cold.x, rcold.x, 1e-6)
    assert int(pcg_solve(A, _t(b), M_inv, tol=1e-8, max_iters=2000,
                         x0=cold.x).iters) <= 1


def test_pcg_breakdown_flag_on_indefinite_operator():
    N = 12
    d = np.array([1.0, -1.0] * (N // 2))
    res = pcg_solve(lambda u: _t(d) * u, torch.ones(N, dtype=torch.float64),
                    lambda r: r, tol=1e-10, max_iters=50)
    ref = ref_pcg_solve(lambda u: jnp.asarray(d) * u, jnp.ones(N),
                        lambda r: r, tol=1e-10, max_iters=50)
    assert bool(res.breakdown) and bool(ref.breakdown)
    assert int(res.iters) == int(ref.iters)


def test_engine_solve_threads_x0_through_pcg():
    """``IterativeEngine.solve(x0=...)`` reaches the preconditioned solver:
    the warm solve repeats in fewer iterations, the counts the
    reference's."""
    K1, K2, mask, Y, noise = _lk_problem()
    cfg = LKGPConfig(cg_tol=1e-8, cg_max_iters=2000, precond_rank=8)
    rcfg = ref_core.LKGPConfig(cg_tol=1e-8, cg_max_iters=2000, precond_rank=8)
    eng, reng = get_engine("iterative"), ref_core.get_engine("iterative")
    A, RA = _operators(K1, K2, mask, noise)
    x = eng.solve(A, _t(Y), cfg)
    cold = A.last_result
    rx = reng.solve(RA, jnp.asarray(Y), rcfg)
    assert [s.solver for s in cold.trace] == ["pcg"]
    assert int(cold.iters) == int(RA.last_result.iters) > 0
    _close(x, rx, 1e-9)
    eng.solve(A, _t(Y), cfg, x0=x)
    reng.solve(RA, jnp.asarray(Y), rcfg, x0=rx)
    assert int(A.last_result.iters) == int(RA.last_result.iters) \
        < int(cold.iters)


class _Counting:
    """An operator wrapper counting its (fast) sweeps, delegating the rest
    (``accurate``, ``mask``, ``preconditioner``) to the base."""

    def __init__(self, base):
        self._base = base
        self.sweeps = 0

    def __call__(self, u):
        self.sweeps += 1
        return self._base(u)

    def __getattr__(self, name):
        return getattr(self._base, name)


@pytest.mark.parametrize("tol", [1e-9, 1e-12])
def test_pcg_with_a_float32_operator_reaches_float64_tolerances(tol):
    """The ``cuda`` engine's operator on the CPU (float32 sweeps, float64
    ``accurate``) through PCG: the true residuals come from ``accurate``
    (replacements), so PCG reaches tolerances no float32 sweep reaches by
    itself and reports float64 residuals; every iteration is ONE fast sweep
    (the kernel's launch on the card) and nothing else is."""
    K1, K2, mask, Y, noise = _lk_problem(seed=2)
    A, _ = _operators(K1, K2, mask, noise, "cuda")
    op = _Counting(A)
    rhs = torch.stack([_t(Y), 0.5 * _t(Y) + 0.1 * _t(mask)])
    cfg = LKGPConfig(cg_tol=tol, cg_max_iters=3000, precond_rank=10)
    res = get_solver("pcg").solve(op, rhs, cfg)
    assert op.sweeps == int(res.iters) and int(res.iters) < 3000
    assert res.replacements >= 1 and not bool(res.breakdown.any())
    r = rhs - A.accurate(res.x)
    rel = torch.sqrt((r * r).sum((-2, -1)) / (rhs * rhs).sum((-2, -1)))
    assert float(rel.max()) <= tol
    torch.testing.assert_close(rel, res.rel_residual, rtol=1e-6, atol=0)
    if int(res.iters) >= REPLACE_EVERY:
        assert res.replacements >= int(res.iters) // REPLACE_EVERY


def test_pcg_solver_without_factors_falls_back_to_cg():
    K1, K2, mask, Y, noise = _lk_problem()
    A, _ = _operators(K1, K2, mask, noise)
    bare = lambda u: A(u)   # noqa: E731 - a closure: nothing to precondition
    cfg = LKGPConfig(solver="pcg", cg_tol=1e-8)
    got = get_solver("pcg").solve(bare, _t(Y), cfg)
    want = get_solver("cg").solve(bare, _t(Y), cfg)
    assert torch.equal(got.x, want.x) and int(got.iters) == int(want.iters)


# --------------------------------------------------------------------------
# SGD
# --------------------------------------------------------------------------
def test_sgd_solve_matches_reference_and_cg():
    """Heavy-ball SGD against the reference's: the same iteration count and
    solution, and the CG solution to solver tolerance."""
    K1, K2, mask, Y, noise = _lk_problem(seed=2)
    A, RA = _operators(K1, K2, mask, noise)
    got = sgd_solve(A, _t(Y), tol=1e-8, max_iters=20_000)
    want = ref_sgd_solve(RA, jnp.asarray(Y), tol=1e-8, max_iters=20_000)
    assert int(got.iters) == int(want.iters) > 0
    assert int(got.matvecs) == int(want.matvecs)
    assert not bool(got.breakdown.any()) and got.col_iters is not None
    assert float(got.rel_residual.max()) <= 1e-7
    _close(got.x, want.x, 1e-9)
    _close(got.x, cg_solve(A, _t(Y), tol=1e-10, max_iters=4000).x, 1e-5)


def test_sgd_polyak_average_at_the_budget_matches_reference():
    """A budget far short of tol: both run every sweep, and the Polyak
    tail average (chosen per system by its tracked residual) gives the
    reference's solution."""
    K1, K2, mask, Y, noise = _lk_problem(seed=3)
    A, RA = _operators(K1, K2, mask, noise)
    rhs = np.stack([Y, np.roll(Y, 1, axis=0) * mask])
    for momentum in (0.9, 0.0):
        got = sgd_solve(A, _t(rhs), tol=1e-14, max_iters=120,
                        momentum=momentum)
        want = ref_sgd_solve(RA, jnp.asarray(rhs), tol=1e-14, max_iters=120,
                             momentum=momentum)
        assert int(got.iters) == int(want.iters) == 120
        _close(got.x, want.x, 1e-10)
        _close(got.rel_residual, want.rel_residual, 1e-10)


def test_sgd_batched_rhs_and_per_column_freezing():
    """A column warm-started at its solution is converged from sweep 0 and
    costs no MVM; the other runs to tol (as in the reference)."""
    K1, K2, mask, Y, noise = _lk_problem(seed=4)
    A, _ = _operators(K1, K2, mask, noise)
    x_star = cg_solve(A, _t(Y), tol=1e-12, max_iters=4000).x
    hard = _t(Y) + 0.3 * torch.roll(_t(Y), 1, 0) * _t(mask)
    res = sgd_solve(A, torch.stack([_t(Y), hard]), tol=1e-6,
                    max_iters=20_000,
                    x0=torch.stack([x_star, torch.zeros_like(x_star)]))
    iters = int(res.iters)
    assert iters > 0 and int(res.col_iters[0]) == 0
    assert int(res.col_iters[1]) == iters == int(res.matvecs)
    assert res.col_iters.dtype == torch.int32
    assert float(res.rel_residual.max()) <= 1e-6
    warm = sgd_solve(A, _t(Y), tol=1e-6, max_iters=20_000, x0=x_star)
    assert int(warm.iters) == 0


def test_sgd_breakdown_flag_on_divergence():
    """A far too large learning rate diverges: the non-finite residual
    flags breakdown instead of looping to max_iters, at the reference's
    sweep."""
    K1, K2, mask, Y, noise = _lk_problem(seed=6)
    A, RA = _operators(K1, K2, mask, noise)
    res = sgd_solve(A, _t(Y), tol=1e-10, max_iters=5000, lr=1e6)
    ref = ref_sgd_solve(RA, jnp.asarray(Y), tol=1e-10, max_iters=5000,
                        lr=1e6)
    assert bool(res.breakdown.all()) and int(res.iters) < 5000
    assert int(res.iters) == int(ref.iters)


def test_estimate_lmax_bounds_spectrum_and_matches_reference():
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    M = Q @ np.diag(np.linspace(1.0, 50.0, 30)) @ Q.T
    b = rng.standard_normal((6, 5))
    est = float(estimate_lmax(lambda u: (_t(M) @ u.reshape(-1, 1)).reshape(
        u.shape), _t(b), iters=30))
    ref = float(ref_estimate_lmax(lambda u: (jnp.asarray(M) @ u.reshape(
        -1, 1)).reshape(u.shape), jnp.asarray(b), iters=30))
    assert 0.8 * 50.0 <= est <= 50.0 * (1 + 1e-6)
    assert est == pytest.approx(ref, rel=1e-12)


def test_engine_solver_config_selects_sgd():
    """``solver="sgd"`` reaches SGDSolver through the engine (the CG answer
    to solver tolerance), and its stacked solve fuses no log-det."""
    K1, K2, mask, Y, noise = _lk_problem(seed=7)
    eng = get_engine("iterative")
    A, _ = _operators(K1, K2, mask, noise)
    x_cg = eng.solve(A, _t(Y), LKGPConfig(solver="cg", cg_tol=1e-10,
                                          cg_max_iters=4000))
    cfg_sgd = LKGPConfig(solver="sgd", cg_tol=1e-8, sgd_iters=20_000)
    x_sgd = eng.solve(A, _t(Y), cfg_sgd)
    assert A.last_result.trace[0].solver == "sgd"
    _close(x_sgd, x_cg, 1e-5)
    st = eng.solve_stacked(A, _t(Y)[None], cfg_sgd, probe_cols=1,
                           subspace_dim=float(mask.sum()))
    assert st.logdet is None


# --------------------------------------------------------------------------
# through the objective and the posterior
# --------------------------------------------------------------------------
def _mll_inputs(seed=3, n=6, m=6, d=4, n_probes=32):
    from repro.data import sample_task
    task = sample_task(seed=seed, n=n, m=m, d=d)
    probes = ref_core.rademacher_probes(jax.random.PRNGKey(0), n_probes,
                                        jnp.asarray(task.mask), jnp.float64)
    return task, np.asarray(probes)


@pytest.mark.parametrize("solver", ["pcg", "sgd"])
def test_mll_through_pcg_and_sgd_matches_reference(solver):
    """With a PCG or SGD solve the fused log-det is gone and the objective
    runs SLQ separately (Lanczos on the same probes): value and gradient
    against the reference's on the same probes, and the value within the
    estimator's spread of the CG objective's."""
    task, probes = _mll_inputs()
    base = dict(cg_tol=1e-10, cg_max_iters=2000, slq_iters=12,
                sgd_iters=20_000)
    kw = dict(precond_rank=6) if solver == "pcg" else dict(solver="sgd")
    args = [task.X, task.t, task.Y, task.mask]

    def ours(cfg):
        p = [a.clone().requires_grad_() for a in init_params(4, device="cpu")]
        from repro_torch.core import LKGPParams
        v = make_mll(cfg, get_engine("iterative"))(
            LKGPParams(*p), *(_t(a) for a in args), _t(probes))
        grads = torch.autograd.grad(v, p)
        return float(v.detach()), np.concatenate(
            [g.reshape(-1).numpy() for g in grads])

    def theirs(cfg):
        mll = ref_core.make_mll(cfg, ref_core.get_engine("iterative"))
        f = lambda p: mll(p, *map(jnp.asarray, args),   # noqa: E731
                          jnp.asarray(probes))
        params = ref_core.init_params(4, jnp.float64)
        v, g = jax.value_and_grad(f)(params)
        return float(v), np.concatenate(
            [np.ravel(x) for x in jax.tree_util.tree_leaves(g)])

    v, g = ours(LKGPConfig(**base, **kw))
    rv, rg = theirs(ref_core.LKGPConfig(**base, **kw))
    assert abs(v - rv) <= 1e-7 * abs(rv)
    _close(g, rg, 1e-6 * np.abs(rg).max())
    v_cg, _ = ours(LKGPConfig(**base))
    assert abs(v - v_cg) <= 0.02 * abs(v_cg)


def _nonuniform_task(seed=11, n=10, m=9, d=3):
    """The reference's backend x solver task: a log-spaced progression grid
    and a missing-values mask (its PRNG's draws)."""
    key = jax.random.PRNGKey(seed)
    kx, ky, kl = jax.random.split(key, 3)
    X = jax.random.uniform(kx, (n, d), jnp.float64)
    t = np.geomspace(1.0, 50.0, m)
    lens = jax.random.randint(kl, (n,), m // 2, m + 1)
    mask = (jnp.arange(m)[None, :] < lens[:, None]).astype(jnp.float64)
    Y = jax.random.normal(ky, (n, m), jnp.float64) * mask
    return tuple(np.asarray(a) for a in (X, t, Y, mask))


def _posterior_cell(backend, solver, task):
    cfg = LKGPConfig(backend=backend, solver=solver, lbfgs_iters=0,
                     cg_tol=1e-9, cg_max_iters=4000, sgd_iters=30_000,
                     posterior_samples=64, seed=0)
    state = fit(*task, cfg, device="cpu")
    post = posterior(state, engine=get_engine(backend), device="cpu")
    f_mean, f_var = post.final()
    return [a.numpy() for a in (post.mean, post.variance, f_mean, f_var)]


@pytest.fixture(scope="module")
def dense_cell():
    task = _nonuniform_task()
    cfg = ref_core.LKGPConfig(backend="dense", lbfgs_iters=0, seed=0)
    rstate = ref_core.fit(*task, cfg)
    rpost = ref_core.posterior(rstate)
    return task, _posterior_cell("dense", "auto", task), (
        np.asarray(rpost.mean), np.asarray(rpost.final()[0]))


@pytest.mark.parametrize("backend,solver", [
    ("iterative", "cg"), ("iterative", "sgd"), ("iterative", "pcg"),
    ("distributed", "cg"), ("cuda", "pcg"),
])
def test_backend_solver_posterior_parity_matrix(backend, solver, dense_cell):
    """Every (backend, solver) cell's posterior against the exact dense one
    (the reference test's cells, plus PCG): the same seed makes the Matheron
    draws shared, so the cells differ only through their solves; the means
    against the reference's dense posterior too. The float32 ``cuda`` sweeps
    reach cg_tol=1e-9 through ``accurate``."""
    task, (ref_mean, ref_var, ref_fm, ref_fv), (jmean, jfm) = dense_cell
    mean, var, f_mean, f_var = _posterior_cell(backend, solver, task)
    np.testing.assert_allclose(mean, ref_mean, atol=1e-4)
    np.testing.assert_allclose(f_mean, ref_fm, atol=1e-4)
    np.testing.assert_allclose(mean, jmean, atol=1e-4)
    np.testing.assert_allclose(f_mean, jfm, atol=1e-4)
    # variance is a shared-draw Matheron MC estimate: solver error only
    np.testing.assert_allclose(var, ref_var, atol=1e-3)
    np.testing.assert_allclose(f_var, ref_fv, atol=1e-3)
    assert np.all(var >= 0) and np.all(f_var >= 0)


def test_matheron_pathwise_sgd_matches_cg_and_reference_samples():
    """``sample_posterior_grid(solver="sgd")``: every pathwise draw an SGD
    solve. With the reference's normals handed across, the samples match
    the CG path and the reference's SGD samples to solver tolerance."""
    K1, K2, mask, Y, noise = _lk_problem(n=8, m=6, seed=8)
    key = jax.random.PRNGKey(0)
    kz, ke = jax.random.split(key)
    normals = (np.asarray(jax.random.normal(kz, (4, 8, 6), jnp.float64)),
               np.asarray(jax.random.normal(ke, (4, 8, 6), jnp.float64)))
    kw = dict(n_train=8, mask=mask, noise=noise, n_samples=4, cg_tol=1e-9,
              cg_max_iters=20_000)
    s_cg, s_sgd = (sample_posterior_grid(
        None, _t(K1), _t(K2), Y=_t(Y), normals=normals, solver=solver,
        **{**kw, "mask": _t(mask)}) for solver in ("cg", "sgd"))
    r_sgd = ref_sample_grid(key, *map(jnp.asarray, (K1, K2)),
                            Y=jnp.asarray(Y), solver="sgd", **kw)
    assert s_sgd.shape == s_cg.shape == (4, 8, 6)
    _close(s_sgd, s_cg, 1e-4)
    _close(s_sgd, r_sgd, 1e-4)


# --------------------------------------------------------------------------
# the deprecation shim
# --------------------------------------------------------------------------
def test_core_cg_shim_warns_and_reexports():
    sys.modules.pop("repro_torch.core.cg", None)
    with pytest.warns(DeprecationWarning, match="repro_torch.core.solvers"):
        shim = importlib.import_module("repro_torch.core.cg")
    from repro_torch.core import solvers
    for name in ("cg_solve", "cg_solve_tridiag", "pcg_solve", "CGResult",
                 "CGTridiag"):
        assert getattr(shim, name) is getattr(solvers, name)
    assert sorted(shim.__all__) == sorted(importlib.import_module(
        "repro.core.cg").__all__)
