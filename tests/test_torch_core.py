"""PyTorch port, model core: transforms, parameters, Gram matrices, backend
resolution, the task sampler, block CG and the engine/solver registries, each
against its counterpart in the reference on the same numpy inputs (float64).
"""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import transforms as ref_tf
from repro.core.solvers import cg_solve as ref_cg_solve
from repro.core.solvers import cg_solve_tridiag as ref_cg_solve_tridiag
from repro.data import sample_task as ref_sample_task
from repro_torch.core import (BACKENDS, CGSolver, CustomMVMEngine,
                              DegradedSolveError, GPData, GuardedSolveError,
                              LKGPConfig, LKGPParams, PCGSolver, SGDSolver,
                              cg_solve, cg_solve_tridiag, get_engine,
                              get_solver, gram_matrices, init_params,
                              list_backends, list_solvers, lk_mvm,
                              lk_operator, make_mll, rademacher_probes,
                              resolve_backend, resolve_solver, solve_tally)
from repro_torch.core import transforms as tf
from repro_torch.core.engines import KernelEngine, LatentKroneckerOperator
from repro_torch.core.solvers.cg import REPLACE_EVERY
from repro_torch.data import sample_task


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# --------------------------------------------------------------------------
# data, transforms, params, grams
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=3, n=6, m=6, d=4), dict(seed=7, n=40, m=25, d=7),
    dict(seed=1, n=9, m=12, d=5, crossing=True),
    dict(seed=2, n=8, t=np.array([1.0, 2.0, 4.0, 8.0, 16.0, 50.0])),
    dict(seed=5, n=30, m=20, diverge_prob=0.5, spike_prob=0.2),
])
def test_sample_task_is_bit_equal_to_reference(kw):
    got, want = sample_task(**kw), ref_sample_task(**kw)
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sample_task_rejects_bad_grid():
    with pytest.raises(ValueError, match="strictly-increasing"):
        sample_task(0, t=np.array([1.0, 1.0, 2.0]))


@pytest.mark.parametrize("seed", [0, 1])
def test_transforms_match_reference(seed):
    task = sample_task(seed, n=9, m=8, d=5)
    X = task.X.copy()
    X[:, 2] = 0.25                      # a constant dimension
    x_tf, rx = tf.XTransform.fit(_t(X)), ref_tf.XTransform.fit(jnp.asarray(X))
    _close(x_tf.lo, rx.lo), _close(x_tf.hi, rx.hi)
    _close(x_tf(_t(X)), rx(jnp.asarray(X)))
    t_tf, rt = tf.TTransform.fit(_t(task.t)), ref_tf.TTransform.fit(
        jnp.asarray(task.t))
    _close(t_tf.log_t1, rt.log_t1), _close(t_tf.log_tm, rt.log_tm)
    _close(t_tf(_t(task.t)), rt(jnp.asarray(task.t)))
    y_tf = tf.YTransform.fit(_t(task.Y), _t(task.mask))
    ry = ref_tf.YTransform.fit(jnp.asarray(task.Y), jnp.asarray(task.mask))
    _close(y_tf.shift, ry.shift), _close(y_tf.scale, ry.scale)
    Z = y_tf(_t(task.Y))
    _close(Z, ry(jnp.asarray(task.Y)))
    _close(y_tf.inverse(Z), task.Y)
    _close(y_tf.inverse_var(Z**2), ry.inverse_var(jnp.asarray(Z.numpy())**2))


def test_ttransform_single_progression_does_not_divide_by_zero():
    t = np.array([3.0])
    got, want = tf.TTransform.fit(_t(t)), ref_tf.TTransform.fit(jnp.asarray(t))
    _close(got.log_tm, want.log_tm)
    _close(got(_t(t)), want(jnp.asarray(t)))


@pytest.mark.parametrize("d", [1, 4, 7])
def test_init_params_match_reference(d):
    got, want = init_params(d, device="cpu"), ref_core.init_params(d)
    assert isinstance(got, LKGPParams) and got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and tuple(a.shape) == b.shape
        _close(a, b, 0)
    assert init_params(3, torch.float32, device="cpu")[0].dtype == torch.float32


def test_init_params_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(4)


@pytest.mark.parametrize("t_kernel", ["matern12", "matern32", "matern52"])
def test_gram_matrices_match_reference(t_kernel):
    task = sample_task(4, n=11, m=9, d=5)
    rng = np.random.default_rng(0)
    raw = dict(raw_x_lengthscale=rng.normal(1.0, 0.3, 5),
               raw_t_lengthscale=np.float64(-1.1),
               raw_outputscale=np.float64(0.3), raw_noise=np.float64(-3.0))
    X = (task.X - task.X.min(0)) / (task.X.max(0) - task.X.min(0))
    t = np.log(task.t) / np.log(task.t[-1])
    K1, K2 = gram_matrices(LKGPParams(**{k: _t(v) for k, v in raw.items()}),
                           _t(X), _t(t), t_kernel, 1e-6)
    R1, R2 = ref_core.gram_matrices(
        ref_core.LKGPParams(**{k: jnp.asarray(v) for k, v in raw.items()}),
        jnp.asarray(X), jnp.asarray(t), t_kernel, 1e-6)
    _close(K1, R1), _close(K2, R2)


def test_config_has_the_reference_fields_and_defaults():
    want = dataclasses.asdict(ref_core.LKGPConfig())
    assert dataclasses.asdict(LKGPConfig()) == want
    assert dataclasses.asdict(LKGPConfig(**want)) == want


@pytest.mark.parametrize("cfg,n_obs,want", [
    (dict(), 10, "dense"), (dict(), 10_000, "iterative"),
    (dict(mll_method="cholesky"), 10_000, "dense"),
    (dict(mll_method="iterative"), 10, "iterative"),
    (dict(use_pallas=True), 10, "cuda"), (dict(backend="pallas"), 10, "cuda"),
    (dict(backend="cuda"), 10, "cuda"), (dict(backend="dense"), 10**6, "dense"),
])
def test_resolve_backend(cfg, n_obs, want):
    assert resolve_backend(LKGPConfig(**cfg), n_obs) == want
    assert want in BACKENDS
    # same routing as the reference, whose name for the kernel slot is "pallas"
    ref = ref_core.resolve_backend(ref_core.LKGPConfig(
        **{k: ("pallas" if v == "cuda" else v) for k, v in cfg.items()}), n_obs)
    assert {"pallas": "cuda"}.get(ref, ref) == want


def test_resolve_backend_unknown_and_unported():
    """Unknown names raise; "distributed", the last of the reference's
    backends, is ported and resolves as in the reference."""
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend(LKGPConfig(backend="nope"), 10)
    with pytest.raises(ValueError, match="unknown backend"):
        get_engine("nope")
    cfg = LKGPConfig(backend="distributed")
    assert resolve_backend(cfg, 10) == ref_core.resolve_backend(
        ref_core.LKGPConfig(backend="distributed"), 10) == "distributed"
    assert get_engine("distributed").name == "distributed"
    assert "distributed" in list_backends()


# --------------------------------------------------------------------------
# block CG vs the reference on a shared operator
# --------------------------------------------------------------------------
def _cg_problem(seed=0, B=5, n=12, m=9):
    rng = np.random.default_rng(seed)
    task = sample_task(seed, n=n, m=m, d=4)
    X = rng.uniform(size=(n, 3))
    d2 = ((X[:, None] - X[None]) ** 2).sum(-1)
    K1 = np.exp(-0.5 * d2 / 0.3) + 1e-6 * np.eye(n)
    tt = np.linspace(0, 1, m)
    K2 = 1.3 * np.exp(-np.abs(tt[:, None] - tt[None]) / 0.25) + 1e-6 * np.eye(m)
    b = rng.standard_normal((B, n, m)) * task.mask
    b[1] *= 1e-3                  # an easy, small column
    b[2] = 0.0                    # an all-zero right-hand side
    # Noise large enough that CG converges fast and monotonically: iteration
    # counts are then a property of the algorithm, not of rounding order.
    return K1, K2, task.mask, b, 0.5


def _both_operators(K1, K2, mask, noise):
    A = lk_operator(_t(K1), _t(K2), _t(mask), noise)
    RA = ref_core.lk_operator(jnp.asarray(K1), jnp.asarray(K2),
                              jnp.asarray(mask), noise)
    return A, RA


def _assert_same_result(got, want, x_tol):
    assert int(got.iters) == int(want.iters)
    assert got.iters.dtype == torch.int32 and got.col_iters.dtype == torch.int32
    np.testing.assert_array_equal(got.col_iters.numpy(),
                                  np.asarray(want.col_iters))
    np.testing.assert_array_equal(got.breakdown.numpy(),
                                  np.asarray(want.breakdown))
    assert int(got.matvecs) == int(want.matvecs)
    assert got.replacements == 0
    _close(got.x, want.x, x_tol)
    _close(got.rel_residual, want.rel_residual, 1e-9)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_cg_iterates_match_reference_step_for_step(k):
    """The update rules: after exactly k iterations (tol=0 keeps every
    non-zero column stepping) the iterates agree to 1e-10. Early iterates
    carry rounding only; later ones amplify it, which is CG, not the port."""
    K1, K2, mask, b, noise = _cg_problem()
    A, RA = _both_operators(K1, K2, mask, noise)
    got = cg_solve(A, _t(b), tol=0.0, max_iters=k)
    want = ref_cg_solve(RA, jnp.asarray(b), tol=0.0, max_iters=k)
    assert int(got.iters) == k
    _assert_same_result(got, want, x_tol=1e-10)
    assert got.col_iters.tolist() == [k, k, 0, k, k]
    assert int(got.matvecs) == 4 * k          # the zero RHS is never active


def test_cg_solve_stops_and_freezes_like_reference():
    K1, K2, mask, b, noise = _cg_problem()
    b[3] = 0.3 * b[0] + 1e-3 * b[3]   # nearly a copy of column 0: converges alike
    b[1] = K1 @ mask @ K2             # smooth: converges early
    b[1] *= mask
    A, RA = _both_operators(K1, K2, mask, noise)
    tol = 1e-2
    got = cg_solve(A, _t(b), tol=tol, max_iters=500)
    want = ref_cg_solve(RA, jnp.asarray(b), tol=tol, max_iters=500)
    # x to 1e-8: the iterates are only tol-accurate, and rounding differences
    # grow with the iteration (see the step-for-step test)
    _assert_same_result(got, want, x_tol=1e-8)
    # per-column freezing: columns stop at different iterations, the zero
    # RHS never starts, and frozen columns are not counted as matvecs
    ci = got.col_iters.tolist()
    assert ci[2] == 0 and ci[1] < max(ci) and int(got.iters) == max(ci)
    assert int(got.matvecs) == sum(ci)
    assert float(got.rel_residual.max()) <= tol * 1.01
    # a frozen column does not move while the others go on
    early = cg_solve(A, _t(b[1]), tol=tol, max_iters=500)
    _close(got.x[1], early.x, 1e-12)


def test_cg_solve_converges_to_the_reference_and_the_dense_solution():
    """At tol=1e-12 both solvers reach the exact solution; x agrees to 1e-10
    and the iteration counts to within the one or two steps by which rounding
    moves a threshold crossing."""
    K1, K2, mask, b, noise = _cg_problem()
    A, RA = _both_operators(K1, K2, mask, noise)
    got = cg_solve(A, _t(b), tol=1e-12, max_iters=500)
    want = ref_cg_solve(RA, jnp.asarray(b), tol=1e-12, max_iters=500)
    assert abs(int(got.iters) - int(want.iters)) <= 2
    assert not bool(got.breakdown.any())
    _close(got.x, want.x, 1e-10)
    assert float(got.rel_residual.max()) <= 1e-11
    idx = np.flatnonzero(mask.ravel())
    Kd = np.kron(K1, K2)[np.ix_(idx, idx)] + noise * np.eye(idx.size)
    x_dense = np.linalg.solve(Kd, b.reshape(len(b), -1)[:, idx].T).T
    _close(got.x.reshape(len(b), -1)[:, idx], x_dense, 1e-10)


class _Float32Operator:
    """A rounded to float32 on the way in and out, with the exact float64
    operator as ``accurate`` (what the cuda engine's operator looks like)."""

    def __init__(self, A, with_accurate=True):
        self._A, self.fast, self.slow = A, 0, 0
        if with_accurate:
            self.accurate = self._accurate

    def __call__(self, u):
        self.fast += 1
        return self._A(u.float().double()).float().double()

    def _accurate(self, u):
        self.slow += 1
        return self._A(u)


def test_cg_residual_replacement_under_a_float32_operator():
    """An operator that rounds to float32 under the float64 recursion. With
    its ``accurate`` counterpart the solver replaces the recursion's residual
    by the true one every REPLACE_EVERY sweeps and at the end, so the TRUE
    residual (float64 operator) ends within tol, down to tolerances a float32
    sweep alone cannot reach. Only residuals go through ``accurate``."""
    K1, K2, mask, b, _ = _cg_problem(seed=6)
    A, _ = _both_operators(K1, K2, mask, 0.01)   # low noise: ~100 iterations

    def true_residual(x):
        r = _t(b) - A(x)
        return (torch.sqrt((r * r).sum((-2, -1)))
                / torch.sqrt((_t(b) ** 2).sum((-2, -1)).clamp_min(1e-300)))

    exact = cg_solve(A, _t(b), tol=1e-5, max_iters=500)
    assert exact.replacements == 0          # a plain operator: untouched loop
    for tol in (1e-5, 1e-9):
        op = _Float32Operator(A)
        got = cg_solve(op, _t(b), tol=tol, max_iters=2000)
        assert op.fast == int(got.iters)
        assert op.slow == 2 + got.replacements
        assert got.replacements >= int(got.iters) // REPLACE_EVERY >= 1
        assert not bool(got.breakdown.any())
        assert float(true_residual(got.x).max()) <= tol
        _close(got.rel_residual, true_residual(got.x), 1e-12)
    # both solves are tol-accurate in the residual; 1/noise bounds the gap
    got5 = cg_solve(_Float32Operator(A), _t(b), tol=1e-5, max_iters=500)
    assert float((got5.x - exact.x).abs().max()) \
        <= 2 * 1e-5 / 0.01 * float(_t(b).abs().max())
    # without ``accurate`` the same operator stalls at the float32 floor and
    # reports it through its own sweeps: the reference's loop, iters + 2
    bare = _Float32Operator(A, with_accurate=False)
    floor = cg_solve(bare, _t(b), tol=1e-9, max_iters=400)
    assert floor.replacements == 0 and bare.fast == int(floor.iters) + 2
    assert float(true_residual(floor.x).max()) > 1e-9
    # the budget is the budget: nothing goes on once max_iters is spent
    spent = cg_solve(_Float32Operator(A), _t(b), tol=1e-9, max_iters=3)
    assert int(spent.iters) == 3 and spent.replacements == 0
    # the tridiagonal record is one unbroken recurrence: nothing is replaced
    # inside it, and the residuals are replaced after it
    op = _Float32Operator(A)
    res, _ = cg_solve_tridiag(op, _t(b), 8, tol=1e-5, max_iters=500)
    assert res.replacements >= int(res.iters) // REPLACE_EVERY >= 1
    assert float(true_residual(res.x).max()) <= 1e-5


@pytest.mark.parametrize("tol", [1e-9, 1e-12])
def test_kernel_engine_solve_below_the_float32_floor_converges(tol):
    """The cuda engine's operator on the CPU (float32 plain sweeps, float64
    ``accurate``) at tolerances no float32 sweep reaches by itself: the
    replaced residuals steer CG down to tol instead of letting it diverge
    (each step after a replacement is the line minimum along the kept
    direction)."""
    params, data, b = _engine_problem()
    A = get_engine("cuda").operator(params, data, LKGPConfig())
    rhs = torch.stack([b, 0.5 * b + 0.1 * data.mask])
    res = cg_solve(A, rhs, tol=tol, max_iters=3000)
    assert not bool(res.breakdown.any()) and int(res.iters) < 3000
    assert res.replacements >= 1
    r = rhs - A.accurate(res.x)
    rel = torch.sqrt((r * r).sum((-2, -1)) / (rhs * rhs).sum((-2, -1)))
    assert float(rel.max()) <= tol
    torch.testing.assert_close(rel, res.rel_residual, rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_rank", [25, REPLACE_EVERY + 10])
def test_recorded_solve_keeps_accurate_residuals_outside_the_window(max_rank):
    """A solve that records CG-Lanczos coefficients (the MLL's stacked solve,
    slq_iters of them) under a float32-rounding operator with ``accurate``:
    no replacement falls inside the recorded window, so the coefficients are
    bit-identical to those of the same operator without ``accurate``; the
    replacements after the window still bring every column's TRUE residual
    within tol. max_rank = 25 is the default slq_iters (< REPLACE_EVERY);
    REPLACE_EVERY + 10 puts the first periodic replacement inside it."""
    K1, K2, mask, b, _ = _cg_problem(seed=6)
    A, _ = _both_operators(K1, K2, mask, 0.01)   # ~100 iterations
    tol = 1e-7
    res, tri = cg_solve_tridiag(_Float32Operator(A), _t(b), max_rank, tol=tol,
                                max_iters=2000)
    bare_res, bare = cg_solve_tridiag(_Float32Operator(A, with_accurate=False),
                                      _t(b), max_rank, tol=tol, max_iters=2000)
    assert torch.equal(tri.alphas, bare.alphas)
    assert torch.equal(tri.betas, bare.betas)
    assert torch.equal(tri.steps, bare.steps)
    assert int(tri.steps.max()) == max_rank
    assert res.replacements >= 1 and bare_res.replacements == 0
    r = _t(b) - A(res.x)
    rel = (torch.sqrt((r * r).sum((-2, -1)))
           / torch.sqrt((_t(b) ** 2).sum((-2, -1))).clamp_min(1e-300))
    assert float(rel.max()) <= tol
    assert float(bare_res.rel_residual.max()) > tol   # the float32 floor


def test_cg_solve_max_iters_and_unbatched_rhs():
    K1, K2, mask, b, noise = _cg_problem(seed=1)
    A, RA = _both_operators(K1, K2, mask, noise)
    got = cg_solve(A, _t(b[0]), tol=1e-12, max_iters=7)
    want = ref_cg_solve(RA, jnp.asarray(b[0]), tol=1e-12, max_iters=7)
    assert int(got.iters) == 7 and got.rel_residual.shape == ()
    _assert_same_result(got, want, x_tol=1e-10)


def test_cg_solve_warm_start_matches_reference_and_saves_iterations():
    K1, K2, mask, b, noise = _cg_problem(seed=2)
    A, RA = _both_operators(K1, K2, mask, noise)
    cold = cg_solve(A, _t(b), tol=1e-6, max_iters=500)
    x0 = cold.x.numpy() * (1 + 1e-3)
    got = cg_solve(A, _t(b), tol=0.0, max_iters=4, x0=_t(x0))
    want = ref_cg_solve(RA, jnp.asarray(b), tol=0.0, max_iters=4,
                        x0=jnp.asarray(x0))
    _assert_same_result(got, want, x_tol=1e-10)
    warm = cg_solve(A, _t(b), tol=1e-6, max_iters=500, x0=_t(x0))
    assert 0 < int(warm.iters) < int(cold.iters)
    assert float(warm.rel_residual.max()) <= 1e-6 * 1.01
    exact = cg_solve(A, _t(b), tol=1e-6, x0=cg_solve(A, _t(b), tol=1e-13).x)
    assert int(exact.iters) == 0


def test_cg_breakdown_on_indefinite_operator_matches_reference():
    K1, K2, mask, b, noise = _cg_problem(seed=3, B=3)
    sign = np.array([1.0, -1.0, 1.0])[:, None, None]   # column 1: -A
    A, RA = _both_operators(K1, K2, mask, noise)
    got = cg_solve(lambda u: _t(sign) * A(u), _t(b), tol=1e-2, max_iters=300)
    want = ref_cg_solve(lambda u: jnp.asarray(sign) * RA(u), jnp.asarray(b),
                        tol=1e-2, max_iters=300)
    assert got.breakdown.tolist() == [False, True, False]
    _assert_same_result(got, want, x_tol=1e-8)
    # the healthy column still converged; the broken one never stepped
    assert float(got.rel_residual[0]) <= 1e-2 * 1.01
    assert int(got.col_iters[1]) == 0
    _close(got.x[1], 0 * b[1], 0)


@pytest.mark.parametrize("max_rank", [4, 40])
def test_cg_solve_tridiag_coefficients_match_reference(max_rank):
    """CG-Lanczos coefficients. The first steps agree to 1e-9; by the time a
    column converges, rounding has grown to ~1e-7 relative (rtol 1e-5)."""
    K1, K2, mask, b, noise = _cg_problem(seed=4)
    A, RA = _both_operators(K1, K2, mask, noise)
    got, tri = cg_solve_tridiag(A, _t(b), max_rank, tol=1e-2, max_iters=500)
    want, rtri = ref_cg_solve_tridiag(RA, jnp.asarray(b), max_rank, tol=1e-2,
                                      max_iters=500)
    _assert_same_result(got, want, x_tol=1e-8)
    np.testing.assert_array_equal(tri.steps.numpy(), np.asarray(rtri.steps))
    assert tri.steps.tolist() == [min(c, max_rank)
                                  for c in got.col_iters.tolist()]
    assert tri.alphas.shape == (b.shape[0], max_rank)
    _close(tri.alphas[:, :4], rtri.alphas[:, :4], 1e-9)
    _close(tri.betas[:, :4], rtri.betas[:, :4], 1e-9)
    np.testing.assert_allclose(tri.alphas.numpy(), np.asarray(rtri.alphas),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(tri.betas.numpy(), np.asarray(rtri.betas),
                               rtol=1e-5, atol=1e-12)
    # the tridiag variant solves the same system the same way
    plain = cg_solve(A, _t(b), tol=1e-2, max_iters=500)
    assert torch.equal(plain.x, got.x)
    with pytest.raises(ValueError, match="max_rank"):
        cg_solve_tridiag(A, _t(b), 0)


# --------------------------------------------------------------------------
# registries: solvers and engines
# --------------------------------------------------------------------------
def test_solver_registry_and_unported_solvers_raise():
    """Every solver of the reference's registry is ported: nothing raises
    NotImplementedError any more. ``"auto"`` keeps the reference's rule (PCG
    iff precond_rank > 0 and the operator can be preconditioned), explicit
    names win, unknown names raise ValueError."""
    assert {"cg", "pcg", "sgd"} <= set(list_solvers())
    assert {"cg", "pcg", "sgd"} <= set(ref_core.list_solvers())
    for name, cls in (("cg", CGSolver), ("pcg", PCGSolver),
                      ("sgd", SGDSolver)):
        assert isinstance(get_solver(name), cls)
        assert get_solver(name) is get_solver(name)
    assert resolve_solver(LKGPConfig()) is get_solver("cg")
    with pytest.raises(ValueError, match="unknown solver"):
        get_solver("nope")
    K1, K2, mask, b, noise = _cg_problem()
    op = get_engine("iterative").operator_from_grams(_t(K1), _t(K2), _t(mask),
                                                     noise)
    rop = ref_core.get_engine("iterative").operator_from_grams(
        jnp.asarray(K1), jnp.asarray(K2), jnp.asarray(mask), noise)
    bare = lambda u: u   # noqa: E731 - no factors to precondition
    for kw, (A, RA), want in (
            (dict(solver="pcg"), (None, None), "pcg"),
            (dict(solver="sgd"), (None, None), "sgd"),
            (dict(precond_rank=8), (None, None), "pcg"),
            (dict(precond_rank=8), (op, rop), "pcg"),
            (dict(solver="sgd", precond_rank=5), (op, rop), "sgd"),
            (dict(precond_rank=8), (bare, bare), "cg")):
        assert resolve_solver(LKGPConfig(**kw), A) is get_solver(want)
        assert ref_core.resolve_solver(ref_core.LKGPConfig(**kw),
                                       RA).name == want
    A, _ = _both_operators(K1, K2, mask, noise)
    # probe columns give a log-det, unless a warm start bends their Krylov
    # spaces (then none, as in the reference)
    st = get_solver("cg").solve_stacked(A, _t(b), LKGPConfig(), probe_cols=2,
                                        subspace_dim=float(mask.sum()))
    assert st.logdet is not None and bool(torch.isfinite(st.logdet))
    st = get_solver("cg").solve_stacked(A, _t(b), LKGPConfig(), probe_cols=2,
                                        subspace_dim=float(mask.sum()),
                                        x0=torch.zeros_like(_t(b)))
    assert st.logdet is None
    st = get_solver("cg").solve_stacked(A, _t(b), LKGPConfig(cg_tol=1e-6))
    assert st.logdet is None and st.breakdown is st.result.breakdown
    assert st.col_iters is st.result.col_iters and st.trace is None


def test_engine_registry_singletons_and_alias():
    assert list_backends() == ["cuda", "dense", "distributed", "iterative"]
    assert get_engine("cuda") is get_engine("pallas")
    assert isinstance(get_engine("pallas"), KernelEngine)
    assert get_engine("dense") is get_engine("dense")
    assert get_engine("dense").exact and not get_engine("cuda").exact
    assert get_engine("cuda").name == "cuda"


def _engine_problem():
    task = sample_task(5, n=7, m=6, d=4)
    X = _t(task.X)
    t = tf.TTransform.fit(_t(task.t))(_t(task.t))
    mask = _t(task.mask)
    params = init_params(4, device="cpu")
    return params, GPData(X, t, None, mask), _t(task.Y * task.mask)


@pytest.mark.parametrize("backend,tol", [("dense", 1e-10), ("iterative", 1e-8),
                                         ("cuda", 2e-4)])
def test_engine_solves_agree_with_reference_engine(backend, tol):
    """Each engine against the reference's engine of the same slot: exact
    ones to rounding, CG at cg_tol=1e-10 to 1e-8, and the float32 kernel slot
    (cg_tol=1e-5, near the floor of a float32 MVM) to 2e-4."""
    params, data, b = _engine_problem()
    cg_tol = 1e-5 if backend == "cuda" else 1e-10
    cfg = LKGPConfig(cg_tol=cg_tol, cg_max_iters=500)
    eng = get_engine(backend)
    A = eng.operator(params, data, cfg)
    before = solve_tally()
    x = eng.solve(A, torch.stack([b, 0.5 * b]), cfg)
    assert solve_tally() == before + 1
    ref_backend = "pallas" if backend == "cuda" else backend
    rcfg = ref_core.LKGPConfig(cg_tol=cg_tol, cg_max_iters=500)
    reng = ref_core.get_engine(ref_backend)
    rparams = ref_core.LKGPParams(*(jnp.asarray(p.numpy()) for p in params))
    rdata = ref_core.GPData(jnp.asarray(data.X.numpy()),
                            jnp.asarray(data.t.numpy()), None,
                            jnp.asarray(data.mask.numpy()))
    RA = reng.operator(rparams, rdata, rcfg)
    rb = jnp.asarray(b.numpy())
    rx = reng.solve(RA, jnp.stack([rb, 0.5 * rb]), rcfg)
    scale = float(np.abs(np.asarray(rx)).max())
    assert np.abs(x.numpy() - np.asarray(rx)).max() <= tol * scale
    if backend != "dense":
        assert A.last_result.x is x
        res = eng.solve_result(A, b, cfg)
        assert float(res.rel_residual) <= cg_tol
        st = eng.solve_stacked(A, torch.stack([b, b]), cfg)
        assert st.logdet is None and st.x.shape == (2, *b.shape)


def test_kernel_engine_casts_factors_once_and_keeps_noise_on_device():
    params, data, b = _engine_problem()
    A = get_engine("cuda").operator(params, data, LKGPConfig())
    assert isinstance(A, LatentKroneckerOperator)
    # the kernel reads float32 copies made here; the operator keeps the
    # state's dtype for the backward and the accurate residuals
    for x in A.fast:
        assert x.dtype == torch.float32 and x.is_contiguous()
    assert A.fast[3].ndim == 0 and A.noise.ndim == 0
    assert A.K1.dtype == torch.float64
    assert A.accurate.K1.data_ptr() == A.K1.data_ptr()   # no copy
    out = A(b)                                   # float64 in, float64 out
    assert out.dtype == torch.float64
    exact = get_engine("iterative").operator(params, data, LKGPConfig())(b)
    assert 0 < (out - exact).abs().max() <= 1e-5 * exact.abs().max()
    # a non-contiguous training block (sliced out of a joint Gram) is fine
    K1, K2 = gram_matrices(params, data.X, data.t)
    big = torch.zeros(9, 9, dtype=torch.float64)
    big[:7, :7] = K1
    A2 = get_engine("cuda").operator_from_grams(big[:7, :7], K2, data.mask,
                                                torch.exp(params.raw_noise))
    assert torch.equal(A2(b), out)


def test_kernel_engine_refuses_autograd_until_backward_is_ported():
    """The backward is ported (K5): the kernel engine's operator takes
    factors that require grad and passes gradients to them, while the bare
    kernel wrappers, which have no backward, still refuse such inputs."""
    params, data, b = _engine_problem()
    K1, K2 = gram_matrices(params, data.X, data.t)
    A = get_engine("cuda").operator_from_grams(
        K1.requires_grad_(), K2, data.mask, torch.exp(params.raw_noise))
    (g,) = torch.autograd.grad((A(b) * b).sum(), K1)
    assert g.shape == K1.shape and bool(torch.isfinite(g).all())
    from repro_torch.kernels import lk_mvm_fused
    with pytest.raises(NotImplementedError, match="K5"):
        lk_mvm_fused(K1.float(), *A.fast[1:3], b)


def test_degraded_solve_raises_instead_of_returning():
    """A degraded eager solve is never returned as if it were healthy: under
    ``solve_policy="strict"`` it raises GuardedSolveError with a one-step
    trace (the dense engine handed a foreign operator iterates under the
    same rule); under the default ``"escalate"`` the ladder ends on the dense
    fallback with the dense engine's answer. The objective's solve is not
    guarded: it raises DegradedSolveError, a GuardedSolveError."""
    params, data, b = _engine_problem()
    eng = CustomMVMEngine(lambda K1, K2, mask, u, noise=0.0:
                          -lk_mvm(K1, K2, mask, u, noise))
    A = eng.operator(params, data, LKGPConfig())
    strict = LKGPConfig(solve_policy="strict")
    with pytest.raises(GuardedSolveError, match="strict") as exc:
        eng.solve(A, b, strict)
    assert [(s.stage, s.ok) for s in exc.value.trace] == [("attempt", False)]
    assert not hasattr(A, "last_result")
    with pytest.raises(GuardedSolveError):
        get_engine("dense").solve(A, b, strict)
    nan_op = LatentKroneckerOperator(
        A.K1, A.K2, A.mask, A.noise,
        mvm=lambda K1, K2, mask, u, noise=0.0: u * float("nan"))
    with pytest.raises(GuardedSolveError):
        get_engine("iterative").solve(nan_op, b, strict)
    dense = get_engine("dense")
    want = dense.solve(dense.operator(params, data, strict), b, strict)
    for op in (A, nan_op):
        x = get_engine("iterative").solve(op, b, LKGPConfig())
        assert op.last_result.trace[-1][:2] == ("dense_fallback", "dense")
        _close(x, want, 1e-10)
    gen = torch.Generator().manual_seed(0)
    probes = rademacher_probes(gen, 4, data.mask, torch.float64)
    assert issubclass(DegradedSolveError, GuardedSolveError)
    for cfg in (strict, LKGPConfig()):
        with pytest.raises(DegradedSolveError, match="breakdown") as exc:
            make_mll(cfg, eng)(params, data.X, data.t, b, data.mask, probes)
        assert bool(exc.value.result.breakdown.all())
        assert exc.value.result.trace is None
