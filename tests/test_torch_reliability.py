"""PyTorch port, the guarded escalation ladder and the fault injectors: every
ladder scenario of the reference's reliability suite, with the port's
escalation trace held equal to the reference's in (stage, solver, jitter, ok)
on the same input (handed across as numpy), and what the port adds: the
ladder on the ``cuda`` engine's float32 operator (its ``accurate`` jittered
and negated with it), the distributed operator that cannot be preconditioned
or assembled, and a fit that is the same bits under every policy."""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.testing as ref_testing  # noqa: E402
from repro.core.solvers import get_solver as ref_get_solver  # noqa: E402
from repro.core.solvers.guarded import \
    _jitter_ladder as ref_jitter_ladder  # noqa: E402
from repro_torch.core import (SOLVE_POLICIES, DistributedEngine,  # noqa: E402
                              GuardedSolveError, GuardedSolver, LKGPConfig,
                              escalation_tally, fit, get_engine, get_solver,
                              guarded_solve, guarded_solve_stacked,
                              reset_escalation_tally, solve_tally)
from repro_torch.core.solvers.guarded import (_JitteredOperator,  # noqa: E402
                                              _jitter_ladder, health)
from repro_torch.data import sample_task  # noqa: E402
from repro_torch.testing import (FaultSchedule, NegatedOperator,  # noqa: E402
                                 arm_flaky_solver, near_singular_problem,
                                 poison_nan)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _lk_problem(n=12, m=10, d=3, seed=0, noise=0.05):
    """The reference reliability suite's system (its PRNG's draws)."""
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
    A = get_engine(backend).operator_from_grams(_t(K1), _t(K2), _t(mask),
                                                noise)
    RA = ref_core.get_engine("iterative").operator_from_grams(
        *map(jnp.asarray, (K1, K2, mask)), noise)
    return A, RA


def _cfgs(**kw):
    return LKGPConfig(**kw), ref_core.LKGPConfig(**kw)


def _steps(trace):
    """A trace as the (stage, solver, jitter, ok) the packages must share."""
    return [(s.stage, s.solver, s.jitter, s.ok) for s in trace]


def _both(problem, wrap, kw, port_wrap=None, **solve_kw):
    """The guarded solve of one scenario in both packages: (port result or
    error, reference result or error)."""
    K1, K2, mask, Y, noise = problem
    A, RA = _operators(K1, K2, mask, noise)
    cfg, rcfg = _cfgs(**kw)
    out = []
    for solve, op, b, c in ((guarded_solve, (port_wrap or wrap)(A), _t(Y),
                             cfg),
                            (ref_core.guarded_solve, wrap(RA),
                             jnp.asarray(Y), rcfg)):
        try:
            out.append(solve(op, b, c, **solve_kw))
        except GuardedSolveError as e:
            out.append(e)
        except ref_core.GuardedSolveError as e:
            out.append(e)
    return out


# --------------------------------------------------------------------------
# the ladder, scenario by scenario (the reference's test_reliability.py)
# --------------------------------------------------------------------------
def test_healthy_solve_is_bitwise_unchanged_by_the_guard():
    """A pure observer on healthy solves: the raw solver's bits, and a
    one-step trace, the reference's."""
    problem = _lk_problem()
    K1, K2, mask, Y, noise = problem
    A, _ = _operators(K1, K2, mask, noise)
    raw = get_solver("cg").solve(A, _t(Y), LKGPConfig())
    res, ref = _both(problem, lambda op: op, {}, solver=None)
    assert torch.equal(raw.x, res.x)
    assert _steps(res.trace) == _steps(ref.trace) == [
        ("attempt", "cg", 0.0, True)]
    assert res.trace[0].worst_residual == float(res.rel_residual.max())


def test_escalation_reaches_dense_fallback_on_broken_operator():
    """A negated (indefinite) operator defeats every iterative rung; the
    dense fallback solves the INTENDED system from the factors, as the
    reference's does, to its answer."""
    res, ref = _both(_lk_problem(), NegatedOperator, {},
                     port_wrap=NegatedOperator)
    steps = _steps(res.trace)
    assert steps == _steps(ref.trace)
    assert steps[0][:2] == ("attempt", "cg") and not steps[0][3]
    assert [s[0] for s in steps].count("retry_jitter") == 3
    assert steps[-1] == ("dense_fallback", "dense", 0.0, True)
    assert not bool(res.breakdown.any())
    assert float(res.rel_residual.max()) < 1e-8
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-10)


def test_strict_policy_raises_without_escalating():
    res, ref = _both(_lk_problem(), NegatedOperator,
                     dict(solve_policy="strict"), port_wrap=NegatedOperator)
    assert isinstance(res, GuardedSolveError)
    assert isinstance(ref, ref_core.GuardedSolveError)
    assert _steps(res.trace) == _steps(ref.trace) == [
        ("attempt", "cg", 0.0, False)]


def test_escalate_raises_when_ladder_exhausted():
    """A broken bare closure (no factors, no dense fallback) exhausts the
    ladder; escalate raises with the whole trace attached."""
    res, ref = _both(_lk_problem(), lambda op: (lambda u: -op(u)),
                     dict(guard_retries=1))
    assert isinstance(res, GuardedSolveError)
    steps = _steps(res.trace)
    assert steps == _steps(ref.trace)
    assert [s[:2] for s in steps] == [("attempt", "cg"),
                                      ("retry_jitter", "cg"),
                                      ("switch_solver", "pcg")]
    assert "exhausted" in str(res)


def test_best_effort_never_raises_and_keeps_diagnostics():
    res, ref = _both(_lk_problem(), lambda op: (lambda u: -op(u)),
                     dict(solve_policy="best_effort", guard_retries=1))
    assert _steps(res.trace) == _steps(ref.trace)
    assert res.trace and not res.trace[-1].ok
    assert bool(res.breakdown.any())          # flags intact


def test_near_singular_system_ends_healthy():
    """The reference's near-singular draws handed across: the ladder ends on
    the reference's rung with a healthy, finite solution. The port's own
    ``near_singular_problem`` (a torch.Generator's draws) ends healthy too."""
    problem = tuple(np.asarray(a) for a in ref_testing.near_singular_problem())
    res, ref = _both(problem[:4] + (float(problem[4]),), lambda op: op, {})
    assert _steps(res.trace) == _steps(ref.trace)
    assert res.trace[-1].ok
    assert bool(torch.isfinite(res.x).all())
    assert not bool(res.breakdown.any())
    K1, K2, mask, Y, noise = near_singular_problem(device="cpu")
    assert K1.shape == (8, 8) and Y.shape == mask.shape == (8, 6)
    assert float(torch.linalg.cond(K1)) > 1e8   # duplicated configs
    A = get_engine("iterative").operator_from_grams(K1, K2, mask, noise)
    own = guarded_solve(A, Y, LKGPConfig())
    assert own.trace[-1].ok and bool(torch.isfinite(own.x).all())
    again = near_singular_problem(device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again[:4], (K1, K2, mask, Y)))


def test_flaky_solver_escalates_at_one_extra_attempt():
    """The armed flaky solver fails once, instantly; the first jitter retry
    (CG underneath) recovers, in both packages."""
    problem = _lk_problem()
    arm_flaky_solver(1)
    ref_testing.arm_flaky_solver(1)
    res, ref = _both(problem, lambda op: op, dict(solver="flaky"))
    assert _steps(res.trace) == _steps(ref.trace)
    assert [s.stage for s in res.trace] == ["attempt", "retry_jitter"]
    assert res.trace[-1].ok and res.trace[0].worst_residual == 1.0


@pytest.mark.parametrize("kw", [
    dict(jitter=1e-6, guard_retries=6, guard_jitter_max=1e-2),
    dict(guard_retries=0), dict(guard_retries=2), dict(jitter=0.0),
    dict(jitter=1e-3, guard_jitter_max=1e-3)])
def test_jitter_ladder_is_deterministic_and_capped(kw):
    cfg, rcfg = _cfgs(**kw)
    assert _jitter_ladder(cfg) == ref_jitter_ladder(rcfg)
    assert _jitter_ladder(LKGPConfig(jitter=1e-6, guard_retries=6,
                                     guard_jitter_max=1e-2)) == \
        pytest.approx([1e-5, 1e-4, 1e-3, 1e-2], rel=1e-9)


def test_engine_exposes_escalation_trace_and_counts_attempts():
    K1, K2, mask, Y, noise = _lk_problem()
    A, _ = _operators(K1, K2, mask, noise)
    A = NegatedOperator(A)
    eng = get_engine("iterative")
    before = solve_tally()
    dense_before = escalation_tally()["dense_fallback"]
    res = eng.solve_result(A, _t(Y), LKGPConfig())
    assert A.last_result is res
    assert res.trace is not None and len(res.trace) > 1
    # one tally entry for the solve + one per extra ladder attempt
    assert solve_tally() - before == len(res.trace)
    assert escalation_tally()["dense_fallback"] == dense_before + 1


# --------------------------------------------------------------------------
# stacked solves
# --------------------------------------------------------------------------
def test_stacked_solve_reports_degraded_columns():
    """An operator broken for system 0 of the stack only: the stacked
    result's breakdown / col_iters name the degraded system, the healthy
    ones converge, and the trace is the reference's."""
    K1, K2, mask, Y, noise = _lk_problem()
    A, RA = _operators(K1, K2, mask, noise)

    def partly_broken(u):
        out = A(u)
        return torch.cat([-out[:1], out[1:]])

    def ref_partly_broken(u):
        out = RA(u)
        return out.at[0].set(-out[0])

    cfg, rcfg = _cfgs(solve_policy="best_effort", guard_retries=0)
    st = guarded_solve_stacked(partly_broken, torch.stack([_t(Y)] * 3), cfg)
    rst = ref_core.guarded_solve_stacked(ref_partly_broken,
                                         jnp.stack([jnp.asarray(Y)] * 3),
                                         rcfg)
    assert st.breakdown.tolist() == [True, False, False]
    assert (st.col_iters[1:] > 0).all()
    np.testing.assert_array_equal(st.breakdown.numpy(),
                                  np.asarray(rst.breakdown))
    assert _steps(st.trace) == _steps(rst.trace)


def test_stacked_solve_healthy_keeps_logdet_and_diagnostics():
    K1, K2, mask, Y, noise = _lk_problem()
    A, RA = _operators(K1, K2, mask, noise)
    cfg, rcfg = _cfgs()
    st = guarded_solve_stacked(A, torch.stack([_t(Y)] * 2), cfg,
                               probe_cols=1, subspace_dim=float(mask.sum()),
                               solver=get_solver("cg"))
    rst = ref_core.guarded_solve_stacked(
        RA, jnp.stack([jnp.asarray(Y)] * 2), rcfg, probe_cols=1,
        subspace_dim=float(mask.sum()), solver=ref_get_solver("cg"))
    assert st.logdet is not None and not bool(st.breakdown.any())
    assert float(st.logdet) == pytest.approx(float(rst.logdet), rel=1e-9)
    assert _steps(st.trace) == _steps(rst.trace) == [
        ("attempt", "cg", 0.0, True)]


def test_stacked_dense_fallback_reports_the_exact_logdet():
    """A stacked solve rescued by the dense fallback reports the exact
    observed-subspace log-determinant (the dense engine's), as the
    reference's; a GuardedSolver drives an explicit solver the same way."""
    K1, K2, mask, Y, noise = _lk_problem()
    A, RA = _operators(K1, K2, mask, noise)
    cfg, rcfg = _cfgs()
    rhs = torch.stack([_t(Y)] * 2)
    for run in (lambda: guarded_solve_stacked(
                    NegatedOperator(A), rhs, cfg, probe_cols=1,
                    subspace_dim=float(mask.sum())),
                lambda: GuardedSolver(get_solver("cg")).solve_stacked(
                    NegatedOperator(A), rhs, cfg, probe_cols=1,
                    subspace_dim=float(mask.sum()))):
        st = run()
        assert st.trace[-1].stage == "dense_fallback"
        dense = get_engine("dense")
        D = dense.operator_from_grams(_t(K1), _t(K2), _t(mask), noise)
        assert float(st.logdet) == pytest.approx(
            float(dense.logdet(D, None, cfg)), rel=1e-12)
    rst = ref_core.guarded_solve_stacked(
        ref_testing.NegatedOperator(RA), jnp.stack([jnp.asarray(Y)] * 2),
        rcfg, probe_cols=1, subspace_dim=float(mask.sum()))
    assert _steps(st.trace) == _steps(rst.trace)
    assert float(st.logdet) == pytest.approx(float(rst.logdet), rel=1e-10)


# --------------------------------------------------------------------------
# determinism, and what the port adds
# --------------------------------------------------------------------------
@pytest.mark.parametrize("policy,retries,seed", [
    ("escalate", 0, 0), ("escalate", 3, 2), ("best_effort", 1, 4),
    ("best_effort", 2, 1)])
def test_escalation_is_deterministic(policy, retries, seed):
    """Same faulty operator and policy: the same trace (the reference's) and
    bitwise the same solution across independent runs."""
    problem = _lk_problem(seed=seed)
    kw = dict(solve_policy=policy, guard_retries=retries)
    r1, ref = _both(problem, NegatedOperator, kw, port_wrap=NegatedOperator)
    r2, _ = _both(problem, NegatedOperator, kw, port_wrap=NegatedOperator)
    assert _steps(r1.trace) == _steps(r2.trace) == _steps(ref.trace)
    assert torch.equal(r1.x, r2.x)
    assert torch.equal(r1.rel_residual, r2.rel_residual)


def test_sgd_base_walks_the_whole_solver_ladder():
    """From ``solver="sgd"`` a negated operator walks sgd -> cg -> pcg (PCG
    through the operator's preconditioner) before the dense fallback, rung
    for rung as the reference."""
    res, ref = _both(_lk_problem(), NegatedOperator,
                     dict(solver="sgd", guard_retries=1),
                     port_wrap=NegatedOperator)
    assert _steps(res.trace) == _steps(ref.trace)
    assert [(s.stage, s.solver) for s in res.trace][-3:] == [
        ("switch_solver", "cg"), ("switch_solver", "pcg"),
        ("dense_fallback", "dense")]


def test_ladder_on_the_float32_kernel_operator():
    """The ``cuda`` engine's operator (float32 sweeps, float64 ``accurate``)
    under the ladder: a jittered or negated operator carries a jittered or
    negated ``accurate`` (CG's true residuals belong to the matrix it
    iterates), the negated one ends on the dense fallback with the
    ``iterative`` engine's trace, and a healthy solve is one step."""
    K1, K2, mask, Y, noise = _lk_problem()
    A, _ = _operators(K1, K2, mask, noise, "cuda")
    u = _t(Y)
    J = _JitteredOperator(A, 1e-3)
    assert torch.equal(J.accurate(u), A.accurate(u) + 1e-3 * u)
    N = NegatedOperator(A)
    assert torch.equal(N.accurate(u), -A.accurate(u))
    assert N.mask is A.mask and N.preconditioner(4) is A.preconditioner(4)
    res = guarded_solve(N, u, LKGPConfig())
    plain, _ = _both(_lk_problem(), NegatedOperator, {},
                     port_wrap=NegatedOperator)
    assert _steps(res.trace) == _steps(plain.trace)
    np.testing.assert_allclose(res.x.numpy(), plain.x.numpy(), atol=1e-10)
    ok = guarded_solve(A, u, LKGPConfig(cg_tol=1e-8))
    assert _steps(ok.trace) == [("attempt", "cg", 0.0, True)]
    assert ok.replacements >= 1 and float(ok.rel_residual.max()) <= 1e-8


def test_distributed_operator_cannot_be_preconditioned_or_assembled():
    """As the reference's distributed operator, a bare closure: ``"auto"``
    with precond_rank > 0 and ``solver="pcg"`` run plain CG (the same bits),
    and a broken one exhausts the ladder without a dense fallback, rung for
    rung as the reference's."""
    K1, K2, mask, Y, noise = _lk_problem()
    A = DistributedEngine().operator_from_grams(_t(K1), _t(K2), _t(mask),
                                                noise)
    RA = ref_core.get_engine("distributed").operator_from_grams(
        *map(jnp.asarray, (K1, K2, mask)), noise)
    for name in ("preconditioner", "K1", "K2", "mask", "noise"):
        assert not hasattr(A, name) and not hasattr(RA, name)
    cg = get_solver("cg").solve(A, _t(Y), LKGPConfig())
    for cfg in (LKGPConfig(precond_rank=8), LKGPConfig(solver="pcg")):
        res = get_engine("distributed").solve_result(A, _t(Y), cfg)
        assert torch.equal(res.x, cg.x)
    cfg, rcfg = _cfgs(guard_retries=1)
    with pytest.raises(GuardedSolveError) as exc:
        guarded_solve(lambda u: -A(u), _t(Y), cfg)
    with pytest.raises(ref_core.GuardedSolveError) as rexc:
        ref_core.guarded_solve(lambda u: -RA(u), jnp.asarray(Y), rcfg)
    assert _steps(exc.value.trace) == _steps(rexc.value.trace)
    assert "dense_fallback" not in [s.stage for s in exc.value.trace]


@pytest.mark.parametrize("backend,polish", [("iterative", None),
                                            ("cuda", None),
                                            ("iterative", 2)])
def test_fit_is_the_same_bits_under_every_policy(backend, polish):
    """The objective is not guarded (the reference's jitted objective never
    is): ``fit`` under ``escalate``, ``best_effort`` and ``strict`` gives the
    same bits and evaluation count, and its solves leave no trace."""
    task = sample_task(2, n=10, m=8, d=4)
    fits = []
    for policy in SOLVE_POLICIES:
        cfg = LKGPConfig(backend=backend, lbfgs_iters=3, slq_probes=4,
                         slq_iters=8, cg_tol=1e-6, solve_policy=policy)
        before = dict(escalation_tally())
        state = fit(task.X, task.t, task.Y, task.mask, cfg,
                    polish_steps=polish, device="cpu")
        assert escalation_tally() == before
        fits.append(state.fit_result)
    for res in fits[1:]:
        assert np.array_equal(res.x, fits[0].x) and res.fun == fits[0].fun
        assert res.n_evals == fits[0].n_evals


# --------------------------------------------------------------------------
# health and the other injectors
# --------------------------------------------------------------------------
def test_health_is_one_read_of_breakdown_finiteness_and_worst_residual():
    from repro_torch.core import CGResult
    z = torch.zeros((), dtype=torch.int32)
    mk = lambda rel, brk: CGResult(   # noqa: E731
        x=torch.zeros(2), iters=z,
        rel_residual=torch.tensor(rel, dtype=torch.float64),
        breakdown=torch.tensor(brk, dtype=torch.bool))
    assert health(mk([1e-3, 2e-3], [False, False])) == (False, 2e-3)
    assert health(mk([1e-3, 2e-3], [False, True])) == (True, 2e-3)
    assert health(mk([1e-3, float("nan")], [False, False])) == (
        True, float("inf"))
    assert health(mk([], [])) == (False, 0.0)


def test_unknown_policy_raises():
    K1, K2, mask, Y, noise = _lk_problem()
    A, _ = _operators(K1, K2, mask, noise)
    with pytest.raises(ValueError, match="solve_policy"):
        guarded_solve(A, _t(Y), dataclasses.replace(LKGPConfig(),
                                                    solve_policy="nope"))


def test_poison_nan_and_fault_schedule_match_reference():
    task = sample_task(0, n=5, m=6, d=4)
    for cells in (1, 3):
        got = poison_nan(task.Y, task.mask, cells=cells)
        want = ref_testing.poison_nan(task.Y, task.mask, cells=cells)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="full"):
        poison_nan(task.Y, np.ones_like(task.mask))
    fired = []
    sched = FaultSchedule().add(2, lambda **ctx: fired.append(ctx) or "a")
    sched.add(0, lambda **ctx: "b").add(2, lambda **ctx: "c")
    assert sched.rounds() == [0, 2]
    assert sched.fire(2, service="s") == ["a", "c"]
    assert sched.fire(1) == [] and fired == [{"service": "s"}]


def test_escalation_tally_counts_by_stage_and_resets():
    K1, K2, mask, Y, noise = _lk_problem()
    A, _ = _operators(K1, K2, mask, noise)
    reset_escalation_tally()
    guarded_solve(NegatedOperator(A), _t(Y), LKGPConfig(guard_retries=2))
    with pytest.raises(GuardedSolveError):
        guarded_solve(NegatedOperator(A), _t(Y),
                      LKGPConfig(solve_policy="strict"))
    assert escalation_tally() == {
        "retry_jitter": 2, "switch_solver": 1, "dense_fallback": 1,
        "degraded_returns": 0, "strict_failures": 1}
    reset_escalation_tally()
    assert not any(escalation_tally().values())
