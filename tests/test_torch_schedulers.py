"""PyTorch port, the AutoML layer (``repro_torch.autotune``): the predictor,
the run pool, Successive Halving (LKGP-ranked and rank-based), Hyperband and
freeze-thaw, each held against ``repro.autotune`` on the same numpy inputs.

The schedulers' decisions rest on Matheron variances, and the two packages
draw different normals from one seed. So the port's ``Posterior.final`` is
patched (``handed_draws``) to take the reference's own draws for the stream
it is asked for: the default stream ``fold_in(PRNGKey(seed), 1)`` when no
generator is given, and ``PRNGKey(s)`` for a generator seeded by the
posterior's stream rule with tag 0 (the freeze-thaw scheduler's explicit
keys). With the draws handed across, the decisions - every rung's active and
promoted set, stop events, ``selected``, ``epochs_spent`` and the regret
trajectories - must be *equal*; scores agree to 1e-6 of their scale on the
dense float64 route. The suites are the reference's own test shapes and
``benchmarks/bench_automl.py``'s ``smoke-crossing`` and ``small-crossing``
suites at two seeds.
"""
import jax

jax.config.update("jax_enable_x64", True)

import os  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.autotune as ref_autotune  # noqa: E402
import repro.core as ref_core  # noqa: E402
import repro.data as ref_data  # noqa: E402
from repro.autotune.predictor import _norm_ppf as ref_norm_ppf  # noqa: E402
import repro_torch.autotune as port_autotune  # noqa: E402
from repro_torch import data  # noqa: E402
from repro_torch import probes_from_numpy  # noqa: E402
from repro_torch.autotune import (AutotuneConfig, CurvePredictor,  # noqa: E402
                                  FreezeThawScheduler, HyperbandScheduler,
                                  RunPool, SHConfig,
                                  SuccessiveHalvingScheduler)
from repro_torch.autotune.predictor import _norm_ppf  # noqa: E402
from repro_torch.core import LKGPConfig, Posterior  # noqa: E402
from repro_torch.core import state as state_mod  # noqa: E402
from repro_torch.kernels import lk_mvm  # noqa: E402

CPU = "cpu"
# Scores on the dense float64 route: both packages' Cholesky solves of the
# same L-BFGS end point, within this fraction of max|score|.
SCORE_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes are tiny and the suite's workers would
    otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_normals(key, n_samples, n, m):
    """The standard-normal draws the reference's prior_residual_draws makes
    from ``key`` (no new configs: the joint grid is the training grid)."""
    kz, ke = jax.random.split(key)
    Z = jax.random.normal(kz, (n_samples, n, m), jnp.float64)
    E = jax.random.normal(ke, (n_samples, n, m), jnp.float64)
    return np.array(Z), np.array(E)


@pytest.fixture
def handed_draws(monkeypatch):
    """The port's ``final`` on the reference's draws for the same stream."""
    final = Posterior.final

    def handed(self, generator=None, n_samples=None, *, normals=None):
        st = self._state
        if normals is None and n_samples is None:
            if generator is None:
                key = jax.random.fold_in(jax.random.PRNGKey(st.config.seed), 1)
            else:
                seed = generator.initial_seed()
                assert seed & 0xFF == 0, "not an explicit key's stream"
                key = jax.random.PRNGKey(seed >> 8)
            normals = _reference_normals(key, st.config.posterior_samples,
                                         st.n, st.m)
        return final(self, None, n_samples, normals=normals)

    monkeypatch.setattr(Posterior, "final", handed)


def _gp(pkg, **kw):
    base = dict(lbfgs_iters=15, posterior_samples=32, slq_probes=8,
                slq_iters=10)
    base.update(kw)
    return pkg.LKGPConfig(**base)


# --------------------------------------------------------------------------
# _norm_ppf, RunPool, CurvePredictor
# --------------------------------------------------------------------------
@pytest.mark.parametrize("q", [0.001, 0.025, 0.2, 0.25, 1 / 3, 0.5, 0.75,
                               0.84, 0.975, 0.999])
def test_norm_ppf_matches_reference(q):
    """To 1e-12 over the quantiles a scheduler asks for. Further out the
    reference's ``erfinv(2q - 1)`` loses digits to the rounding of 2q - 1
    (4.6e-9 at q = 1e-9), where ``NormalDist.inv_cdf`` does not."""
    assert abs(_norm_ppf(q) - ref_norm_ppf(q)) <= 1e-12 * max(
        1.0, abs(ref_norm_ppf(q)))


def test_norm_ppf_rejects_the_closed_ends():
    for q in (0.0, 1.0, -0.1):
        with pytest.raises(ValueError, match="quantile"):
            _norm_ppf(q)


def test_run_pool_bitwise_and_budget():
    """The same advance schedule through both pools: every array bitwise,
    the budget, free history and the never-run NaN as the reference."""
    task = data.sample_task(seed=3, n=4, m=6, d=4)
    pools = (RunPool(data.noisy_step_fns(task, 0, 0.02, 0.1), 6, budget=5),
             ref_autotune.RunPool(ref_data.noisy_step_fns(task, 0, 0.02, 0.1),
                                  6, budget=5))
    for pool in pools:
        pool.advance_to(0, 6, charge=False)     # history: free
        pool.advance_to(1, 4)
        pool.advance_to(2, 4)                   # budget runs out after 1 epoch
    ours, ref = pools
    for name in ("Y", "mask", "epochs_done"):
        assert np.array_equal(getattr(ours, name), getattr(ref, name))
    assert ours.spent == ref.spent == 5 and ours.exhausted()
    assert ours.epochs_done[1] == 4 and ours.epochs_done[2] == 1
    assert ours.observed_last(1) == ref.observed_last(1)
    assert np.isnan(ours.observed_last(3))
    assert ours.observed_best() == ref.observed_best()
    assert ours.observed_best(False) == ref.observed_best(False)


def test_run_pool_replay_bitwise():
    task = data.sample_task(seed=4, n=5, m=7, d=4)
    ours = RunPool.replay(task, budget=20, seed=2, obs_noise=0.01)
    ref = ref_autotune.RunPool.replay(task, budget=20, seed=2, obs_noise=0.01)
    for pool in (ours, ref):
        for i in range(5):
            pool.advance_to(i, 7)
    assert ours.max_epochs == 7 and ours.spent == ref.spent == 20
    assert np.array_equal(ours.Y, ref.Y)
    assert np.array_equal(ours.mask, ref.mask)


def test_curve_predictor_cold_fit_then_warm_extend(handed_draws):
    """The reference's test, side by side: a cold fit on 3 epochs, then a
    warm extend to 5 and a refit. Parameters within 1e-6 relative after each
    update on the dense float64 route, ``predict_final`` within 1e-6 of
    max|mean| with the reference's draws; the mask must grow."""
    task = data.sample_task(seed=1, n=6, m=8, d=4)
    ours = CurvePredictor(task.X, 8, gp=_gp(state_mod), seed=0, device=CPU)
    ref = ref_autotune.CurvePredictor(task.X, 8, gp=_gp(ref_core), seed=0)
    mask1 = np.zeros_like(task.mask)
    mask1[:, :3] = 1.0
    mask2 = mask1.copy()
    mask2[:, :5] = 1.0
    for k, mask in enumerate((mask1, mask2), start=1):
        for p in (ours, ref):
            p.update(task.Y_full * mask, mask)
        assert ours.n_refits == ref.n_refits == k
        for name, want in ref.state.params._asdict().items():
            got = getattr(ours.state.params, name).numpy()
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       atol=1e-8, err_msg=name)
        mean, std = ours.predict_final()
        r_mean, r_std = ref.predict_final()
        scale = float(np.abs(r_mean).max())
        assert mean.shape == (6,) and np.all(std >= 0)
        np.testing.assert_allclose(mean, r_mean, atol=1e-6 * scale, rtol=0)
        np.testing.assert_allclose(std, r_std, atol=1e-6 * scale, rtol=0)
    assert int(ours.state.mask.sum()) == int(mask2.sum())
    with pytest.raises(ValueError, match="superset"):
        ours.update(task.Y_full * mask1, mask1)   # mask must grow


def test_states_do_not_alias_the_callers_arrays():
    """A run pool writes each new epoch into the arrays the predictor was
    updated from. On the CPU ``torch.as_tensor`` would share their memory,
    and a fitted state would change under the scheduler (its rung-0 state
    saw later rungs' observations); ``fit``, ``fit_batch`` and ``extend``
    copy, as the reference's ``jnp.asarray`` does."""
    task = data.sample_task(seed=4, n=5, m=6, d=4)
    X, t = task.X.copy(), task.t.copy()
    Y, mask = task.Y.copy(), task.mask.copy()
    cfg = LKGPConfig(backend="dense", lbfgs_iters=2)
    st = state_mod.fit(X, t, Y, mask, cfg, device=CPU)
    batched = state_mod.fit_batch(X[None], t, Y[None], mask[None], cfg,
                                  device=CPU)
    new_Y, new_mask = task.Y_full.copy(), np.ones_like(task.mask)
    grown = state_mod.extend(st, new_Y, new_mask)
    for a in (X, t, Y, mask, new_Y, new_mask):
        a[...] = 7.0
    for got, want in ((st.X, task.X), (st.t, task.t), (st.mask, task.mask),
                      (batched.X[0], task.X), (batched.mask[0], task.mask),
                      (grown.mask, np.ones_like(task.mask))):
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(st.Y.numpy(), task.Y * task.mask)
    assert np.array_equal(grown.Y.numpy(), task.Y_full)


def test_curve_predictor_minimize_sign_and_rules():
    task = data.sample_task(seed=2, n=5, m=6, d=4)
    pred = CurvePredictor(task.X, 6, gp=_gp(state_mod), maximize=False,
                          device=CPU)
    pred.update(task.Y_full, np.ones_like(task.mask))
    mean, _ = pred.predict_final()
    # score space negates; to_raw undoes it
    np.testing.assert_allclose(pred.to_raw(mean), -mean)
    ucb = pred.scores(rule="ucb", ucb_beta=1.0)
    med = pred.scores(rule="quantile", quantile=0.5)
    hi = pred.scores(rule="quantile", quantile=0.9)
    assert np.all(ucb >= med) and np.all(hi >= med)
    with pytest.raises(ValueError, match="unknown promotion rule"):
        pred.scores(rule="nope")
    with pytest.raises(RuntimeError, match="before any update"):
        CurvePredictor(task.X, 6, device=CPU).predict_final()


def test_curve_predictor_second_default_read_solves_nothing(monkeypatch):
    """A second default ``predict_final`` on an unchanged state returns the
    cached arrays without touching the posterior; an explicit generator
    always runs."""
    task = data.sample_task(seed=2, n=5, m=6, d=4)
    pred = CurvePredictor(task.X, 6, gp=_gp(state_mod), device=CPU)
    pred.update(task.Y, task.mask)
    first = pred.predict_final()
    calls = []
    final = Posterior.final
    monkeypatch.setattr(Posterior, "final",
                        lambda self, *a, **k: calls.append(1)
                        or final(self, *a, **k))
    again = pred.predict_final()
    assert calls == [] and again[0] is first[0] and again[1] is first[1]
    gen = torch.Generator().manual_seed(5)
    pred.predict_final(gen)
    assert calls == [1]


def test_curve_predictor_validates_grid_and_unported_options():
    task = data.sample_task(seed=3, n=5, m=6, d=4)
    with pytest.raises(ValueError, match="disagrees"):
        CurvePredictor(task.X, 7, t=task.t, device=CPU)
    with pytest.raises(ValueError, match="strictly-increasing"):
        CurvePredictor(task.X, t=task.t[::-1], device=CPU)
    with pytest.raises(ValueError, match="max_epochs or an explicit t"):
        CurvePredictor(task.X, device=CPU)
    # the amortized options, once unported, now reach every fit and refit
    from repro_torch.amortize import (Amortizer, AmortizerConfig,
                                      init_amortizer)
    acfg = AmortizerConfig(d=4, d_model=8, curve_layers=1, num_heads=2,
                           d_ff=8)
    am = Amortizer(acfg, init_amortizer(torch.Generator().manual_seed(0),
                                        acfg))
    pred = CurvePredictor(task.X, 6, amortizer=am,
                          gp=LKGPConfig(backend="dense", polish_steps=1),
                          device=CPU)
    mask = np.zeros_like(task.mask)
    for k in (2, 3):
        mask[:, :k] = 1.0
        pred.update(task.Y_full * mask, mask)
        assert pred.state.fit_result.init_source == "amortized"
    sched = SuccessiveHalvingScheduler(task.X, [None] * 5,
                                       SHConfig(amortizer=am), device=CPU)
    assert sched.predictor.amortizer is am


def test_schedulers_need_a_device_for_the_model():
    """Without a GPU the LKGP schedulers raise unless given the CPU; the
    rank mode builds no model and needs none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only raise")
    task = data.sample_task(seed=5, n=6, m=6, d=4)
    fns = data.noisy_step_fns(task, 0, 0.0, 0.0)
    for make in (lambda: SuccessiveHalvingScheduler(task.X, fns),
                 lambda: HyperbandScheduler(task.X, fns),
                 lambda: FreezeThawScheduler(task.X, fns),
                 lambda: CurvePredictor(task.X, 6)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    SuccessiveHalvingScheduler(task.X, fns, SHConfig(promotion="rank"))


# --------------------------------------------------------------------------
# decisions, scheduler by scheduler
# --------------------------------------------------------------------------
def _regret_trajectory(rungs, true_final, best):
    """bench_automl.py's anytime regret: the incumbent after each rung."""
    out = []
    for rung in rungs:
        inc = rung["active"][int(np.argmax(rung["scores"]))]
        out.append([int(rung["epochs_spent"]),
                    float(best - true_final[inc])])
    return out


def _same_rungs(ours, ref, rtol=SCORE_RTOL):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        for k in ("rung", "target_epochs", "active", "epochs_spent"):
            assert o[k] == r[k], (k, o[k], r[k])
        assert o.get("promoted") == r.get("promoted")
        s = np.asarray(r["scores"])
        finite = np.isfinite(s)
        assert np.array_equal(finite, np.isfinite(o["scores"]))
        scale = max(1.0, float(np.abs(s[finite]).max())) if finite.any() \
            else 1.0
        np.testing.assert_allclose(np.asarray(o["scores"])[finite],
                                   s[finite], rtol=0, atol=rtol * scale)


def _same_summary(ours, ref, true_final=None, best=None):
    for k in ("epochs_spent", "selected", "survivors", "observed_best"):
        assert ours[k] == ref[k], (k, ours[k], ref[k])
    _same_rungs(ours["rungs"], ref["rungs"])
    assert ("predicted_final" in ours) == ("predicted_final" in ref)
    if "predicted_final" in ref:
        want = np.asarray(ref["predicted_final"])
        np.testing.assert_allclose(ours["predicted_final"], want, rtol=0,
                                   atol=SCORE_RTOL * np.abs(want).max())
    if true_final is not None:
        assert _regret_trajectory(ours["rungs"], true_final, best) == \
            _regret_trajectory(ref["rungs"], true_final, best)


def _race(at, data_pkg, kw, task, promotion, hist, fresh, seed, **cfg):
    """One SH race as the reference's tests and bench_automl.py run it."""
    m = task.Y_full.shape[1]
    sh_cfg = at.SHConfig(max_epochs=m, promotion=promotion, **cfg)
    sched = at.SuccessiveHalvingScheduler(
        task.X, data_pkg.noisy_step_fns(task, 7000 + seed), sh_cfg,
        seed=seed, t=task.t, **kw)
    for i in hist:
        sched.pool.advance_to(i, m, charge=False)
    return sched, sched.run(subset=fresh)


def test_sh_lkgp_beats_rank_with_the_reference_decisions(handed_draws):
    """The reference's crossing test (n=12, m=9, 3 history curves): both
    promotion modes make the reference's decisions rung by rung, spend the
    same budget, and LKGP promotion wins as it does there."""
    task = data.sample_task(seed=501, n=12, m=9, d=5, noise=0.005,
                            spike_prob=0.0, diverge_prob=0.0, crossing=True)
    rng = np.random.default_rng(1)
    hist = rng.choice(12, 3, replace=False)
    fresh = np.setdiff1d(np.arange(12), hist).tolist()
    true_final = task.Y_full[:, -1]
    best = float(true_final[fresh].max())
    cfg = dict(min_epochs=1, eta=3, ucb_beta=0.0, refit_lbfgs_iters=8)
    out = {}
    for promotion in ("lkgp", "rank"):
        _, ours = _race(port_autotune, data, {"device": CPU}, task,
                        promotion, hist, fresh, 1,
                        gp=_gp(state_mod, lbfgs_iters=20,
                               posterior_samples=64), **cfg)
        _, ref = _race(ref_autotune, ref_data, {}, task, promotion, hist,
                       fresh, 1,
                       gp=_gp(ref_core, lbfgs_iters=20,
                              posterior_samples=64), **cfg)
        _same_summary(ours, ref, true_final, best)
        out[promotion] = ours
    assert out["lkgp"]["epochs_spent"] == out["rank"]["epochs_spent"]
    regret = {k: best - float(true_final[v["selected"]])
              for k, v in out.items()}
    assert regret["lkgp"] < regret["rank"] and regret["lkgp"] < 0.02
    assert set(out["lkgp"]["survivors"]) <= set(fresh)


def test_sh_rank_mode_never_builds_a_model():
    task = data.sample_task(seed=5, n=6, m=6, d=4)
    cfg = SHConfig(max_epochs=6, min_epochs=1, eta=2, promotion="rank")
    sched = SuccessiveHalvingScheduler(
        task.X, data.noisy_step_fns(task, 0, 0.0, 0.0), cfg)
    summary = sched.run()
    ref = ref_autotune.SuccessiveHalvingScheduler(
        task.X, ref_data.noisy_step_fns(task, 0, 0.0, 0.0),
        ref_autotune.SHConfig(max_epochs=6, min_epochs=1, eta=2,
                              promotion="rank")).run()
    assert sched.predictor is None
    assert "predicted_final" not in summary
    assert summary["rungs"][0]["target_epochs"] == 1
    _same_summary(summary, ref)


def test_sh_rank_exhausted_budget_never_selects_unrun_config():
    """With the pool budget exhausted mid-rung, never-run configs (NaN
    observed value) rank worst, as in the reference."""
    task = data.sample_task(seed=8, n=9, m=6, d=4)
    runs = []
    for pkg, dpkg in ((port_autotune, data), (ref_autotune, ref_data)):
        sched = pkg.SuccessiveHalvingScheduler(
            task.X, dpkg.noisy_step_fns(task, 0, 0.0, 0.0),
            pkg.SHConfig(max_epochs=6, min_epochs=1, eta=3,
                         promotion="rank"))
        sched.pool.budget = 2
        runs.append((sched, sched.run()))
    (sched, summary), (_, ref) = runs
    assert sched.pool.epochs_done[summary["selected"]] > 0
    assert np.isneginf(summary["rungs"][0]["scores"]).sum() == 7
    _same_summary(summary, ref)


def test_sh_replays_dataset_task_on_nonuniform_grid(handed_draws):
    """An SH race over the committed LCBench-format fixture's first task:
    replayed curves on the non-uniform (log-spaced) budget grid, the
    reference's decisions, and every observed cell the recorded curve's."""
    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "lcbench_mini.npz")
    task = data.load_artifact(fixture).tasks[0]
    n, m = task.Y_full.shape
    runs = []
    for at, dpkg, core, kw in ((port_autotune, data, state_mod,
                                {"device": CPU}),
                               (ref_autotune, ref_data, ref_core, {})):
        cfg = at.SHConfig(max_epochs=m, min_epochs=1, eta=3,
                          promotion="lkgp", ucb_beta=0.0,
                          refit_lbfgs_iters=5, gp=_gp(core, lbfgs_iters=10))
        sched = at.SuccessiveHalvingScheduler(
            task.X, dpkg.replay_step_fns(task, seed=0), cfg, seed=0,
            t=task.t, **kw)
        runs.append((sched, sched.run(subset=list(range(8)))))
    (sched, summary), (_, ref) = runs
    _same_summary(summary, ref)
    assert 0 <= summary["selected"] < 8
    np.testing.assert_array_equal(sched.predictor.t, np.asarray(task.t))
    np.testing.assert_array_equal(sched.predictor.state.t.numpy(),
                                  np.asarray(task.t))
    obs = sched.pool.mask > 0
    np.testing.assert_allclose(sched.pool.Y[obs],
                               np.asarray(task.Y_full)[obs], atol=0)


def test_hyperband_shares_pool_with_the_reference_decisions(handed_draws):
    task = data.sample_task(seed=6, n=10, m=9, d=4, noise=0.005,
                            spike_prob=0.0, crossing=True)
    runs = []
    for at, dpkg, core, kw in ((port_autotune, data, state_mod,
                                {"device": CPU}),
                               (ref_autotune, ref_data, ref_core, {})):
        cfg = at.SHConfig(max_epochs=9, min_epochs=1, eta=3,
                          promotion="lkgp", ucb_beta=0.0,
                          refit_lbfgs_iters=5, gp=_gp(core, lbfgs_iters=10))
        runs.append(at.HyperbandScheduler(
            task.X, dpkg.noisy_step_fns(task, 1), cfg, seed=0, **kw).run())
    ours, ref = runs
    assert len(ours["brackets"]) == 3          # s = 2, 1, 0
    for k in ("epochs_spent", "selected", "observed_best"):
        assert ours[k] == ref[k]
    assert [b for b, _ in ours["bracket_selections"]] == \
        [b for b, _ in ref["bracket_selections"]]
    for o, r in zip(ours["brackets"], ref["brackets"]):
        for k in ("bracket", "n_configs", "min_epochs"):
            assert o[k] == r[k]
        _same_summary(o, r)
    assert ours["epochs_spent"] <= 10 * 9
    per_bracket = [b["epochs_spent"] for b in ours["brackets"]]
    assert per_bracket == sorted(per_bracket)     # cumulative accounting


def _freeze_thaw(at, dpkg, core, task, seed, kw, step_seed=2, obs_noise=0.01,
                 **cfg):
    m = task.Y_full.shape[1]
    sched = at.FreezeThawScheduler(
        task.X, dpkg.noisy_step_fns(task, step_seed, obs_noise, 0.0),
        at.AutotuneConfig(max_epochs=m, gp=_gp(core, lbfgs_iters=20),
                          refit_lbfgs_iters=8, **cfg), seed=seed, **kw)
    return sched, sched.run()


def _same_freeze_thaw(ours, ref):
    for k in ("epochs_spent", "observed_best", "survivors"):
        assert ours[k] == ref[k], (k, ours[k], ref[k])
    assert len(ours["stop_events"]) == len(ref["stop_events"])
    for o, r in zip(ours["stop_events"], ref["stop_events"]):
        assert (o["epoch"], o["stopped"], o["active"]) == \
            (r["epoch"], r["stopped"], r["active"])
        assert abs(o["pred_best"] - r["pred_best"]) <= \
            SCORE_RTOL * max(1.0, abs(r["pred_best"]))
    want = np.asarray(ref["predicted_final"])
    np.testing.assert_allclose(ours["predicted_final"], want, rtol=0,
                               atol=SCORE_RTOL * np.abs(want).max())


def test_freeze_thaw_keeps_best_config_with_the_reference_stops(handed_draws):
    """The reference's test (n=8, m=10, UCB 1.5): stop event by stop event
    the reference's, with its keyed draws PRNGKey(seed + epoch) handed
    across; the best config survives."""
    task = data.sample_task(seed=7, n=8, m=10, d=5, noise=0.005,
                            spike_prob=0.0)
    cfg = dict(refit_every=3, min_epochs_before_stop=4, ucb_beta=1.5)
    sched, ours = _freeze_thaw(port_autotune, data, state_mod, task, 0,
                               {"device": CPU}, **cfg)
    _, ref = _freeze_thaw(ref_autotune, ref_data, ref_core, task, 0, {},
                          **cfg)
    _same_freeze_thaw(ours, ref)
    assert int(np.argmax(task.Y_full[:, -1])) in ours["survivors"]
    assert ours["epochs_spent"] <= 8 * 10
    assert sched.state is not None and sched.state.device.type == "cpu"


# --------------------------------------------------------------------------
# bench_automl.py's suites: every scheduler, two seeds
# --------------------------------------------------------------------------
SUITES = {
    "smoke-crossing": dict(n=12, m=9, n_hist=3, min_epochs=1),
    "small-crossing": dict(n=16, m=12, n_hist=4, min_epochs=2),
}
BENCH_BASE = dict(d=5, obs_noise=0.02, spike_prob=0.03, diverge_prob=0.0,
                  task_seed=500)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("suite", list(SUITES))
def test_bench_automl_suite_decisions_equal_reference(suite, seed,
                                                      handed_draws):
    """``run_suite``'s four races (SH-lkgp, SH-rank, Hyperband-lkgp,
    freeze-thaw) on one suite and seed: the same decisions, budgets and
    regret trajectories in both packages."""
    s = dict(BENCH_BASE, **SUITES[suite])
    task = data.sample_task(seed=s["task_seed"] + seed, n=s["n"], m=s["m"],
                            d=s["d"], noise=0.005,
                            diverge_prob=s["diverge_prob"], spike_prob=0.0,
                            crossing=True)
    n, m = task.Y_full.shape
    hist = np.random.default_rng(seed).choice(n, s["n_hist"], replace=False)
    fresh = np.setdiff1d(np.arange(n), hist).tolist()
    true_final = task.Y_full[:, -1]
    best = float(true_final[fresh].max())
    sides = {"port": (port_autotune, data, state_mod, {"device": CPU}),
             "ref": (ref_autotune, ref_data, ref_core, {})}
    out = {}
    for side, (at, dpkg, core, kw) in sides.items():
        gp = core.LKGPConfig(lbfgs_iters=20, posterior_samples=64,
                             slq_probes=8, slq_iters=15)
        sh_cfg = dict(max_epochs=m, min_epochs=s["min_epochs"], eta=3, gp=gp,
                      ucb_beta=0.0, refit_lbfgs_iters=8)

        def fns():
            return dpkg.noisy_step_fns(task, 7000 + seed, s["obs_noise"],
                                       s["spike_prob"])

        for promotion in ("lkgp", "rank"):
            sched = at.SuccessiveHalvingScheduler(
                task.X, fns(), at.SHConfig(promotion=promotion, **sh_cfg),
                seed=seed, t=task.t, **kw)
            for i in hist:
                sched.pool.advance_to(i, m, charge=False)
            out[side, promotion] = sched.run(subset=fresh)
        hb = at.HyperbandScheduler(task.X, fns(),
                                   at.SHConfig(promotion="lkgp", **sh_cfg),
                                   seed=seed, candidates=fresh, t=task.t,
                                   **kw)
        for i in hist:
            hb.pool.advance_to(i, m, charge=False)
        out[side, "hyperband"] = hb.run()
        ft = at.FreezeThawScheduler(
            task.X, fns(),
            at.AutotuneConfig(max_epochs=m, refit_every=max(2, m // 4),
                              min_epochs_before_stop=s["min_epochs"],
                              ucb_beta=1.0, gp=gp, refit_lbfgs_iters=8),
            seed=seed, t=task.t, **kw)
        for i in hist:
            ft.pool.advance_to(i, m, charge=False)
        out[side, "freeze-thaw"] = ft.run()
    for promotion in ("lkgp", "rank"):
        _same_summary(out["port", promotion], out["ref", promotion],
                      true_final, best)
    assert out["port", "lkgp"]["epochs_spent"] == \
        out["port", "rank"]["epochs_spent"]
    ours, ref = out["port", "hyperband"], out["ref", "hyperband"]
    for k in ("epochs_spent", "selected"):
        assert ours[k] == ref[k]
    for o, r in zip(ours["brackets"], ref["brackets"]):
        _same_summary(o, r, true_final, best)
    _same_freeze_thaw(out["port", "freeze-thaw"], out["ref", "freeze-thaw"])


# --------------------------------------------------------------------------
# the iterative engines: the cuda route's float32 sweeps against float64 CG
# --------------------------------------------------------------------------
# n=32, m=12: both sides fit with cg_tol 1e-6 on the reference's probes
# (handed across). The port runs through its ``iterative`` engine (float64
# CG) or its ``cuda`` engine (the kernel's plain float32 version on CPU
# tensors, float64 true residuals), the reference through float64 CG. The
# rung-0 scores (a cold fit) agree to 1e-6 either way; a warm refit on the
# float32 route's objective lands up to ~0.7 % of max|score| away (its SLQ
# tridiagonals come from float32 sweeps), so the cuda route is held to 2e-2
# and float64 CG to 1e-5 of max|score|, and the decisions must be equal.
ITERATIVE_CG_TOL = 1e-6
ITERATIVE_SCORE_TOL = {"iterative": 1e-5, "cuda": 2e-2}


@pytest.mark.parametrize("backend", list(ITERATIVE_SCORE_TOL))
def test_sh_through_an_iterative_engine_against_reference_iterative(
        backend, handed_draws, monkeypatch):
    n, m, seed = 32, 12, 0
    task = data.sample_task(seed=510, n=n, m=m, d=5, noise=0.005,
                            spike_prob=0.0, crossing=True)

    def ref_probes(gen, p, mask, dtype):
        z = ref_core.rademacher_probes(
            jax.random.PRNGKey(seed), p, jnp.asarray(mask.numpy()),
            jnp.float64)
        return probes_from_numpy(np.asarray(z), mask)

    monkeypatch.setattr(state_mod, "rademacher_probes", ref_probes)
    launches = lk_mvm.lk_mvm_fused.launches
    runs = []
    for at, dpkg, core, name, kw in (
            (port_autotune, data, state_mod, backend, {"device": CPU}),
            (ref_autotune, ref_data, ref_core, "iterative", {})):
        gp = core.LKGPConfig(backend=name, lbfgs_iters=10,
                             posterior_samples=16, slq_probes=8, slq_iters=10,
                             cg_tol=ITERATIVE_CG_TOL, seed=seed)
        cfg = at.SHConfig(max_epochs=m, min_epochs=1, eta=3, ucb_beta=0.0,
                          refit_lbfgs_iters=5, gp=gp)
        sched = at.SuccessiveHalvingScheduler(
            task.X, dpkg.noisy_step_fns(task, 7000), cfg, seed=seed, **kw)
        runs.append((sched, sched.run()))
    (sched, ours), (_, ref) = runs
    assert sched.predictor.state.config.backend == backend
    assert lk_mvm.lk_mvm_fused.launches == launches   # CPU: the plain version
    _same_rungs(ours["rungs"], ref["rungs"],
                rtol=ITERATIVE_SCORE_TOL[backend])
    assert ours["selected"] == ref["selected"]
    assert ours["epochs_spent"] == ref["epochs_spent"]
