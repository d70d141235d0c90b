"""PyTorch port, the serving slice as a whole: a state fitted by the
reference is carried across with ``state_from_reference`` and
``posterior(state).mean / .samples / .final`` are held against the
reference's posterior on the same backend. Random draws are made once (by
the reference's PRNG) and handed to both sides."""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.data import sample_task as ref_sample_task
from repro_torch import params_from_numpy, state_from_reference
from repro_torch.core import (CustomMVMEngine, GuardedSolveError, LKGPState,
                              Posterior, PosteriorLike, get_engine,
                              joint_grams, lk_mvm, posterior, solve_tally)
from repro_torch.core.matheron import (kronecker_correction,
                                       prior_residual_draws,
                                       sample_posterior_grid)
from repro_torch.kernels import lk_mvm_fused

N, M, D, S = 12, 10, 4, 8
# engine slot here -> engine slot in the reference, cg_tol, tolerance on
# means/samples in y units (max |y| ~ 1).  dense: rounding. iterative: both
# CG runs converge to 1e-10. cuda/pallas: float32 MVMs, CG stops near their
# floor (cg_tol=1e-5), where two correct solves differ by ~1e-5.
BACKENDS = {
    "dense": ("dense", 1e-10, 1e-9),
    "iterative": ("iterative", 1e-10, 1e-8),
    "cuda": ("pallas", 1e-5, 1e-4),
    "pallas": ("pallas", 1e-5, 1e-4),
}


def arrays_from_reference(state) -> dict:
    """Flatten a reference LKGPState into the numpy mapping convert takes."""
    out = {f"params.{k}": np.asarray(v)
           for k, v in state.params._asdict().items()}
    for name in ("X", "t", "Y", "mask"):
        out[name] = np.asarray(getattr(state, name))
    for tf_name in ("x_tf", "t_tf", "y_tf"):
        for k, v in getattr(state, tf_name)._asdict().items():
            out[f"{tf_name}.{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def fitted():
    """A reference state after a few L-BFGS iterations (dense, small)."""
    task = ref_sample_task(seed=3, n=N, m=M, d=D)
    cfg = ref_core.LKGPConfig(lbfgs_iters=5, posterior_samples=S, seed=11)
    state = ref_core.fit(task.X, task.t, task.Y, task.mask, cfg)
    rng = np.random.default_rng(0)
    return state, rng.uniform(size=(5, D))


def _pair(fitted, backend):
    """(reference state, port state) configured for one backend."""
    ref_state, _ = fitted
    ref_backend, cg_tol, tol = BACKENDS[backend]
    rcfg = dataclasses.replace(ref_state.config, backend=ref_backend,
                               cg_tol=cg_tol, cg_max_iters=2000)
    rstate = dataclasses.replace(ref_state, config=rcfg)
    cfg = dict(dataclasses.asdict(rcfg), backend=backend)
    state = state_from_reference(arrays_from_reference(ref_state), cfg,
                                 device="cpu")
    return rstate, state, tol


def _reference_normals(key, n_samples, n_joint):
    """The standard-normal draws prior_residual_draws makes from ``key``."""
    kz, ke = jax.random.split(key)
    Z = jax.random.normal(kz, (n_samples, n_joint, M), jnp.float64)
    E = jax.random.normal(ke, (n_samples, N, M), jnp.float64)
    return np.asarray(Z), np.asarray(E)


# --------------------------------------------------------------------------
# carrying the state across
# --------------------------------------------------------------------------
def test_state_from_reference_round_trips_every_field(fitted):
    ref_state, _ = fitted
    arrays = arrays_from_reference(ref_state)
    state = state_from_reference(arrays, dataclasses.asdict(ref_state.config),
                                 device="cpu")
    assert isinstance(state, LKGPState)
    assert (state.n, state.m, state.d) == (N, M, D)
    assert state.device == torch.device("cpu")
    assert dataclasses.asdict(state.config) == dataclasses.asdict(
        ref_state.config)
    for k, v in state.params._asdict().items():
        assert v.dtype == torch.float64
        np.testing.assert_array_equal(v.numpy(), arrays[f"params.{k}"])
    assert state.mask.dtype == torch.float64            # 0/1 floats, not bool
    for got, want in zip(state.data, ref_state.data):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                                   atol=1e-13)
    K1a, K2 = joint_grams(state)
    R1a, R2 = ref_core.joint_grams(ref_state)
    np.testing.assert_allclose(K1a.numpy(), np.asarray(R1a), atol=1e-13)
    np.testing.assert_allclose(K2.numpy(), np.asarray(R2), atol=1e-13)
    moved = state.with_params(state.params._replace(
        raw_noise=state.params.raw_noise + 1))
    assert moved is not state and moved.X is state.X


def test_state_from_reference_validates_its_input(fitted):
    arrays = arrays_from_reference(fitted[0])
    with pytest.raises(ValueError, match="unknown LKGPConfig"):
        state_from_reference(arrays, {"bakend": "dense"}, device="cpu")
    with pytest.raises(KeyError, match="y_tf.scale"):
        state_from_reference({k: v for k, v in arrays.items()
                              if k != "y_tf.scale"}, device="cpu")
    with pytest.raises(KeyError, match="raw_noise"):
        state_from_reference({k: v for k, v in arrays.items()
                              if k != "params.raw_noise"}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        state_from_reference(dict(arrays, Y=arrays["Y"][:, :-1]), device="cpu")
    p32 = params_from_numpy({k[7:]: v for k, v in arrays.items()
                             if k.startswith("params.")},
                            dtype=torch.float32, device="cpu")
    assert all(v.dtype == torch.float32 for v in p32)
    assert p32.raw_noise.shape == () and p32.raw_x_lengthscale.shape == (D,)


# --------------------------------------------------------------------------
# mean / samples / final against the reference, per backend
# --------------------------------------------------------------------------
@pytest.mark.parametrize("with_xs", [False, True], ids=["train", "new_configs"])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_posterior_mean_matches_reference(fitted, backend, with_xs):
    rstate, state, tol = _pair(fitted, backend)
    Xs = fitted[1] if with_xs else None
    want = np.asarray(ref_core.posterior(rstate, Xs=Xs).mean)
    post = posterior(state, Xs=Xs, device="cpu")
    got = post.mean
    assert got.shape == (N + (5 if with_xs else 0), M)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= tol
    assert post.solve_count == 1
    if backend != "dense":
        info = post.solve_info
        assert float(info.rel_residual) <= state.config.cg_tol
        assert not bool(info.breakdown)


@pytest.mark.parametrize("with_xs", [False, True], ids=["train", "new_configs"])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_posterior_samples_match_reference_on_shared_normals(fitted, backend,
                                                             with_xs):
    rstate, state, tol = _pair(fitted, backend)
    Xs = fitted[1] if with_xs else None
    key = jax.random.PRNGKey(5)
    want = np.asarray(ref_core.posterior(rstate, Xs=Xs).samples(key, 6))
    normals = _reference_normals(key, 6, want.shape[1])
    post = posterior(state, Xs=Xs, device="cpu")
    got = post.samples(None, 6, normals=normals)
    assert got.shape == want.shape == (6, N + (5 if with_xs else 0), M)
    assert np.abs(got.numpy() - want).max() <= 10 * tol
    # [y | residuals] went through ONE stacked solve, which also left alpha
    assert post.solve_count == 1
    again = post.samples(None, 6, normals=normals)
    assert post.solve_count == 2
    assert np.abs(again.numpy() - want).max() <= 10 * tol


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_posterior_final_matches_reference(fitted, backend):
    """Mean exact; variance from the reference's default draws (stream
    (seed, 1), posterior_samples of them), handed over as ``normals``."""
    rstate, state, tol = _pair(fitted, backend)
    rmean, rvar = ref_core.posterior(rstate).final()
    key = jax.random.fold_in(jax.random.PRNGKey(rstate.config.seed), 1)
    normals = _reference_normals(key, S, N)
    post = posterior(state, device="cpu")
    mean, var = post.final(normals=normals)
    assert mean.shape == var.shape == (N,)
    assert np.abs(mean.numpy() - np.asarray(rmean)).max() <= tol
    assert np.abs(var.numpy() - np.asarray(rvar)).max() <= 10 * tol
    assert post.solve_count == 1          # one stacked solve for both
    noise_var = float(state.y_tf.inverse_var(torch.exp(state.params.raw_noise)))
    assert float(var.min()) > noise_var


def test_variance_and_default_streams(fitted):
    _, state, _ = _pair(fitted, "iterative")
    post = posterior(state, device="cpu")
    var = post.variance
    assert var.shape == (N, M) and bool((var > 0).all())
    mean, fvar = post.final()             # the cached default samples
    torch.testing.assert_close(fvar, var[:, -1])
    assert post.solve_count == 1
    # explicit sample count: the fallback stream (seed, 2), not stream 1
    _, fvar2 = post.final(n_samples=S)
    assert post.solve_count == 2
    assert not torch.allclose(fvar2, fvar)
    # the same generator seed gives the same samples; another seed does not
    g = lambda seed: torch.Generator().manual_seed(seed)
    a, b, c = (post.samples(g(s), 3) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert isinstance(post, PosteriorLike)


# --------------------------------------------------------------------------
# the state-keyed cache, the kernel slot, the strict policy
# --------------------------------------------------------------------------
def test_posterior_cache_identity_and_solve_count(fitted):
    _, state, _ = _pair(fitted, "iterative")
    post = posterior(state, device="cpu")
    mean = post.mean
    tally = solve_tally()
    again = posterior(state, device="cpu")
    assert again is post and again.mean is not None
    assert post.solve_count == 1 and solve_tally() == tally
    torch.testing.assert_close(again.mean, mean)
    # explicit Xs / engine / cache=False bypass the cache
    assert posterior(state, cache=False, device="cpu") is not post
    assert posterior(state, Xs=fitted[1], device="cpu") is not post
    assert posterior(state, engine=get_engine("dense"), device="cpu") is not post
    with pytest.raises(ValueError, match="cache=True"):
        posterior(state, Xs=fitted[1], cache=True, device="cpu")
    # a new state object starts cold; posterior_cache=False never attaches
    cold = dataclasses.replace(state)
    assert posterior(cold, device="cpu") is not post
    off = dataclasses.replace(state, config=dataclasses.replace(
        state.config, posterior_cache=False))
    assert posterior(off, device="cpu") is not posterior(off, device="cpu")


def test_kernel_slot_engine_goes_through_the_kernel_wrapper(fitted, monkeypatch):
    """Every CG iteration of the cuda engine is one call of the operator's
    launch of the fused kernel, over float32 operands and a 0-d noise
    tensor; the true residuals (start, end, replacements) go through the
    float64 MVM."""
    import repro_torch.kernels.lk_mvm as mod
    calls = []
    real = mod.MVMLaunch.__call__

    def counting(launch, u):
        calls.append((launch.route, launch.K1.dtype, u.dtype,
                      tuple(u.shape), type(launch.noise)))
        return real(launch, u)

    monkeypatch.setattr(mod.MVMLaunch, "__call__", counting)
    _, state, _ = _pair(fitted, "cuda")
    launches = lk_mvm_fused.launches
    post = posterior(state, device="cpu")
    post.final()
    info = post.solve_info
    assert len(calls) == int(info.iters) > 0
    assert float(info.rel_residual.max()) <= state.config.cg_tol
    assert set(calls) == {("fused", torch.float32, torch.float64,
                           (S + 1, N, M), torch.Tensor)}
    assert lk_mvm_fused.launches == launches      # CPU: no kernel launch


def test_degraded_solve_raises_through_the_posterior(fitted):
    """Through a broken MVM the posterior raises under the strict policy
    and keeps nothing; under the default policy the ladder's dense fallback
    serves the dense engine's mean, its trace on ``solve_info``."""
    _, state, _ = _pair(fitted, "iterative")
    broken = CustomMVMEngine(lambda K1, K2, mask, u, noise=0.0:
                             -lk_mvm(K1, K2, mask, u, noise))
    strict = dataclasses.replace(state, config=dataclasses.replace(
        state.config, solve_policy="strict"))
    post = posterior(strict, engine=broken, device="cpu")
    with pytest.raises(GuardedSolveError, match="strict"):
        post.mean
    with pytest.raises(GuardedSolveError):
        post.final()
    assert post._alpha is None                    # nothing degraded was kept
    post = posterior(state, engine=broken, device="cpu")
    want = posterior(state, engine=get_engine("dense"), device="cpu").mean
    np.testing.assert_allclose(post.mean.numpy(), want.numpy(), atol=1e-9)
    assert [s.stage for s in post.solve_info.trace][-1] == "dense_fallback"


def test_posterior_refuses_a_state_on_another_device(fitted):
    _, state, _ = _pair(fitted, "dense")
    meta = dataclasses.replace(state, X=state.X.to("meta"))
    with pytest.raises(ValueError, match="lives on"):
        posterior(meta, device="cpu")


# --------------------------------------------------------------------------
# Matheron pieces
# --------------------------------------------------------------------------
def test_matheron_pieces_match_reference(fitted):
    ref_state, Xs = fitted
    _, state, _ = _pair(fitted, "iterative")
    K1a, K2 = joint_grams(state, Xs)
    R1a, R2 = ref_core.joint_grams(ref_state, Xs)
    np.testing.assert_allclose(K1a.numpy(), np.asarray(R1a), atol=1e-13)
    key = jax.random.PRNGKey(9)
    noise = float(np.exp(np.asarray(ref_state.params.raw_noise)))
    from repro.core.matheron import kronecker_correction as ref_corr
    from repro.core.matheron import prior_residual_draws as ref_draws
    from repro.core.matheron import sample_posterior_grid as ref_grid
    RF, Reps = ref_draws(key, R1a, R2, N, noise, 4)
    normals = _reference_normals(key, 4, N + 5)
    F, eps = prior_residual_draws(None, K1a, K2, N, noise, 4, normals=normals)
    np.testing.assert_allclose(F.numpy(), np.asarray(RF), atol=1e-10)
    np.testing.assert_allclose(eps.numpy(), np.asarray(Reps), atol=1e-12)
    u = torch.from_numpy(normals[1])
    np.testing.assert_allclose(
        kronecker_correction(K1a, u, K2, N).numpy(),
        np.asarray(ref_corr(R1a, jnp.asarray(normals[1]), R2, N)), atol=1e-10)
    with pytest.raises(ValueError, match="normals must have shapes"):
        prior_residual_draws(None, K1a, K2, N, noise, 3, normals=normals)
    # own draws: right shapes, reproducible, prior covariance roughly right
    g = torch.Generator().manual_seed(0)
    F2, eps2 = prior_residual_draws(g, K1a, K2, N, noise, 2000)
    assert F2.shape == (2000, N + 5, M) and eps2.shape == (2000, N, M)
    assert abs(float(eps2.var()) - noise) < 0.1 * noise
    emp = (F2[:, 0, :, None] * F2[:, 0, None, :]).mean(0)
    assert float((emp - K1a[0, 0] * K2).abs().max()) < 0.15 * float(K2.max())
    # the whole sampler, both ways of solving
    Y = state.y_tf(state.Y)
    ry = jnp.asarray(Y.numpy())
    want = np.asarray(ref_grid(key, R1a, R2, N, ry, jnp.asarray(
        state.mask.numpy()), noise, 4, cg_tol=1e-10))
    got = sample_posterior_grid(None, K1a, K2, N, Y, state.mask, noise, 4,
                                cg_tol=1e-10, normals=normals)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    alpha = Posterior(dataclasses.replace(state, config=dataclasses.replace(
        state.config, cg_tol=1e-10))).alpha
    got2 = sample_posterior_grid(None, K1a, K2, N, Y, state.mask, noise, 4,
                                 cg_tol=1e-10, alpha=alpha, normals=normals)
    np.testing.assert_allclose(got2.numpy(), want, atol=1e-7)
