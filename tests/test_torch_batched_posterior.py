"""PyTorch port, the batched exact posterior: a state fitted by the
reference's ``fit_batch`` is carried across with ``state_from_reference`` and
``posterior_batch(state)`` is held against the reference's on it; the bits
of a task do not depend on the batch it came in; each task agrees with the
lazy ``Posterior`` on the ``dense`` engine. Draws are made once by the
reference's PRNG and handed to both sides."""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.data import sample_suite as ref_sample_suite
from repro.data import stack_suite as ref_stack_suite
from repro_torch import state_from_reference
from repro_torch.core import (BatchedPosterior, LKGPConfig, PosteriorLike,
                              fit_batch, posterior, posterior_batch,
                              stack_states, unstack)
from repro_torch.core.posterior import _BATCH_CACHE_ATTR

B, N, M, D, S = 3, 8, 6, 4, 5
TOL = 1e-9     # relative to max|reference|: rounding of two exact paths


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(state) -> dict:
    """A reference state (batched or not) as convert's numpy mapping."""
    out = {f"params.{k}": np.asarray(v)
           for k, v in state.params._asdict().items()}
    for name in ("X", "t", "Y", "mask"):
        out[name] = np.asarray(getattr(state, name))
    for tf_name in ("x_tf", "t_tf", "y_tf"):
        for k, v in getattr(state, tf_name)._asdict().items():
            out[f"{tf_name}.{k}"] = np.asarray(v)
    return out


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * scale)


@pytest.fixture(scope="module")
def carried():
    """(reference batched state, the port's copy of it)."""
    tasks = ref_sample_suite(7, B, n=N, m=M, d=D)
    X, t, Y, mask, _ = ref_stack_suite(tasks)
    cfg = ref_core.LKGPConfig(lbfgs_iters=4, posterior_samples=S, seed=3)
    ref = ref_core.fit_batch(X, t, Y, mask, cfg)
    state = state_from_reference(_arrays(ref), dataclasses.asdict(cfg),
                                 device="cpu")
    return ref, state


def test_convert_carries_a_batched_state(carried):
    ref, state = carried
    assert state.X.shape == (B, N, D) and state.t.shape == (B, M)
    assert state.params.raw_x_lengthscale.shape == (B, D)
    assert state.params.raw_noise.shape == (B,)
    assert state.y_tf.scale.shape == (B,)
    for a, b in zip(state.params, ref.params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="t must have shape"):
        bad = _arrays(ref)
        bad["t"] = bad["t"][0]
        state_from_reference(bad, device="cpu")


def test_mean_and_exact_final_match_reference(carried):
    """Exact dense products of the same parameters: mean, final mean and
    final variance (exact) within 1e-9 of max|reference|."""
    ref, state = carried
    post = posterior_batch(state, device="cpu")
    want = ref_core.posterior_batch(ref)
    assert isinstance(post, PosteriorLike) and post.solve_info is None
    _close(post.mean, want.mean)
    assert post.mean.shape == (B, N, M)
    (gm, gv), (wm, wv) = post.final(), want.final()
    assert gm.shape == gv.shape == (B, N)
    _close(gm, wm)
    _close(gv, wv)


def test_variance_matches_reference(carried):
    ref, state = carried
    _close(posterior_batch(state, device="cpu").variance,
           ref_core.posterior_batch(ref).variance)


def test_samples_and_mc_final_on_the_reference_normals(carried):
    """The reference's standard normals (its key, its draw shape) handed
    across: samples (s, B, n, m) and the Monte Carlo final within 1e-9."""
    ref, state = carried
    key = jax.random.PRNGKey(11)
    z = np.asarray(jax.random.normal(key, (B, S, N * M), jax.numpy.float64))
    want = ref_core.posterior_batch(ref)
    post = posterior_batch(state, device="cpu")
    got = post.samples(None, S, normals=z)
    assert got.shape == (S, B, N, M)
    _close(got, want.samples(key, S))
    gm, gv = post.final(None, S, normals=z)
    wm, wv = want.final(key, S)
    _close(gm, wm)
    _close(gv, wv)
    with pytest.raises(ValueError, match="normals must have shape"):
        post.samples(None, S, normals=z[:, :2])


def test_default_streams_are_reproducible(carried):
    """final(generator) and final(n_samples=...) draw from torch generators:
    the same seed gives the same bits; the default final is exact."""
    _, state = carried
    post = posterior_batch(state, device="cpu", cache=False)
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    assert torch.equal(post.final(g1, 7)[1], post.final(g2, 7)[1])
    a = post.final(n_samples=6)[1]
    assert torch.equal(a, post.final(n_samples=6)[1])
    assert not torch.equal(a, post.final()[1])


@pytest.mark.parametrize("task", range(B))
def test_bitwise_across_batch_sizes(carried, task):
    """Task i's mean and exact final from a batch of 1 and a batch of 3
    (stack_states of the unstacked tasks) are the same bits."""
    _, state = carried
    tasks = unstack(state)
    one = posterior_batch(stack_states([tasks[task]]), device="cpu")
    many = posterior_batch(stack_states(tasks), device="cpu")
    assert torch.equal(one.mean[0], many.mean[task])
    (m1, v1), (m3, v3) = one.final(), many.final()
    assert torch.equal(m1[0], m3[task]) and torch.equal(v1[0], v3[task])


def test_each_task_matches_the_lazy_dense_posterior(carried):
    """Per task against Posterior on the dense engine (same Grams, jitter on
    K2 only): mean and final mean within 1e-9 relative."""
    _, state = carried
    post = posterior_batch(state, device="cpu")
    for i, st in enumerate(unstack(state)):
        lazy = posterior(st, cache=False, device="cpu")
        _close(post.mean[i], lazy.mean.numpy())


def test_port_fit_batch_serves_and_caches():
    """The port's own fit_batch state: posterior_batch is cached on the
    state (one object per state, cache=False builds a new one); an unbatched
    state and a state on another device are refused."""
    tasks = ref_sample_suite(2, 2, n=N, m=M, d=D)
    X, t, Y, mask, _ = ref_stack_suite(tasks)
    st = fit_batch(X, t, Y, mask, LKGPConfig(), polish_steps=1, device="cpu")
    p = posterior_batch(st, device="cpu")
    assert posterior_batch(st, device="cpu") is p
    assert getattr(st, _BATCH_CACHE_ATTR) is p
    assert posterior_batch(st, cache=False, device="cpu") is not p
    off = fit_batch(X, t, Y, mask, LKGPConfig(posterior_cache=False),
                    polish_steps=0, device="cpu")
    assert posterior_batch(off, device="cpu") is not \
        posterior_batch(off, device="cpu")
    with pytest.raises(ValueError, match="expects a batched state"):
        BatchedPosterior(unstack(st)[0])
    with pytest.raises(ValueError, match="lives on cpu"):
        posterior_batch(st, device="meta")
    assert bool(torch.isfinite(p.final()[1]).all())
