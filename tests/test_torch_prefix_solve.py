"""The posterior solves on the observed prefix of the epoch grid.

With L one past the last observed epoch column, the masked operator is the
(n, L) grid's with ``K2[:L, :L]``. ``Posterior`` solves there; these tests
hold its answers to the full-grid solve made directly through the engine (the
path it took before), show that a state with one full curve runs that path
bit for bit, and that an interior all-zero column is kept.
"""
import dataclasses

import pytest
import torch

from repro_torch import core
from repro_torch.core import get_engine, joint_grams, posterior
from repro_torch.core.matheron import (kronecker_correction,
                                       prior_residual_draws)
from repro_torch.data.curves import sample_task

F64 = torch.float64
N, M, D, S = 64, 12, 4, 8


def make_state(lens, backend: str):
    """A state over ``sample_task``'s curves, config i observed for its
    first ``lens[i]`` epochs."""
    task = sample_task(3, n=N, m=M, d=D)
    X, t, Y_full = (torch.tensor(a, dtype=F64)
                    for a in (task.X, task.t, task.Y_full))
    lens = torch.as_tensor(lens)
    mask = (torch.arange(M)[None, :] < lens[:, None]).to(F64)
    Y = Y_full * mask
    cfg = core.LKGPConfig(backend=backend, posterior_samples=S, seed=5,
                          cg_tol=1e-8)
    params = core.LKGPParams(
        raw_x_lengthscale=torch.zeros(D, dtype=F64),
        raw_t_lengthscale=torch.tensor(0.0, dtype=F64),
        raw_outputscale=torch.tensor(0.0, dtype=F64),
        raw_noise=torch.tensor(-3.0, dtype=F64))
    return core.LKGPState(params=params, X=X, t=t, Y=Y, mask=mask,
                          x_tf=core.XTransform.fit(X),
                          t_tf=core.TTransform.fit(t),
                          y_tf=core.YTransform.fit(Y, mask), config=cfg)


def sh_lens(L: int):
    """Successive Halving's rung: every config at 1 epoch, a third at L."""
    lens = torch.ones(N, dtype=torch.long)
    lens[::3] = L
    return lens


def normals(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((S, N, M), generator=g, dtype=F64),
            torch.randn((S, N, M), generator=g, dtype=F64))


def full_grid(state, Z):
    """The full (n, m) grid's answers, each solve made directly through
    ``engine.solve(engine.operator_from_grams(K1, K2, mask, noise), ...)``:
    alpha, the mean, the samples from normals ``Z`` and ``final()``'s
    (mean, var)."""
    cfg = state.config
    engine = get_engine(cfg.backend)
    K1a, K2 = joint_grams(state)
    noise = torch.exp(state.params.raw_noise)
    A = engine.operator_from_grams(K1a[:N, :N], K2, state.mask, noise)
    F, eps = prior_residual_draws(None, K1a, K2, N, noise, S,
                                  jitter=cfg.jitter, normals=Z)
    resid = state.mask * (F[:, :N, :] + eps)
    Ym = state.y_tf(state.Y) * state.mask
    sol = engine.solve(A, torch.cat([Ym[None], resid], dim=0), cfg)
    alpha = sol[0]
    u = sol[0][None] - sol[1:]
    samples = state.y_tf.inverse(F + kronecker_correction(K1a, u, K2, N))
    mean = state.y_tf.inverse(K1a[:, :N] @ alpha @ K2)
    var = samples[:, :, -1].var(dim=0, unbiased=False) \
        + state.y_tf.inverse_var(noise)
    return {"alpha": alpha, "mean": mean, "samples": samples,
            "final": (mean[:, -1], var)}


def close(got, want, backend="dense"):
    """Float64 rounding for ``dense``. The ``cuda`` engine's sweeps are
    float32 (its plain version on the CPU), and a float32 product sums in an
    order that follows the grid's width, so there the two solves agree to
    that rounding carried through CG: 1e-7 of the answer's scale."""
    if backend == "dense":
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
    else:
        assert float((got - want).abs().max()) \
            <= 1e-7 * float(want.abs().max())


@pytest.mark.parametrize("backend", ["cuda", "dense"])
@pytest.mark.parametrize("L", [4, 1])
def test_prefix_solve_matches_the_full_grid(backend, L):
    state = make_state(sh_lens(L), backend)
    Z = normals()
    want = full_grid(state, Z)
    post = posterior(state, cache=False, device="cpu")
    assert post._prefix == L
    assert tuple(post._operator.mask.shape) == (N, L)
    samples = post.samples(None, normals=Z)
    close(post.alpha, want["alpha"], backend)
    assert post.alpha.shape == (N, M)
    assert torch.all(post.alpha[:, L:] == 0)
    close(post.mean, want["mean"], backend)
    close(samples, want["samples"], backend)
    fresh = posterior(state, cache=False, device="cpu")
    for got, w in zip(fresh.final(normals=Z), want["final"]):
        close(got, w, backend)
    assert fresh.solve_count == 1


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_one_full_curve_runs_the_full_grid_bit_for_bit(backend):
    lens = sh_lens(4)
    lens[5] = M
    state = make_state(lens, backend)
    Z = normals(1)
    post = posterior(state, cache=False, device="cpu")
    assert post._prefix == M
    assert post._operator.K2 is post._grams[1]
    assert post._operator.mask is state.mask
    want = full_grid(state, Z)
    for got, w in zip(post.final(normals=Z), want["final"]):
        assert torch.equal(got, w)
    assert torch.equal(post.alpha, want["alpha"])


def test_an_interior_empty_column_is_kept():
    state = make_state(sh_lens(6), "dense")
    mask = state.mask.clone()
    mask[:, 2] = 0.0
    state = dataclasses.replace(state, mask=mask, Y=state.Y * mask,
                                y_tf=core.YTransform.fit(state.Y * mask, mask))
    Z = normals(2)
    want = full_grid(state, Z)
    post = posterior(state, cache=False, device="cpu")
    assert post._prefix == 6
    op_mask = post._operator.mask
    assert tuple(op_mask.shape) == (N, 6) and torch.all(op_mask[:, 2] == 0)
    assert torch.equal(op_mask, mask[:, :6])
    for got, w in zip(post.final(normals=Z), want["final"]):
        close(got, w)
