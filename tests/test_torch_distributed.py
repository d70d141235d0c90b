"""PyTorch port, the distributed slice: kernel K3's plain version against the
reference's ``lk_mvm_fused_rows`` (interpret mode on CPU), the
``distributed`` engine against the reference's ``DistributedEngine`` on one
device (its float32 / float64 gate, a float32 state served, a float64 fit),
the row-sharded ``dist_*`` functions against theirs, and a 2-rank ``gloo``
run against a world of one. Inputs are made with numpy from a seed and handed
to both frameworks.
"""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core.engines import DistributedEngine as RefDistributedEngine
from repro.distributed import lkgp_dist as ref_dist
from repro.kernels.lk_mvm import lk_mvm_fused_rows as ref_lk_mvm_fused_rows
from repro_torch import probes_from_numpy, state_from_reference
from repro_torch.core import (BACKENDS, DistributedEngine, DistributedOperator,
                              LKGPConfig, fit, get_engine, joint_grams, lk_mvm,
                              posterior, resolve_backend)
from repro_torch.core import state as state_mod
from repro_torch.data import sample_task
from repro_torch.distributed import (dist_cg_solve, dist_lk_mvm_fused,
                                     dist_lk_operator, dist_mll_value)
from repro_torch.kernels import lk_mvm as lk_mod
from repro_torch.kernels import lk_mvm_fused_rows, lk_mvm_fused_rows_plain
from _tf32_emulation import tc_matmul

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _grid_problem(n, m, B=1, seed=0, dtype=np.float32):
    """SPD K1 / K2, a prefix (early-stopping) mask, masked u (B, n, m)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    K1 = A @ A.T / n + 0.5 * np.eye(n)
    Bm = rng.standard_normal((m, m))
    K2 = Bm @ Bm.T / m + 0.5 * np.eye(m)
    lens = rng.integers(1, m + 1, n)
    mask = (np.arange(m)[None, :] < lens[:, None]).astype(np.float64)
    u = rng.standard_normal((B, n, m)) * mask
    return tuple(x.astype(dtype) for x in (K1, K2, mask, u))


# --------------------------------------------------------------------------
# kernel K3: the plain version against the reference's Pallas kernel
# --------------------------------------------------------------------------
# (n_local, n, m, shard): ragged row shards, n_local and m off every tile.
ROW_SHARDS = [(65, 130, 70, 0), (65, 130, 70, 1), (5, 10, 3, 1),
              (16, 48, 21, 2), (7, 7, 19, 0)]


@pytest.mark.parametrize("shard", ROW_SHARDS, ids=str)
@pytest.mark.parametrize("precision,rel_tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_fused_rows_plain_matches_reference_kernel(shard, precision, rel_tol):
    """One rank's rows of the grid: f32 differs from the reference's kernel
    only in summation order (<= 1e-5 * scale); bf16 rounds at the same points
    but sums in another order before rounding T, so single bf16 ulps flip
    (<= 2e-2 * scale, as for K1)."""
    n_local, n, m, r = shard
    K1, K2, mask, u = _grid_problem(n, m)
    rows = slice(r * n_local, (r + 1) * n_local)
    um_full = mask * u[0]
    args = (K1[rows], K2, mask[rows], u[0, rows], um_full)
    ref = np.asarray(ref_lk_mvm_fused_rows(
        *(jnp.asarray(a) for a in args), 0.37, block_n=16, block_m=16,
        precision=precision, interpret=True))
    out = lk_mvm_fused_rows_plain(*_t(*args), 0.37, precision=precision)
    assert out.dtype == torch.float32 and out.shape == (n_local, m)
    scale = np.abs(ref).max()
    assert np.abs(out.numpy() - ref).max() <= rel_tol * scale
    # the wrapper on CPU tensors is the plain version, bit for bit
    wrapped = lk_mvm_fused_rows(*_t(*args), 0.37, precision=precision)
    assert torch.equal(wrapped, out)


@pytest.mark.parametrize("shard", ROW_SHARDS, ids=str)
def test_fused_rows_3xtf32_emulation_matches_reference_kernel(shard):
    """K3's f32-mode arithmetic (T = um_full @ K2 and K1_rows @ T, each from
    three TF32 products) against the reference's kernel in interpret mode:
    within 1e-4 * max|ref|, and closer than one TF32 pass."""
    n_local, n, m, r = shard
    K1, K2, mask, u = _grid_problem(n, m, seed=5)
    rows = slice(r * n_local, (r + 1) * n_local)
    um_full = mask * u[0]
    args = (K1[rows], K2, mask[rows], u[0, rows], um_full)
    ref = np.asarray(ref_lk_mvm_fused_rows(
        *(jnp.asarray(a) for a in args), 0.37, block_n=16, block_m=16,
        interpret=True))
    K1r, K2t, mr, ur, um = _t(*args)
    err = {}
    for p in (1, 3):
        out = mr * tc_matmul(K1r, tc_matmul(um, K2t, p), p) + 0.37 * mr * ur
        err[p] = np.abs(out.numpy() - ref).max()
    assert err[3] <= 1e-4 * np.abs(ref).max()
    assert err[1] > err[3]


def test_fused_rows_batch_is_one_call_per_batch_of_the_reference():
    """A leading batch goes through one call; each slice equals the
    reference's rank-2 kernel on that slice (1e-5 * scale)."""
    n_local, n, m = 13, 26, 9
    K1, K2, mask, u = _grid_problem(n, m, B=3, seed=1)
    rows = slice(n_local, 2 * n_local)
    um_full = mask * u
    out = lk_mvm_fused_rows(*_t(K1[rows], K2, mask[rows],
                                np.ascontiguousarray(u[:, rows]), um_full),
                            0.1)
    assert out.shape == (3, n_local, m)
    for b in range(3):
        ref = np.asarray(ref_lk_mvm_fused_rows(
            jnp.asarray(K1[rows]), jnp.asarray(K2), jnp.asarray(mask[rows]),
            jnp.asarray(u[b, rows]), jnp.asarray(um_full[b]), 0.1,
            block_n=16, block_m=16, interpret=True))
        assert np.abs(out[b].numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("bad", ["dtype", "um_shape", "k1_shape", "device",
                                 "grad", "precision", "layout"])
def test_fused_rows_wrapper_rejects_what_the_kernel_does_not_take(bad):
    n_local, n, m = 4, 8, 5
    K1, K2, mask, u = _t(*_grid_problem(n, m, B=2))
    args = dict(K1_rows=K1[:n_local], K2=K2, mask_rows=mask[:n_local],
                u_rows=u[:, :n_local].contiguous(), um_full=mask * u)
    kw, err = {}, ValueError
    if bad == "dtype":
        args["um_full"] = args["um_full"].double()
        err = TypeError
    elif bad == "um_shape":
        args["um_full"] = args["um_full"][0]
    elif bad == "k1_shape":
        args["K1_rows"] = K1[:n_local + 1]
    elif bad == "device":
        args = {k: v.to("meta") for k, v in args.items()}
    elif bad == "grad":
        args["K1_rows"] = args["K1_rows"].clone().requires_grad_()
        err = NotImplementedError
    elif bad == "precision":
        kw["precision"] = "f16"
    else:
        args["u_rows"] = u[:, :n_local]          # a strided view
    with pytest.raises(err):
        lk_mvm_fused_rows(**args, noise=0.1, **kw)


# --------------------------------------------------------------------------
# the engine's operator against the reference's DistributedEngine
# --------------------------------------------------------------------------
def test_distributed_is_a_registered_backend():
    assert "distributed" in BACKENDS
    assert resolve_backend(LKGPConfig(backend="distributed"), 10) == \
        "distributed"
    assert ref_core.resolve_backend(
        ref_core.LKGPConfig(backend="distributed"), 10) == "distributed"
    engine = get_engine("distributed")
    assert isinstance(engine, DistributedEngine)
    assert get_engine("distributed") is engine
    assert engine.group is None and engine.fused == "auto"
    with pytest.raises(ValueError, match="fused"):
        DistributedEngine(fused="yes")


@pytest.mark.parametrize("fused", ["auto", True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_operator_gate_and_values_match_reference(dtype, fused):
    """The reference's gate: float32 operands take the kernel under "auto"
    and True, float64 ones the exact body under "auto" and False, and
    fused=True on float64 raises naming f32. Values: float32 to 1e-5 *
    scale (summation order), float64 to 1e-12."""
    K1, K2, mask, u = _grid_problem(30, 11, B=3, seed=2, dtype=dtype)
    if dtype == "float64" and fused is True:
        for eng in (DistributedEngine(fused=True),
                    RefDistributedEngine(fused=True)):
            with pytest.raises(ValueError, match="f32"):
                eng.operator_from_grams(*(_t(K1, K2, mask) if isinstance(
                    eng, DistributedEngine) else map(jnp.asarray,
                                                     (K1, K2, mask))), 0.1)
        return
    A = DistributedEngine(fused=fused).operator_from_grams(
        *_t(K1, K2, mask), 0.1)
    R = RefDistributedEngine(fused=fused).operator_from_grams(
        *map(jnp.asarray, (K1, K2, mask)), 0.1)
    assert isinstance(A, DistributedOperator)
    assert A.fused == R.fused == (dtype == "float32" and fused is not False)
    out = A(_t(u)[0])
    want = np.asarray(R(jnp.asarray(u)))
    assert out.dtype == torch.from_numpy(u).dtype and out.shape == u.shape
    tol = 1e-5 * np.abs(want).max() if dtype == "float32" else 1e-12
    assert np.abs(out.numpy() - want).max() <= tol
    # rank-2 input too
    assert torch.allclose(A(_t(u[0])[0]), out[0], rtol=0, atol=tol)


def test_fused_operator_is_one_kernel_call_per_sweep(monkeypatch):
    """Each sweep of the float32 operator is ONE call of the K3 wrapper for
    the whole batch (the reference maps its rank-2 body over the batch)."""
    calls = []
    real = lk_mod.lk_mvm_fused_rows

    def counting(*a, **k):
        calls.append(a[3].shape)
        return real(*a, **k)

    monkeypatch.setattr(lk_mod, "lk_mvm_fused_rows", counting)
    K1, K2, mask, u = _t(*_grid_problem(20, 7, B=5, seed=3))
    A = DistributedEngine().operator_from_grams(K1, K2, mask, 0.2)
    A(u)
    A(u[0])
    assert calls == [(5, 20, 7), (20, 7)]


def test_fused_operator_refuses_gradients():
    """K3 has no backward: a gradient through the float32 operator raises
    (naming the reference caveat) instead of returning a wrong one."""
    K1, K2, mask, u = _t(*_grid_problem(12, 5, seed=4))
    K1 = K1.requires_grad_()
    A = DistributedEngine().operator_from_grams(K1, K2, mask, 0.2)
    with pytest.raises(NotImplementedError, match="no backward"):
        A(u)
    with torch.no_grad():
        A(u)


def test_operator_rejects_rows_that_do_not_split_evenly():
    K1, K2, mask, _ = _t(*_grid_problem(9, 4, seed=5))
    with pytest.raises(ValueError, match="divisible"):
        DistributedOperator(K1, K2, mask, 0.1, fused=True, rank=1, world=2)


def test_float64_gradient_through_the_exact_body():
    """The float64 body is differentiable and agrees with autograd through
    the plain MVM (1e-12)."""
    K1, K2, mask, u = _t(*_grid_problem(10, 6, B=2, seed=6,
                                        dtype=np.float64))
    leaves = [K1.clone().requires_grad_(), K2.clone().requires_grad_(),
              torch.tensor(0.3, dtype=torch.float64, requires_grad=True)]
    A = DistributedEngine().operator_from_grams(leaves[0], leaves[1], mask,
                                                leaves[2])
    g = torch.autograd.grad((A(u) * u).sum(), leaves)
    want = torch.autograd.grad(
        (lk_mvm(leaves[0], leaves[1], mask, u, leaves[2]) * u).sum(), leaves)
    for a, b in zip(g, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------------
# serving a float32 state, fitting a float64 one, against the reference
# --------------------------------------------------------------------------
N, M, D, S = 16, 10, 5, 8


def _arrays(state) -> dict:
    out = {f"params.{k}": np.asarray(v)
           for k, v in state.params._asdict().items()}
    for name in ("X", "t", "Y", "mask"):
        out[name] = np.asarray(getattr(state, name))
    for tf_name in ("x_tf", "t_tf", "y_tf"):
        for k, v in getattr(state, tf_name)._asdict().items():
            out[f"{tf_name}.{k}"] = np.asarray(v)
    return out


def _normals(key, n_samples, n_joint, n_train, m, dtype):
    """The standard-normal draws the reference's prior_residual_draws makes
    from ``key``."""
    kz, ke = jax.random.split(key)
    return (np.asarray(jax.random.normal(kz, (n_samples, n_joint, m), dtype)),
            np.asarray(jax.random.normal(ke, (n_samples, n_train, m), dtype)))


@pytest.fixture(scope="module")
def state32():
    """A float32 reference state at the prior-mean init (polish_steps=0),
    served by both packages through their distributed engines."""
    task = sample_task(7, n=N, m=M, d=D)
    arrays = [np.asarray(a, np.float32)
              for a in (task.X, task.t, task.Y, task.mask)]
    cfg = ref_core.LKGPConfig(backend="distributed", cg_tol=1e-4,
                              cg_max_iters=2000, posterior_samples=S, seed=3)
    # Even at polish_steps=0 the reference evaluates the objective's
    # gradient, which its float32 distributed engine cannot: build the state
    # on the dense engine and serve it through the distributed one.
    ref = ref_core.fit(*arrays, dataclasses.replace(cfg, backend="dense"),
                       polish_steps=0)
    ref = dataclasses.replace(ref, config=cfg)
    assert ref.X.dtype == jnp.float32
    state = state_from_reference(_arrays(ref), dataclasses.asdict(cfg),
                                 dtype=torch.float32, device="cpu")
    return ref, state


@pytest.mark.parametrize("with_xs", [False, True], ids=["train", "new_configs"])
def test_float32_state_mean_matches_reference(state32, with_xs):
    """posterior(st32, engine=DistributedEngine()).mean: K3 (its plain
    version here) on every sweep, float32 CG to cg_tol 1e-4 on both sides;
    two such solves differ by ~cg_tol of the mean (tolerance 1e-3 * max|y|)."""
    ref, state = state32
    Xs = np.random.default_rng(0).uniform(size=(4, D)).astype(np.float32) \
        if with_xs else None
    rpost = ref_core.posterior(ref, Xs=Xs, engine=RefDistributedEngine())
    want = np.asarray(rpost.mean)
    post = posterior(state, Xs=Xs, engine=DistributedEngine(), device="cpu")
    got = post.mean
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert post._operator.fused and rpost._operator.fused
    assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(want).max()
    info = post.solve_info
    assert not bool(info.breakdown.any())
    assert int(info.iters) > 0


def test_float32_state_final_matches_reference(state32):
    """final(): one stacked solve [y | S residuals] through K3; the draws are
    the reference's default ones, handed over. Mean 1e-3 * max|mean|,
    variance 1e-2 * max|var| (the residual columns' solves stop at cg_tol
    1e-4 in float32 on both sides)."""
    ref, state = state32
    rmean, rvar = ref_core.posterior(ref, engine=RefDistributedEngine()).final()
    key = jax.random.fold_in(jax.random.PRNGKey(ref.config.seed), 1)
    normals = _normals(key, S, N, N, M, jnp.float32)
    post = posterior(state, engine=DistributedEngine(), device="cpu")
    mean, var = post.final(normals=normals)
    assert mean.dtype == var.dtype == torch.float32
    assert post.solve_count == 1 and post.solve_info.x.shape[0] == S + 1
    rmean, rvar = np.asarray(rmean), np.asarray(rvar)
    assert np.abs(mean.numpy() - rmean).max() <= 1e-3 * np.abs(rmean).max()
    assert np.abs(var.numpy() - rvar).max() <= 1e-2 * np.abs(rvar).max()


def test_float32_final_beyond_a_float32_cholesky():
    """At n = 1000 a float32 K1 + 1e-6 I is indefinite at the prior-mean
    lengthscales, and stays so rounded to float64 (the reference's float32
    final() fails from n = 300 on). The port draws a float32 state's
    Matheron prior samples from the Grams computed in float64, so its
    float32 final() works and agrees with the float64 state's on the same
    draws (the default ones: both states draw in float64 from stream
    (seed, 1)). Both solve to cg_tol 1e-3 (at 1e-4 the float32 solve is at
    its floor here). Held as chip_smoke.py holds its distributed phase: the
    mean within 10 cg_tol * max|mean|; the variance within 20 cg_tol *
    sqrt(max var) * prior std, since a solve stopped at cg_tol moves each
    Matheron sample by about cg_tol times the prior's scale."""
    n, m, d, s, tol = 1000, 8, 7, 8, 1e-3
    task = sample_task(2, n=n, m=m, d=d)
    ref = ref_core.fit(task.X, task.t, task.Y, task.mask,
                       ref_core.LKGPConfig(backend="dense"), polish_steps=0)
    arrays = _arrays(ref)
    cfg = dict(backend="iterative", cg_tol=tol, posterior_samples=s, seed=0)
    st64 = state_from_reference(arrays, cfg, device="cpu")
    st32 = state_from_reference(arrays, cfg, dtype=torch.float32,
                                device="cpu")
    K1_32 = joint_grams(st32)[0]
    for K in (K1_32, K1_32.double()):
        _, info = torch.linalg.cholesky_ex(
            K + 1e-6 * torch.eye(n, dtype=K.dtype))
        assert int(info) > 0         # the float32 Gram's factorisation fails
    mean64, var64 = posterior(st64, device="cpu").final()
    post = posterior(st32, engine=DistributedEngine(), device="cpu")
    mean32, var32 = post.final()
    assert mean32.dtype == var32.dtype == torch.float32
    assert bool(torch.isfinite(mean32).all() and torch.isfinite(var32).all())
    m64, v64 = mean64.numpy(), var64.numpy()
    prior_std = float(torch.sqrt(st64.y_tf.inverse_var(
        torch.exp(st64.params.raw_outputscale))))
    mean_gap = np.abs(mean32.numpy() - m64).max()
    var_gap = np.abs(var32.numpy() - v64).max()
    assert mean_gap <= 10 * tol * np.abs(m64).max()
    assert var_gap <= 20 * tol * np.sqrt(np.abs(v64).max()) * prior_std


@pytest.fixture(scope="module")
def fit_task():
    return sample_task(5, n=32, m=10, d=5)


FIT_CFG = dict(lbfgs_iters=3, cg_tol=1e-8, cg_max_iters=1000, slq_probes=8,
               slq_iters=15, seed=0)


def test_float64_fit_matches_reference(fit_task, monkeypatch):
    """fit(backend="distributed") in float64 runs the exact body (no kernel)
    and, with the reference's probes handed in, lands on the reference's
    fit: raw parameters to 1e-6 (measured 9e-9; both CG runs to 1e-8), the
    same iteration and evaluation counts, and the same posterior mean. The
    objective is held to 2e-4 relative: its SLQ log-det reads only the first
    slq_iters = 15 CG-Lanczos steps, and on this ill-conditioned system the
    recorded coefficients of the two packages part after ~11 steps from
    rounding alone (loss of orthogonality): 1.2e-4 here, the same gap as
    between the two packages' iterative engines, and 6e-6 between the
    reference's own iterative and distributed engines. Against the port's
    iterative engine the fit is the same to 1e-12."""
    task = fit_task
    z = np.asarray(ref_core.rademacher_probes(
        jax.random.PRNGKey(FIT_CFG["seed"]), FIT_CFG["slq_probes"],
        jnp.asarray(task.mask), jnp.float64))
    monkeypatch.setattr(state_mod, "rademacher_probes",
                        lambda gen, k, mask, dtype: probes_from_numpy(z, mask))
    calls = []
    real = lk_mod.lk_mvm_fused_rows
    monkeypatch.setattr(lk_mod, "lk_mvm_fused_rows",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = dict(backend="distributed", **FIT_CFG)
    state = fit(task.X, task.t, task.Y, task.mask, LKGPConfig(**cfg),
                device="cpu")
    ref = ref_core.fit(task.X, task.t, task.Y, task.mask,
                       ref_core.LKGPConfig(**cfg))
    assert state.backend_used == ref.backend_used == "distributed"
    assert calls == []                  # float64: never the kernel
    res, rres = state.fit_result, ref.fit_result
    np.testing.assert_allclose(res.x, rres.x, atol=1e-6, rtol=0)
    np.testing.assert_allclose(res.fun, rres.fun, rtol=2e-4)
    assert (res.n_iters, res.n_evals) == (rres.n_iters, rres.n_evals)
    it = fit(task.X, task.t, task.Y, task.mask,
             LKGPConfig(**dict(cfg, backend="iterative")), device="cpu")
    np.testing.assert_allclose(res.x, it.fit_result.x, atol=1e-12, rtol=0)
    np.testing.assert_allclose(res.fun, it.fit_result.fun, atol=1e-12, rtol=0)
    np.testing.assert_allclose(posterior(state, device="cpu").mean.numpy(),
                               np.asarray(ref_core.posterior(ref).mean),
                               atol=1e-6)


def test_fit_pins_an_injected_distributed_engine(fit_task):
    engine = DistributedEngine(fused=False)
    task = fit_task
    state = fit(task.X, task.t, task.Y, task.mask,
                LKGPConfig(backend="distributed", lbfgs_iters=1, cg_tol=1e-4,
                           slq_probes=4),
                engine=engine, device="cpu")
    assert state.engine is engine and state.backend_used == "distributed"
    assert posterior(state, device="cpu")._engine is engine


def test_float32_fit_raises_on_the_missing_k3_gradient(fit_task):
    """The reference's float32 fit on its distributed engine fails (its
    kernel has no JVP rule); the port raises a clear NotImplementedError
    instead of returning a wrong gradient."""
    task = fit_task
    arrays = [np.asarray(a, np.float32)
              for a in (task.X, task.t, task.Y, task.mask)]
    with pytest.raises(NotImplementedError, match="K3"):
        fit(*arrays, LKGPConfig(backend="distributed", lbfgs_iters=2,
                                cg_tol=1e-3, slq_probes=4), device="cpu")


# --------------------------------------------------------------------------
# the row-sharded functions against the reference's (one device)
# --------------------------------------------------------------------------
def _ref_mesh():
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def test_dist_lk_operator_and_cg_match_reference():
    """World of one: the exact operator to 1e-12 and CG (tol 1e-8) to 1e-7,
    the same iteration count."""
    K1, K2, mask, u = _grid_problem(24, 9, seed=8, dtype=np.float64)
    A = dist_lk_operator(*_t(K1, K2, mask), 0.05)
    R = ref_dist.dist_lk_operator(_ref_mesh(), *map(jnp.asarray,
                                                    (K1, K2, mask)), 0.05)
    np.testing.assert_allclose(A(_t(u[0])[0]).numpy(),
                               np.asarray(R(jnp.asarray(u[0]))), atol=1e-12)
    x, iters, rel = dist_cg_solve(A, _t(u[0])[0], tol=1e-8, max_iters=500)
    rx, riters, rrel = ref_dist.dist_cg_solve(R, jnp.asarray(u[0]), tol=1e-8,
                                              max_iters=500)
    assert iters == int(riters) and float(rel) <= 1e-8
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), atol=1e-7)


def test_dist_lk_mvm_fused_matches_reference():
    """World of one, float32: K3 (plain version here) against the
    reference's shard-mapped kernel, 1e-5 * scale."""
    K1, K2, mask, u = _grid_problem(24, 9, seed=9)
    A = dist_lk_mvm_fused(*_t(K1, K2, mask), 0.05)
    R = ref_dist.dist_lk_mvm_fused(_ref_mesh(), *map(jnp.asarray,
                                                     (K1, K2, mask)), 0.05,
                                   block_n=16, block_m=16, interpret=True)
    want = np.asarray(R(jnp.asarray(u[0])))
    got = A(_t(u[0])[0])
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_dist_mll_value_matches_reference():
    """The quadratic term -1/2 y^T K^-1 y with K1's rows built from the
    gathered X: to 1e-7 relative (CG to 1e-8 on both sides). The iteration
    counts may differ by a few: the two CG runs part from rounding alone on
    this ill-conditioned system."""
    task = sample_task(4, n=20, m=8, d=5)
    rng = np.random.default_rng(3)
    ls = np.exp(rng.standard_normal(5) * 0.2)
    args = (ls, 0.3, 1.1, 0.02)
    data = (task.X, np.linspace(0, 1, 8), task.Y * task.mask, task.mask)
    quad, iters, rel = dist_mll_value(
        *(torch.as_tensor(a) for a in args + data), cg_tol=1e-8)
    rquad, riters, rrel = ref_dist.dist_mll_value(
        _ref_mesh(), *(jnp.asarray(a) for a in args + data), cg_tol=1e-8)
    assert float(rel) <= 1e-8 and abs(iters - int(riters)) <= 5
    np.testing.assert_allclose(float(quad), float(rquad), rtol=1e-7)


# --------------------------------------------------------------------------
# two ranks over gloo against a world of one
# --------------------------------------------------------------------------
PAYLOAD = """
import sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
sys.path.insert(0, sys.argv[5])
from multirank_case import compute
np.savez(out, **compute())
dist.destroy_process_group()
"""

CASE = '''
import numpy as np
import torch

from repro_torch.core import (DistributedEngine, DistributedOperator,
                              LKGPConfig, fit, posterior)
from repro_torch.data import sample_task
from repro_torch.distributed import (dist_cg_solve, dist_lk_mvm_fused,
                                     dist_lk_operator, dist_mll_value,
                                     gather_rows, group_layout)


def compute():
    """Whatever the ranks are, the same numbers (the caller compares a 2-rank
    run with a world of one)."""
    _, rank, world = group_layout()
    rng = np.random.default_rng(0)
    n, m = 24, 7
    A0 = rng.standard_normal((n, n))
    K1 = A0 @ A0.T / n + 0.5 * np.eye(n)
    B0 = rng.standard_normal((m, m))
    K2 = B0 @ B0.T / m + 0.5 * np.eye(m)
    mask = (np.arange(m)[None] < rng.integers(1, m + 1, n)[:, None]) * 1.0
    u = rng.standard_normal((3, n, m)) * mask
    out = {}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        K1t, K2t, mt, ut = (torch.tensor(a, dtype=dt) for a in (K1, K2, mask, u))
        A = DistributedEngine().operator_from_grams(K1t, K2t, mt, 0.1)
        assert A.fused == (dt == torch.float32) and A.world == world
        out[f"op_{name}"] = A(ut).numpy()
        x = DistributedEngine().solve(A, ut, LKGPConfig(
            cg_tol=1e-4 if dt == torch.float32 else 1e-10))
        out[f"cg_{name}"] = x.numpy()
    try:
        DistributedOperator(*(torch.tensor(a) for a in (K1[:-1, :-1], K2,
                                                        mask[:-1])), 0.1,
                            fused=False, rank=rank, world=world)
        out["odd_rows_raised"] = np.array(world == 1)
    except ValueError:
        out["odd_rows_raised"] = np.array(True)
    task = sample_task(5, n=32, m=10, d=5)
    cfg = LKGPConfig(backend="distributed", lbfgs_iters=2, cg_tol=1e-8,
                     cg_max_iters=1000, slq_probes=8, slq_iters=15)
    state = fit(task.X, task.t, task.Y, task.mask, cfg, device="cpu")
    out["fit_x"] = state.fit_result.x
    out["fit_evals"] = np.array(state.fit_result.n_evals)
    out["mean"] = posterior(state, device="cpu").mean.numpy()
    # the row-sharded functions on this rank's rows, gathered for comparison
    group, _, _ = group_layout()
    n_local = n // world
    rows = slice(rank * n_local, (rank + 1) * n_local)
    t64 = lambda a: torch.tensor(np.ascontiguousarray(a))
    A = dist_lk_operator(t64(K1[rows]), t64(K2), t64(mask[rows]), 0.1)
    out["dist_op"] = gather_rows(A(t64(u[:, rows])), group, world).numpy()
    x, it, rel = dist_cg_solve(A, t64(u[0, rows]), tol=1e-10)
    out["dist_cg"] = gather_rows(x, group, world).numpy()
    out["dist_cg_iters"] = np.array(it)
    t32 = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)
    A = dist_lk_mvm_fused(t32(K1[rows]), t32(K2), t32(mask[rows]), 0.1)
    out["dist_fused"] = gather_rows(A(t32(u[:, rows])), group, world).numpy()
    nx = task.X.shape[0] // world
    xrows = slice(rank * nx, (rank + 1) * nx)
    quad, it, rel = dist_mll_value(
        torch.full((5,), 0.7, dtype=torch.float64), t64(0.3), t64(1.1),
        t64(0.02), t64(task.X[xrows]), t64(np.linspace(0, 1, 10)),
        t64((task.Y * task.mask)[xrows]), t64(task.mask[xrows]),
        cg_tol=1e-10)
    out["dist_mll"] = np.array(float(quad))
    return out
'''


def test_two_ranks_over_gloo_match_a_world_of_one(tmp_path):
    """Two ranks (gloo, file:// rendezvous in tmp_path, no ports), each in
    its own process, against the same computation in a world of one (this
    process, no group): the operator (float32 through K3's plain version,
    float64 exact) to 1e-5 / 1e-12, CG solves, the float64 fit through the
    gradient's collectives (raw parameters to 1e-8, same evaluation count),
    the posterior mean, and the row-sharded dist_* functions. The two ranks
    agree with each other exactly."""
    (tmp_path / "multirank_case.py").write_text(CASE)
    sys.path.insert(0, str(tmp_path))
    try:
        from multirank_case import compute
        want = compute()
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("multirank_case", None)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    init = tmp_path / "rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(PAYLOAD), str(r), "2",
         str(init), str(tmp_path / f"rank{r}.npz"), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for key in want:
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    g = got[0]
    assert bool(g["odd_rows_raised"])
    tol = {"op_f32": 1e-5 * np.abs(want["op_f32"]).max(), "op_f64": 1e-12,
           "cg_f32": 1e-3 * np.abs(want["cg_f32"]).max(), "cg_f64": 1e-8,
           "fit_x": 1e-8, "mean": 1e-8, "dist_op": 1e-12, "dist_cg": 1e-8,
           "dist_mll": 1e-8 * abs(float(want["dist_mll"]))}
    for key, atol in tol.items():
        np.testing.assert_allclose(g[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)
    assert int(g["fit_evals"]) == int(want["fit_evals"])
    assert abs(int(g["dist_cg_iters"]) - int(want["dist_cg_iters"])) <= 1
    np.testing.assert_allclose(g["dist_fused"], want["dist_fused"], rtol=0,
                               atol=1e-5 * np.abs(want["dist_fused"]).max())
