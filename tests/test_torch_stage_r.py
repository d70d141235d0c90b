"""The port at m > 64, NAS-Bench-201's 200 epochs: K2a's plan there (the
wide kernel: all columns of a strip in one pass, K2 and the mask streamed
in k chunks, a ragged last chunk) and its arithmetic emulated on the CPU, ``extend`` + ``final()`` at m = 200 against
the benchmark's plain float64 reference, and the tracing of K2a's plan
(attrs on ``lkgp.mvm``, counters ``lkgp.mvm.stage_r_*``), which costs
nothing while tracing is off."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perfbench.curves import sample_task
from perfbench.reference.lkgp import posterior_final
from perfbench.traffic import sh_masks
from repro.kernels import lk_mvm_two_stage as ref_lk_mvm_two_stage
from repro_torch import core, tracing
from repro_torch.core.engines import KernelOperator
from repro_torch.kernels import lk_mvm
from repro_torch.kernels.lk_mvm import (STREAM_CHUNK, STREAM_COLS,
                                        STREAM_PASS, STREAM_ROWS,
                                        lk_mvm_stage_right_plain, plan_stream)
from _tf32_emulation import mma_3xtf32

F64 = torch.float64
H100_SMS = 132
SHAPE = (3, 70, 200)      # 200 = 6 x 32 + 8: a ragged last chunk


def _problem(B, n, m, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    K1 = A @ A.T / n + 0.5 * np.eye(n)
    t = np.arange(m)
    K2 = np.exp(-np.abs(t[:, None] - t[None, :]) / 40.0) + 0.1 * np.eye(m)
    lens = rng.integers(1, m + 1, n)
    mask = (np.arange(m)[None, :] < lens[:, None]).astype(np.float64)
    u = rng.standard_normal((B, n, m)) * mask
    return tuple(torch.from_numpy(x.astype(np.float32))
                 for x in (K1, K2, mask, u))


def walk(plan):
    """K2a's loop over the plan as its kernels run it, with the bytes each
    step's loads move and the T columns each finished pass stores in both
    planes. The narrow kernel (m <= 64): one step a strip, K2 loaded once a
    block and the mask tile once for each row tile it enters. The wide
    kernel: for each strip its (pass of up to 240 columns, k chunk of 32)
    steps, each loading a chunk of U, of the mask and of K2's rows.
    Returns the (strip, pass, chunk) steps in order and the bytes."""
    B, n, m, SR = plan.B, plan.n, plan.m, plan.strip_rows
    steps, nbytes = [], 0
    for j in range(plan.blocks):
        mask_tile = None
        for q in range(j * plan.strips // plan.blocks,
                       (j + 1) * plan.strips // plan.blocks):
            tile = q // B
            rows = min(SR, n - tile * SR)
            if m <= STREAM_COLS:
                steps.append((q, 0, 0))
                if mask_tile is None:
                    nbytes += 4 * m * m                  # K2, once a block
                if mask_tile != tile:
                    nbytes += 4 * rows * m               # the mask tile
                    mask_tile = tile
                nbytes += 4 * rows * m + 8 * rows * m    # U in, T out
                continue
            for p in range(-(-m // STREAM_PASS)):
                cols = min(STREAM_PASS, m - p * STREAM_PASS)
                for c in range(-(-m // STREAM_CHUNK)):
                    steps.append((q, p, c))
                    ks = min(STREAM_CHUNK, m - c * STREAM_CHUNK)
                    nbytes += 2 * 4 * rows * ks          # U and the mask
                    nbytes += 4 * ks * cols              # K2's rows
                nbytes += 8 * rows * cols                # T, two planes
    return steps, nbytes


@pytest.mark.parametrize("shape", [SHAPE, (65, 4096, 200), (2, 130, 257),
                                   (65, 4096, 52), (3, 50, 21)], ids=str)
def test_stage_r_plan_steps_and_bytes_are_the_kernels_walk(shape):
    """The plan's strip steps and bytes are those of the kernels' own walk:
    one step a strip while m <= 64; beyond, the wide kernel's (pass, k
    chunk) steps, every pair once a strip; the byte count at least what
    the stage needs (U in once, T's two planes out), and U read once while
    m <= 240."""
    B, n, m = shape
    plan = plan_stream(B, n, m, sms=H100_SMS)
    steps, nbytes = walk(plan)
    assert len(steps) == plan.strips * plan.strip_steps
    assert len(set(steps)) == len(steps)
    assert plan.nbytes() == nbytes
    assert nbytes >= 12 * B * n * m
    if m <= STREAM_COLS:
        assert plan.strip_steps == 1
    else:
        assert plan.strip_steps == plan.passes * math.ceil(m / STREAM_CHUNK)
        assert plan.passes == (1 if m <= STREAM_PASS else 2)


def test_chunked_plan_at_nb201_width():
    """At (3, 70, 200) the launcher takes the wide kernel: one pass of all
    200 columns, 7 k chunks of 32 a strip, the last 8 rows deep; two row
    strips of each member cover the 70 rows."""
    B, n, m = SHAPE
    plan = plan_stream(B, n, m, sms=H100_SMS)
    assert (plan.passes, plan.strip_steps) == (1, 7)
    assert m - (m // STREAM_CHUNK) * STREAM_CHUNK == 8
    assert plan.strips == B * 2 == plan.blocks
    covered = np.zeros(B * n, dtype=np.int64)
    for block in range(plan.blocks):
        for r0, r1 in plan.row_ranges(block):
            assert 0 < r1 - r0 <= STREAM_ROWS
            covered[r0:r1] += 1
    assert (covered == 1).all()
    c = plan.c_struct()
    assert (c.strip_rows, c.strips, c.blocks) == (64, 6, 6)


def test_chunked_stage_r_emulation_holds_the_oracle_and_the_reference():
    """K2a's arithmetic at (3, 70, 200) as the wide kernel computes it:
    each k step's three TF32 MMAs into a zeroed fragment, added with a
    rounding add, chunk after chunk (k steps past m are not taken). It holds the float64 product within 1e-5 of max|T|, its
    bias toward zero stays below 1e-6 of |T|, and the pair with a plain
    float32 stage L holds the reference's two-stage Pallas kernel and the
    port's plain version within 1e-4 of max|out|."""
    K1, K2, mask, u = _problem(*SHAPE, seed=7)
    B, n, m = SHAPE
    um = mask * u
    T = np.stack([mma_3xtf32(um[b], K2, per_step=True) for b in range(B)])
    exact = um.double().numpy() @ K2.double().numpy()
    scale = np.abs(exact).max()
    assert np.abs(T - exact).max() <= 1e-5 * scale
    bias = np.mean((T - exact) * np.sign(exact)) / np.mean(np.abs(exact))
    assert abs(bias) < 1e-6
    plain = lk_mvm_stage_right_plain(u, mask, K2).value()
    plain_T = plain.reshape(B, m, n).transpose(1, 2).numpy()
    assert np.abs(plain_T - exact).max() <= 1e-5 * scale
    out = (mask * (K1 @ torch.from_numpy(T)) + 0.37 * um).numpy()
    ref = np.asarray(ref_lk_mvm_two_stage(
        jnp.asarray(K1.numpy()), jnp.asarray(K2.numpy()),
        jnp.asarray(mask.numpy()), jnp.asarray(u.numpy()), 0.37,
        block_n=32, block_m=64, interpret=True))
    ref_scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-4 * ref_scale
    pair = lk_mvm.lk_mvm_two_stage(K1, K2, mask, u, 0.37).numpy()
    assert np.abs(out - pair).max() <= 1e-4 * ref_scale


# --------------------------------------------------------------------------
# extend + final() at NAS-Bench-201's width, against the plain reference
# --------------------------------------------------------------------------
N, M, D = 96, 200, 6
THETA = {"raw_x_lengthscale": [0.3] * D, "raw_t_lengthscale": -1.0,
         "raw_outputscale": 0.0, "raw_noise": -2.5}


def _snapshot(X, t, Y, mask, cfg):
    params = core.LKGPParams(
        raw_x_lengthscale=torch.tensor(THETA["raw_x_lengthscale"], dtype=F64),
        raw_t_lengthscale=torch.tensor(THETA["raw_t_lengthscale"], dtype=F64),
        raw_outputscale=torch.tensor(THETA["raw_outputscale"], dtype=F64),
        raw_noise=torch.tensor(THETA["raw_noise"], dtype=F64))
    return core.LKGPState(params=params, X=X, t=t, Y=Y, mask=mask,
                          x_tf=core.XTransform.fit(X),
                          t_tf=core.TTransform.fit(t),
                          y_tf=core.YTransform.fit(Y, mask), config=cfg)


@pytest.fixture(scope="module")
def race():
    """One Successive Halving race at (96, 200, 6): seeded curves, its five
    rungs' masks, seeded standard normals of 16 draws."""
    task = sample_task(2**31 + 201, n=N, m=M, d=D)
    masks = sh_masks(task.Y_full, 1, 3)
    X, t = (torch.tensor(a, dtype=F64) for a in (task.X, task.t))
    rungs = [(torch.tensor(task.Y_full * mk, dtype=F64),
              torch.tensor(mk, dtype=F64)) for mk in masks]
    g = torch.Generator().manual_seed(33)
    normals = (torch.randn((16, N, M), generator=g, dtype=F64),
               torch.randn((16, N, M), generator=g, dtype=F64))
    return X, t, rungs, normals


def test_five_rungs_at_nb201_width(race):
    _, _, rungs, _ = race
    assert len(rungs) == 5
    assert [int(mk.sum(1).max()) for _, mk in rungs] == [1, 3, 9, 27, 200]


@pytest.mark.parametrize("rung", [1, 4])
def test_extend_final_at_m200_matches_the_plain_reference(race, rung):
    """``extend`` of a rung into the first rung's snapshot, then
    ``posterior(state).final()`` on the ``cuda`` engine (its float32 plain
    path on the CPU, residuals in float64) solved to 1e-9, against the
    benchmark's float64 reference solved to 1e-11 on the same raw inputs
    and normals: means within 1e-6 of the observed standard deviation,
    variances within 1e-5 of themselves."""
    X, t, rungs, normals = race
    cfg = core.LKGPConfig(backend="cuda", cg_tol=1e-9, posterior_samples=16,
                          jitter=1e-6, seed=3)
    snap = _snapshot(X, t, *rungs[0], cfg)
    Y, mask = rungs[rung]
    st = core.extend(snap, Y, mask)
    mean, var = core.posterior(st, device="cpu").final(normals=normals)
    ref = posterior_final(X, t, Y, mask, THETA, normals, jitter=1e-6,
                          tol=1e-11)
    scale = float(ref.transforms.y_scale)
    assert float((mean - ref.mean).abs().max()) <= 1e-6 * scale
    assert float(((var - ref.var) / ref.var).abs().max()) <= 1e-5


# --------------------------------------------------------------------------
# tracing of K2a's plan
# --------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def tracing_left_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _operator(shape, fused, seed=1):
    K1, K2, mask, u = _problem(*shape, seed=seed)
    op = KernelOperator(K1.double(), K2.double(), mask.double(),
                        torch.tensor(0.1, dtype=F64), fused=fused)
    return op, u.double()


@pytest.mark.parametrize("shape", [SHAPE, (2, 40, 52)], ids=str)
def test_two_stage_sweep_counts_its_stage_r_plan(shape):
    """A traced two-stage sweep sets ``m`` and ``r_steps`` on its
    ``lkgp.mvm`` span and adds K2a's plan to the counters: its strips'
    steps and the bytes its loads and stores move (an H100's plan off the
    card), once a sweep."""
    B, n, m = shape
    op, u = _operator(shape, fused=False)
    tracing.enable()
    for _ in range(3):
        op(u)
    tracing.disable()
    plan = plan_stream(B, n, m, sms=H100_SMS)
    mvm = [r for r in tracing.spans() if r["name"] == "lkgp.mvm"]
    assert len(mvm) == 3
    for r in mvm:
        assert r["attrs"] == {"route": "two_stage", "B": B, "m": m,
                              "r_steps": plan.strip_steps}
    assert plan.strip_steps == (7 if m == 200 else 1)
    assert tracing.snapshot()["counters"] == {
        "lkgp.mvm.stage_r_steps": 3 * plan.strips * plan.strip_steps,
        "lkgp.mvm.stage_r_bytes": 3 * plan.nbytes()}


def test_fused_sweep_sets_the_attrs_and_counts_no_stage_r():
    op, u = _operator(SHAPE, fused=True)
    tracing.enable()
    op(u)
    tracing.disable()
    mvm, = [r for r in tracing.spans() if r["name"] == "lkgp.mvm"]
    assert mvm["attrs"] == {"route": "fused", "B": 3, "m": 200,
                            "r_steps": 7}
    assert tracing.snapshot()["counters"] == {}


def test_stage_r_tracing_costs_nothing_while_off(monkeypatch):
    """Tracing off: no plan is made for the counters (a planner that raises
    is never reached), nothing is recorded, and the sweep's bits are those
    of a traced sweep."""
    op, u = _operator(SHAPE, fused=False)
    tracing.enable()
    traced = op(u)
    tracing.disable()
    tracing.reset()

    def refuse(*args, **kwargs):
        raise AssertionError("planned while tracing is off")

    monkeypatch.setattr(lk_mvm, "stream_plan", refuse)
    out = op(u)
    assert torch.equal(out, traced)
    assert tracing.spans() == []
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("rung, L, steps", [(2, 9, 1), (4, M, 7)])
def test_a_request_counts_stage_r_once_a_sweep(race, monkeypatch, rung, L,
                                               steps):
    """``extend`` + ``final()`` at m = 200 with the tuner's route set to
    the two-stage pair: the counters hold the plan once for each of the
    solve's sweeps, which the CG loop counts as ``lkgp.cg.cols_swept``. The
    solve runs on the observed prefix, L columns: at rung 2 (L = 9) K2a's
    narrow kernel, one ring step a strip; at the last rung (L = m) the wide
    one, seven."""
    from repro_torch.kernels import autotune
    monkeypatch.setattr(autotune, "autotune_route",
                        lambda *a, **k: "two_stage")
    X, t, rungs, normals = race
    cfg = core.LKGPConfig(backend="cuda", posterior_samples=16, seed=3)
    snap = _snapshot(X, t, *rungs[0], cfg)
    tracing.enable()
    st = core.extend(snap, *rungs[rung])
    post = core.posterior(st, device="cpu")
    post.final(normals=normals)
    tracing.disable()
    c = tracing.snapshot()["counters"]
    sweeps = c["lkgp.cg.cols_swept"] // 17
    assert sweeps == int(post.solve_info.iters) > 0
    plan = plan_stream(17, N, L, sms=H100_SMS)
    assert c["lkgp.mvm.stage_r_steps"] == sweeps * plan.strips * steps
    assert c["lkgp.mvm.stage_r_bytes"] == sweeps * plan.nbytes()
