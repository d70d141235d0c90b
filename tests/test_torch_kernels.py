"""PyTorch port, kernel layer: the fused MVM's plain version against the
reference's Pallas kernel (interpret mode on CPU), the tensor oracles against
the reference's, and the dispatch rules of ``lk_mvm_op``.

Inputs are made with numpy from a seed and handed to both frameworks.
"""
import ctypes
import functools

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp_kernels as ref_gk
from repro.core import mvm as ref_mvm
from repro.kernels import lk_mvm_fused as ref_lk_mvm_fused
from repro.kernels import lk_mvm_ref as ref_lk_mvm_ref
from repro_torch.core import gp_kernels as gk
from repro_torch.core import mvm
from repro.kernels import lk_mvm_two_stage as ref_lk_mvm_two_stage
from repro_torch.kernels import (lk_mvm_fused, mvm_launch,
                                 lk_mvm_fused_plain, lk_mvm_op, lk_mvm_ref,
                                 lk_mvm_stage_left, lk_mvm_stage_left_plain,
                                 lk_mvm_stage_right, lk_mvm_stage_right_plain,
                                 lk_mvm_two_stage, lk_mvm_two_stage_plain,
                                 rbf_gram_op, rbf_gram_ref)
from repro_torch.kernels import _build
from repro_torch.kernels.lk_mvm import TF32Planes, tf32_planes, tf32_split
from _tf32_emulation import mma_3xtf32, tc_matmul, tf32

# (B, n, m): n < 8, non-multiples of 8, B > 1, m spanning several blocks.
AWKWARD_SHAPES = [(1, 5, 3), (1, 7, 19), (3, 32, 16), (2, 30, 21),
                  (4, 16, 24), (2, 13, 32)]


def _problem(B, n, m, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    K1 = A @ A.T / n + 0.5 * np.eye(n)
    Bm = rng.standard_normal((m, m))
    K2 = Bm @ Bm.T / m + 0.5 * np.eye(m)
    lens = rng.integers(1, m + 1, n)
    mask = (np.arange(m)[None, :] < lens[:, None]).astype(np.float64)
    u = rng.standard_normal((B, n, m)) * mask
    return tuple(x.astype(dtype) for x in (K1, K2, mask, u))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# --------------------------------------------------------------------------
# lk_mvm_fused_plain  vs  the reference's Pallas kernel
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", AWKWARD_SHAPES)
@pytest.mark.parametrize("precision,rel_tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_fused_plain_matches_reference_kernel(shape, precision, rel_tol):
    """f32: only the order of summation differs (<= 1e-5 * scale). bf16: the
    reference rounds f32 -> bf16 at the same points, but sums in another
    order before rounding T, so single bf16 ulps flip (<= 2e-2 * scale)."""
    K1, K2, mask, u = _problem(*shape)
    ref = np.asarray(ref_lk_mvm_fused(
        jnp.asarray(K1), jnp.asarray(K2), jnp.asarray(mask), jnp.asarray(u),
        0.37, block_n=16, block_m=16, precision=precision, interpret=True))
    out = lk_mvm_fused_plain(*_t(K1, K2, mask, u), 0.37, precision=precision)
    assert out.dtype == torch.float32 and out.shape == u.shape
    scale = np.abs(ref).max()
    assert np.abs(out.numpy() - ref).max() <= rel_tol * scale


@pytest.mark.parametrize("shape", [(1, 7, 19), (3, 12, 10)])
def test_fused_float64_u_matches_reference_kernel(shape):
    """A float64 u is computed in float32 and returned as float64, as the
    reference kernel does; <= 1e-5 * scale (summation order)."""
    K1, K2, mask, u = _problem(*shape)
    u64 = u.astype(np.float64)
    ref = ref_lk_mvm_fused(jnp.asarray(K1), jnp.asarray(K2), jnp.asarray(mask),
                           jnp.asarray(u64), 0.1, block_n=16, block_m=16,
                           interpret=True)
    assert ref.dtype == jnp.float64
    out = lk_mvm_fused(*_t(K1, K2, mask, u64), 0.1)   # CPU tensor -> plain
    assert out.dtype == torch.float64
    ref = np.asarray(ref)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_fused_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    K1, K2, mask, u = _t(*_problem(3, 9, 11))
    before = lk_mvm_fused.launches
    for precision in ("f32", "bf16"):
        a = lk_mvm_fused(K1, K2, mask, u, 0.2, precision=precision)
        b = lk_mvm_fused_plain(K1, K2, mask, u, 0.2, precision=precision)
        assert torch.equal(a, b)
    # the counter moves only where the CUDA kernel is launched
    assert lk_mvm_fused.launches == before


def test_fused_leading_batch_dims_and_tensor_noise():
    K1, K2, mask, u = _t(*_problem(6, 16, 12))
    u4 = u.reshape(2, 3, 16, 12)
    out = lk_mvm_fused(K1, K2, mask, u4, torch.tensor(0.1, dtype=torch.float64))
    assert out.shape == (2, 3, 16, 12)
    ref = lk_mvm_ref(K1.double(), K2.double(), mask.double(), u4.double(), 0.1)
    torch.testing.assert_close(out.double(), ref, rtol=2e-5, atol=2e-5)


def test_bf16_mode_actually_rounds():
    K1, K2, mask, u = _t(*_problem(2, 24, 20))
    f32 = lk_mvm_fused_plain(K1, K2, mask, u, 0.1)
    bf16 = lk_mvm_fused_plain(K1, K2, mask, u, 0.1, precision="bf16")
    gap = (f32 - bf16).abs().max() / f32.abs().max()
    assert 1e-5 < gap < 2e-2


@pytest.mark.parametrize("case", ["f64_factor", "bool_mask", "bad_K1", "bad_u",
                                  "strided_u", "strided_K2", "int_u",
                                  "precision", "requires_grad", "empty"])
def test_fused_wrapper_rejects_what_the_kernel_does_not_take(case):
    K1, K2, mask, u = _t(*_problem(2, 6, 5))
    kw = {}
    err = ValueError
    if case == "f64_factor":
        K1, err = K1.double(), TypeError
    elif case == "bool_mask":
        mask, err = mask.bool(), TypeError
    elif case == "bad_K1":
        K1 = K1[:5, :5]
    elif case == "bad_u":
        u = u[:, :, :4]
    elif case == "strided_u":
        u = torch.cat([u, u], dim=-1)[..., ::2]
    elif case == "strided_K2":
        K2 = torch.stack([K2, K2], -1)[..., 0]
    elif case == "int_u":
        u, err = u.to(torch.int32), TypeError
    elif case == "precision":
        kw["precision"] = "fp8"
    elif case == "requires_grad":
        K1, err = K1.clone().requires_grad_(), NotImplementedError
    elif case == "empty":
        u = u[:0]
    with pytest.raises(err):
        lk_mvm_fused(K1, K2, mask, u, 0.1, **kw)


# --------------------------------------------------------------------------
# the two-stage kernels' plain versions vs the reference's two-stage kernel
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", AWKWARD_SHAPES)
def test_two_stage_plain_matches_reference_kernel_and_oracle(shape):
    """lk_mvm_two_stage_plain (float32 T, float32 products and epilogue)
    against the reference's Pallas two-stage kernel in interpret mode
    (float32 too) to float32 rounding, 1e-5 of max|out|; against the
    float64 oracle to the same. The stages, which carry T and K1 as their
    TF32 halves, compose to it within float32 rounding (1e-6 of max|out|)."""
    K1, K2, mask, u = _problem(*shape)
    ref = np.asarray(ref_lk_mvm_two_stage(
        jnp.asarray(K1), jnp.asarray(K2), jnp.asarray(mask), jnp.asarray(u),
        0.37, block_n=8, block_m=8, interpret=True))
    tK1, tK2, tmask, tu = _t(K1, K2, mask, u)
    out = lk_mvm_two_stage_plain(tK1, tK2, tmask, tu, 0.37)
    assert out.dtype == torch.float32 and out.shape == tu.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * scale, rtol=0)
    exact = lk_mvm_ref(*(x.double() for x in (tK1, tK2, tmask, tu)), 0.37)
    assert float((out.double() - exact).abs().max()) <= 1e-5 * scale
    T = lk_mvm_stage_right_plain(tu, tmask, tK2)
    both = lk_mvm_stage_left_plain(tK1, T, tmask, tu, 0.37)
    assert float((both - out).abs().max()) <= 1e-6 * scale


def test_two_stage_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    K1, K2, mask, u = _t(*_problem(3, 9, 11))
    counts = (lk_mvm_stage_right.launches, lk_mvm_stage_left.launches)
    T = lk_mvm_stage_right(u, mask, K2)
    plain = lk_mvm_stage_right_plain(u, mask, K2)
    assert isinstance(T, TF32Planes) and (T.hi.shape[0], T.cols) == (3 * 11, 9)
    assert torch.equal(T.hi, plain.hi) and torch.equal(T.lo, plain.lo)
    out = lk_mvm_stage_left(K1, T, mask, u, torch.tensor(0.2))
    assert torch.equal(out, lk_mvm_stage_left_plain(K1, T, mask, u, 0.2))
    # float64 u with leading batch dims: float32 inside, float64 out
    u64 = u.double().reshape(3, 1, 9, 11)
    both = lk_mvm_two_stage(K1, K2, mask, u64, 0.2)
    assert both.dtype == torch.float64 and both.shape == u64.shape
    assert torch.equal(both, lk_mvm_two_stage_plain(K1, K2, mask, u64, 0.2))
    # the stages carry K1 and T as their TF32 halves: float32 rounding apart
    gap = (both.reshape(3, 9, 11).float() - out).abs().max()
    assert float(gap) <= 1e-6 * float(out.abs().max())
    assert (lk_mvm_stage_right.launches, lk_mvm_stage_left.launches) == counts


@pytest.mark.parametrize("case", ["f64_factor", "bad_K2", "strided_u",
                                  "bad_T", "requires_grad", "empty"])
def test_two_stage_wrappers_reject_what_the_kernels_do_not_take(case):
    K1, K2, mask, u = _t(*_problem(2, 6, 5))
    T = lk_mvm_stage_right_plain(u, mask, K2)
    err = ValueError
    if case == "f64_factor":
        K2, err = K2.double(), TypeError
    elif case == "bad_K2":
        K2 = K2[:4, :4]
    elif case == "strided_u":
        u = torch.cat([u, u], dim=-1)[..., ::2]
    elif case == "bad_T":
        T = TF32Planes(T.hi[:1], T.lo[:1], T.cols)
    elif case == "requires_grad":
        K2, err = K2.clone().requires_grad_(), NotImplementedError
    elif case == "empty":
        u = u[:0]
    with pytest.raises(err):
        lk_mvm_stage_right(u, mask, K2)
        lk_mvm_stage_left(K1, T, mask, u, 0.1)


# --------------------------------------------------------------------------
# tensor oracles vs the reference at float64
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", AWKWARD_SHAPES)
def test_lk_mvm_matches_reference_f64(shape):
    K1, K2, mask, u = _problem(*shape, dtype=np.float64)
    ref = np.asarray(ref_mvm.lk_mvm(*map(jnp.asarray, (K1, K2, mask, u)), 0.37))
    for fn in (mvm.lk_mvm, lk_mvm_ref):
        out = fn(*_t(K1, K2, mask, u), 0.37)
        assert out.dtype == torch.float64
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    ref2 = np.asarray(ref_lk_mvm_ref(*map(jnp.asarray, (K1, K2, mask, u)), 0.37))
    np.testing.assert_allclose(ref, ref2, rtol=0, atol=0)
    op = mvm.lk_operator(*_t(K1, K2, mask), 0.37)
    np.testing.assert_allclose(op(_t(u)[0]).numpy(), ref, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("n,p,d", [(5, 5, 3), (13, 7, 4), (30, 30, 7)])
def test_rbf_ard_and_distances_match_reference_f64(n, p, d):
    rng = np.random.default_rng(n + p)
    x1, x2 = rng.uniform(size=(n, d)), rng.uniform(size=(p, d))
    ls = np.exp(rng.standard_normal(d) * 0.3)
    ref = np.asarray(ref_gk.rbf_ard(jnp.asarray(x1), jnp.asarray(x2),
                                    jnp.asarray(ls), 1.7))
    tx1, tx2, tls = _t(x1, x2, ls)
    for fn in (gk.rbf_ard, rbf_gram_ref):
        np.testing.assert_allclose(fn(tx1, tx2, tls, 1.7).numpy(), ref,
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        gk.sq_dist(tx1, tx2).numpy(),
        np.asarray(ref_gk.sq_dist(jnp.asarray(x1), jnp.asarray(x2))),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        rbf_gram_op(tx1, tx2, tls, 1.7, device="cpu").numpy(), ref,
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["matern12", "matern32", "matern52"])
def test_matern_kernels_match_reference_f64(name):
    rng = np.random.default_rng(3)
    t1, t2 = np.sort(rng.uniform(size=11)), np.sort(rng.uniform(size=7))
    ref = np.asarray(ref_gk.KERNELS_1D[name](jnp.asarray(t1), jnp.asarray(t2),
                                             0.3, 1.4))
    out = gk.KERNELS_1D[name](*_t(t1, t2),
                              torch.tensor(0.3, dtype=torch.float64), 1.4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        gk.abs_dist(*_t(t1, t2)).numpy(),
        np.asarray(ref_gk.abs_dist(jnp.asarray(t1), jnp.asarray(t2))))


def test_kron_and_packing_match_reference_f64():
    K1, K2, mask, u = _problem(2, 6, 5, dtype=np.float64)
    jK1, jK2, ju = map(jnp.asarray, (K1, K2, u))
    tK1, tK2, tmask, tu = _t(K1, K2, mask, u)
    np.testing.assert_allclose(mvm.kron_dense(tK1, tK2).numpy(),
                               np.asarray(ref_mvm.kron_dense(jK1, jK2)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        mvm.joint_cov_packed(tK1, tK2, tmask).numpy(),
        np.asarray(ref_mvm.joint_cov_packed(jK1, jK2, mask)),
        rtol=1e-12, atol=1e-12)
    packed = mvm.grid_to_packed(tu, tmask)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(ref_mvm.grid_to_packed(ju, mask)))
    np.testing.assert_array_equal(
        mvm.packed_to_grid(packed, tmask).numpy(),
        np.asarray(ref_mvm.packed_to_grid(jnp.asarray(packed.numpy()), mask)))
    # the packed operator is the dense matrix the grid MVM applies
    Kp = mvm.joint_cov_packed(tK1, tK2, tmask)
    got = mvm.grid_to_packed(mvm.lk_mvm(tK1, tK2, tmask, tu, 0.0), tmask)
    torch.testing.assert_close(got, packed @ Kp.T, rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------------------
# dispatch: by device, and raising instead of falling back
# --------------------------------------------------------------------------
def test_lk_mvm_op_cpu_routes():
    K1, K2, mask, u = _t(*_problem(2, 9, 7, dtype=np.float64))
    # CPU tensors, no force: the float64 oracle
    out = lk_mvm_op(K1, K2, mask, u, 0.1, device="cpu")
    assert out.dtype == torch.float64
    assert torch.equal(out, lk_mvm_ref(K1, K2, mask, u, 0.1))
    # force_kernel: the kernel wrapper, i.e. float32 factors are demanded ...
    with pytest.raises(TypeError):
        lk_mvm_op(K1, K2, mask, u, 0.1, force_kernel=True, device="cpu")
    # ... and a float64 u comes back float64 after a float32 computation
    f = lambda x: x.float()
    forced = lk_mvm_op(f(K1), f(K2), f(mask), u, 0.1, force_kernel=True,
                       device="cpu")
    assert forced.dtype == torch.float64
    assert torch.equal(forced,
                       lk_mvm_fused_plain(f(K1), f(K2), f(mask), u, 0.1))
    assert 0 < (forced - out).abs().max() < 1e-4


@pytest.mark.parametrize("entry", ["op", "dispatcher"])
def test_two_stage_slot_raises_not_falls_back(entry, monkeypatch):
    """fused=False (and the launch of the route "two_stage") reaches the
    two-stage kernels (never the fused kernel), and what the two-stage
    kernels do not compute (bf16 operands) raises instead of running in
    float32."""
    K1, K2, mask, u = _t(*_problem(2, 6, 5))
    import repro_torch.kernels.lk_mvm as lk

    def call(**kw):
        if entry == "op":
            return lk_mvm_op(K1, K2, mask, u, 0.1, force_kernel=True,
                             fused=False, device="cpu", **kw)
        return mvm_launch("two_stage", K1, K2, mask, 0.1, u.shape[0],
                          **kw)(u)

    monkeypatch.setattr(lk, "lk_mvm_fused", None)   # must not be reached
    out = call()
    assert torch.equal(out, lk_mvm_two_stage_plain(K1, K2, mask, u, 0.1))
    with pytest.raises(NotImplementedError, match="bf16"):
        call(precision="bf16")


def test_rbf_gram_kernel_slot_raises_not_falls_back(monkeypatch):
    """force_kernel reaches the K4 wrapper (its plain version on CPU
    tensors: float32 compute, x1's dtype out), never the oracle; tensors on
    a device that is neither CUDA nor the CPU raise instead of falling back."""
    import repro_torch.kernels.ops as ops_mod
    from repro_torch.kernels import rbf_gram_plain

    x = torch.rand(5, 3, dtype=torch.float64)
    ls = torch.ones(3, dtype=torch.float64)
    monkeypatch.setattr(ops_mod, "rbf_gram_ref", None)   # must not be reached
    out = rbf_gram_op(x, x, ls, force_kernel=True, device="cpu")
    assert out.dtype == torch.float64
    assert torch.equal(out, rbf_gram_plain(x, x, ls))
    meta = x.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rbf_gram_op(meta, meta, ls.to("meta"), force_kernel=True,
                    device="meta")


def test_ops_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only raise")
    K1, K2, mask, u = _t(*_problem(1, 6, 5))
    with pytest.raises(RuntimeError, match="CUDA"):
        lk_mvm_op(K1, K2, mask, u, 0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        rbf_gram_op(u[0], u[0], torch.ones(5))


def test_ops_reject_tensors_on_another_device():
    K1, K2, mask, u = _t(*_problem(1, 6, 5))
    with pytest.raises(ValueError, match="lives on"):
        lk_mvm_op(K1, K2, mask, u.to("meta"), 0.1, device="cpu")


def test_build_failure_is_raised_not_swallowed(tmp_path, monkeypatch):
    """Without a CUDA compiler the kernel build raises; nothing is built at import."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    try:
        _build._nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("a CUDA toolkit is installed; this checks the raise without")
    monkeypatch.setattr(_build, "_build_dir", lambda: tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library("lk_mvm_fused")
    assert not list(tmp_path.iterdir())


# --------------------------------------------------------------------------
# the launch seam: one launch per operator and batch, one table of libraries
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B", [1, 3, 65])
@pytest.mark.parametrize("route", ["fused", "two_stage"])
def test_operator_sweep_is_the_checked_wrapper_bit_for_bit(route, B):
    """A float64 sweep of the cuda engine's operator, through its cached
    launch, gives the bits of the public wrapper of its route called on the
    operator's float32 operands: the same casts, plans and version."""
    from repro_torch.core.engines import KernelOperator
    K1, K2, mask, u = _t(*_problem(B, 13, 7, seed=B, dtype=np.float64))
    A = KernelOperator(K1, K2, mask, torch.tensor(0.3, dtype=torch.float64),
                       fused=route == "fused")
    wrapper = lk_mvm_fused if route == "fused" else lk_mvm_two_stage
    for v in (u, 0.5 * u):             # the launch's first sweep and a later
        got = A(v)
        assert got.dtype == torch.float64 and A.launch(B).route == route
        assert torch.equal(got, wrapper(*A.fast[:3], v, A.fast[3]))


@pytest.mark.parametrize("route", ["fused", "two_stage"])
def test_operator_checks_and_plans_once_per_batch(route, monkeypatch):
    """Repeated sweeps of one batch size run the operand checker and the
    route's planners once, at the first sweep; a new batch size builds a
    new launch, and a batch size seen before reuses its own."""
    import repro_torch.kernels.lk_mvm as lk
    from repro_torch.core.engines import KernelOperator
    calls = {}
    for name in ("_check_grid", "plan_launch", "plan_stream",
                 "plan_stage_left"):
        real = getattr(lk, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(lk, name, counted)
    K1, K2, mask, u = _t(*_problem(3, 11, 6, dtype=np.float64))
    A = KernelOperator(K1, K2, mask, 0.2, fused=route == "fused")
    planner = "plan_launch" if route == "fused" else "plan_stage_left"
    once = {"_check_grid": 1, "plan_stream": 1, planner: 1}
    for _ in range(4):
        A(u)
    assert calls == once
    first = A.launch(3)
    A(u[:2])
    assert calls == {k: 2 * v for k, v in once.items()}
    assert A.launch(2) is not first and A.launch(3) is first
    A(u)
    assert calls == {k: 2 * v for k, v in once.items()}


_PTR = ctypes.POINTER
_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "long long": ctypes.c_longlong, "int": ctypes.c_int,
            "int*": _PTR(ctypes.c_int), "const lk_tc::Plan*": _PTR(_build.CPlan),
            "const lk_two_stage::StreamPlan*": _PTR(_build.CStreamPlan),
            "const lk_wg::Plan*": _PTR(_build.CLeftPlan),
            "const rbf::GramPlan*": _PTR(_build.CGramPlan)}


@pytest.mark.parametrize("library,entry", [
    (lib, entry) for lib, entries in _build.LIBRARIES.items()
    for entry in entries])
def test_library_table_matches_the_c_sources(library, entry):
    """Each entry point of the table of kernel libraries is exported by its
    source with the argument types the table declares, in order."""
    import re
    src = "kernel_attr.cuh" if entry == "repro_device_limits" \
        else f"{library}.cu"
    text = (_build.CSRC / src).read_text()
    found = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert found, f"{entry} is not exported by {src}"
    params = [" ".join(p.split()[:-1]).replace(" *", "*")
              for p in found.group(1).split(",")]
    assert _build.LIBRARIES[library][entry] == [_C_TYPES[p] for p in params]


# --------------------------------------------------------------------------
# the tensor-core body of K1 / K3: its library's digest, its launch planner
# and the arithmetic of its f32 mode (3xTF32), emulated on the CPU
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["lk_mvm_fused", "lk_mvm_fused_rows",
                                  "lk_mvm_two_stage", "lk_mvm_stage_left"])
def test_library_digest_covers_the_shared_header(name, tmp_path):
    """An edited header under csrc/ gives another library name, so a stale
    build is never loaded; the digest is otherwise stable."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = _build._digest(name, csrc)
    assert before == _build._digest(name, csrc)
    assert before == _build._digest(name)    # the copy hashes as the original
    header = csrc / "lk_mvm_tc.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._digest(name, csrc) != before
    (csrc / f"{name}.cu").write_text((csrc / f"{name}.cu").read_text() + " ")
    assert len({before, _build._digest(name, csrc)}) == 2


# The kernel rows of chip_smoke.py as (B, n_local, n, m): K1's shapes
# (n_local = n) and K3's, then row shards of 2 and 4 ranks at small B.
PLAN_SHAPES = [(1, 5, 5, 3), (3, 50, 50, 21), (2, 130, 130, 257),
               (1, 2000, 2000, 52), (16, 2000, 2000, 52),
               (17, 2000, 2000, 52), (65, 2000, 2000, 52),
               (1, 8192, 8192, 64), (16, 8192, 8192, 64),
               (65, 8192, 8192, 64),
               (3, 65, 130, 70), (2, 50, 100, 21), (65, 2048, 8192, 64),
               (1, 2048, 8192, 64), (17, 4096, 8192, 64),
               (1, 1000, 2000, 52), (17, 500, 2000, 52)]


# The planners take the card's SM count; an H100 SXM has 132.
H100_SMS = 132


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_split_planner_partitions_k_in_whole_tiles(shape):
    from repro_torch.kernels.lk_mvm import (TC_K, TC_MAX_SPLITS, TC_ROWS,
                                            plan_launch)
    B, n_local, n, m = shape
    plan = plan_launch(B, n_local, n, m, sms=H100_SMS)
    assert plan.row_tiles == -(-n_local // TC_ROWS)
    assert 1 <= plan.splits <= TC_MAX_SPLITS == 8
    assert plan.splits <= plan.k_tiles == -(-n // TC_K)
    ranges = plan.k_ranges()
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (k0, k1), (k2, _) in zip(ranges, ranges[1:]):
        assert k1 == k2
    for k0, k1 in ranges:
        assert k0 % TC_K == 0 and k1 > k0
        assert k1 % TC_K == 0 or k1 == n
    if plan.tiles >= 2 * H100_SMS:
        assert plan.splits == 1
    else:
        assert plan.splits == min(8, plan.k_tiles,
                                  -(-2 * H100_SMS // plan.tiles))
    # every flattened (b, j) column and every output row has one tile
    assert plan.panels * plan.batch_per_panel * plan.col_tile >= B * m
    assert plan.blocks == plan.tiles * plan.splits


# K2a's grid rule at the (B, n, m) of chip_smoke.py's KERNEL_SHAPES.
STREAM_SHAPES = [(1, 5, 3), (3, 50, 21), (2, 130, 257), (1, 2000, 52),
                 (16, 2000, 52), (17, 2000, 52), (65, 2000, 52),
                 (1, 8192, 64), (16, 8192, 64), (65, 8192, 64),
                 (65, 4096, 200)]


@pytest.mark.parametrize("shape", STREAM_SHAPES, ids=str)
def test_stream_planner_covers_every_row_once(shape):
    """plan_stream's strips, as the blocks take them, cover the B n rows of
    (mask * U) @ K2 exactly once; each strip lies inside one batch member;
    the persistent blocks are at most two per SM of an H100, and each
    block's strips share one or two row tiles (the mask tile it holds)."""
    from repro_torch.kernels.lk_mvm import STREAM_ROWS, plan_stream
    B, n, m = shape
    plan = plan_stream(B, n, m, sms=H100_SMS)
    assert plan.strip_rows == STREAM_ROWS == 64
    assert plan.strips == B * -(-n // STREAM_ROWS)
    assert plan.blocks == min(plan.strips, 2 * H100_SMS)
    covered = np.zeros(B * n, dtype=np.int64)
    for block in range(plan.blocks):
        ranges = plan.row_ranges(block)
        assert ranges, f"block {block} has no strip"
        for r0, r1 in ranges:
            assert 0 < r1 - r0 <= STREAM_ROWS
            assert r0 // n == (r1 - 1) // n       # one batch member
            covered[r0:r1] += 1
        tiles = {(r0 % n) // STREAM_ROWS for r0, _ in ranges}
        assert len(tiles) <= 2 or len(ranges) > B
    assert (covered == 1).all()
    c = plan.c_struct()
    assert (c.strip_rows, c.strips, c.blocks) == (
        plan.strip_rows, plan.strips, plan.blocks)


def test_split_planner_fills_the_card_at_batch_one():
    from repro_torch.kernels.lk_mvm import plan_launch, plan_stage_left
    plan = functools.partial(plan_launch, sms=H100_SMS)
    one = plan(1, 8192, 8192, 64)
    assert one.splits > 1 and one.blocks >= 132
    assert plan(65, 8192, 8192, 64).splits == 1
    # K2b's plan: at B = 1 one 64-column tile (the batch's columns, not 128
    # of which 64 are empty) and k split into as many ranges as keep the
    # units within one wave that fills the card past half; the usual
    # 128-column tile once the batch's columns pass 64
    left = functools.partial(plan_stage_left, sms=H100_SMS)
    narrow = left(1, 8192, 64)
    assert narrow.col_tile == 64 and narrow.splits == 2
    assert narrow.units == narrow.blocks == 128
    assert narrow.units + narrow.tiles > 132
    assert left(2, 8192, 64).col_tile == 128
    assert left(4, 50, 16).col_tile == 64
    assert left(65, 8192, 64).splits == 1


# What the planners gave before they read the card's SM count (an H100's
# 132 was built in): (B, n, m) -> plan_launch's (tiles, splits) and
# plan_stream's blocks.
PLANS_AT_132 = {(1, 2000, 52): ((8, 1), 8, 32),
                (16, 2000, 52): ((8, 8), 5, 264),
                (17, 2000, 52): ((8, 9), 4, 264),
                (1, 8192, 64): ((32, 1), 8, 128),
                (65, 8192, 64): ((32, 33), 1, 264)}


@pytest.mark.parametrize("sms", [132, 114])
def test_planners_follow_the_device_sm_count(sms):
    """plan_launch and plan_stream size their grids by the SM count they are
    given (the wrappers pass the device's): at 132 exactly the plans of the
    built-in H100 count, at 114 (an H100 PCIe) a different split count where
    the tiles are few, and K2a's persistent blocks two per SM (its budget at
    the H100's limits)."""
    from repro_torch.kernels.lk_mvm import plan_launch, plan_stream
    splits = {}
    for (B, n, m), ((rows, panels), s132, blocks132) in PLANS_AT_132.items():
        plan = plan_launch(B, n, n, m, sms=sms)
        assert (plan.row_tiles, plan.panels) == (rows, panels)
        fill = 2 * sms
        assert plan.splits == (1 if plan.tiles >= fill else min(
            8, plan.k_tiles, -(-fill // plan.tiles)))
        splits[(B, n, m)] = plan.splits
        stream = plan_stream(B, n, m, sms=sms)
        assert stream.blocks == min(stream.strips, 2 * sms)
        if sms == 132:
            assert (plan.splits, stream.blocks) == (s132, blocks132)
    if sms == 114:
        assert splits[(16, 2000, 52)] == 4 != PLANS_AT_132[
            (16, 2000, 52)][1]


# K2b's planner at the shapes above, the cell's (65, 4096, 52) and a B = 1
# serve at n = 8192.
LEFT_PLAN_SHAPES = [*PLANS_AT_132, (65, 4096, 52), (1, 8192, 64)]


@pytest.mark.parametrize("shape", LEFT_PLAN_SHAPES, ids=str)
def test_stage_left_schedule_covers_every_output_tile_once(shape):
    """plan_stage_left's persistent schedule, as the kernel walks it, gives
    every (row tile, column tile) output tile each of its splits exactly
    once; the splits' k ranges partition n in whole tiles; the tiles cover
    the n rows and the B m flattened columns; one block an SM at most."""
    from repro_torch.kernels.lk_mvm import (LEFT_K, LEFT_MAX_SPLITS,
                                            LEFT_ROWS, plan_stage_left)
    B, n, m = shape
    plan = plan_stage_left(B, n, m, sms=H100_SMS)
    assert plan.row_tiles == -(-n // LEFT_ROWS)
    assert plan.col_tiles * plan.col_tile >= B * m > (plan.col_tiles - 1) \
        * plan.col_tile
    assert 1 <= plan.splits <= min(LEFT_MAX_SPLITS, plan.k_tiles)
    assert plan.k_tiles == -(-n // LEFT_K)
    assert 1 <= plan.blocks == min(plan.units, H100_SMS)
    seen = {}
    for block in range(plan.blocks):
        for unit in plan.schedule(block):
            seen[unit] = seen.get(unit, 0) + 1
    want = {(r, c, s) for r in range(plan.row_tiles)
            for c in range(plan.col_tiles) for s in range(plan.splits)}
    assert set(seen) == want and set(seen.values()) == {1}
    ranges = plan.k_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (k0, k1), (k2, _) in zip(ranges, ranges[1:]):
        assert k1 == k2
    for k0, k1 in ranges:
        assert k0 % LEFT_K == 0 and k1 > k0 and (k1 % LEFT_K == 0 or k1 == n)
    c = plan.c_struct()
    assert (c.row_tiles, c.col_tiles, c.col_tile, c.k_tiles, c.splits,
            c.blocks) == (plan.row_tiles, plan.col_tiles, plan.col_tile,
                          plan.k_tiles, plan.splits, plan.blocks)


def test_stage_left_pads_under_three_percent_of_the_cells_columns():
    """At the benchmark cell's (65, 4096, 52) the flattened (b, j) columns
    fill 27 tiles of 128 but 2.2 % of the slots; the parent's per-member
    64-column panels (two a panel, 33 panels of 128) padded 20 %."""
    from repro_torch.kernels.lk_mvm import plan_launch, plan_stage_left
    plan = plan_stage_left(65, 4096, 52, sms=H100_SMS)
    assert (plan.col_tiles, plan.col_tile, plan.splits) == (27, 128, 1)
    assert plan.padded_share < 0.03
    panels = plan_launch(65, 4096, 4096, 52, sms=H100_SMS).panels
    assert 1 - 65 * 52 / (panels * 128) > 0.19


def test_tf32_split_gives_exact_halves_that_reconstruct_the_value():
    """K1's split: hi and lo with their 13 low mantissa bits zero (exact
    TF32 values), hi the value rounded to nearest with ties away from zero
    (the tests' own cvt.rna emulation), hi + lo exact in float32 and within
    2^-21 of the value; the planes pad each row to a multiple of four."""
    rng = np.random.default_rng(32)
    x = np.sort(rng.uniform(0.0, 40.0, 101))
    K1 = np.exp(-np.abs(x[:, None] - x[None, :]) / 3.0) \
        * rng.uniform(0.5, 2.0, (101, 101))
    K1 = torch.from_numpy(np.concatenate([K1, -K1[:7]]).astype(np.float32))
    hi, lo = tf32_split(K1)
    for half in (hi, lo):
        assert int((half.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.equal(hi, tf32(K1)) and torch.equal(lo, tf32(K1 - hi))
    assert torch.equal((hi + lo).double(), hi.double() + lo.double())
    rel = ((hi.double() + lo.double() - K1.double()).abs()
           / K1.double().abs()).max()
    assert 0 < float(rel) <= 2.0**-21
    planes = tf32_planes(K1)
    assert (planes.hi.shape[0], planes.cols, planes.ld) == (108, 101, 104)
    assert torch.equal(planes.hi[:, :101], hi)
    assert torch.equal(planes.lo[:, :101], lo)
    assert not planes.hi[:, 101:].any() and not planes.lo[:, 101:].any()
    assert torch.equal(planes.value(), hi + lo)


@pytest.mark.parametrize("shape", AWKWARD_SHAPES)
def test_stage_right_plain_is_todays_T_split_and_transposed(shape):
    """The plain stage R's planes are, bit for bit, the float32 T of the
    parent's plain stage R, ``(mask * u) @ K2``, transposed to (B m, n) and
    split into TF32 halves by the kernels' rule."""
    K1, K2, mask, u = _t(*_problem(*shape))
    B, n, m = shape
    T = (mask * u) @ K2
    Tt = T.transpose(1, 2).reshape(B * m, n)
    P = lk_mvm_stage_right_plain(u, mask, K2)
    assert (P.hi.shape[0], P.cols) == (B * m, n) and P.ld % 4 == 0 and P.ld >= n
    hi = tf32(Tt)
    assert torch.equal(P.hi[:, :n], hi)
    assert torch.equal(P.lo[:, :n], tf32(Tt - hi))


@pytest.mark.parametrize("shape", AWKWARD_SHAPES)
def test_stage_left_plain_over_planes_is_todays_within_rounding(shape):
    """The plain stage L over K1's and T's planes equals the parent's plain
    stage L on the float32 T, ``mask * (K1 @ T) + noise * (mask * u)``,
    within float32 rounding (1e-6 of max|out|), and the product of the
    halves' sums bit for bit."""
    K1, K2, mask, u = _t(*_problem(*shape, seed=5))
    T = (mask * u) @ K2
    today = mask * (K1 @ T) + 0.37 * (mask * u)
    P = lk_mvm_stage_right_plain(u, mask, K2)
    got = lk_mvm_stage_left_plain(K1, P, mask, u, 0.37)
    B, n, m = shape
    Tv = P.value().reshape(B, m, n).transpose(1, 2)
    assert torch.equal(got, mask * (tf32_planes(K1).value() @ Tv)
                       + torch.tensor(0.37) * (mask * u))
    assert got.dtype == torch.float32 and got.shape == today.shape
    scale = float(today.abs().max())
    assert float((got - today).abs().max()) <= 1e-6 * scale


def _tc_route(route, K1, K2, mask, u, noise, passes):
    """One route's arithmetic with its tensor-core products emulated in
    ``passes`` TF32 passes: K1 (``fused``, both products, T never rounded
    to storage), K2a alone (``stage_right``: T on the tensor cores, stage L
    the plain float32 product), K2b alone (``stage_left``: the plain float32
    T, stage L on the tensor cores) or both (``two_stage``)."""
    um = mask * u
    tc_R = route in ("fused", "stage_right", "two_stage")
    tc_L = route in ("fused", "stage_left", "two_stage")
    T = tc_matmul(um, K2, passes) if tc_R else um @ K2
    KT = tc_matmul(K1, T, passes) if tc_L else K1 @ T
    return mask * KT + noise * um


def _tc_reference(route, K1, K2, mask, u, noise):
    """The reference's Pallas kernel of the route, in interpret mode."""
    kernel = ref_lk_mvm_fused if route == "fused" else ref_lk_mvm_two_stage
    return np.asarray(kernel(
        jnp.asarray(K1), jnp.asarray(K2), jnp.asarray(mask), jnp.asarray(u),
        noise, block_n=16, block_m=16, interpret=True))


TC_ROUTES = ["fused", "stage_right", "stage_left", "two_stage"]


@pytest.mark.parametrize("shape,route", [
    pytest.param(shape, route, id=f"shape{i}" if route == "fused"
                 else f"{route}-shape{i}")
    for route in TC_ROUTES for i, shape in enumerate(AWKWARD_SHAPES)])
def test_3xtf32_emulation_matches_reference_kernel(shape, route):
    """The f32 arithmetic of K1 (``fused``) and of K2a, K2b and the pair
    against the reference's Pallas kernel of the same route in interpret
    mode: within 1e-4 * max|ref| (chip_smoke.py's tolerance), and closer
    than a single TF32 pass."""
    K1, K2, mask, u = _problem(*shape, seed=3)
    ref = _tc_reference(route, K1, K2, mask, u, 0.37)
    args = _t(K1, K2, mask, u)
    err = {p: np.abs(_tc_route(route, *args, 0.37, p).numpy() - ref).max()
           for p in (1, 3)}
    scale = np.abs(ref).max()
    assert err[3] <= 1e-4 * scale
    assert err[1] > err[3]


def test_3xtf32_emulation_holds_the_float64_oracle_at_the_fit_shape():
    """At (17, 2000, 52), the fit's stacked solve, three passes stay within
    1e-4 * max|oracle| on every route (K1, K2a, K2b, the pair) and one pass
    is further off: why the f32 mode and the two-stage kernels take three.
    One pass misses the tolerance wherever the (n = 2000)-deep K1 product
    runs on the tensor cores."""
    K1, K2, mask, u = _problem(17, 2000, 52, seed=4)
    args = _t(K1, K2, mask, u)
    truth = lk_mvm_ref(*(a.double() for a in args), 0.1)
    scale = float(truth.abs().max())
    for route in TC_ROUTES:
        err = {p: float((_tc_route(route, *args, 0.1, p).double()
                         - truth).abs().max()) for p in (1, 3)}
        assert err[3] <= 1e-4 * scale, route
        assert err[1] > err[3], route
        if route != "stage_right":
            assert err[1] > 1e-4 * scale, route   # one pass would miss it


def test_k2a_sums_each_k_step_apart_against_truncation_drift():
    """K2a's T = (mask * U) @ K2 at m = 64 as the tensor cores compute it
    (3xTF32 MMAs whose float32 sums truncate): accumulating all 24 MMAs in
    place in the output fragment biases T toward zero by ~5e-7 of |T|; a
    zeroed fragment per k step added with a rounding add (what K2a and K1's
    stage R do) cuts the bias tenfold. A bias that does not average out is
    what CG solutions amplify: a float32 sweep at a solution of the n = 8192
    serve task was off by 1.5e-2 of ||A x|| with the in-place K2a against
    2.0e-3 through K1 (PERF.md)."""
    rng = np.random.default_rng(21)
    t = np.arange(64)
    K2 = torch.from_numpy(np.exp(-np.abs(t[:, None] - t[None, :]) / 20.0)
                          .astype(np.float32))
    U = torch.from_numpy(rng.standard_normal((2048, 64)).astype(np.float32))
    exact = U.double().numpy() @ K2.double().numpy()
    bias = {}
    for per_step in (False, True):
        err = mma_3xtf32(U, K2, per_step).astype(np.float64) - exact
        bias[per_step] = float(np.mean(err * np.sign(exact))
                               / np.mean(np.abs(exact)))
        assert np.abs(err).max() <= 1e-5 * np.abs(exact).max()
    assert bias[False] < -2e-7                 # toward zero
    assert abs(bias[True]) * 5 < abs(bias[False])


def test_k2b_promotes_every_two_k_steps_against_truncation_drift():
    """K2b's K1 @ T at its depth (n = 4096: a Matern-like row of K1 against
    a column of T, 64 x 64 of each) as its wgmmas compute it: 3xTF32, each
    MMA's float32 sum truncated, PROMOTE k steps chained into a zeroed
    accumulator (lo products first) before a rounding add (the kernel's
    constant, read from its source). Its bias toward zero stays within 2x
    of one step's chain (K1's and K2a's order), at least 5x below
    accumulating in place, and its largest error within 1e-5 of max|exact|:
    the CPU evidence that CG does not need more sweeps."""
    import re
    src = (_build.CSRC / "lk_mvm_stage_left.cu").read_text()
    promote = int(re.search(r"constexpr int PROMOTE = (\d+);", src).group(1))
    assert promote == 2
    rng = np.random.default_rng(32)
    n = 4096
    x = np.sort(rng.uniform(0.0, 40.0, n))
    rows = rng.choice(n, 64, replace=False)
    K1 = np.exp(-np.abs(x[rows][:, None] - x[None, :]) / 3.0)
    T = rng.standard_normal((n, 64))
    a, b = (torch.from_numpy(v.astype(np.float32)) for v in (K1, T))
    exact = a.double().numpy() @ b.double().numpy()
    bias, worst = {}, {}
    for name, kw in (("in_place", dict(per_step=False)),
                     ("step", dict(per_step=True)),
                     ("k2b", dict(per_step=True, interval=promote))):
        err = mma_3xtf32(a, b, **kw).astype(np.float64) - exact
        bias[name] = float(np.mean(err * np.sign(exact))
                           / np.mean(np.abs(exact)))
        worst[name] = float(np.abs(err).max() / np.abs(exact).max())
    assert bias["in_place"] < bias["k2b"] < 0       # toward zero
    assert abs(bias["k2b"]) <= 2 * abs(bias["step"])
    assert 5 * abs(bias["k2b"]) <= abs(bias["in_place"])
    assert worst["k2b"] <= 1e-5
