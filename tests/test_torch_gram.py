"""PyTorch port, kernel K4: the RBF-ARD Gram matrix. The kernel wrapper's
plain version and ``rbf_gram_op`` against the reference's Pallas kernel
(interpret mode on CPU) and oracle, on inputs made with numpy from a seed.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rbf_gram_pallas as ref_rbf_gram_pallas
from repro.kernels import rbf_gram_ref as ref_rbf_gram_ref
from repro_torch.kernels import (rbf_gram_cuda, rbf_gram_op, rbf_gram_plain,
                                 rbf_gram_ref)
from repro_torch.kernels import gram as gram_mod

# The five shapes of the reference's own kernel test (tests/test_kernels.py):
# below one tile, ragged tiles, d = 1 and d spanning several chunks.
SHAPES = [(8, 8, 3), (32, 16, 7), (130, 70, 10), (64, 64, 1), (16, 16, 260)]
# The reference's tolerance for its kernel against its oracle: float32 with
# the dot product summed in another order.
TOL = 3e-5


def _inputs(n, p, d, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(size=(n, d)).astype(dtype)
    x2 = rng.uniform(size=(p, d)).astype(dtype)
    ls = np.exp(rng.standard_normal(d) * 0.3).astype(dtype)
    return x1, x2, ls


def _reference(x1, x2, ls, os=1.7):
    return np.asarray(ref_rbf_gram_pallas(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls), os, block_n=32,
        block_d=64, interpret=True))


@pytest.mark.parametrize("n,p,d", SHAPES)
@pytest.mark.parametrize("entry", ["plain", "op_forced", "wrapper"])
def test_rbf_gram_matches_reference_kernel(n, p, d, entry):
    """The plain version, ``rbf_gram_op(force_kernel=True)`` and the wrapper
    on CPU tensors (which runs the plain version) against the reference's
    kernel, within its own tolerance 3e-5."""
    x1, x2, ls = _inputs(n, p, d)
    want = _reference(x1, x2, ls)
    t1, t2, tl = (torch.from_numpy(a) for a in (x1, x2, ls))
    fn = {"plain": rbf_gram_plain, "wrapper": rbf_gram_cuda,
          "op_forced": lambda *a: rbf_gram_op(*a, force_kernel=True,
                                              device="cpu")}[entry]
    got = fn(t1, t2, tl, 1.7)
    assert got.shape == (n, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,d", [(40, 5), (130, 10)])
def test_rbf_gram_symmetric_with_unit_diagonal(n, d):
    """x1 = x2: symmetric to 1e-6 and the diagonal exactly outputscale (the
    norms and the dot product of a row with itself are summed alike, so the
    squared distance there is 0); entries within [0, outputscale]."""
    x, _, _ = _inputs(n, 1, d, seed=2)
    t = torch.from_numpy(x)
    K = rbf_gram_op(t, t, torch.ones(d), 1.0, force_kernel=True,
                    device="cpu").numpy()
    np.testing.assert_allclose(K, K.T, atol=1e-6)
    np.testing.assert_allclose(np.diag(K), 1.0, atol=1e-6)
    assert K.min() >= 0.0 and K.max() <= 1.0 + 1e-6
    ref = _reference(x, x, np.ones(d, np.float32), 1.0)
    np.testing.assert_allclose(K, ref, rtol=TOL, atol=TOL)


def test_rbf_gram_float64_inputs_compute_in_float32():
    """float64 x: z = x / l in float64, the rest in float32, the result
    returned as float64, as the reference's kernel does (3e-5 to it; 1e-6
    away from the float64 oracle at most, not 1e-12)."""
    x1, x2, ls = _inputs(33, 17, 6, seed=3, dtype=np.float64)
    got = rbf_gram_op(*(torch.from_numpy(a) for a in (x1, x2, ls)), 0.9,
                      force_kernel=True, device="cpu")
    assert got.dtype == torch.float64
    want = _reference(x1, x2, ls, 0.9)
    assert want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    exact = np.asarray(ref_rbf_gram_ref(x1, x2, ls, 0.9))
    gap = np.abs(got.numpy() - exact).max()
    assert 0 < gap <= 1e-6


def test_rbf_gram_op_on_the_cpu_is_the_oracle():
    """Without force_kernel the CPU op is the float64 oracle, equal to the
    reference's oracle to rounding (1e-12), and never the kernel wrapper."""
    x1, x2, ls = _inputs(21, 13, 4, seed=4, dtype=np.float64)
    got = rbf_gram_op(*(torch.from_numpy(a) for a in (x1, x2, ls)), 1.3,
                      device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref_rbf_gram_ref(x1, x2, ls, 1.3)),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        got.numpy(), rbf_gram_ref(*(torch.from_numpy(a)
                                    for a in (x1, x2, ls)), 1.3).numpy())


def test_rbf_gram_outputscale_as_tensor_or_number():
    x1, x2, ls = (torch.from_numpy(a) for a in _inputs(9, 11, 3, seed=5))
    a = rbf_gram_plain(x1, x2, ls, 2.5)
    b = rbf_gram_plain(x1, x2, ls, torch.tensor(2.5, dtype=torch.float64))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="scalar"):
        rbf_gram_plain(x1, x2, ls, torch.ones(2))


@pytest.mark.parametrize("bad", ["d", "ls", "device", "grad"])
def test_rbf_gram_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x1, x2, ls = (torch.from_numpy(a) for a in _inputs(9, 11, 3, seed=6))
    if bad == "d":
        x2 = x2[:, :2]
        err = ValueError
    elif bad == "ls":
        ls = torch.ones(4)
        err = ValueError
    elif bad == "device":
        x1, x2, ls = (a.to("meta") for a in (x1, x2, ls))
        err = ValueError      # neither CUDA nor CPU: raise, never fall back
    else:
        x1 = x1.requires_grad_()
        err = NotImplementedError
    with pytest.raises(err):
        rbf_gram_cuda(x1, x2, ls, 1.0)


def test_rbf_gram_wrapper_counts_only_kernel_launches(monkeypatch):
    """On CPU tensors the wrapper runs the plain version and counts nothing;
    the library is never built."""
    monkeypatch.setattr(gram_mod, "launch", None)   # must not be reached
    before = rbf_gram_cuda.launches
    x1, x2, ls = (torch.from_numpy(a) for a in _inputs(9, 11, 3, seed=7))
    rbf_gram_cuda(x1, x2, ls, 1.0)
    assert rbf_gram_cuda.launches == before


@pytest.mark.parametrize("dt1,dt2", [("float32", "float64"),
                                     ("float64", "float32"),
                                     ("float64", "float64")])
def test_rbf_gram_output_dtype_follows_x1(dt1, dt2):
    """The kernel writes x1's dtype from its epilogue (the reference's
    ``out_shape=... x1.dtype``); so does the wrapper's plain version."""
    x1, x2, ls = _inputs(19, 23, 5, seed=8, dtype=np.float64)
    t1 = torch.from_numpy(x1).to(getattr(torch, dt1))
    t2 = torch.from_numpy(x2).to(getattr(torch, dt2))
    got = rbf_gram_cuda(t1, t2, torch.from_numpy(ls), 1.1)
    assert got.dtype == t1.dtype and got.shape == (19, 23)


def test_rbf_gram_float64_output_is_the_float32_result_cast():
    """For float64 inputs the values are the float32 computation's, cast:
    the same bits as the float32 result from the same z = (x / l) rounded
    to float32 (divided by ones, which is exact), converted to float64."""
    x1, x2, ls = (torch.from_numpy(a) for a in
                  _inputs(37, 29, 7, seed=9, dtype=np.float64))
    got = rbf_gram_plain(x1, x2, ls, 0.8)
    assert got.dtype == torch.float64
    z1, z2 = ((x / ls).to(torch.float32) for x in (x1, x2))
    f32 = rbf_gram_plain(z1, z2, torch.ones(7), 0.8)
    assert f32.dtype == torch.float32
    assert torch.equal(got, f32.to(torch.float64))


def test_rbf_gram_divides_before_rounding_to_float32():
    """The kernel forms z = x / l where it loads x, in the dtype x, x2 and l
    promote to, then rounds to float32: the bits of ``(x / l).to(float32)``.
    Shown through the plain version, which rounds at that point: mixed
    float32 x and float64 l divide in float64; and for float32 x and l a
    division in float64 rounded to float32 is the float32 division (float64
    has more than twice float32's precision), which is why the kernel may
    divide a float32 x2 in float64 when x1 is float64."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.uniform(-3, 3, (4000,)).astype(np.float32))
    l32 = torch.from_numpy(np.exp(rng.standard_normal(4000)).astype(
        np.float32))
    assert torch.equal((x.double() / l32.double()).float(), x / l32)
    x1, x2, ls = _inputs(31, 17, 6, seed=11)
    ls64 = torch.from_numpy(ls).double() * (1 + 1e-9)   # not a float32
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    got = rbf_gram_plain(t1, t2, ls64, 1.3)
    assert got.dtype == torch.float32
    z1 = (t1.double() / ls64).float()
    z2 = (t2.double() / ls64).float()
    assert torch.equal(got, rbf_gram_plain(z1, z2, torch.ones(6), 1.3))
    # dividing in float32 instead would have rounded differently somewhere
    assert not torch.equal(z1, t1 / ls64.float())


@pytest.mark.parametrize("n,p,d,sms", [(8192, 8192, 7, 132),
                                       (2000, 2000, 7, 132),
                                       (130, 70, 10, 132), (16, 16, 260, 132),
                                       (8192, 8192, 7, 114), (5, 3000, 3, 132)])
def test_gram_planner_covers_every_output_once(n, p, d, sms):
    """plan_gram's units, as the warps of the grid walk them, cover every
    (column tile, row) once; the grid is at most the blocks per SM that
    d's instantiation admits (3 for d <= 8, 2 above) times the SMs given,
    with about one unit per warp and no block without one; at n = p = 8192
    the units fill 95 % of the warps the card holds."""
    from repro_torch.kernels.gram import GRAM_COLS, GRAM_WARPS, plan_gram
    plan = plan_gram(n, p, d, sms=sms)
    per_sm = 3 if d <= 8 else 2
    assert plan.col_tiles == -(-p // GRAM_COLS)
    assert 1 <= plan.blocks <= per_sm * sms
    units = plan.col_tiles * plan.row_chunks
    assert units <= plan.blocks * GRAM_WARPS < units + GRAM_WARPS \
        or plan.blocks == per_sm * sms
    if (n, p) == (8192, 8192):
        assert units >= 0.95 * per_sm * sms * GRAM_WARPS
    seen = np.zeros((plan.col_tiles, n), dtype=np.int64)
    for w in range(plan.blocks * GRAM_WARPS):
        for c, r0, r1 in plan.units(w):
            seen[c, r0:r1] += 1
    assert (seen == 1).all()
    c = plan.c_struct()
    assert (c.col_tiles, c.row_chunks, c.blocks) == (
        plan.col_tiles, plan.row_chunks, plan.blocks)
