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
    monkeypatch.setattr(gram_mod, "_library", None)   # must not be reached
    before = rbf_gram_cuda.launches
    x1, x2, ls = (torch.from_numpy(a) for a in _inputs(9, 11, 3, seed=7))
    rbf_gram_cuda(x1, x2, ls, 1.0)
    assert rbf_gram_cuda.launches == before
