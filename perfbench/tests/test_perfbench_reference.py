"""The plain reference against the port's CPU path at a tiny size: the same
inputs give the same final means and variances, and the same residual."""
import pytest
import torch

from perfbench import program
from perfbench.clients.final import snapshot_state
from perfbench.reference.lkgp import (Operator, fit_transforms,
                                      posterior_final, relative_residual, tf32)
from perfbench.traffic import draw_normals, make_traffic

CONFIG = {"n": 24, "m": 16, "d": 7,
          "lkgp": {"backend": "iterative", "t_kernel": "matern12",
                   "cg_tol": 1e-10, "jitter": 1e-6, "posterior_samples": 8},
          "hyper_parameters": {"raw_x_lengthscale": [0.3, -0.2, 0.1, 0.4,
                                                     0.0, -0.1, 0.2],
                               "raw_t_lengthscale": -0.5,
                               "raw_outputscale": 0.2, "raw_noise": -3.0}}
MIX = {"min_epochs": 1, "eta": 3, "races": 1}


@pytest.fixture(scope="module")
def prog():
    return program.load()


def _port_and_reference(prog, seed, rung):
    f64 = torch.float64
    tr = make_traffic(CONFIG, MIX, seed)
    race = tr.races[0]
    Y, mask = (torch.tensor(a, dtype=f64) for a in race.rungs[rung])
    X, t = torch.tensor(race.X), torch.tensor(tr.t)
    cfg = prog.core.LKGPConfig(**CONFIG["lkgp"])
    st = snapshot_state(prog, CONFIG, cfg, X, t, Y, mask)
    normals = draw_normals(seed, 0, 8, CONFIG["n"], CONFIG["m"], "cpu")
    post = prog.core.posterior(st, device="cpu")
    mean, var = post.final(normals=normals)
    ref = posterior_final(X, t, Y, mask, CONFIG["hyper_parameters"], normals,
                          jitter=1e-6, tol=1e-10)
    return st, post, mean, var, ref


@pytest.mark.parametrize("rung", [0, -1])  # the race's first and last
@pytest.mark.parametrize("seed", [3, 2**31 + 5])  # the dataset and normals
def test_reference_matches_the_port(prog, seed, rung):
    st, post, mean, var, ref = _port_and_reference(prog, seed, rung)
    assert torch.allclose(mean, ref.mean, rtol=0, atol=1e-7)
    assert torch.allclose(var, ref.var, rtol=1e-6, atol=1e-10)
    tf = fit_transforms(st.X, st.t, st.Y, st.mask)
    assert torch.allclose(tf.y_scale, st.y_tf.scale)
    assert torch.allclose(tf.y_shift, st.y_tf.shift)
    assert float(relative_residual(ref.operator, post.alpha, ref.rhs).max()) \
        < 1e-8


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0],
                     dtype=torch.float32)
    # 2**-11 is half a TF32 step above 1: ties round away from zero
    assert tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0]


def test_tf32_operator_differs_from_float64_by_its_rounding():
    g = torch.Generator().manual_seed(0)
    A = torch.randn(16, 16, generator=g, dtype=torch.float64)
    K1 = A @ A.T / 16
    B = torch.randn(8, 8, generator=g, dtype=torch.float64)
    K2 = B @ B.T / 8
    mask = torch.ones(16, 8, dtype=torch.float64)
    u = torch.randn(2, 16, 8, generator=g, dtype=torch.float64)
    exact = Operator(K1, K2, mask, 0.1)(u)
    low = Operator(K1, K2, mask, 0.1, precision="control")(u)
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-5 < rel < 1e-2
