"""PyTorch port against the reference's TPU kernels themselves:
``tests/fixtures/reference_kernels.npz`` holds inputs and the outputs of
``rbf_gram_pallas``, ``lk_mvm_fused`` and ``lk_mvm_two_stage`` run by Pallas
in interpret mode (``tests/fixtures/make_reference_kernels.py``). The port's
plain versions are held against the file here, one entry is regenerated
through JAX to show that the file is the reference's output, and
``chip_smoke.py`` holds the CUDA kernels against the same file on the card.
"""
import importlib.util
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import (lk_mvm_fused_plain,  # noqa: E402
                                 lk_mvm_two_stage_plain, rbf_gram_plain)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
NPZ = FIXTURES / "reference_kernels.npz"
# The port's plain versions sum in another order than the reference's
# kernels: the MVM within chip_smoke.py's KERNEL_TOL (1e-4 of max|out|),
# the Gram matrix within the reference's own 3e-5.
MVM_TOL, GRAM_TOL = 1e-4, 3e-5


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_reference_kernels", FIXTURES / "make_reference_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    with np.load(NPZ) as z:
        return dict(z)


def test_fixture_is_small_and_complete(ref):
    gen = _generator()
    assert NPZ.stat().st_size < 200_000
    for i, (B, n, m) in enumerate(gen.MVM_SHAPES):
        assert ref[f"mvm{i}_u"].shape == (B, n, m)
        for kind in ("fused", "two_stage"):
            assert ref[f"mvm{i}_{kind}"].shape == (B, n, m)
    for i, (n, p, d, dtype) in enumerate(gen.GRAM_SHAPES):
        assert ref[f"gram{i}_out"].shape == (n, p)
        assert ref[f"gram{i}_out"].dtype == np.dtype(dtype)


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("kind", ["fused", "two_stage"])
def test_plain_mvm_matches_the_reference_kernels(ref, i, kind):
    K1, K2, mask, u = (torch.from_numpy(ref[f"mvm{i}_{k}"])
                       for k in ("K1", "K2", "mask", "u"))
    plain = {"fused": lk_mvm_fused_plain,
             "two_stage": lk_mvm_two_stage_plain}[kind]
    got = plain(K1, K2, mask, u, float(ref["noise"])).numpy()
    want = ref[f"mvm{i}_{kind}"]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MVM_TOL * np.abs(want).max())


@pytest.mark.parametrize("i", [0, 1])
def test_plain_gram_matches_the_reference_kernel(ref, i):
    x1, x2, ls = (torch.from_numpy(ref[f"gram{i}_{k}"])
                  for k in ("x1", "x2", "ls"))
    got = rbf_gram_plain(x1, x2, ls, float(ref["outputscale"])).numpy()
    want = ref[f"gram{i}_out"]
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAM_TOL * np.abs(want).max())


def test_fixture_is_the_reference_output():
    """Regenerating entries through the reference's Pallas kernels (interpret
    mode) from the stored inputs gives the stored outputs."""
    gen = _generator()
    with np.load(NPZ) as z:
        args = [z[f"mvm1_{k}"] for k in ("K1", "K2", "mask", "u")]
        np.testing.assert_allclose(gen.run_mvm("two_stage", *args),
                                   z["mvm1_two_stage"], rtol=1e-6, atol=1e-6)
        x1, x2, ls = (z[f"gram1_{k}"] for k in ("x1", "x2", "ls"))
        np.testing.assert_allclose(gen.run_gram(x1, x2, ls), z["gram1_out"],
                                   rtol=1e-12, atol=1e-12)
    # and the inputs are the seeded ones
    rng = np.random.default_rng(gen.SEED)
    K1, K2, mask, u = gen.mvm_inputs(rng, *gen.MVM_SHAPES[0])
    with np.load(NPZ) as z:
        np.testing.assert_array_equal(K1, z["mvm0_K1"])
        np.testing.assert_array_equal(u, z["mvm0_u"])
