"""Regenerate tests/fixtures/reference_kernels.npz (committed fixture).

The reference's own TPU kernels, run by Pallas in interpret mode on the
CPU, at small ragged shapes: ``rbf_gram_pallas`` (kernel K4's reference),
``lk_mvm_fused`` (K1's) and ``lk_mvm_two_stage`` (K2a + K2b's). The inputs
are made with numpy from a seed and stored beside the outputs, so the port
is held against the reference's kernels without JAX: the CPU tests hold the
port's plain versions against the file (and regenerate one entry through
JAX to show that the file is the reference's output), and ``chip_smoke.py``
holds the CUDA kernels against it on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_reference_kernels.py
"""
import os

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import (lk_mvm_fused, lk_mvm_two_stage,  # noqa: E402
                           rbf_gram_pallas)

OUT = os.path.join(os.path.dirname(__file__), "reference_kernels.npz")
SEED = 20
# (B, n, m): ragged against the reference's blocks below and against the
# port's tiles (n not a multiple of 32 or 256, m not of 16 or 64).
MVM_SHAPES = [(3, 37, 21), (2, 70, 13)]
MVM_BLOCKS = dict(block_n=32, block_m=16)
# (n, p, d, dtype): a ragged float32 case and a float64 one (float64 out).
GRAM_SHAPES = [(130, 70, 10, "float32"), (33, 17, 6, "float64")]
GRAM_BLOCKS = dict(block_n=32, block_d=64)
GRAM_OUTPUTSCALE = 1.7
NOISE = 0.1


def mvm_inputs(rng, B, n, m):
    """SPD K1 (n, n) and K2 (m, m), a prefix (early-stopping) mask, a
    masked u, float32."""
    A = rng.standard_normal((n, n))
    K1 = A @ A.T / n + 0.5 * np.eye(n)
    C = rng.standard_normal((m, m))
    K2 = C @ C.T / m + 0.5 * np.eye(m)
    lens = rng.integers(1, m + 1, n)
    mask = (np.arange(m)[None, :] < lens[:, None]).astype(np.float64)
    u = rng.standard_normal((B, n, m)) * mask
    return [a.astype(np.float32) for a in (K1, K2, mask, u)]


def gram_inputs(rng, n, p, d, dtype):
    x1 = rng.uniform(size=(n, d)).astype(dtype)
    x2 = rng.uniform(size=(p, d)).astype(dtype)
    ls = np.exp(0.3 * rng.standard_normal(d)).astype(dtype)
    return x1, x2, ls


def run_mvm(kind, K1, K2, mask, u):
    fn = {"fused": lk_mvm_fused, "two_stage": lk_mvm_two_stage}[kind]
    args = [jnp.asarray(a) for a in (K1, K2, mask, u)]
    return np.asarray(fn(*args, NOISE, interpret=True, **MVM_BLOCKS))


def run_gram(x1, x2, ls):
    return np.asarray(rbf_gram_pallas(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls), GRAM_OUTPUTSCALE,
        interpret=True, **GRAM_BLOCKS))


def main(path: str = OUT) -> str:
    rng = np.random.default_rng(SEED)
    arrays = {}
    for i, (B, n, m) in enumerate(MVM_SHAPES):
        K1, K2, mask, u = mvm_inputs(rng, B, n, m)
        arrays.update({f"mvm{i}_{k}": v for k, v in
                       (("K1", K1), ("K2", K2), ("mask", mask), ("u", u))})
        for kind in ("fused", "two_stage"):
            arrays[f"mvm{i}_{kind}"] = run_mvm(kind, K1, K2, mask, u)
    for i, (n, p, d, dtype) in enumerate(GRAM_SHAPES):
        x1, x2, ls = gram_inputs(rng, n, p, d, dtype)
        arrays.update({f"gram{i}_x1": x1, f"gram{i}_x2": x2,
                       f"gram{i}_ls": ls, f"gram{i}_out": run_gram(x1, x2, ls)})
    arrays["noise"] = np.float32(NOISE)
    arrays["outputscale"] = np.float32(GRAM_OUTPUTSCALE)
    np.savez_compressed(path, **arrays)
    return path


if __name__ == "__main__":
    print(main())
