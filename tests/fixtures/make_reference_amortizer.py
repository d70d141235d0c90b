"""Regenerate tests/fixtures/reference_amortizer.npz (committed fixture).

The reference's amortizer and curve transformer, run by JAX on the CPU, on
inputs made with numpy from a seed and stored beside the outputs, so the
port is held against them without JAX (the CPU tests hold the port's CPU
path against the file and regenerate entries through JAX to show that the
file is the reference's output; ``chip_smoke.py``'s ``amortize`` phase holds
the card's outputs against it):

* ``am{i}_*``: the packaged d=5 amortizer fixture's ``init_flat`` on two
  transformed tasks, one at n=2048 so that its set stage takes the chunked
  attention;
* ``ct_params/<path>`` and ``ct{i}_*``: ``curve_transformer.forward`` at two
  shapes with parameters drawn by the reference (``PRNGKey(0)``) at the
  configuration ``CT_CONFIG``;
* ``gap_*``: ``benchmarks/bench_automl.py``'s amortized MLL-gap rows at d=5,
  n=12, m=9, seeds 0-3 (the converged objective after 60 L-BFGS
  iterations, and the gaps to it of the default init, the one-shot
  amortized init and the amortized init polished by 2 steps), unrounded.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_reference_amortizer.py
"""
import os

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.amortize import get_amortizer  # noqa: E402
from repro.baselines import (CurveTransformerConfig,  # noqa: E402
                             build_curve_model, forward, normalize_t)
from repro.core import LKGPConfig, fit  # noqa: E402
from repro.data import sample_task  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "reference_amortizer.npz")
SEED = 21
AM_SHAPES = [(40, 9), (2048, 10)]                 # (n, m), d = 5
CT_CONFIG = dict(d_in=7, d_model=32, num_layers=2, num_heads=2, d_ff=64)
CT_SHAPES = [(16, 12), (48, 52)]                  # (curves, m)
GAP_SEEDS = (0, 1, 2, 3)
GAP_SHAPE = dict(n=12, m=9, d=5)


def transformed_task(rng, n, m, d=5):
    """A transformed-view task (unit-cube X, [0, 1] t, standardised Y, a
    prefix mask), float32."""
    lens = rng.integers(1, m + 1, n)
    mask = (np.arange(m)[None, :] < lens[:, None]).astype(np.float32)
    Xn = rng.uniform(size=(n, d)).astype(np.float32)
    tn = np.linspace(0.0, 1.0, m).astype(np.float32)
    Yn = (rng.standard_normal((n, m)) * mask).astype(np.float32)
    return Xn, tn, Yn, mask


def flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(tree[k])
    return out


def mll_gaps(seed):
    task = sample_task(seed=900 + seed, noise=0.005, crossing=True,
                       **GAP_SHAPE)
    args = (task.X, task.t, task.Y, task.mask)
    conv = fit(*args, LKGPConfig(lbfgs_iters=60)).fit_result.fun
    one = fit(*args, LKGPConfig(hyper_init="amortized",
                                polish_steps=0)).fit_result.fun
    dflt = fit(*args, LKGPConfig(polish_steps=0)).fit_result.fun
    pol = fit(*args, LKGPConfig(hyper_init="amortized",
                                polish_steps=2)).fit_result.fun
    return conv, dflt - conv, one - conv, pol - conv


def main(path: str = OUT) -> str:
    rng = np.random.default_rng(SEED)
    arrays = {}
    am = get_amortizer(5)
    for i, (n, m) in enumerate(AM_SHAPES):
        task = transformed_task(rng, n, m)
        arrays.update({f"am{i}_{k}": v for k, v in
                       zip(("Xn", "tn", "Yn", "mask"), task)})
        arrays[f"am{i}_out"] = np.asarray(am.init_flat(*task))
    cfg = CurveTransformerConfig(**CT_CONFIG)
    params = build_curve_model(cfg).init(jax.random.PRNGKey(0))
    arrays.update({f"ct_params/{k}": v for k, v in flatten(params).items()})
    for i, (B, m) in enumerate(CT_SHAPES):
        lens = rng.integers(1, m + 1, B)
        mask = (np.arange(m)[None, :] < lens[:, None]).astype(np.float32)
        hp = rng.uniform(size=(B, cfg.d_in)).astype(np.float32)
        y = (rng.uniform(0.2, 0.9, (B, m)) * mask).astype(np.float32)
        t_norm = np.asarray(normalize_t(np.arange(1.0, m + 1.0)))
        mu, sigma = forward(params, jnp.asarray(hp), jnp.asarray(y),
                            jnp.asarray(mask), jnp.asarray(t_norm), cfg)
        arrays.update({f"ct{i}_hp": hp, f"ct{i}_y": y, f"ct{i}_mask": mask,
                       f"ct{i}_t_norm": t_norm, f"ct{i}_mu": np.asarray(mu),
                       f"ct{i}_sigma": np.asarray(sigma)})
    gaps = np.array([mll_gaps(s) for s in GAP_SEEDS])
    arrays["gap_seeds"] = np.asarray(GAP_SEEDS)
    for j, k in enumerate(("converged", "default", "amortized", "polished")):
        arrays[f"gap_{k}"] = gaps[:, j]
    np.savez_compressed(path, **arrays)
    return path


if __name__ == "__main__":
    print(main())
