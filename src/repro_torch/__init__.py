"""PyTorch/CUDA port of the latent-Kronecker GP (LKGP) learning-curve model.

The reference implementation is the JAX package ``repro`` that sits beside
this one; every module here has the same name as its counterpart there
(``repro_torch.core.posterior`` <-> ``repro.core.posterior``), so a reader can
hold the two side by side. This package imports ``torch`` and ``numpy`` only:
never ``jax``, and nothing from ``repro``.

What is ported so far is the path that *serves* a fitted model:

    state_from_reference(...)  ->  posterior(state)  ->  .mean / .samples / .final

through the ``dense``, ``iterative`` and ``cuda`` inference engines. On the
``cuda`` engine every CG iteration is one launch of the hand-written fused
latent-Kronecker MVM kernel (``kernels/csrc/lk_mvm_fused.cu``).

Device rule: every entry point takes ``device=None`` and ``None`` means the
GPU. With no CUDA device present it raises; nothing silently carries on on
the CPU. Tests pass ``device="cpu"`` explicitly.
"""
from ._device import resolve_device
from .convert import params_from_numpy, state_from_reference
from .core import (LKGPConfig, LKGPParams, LKGPState, Posterior, get_engine,
                   init_params, posterior)

__all__ = [
    "resolve_device", "params_from_numpy", "state_from_reference",
    "LKGPConfig", "LKGPParams", "LKGPState", "Posterior", "get_engine",
    "init_params", "posterior",
]
