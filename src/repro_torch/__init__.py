"""PyTorch/CUDA port of the latent-Kronecker GP (LKGP) learning-curve model.

The reference implementation is the JAX package ``repro`` that sits beside
this one; every module here has the same name as its counterpart there
(``repro_torch.core.posterior`` <-> ``repro.core.posterior``), so a reader can
hold the two side by side. This package imports ``torch`` and ``numpy`` only:
never ``jax``, and nothing from ``repro``.

What is ported so far is the path that fits a model and serves it:

    fit(X, t, Y, mask, config)  ->  posterior(state)  ->  .mean / .samples / .final

(or ``state_from_reference(...)`` in place of ``fit``), its warm-start family
(``extend`` / ``refit`` / the fixed-budget polish; ``fit_batch`` ->
``posterior_batch`` for batches of small tasks) and the data layer
(``repro_torch.data``), the AutoML schedulers (``repro_torch.autotune``) and
the multi-tenant prediction service (``repro_torch.serving``), the amortized
hyper-parameter init (``repro_torch.amortize``: ``fit(init="amortized")``,
``hyper_init="amortized"``, its training) and the paper's Transformer
baseline (``repro_torch.baselines``: the curve transformer, its
pre-training through ``repro_torch.train``, the head-to-head against the
LKGP), the LM zoo's RWKV-6 family (``repro_torch.configs``,
``repro_torch.models.build_model``, served and trained by
``repro_torch.launch``), through the
``dense``, ``iterative``, ``cuda`` and ``distributed`` inference engines. On
the ``cuda`` engine every CG iteration of the fit's marginal likelihood and
of the posterior solves is one sweep of the hand-written latent-Kronecker
MVM kernels: the fused kernel (``kernels/csrc/lk_mvm_fused.cu``) or the
two-stage pair (``kernels/csrc/lk_mvm_two_stage.cu`` and
``lk_mvm_stage_left.cu``), whichever the route
tuner (``kernels/autotune.py``) timed faster at the sweep's shape bucket; a
route is named with ``make_mll_iterative(config, KernelMVM(fused=...))``. The
``distributed`` engine splits the grid's rows over a ``torch.distributed``
group, float32 row blocks through the row-shard kernel
(``kernels/csrc/lk_mvm_fused_rows.cu``); the RBF Gram kernel
(``kernels/csrc/rbf_gram.cu``) is reached through ``kernels.rbf_gram_op``.

Device rule: every entry point takes ``device=None`` and ``None`` means the
GPU. With no CUDA device present it raises; nothing silently carries on on
the CPU. Tests pass ``device="cpu"`` explicitly.
"""
from ._device import resolve_device
from .convert import (params_from_numpy, params_to_numpy, probes_from_numpy,
                      state_from_reference, tree_from_numpy, tree_to_numpy)
from .core import (DistributedEngine, LKGPConfig, LKGPParams, LKGPState,
                   Posterior, fit, get_engine, init_params, posterior)

__all__ = [
    "resolve_device", "params_from_numpy", "params_to_numpy",
    "probes_from_numpy", "state_from_reference", "tree_from_numpy",
    "tree_to_numpy",
    "DistributedEngine", "LKGPConfig", "LKGPParams", "LKGPState",
    "Posterior", "fit", "get_engine", "init_params", "posterior",
]
