"""Amortized hyper-parameter initialisation for the LKGP (counterpart of
``repro.amortize``).

A set encoder (:mod:`~repro_torch.amortize.encoder`, built from the curve
transformer's blocks) maps a masked task straight to the LKGP's
unconstrained parameter vector; ``fit(init="amortized")`` starts there and
needs only a fixed-budget polish (:mod:`repro_torch.core.polish`) instead of
a full host L-BFGS. Training (:mod:`~repro_torch.amortize.train`) is
self-supervised on synthetic task streams with the fit objective itself as
the loss. A pretrained mini-amortizer ships as a packaged fixture
(``fixtures/amortizer_d5.npz``, a byte-for-byte copy of the reference's) and
is what ``LKGPConfig(hyper_init="amortized")`` resolves to for d=5.
"""
from .encoder import (FIXTURE_DIR, Amortizer, AmortizerConfig,
                      clear_amortizer_registry, forward, forward_tasks,
                      get_amortizer, init_amortizer, param_table,
                      register_amortizer)
from .train import (AmortizeTrainConfig, AmortizerModel,
                    build_amortizer_model, sample_amortize_batch,
                    train_amortizer)

__all__ = [
    "Amortizer", "AmortizerConfig", "FIXTURE_DIR", "forward",
    "forward_tasks", "get_amortizer", "register_amortizer",
    "clear_amortizer_registry", "init_amortizer", "param_table",
    "AmortizeTrainConfig", "AmortizerModel", "build_amortizer_model",
    "sample_amortize_batch", "train_amortizer",
]
