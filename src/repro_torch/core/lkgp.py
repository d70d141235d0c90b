"""Latent Kronecker Gaussian Process (LKGP): the deprecated mutable facade.

Counterpart of ``repro.core.lkgp``. The model layer proper is functional:
:mod:`repro_torch.core.state` (immutable :class:`LKGPState`, ``fit`` /
``fit_batch`` / ``extend`` / ``refit``), :mod:`repro_torch.core.engines`
(the inference backends behind ``LKGPConfig.backend``) and
:mod:`repro_torch.core.posterior` (the lazy :class:`Posterior`). This module
re-exports that surface and keeps the original mutable :class:`LKGP` class
as a thin wrapper. Constructing one warns: it predates the immutable-state
design, so it bypasses the state-keyed posterior cache. Use::

    state = fit(X, t, Y, mask, LKGPConfig(backend="iterative"))
    mean, var = posterior(state).final()
"""
from __future__ import annotations

import warnings
from typing import Any

from .engines import (CustomMVMEngine, DenseEngine, DistributedEngine,
                      InferenceEngine, IterativeEngine, KernelEngine,
                      get_engine, list_backends, make_mll, make_mll_iterative,
                      mll_cholesky, register_engine)
from .posterior import Posterior, joint_grams, posterior
from .state import (GPData, LKGPConfig, LKGPParams, LKGPState, extend, fit,
                    fit_batch, gram_matrices, init_params, log_prior, refit,
                    resolve_backend, unstack)

__all__ = ["LKGPConfig", "LKGPParams", "LKGP", "LKGPState", "GPData",
           "init_params", "gram_matrices", "mll_cholesky",
           "make_mll_iterative", "make_mll", "log_prior", "fit", "fit_batch",
           "extend", "refit", "unstack", "resolve_backend", "Posterior",
           "posterior", "joint_grams", "InferenceEngine", "get_engine",
           "register_engine", "list_backends", "DenseEngine",
           "IterativeEngine", "KernelEngine", "DistributedEngine",
           "CustomMVMEngine"]

# Legacy names for the backends as reported by ``mll_method_used``.
_LEGACY_METHOD = {"dense": "cholesky"}


class LKGP:
    """User-facing model: fit on partial curves, predict continuations.

    X: (n, d) raw hyper-parameters; t: (m,) raw progressions (e.g. epochs,
    1-indexed); Y: (n, m) metric values; mask: (n, m) 1.0 where observed.
    ``device`` is passed to :func:`fit` (``None`` = the GPU).

    Thin facade over the functional API: ``fit`` stores an immutable
    :class:`LKGPState` in ``self.state``; inference delegates to
    :class:`Posterior`.
    """

    def __init__(self, config: LKGPConfig | None = None, device=None):
        warnings.warn(
            "LKGP is deprecated; use the functional API (fit / posterior "
            "from repro_torch.core). The facade bypasses the state-keyed "
            "posterior cache.", DeprecationWarning, stacklevel=2)
        self.config = config if config is not None else LKGPConfig()
        self.device = device
        self.state: LKGPState | None = None
        self.fit_result: Any = None
        self.mll_method_used: str | None = None

    # -- fitting ----------------------------------------------------------
    def fit(self, X, t, Y, mask, params0: LKGPParams | None = None) -> "LKGP":
        self.state = fit(X, t, Y, mask, self.config, params0=params0,
                         device=self.device)
        self.fit_result = getattr(self.state, "fit_result", None)
        backend = getattr(self.state, "backend_used", None)
        self.mll_method_used = _LEGACY_METHOD.get(backend, backend)
        return self

    # -- fitted-state accessors (legacy attribute surface) ----------------
    @property
    def params(self):
        return self.state.params if self.state is not None else None

    @property
    def x_tf(self):
        return self.state.x_tf if self.state is not None else None

    @property
    def t_tf(self):
        return self.state.t_tf if self.state is not None else None

    @property
    def y_tf(self):
        return self.state.y_tf if self.state is not None else None

    @property
    def _X(self):
        return None if self.state is None else self.state.x_tf(self.state.X)

    @property
    def _t(self):
        return None if self.state is None else self.state.t_tf(self.state.t)

    @property
    def _Y(self):
        return None if self.state is None else self.state.y_tf(self.state.Y)

    @property
    def _mask(self):
        return None if self.state is None else self.state.mask

    def _grams(self, Xs=None):
        return joint_grams(self.state, Xs)

    # -- inference --------------------------------------------------------
    def posterior(self, Xs=None) -> Posterior:
        """Lazy posterior (optionally over additional test configs Xs)."""
        return Posterior(self.state, Xs=Xs)

    def posterior_mean(self, Xs=None):
        """Exact posterior mean over the full grid, original y units."""
        return self.posterior(Xs).mean

    def posterior_samples(self, generator, Xs=None,
                          n_samples: int | None = None):
        """Matheron-rule posterior samples, original y units: (s, n(+n*), m)."""
        return self.posterior(Xs).samples(generator, n_samples)

    def predict_final(self, generator=None, n_samples: int | None = None):
        """(mean, var) of the final-progression value per training config."""
        return self.posterior().final(generator, n_samples)
