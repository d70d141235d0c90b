"""Immutable model state: parameters, configuration and training data.

Counterpart of the data-model half of ``repro.core.state``. A fitted model is
an :class:`LKGPState`: raw (log-space) GP parameters, the *raw* training data
and the fitted input/output transforms, plus a static :class:`LKGPConfig`.
It is consumed by every inference engine and by
:class:`~repro_torch.core.posterior.Posterior`.

The state transitions (``fit`` / ``extend`` / ``refit``) are not part of this
package yet; a state is carried across from the reference with
:func:`repro_torch.convert.state_from_reference`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from .._device import resolve_device
from . import gp_kernels as gk
from .transforms import TTransform, XTransform, YTransform

__all__ = [
    "LKGPParams", "LKGPConfig", "GPData", "LKGPState", "BACKENDS",
    "BACKEND_ALIASES", "init_params", "gram_matrices", "resolve_backend",
]

# "cuda" is the engine whose every MVM is the hand-written fused GPU kernel.
# The reference calls the same slot "pallas"; that name is accepted as an
# alias so a configuration carried across from the reference round-trips.
BACKENDS = ("dense", "iterative", "cuda")
BACKEND_ALIASES = {"pallas": "cuda"}


class LKGPParams(NamedTuple):
    """Raw (log-space) parameters; positive values are exp(raw)."""
    raw_x_lengthscale: torch.Tensor  # (d,)
    raw_t_lengthscale: torch.Tensor  # ()
    raw_outputscale: torch.Tensor    # ()
    raw_noise: torch.Tensor          # ()


@dataclass(frozen=True)
class LKGPConfig:
    """Model + inference configuration (same fields and defaults as the
    reference's ``LKGPConfig``, so ``dataclasses.asdict`` of one builds the
    other).

    ``backend`` selects the inference engine: ``"dense"`` (exact Cholesky),
    ``"iterative"`` (block CG on the plain tensor MVM), ``"cuda"`` (block CG
    with every MVM routed through the fused GPU kernel; ``"pallas"`` is an
    alias). ``"auto"`` resolves from the legacy ``mll_method`` /
    ``use_pallas`` fields and the observation count. Fields that belong to
    parts of the system not ported yet (SLQ, L-BFGS, polish, the guarded
    solve ladder) are carried but not read.
    """
    t_kernel: str = "matern12"
    backend: str = "auto"           # "auto" | dense | iterative | cuda (alias: pallas)
    mll_method: str = "auto"        # legacy: "cholesky" | "iterative" | "auto"
    auto_cholesky_max: int = 800    # N_obs threshold for "auto"
    cg_tol: float = 0.01            # paper App. B
    cg_max_iters: int = 10_000      # paper App. B
    precond_rank: int = 0           # >0 asks for PCG (not ported yet: raises)
    solver: str = "auto"            # "auto" | "cg" ("pcg" / "sgd" not ported yet)
    sgd_iters: int = 500
    sgd_momentum: float = 0.9
    sgd_lr: float = 0.0
    slq_probes: int = 16
    slq_iters: int = 25
    slq_via_cg: bool = True
    jitter: float = 1e-6
    lbfgs_iters: int = 100
    hyper_init: str = "default"
    polish_steps: int = -1
    posterior_samples: int = 64
    # Default cache policy for posterior(state): True lets repeated
    # posterior() calls on an UNCHANGED state share one lazy Posterior (and
    # therefore its cached K^{-1}[y|residuals] solves).
    posterior_cache: bool = True
    seed: int = 0
    use_pallas: bool = False        # legacy alias for backend="cuda"
    # Carried for round-tripping. Eager solves here always behave as
    # "strict": a degraded solve raises (see engines.IterativeEngine).
    solve_policy: str = "escalate"
    guard_retries: int = 3
    guard_jitter_max: float = 1e-2
    guard_dense_max: int = 4096


def init_params(d: int, dtype: torch.dtype = torch.float64,
                device=None) -> LKGPParams:
    """Initialise at prior means / paper defaults."""
    dev = resolve_device(device)
    return LKGPParams(
        raw_x_lengthscale=torch.full((d,), math.sqrt(2.0) + 0.5 * math.log(d),
                                     dtype=dtype, device=dev),
        raw_t_lengthscale=torch.tensor(math.log(0.25), dtype=dtype, device=dev),
        raw_outputscale=torch.tensor(0.0, dtype=dtype, device=dev),
        raw_noise=torch.tensor(-4.0, dtype=dtype, device=dev),
    )


def gram_matrices(params: LKGPParams, X: torch.Tensor, t: torch.Tensor,
                  t_kernel: str = "matern12", jitter: float = 1e-6):
    """K1 (n, n) over configs and K2 (m, m) over progressions (jittered)."""
    k2fn = gk.KERNELS_1D[t_kernel]
    K1 = gk.rbf_ard(X, X, torch.exp(params.raw_x_lengthscale))
    K2 = k2fn(t, t, torch.exp(params.raw_t_lengthscale),
              torch.exp(params.raw_outputscale))
    K1 = K1 + jitter * torch.eye(X.shape[0], dtype=K1.dtype, device=K1.device)
    K2 = K2 + jitter * torch.eye(t.shape[0], dtype=K2.dtype, device=K2.device)
    return K1, K2


class GPData(NamedTuple):
    """Transformed-space training data handed to an inference engine."""
    X: torch.Tensor          # (n, d) in the unit hypercube
    t: torch.Tensor          # (m,) log-scaled to [0, 1]
    Y: torch.Tensor | None   # (n, m) normalised curves (None when not needed)
    mask: torch.Tensor       # (n, m) 1.0 where observed


@dataclass(frozen=True, eq=False)
class LKGPState:
    """Immutable fitted model state.

    Data fields hold *raw* (untransformed) training data plus the fitted
    transforms and raw GP parameters, all tensors on one device; ``config``
    is static metadata. The transformed view engines consume is exposed via
    :attr:`data`. ``mask`` is a float 0/1 tensor, not bool.

    :func:`repro_torch.core.posterior.posterior` attaches
    ``_posterior_cache`` with ``object.__setattr__`` (the state-keyed solve
    cache): a state is never mutated otherwise, so a cached posterior cannot
    outlive the data whose solves it holds. Instances compare by identity.
    """
    params: LKGPParams
    X: torch.Tensor       # (n, d) raw hyper-parameters
    t: torch.Tensor       # (m,) raw progressions (e.g. epochs, 1-indexed)
    Y: torch.Tensor       # (n, m) raw metric values
    mask: torch.Tensor    # (n, m) 1.0 where observed
    x_tf: XTransform
    t_tf: TTransform
    y_tf: YTransform
    config: LKGPConfig = field(default_factory=LKGPConfig)

    @property
    def n(self) -> int:
        return self.X.shape[-2]

    @property
    def m(self) -> int:
        return self.t.shape[-1]

    @property
    def d(self) -> int:
        return self.X.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.X.device

    @property
    def data(self) -> GPData:
        """Transformed-space view of the training data (paper App. B)."""
        return GPData(self.x_tf(self.X), self.t_tf(self.t),
                      self.y_tf(self.Y), self.mask)

    def with_params(self, params: LKGPParams) -> "LKGPState":
        return dataclasses.replace(self, params=params)


def resolve_backend(config: LKGPConfig, n_obs: int) -> str:
    """Map config (including legacy fields and aliases) to an engine name."""
    if config.backend != "auto":
        name = BACKEND_ALIASES.get(config.backend, config.backend)
        if name == "distributed":
            raise NotImplementedError(
                "backend 'distributed' is not ported yet "
                "(ROADMAP queue 1 item 12, kernel K3)")
        if name not in BACKENDS:
            raise ValueError(f"unknown backend {config.backend!r}; expected "
                             f"one of {BACKENDS + tuple(BACKEND_ALIASES)}")
        return name
    if config.use_pallas:
        return "cuda"
    if config.mll_method == "cholesky":
        return "dense"
    if config.mll_method == "iterative":
        return "iterative"
    return "dense" if n_obs <= config.auto_cholesky_max else "iterative"
