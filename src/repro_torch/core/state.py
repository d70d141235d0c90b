"""Immutable model state, its parameters, and fitting them.

Counterpart of ``repro.core.state``. A fitted model is an
:class:`LKGPState`: raw (log-space) GP parameters, the *raw* training data
and the fitted input/output transforms, plus a static :class:`LKGPConfig`.
It is consumed by every inference engine and by
:class:`~repro_torch.core.posterior.Posterior`.

:func:`fit` turns partially observed curves into a state: it maximises
(MLL + log prior) / N over the raw parameters with the host L-BFGS of
:mod:`repro_torch.core.lbfgs`, the MLL and its gradient coming from the
engine ``config.backend`` names. ``extend`` / ``refit`` / ``fit_batch``, the
fixed-budget device polish and the amortized init are not ported yet
(ROADMAP queue 1 items 6 and 13); a state fitted by the reference can also
be carried across with :func:`repro_torch.convert.state_from_reference`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, ClassVar, NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from . import gp_kernels as gk
from .errors import ObservationError, check_grid_columns, check_observed_finite
from .lbfgs import lbfgs_minimize
from .priors import noise_prior_logpdf, x_lengthscale_prior_logpdf
from .slq import rademacher_probes
from .transforms import TTransform, XTransform, YTransform

__all__ = [
    "LKGPParams", "LKGPConfig", "GPData", "LKGPState", "FitResult",
    "BACKENDS", "BACKEND_ALIASES", "init_params", "gram_matrices",
    "log_prior", "resolve_backend", "fit",
]

# "cuda" is the engine whose every MVM goes through the hand-written GPU
# kernels, on the route the tuner picks (K1, or K2a + K2b).
# The reference calls the same slot "pallas"; that name is accepted as an
# alias so a configuration carried across from the reference round-trips.
# "distributed" splits the grid's rows over a torch.distributed group.
BACKENDS = ("dense", "iterative", "cuda", "distributed")
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
    with every MVM routed through the GPU kernels on the tuner's route;
    ``"pallas"`` is an alias), ``"distributed"`` (block CG with the grid's rows split over a
    ``torch.distributed`` group, float32 row blocks through the row-shard
    kernel). ``"auto"`` resolves from the legacy ``mll_method`` /
    ``use_pallas`` fields and the observation count. Fields that belong to
    parts of the system not ported yet (the guarded solve ladder, the
    solvers ``pcg`` / ``sgd``) are carried but not read, and
    ``hyper_init="amortized"`` or ``polish_steps > 0`` make :func:`fit`
    raise ``NotImplementedError``.
    """
    t_kernel: str = "matern12"
    backend: str = "auto"           # "auto" | dense | iterative | cuda (alias: pallas) | distributed
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


def log_prior(params: LKGPParams, d: int) -> torch.Tensor:
    return (x_lengthscale_prior_logpdf(params.raw_x_lengthscale, d)
            + noise_prior_logpdf(params.raw_noise))


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

    :func:`fit` attaches ``fit_result`` (a :class:`FitResult`) and
    ``backend_used``, and ``engine`` where one was passed to it, with
    ``object.__setattr__``; read them with ``getattr(state, ..., None)``.
    :func:`repro_torch.core.posterior.posterior` attaches
    ``_posterior_cache`` the same way (the state-keyed solve cache): a state
    is never mutated otherwise, so a cached posterior cannot outlive the data
    whose solves it holds. Instances compare by identity.
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

    fit_result: ClassVar[Any]
    backend_used: ClassVar[str]
    engine: ClassVar[Any]

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


def _fit_transforms(X, t, Y, mask):
    return XTransform.fit(X), TTransform.fit(t), YTransform.fit(Y, mask)


class FitResult(NamedTuple):
    """Diagnostics of the optimisation that produced a state's params.

    ``x`` / ``fun`` / ``n_iters`` / ``n_evals`` / ``converged`` as the
    L-BFGS result; ``budget`` is the iteration cap the optimiser ran under,
    ``init_source`` where the starting point came from (``"default"`` |
    ``"params"``), ``optimizer`` the path taken (``"lbfgs"`` host loop,
    ``"none"`` for ``polish_steps=0``). ``converged`` reflects the gradient
    tolerance at the final iterate; ``n_iters == budget`` with
    ``converged=False`` means the budget bound first.
    """
    x: np.ndarray
    fun: float
    n_iters: int
    n_evals: int
    converged: bool
    budget: int
    init_source: str
    optimizer: str


def _flatten_params(p: LKGPParams) -> torch.Tensor:
    """(d + 3,) flat raw-parameter vector (the reference's field order)."""
    return torch.cat([p.raw_x_lengthscale,
                      p.raw_t_lengthscale.reshape(1),
                      p.raw_outputscale.reshape(1),
                      p.raw_noise.reshape(1)])


def _unflatten_params(x: torch.Tensor, d: int) -> LKGPParams:
    return LKGPParams(raw_x_lengthscale=x[:d], raw_t_lengthscale=x[d],
                      raw_outputscale=x[d + 1], raw_noise=x[d + 2])


_NOT_PORTED_INIT = ("ROADMAP queue 1 item 13 (amortize/): the amortized "
                    "hyper-parameter init is not ported yet")
_NOT_PORTED_POLISH = ("ROADMAP queue 1 item 6 (polish.py): the fixed-budget "
                      "device polish (polish_steps > 0) is not ported yet")


def _resolve_init(cfg: LKGPConfig, init, params0, amortizer, d: int, dtype,
                  device) -> tuple[LKGPParams, str]:
    """Starting parameters and their provenance, with the reference's
    precedence: explicit ``init`` > ``params0`` > a passed ``amortizer`` >
    ``cfg.hyper_init``."""
    if init is None:
        if params0 is not None:
            init = params0
        elif amortizer is not None:
            init = "amortized"
        else:
            init = cfg.hyper_init
    if isinstance(init, str):
        if init == "default":
            return init_params(d, dtype, device), "default"
        if init == "amortized":
            raise NotImplementedError(_NOT_PORTED_INIT)
        raise ValueError(f"unknown init {init!r}; expected 'default', "
                         "'amortized', or explicit LKGPParams")
    p = LKGPParams(*(torch.as_tensor(a, dtype=dtype, device=device)
                     for a in init))
    if p.raw_x_lengthscale.ndim != 1:
        raise ValueError(f"explicit init params have x-lengthscale ndim "
                         f"{p.raw_x_lengthscale.ndim}; expected 1")
    return p, "params"


def fit(X, t, Y, mask, config: LKGPConfig | None = None,
        params0: LKGPParams | None = None, engine=None, *,
        init=None, polish_steps: int | None = None, amortizer=None,
        device=None) -> LKGPState:
    """Fit the LKGP and return an immutable :class:`LKGPState`.

    Maximises (MLL + log prior) / N with L-BFGS on log-space parameters,
    through the engine selected by ``config.backend`` (or an explicitly
    provided ``engine``, which the state then keeps). ``X, t, Y, mask`` are
    arrays or tensors; the state's dtype is ``X``'s and everything lives on
    ``device`` (``None`` = the GPU).

    ``init`` selects the starting point: ``"default"`` (prior-mean init) or
    explicit :class:`LKGPParams`; unset, it falls back to ``params0`` and
    then ``config.hyper_init``. ``polish_steps`` overrides
    ``config.polish_steps``: ``-1`` runs the host L-BFGS for up to
    ``config.lbfgs_iters`` iterations, ``0`` skips optimisation (the init is
    the fit). ``init="amortized"``, an ``amortizer`` and ``polish_steps > 0``
    raise ``NotImplementedError`` (ROADMAP queue 1 items 13 and 6).
    Iterative engines draw ``config.slq_probes`` Rademacher probes once,
    from a ``torch.Generator`` on the device seeded with ``config.seed``.
    """
    from .engines import get_engine, make_mll

    cfg = config if config is not None else LKGPConfig()
    dev = resolve_device(device)
    budget = cfg.polish_steps if polish_steps is None else polish_steps
    if budget > 0:
        raise NotImplementedError(_NOT_PORTED_POLISH)
    X = torch.as_tensor(X, device=dev)
    dtype = X.dtype
    t = torch.as_tensor(t, dtype=dtype, device=dev)
    Y = torch.as_tensor(Y, dtype=dtype, device=dev)
    mask = torch.as_tensor(mask, dtype=dtype, device=dev)
    if Y.shape != mask.shape:
        raise ObservationError(
            f"Y shape {tuple(Y.shape)} does not match mask shape "
            f"{tuple(mask.shape)}")
    mask_host = mask.cpu().numpy()
    check_grid_columns(mask_host, t.shape[-1])
    check_observed_finite(Y.cpu().numpy(), mask_host)
    # Zero unobserved cells: every downstream use is masked, so this is a
    # no-op for finite payloads and makes NaN/inf there harmless.
    Y = torch.where(mask > 0, Y, torch.zeros_like(Y))

    x_tf, t_tf, y_tf = _fit_transforms(X, t, Y, mask)
    Xn, tn, Yn = x_tf(X), t_tf(t), y_tf(Y)

    d = X.shape[1]
    n_obs = int(mask_host.sum())
    explicit_engine = engine is not None
    backend = engine.name if explicit_engine else resolve_backend(cfg, n_obs)
    if engine is None:
        engine = get_engine(backend)

    probes = None
    if not engine.exact:
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        probes = rademacher_probes(gen, cfg.slq_probes, mask, dtype)

    p0, init_source = _resolve_init(cfg, init, params0, amortizer, d, dtype,
                                    dev)
    mll_fn = make_mll(cfg, engine)
    N = mask.sum()

    def objective(p: LKGPParams) -> torch.Tensor:
        return -(mll_fn(p, Xn, tn, Yn, mask, probes) + log_prior(p, d)) / N

    flat0 = _flatten_params(p0).detach()
    if budget == 0:
        with torch.no_grad():
            f0 = float(objective(p0))
        params = p0
        res = FitResult(x=flat0.cpu().numpy().astype(np.float64), fun=f0,
                        n_iters=0, n_evals=1, converged=False, budget=0,
                        init_source=init_source, optimizer="none")
    else:
        def value_and_grad(x: np.ndarray):
            xt = torch.as_tensor(x, device=dev).to(dtype).requires_grad_()
            f = objective(_unflatten_params(xt, d))
            (g,) = torch.autograd.grad(f, xt)
            return float(f.detach()), g.cpu().numpy().astype(np.float64)

        lb = lbfgs_minimize(value_and_grad,
                            flat0.cpu().numpy().astype(np.float64),
                            max_iters=cfg.lbfgs_iters)
        params = _unflatten_params(
            torch.as_tensor(lb.x, device=dev).to(dtype), d)
        res = FitResult(x=lb.x, fun=lb.fun, n_iters=lb.n_iters,
                        n_evals=lb.n_evals, converged=lb.converged,
                        budget=cfg.lbfgs_iters, init_source=init_source,
                        optimizer="lbfgs")
    state = LKGPState(params=params, X=X, t=t, Y=Y, mask=mask,
                      x_tf=x_tf, t_tf=t_tf, y_tf=y_tf, config=cfg)
    object.__setattr__(state, "fit_result", res)
    object.__setattr__(state, "backend_used", backend)
    if explicit_engine:
        # An injected engine is pinned, so posterior() keeps using it.
        object.__setattr__(state, "engine", engine)
    return state
