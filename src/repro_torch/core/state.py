"""Immutable model state, its parameters, and fitting them.

Counterpart of ``repro.core.state``. A fitted model is an
:class:`LKGPState`: raw (log-space) GP parameters, the *raw* training data
and the fitted input/output transforms, plus a static :class:`LKGPConfig`.
It is consumed by every inference engine and by
:class:`~repro_torch.core.posterior.Posterior`.

:func:`fit` turns partially observed curves into a state: it maximises
(MLL + log prior) / N over the raw parameters with the host L-BFGS of
:mod:`repro_torch.core.lbfgs` or the fixed-budget polish of
:mod:`repro_torch.core.polish`, the MLL and its gradient coming from the
engine ``config.backend`` names. State transitions are functional:
``extend(state, ...)`` folds in new observations with warm-started
hyper-parameters, ``refit(state)`` re-optimises them, ``fit_batch`` fits a
batch of same-shaped tasks through the exact objective, and
``stack_states`` / ``unstack`` move between per-task and batched states.
The amortized init is not ported yet (ROADMAP queue 1 item 13); a state
fitted by the reference can also be carried across with
:func:`repro_torch.convert.state_from_reference`.
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
from .caching import LRUCache
from .errors import ObservationError, check_grid_columns, check_observed_finite
from .lbfgs import lbfgs_minimize
from .polish import make_polish
from .priors import noise_prior_logpdf, x_lengthscale_prior_logpdf
from .slq import rademacher_probes
from .transforms import TTransform, XTransform, YTransform

__all__ = [
    "LKGPParams", "LKGPConfig", "GPData", "LKGPState", "FitResult",
    "BACKENDS", "BACKEND_ALIASES", "init_params", "gram_matrices",
    "log_prior", "resolve_backend", "fit", "fit_batch", "extend", "refit",
    "unstack", "stack_states", "compiled_cache_stats",
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
    ``hyper_init="amortized"`` makes :func:`fit` raise
    ``NotImplementedError``.
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
    :func:`repro_torch.core.posterior.posterior` and ``posterior_batch``
    attach ``_posterior_cache`` / ``_posterior_batch_cache`` the same way
    (the state-keyed solve cache): a state is never mutated otherwise, so a
    cached posterior cannot outlive the data whose solves it holds.
    Instances compare by identity. A batched state (:func:`fit_batch`,
    :func:`stack_states`) has a leading task axis on every tensor.
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
    ``"polish"`` fixed-budget polish, ``"none"`` for ``polish_steps=0``).
    ``converged`` reflects the gradient tolerance at the final iterate;
    ``n_iters == budget`` with ``converged=False`` means the budget bound
    first.
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




# The fit objective's value and gradient, cached across fit / refit rounds.
# Key = the objective-relevant config fields + engine identity + parameter
# dim: a refit that only changes lbfgs_iters, seed or posterior_samples (they
# enter through arguments, not the objective) reuses the same function, and
# fit, the polish and fit_batch all optimise that one function. The engine
# is part of the key by object; get_engine returns singletons so it hits.
# Both caches are LRU-bounded with hit/miss/eviction counters
# (:func:`compiled_cache_stats`).
_VG_CACHE: LRUCache = LRUCache(64)
_POLISH_CACHE: LRUCache = LRUCache(64)
# Armijo ladder width of the polish, the reference's: every rung is
# evaluated each step, so an evaluation costs 1 + steps * 4.
_POLISH_BACKTRACKS = 4
_POLISH_GTOL = 1e-6


def compiled_cache_stats() -> dict:
    """Hit/miss/eviction counters of the objective caches."""
    return {"fit_vg": _VG_CACHE.stats(), "polish": _POLISH_CACHE.stats()}


def _objective_cache_key(cfg: LKGPConfig) -> tuple:
    return (cfg.t_kernel, cfg.backend, cfg.mll_method, cfg.auto_cholesky_max,
            cfg.cg_tol, cfg.cg_max_iters, cfg.precond_rank, cfg.solver,
            cfg.sgd_iters, cfg.sgd_momentum, cfg.sgd_lr, cfg.slq_probes,
            cfg.slq_iters, cfg.slq_via_cg, cfg.jitter, cfg.use_pallas)


def _cached_fit_vg(cfg: LKGPConfig, engine, d: int):
    """Value and gradient of the fit objective (MLL + log prior) / N.

    The returned function has the signature ``vg(params, Xn, tn, Yn, mask,
    probes) -> (value, grads)``, ``grads`` an :class:`LKGPParams`: all data
    enters as arguments (N is ``mask.sum()``), so same-shaped refits get the
    same function back. Each call differentiates on fresh leaves detached
    from ``params``; value and gradients come back detached.
    """
    from .engines import make_mll

    key = (_objective_cache_key(cfg), engine, d)
    vg = _VG_CACHE.get(key)
    if vg is None:
        mll_fn = make_mll(cfg, engine)

        def vg(params, Xn, tn, Yn, mask, probes):
            with torch.enable_grad():
                leaves = [a.detach().requires_grad_() for a in params]
                p = LKGPParams(*leaves)
                mll = mll_fn(p, Xn, tn, Yn, mask, probes)
                f = -(mll + log_prior(p, d)) / mask.sum()
                grads = torch.autograd.grad(f, leaves)
            return f.detach(), LKGPParams(*grads)

        _VG_CACHE[key] = vg
    return vg


def _cached_polish(cfg: LKGPConfig, engine, d: int, steps: int):
    """The fixed-budget polish of the objective ``_cached_fit_vg`` hands the
    host L-BFGS, one cached function per key. There is deliberately no
    batched variant: :func:`fit_batch` calls this one once per task, which
    keeps per-task results bitwise equal to a single-task :func:`fit` at
    every batch size."""
    key = (_objective_cache_key(cfg), engine, d, steps)
    fn = _POLISH_CACHE.get(key)
    if fn is None:
        vg = _cached_fit_vg(cfg, engine, d)

        def vg_flat(xf, Xn, tn, Yn, mask, probes):
            f, g = vg(_unflatten_params(xf, d), Xn, tn, Yn, mask, probes)
            return f, _flatten_params(g)

        fn = make_polish(vg_flat, steps=steps,
                         n_backtracks=_POLISH_BACKTRACKS)
        _POLISH_CACHE[key] = fn
    return fn


_NOT_PORTED_INIT = ("ROADMAP queue 1 item 13 (amortize/): the amortized "
                    "hyper-parameter init is not ported yet")


def _resolve_init(cfg: LKGPConfig, init, params0, amortizer, d: int, dtype,
                  device, batch: int | None = None
                  ) -> tuple[LKGPParams, str]:
    """Starting parameters and their provenance, with the reference's
    precedence: explicit ``init`` > ``params0`` > a passed ``amortizer`` >
    ``cfg.hyper_init``. Explicit params already in ``dtype`` on ``device``
    come back as the same tensors. With ``batch`` set the parameters carry
    a leading task axis."""
    if init is None:
        if params0 is not None:
            init = params0
        elif amortizer is not None:
            init = "amortized"
        else:
            init = cfg.hyper_init
    if isinstance(init, str):
        if init == "default":
            p = init_params(d, dtype, device)
            if batch is not None:
                p = LKGPParams(*(a.expand(batch, *a.shape).clone()
                                 for a in p))
            return p, "default"
        if init == "amortized":
            raise NotImplementedError(_NOT_PORTED_INIT)
        raise ValueError(f"unknown init {init!r}; expected 'default', "
                         "'amortized', or explicit LKGPParams")
    p = LKGPParams(*(torch.as_tensor(a, dtype=dtype, device=device)
                     for a in init))
    want = 1 if batch is None else 2
    if p.raw_x_lengthscale.ndim != want:
        raise ValueError(
            f"explicit init params have x-lengthscale ndim "
            f"{p.raw_x_lengthscale.ndim}; expected {want} for this "
            f"{'batched ' if batch else ''}fit")
    return p, "params"


def _polish_fit(cfg: LKGPConfig, engine, d: int, dtype, budget: int,
                init_source: str, p0: LKGPParams, Xn, tn, Yn, mask, probes):
    """Fixed-budget polish (or the ``budget == 0`` no-op) for ``fit``."""
    flat0 = _flatten_params(p0).to(dtype).detach()
    if budget == 0:
        f0, _ = _cached_fit_vg(cfg, engine, d)(p0, Xn, tn, Yn, mask, probes)
        res = FitResult(x=flat0.cpu().numpy(), fun=float(f0), n_iters=0,
                        n_evals=1, converged=False, budget=0,
                        init_source=init_source, optimizer="none")
        return p0, res
    pol = _cached_polish(cfg, engine, d, budget)
    pr = pol(flat0, Xn, tn, Yn, mask, probes)
    params = _unflatten_params(pr.x, d)
    res = FitResult(x=pr.x.cpu().numpy(), fun=float(pr.fun), n_iters=budget,
                    n_evals=1 + budget * _POLISH_BACKTRACKS,
                    converged=bool(pr.grad_inf < _POLISH_GTOL),
                    budget=budget, init_source=init_source,
                    optimizer="polish")
    return params, res


def _observations(Y, mask, m: int, names=("Y", "mask")) -> torch.Tensor:
    """Validate a payload on the host (one read) and zero its unobserved
    cells: every downstream use is masked, so this is a no-op for finite
    payloads and makes NaN/inf there harmless. ``names`` are the payload's
    names in the errors (``("new_Y", "new_mask")`` for :func:`extend`)."""
    y_name, mask_name = names
    if Y.shape != mask.shape:
        raise ObservationError(
            f"{y_name} shape {tuple(Y.shape)} does not match {mask_name} "
            f"shape {tuple(mask.shape)}")
    mask_host = mask.cpu().numpy()
    check_grid_columns(mask_host, m, what=mask_name)
    check_observed_finite(Y.cpu().numpy(), mask_host, what=y_name)
    return torch.where(mask > 0, Y, torch.zeros_like(Y))


def fit(X, t, Y, mask, config: LKGPConfig | None = None,
        params0: LKGPParams | None = None, engine=None, *,
        init=None, polish_steps: int | None = None, amortizer=None,
        device=None) -> LKGPState:
    """Fit the LKGP and return an immutable :class:`LKGPState`.

    Maximises (MLL + log prior) / N on log-space parameters, through the
    engine selected by ``config.backend`` (or an explicitly provided
    ``engine``, which the state then keeps). ``X, t, Y, mask`` are arrays or
    tensors; the state's dtype is ``X``'s and everything lives on ``device``
    (``None`` = the GPU).

    ``init`` selects the starting point: ``"default"`` (prior-mean init) or
    explicit :class:`LKGPParams`; unset, it falls back to ``params0`` and
    then ``config.hyper_init``. ``polish_steps`` is a one-call override of
    ``config.polish_steps``: ``-1`` runs the host L-BFGS for up to
    ``config.lbfgs_iters`` iterations, ``0`` skips optimisation (the init is
    the fit, bitwise), ``k > 0`` runs exactly ``k`` steps of the fixed-budget
    polish (:mod:`repro_torch.core.polish`, ``1 + 4 k`` evaluations).
    ``init="amortized"`` and an ``amortizer`` raise ``NotImplementedError``
    (ROADMAP queue 1 item 13). Iterative engines draw ``config.slq_probes``
    Rademacher probes once, from a ``torch.Generator`` on the device seeded
    with ``config.seed``.
    """
    from .engines import get_engine

    cfg = config if config is not None else LKGPConfig()
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    dtype = X.dtype
    t = torch.as_tensor(t, dtype=dtype, device=dev)
    Y = torch.as_tensor(Y, dtype=dtype, device=dev)
    mask = torch.as_tensor(mask, dtype=dtype, device=dev)
    Y = _observations(Y, mask, t.shape[-1])

    x_tf, t_tf, y_tf = _fit_transforms(X, t, Y, mask)
    Xn, tn, Yn = x_tf(X), t_tf(t), y_tf(Y)

    d = X.shape[1]
    n_obs = int(mask.sum().item())
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
    budget = cfg.polish_steps if polish_steps is None else polish_steps

    if budget >= 0:
        params, res = _polish_fit(cfg, engine, d, dtype, budget, init_source,
                                  p0, Xn, tn, Yn, mask, probes)
    else:
        vg = _cached_fit_vg(cfg, engine, d)

        def value_and_grad(x: np.ndarray):
            p = _unflatten_params(torch.as_tensor(x, device=dev).to(dtype), d)
            f, g = vg(p, Xn, tn, Yn, mask, probes)
            return float(f), _flatten_params(g).cpu().numpy().astype(
                np.float64)

        flat0 = _flatten_params(p0).detach()
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
        # An injected engine is pinned, so posterior() / refit() / extend()
        # keep using it.
        object.__setattr__(state, "engine", engine)
    return state


def _stack(objs):
    """Stack NamedTuples of tensors field by field (leading task axis)."""
    return type(objs[0])(*(torch.stack(fs) for fs in zip(*objs)))


def fit_batch(X, t, Y, mask, config: LKGPConfig | None = None,
              params0: LKGPParams | None = None, *,
              init=None, polish_steps: int | None = None,
              amortizer=None, device=None) -> LKGPState:
    """Fit B independent tasks through the exact ``dense`` objective.

    X: (B, n, d); t: (m,) or (B, m); Y, mask: (B, n, m). All tasks share
    shapes. Returns an :class:`LKGPState` whose data leaves carry a leading
    task axis; :func:`unstack` splits it into per-task states.

    The input/output transforms are fitted and applied per task. With
    ``polish_steps=k >= 0`` each task runs the single-task fixed-budget
    polish of :func:`fit` on the ``dense`` engine from its init, one call
    per task, so task i's parameters are bitwise those of ``fit(task_i,
    LKGPConfig(backend="dense"), polish_steps=k)``. With the default ``-1``
    one host L-BFGS runs on the sum of the per-task objectives over the
    concatenated parameter vector (the reference's flat layout: every
    task's x-lengthscales, then the t-lengthscales, outputscales, noises).
    """
    from .engines import get_engine, mll_cholesky

    cfg = config if config is not None else LKGPConfig()
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    dtype = X.dtype
    B, n, d = X.shape
    t = torch.as_tensor(t, dtype=dtype, device=dev)
    if t.ndim == 1:
        t = t.expand(B, t.shape[0]).contiguous()
    Y = torch.as_tensor(Y, dtype=dtype, device=dev)
    mask = torch.as_tensor(mask, dtype=dtype, device=dev)
    Y = _observations(Y, mask, t.shape[-1])

    # Per task, on fresh copies: the single-task arithmetic of fit() on
    # tensors of their own (a slice's offset can steer a library routine
    # to another kernel), so the polish below matches fit() bitwise.
    tasks = [tuple(a[i].clone() for a in (X, t, Y, mask)) for i in range(B)]
    tfs = [_fit_transforms(*task) for task in tasks]
    data = [(x_tf(Xi), t_tf(ti), y_tf(Yi), mi)
            for (x_tf, t_tf, y_tf), (Xi, ti, Yi, mi) in zip(tfs, tasks)]
    x_tf, t_tf, y_tf = (_stack(list(f)) for f in zip(*tfs))

    p0, init_source = _resolve_init(cfg, init, params0, amortizer, d, dtype,
                                    dev, batch=B)
    budget = cfg.polish_steps if polish_steps is None else polish_steps

    if budget >= 0:
        engine = get_engine("dense")
        flat0 = [_flatten_params(LKGPParams(*(a[i] for a in p0))).to(dtype)
                 for i in range(B)]
        if budget == 0:
            vg = _cached_fit_vg(cfg, engine, d)
            fs = [vg(_unflatten_params(flat0[i], d), *data[i], None)[0]
                  for i in range(B)]
            params = p0
            res = FitResult(x=torch.stack(flat0).cpu().numpy(),
                            fun=float(sum(float(f) for f in fs)),
                            n_iters=0, n_evals=B, converged=False, budget=0,
                            init_source=init_source, optimizer="none")
        else:
            pol = _cached_polish(cfg, engine, d, budget)
            prs = [pol(flat0[i], *data[i], None) for i in range(B)]
            xs = torch.stack([pr.x for pr in prs])
            params = LKGPParams(xs[:, :d], xs[:, d], xs[:, d + 1],
                                xs[:, d + 2])
            res = FitResult(
                x=xs.cpu().numpy(),
                fun=float(sum(float(pr.fun) for pr in prs)),
                n_iters=budget,
                n_evals=B * (1 + budget * _POLISH_BACKTRACKS),
                converged=all(float(pr.grad_inf) < _POLISH_GTOL
                              for pr in prs),
                budget=budget, init_source=init_source, optimizer="polish")
    else:
        def unravel(x):
            return LKGPParams(x[:B * d].reshape(B, d), x[B * d:B * (d + 1)],
                              x[B * (d + 1):B * (d + 2)], x[B * (d + 2):])

        def objective(pb):
            total = 0.0
            for i, (Xi, ti, Yi, mi) in enumerate(data):
                p = LKGPParams(*(a[i] for a in pb))
                mll = mll_cholesky(p, Xi, ti, Yi, mi, cfg.t_kernel,
                                   cfg.jitter)
                total = total - (mll + log_prior(p, d)) / mi.sum()
            return total

        def value_and_grad(x: np.ndarray):
            xt = torch.as_tensor(x, device=dev).to(dtype).requires_grad_()
            f = objective(unravel(xt))
            (g,) = torch.autograd.grad(f, xt)
            return float(f.detach()), g.cpu().numpy().astype(np.float64)

        flat0 = torch.cat([a.reshape(-1) for a in p0]).detach()
        lb = lbfgs_minimize(value_and_grad,
                            flat0.cpu().numpy().astype(np.float64),
                            max_iters=cfg.lbfgs_iters)
        params = unravel(torch.as_tensor(lb.x, device=dev).to(dtype))
        res = FitResult(x=lb.x, fun=lb.fun, n_iters=lb.n_iters,
                        n_evals=lb.n_evals, converged=lb.converged,
                        budget=cfg.lbfgs_iters, init_source=init_source,
                        optimizer="lbfgs")
    state = LKGPState(params=params, X=X, t=t, Y=Y, mask=mask,
                      x_tf=x_tf, t_tf=t_tf, y_tf=y_tf, config=cfg)
    object.__setattr__(state, "fit_result", res)
    object.__setattr__(state, "backend_used", "dense")
    return state


def _map_state(fn, *states: LKGPState) -> LKGPState:
    """A new state whose every tensor is ``fn`` of the corresponding tensors
    of ``states`` (the reference's ``tree_map`` over a state: the config of
    the first, no attached attributes)."""
    def tup(field):
        objs = [getattr(s, field) for s in states]
        return type(objs[0])(*(fn(*fs) for fs in zip(*objs)))

    return LKGPState(params=tup("params"),
                     **{k: fn(*(getattr(s, k) for s in states))
                        for k in ("X", "t", "Y", "mask")},
                     x_tf=tup("x_tf"), t_tf=tup("t_tf"), y_tf=tup("y_tf"),
                     config=states[0].config)


def unstack(state: LKGPState) -> list[LKGPState]:
    """Split a batched state from :func:`fit_batch` into per-task states,
    every tensor a fresh copy of its own (a slice's offset can steer a
    library routine to another kernel)."""
    return [_map_state(lambda a, i=i: a[i].clone(), state)
            for i in range(state.X.shape[0])]


def stack_states(states: list[LKGPState]) -> LKGPState:
    """Stack same-shaped per-task states into one batched state.

    The inverse of :func:`unstack`: every tensor (params, data, transforms)
    gains a leading task axis, giving a state that
    :func:`~repro_torch.core.posterior.posterior_batch` accepts. All states
    must share shapes and an identical ``config``.
    """
    if not states:
        raise ValueError("stack_states needs at least one state")
    first = states[0]
    for i, st in enumerate(states):
        if st.config != first.config:
            raise ValueError(f"state {i} has a different config than state 0"
                             " — coalesced states must share one config")
        if st.X.ndim != 2:
            raise ValueError(f"state {i} is already batched "
                             f"(X ndim {st.X.ndim}); stack unbatched states")
        if (st.X.shape != first.X.shape or st.t.shape != first.t.shape
                or st.Y.shape != first.Y.shape):
            raise ValueError(
                f"state {i} shapes (X {tuple(st.X.shape)}, t "
                f"{tuple(st.t.shape)}, Y {tuple(st.Y.shape)}) do not match "
                f"state 0 (X {tuple(first.X.shape)}, t "
                f"{tuple(first.t.shape)}, Y {tuple(first.Y.shape)})")
    return _map_state(lambda *leaves: torch.stack(leaves), *states)


def extend(state: LKGPState, new_Y, new_mask, new_X=None) -> LKGPState:
    """Incremental conditioning: fold new observations into the state.

    Two modes:

    * ``new_X is None``: ``new_Y`` / ``new_mask`` are the *full updated*
      (n, m) grids over the existing configs (e.g. a freeze-thaw scheduler
      observed more epochs). ``new_mask`` must be a superset of
      ``state.mask`` (checked with one host read).
    * ``new_X`` given: k new configs are appended; ``new_Y`` / ``new_mask``
      are their (k, m) rows.

    The input and output transforms are refit on the union of the data; the
    fitted hyper-parameters are carried over unchanged as a warm start
    (follow with :func:`refit`). New tensors go to ``state.device``. An
    engine bound by ``fit`` is carried on; ``fit_result`` and
    ``backend_used`` are cleared (they described the pre-extend fit), and
    the new state's posterior cache starts cold.
    """
    dtype, dev = state.Y.dtype, state.device
    new_Y = torch.as_tensor(new_Y, dtype=dtype, device=dev)
    new_mask = torch.as_tensor(new_mask, dtype=dtype, device=dev)
    new_Y = _observations(new_Y, new_mask, state.m, ("new_Y", "new_mask"))

    if new_X is None:
        if new_Y.shape != state.Y.shape:
            raise ValueError(f"full-grid update expects shape "
                             f"{tuple(state.Y.shape)}, got "
                             f"{tuple(new_Y.shape)}")
        if bool((new_mask < state.mask).any().item()):
            raise ValueError("new_mask must be a superset of the current mask")
        X, Y, mask = state.X, new_Y, new_mask
    else:
        new_X = torch.as_tensor(new_X, dtype=state.X.dtype, device=dev)
        X = torch.cat([state.X, new_X], dim=0)
        Y = torch.cat([state.Y, new_Y], dim=0)
        mask = torch.cat([state.mask, new_mask], dim=0)

    x_tf, _, y_tf = _fit_transforms(X, state.t, Y, mask)
    out = dataclasses.replace(state, X=X, Y=Y, mask=mask,
                              x_tf=x_tf, y_tf=y_tf)
    eng = getattr(state, "engine", None)
    if eng is not None:
        object.__setattr__(out, "engine", eng)
    object.__setattr__(out, "fit_result", None)
    object.__setattr__(out, "backend_used", None)
    return out


def refit(state: LKGPState, config: LKGPConfig | None = None,
          lbfgs_iters: int | None = None, engine=None, *,
          init=None, polish_steps: int | None = None,
          amortizer=None) -> LKGPState:
    """Re-optimise hyper-parameters warm-started from ``state.params``, on
    the state's device.

    ``lbfgs_iters`` and ``polish_steps`` are one-call budget overrides: they
    do NOT persist into the returned state's config. An engine bound by the
    original ``fit`` is reused unless a new one is given. The starting point
    defaults to ``state.params``; with ``init=<params>`` and
    ``polish_steps=0`` the given params round-trip bitwise.
    ``init="amortized"``, ``hyper_init="amortized"`` and an ``amortizer``
    raise ``NotImplementedError`` (ROADMAP queue 1 item 13).
    """
    base_cfg = config if config is not None else state.config
    cfg = base_cfg
    if lbfgs_iters is not None:
        cfg = dataclasses.replace(cfg, lbfgs_iters=lbfgs_iters)
    if engine is None:
        engine = getattr(state, "engine", None)
    if init is None and amortizer is None and cfg.hyper_init != "amortized":
        init = state.params
    out = fit(state.X, state.t, state.Y, state.mask, cfg,
              engine=engine, init=init, polish_steps=polish_steps,
              amortizer=amortizer, device=state.device)
    if cfg is not base_cfg:
        diag = {k: getattr(out, k, None)
                for k in ("fit_result", "backend_used", "engine")}
        out = dataclasses.replace(out, config=base_cfg)
        for k, v in diag.items():
            if v is not None:
                object.__setattr__(out, k, v)
    return out
