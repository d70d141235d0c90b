"""Lazy posterior over the latent grid, behind one ``PosteriorLike`` API.

Counterpart of ``repro.core.posterior``: the lazy, engine-backed
:class:`Posterior` and the exact dense :class:`BatchedPosterior` over a batch
of tasks (from :func:`~repro_torch.core.state.fit_batch` or
:func:`~repro_torch.core.state.stack_states`).

A :class:`Posterior` is cheap to construct: nothing is computed until a
property is read. The expensive CG solve of ``alpha = K^{-1} (Y * mask)``
is computed once and cached, then shared between

* the exact posterior mean  ``K1[:, :n] @ alpha @ K2``  and
* Matheron-rule samples: by linearity,
  ``K^{-1}(Y - F - eps) = alpha - K^{-1}(F + eps)``, so each sampling call
  only solves for the (F + eps) part and reuses the cached ``alpha``.

Solves are consolidated: if samples are requested before ``alpha`` exists,
the posterior stacks ``[Y * mask | Matheron residuals]`` into ONE multi-RHS
block solve, so a full posterior evaluation (``final()``: exact mean +
Matheron variance) costs a single batched operator sweep instead of two.
The block solver's per-column diagnostics from the most recent solve are
exposed as :attr:`Posterior.solve_info`; :attr:`Posterior.solve_count`
counts the engine solves this posterior has performed.

Caching is *state-keyed*: :func:`posterior` attaches the lazy posterior to
the state instance itself, so repeated ``posterior(state)`` calls on an
unchanged state return the SAME object and reuse its resident solves.

:class:`BatchedPosterior` computes each task with one single-task function
called once per task, and stacks the results: a task's mean and exact final
values are then the same bits whatever batch it came in (the serving
guarantee that per-request equals coalesced), because no library call sees
the batch size.

Randomness: where the reference takes a PRNG key, this module takes a
``torch.Generator`` on the state's device. The default sample stream and
``final()``'s fallback stream are two distinct generators seeded from
``(config.seed, 1)`` and ``(config.seed, 2)``.
"""
from __future__ import annotations

import threading
from functools import cached_property
from typing import Any, Protocol, runtime_checkable

import torch

from .._device import check_on_device, resolve_device
from . import gp_kernels as gk
from .engines import get_engine
from .matheron import kronecker_correction, prior_residual_draws
from .mvm import kron_dense
from .state import LKGPState, resolve_backend, unstack

__all__ = ["PosteriorLike", "Posterior", "posterior", "joint_grams",
           "BatchedPosterior", "posterior_batch"]


@runtime_checkable
class PosteriorLike(Protocol):
    """One posterior interface for lazy and batched implementations.

    ``mean`` / ``variance`` cover the full grid (original y units);
    ``samples`` draws posterior functions; ``final`` returns the
    final-progression (mean, var) per config; ``solve_info`` surfaces the
    most recent solver diagnostics (None for exact paths that have none).
    """

    @property
    def mean(self) -> torch.Tensor: ...

    @property
    def variance(self) -> torch.Tensor: ...

    @property
    def solve_info(self) -> Any: ...

    def samples(self, generator, n_samples: int | None = None) -> torch.Tensor: ...

    def final(self, generator=None, n_samples: int | None = None): ...


def _stream(seed: int, tag: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for the random stream ``(seed, tag)``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 8) + int(tag))
    return g


def joint_grams(state: LKGPState, Xs=None, dtype: torch.dtype | None = None):
    """K1 over [X_train; X_test] (transformed) and K2 over t (jittered).

    Matches the training-time Gram construction: K2 carries the jitter, the
    joint K1 does not (its train block is only used inside the noisy
    operator; Cholesky call sites add jitter themselves). ``dtype`` computes
    the Grams in another dtype from the inputs transformed in the state's.
    """
    cfg = state.config
    p = state.params
    Xn = state.x_tf(state.X)
    tn = state.t_tf(state.t)
    if Xs is not None:
        Xs = torch.as_tensor(Xs, dtype=Xn.dtype, device=Xn.device)
        Xn = torch.cat([Xn, state.x_tf(Xs)], 0)
    if dtype is not None:
        Xn, tn = Xn.to(dtype), tn.to(dtype)
        p = type(p)(*(x.to(dtype) for x in p))
    K2 = gk.KERNELS_1D[cfg.t_kernel](
        tn, tn, torch.exp(p.raw_t_lengthscale), torch.exp(p.raw_outputscale))
    K2 = K2 + cfg.jitter * torch.eye(tn.shape[0], dtype=K2.dtype,
                                     device=K2.device)
    K1a = gk.rbf_ard(Xn, Xn, torch.exp(p.raw_x_lengthscale))
    return K1a, K2


class Posterior:
    """Lazy LKGP posterior over the full (train [+ test]) x t grid.

    Rows ``[:n]`` of every product are curve continuations for the training
    configs; if ``Xs`` was given, rows ``[n:]`` are predictions for the new
    configs. All outputs are in original y units, on the state's device.
    """

    def __init__(self, state: LKGPState, Xs=None, engine=None):
        self._state = state
        self._Xs = Xs
        if engine is None:
            # An engine injected at fit() time stays with its state.
            engine = getattr(state, "engine", None)
        if engine is None:
            n_obs = int(state.mask.sum().item())
            engine = get_engine(resolve_backend(state.config, n_obs))
        self._engine = engine
        self._alpha: torch.Tensor | None = None   # cached K^{-1}(Y*mask)
        self._solve_info: Any = None  # CGResult of most recent engine solve
        self._n_solves = 0            # engine solves performed (sweeps run)

    # -- cached pieces -----------------------------------------------------
    @cached_property
    def _grams(self):
        return joint_grams(self._state, self._Xs)

    @cached_property
    def _draw_grams(self):
        """The joint Grams whose Cholesky factors make the Matheron prior
        draws: the state's own for a float64 state; for a float32 one, the
        same computed in float64 from its transformed inputs. A float32 K1
        near 1 everywhere (the prior-mean lengthscales) is indefinite by more
        than the 1e-6 jitter once n reaches a few hundred, rounded to float64
        or not, so its Cholesky fails (the reference's float32 final() fails
        there); the Gram of the same inputs computed in float64 is positive
        definite. The draws are cast back to the state's dtype."""
        if self._state.X.dtype == torch.float64:
            return self._grams
        return joint_grams(self._state, self._Xs, dtype=torch.float64)

    @cached_property
    def _noise(self) -> torch.Tensor:
        return torch.exp(self._state.params.raw_noise)

    @cached_property
    def _operator(self):
        """A = P (K1 (x) K2) P^T + sigma^2 I over the training block."""
        K1a, K2 = self._grams
        n = self._state.n
        return self._engine.operator_from_grams(
            K1a[:n, :n], K2, self._state.mask, self._noise)

    def _solve(self, rhs):
        """Engine solve capturing the block solver's diagnostics."""
        x = self._engine.solve(self._operator, rhs, self._state.config)
        self._solve_info = getattr(self._operator, "last_result", None)
        self._n_solves += 1
        return x

    @property
    def alpha(self):
        """Cached K^{-1} (Y * mask) in transformed space (grid form)."""
        if self._alpha is None:
            st = self._state
            Ym = st.y_tf(st.Y) * st.mask
            self._alpha = self._solve(Ym)
        return self._alpha

    @property
    def solve_info(self):
        """Diagnostics (:class:`repro_torch.core.solvers.CGResult`) of the
        most recent solve through this posterior - per-column iterations,
        true residuals, and breakdown flags - or None before any solve (or
        for engines that do not report them, e.g. the exact dense solve)."""
        return self._solve_info

    @property
    def solve_count(self) -> int:
        """Number of engine solves (batched operator sweeps) this posterior
        has run. A state-cache hit returns the same posterior object, so a
        repeated evaluation leaves this counter unchanged."""
        return self._n_solves

    # -- products ----------------------------------------------------------
    @property
    def mean(self) -> torch.Tensor:
        """Exact posterior mean over the grid: (n(+n*), m), y units."""
        K1a, K2 = self._grams
        n = self._state.n
        mean_t = K1a[:, :n] @ self.alpha @ K2
        return self._state.y_tf.inverse(mean_t)

    def samples(self, generator, n_samples: int | None = None, *,
                normals=None) -> torch.Tensor:
        """Matheron-rule posterior samples: (s, n(+n*), m), y units.

        If ``alpha`` is not cached yet, ``[Y * mask | residuals]`` are
        stacked into ONE multi-RHS block solve (a single batched operator
        sweep yields the exact mean's alpha AND every sample); afterwards
        samples reuse the cached alpha and only solve the residual part.
        ``normals=(Z, E)`` supplies the standard-normal draws instead of
        ``generator`` (see :func:`prior_residual_draws`).
        """
        st = self._state
        cfg = st.config
        n_samples = n_samples or cfg.posterior_samples
        K1a, K2 = self._grams
        n = st.n
        K1d, K2d = self._draw_grams
        F, eps = prior_residual_draws(generator, K1d, K2d, n,
                                      self._noise.to(K1d.dtype), n_samples,
                                      jitter=cfg.jitter, normals=normals)
        F, eps = F.to(K1a.dtype), eps.to(K1a.dtype)
        resid = st.mask * (F[:, :n, :] + eps)
        if self._alpha is None:
            Ym = st.y_tf(st.Y) * st.mask
            sol = self._solve(torch.cat([Ym[None], resid], dim=0))
            self._alpha = sol[0]
            u = sol[0][None] - sol[1:]
        else:
            # Linearity: K^{-1}(Y - F - eps) = alpha - K^{-1}(F + eps).
            u = self._alpha[None] - self._solve(resid)
        raw = F + kronecker_correction(K1a, u, K2, n)
        return st.y_tf.inverse(raw)

    @cached_property
    def _default_samples(self):
        # Stream tag 1: the cached default-sample stream. final()'s
        # explicit-count fallback uses tag 2 so the two paths never share
        # randomness.
        st = self._state
        return self.samples(_stream(st.config.seed, 1, st.device))

    @property
    def variance(self) -> torch.Tensor:
        """Predictive variance (Matheron MC estimate + observation noise)."""
        st = self._state
        var_f = self._default_samples.var(dim=0, unbiased=False)
        return var_f + st.y_tf.inverse_var(self._noise)

    def final(self, generator=None, n_samples: int | None = None, *,
              normals=None):
        """(mean, var) of the final-progression value per config.

        Mean is exact (cached CG solve); variance is estimated from Matheron
        samples plus observation noise - the Fig. 4 protocol.
        """
        st = self._state
        # Samples first: on a fresh posterior this folds the alpha solve and
        # the Matheron residual solves into ONE stacked operator sweep; the
        # mean below then reads the alpha cached by that same solve.
        if generator is None and n_samples is None and normals is None:
            s = self._default_samples[:, :, -1]   # cached; same default stream
        else:
            if generator is None and normals is None:
                # tag 2: distinct from the _default_samples stream (tag 1).
                generator = _stream(st.config.seed, 2, st.device)
            s = self.samples(generator, n_samples, normals=normals)[:, :, -1]
        mean = self.mean[:, -1]
        var_f = s.var(dim=0, unbiased=False)
        var_y = var_f + st.y_tf.inverse_var(self._noise)
        return mean, var_y


# -- state-keyed solve cache -----------------------------------------------
# The cached posterior lives ON the state instance, so its lifetime is exactly
# the state's: a new state object starts cold, dropping a state drops its
# solves with it. The lock only guards the get-or-create so concurrent
# serving threads share one posterior.
_CACHE_ATTR = "_posterior_cache"
_BATCH_CACHE_ATTR = "_posterior_batch_cache"
_CACHE_LOCK = threading.Lock()


def _state_cached(state, attr: str, build):
    with _CACHE_LOCK:
        post = getattr(state, attr, None)
        if post is None:
            post = build()
            object.__setattr__(state, attr, post)
        return post


def posterior(state: LKGPState, Xs=None, engine=None,
              cache: bool | None = None, *, device=None) -> Posterior:
    """Lazy posterior for a fitted state (optionally at new configs Xs).

    ``device=None`` means the GPU: the state must live there, and with no
    CUDA device this raises. A state built on the CPU is served only when
    ``device="cpu"`` says so.

    ``cache=None`` (default) consults ``state.config.posterior_cache``:
    when on, repeated calls on the same state object return ONE shared
    :class:`Posterior` whose solves are resident - the second call performs
    zero additional operator sweeps. Explicit ``Xs`` / ``engine`` arguments
    always bypass the cache (their results are not state-determined);
    ``cache=False`` forces a fresh posterior; ``cache=True`` demands the
    cached one and raises if the call is not cacheable.
    """
    check_on_device(resolve_device(device), X=state.X, Y=state.Y,
                    mask=state.mask, t=state.t)
    cacheable = Xs is None and engine is None
    if cache is None:
        cache = cacheable and state.config.posterior_cache
    elif cache and not cacheable:
        raise ValueError("cache=True requires the state-determined "
                         "posterior: no explicit Xs or engine")
    if not cache:
        return Posterior(state, Xs=Xs, engine=engine)
    return _state_cached(state, _CACHE_ATTR, lambda: Posterior(state))


# -- batched exact posterior (one single-task call per task) ---------------
def _task_grams(st: LKGPState):
    """Transformed data and Grams of one unbatched task (K2 jittered, K1
    not, as :func:`joint_grams`)."""
    cfg, p = st.config, st.params
    Xn, tn, Yn = st.x_tf(st.X), st.t_tf(st.t), st.y_tf(st.Y)
    m = tn.shape[0]
    K2 = gk.KERNELS_1D[cfg.t_kernel](
        tn, tn, torch.exp(p.raw_t_lengthscale), torch.exp(p.raw_outputscale))
    K2 = K2 + cfg.jitter * torch.eye(m, dtype=K2.dtype, device=K2.device)
    K1 = gk.rbf_ard(Xn, Xn, torch.exp(p.raw_x_lengthscale))
    return Yn, K1, K2, torch.exp(p.raw_noise)


def _masked_chol(K1, K2, mask, noise):
    """Kronecker product, its masked noisy matrix's Cholesky factor."""
    mv = mask.reshape(-1)
    Kfull = kron_dense(K1, K2)
    Kd = Kfull * (mv[:, None] * mv[None, :])
    Kd = Kd + torch.diag(noise * mv + (1.0 - mv))
    return Kfull, torch.linalg.cholesky(Kd), mv


def _reduce_mean(alpha, K1, K2):
    """``K1 @ alpha @ K2`` as broadcast-multiply and reduce, the reference's
    form: no GEMM whose tiling could depend on anything but this task."""
    tmp = (alpha[:, :, None] * K2[None, :, :]).sum(dim=1)        # (n, m)
    return (K1[:, :, None] * tmp[None, :, :]).sum(dim=1)


def _task_products(st: LKGPState):
    """One task's exact posterior mean (y units) over its grid and exact
    predictive variance (with noise, y units) of each config's final value:
    the reference's ``_batched_products_fn`` for one task."""
    Yn, K1, K2, noise = _task_grams(st)
    n, m = st.mask.shape
    _, L, mv = _masked_chol(K1, K2, st.mask, noise)
    ym = (Yn * st.mask).reshape(-1)
    # Joint-covariance rows at the final-epoch cells, for the exact final
    # variance, stacked with ym into ONE multi-column solve.
    Krhs = ((K1[:, :, None] * K2[:, -1][None, None, :])
            * st.mask[None]).reshape(n, n * m)
    sol = torch.cholesky_solve(torch.cat([ym[:, None], Krhs.T], dim=1), L)
    alpha = (sol[:, 0] * mv).reshape(n, m)
    mean_t = _reduce_mean(alpha, K1, K2)
    # var_i = K1[ii] K2[mm] - k_i^T A^{-1} k_i, k_i the masked joint row.
    quad = (Krhs.T * sol[:, 1:]).sum(dim=0)
    var_f = (torch.diagonal(K1) * K2[-1, -1] - quad).clamp_min(0.0)
    return st.y_tf.inverse(mean_t), st.y_tf.inverse_var(var_f + noise)


def _task_cov_products(st: LKGPState):
    """One task's full-grid exact posterior: transformed mean, per-cell
    predictive variance (y units, with noise) and the Cholesky factor of the
    latent grid covariance (for joint samples): the reference's
    ``_batched_cov_fn`` for one task."""
    Yn, K1, K2, noise = _task_grams(st)
    n, m = st.mask.shape
    N = n * m
    Kfull, L, mv = _masked_chol(K1, K2, st.mask, noise)
    ym = (Yn * st.mask).reshape(-1)
    # C = K - Kx A^-1 Kx^T, Kx the cross-covariance with its unobserved
    # columns zeroed (those rows / columns of A are the identity).
    Kx = Kfull * mv[None, :]
    sol = torch.cholesky_solve(torch.cat([ym[:, None], Kx.T], dim=1), L)
    alpha = (sol[:, 0] * mv).reshape(n, m)
    mean_t = _reduce_mean(alpha, K1, K2)
    C = Kfull - Kx @ sol[:, 1:]
    var_grid = torch.diagonal(C).clamp_min(0.0).reshape(n, m)
    jitter = st.config.jitter
    Lc = torch.linalg.cholesky(
        C + 10.0 * jitter * torch.eye(N, dtype=C.dtype, device=C.device))
    return mean_t, st.y_tf.inverse_var(var_grid + noise), Lc


class BatchedPosterior:
    """Exact dense posterior over a batch of tasks (a state with a leading
    task axis from :func:`~repro_torch.core.state.fit_batch` or
    :func:`~repro_torch.core.state.stack_states`).

    Each task is computed by one single-task function (Cholesky of the
    masked dense matrix, no Matheron MC: the per-task problems this path
    serves are small), called once per task, and the results stacked, so a
    task's ``mean`` and exact ``final()`` are bitwise the same at every
    batch size. The Gram construction matches :func:`joint_grams` (jitter on
    K2 only), so per-task results agree with :class:`Posterior` on the same
    task.

    Conforms to :class:`PosteriorLike`: ``variance`` is the exact per-cell
    predictive variance (B, n, m); ``samples(generator, n_samples)`` draws
    exact joint posterior functions (s, B, n, m) from each task's dense grid
    covariance; ``final(generator, n_samples)`` without either returns the
    exact final variance, with one estimates it from samples plus noise.
    ``normals`` (shape (B, s, n * m)) replaces the generator's draws, so a
    test can hand the reference's across. ``solve_info`` is None.
    """

    def __init__(self, state: LKGPState):
        if state.X.ndim != 3:
            raise ValueError("BatchedPosterior expects a batched state from "
                             "fit_batch or stack_states; got X of shape "
                             f"{tuple(state.X.shape)}")
        self._state = state

    @property
    def solve_info(self):
        """None: the exact dense path reports no iterative diagnostics."""
        return None

    @cached_property
    def _tasks(self) -> list[LKGPState]:
        return unstack(self._state)

    @cached_property
    def _products(self):
        means, vars_ = zip(*(_task_products(st) for st in self._tasks))
        return torch.stack(means), torch.stack(vars_)

    @cached_property
    def _cov_products(self):
        means, vars_, chols = zip(*(_task_cov_products(st)
                                    for st in self._tasks))
        return torch.stack(means), torch.stack(vars_), torch.stack(chols)

    @cached_property
    def _final_exact(self):
        mean, var = self._products
        return mean[:, :, -1], var

    @property
    def mean(self) -> torch.Tensor:
        """Exact posterior means, (B, n, m), y units."""
        return self._products[0]

    @property
    def variance(self) -> torch.Tensor:
        """Exact per-cell predictive variance (+ noise), (B, n, m), y units."""
        return self._cov_products[1]

    def samples(self, generator, n_samples: int | None = None, *,
                normals=None) -> torch.Tensor:
        """Exact joint posterior samples, (s, B, n, m), y units.

        Drawn from the dense latent grid covariance per task (no observation
        noise, as :meth:`Posterior.samples`). ``normals`` of shape
        (B, s, n * m) replaces the draws from ``generator``.
        """
        st = self._state
        n_samples = n_samples or st.config.posterior_samples
        mean_t, _, Lc = self._cov_products
        B, n, m = st.Y.shape
        shape = (B, n_samples, n * m)
        if normals is None:
            z = torch.randn(shape, dtype=mean_t.dtype, device=mean_t.device,
                            generator=generator)
        else:
            z = torch.as_tensor(normals, dtype=mean_t.dtype,
                                device=mean_t.device)
            if tuple(z.shape) != shape:
                raise ValueError(f"normals must have shape {shape}, got "
                                 f"{tuple(z.shape)}")
        draws = torch.stack([mean_t[b].reshape(1, n * m) + z[b] @ Lc[b].T
                             for b in range(B)])
        raw = draws.reshape(B, n_samples, n, m).transpose(0, 1)
        scale, shift = st.y_tf.scale, st.y_tf.shift
        return raw * scale[None, :, None, None] + shift[None, :, None, None]

    def final(self, generator=None, n_samples: int | None = None, *,
              normals=None):
        """(mean, var) of the final-progression value, each (B, n).

        With no ``generator``, ``n_samples`` or ``normals`` the variance is
        exact; otherwise it is estimated from joint samples plus noise, as
        the lazy posterior's Matheron protocol (``generator=None`` then takes
        the stream ``(config.seed, 2)``).
        """
        if generator is None and n_samples is None and normals is None:
            return self._final_exact
        mean, _ = self._products
        st = self._state
        if generator is None and normals is None:
            generator = _stream(st.config.seed, 2, st.device)
        s = self.samples(generator, n_samples, normals=normals)[..., -1]
        noise = torch.exp(st.params.raw_noise)                    # (B,)
        var_mc = (s.var(dim=0, unbiased=False)
                  + (noise * st.y_tf.scale ** 2)[:, None])
        return mean[:, :, -1], var_mc


def posterior_batch(state: LKGPState, cache: bool | None = None, *,
                    device=None) -> BatchedPosterior:
    """Batched exact posterior for a batched state.

    ``device=None`` means the GPU (the state must live there). Same
    state-keyed cache as :func:`posterior`: by default the batched posterior
    (and its computed products) is shared across calls on the same state
    object.
    """
    check_on_device(resolve_device(device), X=state.X, Y=state.Y,
                    mask=state.mask, t=state.t)
    if cache is None:
        cache = state.config.posterior_cache
    if not cache:
        return BatchedPosterior(state)
    return _state_cached(state, _BATCH_CACHE_ATTR,
                         lambda: BatchedPosterior(state))
