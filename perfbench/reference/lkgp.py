"""Plain PyTorch reference of the latent-Kronecker GP posterior.

Written from the paper's equations (arXiv:2410.09239, Section 2 and App. B),
independently of the package under test: it imports nothing of it. Every
product is a plain ``torch`` matmul in the dtype given, float64 for the
truth. The benchmark hands it the same raw inputs as the program (configs,
epochs, curves, masks, hyper-parameters, standard normals) and it works out
everything else again: the input and output transforms, both Gram
matrices, the masked noisy operator, the block conjugate-gradient solve and
the Matheron-rule samples of each configuration's final value.

``precision="control"`` is the benchmark's control: every product one step
below the precision the configuration states for it. The operator's
float32 products take operands rounded to TF32 (10-bit mantissa, as the
tensor cores' ``cvt.rna.tf32.f32`` rounds them) and sum in float32; the
posterior's float64 products (the prior draw, the mean, the Matheron
correction) run in float32. Factorisations stay in float64.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["Transforms", "fit_transforms", "grams", "Operator", "block_cg",
           "relative_residual", "posterior_final", "FinalAnswer", "tf32",
           "final_mean"]


class Transforms(NamedTuple):
    x_lo: torch.Tensor
    x_hi: torch.Tensor
    log_t1: torch.Tensor
    log_tm: torch.Tensor
    y_shift: torch.Tensor
    y_scale: torch.Tensor


def fit_transforms(X, t, Y, mask) -> Transforms:
    """x to the unit cube by the data's min and max per dimension; t to
    [0, 1] on a log scale; y less its observed maximum, over its observed
    standard deviation (paper App. B)."""
    lo, hi = X.min(dim=0).values, X.max(dim=0).values
    hi = torch.where(hi == lo, lo + 1.0, hi)
    lt = torch.log(t)
    t1, tm = lt[0], lt[-1]
    tm = torch.where(tm == t1, t1 + 1.0, tm)
    obs = mask > 0
    shift = Y[obs].max()
    cnt = mask.sum()
    mean = (Y * mask).sum() / cnt
    var = (mask * (Y - mean) ** 2).sum() / cnt
    return Transforms(lo, hi, t1, tm, shift, torch.sqrt(var.clamp_min(1e-12)))


def grams(theta: dict, Xn, tn, jitter: float):
    """K1 over configurations (RBF with one lengthscale a dimension, no
    jitter) and K2 over epochs (Matern-1/2 with its outputscale, jittered),
    from the raw (log-space) hyper-parameters."""
    ls = torch.exp(torch.as_tensor(theta["raw_x_lengthscale"],
                                   dtype=Xn.dtype, device=Xn.device))
    z = Xn / ls
    K1 = torch.exp(-0.5 * ((z[:, None, :] - z[None, :, :]) ** 2).sum(-1))
    lt = math.exp(theta["raw_t_lengthscale"])
    os_ = math.exp(theta["raw_outputscale"])
    K2 = os_ * torch.exp(-(tn[:, None] - tn[None, :]).abs() / lt)
    K2 = K2 + jitter * torch.eye(tn.shape[0], dtype=K2.dtype, device=K2.device)
    return K1, K2


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: to nearest on the bit pattern, ties away
    from zero, the 13 low mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Operator:
    """A(u) = mask * (K1 @ (mask * u) @ K2) + noise * mask * u on grid
    vectors (..., n, m), in float64 or (``"control"``) from TF32 operands
    summed in float32."""

    def __init__(self, K1, K2, mask, noise: float, precision: str = "float64"):
        if precision not in ("float64", "control"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.mask, self.noise = mask, noise
        if precision == "float64":
            self.K1, self.K2 = K1, K2
        else:
            self.K1, self.K2 = tf32(K1.float()), tf32(K2.float())

    def __call__(self, u):
        um = u * self.mask
        if self.precision == "float64":
            s = self.K1 @ (um @ self.K2)
        else:
            t = tf32(um.float()) @ self.K2
            s = (self.K1 @ tf32(t)).to(u.dtype)
        return self.mask * s + self.noise * um


def _dot(a, b):
    return (a * b).sum(dim=(-2, -1))


@torch.no_grad()
def block_cg(A, b, tol: float, max_iters: int = 10_000, check_every: int = 8):
    """Conjugate gradients on every column of ``b`` (..., n, m) at once; a
    column stops once its recursive residual is below ``tol * ||b||``.
    Returns ``(x, iterations)``. The host looks at the residuals every
    ``check_every`` iterations; a column that converged in between stops
    where it crossed ``tol``."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = _dot(r, r)
    bn = torch.sqrt(_dot(b, b)).clamp_min(1e-300)
    zero = torch.zeros_like(rs)
    it = 0
    while it < max_iters:
        active = torch.sqrt(rs) / bn > tol
        if it % check_every == 0 and not bool(active.any()):
            break
        Ap = A(p)
        pAp = _dot(p, Ap)
        alpha = torch.where(active, rs / torch.where(pAp == 0, 1.0, pAp), zero)
        x = x + alpha[..., None, None] * p
        r = r - alpha[..., None, None] * Ap
        rs_new = torch.where(active, _dot(r, r), rs)
        beta = torch.where(active, rs_new / torch.where(rs == 0, 1.0, rs), zero)
        p = torch.where(active[..., None, None],
                        r + beta[..., None, None] * p, p)
        rs = rs_new
        it += 1
    return x, it


@torch.no_grad()
def relative_residual(A, x, b) -> torch.Tensor:
    """Per column ||b - A x|| / ||b||, through ``A`` as given."""
    r = b - A(x)
    return torch.sqrt(_dot(r, r)) / torch.sqrt(_dot(b, b)).clamp_min(1e-300)


class FinalAnswer(NamedTuple):
    mean: torch.Tensor      # (n,) final-epoch posterior mean, y units
    var: torch.Tensor       # (n,) Matheron variance + noise, y units
    alpha: torch.Tensor     # (n, m) the solve K^{-1} y
    iters: int              # CG iterations of the stacked solve
    operator: Operator      # the float64 operator (to judge solutions with)
    rhs: torch.Tensor       # (n, m) the transformed observations, masked
    K1: torch.Tensor        # (n, n) float64
    K2: torch.Tensor        # (m, m) float64
    transforms: Transforms


@torch.no_grad()
def final_mean(K1, alpha, K2, tf: Transforms) -> torch.Tensor:
    """The final-epoch mean, y units, that a solve ``alpha`` gives."""
    return (K1 @ alpha @ K2[:, -1:])[:, 0] * tf.y_scale + tf.y_shift


@torch.no_grad()
def posterior_final(X, t, Y, mask, theta: dict, normals, *, jitter: float,
                    tol: float, precision: str = "float64",
                    max_iters: int = 10_000) -> FinalAnswer:
    """Final-epoch mean and variance of every configuration.

    ``normals = (Z, E)``, each (s, n, m): the standard normals of the prior
    draw ``F = L1 Z L2^T`` and of the noise ``eps = sigma E``. One stacked
    solve ``K^{-1} [y | mask (F + eps)]``; the mean is ``K1 alpha K2`` at
    the last epoch, the variance that of ``F + K1 (alpha - u_s) K2`` over the
    draws plus the noise, mapped back to y units."""
    dt = torch.float64
    X, t, Y, mask = (a.to(dt) for a in (X, t, Y, mask))
    tf = fit_transforms(X, t, Y, mask)
    Xn = (X - tf.x_lo) / (tf.x_hi - tf.x_lo)
    tn = (torch.log(t) - tf.log_t1) / (tf.log_tm - tf.log_t1)
    Yn = (Y - tf.y_shift) / tf.y_scale
    K1, K2 = grams(theta, Xn, tn, jitter)
    noise = math.exp(theta["raw_noise"])
    n, m = mask.shape
    Z, E = (z.to(dt) for z in normals)
    low = torch.float32 if precision == "control" else dt

    def mm(a, b):
        """A float64 product of the configuration, one step lower in the
        control."""
        return (a.to(low) @ b.to(low)).to(dt)

    eye_n = torch.eye(n, dtype=dt, device=X.device)
    eye_m = torch.eye(m, dtype=dt, device=X.device)
    L1 = torch.linalg.cholesky(K1 + jitter * eye_n)
    L2 = torch.linalg.cholesky(K2 + jitter * eye_m)
    F = mm(mm(L1, Z), L2.T)
    resid = mask * (F + math.sqrt(noise) * E)
    ym = torch.where(mask > 0, Yn, torch.zeros_like(Yn)) * mask
    A64 = Operator(K1, K2, mask, noise)
    A = A64 if precision == "float64" else Operator(K1, K2, mask, noise,
                                                      precision)
    sol, iters = block_cg(A, torch.cat([ym[None], resid], 0), tol, max_iters)
    alpha = sol[0]
    u = alpha[None] - sol[1:]
    mean = mm(mm(K1, alpha), K2)[:, -1] * tf.y_scale + tf.y_shift
    draws = F[:, :, -1] + mm(mm(K1, u), K2[:, -1:])[..., 0]
    var = draws.var(dim=0, unbiased=False) + noise
    return FinalAnswer(mean, var * tf.y_scale ** 2, alpha, iters, A64, ym,
                       K1, K2, tf)
