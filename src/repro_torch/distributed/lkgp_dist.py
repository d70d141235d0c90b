"""Row-sharded latent-Kronecker MVM, CG and MLL over a ``torch.distributed``
process group.

Counterpart of ``repro.distributed.lkgp_dist``. Rows of the latent grid (the
hyper-parameter configurations) are split evenly over the ranks of a group;
K2 (m x m) is replicated. Rank r holds rows ``r * n_local ... (r+1) * n_local``
of K1, the mask and every grid vector. One MVM is then

    T_loc = (mask_loc * U_loc) @ K2          local     O(n/p * m^2)
    S_loc = K1[rows_loc, :] @ all_gather(T)  1 gather  O(n^2/p * m)
    out   = mask_loc * S_loc + noise * (mask_loc * U_loc)

one all-gather of an (n_local, m) block per MVM (:func:`dist_lk_operator`),
or, through the hand-written row-shard kernel K3, one all-gather of the
pre-masked input and the whole row block in one launch
(:func:`dist_lk_mvm_fused`). :func:`dist_cg_solve` all-reduces its sums over
the group; :func:`dist_mll_value` builds K1's row block after one all-gather
of X.

``group=None`` means the default group when one is initialised and otherwise
a world of one rank, with no collective at all. A group may have a single
rank (``world_size=1``): its collectives still run, which is how one card
exercises the collective path. Each rank's tensors live on that rank's
device (``cuda:{local_rank}`` under NCCL, with ``torch.cuda.set_device``
called by the caller; the CPU under gloo).

:func:`gather_rows` and :func:`group_layout` are also what
:class:`repro_torch.core.engines.DistributedEngine` uses; its operator keeps
whole grid vectors on every rank and gathers the output rows instead.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.gp_kernels import KERNELS_1D, rbf_ard
from ..kernels.lk_mvm import lk_mvm_fused_rows

__all__ = ["group_layout", "gather_rows", "dist_lk_operator",
           "dist_lk_mvm_fused", "dist_cg_solve", "dist_mll_value"]


def group_layout(group=None):
    """``(group, rank, world_size)`` for ``group``.

    ``None`` resolves to the default group when one is initialised; with
    none, it stays ``None`` with rank 0 of a world of 1, and the functions of
    this module then make no collective call.
    """
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None, 0, 1
        group = dist.group.WORLD
    return group, dist.get_rank(group), dist.get_world_size(group)


# torch >= 2.12 names the one-tensor all-gather all_gather_single; earlier
# releases call it all_gather_into_tensor. Both take the output as the inputs
# of all ranks concatenated along dimension 0.
_all_gather_single = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)


def gather_rows(x_rows: torch.Tensor, group=None, world: int = 1
                ) -> torch.Tensor:
    """All-gather the row blocks (..., n_local, m) of every rank into
    (..., world * n_local, m), ranks in order. ``group=None`` (a world of
    one, no group) returns ``x_rows`` itself. Not differentiable: see
    :class:`GatherRows`."""
    if group is None:
        return x_rows
    x = x_rows.contiguous()
    out = torch.empty((world * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather_single(out, x, group=group)
    if x.ndim == 2:
        return out          # (world * n_local, m): already in row order
    out = out.reshape(world, *x.shape).movedim(0, -3)
    return out.reshape(*x.shape[:-2], world * x.shape[-2], x.shape[-1])


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (``x`` itself for none)."""
    if group is not None:
        x = x.clone()
        dist.all_reduce(x, group=group)
    return x


class GatherRows(torch.autograd.Function):
    """:func:`gather_rows` with a gradient, for computations that go on
    REPLICATED after the gather: every rank then holds the same upstream
    gradient, and the gradient of its own row block is that gradient's slice
    at its rows (the conjugate of :class:`SumGrads`)."""

    @staticmethod
    def forward(ctx, x_rows, group, rank, world):
        ctx.rank, ctx.n_local = rank, x_rows.shape[-2]
        return gather_rows(x_rows, group, world)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.rank * ctx.n_local
        return g[..., r0:r0 + ctx.n_local, :], None, None, None


class SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group.

    A tensor replicated on every rank (a Gram factor, the noise, a grid
    vector) from which each rank computes its own row block receives, on each
    rank, only that block's share of the gradient; the sum over the ranks is
    the whole of it, and every rank gets the same."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


def dist_lk_operator(K1_rows, K2, mask_rows, noise, group=None):
    """Row-sharded operator ``u_rows -> A(u)_rows`` in the factors' dtype.

    ``K1_rows`` (n_local, n) this rank's rows of K1; ``mask_rows`` and every
    ``u_rows`` (..., n_local, m) its rows of the mask and of the vector;
    ``K2`` (m, m) replicated. One all-gather of the (n_local, m) block
    ``(mask * u) @ K2`` per call. Exact: no float32 kernel.
    """
    group, _, world = group_layout(group)

    def A(u_rows):
        um = mask_rows * u_rows
        t_full = gather_rows(um @ K2, group, world)
        return mask_rows * (K1_rows @ t_full) + noise * um

    return A


def dist_lk_mvm_fused(K1_rows, K2, mask_rows, noise, group=None, *,
                      precision: str = "f32"):
    """Row-sharded operator ``u_rows -> A(u)_rows`` running kernel K3 on each
    rank's rows.

    Same contract as :func:`dist_lk_operator` (float32 operands), but the
    all-gather carries the pre-masked input ``mask * u`` and each rank's row
    block is ONE launch of :func:`repro_torch.kernels.lk_mvm.lk_mvm_fused_rows`
    (the stage-R intermediate stays in shared memory; leading batch dims in
    the same launch). ``precision="bf16"`` as for the kernel.
    """
    group, _, world = group_layout(group)

    def A(u_rows):
        u_rows = u_rows.contiguous()
        um_full = gather_rows(mask_rows * u_rows, group, world)
        return lk_mvm_fused_rows(K1_rows, K2, mask_rows, u_rows,
                                 um_full.contiguous(), noise,
                                 precision=precision)

    return A


def dist_cg_solve(A, b, tol: float = 0.01, max_iters: int = 10_000, x0=None,
                  group=None):
    """CG on row-sharded grid vectors; every inner product is a local sum
    all-reduced over the group (the reference's global ``jnp.sum``). The sums
    run over every element of ``b``: one system. ``x0`` warm-starts.

    Returns ``(x_rows, iters, rel_residual)``: this rank's rows of the
    solution, the iteration count (an int) and the recursively updated
    relative residual (a 0-d tensor), as the reference does. One host read
    per iteration (the loop condition), the same on every rank.
    """
    group, _, _ = group_layout(group)

    def gsum(x):
        return all_reduce_sum(x.sum(), group)

    b_norm = torch.sqrt(gsum(b * b))
    safe = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    p = r
    rs = gsum(r * r)
    floor = torch.tensor(1e-30, dtype=rs.dtype, device=rs.device)
    it = 0
    while it < max_iters:
        # the one read an iteration
        go = (torch.sqrt(rs) / safe > tol).item()  # lint: disable=RT103 (designed)
        if not go:
            break
        Ap = A(p)
        alpha = rs / torch.maximum(gsum(p * Ap), floor)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = gsum(r * r)
        p = r + (rs_new / torch.maximum(rs, floor)) * p
        rs = rs_new
        it += 1
    return x, it, torch.sqrt(rs) / safe


def dist_mll_value(params_ls, params_tls, params_os, params_noise, X_rows, t,
                   Y_rows, mask_rows, t_kernel: str = "matern12",
                   jitter: float = 1e-6, cg_tol: float = 0.01,
                   cg_max_iters: int = 10_000, group=None):
    """Row-sharded MLL quadratic term ``-1/2 y^T K^-1 y``.

    ``X_rows`` (n_local, d), ``Y_rows`` and ``mask_rows`` (n_local, m) are
    this rank's rows; ``t`` (m,) and the (positive, not raw) parameters are
    replicated. K1's row block is ``rbf_ard(X_rows, all_gather(X))`` plus the
    jitter on its part of the diagonal; the solve is :func:`dist_cg_solve`
    against :func:`dist_lk_operator`. Returns ``(quad, iters, rel_residual)``,
    ``quad`` the same on every rank.
    """
    group, rank, world = group_layout(group)
    n_local = X_rows.shape[0]
    x_full = gather_rows(X_rows, group, world)
    K1_rows = rbf_ard(X_rows, x_full, params_ls)
    local = torch.arange(n_local, device=K1_rows.device)
    K1_rows = K1_rows.index_put((local, rank * n_local + local),
                                torch.tensor(jitter, dtype=K1_rows.dtype,
                                             device=K1_rows.device),
                                accumulate=True)
    m = t.shape[0]
    K2 = KERNELS_1D[t_kernel](t, t, params_tls, params_os)
    K2 = K2 + jitter * torch.eye(m, dtype=K2.dtype, device=K2.device)
    A = dist_lk_operator(K1_rows, K2, mask_rows, params_noise, group)
    Ym = Y_rows * mask_rows
    alpha, iters, rel = dist_cg_solve(A, Ym, tol=cg_tol,
                                      max_iters=cg_max_iters, group=group)
    quad = -0.5 * all_reduce_sum((Ym * alpha).sum(), group)
    return quad, iters, rel
