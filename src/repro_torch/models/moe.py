"""Mixture-of-Experts FFN with capacity-based dispatch (counterpart of
``repro.models.moe``, its single-device grouped path).

Tokens are organised into G groups, so the dispatch bookkeeping (each
assignment's rank within its expert, a cumsum) stays inside a group. Expert
buffers are (G, E, C, D) with C = ceil(Tg * top_k * cf / E): the dispatch is
a scatter and the combine a gather, with no one-hot dispatch product.
Tokens beyond an expert's capacity C are dropped (weight 0, their index
clamped to C - 1 so every write stays in bounds and adds a zero);
decode-sized groups clamp C to the group size, which makes the dispatch
dropless there.

Two places where the port must take care to agree with the reference:

* ``jax.lax.top_k`` breaks ties toward the lower expert index, and
  ``torch.topk`` promises no order under ties (bf16 router logits tie at
  full width). :func:`_top_k` takes a stable descending sort instead.
* The dispatch adds into a zeroed buffer, and each (g, e, s < C) slot takes
  exactly one kept token; every other write into it is a dropped token's
  zero. So the sum is exact in any order and two runs give the same bits.

The expert-parallel paths (``moe_ffn_sharded``, ``moe_ffn_sharded_decode``
and their per-rank bodies ``_local_moe``, ``_local_moe_tokens_gathered``)
are the reference's ``shard_map`` s over a ``DeviceMesh``: each input is
laid out as the reference's ``in_specs`` say and cut to this rank's block
(``sharding.to_local``), the body runs on plain tensors with explicit
collectives over ``mesh.get_group(axis)`` (differentiable ones when
autograd records), and the output is a ``DTensor`` of the ``out_specs``.
Every rank routes its tokens against the full router and computes the slot
ranks over all of them, so capacity drops agree across the expert shards;
the capacity is per shard, from the local token count, as the reference's.
A rank's share of a gradient is summed by DTensor (``sharding.to_local``),
and the sum over the model axis, whose result every rank uses alike, passes
its gradient through: the gradient is the one-device path's, as the
reference's is.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..distributed.sharding import (dp_axes, mesh_shape, spec_placements,
                                    to_local)
from .layers import _mm, identity_constrain

__all__ = ["moe_param_table", "moe_ffn", "moe_ffn_sharded",
           "moe_ffn_sharded_decode", "moe_capacity", "moe_groups"]


def moe_capacity(tokens_per_group: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    c = math.ceil(tokens_per_group * top_k * capacity_factor / num_experts)
    c = max(c, min(8, tokens_per_group))
    return min(c, tokens_per_group)


def moe_param_table(cfg) -> dict[str, tuple]:
    """name -> (shape, logical_axes, fan_in). Gated (swiglu) experts."""
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    return {
        "router": ((D, E), ("embed", "experts_router"), D),
        "wi_0": ((E, D, F_), ("experts", "embed", "mlp"), D),
        "wi_1": ((E, D, F_), ("experts", "embed", "mlp"), D),
        "wo": ((E, F_, D), ("experts", "mlp", "embed"), F_),
    }


def _top_k(probs: torch.Tensor, k: int):
    """The k largest entries of the last axis and their indices, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_groups(tokens: int, num_groups: int) -> int:
    """The reference's group count: ``num_groups`` taken down until it
    divides the token count."""
    G = max(1, min(num_groups, tokens))
    while tokens % G:
        G -= 1
    return G


def moe_ffn(x: torch.Tensor, params: dict[str, Any], cfg,
            num_groups: int, constrain=identity_constrain) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): route each token to its top-k experts,
    run the gated (SwiGLU) experts on their capacity buffers, and combine
    with the routing weights (renormalised over the top k when
    ``cfg.moe_renormalize``). ``constrain(tensor, logical_axes)`` applies a
    sharding constraint (the identity on one device)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    T = B * S
    G = moe_groups(T, num_groups)
    Tg = T // G
    C = moe_capacity(Tg, E, K, cfg.capacity_factor)
    xg = constrain(x.reshape(G, Tg, D), ("moe_groups", None, "embed"))

    # --- routing -----------------------------------------------------------
    logits = _mm("gtd,de->gte", xg, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, K)                         # (G, Tg, K)
    if getattr(cfg, "moe_renormalize", True):
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # --- rank of each (token, k) within its expert ---------------------------
    # flat (G, Tg*K) assignment order is token-major: earlier tokens win slots.
    flat_e = top_e.reshape(G, Tg * K)
    onehot = F.one_hot(flat_e, E).float()                    # (G, Tg*K, E)
    onehot = constrain(onehot, ("moe_groups", None, None))
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot          # rank, 0-based
    slot = (pos_in_e * onehot).sum(-1).to(torch.int32).reshape(G, Tg, K)
    keep = slot < C
    weight = top_p * keep.to(top_p.dtype)                    # dropped -> 0
    s_idx = torch.clamp_max(slot, C - 1).long()

    # --- dispatch: scatter tokens into (G, E, C, D) buffers -----------------
    buf = torch.zeros((G, E, C, D), dtype=x.dtype, device=x.device)
    gidx = torch.arange(G, device=x.device)[:, None]
    for j in range(K):
        src = torch.where(keep[:, :, j, None], xg, torch.zeros_like(xg))
        buf = buf.index_put((gidx, top_e[:, :, j], s_idx[:, :, j]), src,
                            accumulate=True)
    buf = constrain(buf, ("moe_groups", "experts", None, "embed"))

    # --- expert computation (gated SwiGLU) ----------------------------------
    g = _mm("gecd,edf->gecf", buf, params["wi_0"])
    u = _mm("gecd,edf->gecf", buf, params["wi_1"])
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    out_buf = _mm("gecf,efd->gecd", h, params["wo"])
    out_buf = constrain(out_buf, ("moe_groups", "experts", None, "embed"))

    # --- combine: gather each token's k slots, weight, and sum --------------
    out = torch.zeros((G, Tg, D), dtype=torch.float32, device=x.device)
    for j in range(K):
        gathered = out_buf[gidx, top_e[:, :, j], s_idx[:, :, j]]
        out = out + weight[:, :, j, None] * gathered.float()
    out = constrain(out.to(x.dtype), ("moe_groups", None, "embed"))
    return out.reshape(B, S, D)


# --------------------------------------------------------------------------
# Expert-parallel paths over a DeviceMesh
# --------------------------------------------------------------------------
class _SumToReplicas(torch.autograd.Function):
    """The sum of ``x`` over ``group``, whose result every rank of the group
    then holds and uses alike: each rank's upstream gradient is already the
    whole gradient of its share, so the backward passes it through."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_reduce(x: torch.Tensor, group, replicated: bool = True
                ) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (``None``: a single rank, ``x``).
    ``replicated``: the ranks use the sum alike (its gradient passes
    through); else each rank uses its own part of it (its gradient is the
    sum of theirs, ``torch.distributed.nn``'s ``all_reduce``)."""
    if group is None:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x
    if replicated:
        return _SumToReplicas.apply(x, group)
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, group=group)


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    gather = getattr(dist, "all_gather_single", None) or getattr(
        dist, "all_gather_into_tensor")
    gather(out, x, group=group)
    return out


class _GatherShares(torch.autograd.Function):
    """All-gather along dimension 0, after which each rank computes its own
    share from all rows: a rank's gradient is its rows of the sum of every
    rank's upstream gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return grad[r * ctx.rows:(r + 1) * ctx.rows], None


def _all_gather0(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along dimension 0 in rank
    order (``all_gather(tiled=True)``)."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherShares.apply(x, group)
    return _gather0(x, group)


def _axis(mesh, name: str):
    """(rank along ``name``, its group or ``None`` for an axis of one)."""
    sizes = mesh_shape(mesh)
    if sizes.get(name, 1) == 1:
        return 0, None
    return mesh.get_local_rank(name), mesh.get_group(name)


def _route_local(xf, router, cfg, C, e_lo, e_lo_size):
    """Routing of T tokens against the full router, restricted to the
    experts [e_lo, e_lo + e_lo_size): (keep, local expert index, slot index,
    float32 weight), each (T, K). Slot ranks count over all T tokens and
    all experts, so every shard drops the same assignments."""
    T = xf.shape[0]
    E, K = cfg.num_experts, cfg.moe_top_k
    logits = _mm("td,de->te", xf, router).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, K)                          # (T, K)
    if getattr(cfg, "moe_renormalize", True):
        top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    onehot = F.one_hot(top_e.reshape(T * K), E).float()      # (T*K, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    slot = (pos * onehot).sum(-1).to(torch.int32).reshape(T, K)
    local = (top_e >= e_lo) & (top_e < e_lo + e_lo_size)
    keep = (slot < C) & local
    weight = (top_p * keep.to(top_p.dtype)).float()
    e_idx = torch.clamp(top_e - e_lo, 0, e_lo_size - 1)
    s_idx = torch.clamp_max(slot, C - 1).long()
    return keep, e_idx, s_idx, weight


def _local_experts(xf, keep, e_idx, s_idx, weight, wi0, wi1, wo, C):
    """Dispatch into (E_loc, C, D) buffers, the gated experts, and the
    weighted combine: (T, D) float32, partial over the other shards."""
    T, D = xf.shape
    K = keep.shape[1]
    buf = torch.zeros((wi0.shape[0], C, D), dtype=xf.dtype, device=xf.device)
    for j in range(K):
        src = torch.where(keep[:, j, None], xf, torch.zeros_like(xf))
        buf = buf.index_put((e_idx[:, j], s_idx[:, j]), src, accumulate=True)
    g = _mm("ecd,edf->ecf", buf, wi0)
    u = _mm("ecd,edf->ecf", buf, wi1)
    h = (F.silu(g.float()) * u.float()).to(xf.dtype)
    out_buf = _mm("ecf,efd->ecd", h, wo)
    out = torch.zeros((T, D), dtype=torch.float32, device=xf.device)
    for j in range(K):
        gathered = out_buf[e_idx[:, j], s_idx[:, j]]
        out = out + weight[:, j, None] * gathered.float()
    return out


def _local_moe(x_loc, router, wi0, wi1, wo, cfg, e_lo_size, e_rank=0,
               group=None):
    """Per-rank body: this data shard's tokens (replicated over the model
    axis) against this model shard's experts, summed over ``group`` (the
    model axis). Dropped tokens and other shards' experts contribute
    zeros."""
    B, S, D = x_loc.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    T = B * S
    C = moe_capacity(T, E, K, cfg.capacity_factor)
    xf = x_loc.reshape(T, D)
    route = _route_local(xf, router, cfg, C, e_rank * e_lo_size, e_lo_size)
    out = _local_experts(xf, *route, wi0, wi1, wo, C)
    out = _all_reduce(out.to(x_loc.dtype), group)
    return out.reshape(B, S, D)


def _from_local(out, mesh, spec):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(out, mesh, spec_placements(spec, mesh),
                              run_check=False)


def moe_ffn_sharded(x, params, cfg, mesh):
    """Expert-parallel MoE: tokens over the data axes, experts over
    'model'; one activation-sized sum over 'model' a layer. ``x`` is a
    ``DTensor`` (or a plain tensor every rank holds); returns a ``DTensor``
    with the batch over the data axes when they divide it."""
    sizes = mesh_shape(mesh)
    tp = sizes.get("model", 1)
    if cfg.num_experts % tp:
        raise ValueError("experts must divide the model axis")
    dp = dp_axes(mesh)
    dp_ok = dp if x.shape[0] % math.prod(sizes[a] for a in dp) == 0 else ()
    xspec = (dp_ok if dp_ok else None, None, None)
    wspec = ("model", None, None)
    e_rank, group = _axis(mesh, "model")
    out = _local_moe(to_local(x, mesh, xspec),
                     to_local(params["router"], mesh, (None, None)),
                     to_local(params["wi_0"], mesh, wspec),
                     to_local(params["wi_1"], mesh, wspec),
                     to_local(params["wo"], mesh, wspec),
                     cfg, cfg.num_experts // tp, e_rank, group)
    return _from_local(out, mesh, xspec)


def _local_moe_tokens_gathered(x_loc, router, wi0, wi1, wo, cfg, e_lo_size,
                               dp_groups=(), tp=(0, None), f_group=None):
    """Decode-path body: the (small) token batch all-gathered over the data
    axes, the expert weights resident and sharded over both axes (E over
    'model', F over 'data'). Every rank then holds all tokens, so the
    partial outputs (partial over the local experts and over F) sum over
    'model' and 'data' into the full combine, and each rank takes its rows
    back.

    ``dp_groups``: (rank, group, size) of each data axis the tokens were
    gathered over, in mesh order; ``tp``: (rank, group) of the model axis;
    ``f_group``: the group of the axis F is split over ('data'). The
    reference sums over the model axis and the gathered axes instead: that
    misses F's sum when the batch does not divide 'data' (its tokens then
    are not gathered) and doubles the output over a 'pod' axis (its ranks
    hold the same tokens and the same weights); ROADMAP's reference
    caveats give the numbers.
    """
    B, S, D = x_loc.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    x_all = x_loc
    for _, group, _ in dp_groups:
        x_all = _all_gather0(x_all, group)
    T = x_all.shape[0] * S
    xf = x_all.reshape(T, D)
    e_rank, tp_group = tp
    C = moe_capacity(T, E, K, cfg.capacity_factor)
    route = _route_local(xf, router, cfg, C, e_rank * e_lo_size, e_lo_size)
    out = _local_experts(xf, *route, wi0, wi1, wo, C)   # partial over F
    # the model axis's ranks keep the same rows, the data axis's their own
    out = _all_reduce(_all_reduce(out, tp_group), f_group,
                      replicated=False)
    out = out.to(x_loc.dtype).reshape(x_all.shape)
    # this rank's tokens back out (the last gather holds the outermost
    # blocks)
    idx = 0
    for rank, _, size in reversed(dp_groups):
        idx = idx * size + rank
    return out[idx * B:(idx + 1) * B]


def moe_ffn_sharded_decode(x, params, cfg, mesh):
    """Serve-time MoE for small token counts (decode): resident weights,
    gathered tokens. Returns a ``DTensor`` with the batch over each data
    axis that divides it."""
    sizes = mesh_shape(mesh)
    tp = sizes.get("model", 1)
    dp = tuple(a for a in dp_axes(mesh) if x.shape[0] % sizes[a] == 0)
    xspec = (dp if dp else None, None, None)
    dp_groups = tuple((*_axis(mesh, a), sizes[a]) for a in dp)
    # every rank computes with all tokens: a share of the gradient over the
    # model and data axes (its experts, its slice of F), a copy over 'pod'
    partial = ("model", "data")
    out = _local_moe_tokens_gathered(
        to_local(x, mesh, xspec, partial),
        to_local(params["router"], mesh, (None, None), partial),
        to_local(params["wi_0"], mesh, ("model", None, "data"), partial),
        to_local(params["wi_1"], mesh, ("model", None, "data"), partial),
        to_local(params["wo"], mesh, ("model", "data", None), partial),
        cfg, cfg.num_experts // tp, dp_groups, _axis(mesh, "model"),
        _axis(mesh, "data")[1] if "data" in sizes else None)
    return _from_local(out, mesh, xspec)
