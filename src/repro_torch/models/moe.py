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

The expert-parallel paths of the reference (``moe_ffn_sharded``,
``moe_ffn_sharded_decode``, ``_local_moe``, ``_local_moe_tokens_gathered``)
need ``distributed/sharding.py`` and are not ported (ROADMAP queue 1).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .layers import _mm

__all__ = ["moe_param_table", "moe_ffn", "moe_capacity", "moe_groups"]


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
            num_groups: int) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): route each token to its top-k experts,
    run the gated (SwiGLU) experts on their capacity buffers, and combine
    with the routing weights (renormalised over the top k when
    ``cfg.moe_renormalize``)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    T = B * S
    G = moe_groups(T, num_groups)
    Tg = T // G
    C = moe_capacity(Tg, E, K, cfg.capacity_factor)
    xg = x.reshape(G, Tg, D)

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

    # --- expert computation (gated SwiGLU) ----------------------------------
    g = _mm("gecd,edf->gecf", buf, params["wi_0"])
    u = _mm("gecd,edf->gecf", buf, params["wi_1"])
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    out_buf = _mm("gecf,efd->gecd", h, params["wo"])

    # --- combine: gather each token's k slots, weight, and sum --------------
    out = torch.zeros((G, Tg, D), dtype=torch.float32, device=x.device)
    for j in range(K):
        gathered = out_buf[gidx, top_e[:, :, j], s_idx[:, :, j]]
        out = out + weight[:, :, j, None] * gathered.float()
    return out.to(x.dtype).reshape(B, S, D)
