"""Shared neural-net layers (counterpart of ``repro.models.layers``).

Every layer of the reference is ported: ``rms_norm``, ``layer_norm``,
``rope`` / ``apply_rope``, ``mlp`` / ``mlp_params``, ``attention`` with both
of its paths, ``decode_attention`` against a KV cache, ``chunked_ce_loss``
and the decoder's KV ``Cache``.

Conventions, as the reference's: activations are (batch, seq, d_model);
attention scores and the softmax are computed in float32 and the output is
cast back to the activation dtype; every gelu is the tanh approximation
(``jax.nn.gelu``'s default, not ``F.gelu``'s). Sequences longer than 1024
whose lengths divide into the chunks take the chunked (flash-style) path:
query blocks against key blocks with an online softmax, so no (Sq, Sk) score
matrix is held. The reference wraps its key loop in ``jax.checkpoint``; that
only trades memory in the backward pass and changes no value, so the port's
loops are plain. ``chunked_ce_loss`` recomputes each chunk's logits in the
backward pass under autograd (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` does, so no (B, S, vocab) tensor is kept.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["rms_norm", "layer_norm", "rope", "apply_rope", "mlp",
           "mlp_params", "attention", "decode_attention", "chunked_ce_loss",
           "Cache", "identity_constrain", "mesh_of", "cache_zeros",
           "write_layer", "write_all", "write_prefix", "write_at",
           "embed_lookup"]


def identity_constrain(t, logical):
    """The models' default ``constrain``: no sharding constraint."""
    return t


def _even(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or for a ``DTensor`` with a dimension sharded unevenly
    (a batch of 5 over 2 ranks) or a pending sum (``Partial``) that
    placement replicated. DTensor cannot flatten an uneven shard, an
    ``einsum`` flattens its operands, and DTensor's strategies would scatter
    a pending sum over the leading axis however uneven."""
    placements = getattr(t, "placements", None)
    if placements is None:
        return t
    from torch.distributed.tensor import Replicate, Shard

    mesh = t.device_mesh
    even = [p if p.is_replicate() or (isinstance(p, Shard)
                                      and t.shape[p.dim] % mesh.size(i) == 0)
            else Replicate() for i, p in enumerate(placements)]
    return t if even == list(placements) else t.redistribute(mesh, even)


def unflattenable(t: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``t``, ready for a view that splits dimension ``dim`` into (``outer``,
    rest): a ``DTensor`` whose ``dim`` is split over more ranks than
    ``outer`` divides (4 KV heads over 8) has that split replicated first.
    DTensor cannot unflatten a dimension whose blocks do not hold whole
    rows of the view, where XLA reshards within a row."""
    placements = getattr(t, "placements", None)
    if placements is None:
        return t
    from torch.distributed.tensor import Replicate, Shard

    mesh, dim = t.device_mesh, dim % t.ndim
    ranks = math.prod(mesh.size(i) for i, p in enumerate(placements)
                      if isinstance(p, Shard) and p.dim == dim)
    if outer % ranks == 0:
        return t
    return t.redistribute(mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in placements])


class _UnflattenableGrad(torch.autograd.Function):
    """The identity; its backward makes the gradient :func:`unflattenable`
    along ``dim``."""

    @staticmethod
    def forward(ctx, t, dim, outer):
        ctx.dim, ctx.outer = dim, outer
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return unflattenable(g, ctx.dim, ctx.outer), None, None


def flattenable(t: torch.Tensor, first: int, last: int) -> torch.Tensor:
    """``t``, ready for a view that flattens dimensions ``first`` ..
    ``last``: a ``DTensor`` split on one of them after the first has that
    split replicated. PyTorch 2.11's DTensor refuses such a flatten (2.13
    makes a strided shard of it)."""
    placements = getattr(t, "placements", None)
    if placements is None:
        return t
    from torch.distributed.tensor import Replicate, Shard

    inner = range(first % t.ndim + 1, last % t.ndim + 1)
    keep = [Replicate() if isinstance(p, Shard) and p.dim in inner else p
            for p in placements]
    return t if keep == list(placements) else t.redistribute(t.device_mesh,
                                                             keep)


def _merged(t: torch.Tensor, first: int, last: int,
            shape: tuple) -> torch.Tensor:
    """``t`` with dimensions ``first`` .. ``last`` flattened (to
    ``shape``), :func:`flattenable` first; on a ``DTensor`` its gradient
    is made :func:`unflattenable` for the backward's view back."""
    t = flattenable(t, first, last)
    out = t.reshape(shape)
    if getattr(out, "placements", None) is None:
        return out
    return _UnflattenableGrad.apply(out, first, t.shape[first])


def merge_heads(t: torch.Tensor, groups: int) -> torch.Tensor:
    """``t`` (B, S, groups, G, Dh) flattened to (B, S, groups * G, Dh)
    (:func:`_merged`)."""
    B, S, _, G, Dh = t.shape
    return _merged(t, 2, 3, (B, S, groups * G, Dh))


def flatten_heads(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, S, H, Dh) flattened to (B, S, H * Dh) (:func:`_merged`)."""
    B, S, H, Dh = t.shape
    return _merged(t, 2, 3, (B, S, H * Dh))


def split_heads(t: torch.Tensor, heads: int, dh: int) -> torch.Tensor:
    """``t`` (..., heads * dh) viewed as (..., heads, dh)
    (:func:`unflattenable` first)."""
    t = unflattenable(t, -1, heads)
    return t.reshape(*t.shape[:-1], heads, dh)


def _einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with :func:`_even` operands; on ``DTensor`` s that
    only batch labels split, on each rank's blocks (:func:`_batch_local`)."""
    operands = tuple(map(_even, operands))
    local = _batch_local(eq, operands)
    return torch.einsum(eq, *operands) if local is None else local


def _batch_local(eq: str, operands) -> torch.Tensor | None:
    """The einsum of ``DTensor`` operands computed on each rank's blocks,
    when every mesh axis that splits anything splits one batch label (a
    label of every operand and of the output) in every operand: each
    rank's result is then the einsum of its blocks, with no collective.
    DTensor's own einsum flattens the batch labels into one for its
    product, which PyTorch 2.11 refuses when a label after the first is
    split (attention's (batch, kv heads) on a (data, model) mesh). None
    where the rule does not apply (a plain operand, a pending sum, a
    split contraction)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not operands or not all(isinstance(o, DTensor) for o in operands):
        return None
    lhs, out = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    mesh = operands[0].device_mesh
    if "." in lhs or any(o.device_mesh != mesh for o in operands):
        return None
    placements, split = [], []
    for m in range(mesh.ndim):
        labels = []
        for term, o in zip(terms, operands):
            p = o.placements[m]
            if not (isinstance(p, Shard) or p.is_replicate()):
                return None
            if isinstance(p, Shard):
                labels.append(term[p.dim])
        if not labels:
            placements.append(Replicate())
            split.append(None)
            continue
        label = labels[0]
        if label not in out or any(label not in term for term in terms):
            return None
        placements.append(Shard(out.index(label)))
        split.append(label)
    if all(p.is_replicate() for p in placements):
        return None
    # an operand laid out otherwise on a mesh axis (an older PyTorch's
    # strategy may leave one replicated, or split elsewhere) is moved onto
    # the first operand's batch label: a replicated one keeps its block
    operands = tuple(
        o if all(p == (Shard(term.index(lb)) if lb else Replicate())
                 for p, lb in zip(o.placements, split))
        else o.redistribute(mesh, [Shard(term.index(lb)) if lb
                                   else Replicate() for lb in split])
        for term, o in zip(terms, operands))
    # the split is even (``_even``): the global shape follows from the
    # block's; blocks and their gradients are kept contiguous, as DTensor's
    # views of them expect
    local = torch.einsum(eq, *(_ContiguousGrad.apply(o.to_local())
                               for o in operands)).contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """The identity; its backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _mm(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum`` of an activation and a weight in their promoted dtype (JAX
    promotes mixed bfloat16 / float32 operands, ``torch.einsum`` refuses
    them). The einsum flattens the activation's own labels (batch,
    sequence) into one: a split of the sequence (the sequence-parallel
    layout) is replicated first (:func:`flattenable`), the all-gather at
    the sequence-parallel boundary."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if getattr(x, "placements", None) is not None:
        lhs, out = eq.replace(" ", "").split("->")
        xt, wt = lhs.split(",")
        own = [i for i, lb in enumerate(xt) if lb in out and lb not in wt]
        if len(own) > 1 and own == list(range(own[0], own[-1] + 1)):
            x = flattenable(x, own[0], own[-1])
    return _einsum(eq, x, w)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the scale applied as ``1 + scale``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in float32 (population variance), cast back to x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------
def rope(positions: torch.Tensor, head_dim: int, theta: float = 10_000.0,
         dtype: torch.dtype = torch.float32):
    """positions: (..., S) -> cos, sin of shape (..., S, head_dim / 2).

    Frequencies and angles in float32, as the reference's
    ``theta ** (arange(0, Dh, 2) / Dh)``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); cos / sin: (B, S, Dh / 2) or (S, Dh / 2). Rotates
    the two halves of every head in float32 and casts back."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def mlp(x: torch.Tensor, params: dict, act: str) -> torch.Tensor:
    """act in {swiglu, geglu, gelu, relu2}. Gated acts use wi_0 (gate) and
    wi_1; the others take the optional biases bi_0 / bo."""
    if act in ("swiglu", "geglu"):
        g = _mm("bsd,df->bsf", x, params["wi_0"])
        u = _mm("bsd,df->bsf", x, params["wi_1"])
        g = F.silu(g.float()) if act == "swiglu" else _gelu(g.float())
        h = (g * u.float()).to(x.dtype)
    else:
        h = _mm("bsd,df->bsf", x, params["wi_0"])
        if act == "gelu":
            h = _gelu(h.float()).to(x.dtype)
        elif act == "relu2":  # squared ReLU (Nemotron-4)
            h32 = torch.clamp_min(h.float(), 0.0)
            h = (h32 * h32).to(x.dtype)
        else:
            raise ValueError(act)
        if "bi_0" in params:
            h = h + params["bi_0"].to(h.dtype)
    out = _mm("bsf,fd->bsd", h, params["wo"])
    if "bo" in params:
        out = out + params["bo"].to(out.dtype)
    return out


def mlp_params(act: str, d_model: int, d_ff: int, bias: bool = False):
    """(name -> (shape, logical_axes, fan_in)) table entries for an MLP."""
    table = {}
    if act in ("swiglu", "geglu"):
        table["wi_0"] = ((d_model, d_ff), ("embed", "mlp"), d_model)
        table["wi_1"] = ((d_model, d_ff), ("embed", "mlp"), d_model)
    else:
        table["wi_0"] = ((d_model, d_ff), ("embed", "mlp"), d_model)
        if bias:
            table["bi_0"] = ((d_ff,), ("mlp",), None)
    table["wo"] = ((d_ff, d_model), ("mlp", "embed"), d_ff)
    if bias:
        table["bo"] = ((d_model,), ("embed",), None)
    return table


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def _visible(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
             window) -> torch.Tensor:
    """(cq, ck) bool: which keys each query may attend to."""
    ok = torch.ones(q_pos.shape[0], k_pos.shape[1], dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


def _plain_attention(q, k, v, causal, window, q_offset):
    """q: (B, Sq, Hq, Dh), k/v: (B, Sk, Hkv, Dh). Full score matrix."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = unflattenable(q, 2, Hkv).reshape(B, Sq, Hkv, G, Dh)
    scores = _einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(Dh)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = _visible(qpos, kpos, causal, window)
    scores = torch.where(ok, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = _einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return merge_heads(out, Hkv)


def _chunked_attention(q, k, v, causal, window, q_chunk, kv_chunk):
    """Query blocks against key blocks with an online softmax; O(cq * ck)
    score memory."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    qs = unflattenable(unflattenable(q, 1, nq), 2, Hkv).reshape(
        B, nq, q_chunk, Hkv, G, Dh)
    ks = unflattenable(k, 1, nk).reshape(B, nk, kv_chunk, Hkv, Dh)
    vs = unflattenable(v, 1, nk).reshape(B, nk, kv_chunk, Hkv, Dh)
    scale = 1.0 / math.sqrt(Dh)
    outs = []
    for qi in range(nq):
        qb = qs[:, qi]                                   # (B, cq, Hkv, G, Dh)
        m = torch.full((B, Hkv, G, q_chunk), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, Hkv, G, q_chunk, Dh), dtype=torch.float32,
                          device=q.device)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)[:, None]
        for ki in range(nk):
            s = _einsum("bqhgd,bkhd->bhgqk", qb, ks[:, ki]).float() * scale
            kpos = ki * kv_chunk + torch.arange(kv_chunk,
                                                device=q.device)[None, :]
            ok = _visible(qpos, kpos, causal, window)
            s = torch.where(ok, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _einsum(
                "bhgqk,bkhd->bhgqd", p, vs[:, ki].float())
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(_einsum("bhgqd->bqhgd", out))   # (B, cq, Hkv, G, Dh)
    out = merge_heads(torch.cat(outs, dim=1), Hkv)
    return out.to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0,
              q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Dispatch between plain and chunked attention on the sequence length,
    by the reference's rule: chunked when ``Sq > max(q_chunk, 1024)`` and
    both lengths divide into their chunks."""
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq <= max(q_chunk, 1024) or Sq % q_chunk or Sk % kv_chunk:
        return _plain_attention(q, k, v, causal, window, q_offset)
    return _chunked_attention(q, k, v, causal, window, q_chunk, kv_chunk)


def decode_attention(q, k_cache, v_cache, cache_len, window=None):
    """One query position against a whole KV cache.

    q: (B, 1, Hq, Dh); k / v_cache: (B, T, Hkv, Dh); ``cache_len``: the
    count of valid entries (a 0-d device tensor or an int; the new token is
    already written at ``cache_len - 1``). The scores are float32 over all T
    positions, ``-1e30`` where a position is not below ``cache_len`` (or
    falls outside the window), and the softmax is cast to the cache's dtype
    before the value product, as the reference's.
    """
    B, T, Hkv, Dh = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    qg = unflattenable(q, 2, Hkv).reshape(B, 1, Hkv, G, Dh)
    s = _einsum("bqhgd,bkhd->bhgqk", qg, k_cache).float()
    s = s / math.sqrt(Dh)
    kpos = torch.arange(T, device=q.device)
    valid = kpos < cache_len
    if window is not None:
        valid &= kpos >= cache_len - window
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = _einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype), v_cache)
    return merge_heads(out, Hkv)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
def _vocab_parallel_nll(logits, lc):
    """Per-token NLL (and validity) of ``logits``, a ``DTensor`` laid out
    over the mesh, as ``DTensor`` s of the (B, S) token layout.

    Each rank works on its block of the logits. Where the vocab axis is
    split, a rank gathers the gold logit only for labels inside its block
    ``[lo, hi)`` (the others give zero), and the gold logits and the sums
    of exps (shifted by the max over the vocab ranks) are summed over the
    vocab groups: every vocab rank then holds the same NLL. Where it is not
    split, a rank runs the one-device ops on its block."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from ..distributed.sharding import sum_to_replicas

    mesh = logits.device_mesh
    if any(isinstance(p, Partial) for p in logits.placements):
        logits = logits.redistribute(mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in logits.placements])
    placements = logits.placements
    vocab_dims = [i for i, p in enumerate(placements)
                  if isinstance(p, Shard) and p.dim == 2]
    tok = [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
           for p in placements]
    if not isinstance(lc, DTensor):
        lc = DTensor.from_local(lc, mesh, [Replicate()] * mesh.ndim,
                                run_check=False)
    lc = lc.redistribute(mesh, tok).to_local()
    local = logits.to_local()
    ids = torch.clamp_min(lc, 0).long()[..., None]
    if not vocab_dims:
        lse = torch.logsumexp(local, dim=-1)
        gold = torch.gather(local, -1, ids)[..., 0]
    else:
        _, offset = compute_local_shape_and_global_offset(
            logits.shape, mesh, placements)
        lo = offset[2]
        inside = (ids >= lo) & (ids < lo + local.shape[2])
        gold = torch.gather(local, -1, torch.where(inside, ids - lo, 0))
        gold = torch.where(inside, gold, 0.0)[..., 0]
        groups = [mesh.get_group(i) for i in vocab_dims]
        top = local.detach().amax(dim=-1)
        for group in groups:
            torch.distributed.all_reduce(
                top, op=torch.distributed.ReduceOp.MAX, group=group)
        sumexp = torch.sum(torch.exp(local - top[..., None]), dim=-1)
        lse = top + torch.log(sum_to_replicas(sumexp, groups))
        gold = sum_to_replicas(gold, groups)
    valid = (lc >= 0).float()
    wrap = lambda t: DTensor.from_local(t, mesh, tok, run_check=False)
    return wrap((lse - gold) * valid), wrap(valid)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """``table[tokens]`` (cast to ``dtype``), rows of a (V, D) table.

    On a plain tensor, the one-device lookup. On a ``DTensor``, each rank
    looks its tokens up in its block ``[lo, hi)`` of the rows (and of the
    columns, where those are split): a token outside the block gives a zero
    row, and the rows are summed over the vocab axes, so no rank gathers
    the table. The tokens are replicated over the table's axes first (they
    are small); the result keeps the tokens' split elsewhere and the
    columns' split. Its backward is each rank's scatter into its own block
    (DTensor's own lookup, whose backward is an ``index_put``, is what
    PyTorch 2.11 refuses on a batch-split index)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    placements = getattr(table, "placements", None)
    if placements is None:
        out = table[tokens]
        return out if dtype is None else out.to(dtype)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from ..distributed.sharding import contiguous_stride, sum_to_replicas

    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok = [Replicate() if isinstance(p, Shard) or not isinstance(q, Shard)
           else q for p, q in zip(placements, tokens.placements)]
    ids = tokens.redistribute(mesh, tok).to_local().long()
    rows, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, placements)
    # where the table is whole and the tokens split, each rank's gradient
    # is its tokens' share of the whole one
    local = table.to_local(grad_placements=[
        Partial() if p.is_replicate() and isinstance(q, Shard) else p
        for p, q in zip(placements, tok)])
    if dtype is not None:
        local = local.to(dtype)
    lo = offset[0]
    if rows[0] == table.shape[0]:
        out = local[ids]
    else:
        inside = (ids >= lo) & (ids < lo + rows[0])
        out = torch.where(inside[..., None],
                          local[torch.clamp(ids - lo, 0, rows[0] - 1)], 0.0)
    vocab = [i for i, p in enumerate(placements) if p == Shard(0)]
    if vocab:
        out = sum_to_replicas(out, [mesh.get_group(i) for i in vocab])
    shape = (*tokens.shape, table.shape[1])
    last = len(shape) - 1
    result = [Shard(last) if p == Shard(1) else
              Replicate() if p == Shard(0) else q
              for p, q in zip(placements, tok)]
    return DTensor.from_local(out, mesh, result, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _ce_chunk(xc, embed, lc, logit_cap):
    """Summed NLL and valid-label count of one sequence chunk (a
    ``DTensor`` chunk's through :func:`_vocab_parallel_nll`)."""
    # the einsum flattens (batch, sequence): a sequence split is replicated
    # first, as in ``_mm``
    logits = _einsum("bsd,vd->bsv", flattenable(xc, 0, 1), embed).float()
    if logit_cap is not None:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    if hasattr(logits, "device_mesh") and not all(
            p.is_replicate() for p in logits.placements):
        nll, valid = _vocab_parallel_nll(logits, lc)
        return torch.sum(nll), torch.sum(valid)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp_min(lc, 0).long()[..., None])[..., 0]
    valid = (lc >= 0).float()
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def chunked_ce_loss(x: torch.Tensor, embed: torch.Tensor,
                    labels: torch.Tensor, *, chunk: int = 512,
                    logit_cap: float | None = None) -> torch.Tensor:
    """Cross-entropy with the float32 logits computed per sequence chunk.

    x: (B, S, D); embed: (V, D) output table; labels (B, S) with -1 =
    ignore. A sequence that does not divide into chunks is one chunk. Returns
    the summed NLL over the count of valid labels (at least 1).
    """
    B, S, D = x.shape
    chunk = min(chunk, S)
    if S % chunk != 0:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, S, chunk):
        args = (x[:, start:start + chunk], embed,
                labels[:, start:start + chunk], logit_cap)
        if torch.is_grad_enabled():
            nll, valid = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            nll, valid = _ce_chunk(*args)
        total = total + nll
        count = count + valid
    return total / torch.clamp_min(count, 1.0)


class Cache(NamedTuple):
    """Decode-time KV cache of one attention stack (stacked over layers)."""
    k: torch.Tensor        # (L, B, T, Hkv, Dh)
    v: torch.Tensor        # (L, B, T, Hkv, Dh)
    length: torch.Tensor   # 0-d int32: the count of valid positions


# --------------------------------------------------------------------------
# caches on a mesh
# --------------------------------------------------------------------------
def mesh_of(x: torch.Tensor):
    """The ``DeviceMesh`` of a ``DTensor``, ``None`` for a plain tensor."""
    return getattr(x, "device_mesh", None)


def cache_zeros(shape, dtype: torch.dtype, device, mesh=None,
                fill=0) -> torch.Tensor:
    """A cache leaf filled with ``fill``: a plain tensor on ``device``, or on
    a mesh a ``DTensor`` in the prefill's cache layout (the reference's
    ``cache_shardings(batch, "width")`` rule), whose blocks live on the
    ``meta`` device when ``device`` is ``meta`` (the dry run's)."""
    if mesh is None:
        return torch.full(shape, fill, dtype=dtype, device=device)
    from torch.distributed.tensor import full

    from ..distributed.sharding import (NamedSharding, cache_spec,
                                        placed_zeros, spec_placements)
    spec = cache_spec(shape, dtype, mesh, prefer="width")
    if torch.device(device).type == "meta":
        return placed_zeros(shape, dtype, NamedSharding(mesh, spec), device)
    return full(shape, fill, dtype=dtype, device_mesh=mesh,
                placements=spec_placements(spec, mesh))


def write_all(d: torch.Tensor, s: torch.Tensor) -> None:
    """A writer for :func:`write_layer`: the whole layer."""
    d.copy_(s)


def write_prefix(d: torch.Tensor, s: torch.Tensor) -> None:
    """A writer for :func:`write_layer`: positions [0, S) of a (B, T, ...)
    layer from a (B, S, ...) source."""
    d[:, :s.shape[1]] = s


def write_at(at: torch.Tensor):
    """A writer for :func:`write_layer`: a (B, 1, ...) entry at index
    ``at`` (a 1-element device tensor) of a (B, T, ...) layer."""
    def write(d, s):
        d.index_copy_(1, at, s.to(d.dtype))
    return write


def write_layer(dst: torch.Tensor, layer: int, src: torch.Tensor, write,
                along: int | None = None) -> None:
    """``write(dst[layer], src)``: an in-place write into one layer of a
    stacked (L, ...) cache leaf.

    On a ``DTensor`` ``dst`` (a cache on a mesh) ``src`` is first laid out
    as ``dst[layer]`` is and the write runs on every rank's own block, which
    is exact as long as the dimension the write indexes (``along``, of
    ``dst[layer]``: the time or window-slot axis) is not sharded; the
    prefill's 'width' cache layout never shards it.
    """
    mesh = mesh_of(dst)
    if mesh is None:
        write(dst[layer], src)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = []
    for p in dst.placements:
        if isinstance(p, Shard):
            if p.dim == 0 or p.dim - 1 == along:
                raise ValueError(f"a cache write along a sharded dimension "
                                 f"({dst.placements}, along {along})")
            placements.append(Shard(p.dim - 1))
        else:
            placements.append(Replicate())
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src.contiguous(), mesh,
                                 [Replicate()] * mesh.ndim, run_check=False)
    src = src.redistribute(mesh, placements)
    write(dst.to_local()[layer], src.to_local())
