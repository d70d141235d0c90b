"""Decoder-only transformer LM (dense / MoE / VLM prefix) and the parameter
tables (counterpart of ``repro.models.transformer``).

One implementation covers stablelm-12b, nemotron-4-15b, phi3-medium-14b,
qwen2-72b, llava-next-mistral-7b (patch-embedding prefix), arctic-480b and
qwen3-moe-235b (MoE FFN, optional parallel dense residual, optional QK-norm).

A table maps a ``/``-joined path to ``(shape, logical_axes, fan_in or
None)``; :func:`build_params` turns it into a nested dict of tensors that
mirrors the reference's pytree, :func:`table_logical` into the same nesting
of logical axes. Every layer's weights are stacked on a leading (L, ...)
axis, so a reference parameter tree carries across one to one
(``convert.tree_from_numpy``). Where the reference scans over layers, this
module loops in Python; its ``lax.switch`` over ``layer_windows`` is a
branch on ``layer % len(windows)``. With ``cfg.remat`` each layer is
recomputed in the backward pass under autograd (``torch.utils.checkpoint``),
as the reference's ``jax.checkpoint``; that changes no value.

Serving: :func:`decoder_prefill` fills a KV :class:`Cache` of ``max_len``
positions; :func:`decoder_decode_step` writes the new token's K / V at the
cache's ``length`` (a 0-d device int32, so no step reads the device), with
the start clamped to the last position as XLA's ``dynamic_update_slice``
clamps it, and attends over the whole cache with the tail masked. A decode
step returns a new cache and leaves its argument as it was.

On a mesh (``train.trainer.make_serve_steps(..., mesh=...)``) the
parameters are ``DTensor`` s and every function takes the reference's
``constrain(tensor, logical_axes)`` hook, called at the reference's sites
(default: the identity). The cache is created in the prefill's layout and
written on each rank's block (``layers.write_layer``); the MoE takes its
expert-parallel path when the active mesh splits the experts
(:func:`_ffn`).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..distributed.sharding import get_active_mesh, keyed_block, mesh_shape
from .layers import (Cache, _einsum, _mm, apply_rope, attention, cache_zeros,
                     chunked_ce_loss, decode_attention, embed_lookup,
                     flatten_heads, identity_constrain, mesh_of, mlp,
                     mlp_params, rms_norm, rope, split_heads, write_at,
                     write_layer, write_prefix)
from .moe import (moe_ffn, moe_ffn_sharded, moe_ffn_sharded_decode,
                  moe_param_table)

__all__ = ["decoder_param_table", "decoder_layer_table", "build_params",
           "table_logical", "decoder_forward", "decoder_loss",
           "decoder_prefill", "decoder_decode_step", "init_decoder_cache"]

_NORM_SUFFIXES = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def zero_init(name: str) -> bool:
    """Whether :func:`build_params` makes the leaf ``name`` zero (no draw):
    norm scales by suffix, ``*/b*`` and ``b*`` entries."""
    return name.endswith(_NORM_SUFFIXES) or "/b" in name \
        or name.startswith("b")


def init_std(name: str, fan) -> float:
    """The standard deviation :func:`build_params` draws the leaf ``name``
    with: 0 for a zero leaf, ``fan ** -0.5`` with a fan-in, else 0.02."""
    return 0.0 if zero_init(name) else 0.02 if fan is None else fan ** -0.5


# --------------------------------------------------------------------------
# parameter tables:  path -> (shape, logical_axes, fan_in or None)
# --------------------------------------------------------------------------
def _attn_table(cfg):
    D, Hq, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = {
        "ln1": ((D,), ("embed",), None),
        "wq": ((D, Hq * Dh), ("embed", "heads_fused"), D),
        "wk": ((D, Hkv * Dh), ("embed", "kv_fused"), D),
        "wv": ((D, Hkv * Dh), ("embed", "kv_fused"), D),
        "wo": ((Hq * Dh, D), ("heads_fused", "embed"), Hq * Dh),
    }
    if cfg.qkv_bias:
        t["bq"] = ((Hq * Dh,), ("heads_fused",), None)
        t["bk"] = ((Hkv * Dh,), ("kv_fused",), None)
        t["bv"] = ((Hkv * Dh,), ("kv_fused",), None)
    if cfg.qk_norm:
        t["q_norm"] = ((Dh,), (None,), None)
        t["k_norm"] = ((Dh,), (None,), None)
    return t


def decoder_layer_table(cfg):
    t = dict(_attn_table(cfg))
    t["ln2"] = ((cfg.d_model,), ("embed",), None)
    if cfg.moe:
        for k, v in moe_param_table(cfg).items():
            t[f"moe/{k}"] = v
        if cfg.moe_dense_residual:
            for k, v in mlp_params(cfg.mlp_act, cfg.d_model,
                                   cfg.d_ff).items():
                t[f"residual_mlp/{k}"] = v
    else:
        for k, v in mlp_params(cfg.mlp_act, cfg.d_model, cfg.d_ff,
                               bias=cfg.mlp_bias).items():
            t[f"mlp/{k}"] = v
    return t


def decoder_param_table(cfg):
    table = {
        "embed": ((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), None),
        "final_norm": ((cfg.d_model,), ("embed",), None),
    }
    for k, v in decoder_layer_table(cfg).items():
        shape, logical, fan = v
        table[f"layers/{k}"] = ((cfg.num_layers, *shape),
                                ("layers", *logical), fan)
    return table


def build_params(generator: torch.Generator, table: dict,
                 dtype: torch.dtype = torch.float32, place=None) -> dict:
    """Materialise a parameter tree from a table on ``generator``'s device.

    The reference's rules by name: norm scales (by suffix), ``*/b*`` and
    ``b*`` entries are zero; an entry with a fan-in is ``fan ** -0.5`` times
    a standard normal, one without ``0.02`` times it, drawn in float32 and
    cast to ``dtype``.

    The normals are the port's keyed stream, a stream of its own
    (``sharding.keyed_block``): each value is a pure function of the seed,
    the leaf's name and its position in the leaf, drawn slab by slab from
    generators seeded by a hash of the three, so it depends on neither the
    mesh, the rank, nor the order of the draws. The seed is
    ``generator.initial_seed()``: draws made earlier on ``generator`` do not
    shift the values, and ``generator`` itself is not advanced. The values
    equal neither the reference's (the PRNGs differ; carry its parameters
    across with :mod:`repro_torch.convert` where equal values are needed)
    nor those of the port's earlier one-stream-per-model draw.

    ``place(name, seed, std, dtype, device)``, when given, makes each leaf
    instead (``sharding.param_placer``: this rank's block on a mesh, drawn
    by ``keyed_block``), so a rank holds its blocks plus one slab at a time
    and never a whole leaf; the blocks of every rank together equal the
    one-device leaves bit for bit.
    """
    seed = generator.initial_seed()
    dev = generator.device
    params: dict[str, Any] = {}
    for name in sorted(table):
        shape, _, fan = table[name]
        std = init_std(name, fan)
        if place is None:
            arr = keyed_block(seed, name, shape, std, (None,) * len(shape),
                              {}, {}, dtype, dev)
        else:
            arr = place(name, seed, std, dtype, dev)
        _assign(params, name, arr)
    return params


def table_logical(table: dict) -> dict:
    """The table's logical axes, nested as :func:`build_params` nests."""
    out: dict[str, Any] = {}
    for name, (_, logical, _) in table.items():
        _assign(out, name, logical)
    return out


def _assign(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def _layer(layers: dict, l: int) -> dict:
    """Layer ``l``'s parameters: a view of each stacked leaf."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in layers.items()}


def _window(cfg, l: int):
    """Layer ``l``'s attention window (the reference's ``lax.switch``)."""
    windows = cfg.layer_windows
    return cfg.window if windows is None else windows[l % len(windows)]


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
def _project_qkv(x, p, cfg):
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _mm("bsd,dh->bsh", x, p["wq"])
    k = _mm("bsd,dh->bsh", x, p["wk"])
    v = _mm("bsd,dh->bsh", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = split_heads(q, Hq, Dh)
    k = split_heads(k, Hkv, Dh)
    v = split_heads(v, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _ffn(x, p, cfg, constrain=identity_constrain):
    if cfg.moe:
        mesh = get_active_mesh()
        tp = 1 if mesh is None else mesh_shape(mesh).get("model", 1)
        if tp > 1 and cfg.num_experts % tp == 0:
            if x.shape[0] * x.shape[1] <= 4096:
                # decode-sized batches: resident weights, gathered tokens
                out = moe_ffn_sharded_decode(x, p["moe"], cfg, mesh)
            else:
                # expert parallel: tokens over data, experts over model
                out = moe_ffn_sharded(x, p["moe"], cfg, mesh)
        else:
            out = moe_ffn(x, p["moe"], cfg, cfg.num_moe_groups, constrain)
        if cfg.moe_dense_residual:
            out = out + mlp(x, p["residual_mlp"], cfg.mlp_act)
        return out
    return mlp(x, p["mlp"], cfg.mlp_act)


def _attn_out(a, p):
    return _mm("bsh,hd->bsd", flatten_heads(a), p["wo"])


def _qkv_rope(x, p, cfg, cos, sin):
    """The pre-norm, the projections and the rotary embedding of a block."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(h, p, cfg)
    if cfg.use_rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


_ACT = (("batch",), "seq", "embed")


def _decoder_layer(x, p, cfg, cos, sin, layer_window,
                   constrain=identity_constrain, constrain_q=False):
    """One block over a whole sequence: (new x, its K, its V). The
    reference's forward constrains q, its prefill does not."""
    q, k, v = _qkv_rope(x, p, cfg, cos, sin)
    if constrain_q:
        q = constrain(q, (("batch",), None, "heads", None))
    a = attention(q, k, v, causal=True, window=layer_window,
                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = x + constrain(_attn_out(a, p), _ACT)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + constrain(_ffn(h, p, cfg, constrain), _ACT), k, v


def _run_layers(params, x, cfg, cos, sin, cache=None,
                constrain=identity_constrain):
    """Every block in order; with ``cache``, each block's K / V are written
    at its positions [0, S)."""
    remat = cfg.remat and torch.is_grad_enabled()
    for l in range(cfg.num_layers):
        args = (x, _layer(params["layers"], l), cfg, cos, sin,
                _window(cfg, l), constrain, cache is None)
        if remat:
            x, k, v = checkpoint(_decoder_layer, *args, use_reentrant=False)
        else:
            x, k, v = _decoder_layer(*args)
        if cache is not None:
            write_layer(cache.k, l, k, write_prefix, along=1)
            write_layer(cache.v, l, v, write_prefix, along=1)
    return x


def _embed(params, tokens, cfg, prefix_embeds=None):
    x = embed_lookup(params["embed"], tokens, cfg.dtype_act)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    if cfg.scale_embed:
        x = x * cfg.d_model ** 0.5
    return x


def _logits(params, x, cfg, constrain=None):
    """Tied output head (the embedding), with the optional logit cap; the
    decode step's logits (B, 1, V) are constrained."""
    logits = _einsum("...d,vd->...v", x, params["embed"].to(x.dtype))
    if constrain is not None:
        logits = constrain(logits, (("batch",), None, "vocab"))
    if cfg.final_logit_cap is not None:
        logits = cfg.final_logit_cap * torch.tanh(logits
                                                  / cfg.final_logit_cap)
    return logits


# --------------------------------------------------------------------------
# forward / loss / serve
# --------------------------------------------------------------------------
def decoder_forward(params, tokens, cfg, *, prefix_embeds=None,
                    constrain=identity_constrain):
    """tokens: (B, S_text) int; prefix_embeds: (B, P, D) or None.

    Returns the final hidden states (B, P + S_text, D).
    """
    x = constrain(_embed(params, tokens, cfg, prefix_embeds), _ACT)
    S = x.shape[1]
    cos, sin = rope(torch.arange(S, device=x.device), cfg.head_dim,
                    cfg.rope_theta)
    x = _run_layers(params, x, cfg, cos, sin, constrain=constrain)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def decoder_loss(params, batch, cfg, constrain=identity_constrain):
    prefix = batch.get("prefix_embeds")
    x = decoder_forward(params, batch["tokens"], cfg, prefix_embeds=prefix,
                        constrain=constrain)
    P = 0 if prefix is None else prefix.shape[1]
    return chunked_ce_loss(x[:, P:, :], params["embed"].to(cfg.dtype_act),
                           batch["labels"], chunk=cfg.loss_chunk,
                           logit_cap=cfg.final_logit_cap)


def init_decoder_cache(cfg, batch, max_len, dtype, device=None,
                       mesh=None) -> Cache:
    """An empty cache of ``max_len`` positions on ``device`` (``None``: the
    GPU), or on ``mesh`` in the prefill's layout."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return Cache(k=cache_zeros(shape, dtype, dev, mesh),
                 v=cache_zeros(shape, dtype, dev, mesh),
                 length=torch.zeros((), dtype=torch.int32, device=dev))


def _decode_layer(x, lp, cache_k, cache_v, l, at, length, cfg, cos, sin,
                  layer_window, constrain=identity_constrain):
    """One block for one new position: K / V written into layer ``l`` of
    ``cache_k`` / ``cache_v`` (L, B, T, Hkv, Dh) at index ``at``."""
    q, k, v = _qkv_rope(x, lp, cfg, cos, sin)
    write_layer(cache_k, l, k, write_at(at), along=1)
    write_layer(cache_v, l, v, write_at(at), along=1)
    a = decode_attention(q, cache_k[l], cache_v[l], length + 1,
                         window=layer_window)
    x = x + _attn_out(a, lp)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _ffn(h, lp, cfg, constrain)


def decoder_decode_step(params, cache: Cache, tokens, cfg,
                        constrain=identity_constrain):
    """One greedy decode step. tokens: (B, 1) -> (logits (B, V), new cache).

    The new K / V go to position ``cache.length``, clamped to the cache's
    last position (XLA's ``dynamic_update_slice`` rule: a full cache is
    overwritten at its end, not refused).
    """
    x = _embed(params, tokens, cfg)
    pos = cache.length
    cos, sin = rope(torch.arange(1, device=x.device) + pos, cfg.head_dim,
                    cfg.rope_theta)
    T = cache.k.shape[2]
    at = torch.clamp(pos, 0, T - 1).long().reshape(1)
    new_k, new_v = cache.k.clone(), cache.v.clone()
    for l in range(cfg.num_layers):
        x = _decode_layer(x, _layer(params["layers"], l), new_k, new_v, l,
                          at, pos, cfg, cos, sin, _window(cfg, l), constrain)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x, cfg, constrain)
    return logits[:, 0], Cache(k=new_k, v=new_v, length=cache.length + 1)


def decoder_prefill(params, batch, cfg, max_len,
                    constrain=identity_constrain):
    """Process a full prompt (and the VLM's prefix), return (last position's
    logits (B, V), a cache of ``max_len`` positions holding its K / V)."""
    x = constrain(_embed(params, batch["tokens"], cfg,
                         batch.get("prefix_embeds")), _ACT)
    B, S = x.shape[:2]
    if S > max_len:
        raise ValueError(f"a prompt of {S} positions does not fit a cache "
                         f"of max_len {max_len}")
    cos, sin = rope(torch.arange(S, device=x.device), cfg.head_dim,
                    cfg.rope_theta)
    cache = init_decoder_cache(cfg, B, max_len, cfg.dtype_act, x.device,
                               mesh_of(x))
    x = _run_layers(params, x, cfg, cos, sin, cache, constrain)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x[:, -1, :], cfg)
    return logits, cache._replace(
        length=torch.tensor(S, dtype=torch.int32, device=x.device))
