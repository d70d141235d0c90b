"""Whisper-style encoder-decoder transformer (whisper-tiny backbone) in
PyTorch (counterpart of ``repro.models.encdec``).

The audio conv frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (B, frames, D), the output of the two-conv mel
frontend. Encoder: bidirectional MHA + GELU MLP, float32 sinusoidal
positions cast to the activation dtype, pre-LN. Decoder: learned positions
(``dec_pos``), causal self-attention, cross-attention over the encoder
output, tied embedding head. Every norm is ``layer_norm(x, 1 + scale,
bias)``; the K projections have no bias.

Parameters are the reference's tree, each stack's weights on a leading
(L, ...) axis; where the reference scans over layers this module loops in
Python, each layer's parameters views of the stacked leaves. With
``cfg.remat`` each layer is recomputed in the backward pass under autograd
(``torch.utils.checkpoint``); that changes no value. Every function takes
the reference's ``constrain`` hook (default: the identity), called where
the reference calls it: the encoder's input and the training decoder's.

Serving: :func:`encdec_prefill` runs the encoder once, caches each decoder
layer's self-attention K / V of the prompt in a cache of ``max_len``
positions and its cross-attention K / V over all frames;
:func:`encdec_decode_step` writes the new token's K / V at the cache's
``length`` (a 0-d device int32: no host read), with the start clamped to the
last position as XLA's ``dynamic_update_slice`` clamps it, and returns a new
cache, leaving its argument as it was. The cross cache is static and passes
through uncopied. On a mesh the caches are created in the prefill's layout
and written on each rank's block (``layers.write_layer``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from .layers import (_einsum, _mm, attention, cache_zeros, chunked_ce_loss,
                     decode_attention, embed_lookup, flatten_heads,
                     identity_constrain, layer_norm, mesh_of, mlp,
                     mlp_params, split_heads, write_all, write_at,
                     write_layer, write_prefix)
from .transformer import _layer

__all__ = ["encdec_layer_table", "encdec_param_table", "encode",
           "decode_train", "encdec_loss", "encdec_prefill",
           "encdec_decode_step", "init_encdec_cache", "EncDecCache"]

_DEC_POS = 32768      # rows of dec_pos: ModelConfig has no max_dec_len


class EncDecCache(NamedTuple):
    k: torch.Tensor        # (L, B, T, H, Dh) decoder self-attention K
    v: torch.Tensor
    xk: torch.Tensor       # (L, B, F, H, Dh) cross-attention K (static)
    xv: torch.Tensor
    length: torch.Tensor   # 0-d int32: the count of valid positions


def _mha_table(cfg, prefix):
    D, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        f"{prefix}wq": ((D, H * Dh), ("embed", "heads_fused"), D),
        f"{prefix}bq": ((H * Dh,), ("heads_fused",), None),
        f"{prefix}wk": ((D, H * Dh), ("embed", "heads_fused"), D),
        f"{prefix}wv": ((D, H * Dh), ("embed", "heads_fused"), D),
        f"{prefix}bv": ((H * Dh,), ("heads_fused",), None),
        f"{prefix}wo": ((H * Dh, D), ("heads_fused", "embed"), H * Dh),
        f"{prefix}bo": ((D,), ("embed",), None),
    }


def _ln_table(cfg, name):
    return {f"{name}": ((cfg.d_model,), ("embed",), None),
            f"{name}_b": ((cfg.d_model,), ("embed",), None)}


def encdec_layer_table(cfg, cross: bool):
    t = {}
    t.update(_ln_table(cfg, "ln1"))
    t.update(_mha_table(cfg, "attn/"))
    if cross:
        t.update(_ln_table(cfg, "lnx"))
        t.update(_mha_table(cfg, "xattn/"))
    t.update(_ln_table(cfg, "ln2"))
    for k, v in mlp_params("gelu", cfg.d_model, cfg.d_ff, bias=True).items():
        t[f"mlp/{k}"] = v
    return t


def encdec_param_table(cfg):
    table = {
        "embed": ((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), None),
        "dec_pos": ((getattr(cfg, "max_dec_len", _DEC_POS), cfg.d_model),
                    (None, "embed"), None),
        "enc_ln": ((cfg.d_model,), ("embed",), None),
        "enc_ln_b": ((cfg.d_model,), ("embed",), None),
        "dec_ln": ((cfg.d_model,), ("embed",), None),
        "dec_ln_b": ((cfg.d_model,), ("embed",), None),
    }
    for k, v in encdec_layer_table(cfg, cross=False).items():
        shape, logical, fan = v
        table[f"enc_layers/{k}"] = ((cfg.enc_layers, *shape),
                                    ("layers", *logical), fan)
    for k, v in encdec_layer_table(cfg, cross=True).items():
        shape, logical, fan = v
        table[f"dec_layers/{k}"] = ((cfg.num_layers, *shape),
                                    ("layers", *logical), fan)
    return table


def _sinusoid(length, d, dtype, device=None):
    """(length, d): sin over the first half of the channels, cos over the
    second, computed in float32 and cast to ``dtype``. The frequencies'
    ``10000 ** (2 i / d)`` is rounded once from float64, as XLA's float32
    power is (``torch.pow`` in float32 is an ulp off at some exponents, and
    at 1500 positions an ulp of the frequency is 4e-6 of the sine)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    base = torch.tensor(10_000.0, dtype=torch.float64, device=device)
    angle = pos / torch.pow(base, (2 * dim / d).double()).float()
    return torch.cat([torch.sin(angle), torch.cos(angle)], -1).to(dtype)


def _ln(x, lp, name):
    return layer_norm(x, 1.0 + lp[name], lp[f"{name}_b"])


def _heads(x, B, H, Dh):
    return split_heads(x, H, Dh)


def _q(x, p, cfg):
    B = x.shape[0]
    return _heads(_mm("bsd,dh->bsh", x, p["wq"]) + p["bq"], B,
                  cfg.num_heads, cfg.head_dim)


def _kv(src, p, cfg):
    """The K (no bias) and V (with bias) projections of ``src``."""
    B = src.shape[0]
    H, Dh = cfg.num_heads, cfg.head_dim
    k = _mm("bsd,dh->bsh", src, p["wk"])
    v = _mm("bsd,dh->bsh", src, p["wv"]) + p["bv"]
    return _heads(k, B, H, Dh), _heads(v, B, H, Dh)


def _out(a, p):
    return _mm("bsh,hd->bsd", flatten_heads(a), p["wo"]) + p["bo"]


def _mha(x, kv_src, p, cfg, causal):
    q = _q(x, p, cfg)
    k, v = _kv(kv_src, p, cfg)
    a = attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                  kv_chunk=cfg.kv_chunk)
    return _out(a, p)


def _enc_layer(x, lp, cfg):
    h = _ln(x, lp, "ln1")
    x = x + _mha(h, h, lp["attn"], cfg, causal=False)
    h = _ln(x, lp, "ln2")
    return x + mlp(h, lp["mlp"], "gelu")


def _dec_layer(x, enc, lp, cfg):
    h = _ln(x, lp, "ln1")
    x = x + _mha(h, h, lp["attn"], cfg, causal=True)
    h = _ln(x, lp, "lnx")
    x = x + _mha(h, enc, lp["xattn"], cfg, causal=False)
    h = _ln(x, lp, "ln2")
    return x + mlp(h, lp["mlp"], "gelu")


def _stack(fn, x, layers, n, cfg, *extra):
    """``fn(x, *extra, layer l, cfg)`` over the n stacked layers, each
    recomputed in the backward pass under ``cfg.remat``."""
    remat = cfg.remat and torch.is_grad_enabled()
    for l in range(n):
        args = (x, *extra, _layer(layers, l), cfg)
        x = checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)
    return x


_ACT = (("batch",), None, "embed")


def encode(params, frames, cfg, constrain=identity_constrain):
    """frames: (B, F, D) precomputed frontend embeddings -> (B, F, D)."""
    x = frames.to(cfg.dtype_act) + _sinusoid(
        frames.shape[1], cfg.d_model, cfg.dtype_act, frames.device)[None]
    x = constrain(x, _ACT)
    x = _stack(_enc_layer, x, params["enc_layers"], cfg.enc_layers, cfg)
    return layer_norm(x, 1.0 + params["enc_ln"], params["enc_ln_b"])


def _embed(params, tokens, cfg, positions):
    x = embed_lookup(params["embed"], tokens, cfg.dtype_act)
    # dec_pos's rows are never split (its logical row axis is None under
    # every rule set), so its lookup is the block's own
    return x + params["dec_pos"][positions].to(x.dtype)[None]


def _final(params, x):
    return layer_norm(x, 1.0 + params["dec_ln"], params["dec_ln_b"])


def decode_train(params, enc, tokens, cfg, constrain=identity_constrain):
    """The decoder over whole sequences: final hidden states (B, S, D)."""
    S = tokens.shape[1]
    x = constrain(_embed(params, tokens, cfg, slice(0, S)), _ACT)
    x = _stack(_dec_layer, x, params["dec_layers"], cfg.num_layers, cfg, enc)
    return _final(params, x)


def encdec_loss(params, batch, cfg, constrain=identity_constrain):
    enc = encode(params, batch["frames"], cfg, constrain)
    x = decode_train(params, enc, batch["tokens"], cfg, constrain)
    return chunked_ce_loss(x, params["embed"].to(cfg.dtype_act),
                           batch["labels"], chunk=cfg.loss_chunk)


def init_encdec_cache(cfg, batch, max_len, dtype, device=None, mesh=None,
                      frames=None) -> EncDecCache:
    """An empty cache of ``max_len`` positions and ``frames`` cross
    positions (``None``: ``cfg.enc_frames``) on ``device`` (``None``: the
    GPU), or on ``mesh`` in the prefill's layout."""
    dev = resolve_device(device)
    L, H, Dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
    F = cfg.enc_frames if frames is None else frames
    return EncDecCache(
        k=cache_zeros((L, batch, max_len, H, Dh), dtype, dev, mesh),
        v=cache_zeros((L, batch, max_len, H, Dh), dtype, dev, mesh),
        xk=cache_zeros((L, batch, F, H, Dh), dtype, dev, mesh),
        xv=cache_zeros((L, batch, F, H, Dh), dtype, dev, mesh),
        length=torch.zeros((), dtype=torch.int32, device=dev))


def encdec_prefill(params, batch, cfg, max_len,
                   constrain=identity_constrain):
    """Encoder pass + decoder prompt pass: (last position's logits (B, V),
    a cache of ``max_len`` positions)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"a prompt of {S} positions does not fit a cache "
                         f"of max_len {max_len}")
    enc = encode(params, batch["frames"], cfg, constrain)
    x = _embed(params, tokens, cfg, slice(0, S))
    cache = init_encdec_cache(cfg, B, max_len, cfg.dtype_act, x.device,
                              mesh_of(x), frames=enc.shape[1])
    for l in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], l)
        k, v = _kv(_ln(x, lp, "ln1"), lp["attn"], cfg)
        write_layer(cache.k, l, k, write_prefix, along=1)
        write_layer(cache.v, l, v, write_prefix, along=1)
        xk, xv = _kv(enc, lp["xattn"], cfg)
        write_layer(cache.xk, l, xk, write_all)
        write_layer(cache.xv, l, xv, write_all)
        x = _dec_layer(x, enc, lp, cfg)
    x = _final(params, x)
    logits = _einsum("bd,vd->bv", x[:, -1], params["embed"].to(x.dtype))
    return logits, cache._replace(
        length=torch.tensor(S, dtype=torch.int32, device=x.device))


def encdec_decode_step(params, cache: EncDecCache, tokens, cfg,
                       constrain=identity_constrain):
    """One greedy step. tokens: (B, 1) -> (logits (B, V), new cache).

    Reads ``dec_pos`` at ``length`` and writes the new K / V there, both
    clamped to their last row (XLA's ``dynamic_slice`` /
    ``dynamic_update_slice`` rule); attends to the static cross cache over
    all frames."""
    pos = cache.length
    n_pos = params["dec_pos"].shape[0]
    x = _embed(params, tokens, cfg,
               torch.clamp(pos, 0, n_pos - 1).long().reshape(1))
    T = cache.k.shape[2]
    at = torch.clamp(pos, 0, T - 1).long().reshape(1)
    new_k, new_v = cache.k.clone(), cache.v.clone()
    F = cache.xk.shape[2]
    for l in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], l)
        p = lp["attn"]
        hn = _ln(x, lp, "ln1")
        q = _q(hn, p, cfg)
        k, v = _kv(hn, p, cfg)
        write_layer(new_k, l, k, write_at(at), along=1)
        write_layer(new_v, l, v, write_at(at), along=1)
        x = x + _out(decode_attention(q, new_k[l], new_v[l], pos + 1), p)
        # cross attention against the static encoder cache
        p = lp["xattn"]
        q = _q(_ln(x, lp, "lnx"), p, cfg)
        x = x + _out(decode_attention(q, cache.xk[l], cache.xv[l], F), p)
        x = x + mlp(_ln(x, lp, "ln2"), lp["mlp"], "gelu")
    x = _final(params, x)
    logits = _einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    return logits[:, 0], cache._replace(k=new_k, v=new_v,
                                        length=cache.length + 1)
