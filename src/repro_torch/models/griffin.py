"""Griffin-style hybrid (RecurrentGemma-2B) in PyTorch (counterpart of
``repro.models.griffin``): RG-LRU recurrent blocks and local sliding-window
MQA, the pattern (rec, rec, attn) cycled over the layers.

Recurrent block (Griffin, De et al. 2024)::

    y  = GeLU(W_y x)                       (B, S, R)
    z  = W_x x -> causal depthwise conv(4) -> RG-LRU -> h
    out = W_o (y * h)

RG-LRU::

    r_t = sigmoid(W_a z_t + b_a);  i_t = sigmoid(W_i z_t + b_i)
    log a_t = -c * r_t * softplus(lam)          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * z_t)

Over a sequence the recurrence runs as a log-depth doubling scan in float32
(:func:`_doubling_scan`, the reference's ``associative_scan`` combine
``(a1 a2, a2 b1 + b2)``: ceil(log2 S) elementwise steps, no division);
:func:`_rglru_loop` is the sequential plain version the tests hold it
against. A decode step is the reference's one fused step. The attention
layers keep only ``window`` K / V entries (a rotating buffer, slot
``pos % window``), so the cache's bytes do not grow with the context.

Parameters are the reference's tree, every layer's weights stacked on a
leading (L, ...) axis, and every layer holds both branches' weights (the
reference's table). Where the reference scans over layers with
``lax.switch(li % len(pattern))``, this module loops in Python and branches
on ``cfg.block_pattern``; each layer's parameters are views of the stacked
leaves. With ``cfg.remat`` each layer is recomputed in the backward pass
under autograd (``torch.utils.checkpoint``); that changes no value. Every
function takes the reference's ``constrain`` hook (default: the identity);
as in the reference, only the forward pass calls it. On a mesh the cache is
created in the prefill's layout and written on each rank's block
(``layers.write_layer``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from .layers import (_einsum, _even, _gelu, _mm, apply_rope, attention,
                     cache_zeros, chunked_ce_loss, embed_lookup,
                     identity_constrain, merge_heads, mesh_of, mlp,
                     mlp_params, rms_norm, rope, unflattenable, write_all,
                     write_at, write_layer)
from .transformer import _attn_out, _layer, _logits, _project_qkv

__all__ = ["griffin_layer_table", "griffin_param_table", "griffin_forward",
           "griffin_loss", "griffin_prefill", "griffin_decode_step",
           "init_griffin_cache", "GriffinCache"]

_LRU_C = 8.0
_UNSEEN = -10**9      # the position of a window slot not written yet


class GriffinCache(NamedTuple):
    h: torch.Tensor       # (L, B, R) RG-LRU hidden state, float32
    conv: torch.Tensor    # (L, B, W_conv - 1, R) conv tail
    k: torch.Tensor       # (L, B, W, Hkv, Dh) rotating window K
    v: torch.Tensor       # (L, B, W, Hkv, Dh)
    pos: torch.Tensor     # (L, B, W) int32 absolute positions in the buffer
    length: torch.Tensor  # 0-d int32: positions consumed


def griffin_layer_table(cfg):
    D, R = cfg.d_model, cfg.rnn_width
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = {
        # recurrent branch (present in every layer; attn layers ignore it)
        "rec/ln": ((D,), ("embed",), None),
        "rec/wy": ((D, R), ("embed", "rnn"), D),
        "rec/wx": ((D, R), ("embed", "rnn"), D),
        "rec/conv_w": ((cfg.conv_width, R), (None, "rnn"), None),
        "rec/conv_b": ((R,), ("rnn",), None),
        "rec/wa": ((R, R), ("rnn", "rnn_in"), R),
        "rec/ba": ((R,), ("rnn",), None),
        "rec/wi": ((R, R), ("rnn", "rnn_in"), R),
        "rec/bi": ((R,), ("rnn",), None),
        "rec/lam": ((R,), ("rnn",), None),
        "rec/wo": ((R, D), ("rnn", "embed"), R),
        # local attention branch
        "attn/ln": ((D,), ("embed",), None),
        "attn/wq": ((D, Hq * Dh), ("embed", "heads_fused"), D),
        "attn/wk": ((D, Hkv * Dh), ("embed", "kv_fused"), D),
        "attn/wv": ((D, Hkv * Dh), ("embed", "kv_fused"), D),
        "attn/wo": ((Hq * Dh, D), ("heads_fused", "embed"), Hq * Dh),
        # shared MLP
        "mlp_ln": ((D,), ("embed",), None),
    }
    for k, v in mlp_params(cfg.mlp_act, cfg.d_model, cfg.d_ff).items():
        t[f"mlp/{k}"] = v
    return t


def griffin_param_table(cfg):
    table = {
        "embed": ((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), None),
        "final_norm": ((cfg.d_model,), ("embed",), None),
    }
    for k, v in griffin_layer_table(cfg).items():
        shape, logical, fan = v
        table[f"layers/{k}"] = ((cfg.num_layers, *shape),
                                ("layers", *logical), fan)
    return table


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------
def _rglru_gates(z, p):
    """(a, gated input), float32 (B, S, R). The biases are added in the
    activation dtype before the cast, as the reference adds them; on a mesh
    to the reduced product (``_even``: PyTorch 2.11 cannot add a split bias
    to a pending sum)."""
    r = torch.sigmoid((_even(_mm("bsr,rq->bsq", z, p["wa"]))
                       + p["ba"]).float())
    i = torch.sigmoid((_even(_mm("bsr,rq->bsq", z, p["wi"]))
                       + p["bi"]).float())
    lam = p["lam"].float()
    log_a = -_LRU_C * r * torch.logaddexp(lam, torch.zeros_like(lam))
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * z.float())
    return a, gated


def _doubling_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, over axis 1: ceil(log2 S)
    steps of the combine (a1 a2, a2 b1 + b2) at doubling offsets."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def _rglru_loop(a, b):
    """The same recurrence one step at a time: the plain version."""
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def _rglru_scan(z, p):
    """z: (B, S, R) -> h: (B, S, R) in z's dtype, through the doubling
    scan."""
    a, b = _rglru_gates(z, p)
    return _doubling_scan(a, b).to(z.dtype)


def _causal_conv(z, w, b, tail=None):
    """Depthwise causal conv along time. z: (B, S, R); w: (K, R). The K
    taps are summed in order, in z's dtype; returns (out, the last K - 1
    rows of [tail | z], the new tail)."""
    K = w.shape[0]
    S = z.shape[1]
    if tail is None:
        tail = torch.zeros((z.shape[0], K - 1, z.shape[2]), dtype=z.dtype,
                           device=z.device)
    zp = torch.cat([tail.to(z.dtype), z], dim=1)
    out = zp[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + zp[:, i:i + S, :] * w[i][None, None, :]
    return (out + b[None, None, :]).to(z.dtype), zp[:, -(K - 1):, :]


def _rec_block(x, p, cfg, h0=None, conv_tail=None):
    """Returns (out, h at the last position as float32, new conv tail).
    With ``h0`` (decode, S = 1) one fused step from it."""
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    y = _gelu(_mm("bsd,dr->bsr", xn, p["wy"]).float()).to(x.dtype)
    z = _mm("bsd,dr->bsr", xn, p["wx"])
    z, new_tail = _causal_conv(z, p["conv_w"], p["conv_b"], conv_tail)
    if h0 is None:
        h = _rglru_scan(z, p)
    else:
        a, b = _rglru_gates(z, p)
        h = (a * h0[:, None, :] + b).to(x.dtype)
    out = _mm("bsr,rd->bsd", (y * h).to(x.dtype), p["wo"])
    return out, h[:, -1, :].float(), new_tail


def _qkv(xn, p, cfg, cos, sin):
    """The MQA projections of the normed input, q and k rotated."""
    q, k, v = _project_qkv(xn, p, cfg)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attn_block(x, p, cfg, cos, sin):
    """Returns (out, K, V) of the sequence."""
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(xn, p, cfg, cos, sin)
    a = attention(q, k, v, causal=True, window=cfg.window,
                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return _attn_out(a, p), k, v


def _is_attn(cfg, li):
    pat = cfg.block_pattern
    return pat[li % len(pat)] == "attn"


# --------------------------------------------------------------------------
# forward / loss
# --------------------------------------------------------------------------
def _embed(params, tokens, cfg):
    return embed_lookup(params["embed"], tokens, cfg.dtype_act) \
        * math.sqrt(cfg.d_model)


_ACT = (("batch",), None, "embed")


def _layer_fwd(h, lp, cfg, cos, sin, attn: bool,
               constrain=identity_constrain):
    """One layer over a sequence: (new h, the branch's outputs)."""
    if attn:
        out, k, v = _attn_block(h, lp["attn"], cfg, cos, sin)
        state = (k, v)
    else:
        out, h_last, tail = _rec_block(h, lp["rec"], cfg)
        state = (h_last, tail)
    h = h + constrain(out, _ACT)
    hn = rms_norm(h, lp["mlp_ln"], cfg.norm_eps)
    return h + constrain(mlp(hn, lp["mlp"], cfg.mlp_act), _ACT), state


def _layers(params, x, cfg, cos, sin, constrain=identity_constrain):
    """Every layer in order: (final h, each layer's branch outputs)."""
    remat = cfg.remat and torch.is_grad_enabled()
    states = []
    for li in range(cfg.num_layers):
        attn = _is_attn(cfg, li)
        args = (x, _layer(params["layers"], li), cfg, cos, sin, attn,
                constrain)
        if remat:
            x, st = checkpoint(_layer_fwd, *args, use_reentrant=False)
        else:
            x, st = _layer_fwd(*args)
        states.append(st)
    return x, states


def griffin_forward(params, tokens, cfg, constrain=identity_constrain):
    """Final hidden states (B, S, D) of ``tokens`` (B, S)."""
    x = constrain(_embed(params, tokens, cfg), _ACT)
    cos, sin = rope(torch.arange(x.shape[1], device=x.device), cfg.head_dim,
                    cfg.rope_theta)
    x, _ = _layers(params, x, cfg, cos, sin, constrain)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def griffin_loss(params, batch, cfg, constrain=identity_constrain):
    x = griffin_forward(params, batch["tokens"], cfg, constrain)
    return chunked_ce_loss(x, params["embed"].to(cfg.dtype_act),
                           batch["labels"], chunk=cfg.loss_chunk,
                           logit_cap=cfg.final_logit_cap)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def init_griffin_cache(cfg, batch, dtype, device=None,
                       mesh=None) -> GriffinCache:
    """An empty cache on ``device`` (``None``: the GPU), or on ``mesh`` in
    the prefill's layout. Its size does not depend on a context length: the
    window is the attention's whole memory."""
    dev = resolve_device(device)
    L, R, W = cfg.num_layers, cfg.rnn_width, cfg.window
    Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
    return GriffinCache(
        h=cache_zeros((L, batch, R), torch.float32, dev, mesh),
        conv=cache_zeros((L, batch, cfg.conv_width - 1, R), dtype, dev,
                         mesh),
        k=cache_zeros((L, batch, W, Hkv, Dh), dtype, dev, mesh),
        v=cache_zeros((L, batch, W, Hkv, Dh), dtype, dev, mesh),
        pos=cache_zeros((L, batch, W), torch.int32, dev, mesh, _UNSEEN),
        length=torch.zeros((), dtype=torch.int32, device=dev))


def _windowed_decode_attention(q, kbuf, vbuf, posbuf, cur_pos, window):
    """q: (B, 1, Hq, Dh); kbuf / vbuf: (B, W, Hkv, Dh); posbuf: (B, W).
    Attends to the slots whose stored position lies in (cur_pos - window,
    cur_pos]."""
    B, W, Hkv, Dh = kbuf.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    qg = unflattenable(q, 2, Hkv).reshape(B, 1, Hkv, G, Dh)
    s = _einsum("bqhgd,bkhd->bhgqk", qg, kbuf).float()
    s = s / math.sqrt(Dh)
    valid = (posbuf <= cur_pos) & (posbuf > cur_pos - window)
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = _einsum("bhgqk,bkhd->bqhgd", p.to(vbuf.dtype), vbuf)
    return merge_heads(out, Hkv)


def griffin_decode_step(params, cache: GriffinCache, tokens, cfg,
                        constrain=identity_constrain):
    """One step. tokens: (B, 1) -> (logits (B, V), new cache).

    The new cache is a copy of ``cache`` with each layer's new state
    written in: a recurrent layer's h and conv tail, an attention layer's
    K, V and position at slot ``length % window`` (``index_copy_`` at a
    device index, no host read). ``cache`` itself is left as it was.
    """
    x = _embed(params, tokens, cfg)
    pos = cache.length
    cos, sin = rope(torch.arange(1, device=x.device) + pos, cfg.head_dim,
                    cfg.rope_theta)
    slot = (pos % cfg.window).long().reshape(1)
    stamp = pos.reshape(1, 1).expand(x.shape[0], 1)
    new = cache._replace(h=cache.h.clone(), conv=cache.conv.clone(),
                         k=cache.k.clone(), v=cache.v.clone(),
                         pos=cache.pos.clone(), length=cache.length + 1)
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        if _is_attn(cfg, li):
            xn = rms_norm(x, lp["attn"]["ln"], cfg.norm_eps)
            q, k, v = _qkv(xn, lp["attn"], cfg, cos, sin)
            write = write_at(slot)
            write_layer(new.k, li, k, write, along=1)
            write_layer(new.v, li, v, write, along=1)
            write_layer(new.pos, li, stamp, write, along=1)
            a = _windowed_decode_attention(q, new.k[li], new.v[li],
                                           new.pos[li], pos, cfg.window)
            x = x + _attn_out(a, lp["attn"])
        else:
            out, h_new, tail = _rec_block(x, lp["rec"], cfg, h0=cache.h[li],
                                          conv_tail=cache.conv[li])
            write_layer(new.h, li, h_new, write_all)
            write_layer(new.conv, li, tail, write_all)
            x = x + out
        hn = rms_norm(x, lp["mlp_ln"], cfg.norm_eps)
        x = x + mlp(hn, lp["mlp"], cfg.mlp_act)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], new


def griffin_prefill(params, batch, cfg, constrain=identity_constrain):
    """Prompt pass returning (last position's logits (B, V), a cache with
    every layer's state and ``length = S``). An attention layer keeps its
    last ``window`` positions in slot order ``pos % window``; a slot no
    position has reached holds the last position's K / V (the reference's
    clipped gather) and the position ``-10**9``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    dev = x.device
    cos, sin = rope(torch.arange(S, device=dev), cfg.head_dim,
                    cfg.rope_theta)
    x, states = _layers(params, x, cfg, cos, sin)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x[:, -1], cfg)

    cache = init_griffin_cache(cfg, B, cfg.dtype_act, dev, mesh_of(x))
    W = cfg.window
    last = torch.arange(W, device=dev)
    if S >= W:
        src = S - W + torch.remainder(last - S % W, W)
    else:
        src = last
    take = torch.clamp(src, 0, S - 1)
    seen = torch.where(src < S, src, torch.full_like(src, _UNSEEN))
    seen = seen.to(torch.int32)[None, :].repeat(B, 1)
    for li, st in enumerate(states):
        if _is_attn(cfg, li):
            k, v = st
            write_layer(cache.k, li, k[:, take], write_all)
            write_layer(cache.v, li, v[:, take], write_all)
            write_layer(cache.pos, li, seen, write_all)
        else:
            write_layer(cache.h, li, st[0], write_all)
            write_layer(cache.conv, li, st[1], write_all)
    return logits, cache._replace(
        length=torch.tensor(S, dtype=torch.int32, device=dev))
