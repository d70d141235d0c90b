"""RWKV-6 "Finch" (attention-free, data-dependent decay) in PyTorch
(counterpart of ``repro.models.rwkv``).

Time-mix (per head, head_size N = 64, H = D / N heads):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T                (state: (H, N, N))
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
with data-dependent decay w_t = exp(-exp(w_base + lora_w(x))) and
token-shift "ddlerp" mixing (low-rank adapters) for r/k/v/w/g, following
arXiv:2404.05892. Channel-mix uses squared-ReLU.

Parameters are the reference's tree: nested dicts of tensors with every
layer's weights stacked on a leading (L, ...) axis, so a reference
parameter tree carries across one to one (``convert.tree_from_numpy``).
Where the reference scans over layers or time, this module loops in Python.
The wkv recurrence runs as a sequential loop over time, or, when the config
sets ``rwkv_chunk`` and the sequence is longer than a chunk and divides into
chunks, chunk-parallel with the reference's algebra (:func:`_wkv_chunked`).
With ``cfg.remat`` each layer is recomputed in the backward pass under
autograd (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``;
that changes no value. Every function takes the reference's ``constrain``
hook (default: the identity); as in the reference, only the forward pass
calls it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from .layers import (_einsum, _mm, cache_zeros, chunked_ce_loss,
                     embed_lookup, identity_constrain, layer_norm,
                     unflattenable)
from .transformer import _layer

__all__ = ["rwkv_layer_table", "rwkv_param_table", "rwkv_forward",
           "rwkv_loss", "rwkv_prefill", "rwkv_decode_step",
           "init_rwkv_cache", "RWKVCache"]

_LORA = 32          # ddlerp low-rank dim
_LORA_W = 64        # decay lora dim


class RWKVCache(NamedTuple):
    state: torch.Tensor   # (L, B, H, N, N) wkv state (float32)
    x_tm: torch.Tensor    # (L, B, D) last input of time-mix
    x_cm: torch.Tensor    # (L, B, D) last input of channel-mix
    length: torch.Tensor  # 0-d int32: positions consumed


def rwkv_layer_table(cfg):
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "ln1": ((D,), ("embed",), None),
        "ln1_b": ((D,), ("embed",), None),
        "ln2": ((D,), ("embed",), None),
        "ln2_b": ((D,), ("embed",), None),
        # ddlerp mixing
        "tm/mu_x": ((D,), ("embed",), None),
        "tm/mu": ((5, D), (None, "embed"), None),
        "tm/lora_a": ((D, 5 * _LORA), ("embed", None), D),
        "tm/lora_b": ((5, _LORA, D), (None, None, "embed"), _LORA),
        # projections
        "tm/wr": ((D, D), ("embed", "heads_fused"), D),
        "tm/wk": ((D, D), ("embed", "heads_fused"), D),
        "tm/wv": ((D, D), ("embed", "heads_fused"), D),
        "tm/wg": ((D, D), ("embed", "heads_fused"), D),
        "tm/wo": ((D, D), ("heads_fused", "embed"), D),
        # decay + bonus
        "tm/w_base": ((D,), ("embed",), None),
        "tm/w_lora_a": ((D, _LORA_W), ("embed", None), D),
        "tm/w_lora_b": ((_LORA_W, D), (None, "embed"), _LORA_W),
        "tm/u": ((D,), ("embed",), None),
        # group-norm on heads after wkv
        "tm/gn": ((D,), ("embed",), None),
        "tm/gn_b": ((D,), ("embed",), None),
        # channel mix
        "cm/mu_k": ((D,), ("embed",), None),
        "cm/mu_r": ((D,), ("embed",), None),
        "cm/wk": ((D, F_), ("embed", "mlp"), D),
        "cm/wv": ((F_, D), ("mlp", "embed"), F_),
        "cm/wr": ((D, D), ("embed", "embed_out"), D),
    }


def rwkv_param_table(cfg):
    table = {
        "embed": ((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), None),
        "ln0": ((cfg.d_model,), ("embed",), None),
        "ln0_b": ((cfg.d_model,), ("embed",), None),
        "final_norm": ((cfg.d_model,), ("embed",), None),
        "final_norm_b": ((cfg.d_model,), ("embed",), None),
        "head": ((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                 cfg.d_model),
    }
    for k, (shape, logical, fan) in rwkv_layer_table(cfg).items():
        table[f"layers/{k}"] = ((cfg.num_layers, *shape),
                                ("layers", *logical), fan)
    return table


# --------------------------------------------------------------------------
# time-mix
# --------------------------------------------------------------------------
def _ddlerp(x, x_prev, p):
    """Data-dependent lerp producing the 5 mixed inputs (r, k, v, w, g)."""
    xx = x_prev - x
    base = x + xx * p["mu_x"].to(x.dtype)
    lora = torch.tanh(_mm("bsd,dk->bsk", base, p["lora_a"]))
    lora = unflattenable(lora, -1, 5).reshape(*lora.shape[:-1], 5, _LORA)
    adj = _mm("bsik,ikd->bsid", lora, p["lora_b"])
    mix = p["mu"].to(x.dtype)[None, None] + adj           # (B, S, 5, D)
    return [x + xx * mix[:, :, i, :] for i in range(5)]


def _decay(xw, p):
    """exp(-exp(w_base + lora_w(xw))) in float32: (B, S, D) in (0, 1)."""
    lora = torch.tanh(_mm("bsd,dk->bsk", xw, p["w_lora_a"]))
    ww = p["w_base"].float() + _mm("bsk,kd->bsd", lora,
                                   p["w_lora_b"]).float()
    return torch.exp(-torch.exp(ww))


def _wkv_scan(r, k, v, w, u, H, N, state0=None):
    """Sequential wkv recurrence. r/k/v/w: (B, S, D); returns (y (B, S, D)
    float32, final state (B, H, N, N))."""
    B, S, D = r.shape
    rh = r.reshape(B, S, H, N).float()
    kh = k.reshape(B, S, H, N).float()
    vh = v.reshape(B, S, H, N).float()
    wh = w.reshape(B, S, H, N)
    uh = u.reshape(H, N).float()
    state = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
             if state0 is None else state0)
    ys = []
    for t in range(S):
        kv = kh[:, t, :, :, None] * vh[:, t, :, None, :]    # (B, H, N, N)
        ys.append(_einsum("bhn,bhnm->bhm", rh[:, t],
                               state + uh[None, :, :, None] * kv))
        state = wh[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1).reshape(B, S, D), state


def _wkv_chunked(r, k, v, w, u, H, N, chunk, state0=None):
    """Chunk-parallel wkv: the reference's exact algebra.

    With per-step decay products A_t = prod_{u<=t} w_u (per channel),
    unrolling the recurrence inside a chunk of length c gives

        y_t = (r_t * A_{t-1})^T S_0                         [inter]
            + sum_{s<t} (sum_n r_t[n] k_s[n] e^{la_{t-1,n} - la_{s,n}}) v_s
            + (r_t * u)^T k_t v_t                           [bonus diag]
        S_c = diag(A_c) S_0 + sum_s diag(A_c / A_s) k_s v_s^T

    The pairwise decay exponents la_{t-1} - la_s are <= 0 for s <= t-1 and
    are clipped to [-80, 0], so the (c, c, N) exp tensor cannot overflow.
    ``w`` is clamped at 1e-30 (a normal float32) before its log.

    One departure in precision, none in the algebra: the log-decay sums
    ``la`` and the exponents taken from them are float64 (their exps are
    float32). Strong decays put ``la`` near -1000 within one chunk, where a
    float32 ulp (6e-5) becomes that relative error in every decay factor;
    the reference's float32 sums leave its chunked path up to 3e-4 off its
    scan at N = 64, this one within 1e-5.
    """
    B, S, D = r.shape
    c = chunk
    nc = S // c
    sh = (B, nc, c, H, N)
    rh = r.reshape(sh).float()
    kh = k.reshape(sh).float()
    vh = v.reshape(sh).float()
    la = _cumsum(torch.log(torch.clamp_min(w.reshape(sh).float(),
                                           1e-30)).double(), dim=2)
    uh = u.reshape(H, N).float()
    state = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
             if state0 is None else state0)

    # intra-chunk pairwise decay scores (strictly lower triangular)
    la_prev = torch.cat([torch.zeros_like(la[:, :, :1]), la[:, :, :-1]],
                        dim=2)                              # la_{t-1}
    pair = torch.exp(torch.clamp(la_prev[:, :, :, None] - la[:, :, None],
                                 -80.0, 0.0)).float()       # (B,nc,t,s,H,N)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    scores = (rh[:, :, :, None] * kh[:, :, None] * pair).sum(-1)
    scores = scores.permute(0, 1, 4, 2, 3)                  # (B,nc,H,t,s)
    scores = torch.where(tri, scores, torch.zeros_like(scores))
    diag = (rh * uh * kh).sum(-1)                           # (B,nc,t,H)
    y_intra = _einsum("bghts,bgshm->bgthm", scores, vh) \
        + diag[..., None] * vh

    # inter-chunk: a loop over chunk states
    A_end = torch.exp(la[:, :, -1]).float()                 # (B,nc,H,N)
    kd = kh * torch.exp(la[:, :, -1:] - la).float()         # k_s * A_c/A_s
    r_decayed = rh * torch.exp(la_prev).float()             # r_t * A_{t-1}
    y_inter = []
    for g in range(nc):
        y_inter.append(_einsum("bthn,bhnm->bthm", r_decayed[:, g],
                                    state))
        state = A_end[:, g, :, :, None] * state + _einsum(
            "bshn,bshm->bhnm", kd[:, g], vh[:, g])
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(B, S, D), state


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum``; of a ``DTensor`` whose ``dim`` no rank splits, the
    cumsum of each rank's block (the same values: PyTorch 2.11's DTensor
    has no sharding rule for the ``flip`` of cumsum's backward)."""
    placements = getattr(x, "placements", None)
    if placements is None or any(p.is_shard(dim % x.ndim)
                                 for p in placements):
        return torch.cumsum(x, dim=dim)
    from torch.distributed.tensor import DTensor

    local = torch.cumsum(x.to_local(), dim=dim)
    return DTensor.from_local(local, x.device_mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=local.stride())


def _time_mix(x, x_prev, p, cfg, state0=None):
    H = cfg.d_model // cfg.rwkv_head_size
    N = cfg.rwkv_head_size
    xr, xk, xv, xw, xg = _ddlerp(x, x_prev, p)
    r = _mm("bsd,dh->bsh", xr, p["wr"])
    k = _mm("bsd,dh->bsh", xk, p["wk"])
    v = _mm("bsd,dh->bsh", xv, p["wv"])
    g = F.silu(_mm("bsd,dh->bsh", xg, p["wg"]).float())
    w = _decay(xw, p)
    S = r.shape[1]
    chunk = cfg.rwkv_chunk
    if chunk and S > chunk and S % chunk == 0:
        y, state = _wkv_chunked(r, k, v, w, p["u"], H, N, chunk, state0)
    else:
        y, state = _wkv_scan(r, k, v, w, p["u"], H, N, state0)
    # per-head group norm (population variance)
    B, S, D = y.shape
    yh = y.reshape(B, S, H, N)
    mu = torch.mean(yh, dim=-1, keepdim=True)
    var = torch.var(yh, dim=-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    y = yh.reshape(B, S, D) * p["gn"].float() + p["gn_b"].float()
    out = _mm("bsh,hd->bsd", (y * g).to(x.dtype), p["wo"])
    return out, state


def _channel_mix(x, x_prev, p):
    xx = x_prev - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    k = _mm("bsd,df->bsf", xk, p["wk"])
    k32 = torch.clamp_min(k.float(), 0.0)
    kv = _mm("bsf,fd->bsd", (k32 * k32).to(x.dtype), p["wv"])
    r = torch.sigmoid(_mm("bsd,de->bse", xr, p["wr"]).float())
    return (r * kv.float()).to(x.dtype)


def _shift(x, last=None):
    """Token shift: x_prev[t] = x[t-1]; the first uses ``last`` (or
    zeros)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


# --------------------------------------------------------------------------
# forward / loss / serving
# --------------------------------------------------------------------------
_ACT = (("batch",), None, "embed")


def _block(h, lp, cfg, last_tm=None, last_cm=None, state0=None,
           constrain=identity_constrain):
    """One layer: (new h, wkv state, last time-mix input, last channel-mix
    input). ``last_*`` and ``state0`` carry a decode cache's entries."""
    hn = layer_norm(h, 1.0 + lp["ln1"], lp["ln1_b"])
    out, state = _time_mix(hn, _shift(hn, last_tm), lp["tm"], cfg, state0)
    x_tm = hn[:, -1, :]
    h = h + constrain(out, _ACT)
    hn = layer_norm(h, 1.0 + lp["ln2"], lp["ln2_b"])
    h = h + constrain(_channel_mix(hn, _shift(hn, last_cm), lp["cm"]), _ACT)
    return h, state, x_tm, hn[:, -1, :]


def _embed(params, tokens, cfg):
    x = embed_lookup(params["embed"], tokens, cfg.dtype_act)
    return layer_norm(x, 1.0 + params["ln0"], params["ln0_b"])


def _layers(params, x, cfg, constrain=identity_constrain):
    """All layers over a whole sequence; (h, stacked states, x_tm, x_cm)."""
    remat = cfg.remat and torch.is_grad_enabled()
    states, xtms, xcms = [], [], []
    for l in range(cfg.num_layers):
        lp = _layer(params["layers"], l)
        args = (x, lp, cfg, None, None, None, constrain)
        if remat:
            x, st, xtm, xcm = checkpoint(_block, *args, use_reentrant=False)
        else:
            x, st, xtm, xcm = _block(*args)
        states.append(st)
        xtms.append(xtm)
        xcms.append(xcm)
    return x, states, xtms, xcms


def _final_norm(params, x):
    return layer_norm(x, 1.0 + params["final_norm"], params["final_norm_b"])


def rwkv_forward(params, tokens, cfg, constrain=identity_constrain):
    """Final hidden states (B, S, D) of ``tokens`` (B, S)."""
    x = constrain(_embed(params, tokens, cfg), _ACT)
    x, _, _, _ = _layers(params, x, cfg, constrain)
    return _final_norm(params, x)


def rwkv_loss(params, batch, cfg, constrain=identity_constrain):
    x = rwkv_forward(params, batch["tokens"], cfg, constrain)
    return chunked_ce_loss(x, params["head"].T.to(cfg.dtype_act),
                           batch["labels"], chunk=cfg.loss_chunk)


def init_rwkv_cache(cfg, batch, dtype, device=None, mesh=None
                    ) -> RWKVCache:
    """An empty cache on ``device`` (``None``: the GPU), or on ``mesh`` in
    the prefill's layout."""
    dev = resolve_device(device)
    H = cfg.d_model // cfg.rwkv_head_size
    N = cfg.rwkv_head_size
    L, D = cfg.num_layers, cfg.d_model
    return RWKVCache(
        state=cache_zeros((L, batch, H, N, N), torch.float32, dev, mesh),
        x_tm=cache_zeros((L, batch, D), dtype, dev, mesh),
        x_cm=cache_zeros((L, batch, D), dtype, dev, mesh),
        length=torch.zeros((), dtype=torch.int32, device=dev),
    )


def rwkv_decode_step(params, cache: RWKVCache, tokens, cfg,
                     constrain=identity_constrain):
    """One step. tokens: (B, 1) -> (logits (B, V), new cache)."""
    x = _embed(params, tokens, cfg)                         # (B, 1, D)
    states, xtms, xcms = [], [], []
    for l in range(cfg.num_layers):
        x, st, xtm, xcm = _block(x, _layer(params["layers"], l), cfg,
                                 cache.x_tm[l], cache.x_cm[l],
                                 cache.state[l])
        states.append(st)
        xtms.append(xtm)
        xcms.append(xcm)
    x = _final_norm(params, x)
    logits = _einsum("bsd,dv->bsv", x, params["head"].to(x.dtype))
    new_cache = RWKVCache(state=torch.stack(states), x_tm=torch.stack(xtms),
                          x_cm=torch.stack(xcms), length=cache.length + 1)
    return logits[:, 0], new_cache


def rwkv_prefill(params, batch, cfg, constrain=identity_constrain):
    """Prompt pass returning (last position's logits (B, V), cache with the
    final states and ``length = S``)."""
    tokens = batch["tokens"]
    x, states, xtms, xcms = _layers(params, _embed(params, tokens, cfg), cfg)
    x = _final_norm(params, x)
    logits = _einsum("bd,dv->bv", x[:, -1], params["head"].to(x.dtype))
    cache = RWKVCache(state=torch.stack(states), x_tm=torch.stack(xtms),
                      x_cm=torch.stack(xcms),
                      length=torch.tensor(tokens.shape[1], dtype=torch.int32,
                                          device=tokens.device))
    return logits, cache
