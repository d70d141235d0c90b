"""Model zoo registry (counterpart of ``repro.models.registry``).

``build_model(cfg)`` returns a ``Model`` with functional endpoints:
    init(generator, dtype, place)    -> params
    loss(params, batch, constrain)   -> scalar        (train shapes)
    prefill(params, batch, max_len, constrain) -> (logits, cache)
    decode_step(params, cache, tk, constrain)  -> (logits, cache)
    init_cache(batch, max_len, dtype, device, mesh) -> cache
plus the parameter table and its logical-axis tree. ``constrain`` is the
reference's sharding-constraint hook (default: the identity) and ``mesh``
places an empty cache on a ``DeviceMesh`` in the prefill's layout.

Every family of the reference is built: the decoder family (``dense``,
``moe``, ``vlm``), the encoder-decoder (``encdec``, ``audio``: its prefill
needs ``max_len``), the Griffin hybrid (``hybrid``) and RWKV-6 (``ssm``),
whose prefill and cache take ``max_len=None`` and ignore it (their state
does not grow with the context).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from . import encdec, griffin, rwkv, transformer
from .layers import identity_constrain as _ident
from .transformer import build_params, table_logical

__all__ = ["Model", "InputSpec", "build_model", "count_params",
           "active_params", "make_input_specs"]


class Model(NamedTuple):
    cfg: Any
    param_table: dict
    logical: dict
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


class InputSpec(NamedTuple):
    """What the reference's ``jax.ShapeDtypeStruct`` records."""
    shape: tuple
    dtype: torch.dtype


def build_model(cfg) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        table = transformer.decoder_param_table(cfg)
        return Model(
            cfg=cfg, param_table=table, logical=table_logical(table),
            init=lambda generator, dtype=cfg.dtype_param, place=None:
                build_params(generator, table, dtype, place),
            loss=lambda p, b, constrain=_ident: transformer.decoder_loss(
                p, b, cfg, constrain),
            prefill=lambda p, b, max_len, constrain=_ident:
                transformer.decoder_prefill(p, b, cfg, max_len, constrain),
            decode_step=lambda p, c, t, constrain=_ident:
                transformer.decoder_decode_step(p, c, t, cfg, constrain),
            init_cache=lambda batch, max_len, dtype=cfg.dtype_act,
            device=None, mesh=None: transformer.init_decoder_cache(
                cfg, batch, max_len, dtype, device, mesh),
        )
    if fam in ("encdec", "audio"):
        table = encdec.encdec_param_table(cfg)
        return Model(
            cfg=cfg, param_table=table, logical=table_logical(table),
            init=lambda generator, dtype=cfg.dtype_param, place=None:
                build_params(generator, table, dtype, place),
            loss=lambda p, b, constrain=_ident: encdec.encdec_loss(
                p, b, cfg, constrain),
            prefill=lambda p, b, max_len, constrain=_ident:
                encdec.encdec_prefill(p, b, cfg, max_len, constrain),
            decode_step=lambda p, c, t, constrain=_ident:
                encdec.encdec_decode_step(p, c, t, cfg, constrain),
            init_cache=lambda batch, max_len, dtype=cfg.dtype_act,
            device=None, mesh=None: encdec.init_encdec_cache(
                cfg, batch, max_len, dtype, device, mesh),
        )
    if fam == "hybrid":
        table = griffin.griffin_param_table(cfg)
        return Model(
            cfg=cfg, param_table=table, logical=table_logical(table),
            init=lambda generator, dtype=cfg.dtype_param, place=None:
                build_params(generator, table, dtype, place),
            loss=lambda p, b, constrain=_ident: griffin.griffin_loss(
                p, b, cfg, constrain),
            prefill=lambda p, b, max_len=None, constrain=_ident:
                griffin.griffin_prefill(p, b, cfg, constrain),
            decode_step=lambda p, c, t, constrain=_ident:
                griffin.griffin_decode_step(p, c, t, cfg, constrain),
            init_cache=lambda batch, max_len=None, dtype=cfg.dtype_act,
            device=None, mesh=None: griffin.init_griffin_cache(
                cfg, batch, dtype, device, mesh),
        )
    if fam == "ssm":
        table = rwkv.rwkv_param_table(cfg)
        return Model(
            cfg=cfg, param_table=table, logical=table_logical(table),
            init=lambda generator, dtype=cfg.dtype_param, place=None:
                build_params(generator, table, dtype, place),
            loss=lambda p, b, constrain=_ident: rwkv.rwkv_loss(
                p, b, cfg, constrain),
            prefill=lambda p, b, max_len=None, constrain=_ident:
                rwkv.rwkv_prefill(p, b, cfg, constrain),
            decode_step=lambda p, c, t, constrain=_ident:
                rwkv.rwkv_decode_step(p, c, t, cfg, constrain),
            init_cache=lambda batch, max_len=None, dtype=cfg.dtype_act,
            device=None, mesh=None: rwkv.init_rwkv_cache(
                cfg, batch, dtype, device, mesh),
        )
    raise ValueError(f"unknown family: {fam}")


def count_params(cfg) -> int:
    """Total parameter count from the table (exact)."""
    table = build_model(cfg).param_table
    return int(sum(math.prod(shape) for shape, _, _ in table.values()))


def active_params(cfg) -> int:
    """Active-per-token parameters (MoE: top_k of num_experts)."""
    total = count_params(cfg)
    if not cfg.moe:
        return total
    table = build_model(cfg).param_table
    expert = sum(math.prod(shape) for name, (shape, _, _) in table.items()
                 if "/moe/w" in name)
    return int(total - expert + expert * cfg.moe_top_k / cfg.num_experts)


def make_input_specs(cfg, shape, dtype_tokens=torch.int32) -> dict:
    """:class:`InputSpec` records of a batch of the given ShapeSpec (no
    allocation). Modality frontends are stubs: whisper gets precomputed
    frame embeddings, llava precomputed patch embeddings."""
    B, S = shape.global_batch, shape.seq_len
    sds = InputSpec
    if cfg.family in ("encdec", "audio"):
        specs = {"frames": sds((B, cfg.enc_frames, cfg.d_model),
                               cfg.dtype_act)}
        if shape.kind == "train":
            specs["tokens"] = sds((B, S), dtype_tokens)
            specs["labels"] = sds((B, S), dtype_tokens)
        elif shape.kind == "prefill":
            specs["tokens"] = sds((B, S), dtype_tokens)
        else:  # decode: one new token; cache handled by the caller
            specs = {"tokens": sds((B, 1), dtype_tokens)}
        return specs
    if cfg.family == "vlm" and shape.kind != "decode":
        P = cfg.num_patch_tokens
        text = S - P
        specs = {"prefix_embeds": sds((B, P, cfg.d_model), cfg.dtype_act),
                 "tokens": sds((B, text), dtype_tokens)}
        if shape.kind == "train":
            specs["labels"] = sds((B, text), dtype_tokens)
        return specs
    if shape.kind == "train":
        return {"tokens": sds((B, S), dtype_tokens),
                "labels": sds((B, S), dtype_tokens)}
    if shape.kind == "prefill":
        return {"tokens": sds((B, S), dtype_tokens)}
    return {"tokens": sds((B, 1), dtype_tokens)}
