"""Curve-prediction transformer: amortized learning-curve continuation
(counterpart of ``repro.baselines.curve_transformer``).

The paper's Transformer competitor (an FT-PFN-style amortized predictor):
each curve is a sequence of epoch tokens carrying ``(observed value,
missing-value mask, progression encoding)``, a conditioning token embeds
the curve's hyper-parameter vector, a bidirectional pre-norm encoder attends
over the ``m + 1`` tokens, and a heteroscedastic head decodes a Gaussian
``N(mu_j, sigma_j^2)`` for every epoch ``j``, observed or not. Trained on
streams of synthetic tasks (:mod:`repro_torch.baselines.pretrain`), one
forward pass amortizes the whole fit-and-predict loop the LKGP runs per task.

Parameters are a nested dict of tensors with the reference's pytree paths
(``params["layers"]["mlp"]["wi_0"]`` is ``layers/mlp/wi_0``), the layer
parameters stacked over a leading ``num_layers`` axis; the stack is a loop
over that axis where the reference scans. Everything computes in the
config's dtype (float32) on the parameters' device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..models.layers import attention, mlp, mlp_params, rms_norm
from ..models.transformer import build_params, table_logical

__all__ = ["CurveTransformerConfig", "CurveModel", "param_table",
           "layer_table", "transformer_stack", "build_curve_model",
           "encode_features", "forward", "gaussian_nll", "curve_loss",
           "normalize_t", "predict_task"]


@dataclass(frozen=True)
class CurveTransformerConfig:
    """Shape + loss configuration for the curve transformer."""
    d_in: int = 7              # hyper-parameter dimension
    d_model: int = 64
    num_layers: int = 3
    num_heads: int = 4
    d_ff: int = 128
    mlp_act: str = "swiglu"
    norm_eps: float = 1e-6
    min_sigma: float = 1e-3    # floor on the predicted std
    fourier_feats: int = 6     # continuous progression encoding (any m works)
    obs_loss_weight: float = 0.1  # NLL weight on observed (vs continued) cells
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def num_features(self) -> int:
        # (masked value, mask flag, t_norm) + sin/cos Fourier features of t.
        return 3 + 2 * self.fourier_feats


class CurveModel(NamedTuple):
    """Functional endpoints, the shape :func:`repro_torch.train.trainer
    .make_train_step` takes: ``init(generator)`` -> params,
    ``loss(params, batch)`` -> scalar, ``predict(params, hp, y, mask,
    t_norm)`` -> (mu, sigma)."""
    cfg: CurveTransformerConfig
    param_table: dict
    logical: dict
    init: Callable
    loss: Callable
    predict: Callable


# --------------------------------------------------------------------------
# parameter table (the (shape, logical_axes, fan_in) format of the zoo)
# --------------------------------------------------------------------------
def layer_table(cfg: CurveTransformerConfig) -> dict:
    """Parameter table for ONE encoder block (pre-norm attention + MLP);
    the amortizer stacks the same blocks under its own top-level names."""
    D, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    t = {
        "ln1": ((D,), ("embed",), None),
        "wq": ((D, H * Dh), ("embed", "heads_fused"), D),
        "wk": ((D, H * Dh), ("embed", "heads_fused"), D),
        "wv": ((D, H * Dh), ("embed", "heads_fused"), D),
        "wo": ((H * Dh, D), ("heads_fused", "embed"), H * Dh),
        "ln2": ((D,), ("embed",), None),
    }
    for k, v in mlp_params(cfg.mlp_act, D, cfg.d_ff).items():
        t[f"mlp/{k}"] = v
    return t


def param_table(cfg: CurveTransformerConfig) -> dict:
    D = cfg.d_model
    table = {
        "in_proj/w": ((cfg.num_features, D), (None, "embed"), cfg.num_features),
        "in_proj/b": ((D,), ("embed",), None),
        "hp_embed/w0": ((cfg.d_in, D), (None, "embed"), cfg.d_in),
        "hp_embed/b0": ((D,), ("embed",), None),
        "hp_embed/w1": ((D, D), ("embed", None), D),
        "final_norm": ((D,), ("embed",), None),
        "head/w": ((D, 2), ("embed", None), D),
        "head/b": ((2,), (None,), None),
    }
    for k, (shape, logical, fan) in layer_table(cfg).items():
        table[f"layers/{k}"] = ((cfg.num_layers, *shape),
                                ("layers", *logical), fan)
    return table


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def normalize_t(t) -> np.ndarray:
    """Log-scale progressions to [0, 1] (matches ``TTransform``); float32.

    Host numpy on purpose, as the reference's: callers pass concrete epoch
    grids.
    """
    lt = np.log(np.asarray(t, np.float64))
    span = max(float(lt[-1] - lt[0]), 1e-9)
    return ((lt - lt[0]) / span).astype(np.float32)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it everywhere
    (torch's ``F.softplus`` returns ``x`` itself above 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def encode_features(y, mask, t_norm, cfg: CurveTransformerConfig):
    """Per-epoch token features: masked value, mask flag, progression enc.

    ``y``, ``mask``: (B, m); ``t_norm``: (m,) shared by every row, or
    (B, m), one grid a row (the amortizer's batches of tasks).
    """
    B, m = y.shape
    dt = cfg.dtype
    ym = (y * mask).to(dt)
    freqs = (2.0 ** torch.arange(cfg.fourier_feats, dtype=torch.float32,
                                 device=y.device)) * math.pi
    ang = t_norm.float().unsqueeze(-1) * freqs                # (.., m, F)
    tf = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    tf = tf.expand(B, m, 2 * cfg.fourier_feats)
    tcol = t_norm.to(dt).unsqueeze(-1).expand(B, m, 1)
    return torch.cat([ym[..., None], mask.to(dt)[..., None], tcol,
                      tf.to(dt)], dim=-1)


def _layer(layers: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def transformer_stack(x, layers: dict, cfg: CurveTransformerConfig):
    """The bidirectional pre-norm encoder blocks over ``x`` (B, S, d_model);
    ``layers`` the stacked (num_layers, ...) block parameters (the
    ``layers/*`` entries of :func:`param_table`, or any other stack built
    from :func:`layer_table`)."""
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    for i in range(layers["ln1"].shape[0]):
        lp = _layer(layers, i)
        hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = (hn @ lp["wq"]).reshape(B, S, H, Dh)
        k = (hn @ lp["wk"]).reshape(B, S, H, Dh)
        v = (hn @ lp["wv"]).reshape(B, S, H, Dh)
        a = attention(q, k, v, causal=False)              # bidirectional
        x = x + a.reshape(B, S, H * Dh) @ lp["wo"]
        hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp(hn, lp["mlp"], cfg.mlp_act)
    return x


def embed_curves(params, hp, y, mask, t_norm, cfg: CurveTransformerConfig):
    """The token stack (B, m + 1, d_model) after the encoder: the
    hyper-parameter token first, then the m epoch tokens. Shared by
    :func:`forward` and the amortizer's curve stage."""
    dt = cfg.dtype
    x = encode_features(y, mask, t_norm, cfg)
    x = x @ params["in_proj"]["w"] + params["in_proj"]["b"]
    h0 = torch.nn.functional.gelu(
        hp.to(dt) @ params["hp_embed"]["w0"] + params["hp_embed"]["b0"],
        approximate="tanh")
    h0 = h0 @ params["hp_embed"]["w1"]
    x = torch.cat([h0[:, None, :], x], dim=1)              # (B, m + 1, D)
    return transformer_stack(x, params["layers"], cfg)


def forward(params, hp, y, mask, t_norm, cfg: CurveTransformerConfig):
    """hp: (B, d_in); y, mask: (B, m); t_norm: (m,) -> (mu, sigma), (B, m).

    Values at ``mask == 0`` cells never enter the computation (the feature
    encoder zeroes them), so predictions depend only on the observed prefix.
    """
    x = embed_curves(params, hp, y, mask, t_norm, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out = x[:, 1:, :] @ params["head"]["w"] + params["head"]["b"]  # (B, m, 2)
    mu = out[..., 0]
    sigma = cfg.min_sigma + softplus(out[..., 1])
    return mu, sigma


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
def gaussian_nll(mu, sigma, target):
    """Per-cell negative log-likelihood of a heteroscedastic Gaussian."""
    var = sigma * sigma
    return 0.5 * (torch.log(2.0 * math.pi * var) + (target - mu) ** 2 / var)


def curve_loss(params, batch: dict, cfg: CurveTransformerConfig):
    """Weighted NLL: full weight on continuation cells, ``obs_loss_weight``
    on the (noisy) observed prefix. Batch keys: hp, y, mask, t_norm, target.
    """
    mu, sigma = forward(params, batch["hp"], batch["y"], batch["mask"],
                        batch["t_norm"], cfg)
    nll = gaussian_nll(mu, sigma, batch["target"].to(mu.dtype))
    mask = batch["mask"].to(mu.dtype)
    w = mask * cfg.obs_loss_weight + (1.0 - mask)
    return torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)


# --------------------------------------------------------------------------
# model + convenience prediction
# --------------------------------------------------------------------------
def build_curve_model(cfg: CurveTransformerConfig) -> CurveModel:
    table = param_table(cfg)
    return CurveModel(
        cfg=cfg, param_table=table, logical=table_logical(table),
        init=lambda generator, dtype=cfg.dtype: build_params(generator, table,
                                                             dtype),
        loss=lambda p, b: curve_loss(p, b, cfg),
        predict=lambda p, hp, y, mask, t_norm: forward(p, hp, y, mask,
                                                       t_norm, cfg),
    )


def _device_of(params: dict) -> torch.device:
    return params["in_proj"]["w"].device


def predict_task(params, cfg: CurveTransformerConfig, X, t, Y, mask):
    """One amortized forward pass over a task on the parameters' device;
    returns numpy float64 (mean, var), each (n, m)."""
    dev = _device_of(params)

    def tensor(a):
        # the caller's dtype, as the reference's jnp.asarray keeps it
        return torch.as_tensor(  # lint: disable=RT104 (the reference's)
            np.asarray(a), device=dev)

    with torch.no_grad():
        mu, sigma = forward(params, tensor(X), tensor(Y), tensor(mask),
                            tensor(normalize_t(t)), cfg)
    sigma = sigma.cpu().numpy().astype(np.float64)
    return mu.cpu().numpy().astype(np.float64), sigma ** 2
