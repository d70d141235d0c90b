"""Hyper-parameter amortizer: a set encoder from curves to LKGP parameters
(counterpart of ``repro.amortize.encoder``).

The encoder maps a whole masked task (hyper-parameter vectors ``X`` (n, d),
progression grid ``t`` (m,), observed curves ``Y`` / ``mask`` (n, m), all
in the *transformed* view the MLL objective sees) directly to the LKGP's
flat unconstrained parameter vector (d ARD log-lengthscales, the t
log-lengthscale, the log-outputscale, the log-noise), so a fit can start
from a data-dependent point and finish with a few polish steps
(:mod:`repro_torch.core.polish`) instead of a full host L-BFGS.

Architecture, the curve transformer used twice:

1. **curve stage**: each curve becomes ``m`` epoch tokens plus a token
   embedding its hyper-parameter vector, run through the shared
   bidirectional encoder blocks; the hyper-parameter token's output
   summarises the curve;
2. **set stage**: the ``n`` curve summaries attend to each other through a
   second, smaller stack of the same blocks and are mean-pooled (at
   n > 1024 this attention takes the chunked path of
   :func:`repro_torch.models.layers.attention`);
3. **head**: a gelu MLP decodes a bounded *delta* around the prior-mean
   init: ``base + delta_scale * tanh(delta / delta_scale)``. The last head
   weight is zero-initialised, so an untrained amortizer predicts exactly
   :func:`repro_torch.core.state.init_params`.

Everything computes in float32 (``AmortizerConfig.dtype``) on the
parameters' device. :meth:`Amortizer.init_batch` runs the single-task
forward once per task, so a coalesced ``fit_batch`` starts every task from
the bits a single-task ``fit`` starts from. Files are the reference's
``.npz`` format (``__cfg__`` JSON with the dtype by name, parameter paths
joined with ``/``): a file written by either package loads in the other.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..baselines.curve_transformer import (CurveTransformerConfig,
                                           embed_curves, layer_table,
                                           transformer_stack)
from ..baselines.curve_transformer import param_table as curve_param_table
from ..core.state import (LKGPParams, _flatten_params, _unflatten_params,
                          init_params)
from ..models.layers import rms_norm
from ..models.transformer import _assign, build_params

__all__ = ["AmortizerConfig", "Amortizer", "param_table", "init_amortizer",
           "forward", "forward_tasks", "get_amortizer", "register_amortizer",
           "clear_amortizer_registry", "FIXTURE_DIR"]

FIXTURE_DIR = Path(__file__).resolve().parent / "fixtures"


@dataclass(frozen=True)
class AmortizerConfig:
    """Shape configuration; ``d`` is the hyper-parameter dimension."""
    d: int = 5
    d_model: int = 32
    curve_layers: int = 2      # per-curve encoder depth
    set_layers: int = 1        # cross-curve encoder depth
    num_heads: int = 4
    d_ff: int = 64
    mlp_act: str = "swiglu"
    norm_eps: float = 1e-6
    fourier_feats: int = 4
    delta_scale: float = 3.0   # bound on |predicted - default| per coordinate
    dtype: Any = torch.float32

    @property
    def n_out(self) -> int:
        """Flat unconstrained LKGP parameter count (see ``LKGPParams``)."""
        return self.d + 3

    def curve_cfg(self) -> CurveTransformerConfig:
        """The curve-transformer view of this config (shared blocks)."""
        return CurveTransformerConfig(
            d_in=self.d, d_model=self.d_model, num_layers=self.curve_layers,
            num_heads=self.num_heads, d_ff=self.d_ff, mlp_act=self.mlp_act,
            norm_eps=self.norm_eps, fourier_feats=self.fourier_feats,
            dtype=self.dtype)


# --------------------------------------------------------------------------
# parameter table / init
# --------------------------------------------------------------------------
def param_table(cfg: AmortizerConfig) -> dict:
    """Curve-transformer table minus its Gaussian head, plus the set stage
    and the head. ``set_final_norm`` ends with ``final_norm`` on purpose:
    :func:`repro_torch.models.transformer.build_params` zeroes norm scales
    by name suffix."""
    ccfg = cfg.curve_cfg()
    D = cfg.d_model
    table = {k: v for k, v in curve_param_table(ccfg).items()
             if not k.startswith("head/")}
    for k, (shape, logical, fan) in layer_table(ccfg).items():
        table[f"set_layers/{k}"] = ((cfg.set_layers, *shape),
                                    ("layers", *logical), fan)
    table["set_final_norm"] = ((D,), ("embed",), None)
    table["head/w0"] = ((D, D), ("embed", None), D)
    table["head/b0"] = ((D,), (None,), None)
    table["head/w1"] = ((D, cfg.n_out), ("embed", None), D)
    return table


def init_amortizer(generator: torch.Generator, cfg: AmortizerConfig) -> dict:
    """Fresh parameters on ``generator``'s device; the last head weight is
    zeroed so the untrained encoder predicts exactly the prior-mean init."""
    p = build_params(generator, param_table(cfg), cfg.dtype)
    p["head"]["w1"] = torch.zeros_like(p["head"]["w1"])
    return p


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def forward_tasks(params, Xn, tn, Yn, mask, cfg: AmortizerConfig):
    """T tasks at once: ``Xn`` (T, n, d), ``tn`` (T, m), ``Yn`` / ``mask``
    (T, n, m) -> (T, d + 3). Each task's curves attend only within the
    task. Training uses this; a fit uses :func:`forward`."""
    ccfg = cfg.curve_cfg()
    dt = ccfg.dtype
    T, n, m = Yn.shape
    x = embed_curves(params, Xn.reshape(T * n, -1).to(dt),
                     Yn.reshape(T * n, m).to(dt),
                     mask.reshape(T * n, m).to(dt),
                     tn.to(dt).repeat_interleave(n, dim=0), ccfg)
    e = rms_norm(x, params["final_norm"], ccfg.norm_eps)[:, 0, :]  # (T n, D)
    s = transformer_stack(e.reshape(T, n, -1), params["set_layers"], ccfg)
    s = rms_norm(s, params["set_final_norm"], ccfg.norm_eps)
    pooled = torch.mean(s, dim=1)                                  # (T, D)
    h = torch.nn.functional.gelu(
        pooled @ params["head"]["w0"] + params["head"]["b0"],
        approximate="tanh")
    delta = h @ params["head"]["w1"]
    base = _flatten_params(init_params(cfg.d, delta.dtype, delta.device))
    scale = torch.tensor(cfg.delta_scale, dtype=delta.dtype,
                         device=delta.device)
    return base + scale * torch.tanh(delta / scale)


def forward(params, Xn, tn, Yn, mask, cfg: AmortizerConfig) -> torch.Tensor:
    """One task -> flat unconstrained LKGP parameter vector (d + 3,).

    ``Xn`` (n, d), ``tn`` (m,), ``Yn`` / ``mask`` (n, m) are the TRANSFORMED
    training data (unit-cube configs, [0, 1] progressions, normalised
    curves), exactly what the MLL objective consumes.
    """
    return forward_tasks(params, Xn[None], tn[None], Yn[None], mask[None],
                         cfg)[0]


# --------------------------------------------------------------------------
# the user-facing artifact
# --------------------------------------------------------------------------
def _params_device(params: dict) -> torch.device:
    return params["in_proj"]["w"].device


class Amortizer:
    """A (pre)trained amortizer: a config and its parameters, which live on
    one device; every call computes there and returns float32 tensors
    there (``fit`` casts them to the state's dtype and device)."""

    def __init__(self, cfg: AmortizerConfig, params: dict):
        self.cfg = cfg
        self.params = params

    @property
    def device(self) -> torch.device:
        return _params_device(self.params)

    def _tensor(self, a) -> torch.Tensor:
        """A fresh float32 copy on the amortizer's device: a row of a
        stacked batch then computes from a tensor of its own, as a
        single task does."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.cfg.dtype, copy=True)
        return torch.tensor(np.asarray(a), dtype=self.cfg.dtype,
                            device=self.device)

    def init_flat(self, Xn, tn, Yn, mask) -> torch.Tensor:
        """Predicted flat unconstrained parameter vector for one task."""
        with torch.no_grad():
            return forward(self.params, self._tensor(Xn), self._tensor(tn),
                           self._tensor(Yn), self._tensor(mask), self.cfg)

    def init_for(self, Xn, tn, Yn, mask) -> LKGPParams:
        """Predicted :class:`LKGPParams` for one (transformed) task."""
        return _unflatten_params(self.init_flat(Xn, tn, Yn, mask), self.cfg.d)

    def init_batch(self, Xn, tn, Yn, mask) -> LKGPParams:
        """Per-task predictions for a (B, ...) stack, leading axis B.

        Runs the single-task forward once per task (not one batched
        forward), so every row is bitwise :meth:`init_for` on that task:
        the invariant ``fit_batch`` relies on.
        """
        d = self.cfg.d
        xs = torch.stack([self.init_flat(Xn[i], tn[i], Yn[i], mask[i])
                          for i in range(Xn.shape[0])])
        return LKGPParams(xs[:, :d], xs[:, d], xs[:, d + 1], xs[:, d + 2])

    # ---- persistence -----------------------------------------------------
    def save(self, path) -> None:
        """Write the reference's self-describing ``.npz`` (config JSON with
        the dtype by name, flat ``/``-joined parameter paths)."""
        flat = _flatten_tree(self.params)
        cfg = asdict(self.cfg)
        cfg["dtype"] = str(cfg["dtype"]).removeprefix("torch.")
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, __cfg__=np.asarray(json.dumps(cfg)),
                 **{k: v.detach().cpu().numpy() for k, v in flat.items()})

    @classmethod
    def load(cls, path, device=None) -> "Amortizer":
        """Read a file of either package onto ``device`` (``None``: the
        GPU)."""
        dev = resolve_device(device)
        with np.load(path) as z:
            cfg_d = json.loads(str(z["__cfg__"]))
            cfg_d["dtype"] = getattr(torch, cfg_d["dtype"])
            cfg = AmortizerConfig(**cfg_d)
            params = _nest_tree({
                k: torch.as_tensor(z[k]).to(device=dev, dtype=cfg.dtype)
                for k in z.files if k != "__cfg__"})
        return cls(cfg, params)


def _flatten_tree(tree, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flatten_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest_tree(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        _assign(out, path, v)
    return out


# --------------------------------------------------------------------------
# registry: fit(init="amortized") resolves through here
# --------------------------------------------------------------------------
_REGISTRY: dict[int, Amortizer] = {}


def register_amortizer(am: Amortizer) -> Amortizer:
    """Make ``am`` the process-wide amortizer for its ``d``; returns it."""
    _REGISTRY[am.cfg.d] = am
    return am


def clear_amortizer_registry() -> None:
    _REGISTRY.clear()


def get_amortizer(d: int, device=None) -> Amortizer:
    """The registered amortizer for ``d``, falling back to the packaged
    pretrained fixture (``fixtures/amortizer_d{d}.npz``), loaded onto
    ``device`` (``None``: the GPU) and registered. A registered amortizer
    is returned wherever it lives."""
    am = _REGISTRY.get(d)
    if am is None:
        path = FIXTURE_DIR / f"amortizer_d{d}.npz"
        if not path.exists():
            raise ValueError(
                f"no amortizer registered for d={d} and no packaged fixture "
                f"at {path}; train one with "
                "repro_torch.amortize.train_amortizer and "
                "register_amortizer(...), or pass amortizer= explicitly")
        am = register_amortizer(Amortizer.load(path, device))
    return am
