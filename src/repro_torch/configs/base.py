"""Architecture config dataclass, input-shape sets, and the registry
(counterpart of ``repro.configs.base``).

Every architecture gets a module in this package defining CONFIG (the exact
published shape) and SMOKE (a reduced same-family variant for CPU tests),
copied field for field from the reference's. ``get_config(arch_id)`` /
``get_smoke_config(arch_id)`` look them up; ``SHAPES`` defines the four
input-shape cells of the LM families.

The reference mixes two kinds of dtype: ``jnp.bfloat16`` by default and the
string ``"float32"`` in the smoke configs. Here both are resolved once, by
:func:`resolve_dtype` in ``__post_init__``, so ``dtype_act`` and
``dtype_param`` are always a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "get_config",
           "get_smoke_config", "shape_applicable", "resolve_dtype"]


def resolve_dtype(dtype: Any) -> torch.dtype:
    """A ``torch.dtype`` from a ``torch.dtype`` or a numpy-style name
    (``"float32"``, ``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).removeprefix("torch.")
    resolved = getattr(torch, name, None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"not a dtype: {dtype!r}")
    return resolved


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe | encdec | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # MLP / attention variants
    mlp_act: str = "swiglu"        # swiglu | geglu | gelu | relu2
    mlp_bias: bool = False
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    scale_embed: bool = False
    window: int | None = None      # uniform local-attention window
    layer_windows: tuple | None = None  # per-layer window pattern (cycled)
    final_logit_cap: float | None = None
    norm_eps: float = 1e-6

    # MoE
    moe: bool = False
    num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_dense_residual: bool = False
    moe_renormalize: bool = True
    capacity_factor: float = 1.25
    num_moe_groups: int = 16       # = data-parallel shard count on the prod mesh

    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_frames: int = 1500
    enc_pos: str = "sinusoidal"

    # hybrid recurrent (recurrentgemma) / ssm (rwkv6)
    rnn_width: int = 0             # RG-LRU lru width
    conv_width: int = 4
    block_pattern: tuple = ()      # e.g. ("rec", "rec", "attn")
    rwkv_head_size: int = 64
    rwkv_chunk: int = 0            # 0 = sequential scan; >0 = chunk-parallel

    # VLM
    num_patch_tokens: int = 0

    # numerics / execution
    dtype_act: Any = torch.bfloat16
    dtype_param: Any = torch.bfloat16
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 512
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        for name in ("dtype_act", "dtype_param"):
            object.__setattr__(self, name, resolve_dtype(getattr(self, name)))

    @property
    def param_count(self) -> int:
        """Exact parameter count from the model's table (the port's
        registry)."""
        from ..models.registry import count_params
        return count_params(self)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "whisper_tiny",
    "recurrentgemma_2b",
    "arctic_480b",
    "qwen3_moe_235b",
    "stablelm_12b",
    "nemotron4_15b",
    "phi3_medium_14b",
    "qwen2_72b",
    "llava_next_mistral_7b",
    "rwkv6_1b6",
]

# Sub-quadratic archs that can serve a 500k-token context (SSM / hybrid with
# bounded attention state). Pure full-attention archs skip long_500k.
_LONG_CONTEXT_OK = {"rwkv6_1b6", "recurrentgemma_2b"}


def shape_applicable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in _LONG_CONTEXT_OK
    return True


def _module(arch_id: str):
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
