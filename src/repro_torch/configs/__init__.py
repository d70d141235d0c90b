"""Published architecture configs and their reduced smoke variants
(counterpart of ``repro.configs``)."""
from .base import (ARCH_IDS, SHAPES, ModelConfig, ShapeSpec, get_config,
                   get_smoke_config, resolve_dtype, shape_applicable)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "get_smoke_config", "resolve_dtype", "shape_applicable"]
