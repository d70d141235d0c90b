"""llava-next-mistral-7b [vlm]: Mistral-7B backbone + anyres patch prefix.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf]. The vision tower is a STUB per the
assignment: input_specs() provides 2880 precomputed patch embeddings (anyres
tiling: 4 tiles + base image, 576 patches each) consumed as a prefix.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava_next_mistral_7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32_000,
    rope_theta=1_000_000.0, num_patch_tokens=2880,
)

SMOKE = ModelConfig(
    arch_id="llava_next_mistral_7b", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=283,
    num_patch_tokens=12,
    dtype_act="float32", dtype_param="float32", remat=False,
)
