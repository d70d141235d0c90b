"""rwkv6-1.6b "Finch" [ssm]: attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536, head_size=64 (32 wkv heads)
[arXiv:2404.05892].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6_1b6", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65_536,
    rwkv_head_size=64, use_rope=False,
    rwkv_chunk=16,  # chunk-parallel wkv (exact; dense products per chunk)
)

SMOKE = ModelConfig(
    arch_id="rwkv6_1b6", family="ssm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=293,
    rwkv_head_size=16, use_rope=False,
    dtype_act="float32", dtype_param="float32", remat=False,
)
