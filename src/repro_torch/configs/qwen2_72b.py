"""qwen2-72b [dense]: GQA with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2407.10671].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2_72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152_064,
    qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    arch_id="qwen2_72b", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=281,
    qkv_bias=True,
    dtype_act="float32", dtype_param="float32", remat=False,
)
