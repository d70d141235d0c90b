"""phi3-medium-14b [dense]: RoPE SwiGLU GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352 [arXiv:2404.14219].
Note: 40 query heads do not divide a 16-way tensor axis; projections shard
on the fused (heads*head_dim)=5120 dim instead.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3_medium_14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100_352,
)

SMOKE = ModelConfig(
    arch_id="phi3_medium_14b", family="dense",
    num_layers=2, d_model=60, num_heads=6, num_kv_heads=3, head_dim=10,
    d_ff=112, vocab_size=277,
    dtype_act="float32", dtype_param="float32", remat=False,
)
