"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, pattern 1 attn : 2 rec.

26L d_model=2560 10H MQA (kv=1) d_ff=7680 vocab=256000 [arXiv:2402.19427; hf].
Griffin details: lru_width=2560, window=2048, GeGLU MLP, embeddings scaled by
sqrt(d_model), final logit soft-cap 30.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma_2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000,
    rnn_width=2560, conv_width=4, window=2048,
    block_pattern=("rec", "rec", "attn"),
    mlp_act="geglu", scale_embed=True, final_logit_cap=30.0,
)

SMOKE = ModelConfig(
    arch_id="recurrentgemma_2b", family="hybrid",
    num_layers=5, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
    d_ff=128, vocab_size=251,
    rnn_width=64, conv_width=4, window=8,
    block_pattern=("rec", "rec", "attn"),
    mlp_act="geglu", scale_embed=True, final_logit_cap=30.0,
    dtype_act="float32", dtype_param="float32", remat=False,
)
