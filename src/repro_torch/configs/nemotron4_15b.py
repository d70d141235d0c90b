"""nemotron-4-15b [dense]: GQA, squared-ReLU MLP (no gating).

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 [arXiv:2402.16819].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron4_15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256_000,
    mlp_act="relu2",
)

SMOKE = ModelConfig(
    arch_id="nemotron4_15b", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=271,
    mlp_act="relu2",
    dtype_act="float32", dtype_param="float32", remat=False,
)
