"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, QK-norm, GQA kv=4.

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per-expert) vocab=151936
[hf:Qwen/Qwen3-30B-A3B family scaled]. Qwen3 uses head_dim=128 (decoupled
from d_model/num_heads) and per-head RMS QK-norm; top-k probabilities are
renormalised.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3_moe_235b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151_936,
    qk_norm=True, rope_theta=1_000_000.0,
    moe=True, num_experts=128, moe_top_k=8, moe_d_ff=1536,
    moe_renormalize=True, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    arch_id="qwen3_moe_235b", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=263,
    qk_norm=True,
    moe=True, num_experts=8, moe_top_k=4, moe_d_ff=96,
    moe_renormalize=True, capacity_factor=1.25, num_moe_groups=1,
    dtype_act="float32", dtype_param="float32", remat=False,
)
