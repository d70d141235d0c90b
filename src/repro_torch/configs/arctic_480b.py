"""arctic-480b [moe]: 128 experts top-2 plus a parallel dense residual MLP.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base]. The published dense-MoE-hybrid places a
dense MLP residual in parallel with the MoE FFN; both use d_ff=4864 here.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="arctic_480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32_000,
    moe=True, num_experts=128, moe_top_k=2, moe_d_ff=4864,
    moe_dense_residual=True, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    arch_id="arctic_480b", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=257,
    moe=True, num_experts=8, moe_top_k=2, moe_d_ff=96,
    moe_dense_residual=True, capacity_factor=1.25, num_moe_groups=1,
    dtype_act="float32", dtype_param="float32", remat=False,
)
