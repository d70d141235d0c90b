"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai/stablelm-2-12b family]. SwiGLU, RoPE."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm_12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=160,
    d_ff=13824, vocab_size=100_352,
)

SMOKE = ModelConfig(
    arch_id="stablelm_12b", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=269,
    dtype_act="float32", dtype_param="float32", remat=False,
)
