"""whisper-tiny [audio]: enc-dec, conv frontend stubbed (frame embeddings).

4L d_model=384 6H (kv=6 -> MHA) d_ff=1536 vocab=51865 [arXiv:2212.04356].
"4L" = 4 encoder + 4 decoder blocks (whisper-tiny). No RoPE: sinusoidal
encoder positions, learned decoder positions. GELU MLP with biases.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper_tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865,
    enc_layers=4, enc_frames=1500,
    mlp_act="gelu", mlp_bias=True, use_rope=False,
)

SMOKE = ModelConfig(
    arch_id="whisper_tiny", family="audio",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=509,
    enc_layers=2, enc_frames=24,
    mlp_act="gelu", mlp_bias=True, use_rope=False,
    dtype_act="float32", dtype_param="float32", remat=False,
)
