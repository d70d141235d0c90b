"""Neural-net blocks of the port (counterpart of ``repro.models``): only what
the curve transformer and the hyper-parameter amortizer call. The LM zoo
(decoder forward, MoE, RWKV, Griffin, encoder-decoder, the registry) waits
for ROADMAP queue 1 item 14."""
from .layers import attention, mlp, mlp_params, rms_norm
from .transformer import build_params, table_logical

__all__ = ["attention", "mlp", "mlp_params", "rms_norm", "build_params",
           "table_logical"]
