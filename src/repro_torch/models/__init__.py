"""Neural-net blocks and the LM zoo of the port (counterpart of
``repro.models``): the blocks the curve transformer and the amortizer call,
and the RWKV-6 family behind the registry (``build_model``). The decoder
family (dense, MoE, VLM), Griffin and the encoder-decoder wait for ROADMAP
queue 1 item 14: ``build_model`` raises ``NotImplementedError`` for them."""
from .layers import (attention, chunked_ce_loss, layer_norm, mlp,
                     mlp_params, rms_norm)
from .registry import (InputSpec, Model, active_params, build_model,
                       count_params, make_input_specs)
from .transformer import build_params, table_logical

__all__ = ["attention", "chunked_ce_loss", "layer_norm", "mlp", "mlp_params",
           "rms_norm", "build_params", "table_logical", "InputSpec", "Model",
           "active_params", "build_model", "count_params",
           "make_input_specs"]
