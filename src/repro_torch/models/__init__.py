"""Neural-net blocks and the LM zoo of the port (counterpart of
``repro.models``): the blocks the curve transformer and the amortizer call,
and the decoder family (dense, MoE, VLM) and the RWKV-6 family behind the
registry (``build_model``). Griffin and the encoder-decoder wait for ROADMAP
queue 1 item 14: ``build_model`` raises ``NotImplementedError`` for them."""
from .layers import (Cache, apply_rope, attention, chunked_ce_loss,
                     decode_attention, layer_norm, mlp, mlp_params, rms_norm,
                     rope)
from .registry import (InputSpec, Model, active_params, build_model,
                       count_params, make_input_specs)
from .transformer import build_params, table_logical

__all__ = ["Cache", "apply_rope", "attention", "chunked_ce_loss",
           "decode_attention", "layer_norm", "mlp", "mlp_params", "rms_norm",
           "rope", "build_params", "table_logical", "InputSpec", "Model",
           "active_params", "build_model", "count_params",
           "make_input_specs"]
