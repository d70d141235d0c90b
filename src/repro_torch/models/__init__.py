"""Neural-net blocks and the LM zoo of the port (counterpart of
``repro.models``): the blocks the curve transformer and the amortizer call,
and all ten configs' families behind the registry (``build_model``): the
decoder family (dense, MoE, VLM), the Whisper encoder-decoder, the Griffin
hybrid and RWKV-6."""
from .layers import (Cache, apply_rope, attention, chunked_ce_loss,
                     decode_attention, layer_norm, mlp, mlp_params, rms_norm,
                     rope)
from .encdec import EncDecCache
from .griffin import GriffinCache
from .registry import (InputSpec, Model, active_params, build_model,
                       count_params, make_input_specs)
from .transformer import build_params, table_logical

__all__ = ["Cache", "apply_rope", "attention", "chunked_ce_loss",
           "decode_attention", "layer_norm", "mlp", "mlp_params", "rms_norm",
           "rope", "build_params", "table_logical", "InputSpec", "Model",
           "active_params", "build_model", "count_params",
           "make_input_specs", "EncDecCache", "GriffinCache"]
