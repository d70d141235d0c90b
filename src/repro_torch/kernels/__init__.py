"""Hand-written GPU kernels of the port, their wrappers and plain oracles."""
from .lk_mvm import lk_mvm_cuda, lk_mvm_fused, lk_mvm_fused_plain
from .ops import lk_mvm_op, rbf_gram_op
from .ref import lk_mvm_ref, rbf_gram_ref

__all__ = ["lk_mvm_cuda", "lk_mvm_fused", "lk_mvm_fused_plain", "lk_mvm_op",
           "rbf_gram_op", "lk_mvm_ref", "rbf_gram_ref"]
