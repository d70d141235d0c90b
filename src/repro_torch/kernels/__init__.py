"""Hand-written GPU kernels of the port, their wrappers and plain oracles."""
from .gram import rbf_gram_cuda, rbf_gram_plain
from .lk_mvm import (lk_mvm_fused, lk_mvm_fused_plain,
                     lk_mvm_fused_rows, lk_mvm_fused_rows_plain,
                     lk_mvm_stage_left, lk_mvm_stage_left_plain,
                     lk_mvm_stage_right, lk_mvm_stage_right_plain,
                     lk_mvm_two_stage, lk_mvm_two_stage_plain, mvm_launch)
from .ops import lk_mvm_op, rbf_gram_op
from .ref import lk_mvm_ref, rbf_gram_ref

__all__ = ["mvm_launch", "lk_mvm_fused", "lk_mvm_fused_plain",
           "lk_mvm_two_stage", "lk_mvm_two_stage_plain", "lk_mvm_stage_right",
           "lk_mvm_stage_right_plain", "lk_mvm_stage_left",
           "lk_mvm_stage_left_plain", "lk_mvm_fused_rows",
           "lk_mvm_fused_rows_plain", "rbf_gram_cuda", "rbf_gram_plain",
           "lk_mvm_op", "rbf_gram_op", "lk_mvm_ref", "rbf_gram_ref"]
