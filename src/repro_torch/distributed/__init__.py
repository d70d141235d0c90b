"""Row-sharded latent-Kronecker operator, CG and MLL over torch.distributed."""
from .lkgp_dist import (dist_cg_solve, dist_lk_mvm_fused, dist_lk_operator,
                        dist_mll_value, gather_rows, group_layout)

__all__ = ["dist_lk_operator", "dist_lk_mvm_fused", "dist_cg_solve",
           "dist_mll_value", "gather_rows", "group_layout"]
