"""Row-sharded latent-Kronecker operator, CG and MLL over torch.distributed,
and the logical-axis sharding rules of the LM zoo on a ``DeviceMesh``."""
from .lkgp_dist import (dist_cg_solve, dist_lk_mvm_fused, dist_lk_operator,
                        dist_mll_value, gather_rows, group_layout)
from .sharding import (ACT_RULES, FSDP_RULES, SERVE_RULES, TP_RULES,
                       ZERO_RULES, batch_shardings, dp_axes, get_active_mesh,
                       logical_to_pspec, make_constrain, param_shardings,
                       rules_for, set_active_mesh)

__all__ = ["dist_lk_operator", "dist_lk_mvm_fused", "dist_cg_solve",
           "dist_mll_value", "gather_rows", "group_layout",
           "TP_RULES", "FSDP_RULES", "ZERO_RULES", "SERVE_RULES", "ACT_RULES",
           "rules_for", "logical_to_pspec", "make_constrain",
           "param_shardings", "batch_shardings", "dp_axes",
           "set_active_mesh", "get_active_mesh"]
