"""Numerical core of the port: kernels functions, the latent-Kronecker MVM,
solvers, inference engines and the lazy posterior."""
from .engines import (ENGINES, CustomMVMEngine, DegradedSolveError,
                      DenseEngine, InferenceEngine, IterativeEngine,
                      KernelEngine, LatentKroneckerOperator, get_engine,
                      list_backends, register_engine, solve_tally)
from .gp_kernels import (KERNELS_1D, abs_dist, matern12, matern32, matern52,
                         rbf_ard, sq_dist)
from .matheron import (kronecker_correction, prior_residual_draws,
                       sample_posterior_grid)
from .mvm import (grid_to_packed, joint_cov_packed, kron_dense, lk_mvm,
                  lk_operator, packed_to_grid)
from .posterior import Posterior, PosteriorLike, joint_grams, posterior
from .solvers import (CGResult, CGSolver, CGTridiag, Solver,
                      StackedSolveResult, cg_solve, cg_solve_tridiag,
                      get_solver, list_solvers, register_solver,
                      resolve_solver)
from .state import (BACKENDS, GPData, LKGPConfig, LKGPParams, LKGPState,
                    gram_matrices, init_params, resolve_backend)
from .transforms import TTransform, XTransform, YTransform

__all__ = [
    "ENGINES", "CustomMVMEngine", "DegradedSolveError", "DenseEngine",
    "InferenceEngine", "IterativeEngine", "KernelEngine",
    "LatentKroneckerOperator", "get_engine", "list_backends",
    "register_engine", "solve_tally",
    "KERNELS_1D", "abs_dist", "matern12", "matern32", "matern52", "rbf_ard",
    "sq_dist",
    "kronecker_correction", "prior_residual_draws", "sample_posterior_grid",
    "grid_to_packed", "joint_cov_packed", "kron_dense", "lk_mvm",
    "lk_operator", "packed_to_grid",
    "Posterior", "PosteriorLike", "joint_grams", "posterior",
    "CGResult", "CGSolver", "CGTridiag", "Solver", "StackedSolveResult",
    "cg_solve", "cg_solve_tridiag", "get_solver", "list_solvers",
    "register_solver", "resolve_solver",
    "BACKENDS", "GPData", "LKGPConfig", "LKGPParams", "LKGPState",
    "gram_matrices", "init_params", "resolve_backend",
    "TTransform", "XTransform", "YTransform",
]
