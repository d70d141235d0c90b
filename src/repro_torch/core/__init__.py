"""Numerical core of the port: kernels functions, the latent-Kronecker MVM,
solvers, SLQ, inference engines and the marginal likelihood, L-BFGS, the
fixed-budget polish and the fit family (``fit``, ``fit_batch``, ``extend``,
``refit``), the lazy and the batched exact posterior, and the deprecated
:class:`LKGP` facade."""
from .caching import LRUCache
from .engines import (ENGINES, CustomMVMEngine, DegradedSolveError,
                      DenseEngine, DistributedEngine, DistributedOperator,
                      InferenceEngine, IterativeEngine,
                      KernelEngine, KernelMVM, KernelMVMFunction,
                      KernelOperator, LatentKroneckerOperator, get_engine,
                      list_backends, make_mll, make_mll_iterative,
                      mll_cholesky, register_engine, solve_tally,
                      engine_cache_stats)
from .errors import ObservationError, check_grid_columns, check_observed_finite
from .lbfgs import LBFGSResult, lbfgs_minimize
from .gp_kernels import (KERNELS_1D, abs_dist, matern12, matern32, matern52,
                         rbf_ard, sq_dist)
from .matheron import (kronecker_correction, prior_residual_draws,
                       sample_posterior_grid)
from .mvm import (grid_to_packed, joint_cov_packed, kron_dense, lk_mvm,
                  lk_operator, packed_to_grid)
from .lkgp import LKGP
from .polish import PolishResult, make_polish
from .posterior import (BatchedPosterior, Posterior, PosteriorLike,
                        joint_grams, posterior, posterior_batch)
from .slq import (lanczos, rademacher_probes, slq_logdet,
                  slq_logdet_from_tridiag, tridiag_from_cg)
from .solvers import (CGResult, CGSolver, CGTridiag, Solver,
                      StackedSolveResult, cg_solve, cg_solve_tridiag,
                      get_solver, list_solvers, register_solver,
                      resolve_solver)
from .state import (BACKENDS, FitResult, GPData, LKGPConfig, LKGPParams,
                    LKGPState, compiled_cache_stats, extend, fit, fit_batch,
                    gram_matrices, init_params, log_prior, refit,
                    resolve_backend, stack_states, unstack)
from .transforms import TTransform, XTransform, YTransform

__all__ = [
    "ENGINES", "CustomMVMEngine", "DegradedSolveError", "DenseEngine",
    "DistributedEngine", "DistributedOperator",
    "InferenceEngine", "IterativeEngine", "KernelEngine",
    "KernelMVM", "KernelMVMFunction", "KernelOperator",
    "LatentKroneckerOperator", "get_engine", "list_backends",
    "make_mll", "make_mll_iterative", "mll_cholesky",
    "register_engine", "solve_tally",
    "ObservationError", "check_grid_columns", "check_observed_finite",
    "LBFGSResult", "lbfgs_minimize",
    "lanczos", "rademacher_probes", "slq_logdet", "slq_logdet_from_tridiag",
    "tridiag_from_cg",
    "KERNELS_1D", "abs_dist", "matern12", "matern32", "matern52", "rbf_ard",
    "sq_dist",
    "kronecker_correction", "prior_residual_draws", "sample_posterior_grid",
    "grid_to_packed", "joint_cov_packed", "kron_dense", "lk_mvm",
    "lk_operator", "packed_to_grid",
    "Posterior", "PosteriorLike", "joint_grams", "posterior", "LKGP",
    "BatchedPosterior", "posterior_batch",
    "CGResult", "CGSolver", "CGTridiag", "Solver", "StackedSolveResult",
    "cg_solve", "cg_solve_tridiag", "get_solver", "list_solvers",
    "register_solver", "resolve_solver",
    "BACKENDS", "FitResult", "GPData", "LKGPConfig", "LKGPParams",
    "LKGPState", "fit", "gram_matrices", "init_params", "log_prior",
    "resolve_backend", "fit_batch", "extend", "refit", "unstack",
    "stack_states",
    "PolishResult", "make_polish", "LRUCache", "compiled_cache_stats",
    "engine_cache_stats",
    "TTransform", "XTransform", "YTransform",
]
