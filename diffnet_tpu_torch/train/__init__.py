from .continuation import coarse_to_fine, prolong_field
from .krylov import bicgstab, cg, gmres
from .linear import (gauss_newton_solve, module_linear_solve,
                     multigrid_preconditioner, newton_solve, ns_newton_solve,
                     solve_linear,
                     stokes_block_preconditioner, stokes_linear_solve)
from .stencil import (assemble_stencil, extract_stencil, extract_verified,
                      stencil_diag, stencil_matvec)
from .query import (calc_mean_stddev, point_histograms, query_batched,
                    query_statistical, save_query_results)
from .pretrain import ArrayImageDataset, pretrain_autoencoder
from .trainer import (Callback, CSVLogger, EarlyStopping, OptimizerSwitch,
                      TensorBoardLogger, Trainer, TrainState, load_params,
                      load_state, make_run_dir, save_params, save_state)

__all__ = ["Trainer", "TrainState", "Callback", "CSVLogger", "EarlyStopping",
           "OptimizerSwitch", "TensorBoardLogger", "ArrayImageDataset",
           "pretrain_autoencoder", "make_run_dir", "save_params", "load_params", "save_state",
           "load_state", "query_batched", "query_statistical",
           "calc_mean_stddev", "point_histograms", "save_query_results",
           "coarse_to_fine", "prolong_field", "cg", "bicgstab", "gmres",
           "solve_linear", "module_linear_solve", "multigrid_preconditioner",
           "assemble_stencil", "extract_stencil", "extract_verified",
           "stencil_diag", "stencil_matvec", "newton_solve",
           "ns_newton_solve", "gauss_newton_solve",
           "stokes_block_preconditioner",
           "stokes_linear_solve"]
