"""LPD-SVM core, PyTorch port: the monolithic fit -> predict route."""
from repro_torch.core.dual_solver import (SolveResult, SolverConfig, TaskBatch,
                                          dual_objective, duality_gap,
                                          primal_objective, solve_batch,
                                          solve_one)
from repro_torch.core.kernel_fn import (KernelParams, apply_epilogue, gram,
                                        kernel_diag, median_gamma)
from repro_torch.core.nystrom import (LowRankFactor, compute_factor,
                                      select_landmarks)
from repro_torch.core.ovo import (build_ovo_tasks, class_pairs,
                                  ovo_decision_values, ovo_vote)
from repro_torch.core.svm import LPDSVM, FitStats

__all__ = [
    "SolveResult", "SolverConfig", "TaskBatch", "dual_objective",
    "duality_gap", "primal_objective", "solve_batch", "solve_one",
    "KernelParams", "apply_epilogue", "gram", "kernel_diag", "median_gamma",
    "LowRankFactor", "compute_factor", "select_landmarks",
    "build_ovo_tasks", "class_pairs", "ovo_decision_values", "ovo_vote",
    "LPDSVM", "FitStats",
]
