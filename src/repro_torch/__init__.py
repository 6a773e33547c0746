"""LPD-SVM in PyTorch with hand-written CUDA kernels for the H100.

A port of the JAX package ``repro`` (which stays the reference and is never
imported here).  This slice is the monolithic route: ``LPDSVM(...).fit(x, y)``
then ``predict(x_test)`` on one card, through kernel B1 (gram) in stage 1 and
prediction, and kernel B2 (SMO epoch) in stage 2.
"""
from repro_torch.core import (LPDSVM, FitStats, KernelParams, LowRankFactor,
                              SolverConfig, TaskBatch, compute_factor,
                              median_gamma, solve_batch)

__all__ = ["LPDSVM", "FitStats", "KernelParams", "LowRankFactor",
           "SolverConfig", "TaskBatch", "compute_factor", "median_gamma",
           "solve_batch"]
