"""LPD-SVM in PyTorch with hand-written CUDA kernels for the H100.

A port of the JAX package ``repro`` (which stays the reference and is never
imported here).  Two routes of ``LPDSVM(...).fit(x, y)`` then
``predict(x_test)``: the monolithic one, through kernel B1
(gram) in stage 1 and prediction and kernel B2 (SMO epoch) in stage 2, and
the out-of-core one (``stream`` / ``stream_config``), where x and G stay in
host memory, stage-1 chunks cross the bus as int8 through kernel B3 (or as
fp32 through B1) and stage 2 streams G's row blocks through B2, on one card
or over several (the task farm of ``core/distributed.py``).  Either
route's stage 2 can run as the paper's polish ladder (``polish=True``), and
``grid_search`` / ``cross_validate`` select gamma and C by k-fold
cross-validation on one factor per gamma.  A ``Tracer`` (``fit(trace=)``,
``StreamConfig(trace=)`` or ``install``) records their timeline, with the
card's work as CUDA-event spans.
"""
from repro_torch.core import (LPDSVM, FitStats, GridResult, KernelParams,
                              LowRankFactor, PolishSchedule, PolishTrace,
                              SolverConfig, StreamConfig, TaskBatch,
                              build_cv_grid_tasks, compute_factor,
                              cross_validate, grid_search, make_schedule,
                              median_gamma, solve_batch, Tracer)

__all__ = ["LPDSVM", "FitStats", "GridResult", "KernelParams",
           "LowRankFactor", "PolishSchedule", "PolishTrace", "SolverConfig",
           "StreamConfig", "TaskBatch", "build_cv_grid_tasks",
           "compute_factor", "cross_validate", "grid_search", "make_schedule",
           "median_gamma", "solve_batch", "Tracer"]
