"""LPD-SVM core, PyTorch port: the monolithic and the out-of-core (streamed)
fit -> predict routes, the polish ladder over stage 2, cross-validation and
grid search over them, the disk tier below host RAM (the checksummed shard
store), and the tracer that records their timeline."""
from repro_torch.core.cv import (CellStats, GridResult, build_cv_grid_tasks,
                                 build_cv_tasks, cross_validate, grid_search,
                                 kfold_masks)
from repro_torch.core.dual_solver import (SolveResult, SolverConfig, TaskBatch,
                                          dual_objective, duality_gap,
                                          primal_objective, solve_batch,
                                          solve_one)
from repro_torch.core.kernel_fn import (KernelParams, apply_epilogue, gram,
                                        kernel_diag, median_gamma)
from repro_torch.core.nystrom import (LowRankFactor, compute_factor,
                                      landmark_rows, select_landmarks)
from repro_torch.core.ovo import (build_ovo_tasks, class_pairs,
                                  ovo_decision_values, ovo_vote)
from repro_torch.core.polish import (PolishSchedule, PolishTrace,
                                     make_schedule, solve_polished)
from repro_torch.core.quant import (GROUP_ROWS, QuantBlock, dequant_rows,
                                    dequantize_rows, quantize_block,
                                    quantize_rows)
from repro_torch.core.shards import (GShardView, ShardCorruptionError, ShardError,
                                     ShardSpillSink, ShardStore, ShardStoreStats,
                                     ShardWriter, ingest_libsvm_shards,
                                     open_or_ingest)
from repro_torch.core.solver_stream import (Stage2StreamStats, auto_tile_rows,
                                            route_stage2, should_stream_stage2,
                                            solve_batch_streamed,
                                            solve_streamed_auto, wire_group)
from repro_torch.core.streaming import (Stage1StreamStats, StreamConfig,
                                        auto_chunk_rows,
                                        compute_factor_streamed,
                                        compute_factor_streamed_csr,
                                        compute_factor_streamed_shards, host_buffer,
                                        should_stream, stream_factor_blocks,
                                        stream_factor_rows)
from repro_torch.core.svm import LPDSVM, FitStats
from repro_torch.core.trace import (NULL, NullTracer, ProgressPrinter, Tracer,
                                    install, uninstall)
from repro_torch.core.trace import active as active_tracer
from repro_torch.core.trace import resolve as resolve_tracer

__all__ = [
    "CellStats", "GridResult", "build_cv_grid_tasks", "build_cv_tasks",
    "cross_validate", "grid_search", "kfold_masks",
    "SolveResult", "SolverConfig", "TaskBatch", "dual_objective",
    "duality_gap", "primal_objective", "solve_batch", "solve_one",
    "KernelParams", "apply_epilogue", "gram", "kernel_diag", "median_gamma",
    "LowRankFactor", "compute_factor", "landmark_rows", "select_landmarks",
    "build_ovo_tasks", "class_pairs", "ovo_decision_values", "ovo_vote",
    "PolishSchedule", "PolishTrace", "make_schedule", "solve_polished",
    "GROUP_ROWS", "QuantBlock", "dequant_rows", "dequantize_rows",
    "quantize_block", "quantize_rows",
    "GShardView", "ShardCorruptionError", "ShardError", "ShardSpillSink",
    "ShardStore", "ShardStoreStats", "ShardWriter", "ingest_libsvm_shards",
    "open_or_ingest",
    "Stage2StreamStats", "auto_tile_rows", "route_stage2",
    "should_stream_stage2", "solve_batch_streamed", "solve_streamed_auto",
    "wire_group",
    "Stage1StreamStats", "StreamConfig", "auto_chunk_rows",
    "compute_factor_streamed", "compute_factor_streamed_csr",
    "compute_factor_streamed_shards", "host_buffer", "should_stream",
    "stream_factor_blocks", "stream_factor_rows",
    "LPDSVM", "FitStats",
    "NULL", "NullTracer", "ProgressPrinter", "Tracer", "install", "uninstall",
    "active_tracer", "resolve_tracer",
]
