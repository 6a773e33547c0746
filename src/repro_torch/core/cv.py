"""Cross-validation, grid search and warm starts (paper sec. 4, Table 3):
PyTorch port of ``repro.core.cv``.

The paper's point: parameter tuning is where the two-stage design pays off.
The factor G depends only on the kernel (gamma), not on C or the fold split,
so one stage-1 run serves folds x C-grid x OVO-pairs solves; and an
ascending C grid warm-starts each C from the C before it (alphas clipped
into the new box).

All (fold x pair) tasks of one (gamma, C) cell are solved as one
``TaskBatch`` of T = folds x pairs tasks, fold-major, so one launch of kernel
B2 runs an epoch of every live task of the cell.  The cell's stage 2 is
routed as ``LPDSVM``'s (``_solve_routed``): the polish ladder, the streamed
row-block solver, or ``solve_fn`` on G on the device.  Where the cells
would stream, the grid task farm puts every (C, fold, pair) cell of a gamma
in one streamed ``TaskBatch``, the C ladder chained inside the solver.
Validation errors come from rows of G, never from new kernel evaluations.

Differences from the reference:

  * ``device=None`` means the card, as for ``LPDSVM``; ``device="cpu"`` runs
    the kernels' plain versions.  ``seed`` draws the landmarks from a
    ``torch.Generator`` (``nystrom.landmark_rows``), not ``jax.random``.
  * Stage 1 and each cell are timed after a device synchronisation, as
    the reference's spans ``cv`` / ``stage1_factor``, ``grid_cell`` and
    ``grid_farm`` (``stream_config.trace``, else an installed tracer).
  * Validation decisions are summed in fp64 where the fold's rows of G lie:
    on the card for a device G, on the host for a host (streamed) G, which
    never goes to the card whole.  The two routes then vote alike on the
    same G and W.
  * The grid task farm runs through kernel B2's window form
    (``solve_streamed_auto(..., chain_next=...)``): on one card, or on a
    host with more cards over the multi-device farm of
    ``core/distributed.py``, each C ladder whole on one worker
    (``balance_chain_split``).  Beside the reference's per-gamma ``stream_stats``,
    ``GridResult.cells`` holds one ``CellStats`` a C of a farmed gamma.
  * Each gamma has a checkpoint directory and a shard directory of its own
    (``<dir>/gamma{gi}``), as in the reference, and each serial cell a
    checkpoint directory ``c{ci}`` under its gamma's.  A spilled G
    (``StreamConfig.spill_g``) serves the grid task farm and the serial
    cells from its shards, and the folds' validation rows are read from
    them a block at a time (``ovo.factor_decisions``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dual_solver import SolverConfig, TaskBatch, solve_batch
from repro_torch.core.kernel_fn import KernelParams, gram
from repro_torch.core.nystrom import LowRankFactor, compute_factor
from repro_torch.core.ovo import class_pairs, factor_decisions, ovo_arrays, ovo_vote
from repro_torch.core.polish import PolishSchedule, make_schedule, solve_polished
from repro_torch.core.solver_stream import (Stage2StreamStats, route_stage2,
                                            solve_streamed_auto)
from repro_torch.core.streaming import StreamConfig
from repro_torch.core.svm import resolve_device
from repro_torch.core.trace import resolve


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _solve_routed(factor: LowRankFactor, tasks: TaskBatch,
                  config: SolverConfig, solve_fn: Callable,
                  stream, stream_config: Optional[StreamConfig],
                  polish_schedule: Optional[PolishSchedule] = None):
    """Stage-2 dispatch of one cell (``solver_stream.route_stage2``, shared
    with ``LPDSVM._solve_stage2``); with a ``polish_schedule`` the cell runs
    the coarse-to-fine ladder, composing with the C-grid warm start carried
    in ``tasks.alpha0``.  A host G that is not to stream goes to the device
    whole.  Returns the ``SolveResult`` and, where the cell (or the ladder's
    final level) streamed, its ``Stage2StreamStats``, else None."""
    if polish_schedule is not None:
        res, ptrace = solve_polished(factor, tasks, config, polish_schedule,
                                     stream=stream, stream_config=stream_config,
                                     solve_fn=solve_fn, gap_trace=False,
                                     return_trace=True)
        return res, ptrace.final.stream_stats
    if route_stage2(factor, tasks, stream, stream_config, solve_fn,
                    solve_batch):
        return solve_streamed_auto(factor.G, tasks, config,
                                   stream_config=stream_config,
                                   return_stats=True)
    return solve_fn(factor.G.to(tasks.idx.device), tasks, config), None


def kfold_masks(n: int, k: int, seed: int = 0) -> List[np.ndarray]:
    """Return k boolean validation masks partitioning range(n)."""
    perm = np.random.default_rng(seed).permutation(n)
    masks = []
    for f in range(k):
        m = np.zeros(n, dtype=bool)
        m[perm[f::k]] = True
        masks.append(m)
    return masks


def _cv_n_pad(labels: np.ndarray, n_classes: int) -> int:
    """Every fold's tasks are padded to the two largest classes' rows (of
    all rows), rounded up to 8, so that the folds stack."""
    counts = np.bincount(labels, minlength=n_classes)
    top2 = np.sort(counts)[-2:].sum()
    return -(-int(top2) // 8) * 8


def _cv_cells(labels: np.ndarray, n_classes: int,
              val_masks: Sequence[np.ndarray], n_pad: Optional[int], device):
    """The fold-major layout every cell of a grid shares: the OVO tasks of
    each training fold (``~val_mask``), stacked on the host and put on
    ``device`` once.  Returns ``cell(C, warm=None) -> TaskBatch``, which
    sets the box to C and the warm start (clipped into [0, C] on the
    device), and the pairs."""
    if n_pad is None:
        n_pad = _cv_n_pad(labels, n_classes)
    folds = [ovo_arrays(labels, n_classes, 1.0, include_mask=~vm, n_pad=n_pad)
             for vm in val_masks]
    pairs = folds[-1][1] if folds else None
    idx, y, c = (torch.as_tensor(np.concatenate([f[0][k] for f in folds]),
                                 device=device) for k in range(3))
    real = c > 0.0

    def cell(C: float, warm=None) -> TaskBatch:
        box = torch.zeros_like(y).masked_fill_(real, float(C))
        alpha0 = (torch.zeros_like(y) if warm is None else
                  torch.as_tensor(warm, dtype=torch.float32, device=device)
                  .clamp(0.0, float(C)))
        return TaskBatch(idx=idx, y=y, c=box, alpha0=alpha0)

    return cell, pairs


def build_cv_tasks(
    labels: np.ndarray,
    n_classes: int,
    C: float,
    val_masks: Sequence[np.ndarray],
    *,
    n_pad: Optional[int] = None,
    warm=None,
    device=None,
) -> Tuple[TaskBatch, list]:
    """Stack OVO tasks for every fold into one batch of T = folds * pairs on
    ``device`` (default the card).

    Task layout: fold-major (fold f, pair t) -> row f * n_pairs + t, so a warm
    start from a previous C value can be passed straight through as `warm`.
    """
    cell, pairs = _cv_cells(labels, n_classes, val_masks, n_pad,
                            resolve_device(device))
    return cell(C, warm), pairs


def _fold_val_sets(factor: LowRankFactor, labels: np.ndarray,
                   val_masks: Sequence[np.ndarray]) -> List[tuple]:
    """Per-fold validation sets, once per gamma: (G, the fold's rows, their
    labels).  The rows are read where G lies at scoring time (a host G on
    the host, a spilled G from its shards)."""
    return [(factor.G, np.where(vm)[0], labels[vm]) for vm in val_masks]


def _cv_error_from(val_sets: Sequence[tuple], n_classes: int, W) -> float:
    """Validation error of one (gamma, C) cell from the fold sets; the
    decisions are summed in fp64 (``ovo.factor_decisions``)."""
    pairs = class_pairs(n_classes)
    n_pairs = len(pairs)
    wrong = 0
    total = 0
    for f, (G, rows, yv) in enumerate(val_sets):
        dec = factor_decisions(G, W[f * n_pairs:(f + 1) * n_pairs], rows=rows)
        pred = (ovo_vote(dec, pairs, n_classes) if n_pairs > 1
                else np.where(dec[:, 0] > 0, 0, 1))
        wrong += int(np.sum(pred != yv))
        total += len(yv)
    return wrong / max(total, 1)


def _cv_error(factor: LowRankFactor, labels: np.ndarray, n_classes: int,
              W, val_masks: Sequence[np.ndarray]) -> float:
    """Validation error using precomputed G rows as features (no kernel evals)."""
    return _cv_error_from(_fold_val_sets(factor, labels, val_masks),
                          n_classes, W)


def build_cv_grid_tasks(
    labels: np.ndarray,
    n_classes: int,
    Cs: Sequence[float],
    val_masks: Sequence[np.ndarray],
    *,
    n_pad: Optional[int] = None,
    warm=None,
    ladder: bool = True,
    device=None,
) -> Tuple[TaskBatch, list, Optional[np.ndarray]]:
    """One TaskBatch carrying EVERY (C, fold, pair) cell of a gamma: the
    grid task farm's layout.

    Level-major layout on top of `build_cv_tasks`' fold-major one: cell
    (ci, f, t) is task  u = ci * folds * n_pairs + f * n_pairs + t,  so
    slicing ``ci * FP:(ci + 1) * FP`` (FP = folds * n_pairs) recovers one
    C value's batch in exactly the per-cell layout.

    ``Cs`` must be ascending.  With ``ladder=True`` the returned
    ``chain_next`` declares each cell the warm-start predecessor of the same
    (fold, pair) cell at the next C.  ``warm`` seeds level 0 (cross-gamma
    warm start), clipped into the first C box.
    """
    Cs = [float(C) for C in Cs]
    if sorted(Cs) != Cs:
        raise ValueError("build_cv_grid_tasks requires ascending Cs")
    cell, pairs = _cv_cells(labels, n_classes, val_masks, n_pad,
                            resolve_device(device))
    tasks, chain = _grid_batch(cell, Cs, len(val_masks) * len(pairs), warm,
                               ladder)
    return tasks, pairs, chain


def _grid_batch(cell, Cs: Sequence[float], FP: int, warm, ladder: bool):
    """The level-major grid batch of ``_cv_cells``' ``cell`` over the
    ascending ``Cs`` (``warm`` seeds level 0) and the C ladder's
    ``chain_next`` (None without a ladder or with one C)."""
    levels = [cell(C, warm if ci == 0 else None) for ci, C in enumerate(Cs)]
    tasks = TaskBatch(*(torch.cat([getattr(b, k) for b in levels])
                        for k in TaskBatch._fields))
    chain = None
    if ladder and len(Cs) > 1:
        chain = np.full((len(Cs) * FP,), -1, np.int64)
        chain[:(len(Cs) - 1) * FP] = np.arange((len(Cs) - 1) * FP) + FP
    return tasks, chain


@dataclasses.dataclass
class CellStats:
    """One (gamma, C) cell of the serial grid (the port's record)."""

    gamma: float
    C: float
    n_tasks: int                  # folds x pairs
    n_pad: int
    epochs: np.ndarray            # (T,) epochs each task was live
    seconds: float                # the cell's stage 2, synchronised (farm:
    #                               the gamma's over its Cs)
    error: float                  # its CV error
    stream_stats: Optional[Stage2StreamStats] = None
    # ^ set where the cell streamed alone; None on the farm, whose record of
    #   the whole gamma is GridResult.stream_stats[gi]


@dataclasses.dataclass
class GridResult:
    errors: np.ndarray            # (n_gamma, n_C) CV error
    best_gamma: float
    best_C: float
    best_error: float
    stage1_seconds: float
    stage2_seconds: float
    n_binary_solved: int
    per_cell_seconds: np.ndarray  # (n_gamma, n_C)
    stream_stats: Optional[list] = None
    # ^ farm: one Stage2StreamStats a gamma (None for a gamma the serial loop
    #   ran); None where no gamma was farmed
    bytes_h2d: Optional[np.ndarray] = None   # (n_gamma,) the farm's H2D bytes
    cells: List[CellStats] = dataclasses.field(default_factory=list)
    # ^ the port's: every cell in the order solved (gamma-major, C ascending)


def grid_search(
    x: np.ndarray,
    y: np.ndarray,
    gammas: Sequence[float],
    Cs: Sequence[float],
    *,
    budget: int = 500,
    folds: int = 5,
    kernel_kind: str = "rbf",
    config: SolverConfig = SolverConfig(),
    seed: int = 0,
    gram_fn: Callable = gram,
    solve_fn: Callable = solve_batch,
    warm_start: bool = True,
    warm_start_gamma: bool = False,
    stream: Optional[bool] = None,
    stream_config: Optional[StreamConfig] = None,
    polish: bool = False,
    polish_levels: int = 3,
    polish_schedule: Optional[PolishSchedule] = None,
    farm: Optional[bool] = None,
    device=None,
) -> GridResult:
    """Full grid search with k-fold CV, G reuse per gamma, warm starts over C.

    Cs are solved in ascending order so each cell warm-starts from its
    predecessor (alphas clipped into the new box); the first best cell in
    that order wins ties.

    ``farm`` selects the grid task farm: every (C, fold, pair) cell of a
    gamma rides one streamed ``TaskBatch`` (``build_cv_grid_tasks``) with
    the C ladder run inside the solver (``chain_next``), so each G block
    updates every live cell of the grid.  ``None`` farms where the cells
    would stream anyway (``route_stage2`` on the grid batch), ``True``
    forces it, ``False`` pins the per-cell serial loop; a polish ladder or
    a single C always runs the serial loop.  Without ``warm_start`` the
    farm's cells run side by side, each from zero.

    ``warm_start_gamma`` (beyond-paper): also seed the first C of each new
    gamma from the previous gamma's alphas at the same C.

    ``polish`` runs every cell through the coarse-to-fine ladder
    (`core/polish.py`); it composes with both warm-start axes.
    """
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    classes, labels = np.unique(np.asarray(y), return_inverse=True)
    n_classes = len(classes)
    val_masks = kfold_masks(x.shape[0], folds, seed)
    Cs = sorted(float(c) for c in Cs)
    if polish and polish_schedule is None:
        polish_schedule = make_schedule(levels=polish_levels)
    cell_tasks, pairs = _cv_cells(labels, n_classes, val_masks, None, dev)
    FP = folds * len(pairs)

    errors = np.zeros((len(gammas), len(Cs)))
    cell_sec = np.zeros_like(errors)
    t_stage1 = 0.0
    t_stage2 = 0.0
    n_solved = 0
    best = (np.inf, None, None)
    cells: List[CellStats] = []
    gamma_stats: List[Optional[Stage2StreamStats]] = [None] * len(gammas)
    gamma_bytes = np.zeros((len(gammas),), np.int64)

    tr = resolve(getattr(stream_config, "trace", None))
    warm_first_c = None       # cross-gamma seed (beyond-paper)
    for gi, gamma in enumerate(gammas):
        kp = KernelParams(kind=kernel_kind, gamma=float(gamma))
        # each gamma is its own resumable unit (G and the solver state both
        # depend on it), as in the reference: checkpoints and a spilled G's
        # shards under gamma{gi}/
        g_cfg = stream_config
        ck = getattr(stream_config, "checkpoint_dir", None)
        sd = getattr(stream_config, "shard_dir", None)
        if ck or sd:
            g_cfg = dataclasses.replace(
                stream_config,
                checkpoint_dir=os.path.join(ck, f"gamma{gi}") if ck else None,
                shard_dir=os.path.join(sd, f"gamma{gi}") if sd else None)
        t0 = tr.begin()
        factor = compute_factor(x, kp, budget, seed=seed, gram_fn=gram_fn,
                                device=dev, stream=stream,
                                stream_config=g_cfg)
        _sync(dev)
        t_stage1 += tr.end("cv", "stage1_factor", t0, gamma=float(gamma))

        warm = warm_first_c if warm_start_gamma else None
        val_sets = _fold_val_sets(factor, labels, val_masks)
        use_farm = False
        if farm is not False and polish_schedule is None and len(Cs) > 1:
            gtasks, chain = _grid_batch(cell_tasks, Cs, FP,
                                        warm if warm_start else None, warm_start)
            use_farm = farm is True or route_stage2(
                factor, gtasks, stream, stream_config, solve_fn, solve_batch)
            if not use_farm:
                del gtasks
        if use_farm:
            # one streamed solve trains every cell of this gamma; the ladder
            # runs inside it, so the epoch budget covers the whole ladder
            # (the + 1 a level pays each seeded cell's w0 pass)
            t0 = tr.begin()
            farm_cfg = dataclasses.replace(
                config, max_epochs=config.max_epochs * len(Cs) + len(Cs))
            res, sstats = solve_streamed_auto(
                factor.G, gtasks, farm_cfg, stream_config=g_cfg,
                chain_next=chain, return_stats=True)
            _sync(dev)
            dt = tr.end("cv", "grid_farm", t0, gamma=float(gamma),
                        cells=gtasks.n_tasks)
            t_stage2 += dt
            cell_sec[gi, :] = dt / len(Cs)
            n_solved += gtasks.n_tasks
            gamma_stats[gi] = sstats
            gamma_bytes[gi] = sstats.bytes_h2d
            epochs = res.epochs.cpu().numpy()
            for ci, C in enumerate(Cs):
                err = _cv_error_from(val_sets, n_classes,
                                     res.w[ci * FP:(ci + 1) * FP])
                errors[gi, ci] = err
                cells.append(CellStats(
                    gamma=float(gamma), C=C, n_tasks=FP,
                    n_pad=int(gtasks.idx.shape[1]),
                    epochs=epochs[ci * FP:(ci + 1) * FP], seconds=dt / len(Cs),
                    error=err))
                if err < best[0]:
                    best = (err, float(gamma), C)
            warm_first_c = res.alpha[:FP]
            del val_sets, factor, gtasks, res
            continue

        for ci, C in enumerate(Cs):
            t0 = tr.begin()
            tasks = cell_tasks(C, warm if warm_start else None)
            c_cfg = g_cfg             # and each serial cell under c{ci}/
            if getattr(g_cfg, "checkpoint_dir", None):
                c_cfg = dataclasses.replace(g_cfg, checkpoint_dir=os.path.join(
                    g_cfg.checkpoint_dir, f"c{ci}"))
            res, sstats = _solve_routed(factor, tasks, config, solve_fn,
                                        stream, c_cfg, polish_schedule)
            _sync(dev)
            dt = tr.end("cv", "grid_cell", t0, gamma=float(gamma), C=float(C))
            t_stage2 += dt
            cell_sec[gi, ci] = dt
            n_solved += tasks.n_tasks
            warm = res.alpha
            if ci == 0:
                warm_first_c = res.alpha
            err = _cv_error_from(val_sets, n_classes, res.w)
            errors[gi, ci] = err
            cells.append(CellStats(
                gamma=float(gamma), C=C, n_tasks=tasks.n_tasks,
                n_pad=int(tasks.idx.shape[1]), epochs=res.epochs.cpu().numpy(),
                seconds=dt, error=err, stream_stats=sstats))
            if err < best[0]:
                best = (err, float(gamma), C)
        del val_sets, factor

    farmed = any(s is not None for s in gamma_stats)
    return GridResult(
        errors=errors, best_gamma=best[1], best_C=best[2], best_error=best[0],
        stage1_seconds=t_stage1, stage2_seconds=t_stage2,
        n_binary_solved=n_solved, per_cell_seconds=cell_sec,
        stream_stats=gamma_stats if farmed else None,
        bytes_h2d=gamma_bytes if farmed else None, cells=cells)


def cross_validate(
    x: np.ndarray, y: np.ndarray, kernel: KernelParams, C: float, *,
    budget: int = 500, folds: int = 5, config: SolverConfig = SolverConfig(),
    seed: int = 0, gram_fn: Callable = gram, solve_fn: Callable = solve_batch,
    factor: Optional[LowRankFactor] = None,
    stream: Optional[bool] = None,
    stream_config: Optional[StreamConfig] = None,
    polish_schedule: Optional[PolishSchedule] = None,
    device=None,
) -> Tuple[float, LowRankFactor]:
    """k-fold CV error for one (kernel, C); returns (error, reusable factor).
    The tasks lie on ``device`` (default the card); a given ``factor`` is
    used where its G lies, as ``LPDSVM.fit`` uses it."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    _, labels = np.unique(np.asarray(y), return_inverse=True)
    n_classes = int(labels.max()) + 1
    if factor is None:
        factor = compute_factor(x, kernel, budget, seed=seed, gram_fn=gram_fn,
                                device=dev, stream=stream,
                                stream_config=stream_config)
    val_masks = kfold_masks(x.shape[0], folds, seed)
    tasks, _ = build_cv_tasks(labels, n_classes, float(C), val_masks, device=dev)
    res, _ = _solve_routed(factor, tasks, config, solve_fn, stream,
                           stream_config, polish_schedule)
    err = _cv_error(factor, labels, n_classes, res.w, val_masks)
    return err, factor


__all__ = ["CellStats", "GridResult", "build_cv_grid_tasks", "build_cv_tasks",
           "cross_validate", "grid_search", "kfold_masks"]
