"""Polishing: coarse-to-fine warm-started stage-2 training, the paper
title's first ingredient (PyTorch port of ``repro.core.polish``).

Rather than cold-starting the full-data solve at the final tolerance, a
ladder of nested row-subsample problems (n/16 -> n/4 -> n by default) is
solved with per-level tolerance annealing, each level warm-starting the
next, so that the full-data pass starts near the optimum and is a short
polish.

Per level:

  * restriction: each task keeps a nested, class-stratified random prefix
    of its real (c > 0) rows, drawn by numpy from the schedule's seed, so
    the ladder's rows are the reference's bit for bit; the union of kept
    rows is gathered into a compact level factor ``G[union]``;
  * solve: a coarse level routes on its own working set
    (``should_stream_stage2``) to ``solve_batch`` (kernel B2) or
    ``solve_batch_streamed`` (B2's window form); the final level goes
    through the same ``route_stage2`` as an unpolished fit;
  * prolongation: the level's alphas are scattered back into each task's
    full index space; rows not yet seen keep their incoming warm start, so
    a warm start in ``tasks.alpha0`` seeds every level.

Where G lives decides where a level's factor goes.  A streamed factor's G
is a host tensor (pinned when the tasks are on the card): a coarse level
that routes monolithic moves its gathered rows to the tasks' device, and
one that routes streamed gathers them straight into pinned memory, since a
gather of a pinned tensor is pageable and the streamed solver refuses
pageable memory for the card.  The tasks' idx / y / c / alpha0 come to the
host once per solve and each level's alphas once per level; each level's
``TaskBatch`` is built on the tasks' device.

The ladder overrides the solver's full-pass cadence (period 1 on
monolithic levels, 5 on streamed ones), as the reference does: warm-started
levels converge in a few passes.  A tracer (``trace=``, else
``stream_config.trace``, else an installed one) records a ``polish`` /
``level_{i}`` span a level; it never changes a level's route.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import shards
from repro_torch.core.dual_solver import (SolveResult, SolverConfig, TaskBatch,
                                          duality_gap, solve_batch)
from repro_torch.core.solver_stream import (Stage2StreamStats, route_stage2,
                                            should_stream_stage2,
                                            solve_batch_streamed,
                                            solve_streamed_auto)
from repro_torch.core.streaming import StreamConfig, host_buffer, with_trace
from repro_torch.core.trace import resolve


@dataclasses.dataclass(frozen=True)
class PolishSchedule:
    """The coarse-to-fine ladder: ascending row fractions (last one must be
    1.0, the full-data polish pass) with per-level tolerance annealing
    (``tol * tol_factor``, final factor 1.0 = ``SolverConfig.tol``)."""

    fractions: Tuple[float, ...] = (1 / 16, 1 / 4, 1.0)
    tol_factors: Tuple[float, ...] = (16.0, 4.0, 1.0)
    min_rows: int = 64     # per-task floor: coarse levels never degenerate
    seed: int = 0          # row-priority RNG (nested prefixes)
    scale_C: bool = False  # True scales the coarse box by n/m (constant
                           # lambda = 1/(C n)); False keeps the paper's
                           # unnormalised C * sum(hinge) objective per level
    full_pass_period: Optional[int] = 1
                           # SolverConfig.full_pass_period of MONOLITHIC
                           # level solves (None = keep the config's)
    stream_full_pass_period: Optional[int] = 5
                           # the same for STREAMED level solves, where cheap
                           # epochs cut the bytes (None = keep the config's)

    def __post_init__(self):
        if len(self.fractions) != len(self.tol_factors):
            raise ValueError("fractions and tol_factors must align")
        if not self.fractions or abs(self.fractions[-1] - 1.0) > 1e-9:
            raise ValueError("last level must be the full data (fraction 1.0)")
        if any(f <= 0.0 or f > 1.0 for f in self.fractions):
            raise ValueError("fractions must lie in (0, 1]")
        if any(b <= a for a, b in zip(self.fractions, self.fractions[1:])):
            raise ValueError("fractions must be strictly ascending")
        if any(f < 1.0 for f in self.tol_factors):
            raise ValueError("tol_factors anneal TOWARD tol; need >= 1")

    @property
    def n_levels(self) -> int:
        return len(self.fractions)


def make_schedule(levels: int = 3, ratio: float = 4.0, tol_growth: float = 4.0,
                  min_rows: int = 64, seed: int = 0,
                  scale_C: bool = False,
                  full_pass_period: Optional[int] = 1,
                  stream_full_pass_period: Optional[int] = 5) -> PolishSchedule:
    """Geometric ladder: fractions ratio^-(L-1) ... 1, tols tol*growth^(L-1)
    ... tol (levels=3, ratio=4 -> n/16 -> n/4 -> n)."""
    if levels < 1:
        raise ValueError("need at least one level")
    fr = tuple(float(ratio) ** -(levels - 1 - l) for l in range(levels))
    tf = tuple(float(tol_growth) ** (levels - 1 - l) for l in range(levels))
    return PolishSchedule(fractions=fr, tol_factors=tf, min_rows=min_rows,
                          seed=seed, scale_C=scale_C,
                          full_pass_period=full_pass_period,
                          stream_full_pass_period=stream_full_pass_period)


@dataclasses.dataclass
class PolishLevelStats:
    """Convergence and work accounting of one ladder level."""

    fraction: float
    tol: float
    n_rows: int                   # union of task rows gathered at this level
    n_pad: int
    streamed: bool
    epochs: np.ndarray            # (T,)
    violations: np.ndarray        # (T,)
    duality_gap: np.ndarray       # (T,) nan when gap_trace=False
    row_visits: int               # coordinate visits charged to this level
    seconds: float
    stream_stats: Optional[Stage2StreamStats] = None


@dataclasses.dataclass
class PolishTrace:
    """Per-level trajectory of one polished solve (``FitStats.polish_trace``)."""

    levels: List[PolishLevelStats] = dataclasses.field(default_factory=list)

    @property
    def total_row_visits(self) -> int:
        return sum(l.row_visits for l in self.levels)

    @property
    def total_seconds(self) -> float:
        return sum(l.seconds for l in self.levels)

    @property
    def final(self) -> PolishLevelStats:
        return self.levels[-1]


def task_duality_gap(rows, y, c, alpha) -> float:
    """Duality gap of one task from its gathered G rows, in host numpy (so a
    streamed host G never goes to the card for it); mirrors
    ``dual_solver.duality_gap``."""
    rows = np.asarray(rows, np.float32)
    y = np.asarray(y, np.float32)
    c = np.asarray(c, np.float32)
    alpha = np.asarray(alpha, np.float32)
    w = (alpha * y) @ rows
    real = c > 0.0
    C = float(c.max()) if real.any() else 1.0
    margins = y * (rows @ w)
    hinge = np.where(real, np.maximum(0.0, 1.0 - margins), 0.0)
    p = 0.5 * float(w @ w) + C * float(hinge.sum())
    d = float(alpha.sum()) - 0.5 * float(w @ w)
    return p - d


def _level_positions(idx: np.ndarray, y: np.ndarray, c: np.ndarray,
                     schedule: PolishSchedule, n_rows: int) -> List[List[np.ndarray]]:
    """Per (level, task): positions into the padded task layout, sorted by
    global row index.  A class-stratified random prefix under a fixed
    per-row priority, so levels are nested (coarse rows never leave) and
    idx stays sorted, as the streamed solver wants."""
    T = idx.shape[0]
    prio = np.random.default_rng(schedule.seed).random(n_rows)
    floor_p = schedule.min_rows // 2
    floor_n = schedule.min_rows - floor_p
    sel: List[List[np.ndarray]] = [[None] * T for _ in schedule.fractions]
    for t in range(T):
        real_pos = np.where(c[t] > 0.0)[0]
        rt = idx[t][real_pos]
        yt = y[t][real_pos]
        pr = prio[rt]
        pos_p = np.where(yt > 0)[0]
        pos_n = np.where(yt <= 0)[0]
        ord_p = pos_p[np.argsort(pr[pos_p], kind="stable")]
        ord_n = pos_n[np.argsort(pr[pos_n], kind="stable")]
        for li, f in enumerate(schedule.fractions):
            if f >= 1.0:
                sl = np.arange(len(real_pos))
            else:
                kp = min(len(ord_p), max(math.ceil(f * len(ord_p)), floor_p))
                kn = min(len(ord_n), max(math.ceil(f * len(ord_n)), floor_n))
                sl = np.sort(np.concatenate([ord_p[:kp], ord_n[:kn]]))
            sel[li][t] = real_pos[sl]
    return sel


def _route_level(n_rows: int, rank: int, n_tasks: int, n_pad: int,
                 stream, stream_config: Optional[StreamConfig],
                 solve_fn: Callable) -> bool:
    """Routing of a coarse level: the gathered sub-factor is its own
    problem, so only its own working set decides (a forced ``stream=True``
    streams the final level, through ``route_stage2``, but not the small
    gathered levels)."""
    if solve_fn is not solve_batch or stream is False or stream_config is None:
        return False
    return should_stream_stage2(n_rows, rank, n_tasks, n_pad, stream_config)


def _gather(G, union: np.ndarray, pinned_for) -> torch.Tensor:
    """G[union]: on G's device, or for a host G (a spilled one's shards
    included) straight into a host buffer (pinned when ``pinned_for`` is a
    CUDA device, for the streamed solver)."""
    if G.device.type != "cpu":
        return G.index_select(0, torch.from_numpy(union.astype(np.int64)).to(G.device))
    out = host_buffer((len(union), G.shape[1]), torch.float32, pinned_for or "cpu")
    return shards.gather_into(G, union, out)


def solve_polished(
    factor,
    tasks: TaskBatch,
    config: SolverConfig = SolverConfig(),
    schedule: Optional[PolishSchedule] = None,
    *,
    stream=None,
    stream_config: Optional[StreamConfig] = None,
    solve_fn: Callable = solve_batch,
    gap_trace: bool = True,
    return_trace: bool = False,
    trace=None,
):
    """Coarse-to-fine warm-started drop-in for the routed stage-2 solve.

    Solves the schedule's nested subsample ladder, prolongating each level's
    alpha into the next, and returns the final level's ``SolveResult``
    (laid out as ``solve_batch(factor.G, tasks, config)``'s, on the tasks'
    device), plus a ``PolishTrace`` with ``return_trace=True``.  Incoming
    ``tasks.alpha0`` seeds every level's not-yet-solved rows."""
    # ``trace`` observes only: routing keys off ``stream_config``, and the
    # streamed solves get a copy of it that carries the tracer
    tr = resolve(trace if trace is not None
                 else getattr(stream_config, "trace", None))
    run_cfg = with_trace(stream_config, trace)
    # checkpoints are the final level's: a coarse level is re-solved from
    # the same warm start in a resumed run, and its own snapshots would
    # stand in the final level's directory
    coarse_cfg = run_cfg
    if getattr(run_cfg, "checkpoint_dir", None):
        coarse_cfg = dataclasses.replace(run_cfg, checkpoint_dir=None,
                                         checkpoint_every=0, resume=False)
    if schedule is None:
        schedule = PolishSchedule()
    G = factor.G
    n, rank = int(G.shape[0]), int(G.shape[1])
    dev = tasks.idx.device
    host_G = G.device.type == "cpu"
    # the task tables on the host, once per solve
    idx = tasks.idx.cpu().numpy()
    y_loc = tasks.y.cpu().numpy().astype(np.float32)
    c_loc = tasks.c.cpu().numpy().astype(np.float32)
    T, n_pad = idx.shape
    af = np.clip(tasks.alpha0.cpu().numpy().astype(np.float32), 0.0, c_loc)

    sel = _level_positions(idx, y_loc, c_loc, schedule, n)
    # drop redundant coarse levels (min_rows flooring can make a level equal
    # its successor; nested prefixes, so equal sizes mean equal sets)
    keep = [li for li in range(schedule.n_levels - 1)
            if any(len(sel[li][t]) < len(sel[li + 1][t]) for t in range(T))]
    keep.append(schedule.n_levels - 1)

    ptrace = PolishTrace()
    res: Optional[SolveResult] = None

    def level_config(li: int, streamed: bool) -> SolverConfig:
        period = (schedule.stream_full_pass_period if streamed
                  else schedule.full_pass_period) or config.full_pass_period
        return dataclasses.replace(
            config, tol=float(config.tol * schedule.tol_factors[li]),
            full_pass_period=period)

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=dev)

    for li in keep:
        frac = schedule.fractions[li]
        final = frac >= 1.0
        t0 = tr.begin()
        sstats = None
        pos_l = sel[li]
        if final:
            tasks_l = TaskBatch(idx=tasks.idx, y=tasks.y, c=tasks.c,
                                alpha0=on_device(np.clip(af, 0.0, c_loc)))
            streamed = route_stage2(factor, tasks_l, stream, stream_config,
                                    solve_fn, solve_batch)
            cfg_l = level_config(li, streamed)
            if streamed:
                res, sstats = solve_streamed_auto(
                    G, tasks_l, cfg_l, stream_config=run_cfg,
                    return_stats=True)
            else:
                res = solve_fn(G.to(dev) if host_G else G, tasks_l, cfg_l)
            res_l, n_pad_l, n_rows_l = res, n_pad, n
            a_np = res.alpha.cpu().numpy()
            af = a_np
            level_G = G
        else:
            n_pad_l = max(8, -(-max(len(p) for p in pos_l) // 8) * 8)
            union = np.unique(np.concatenate(
                [idx[t][p] for t, p in enumerate(pos_l)]))
            n_rows_l = len(union)
            idx_l = np.zeros((T, n_pad_l), np.int32)
            y_l = np.ones((T, n_pad_l), np.float32)
            c_l = np.zeros((T, n_pad_l), np.float32)
            a_l = np.zeros((T, n_pad_l), np.float32)
            for t, p in enumerate(pos_l):
                k = len(p)
                m_full = int(np.sum(c_loc[t] > 0.0))
                scale = (m_full / max(k, 1)) if schedule.scale_C else 1.0
                idx_l[t, :k] = np.searchsorted(union, idx[t][p])
                y_l[t, :k] = y_loc[t][p]
                c_l[t, :k] = c_loc[t][p] * scale
                a_l[t, :k] = np.clip(af[t][p], 0.0, c_l[t, :k])
            tasks_l = TaskBatch(idx=on_device(idx_l), y=on_device(y_l),
                                c=on_device(c_l), alpha0=on_device(a_l))
            streamed = _route_level(n_rows_l, rank, T, n_pad_l, stream,
                                    stream_config, solve_fn)
            cfg_l = level_config(li, streamed)
            level_G = _gather(G, union, dev if streamed else None)
            if streamed:
                res_l, sstats = solve_batch_streamed(
                    level_G, tasks_l, cfg_l, stream_config=coarse_cfg,
                    return_stats=True)
            else:
                res_l = solve_fn(level_G.to(dev), tasks_l, cfg_l)
            # prolongation: solved rows overwrite (raw, in the level's scaled
            # box; each use site clips into its own box); unseen rows keep
            # their incoming warm start
            a_np = res_l.alpha.cpu().numpy()
            for t, p in enumerate(pos_l):
                af[t][p] = a_np[t][: len(p)]

        epochs_l = res_l.epochs.cpu().numpy()
        visits = (sstats.coord_visits if sstats is not None
                  else int(epochs_l.sum()) * n_pad_l)
        gaps = np.full((T,), np.nan, np.float32)
        if gap_trace and final and not host_G:
            # a device-resident G: the gap on the device, scalars back,
            # rather than the whole (n, B') factor to the host
            for t in range(T):
                gaps[t] = float(duality_gap(G, tasks.idx[t], tasks.y[t],
                                            tasks.c[t], res_l.alpha[t]))
        elif gap_trace:
            # host numpy: coarse levels on the small gathered factor; a final
            # level on a host G reads it where it lies (a spilled G's rows
            # from its shards)
            G_np = shards.numpy_rows(level_G)
            for t, p in enumerate(pos_l):
                k = len(p)
                if final:
                    gaps[t] = task_duality_gap(G_np[idx[t][p]], y_loc[t][p],
                                               c_loc[t][p], a_np[t][p])
                else:
                    # the level's own problem (scaled box): what the
                    # tolerance annealing drives toward zero
                    gaps[t] = task_duality_gap(G_np[idx_l[t, :k]], y_l[t, :k],
                                               c_l[t, :k], a_np[t][:k])
        violations = res_l.violation.cpu().numpy()
        dt = tr.end("polish", f"level_{li}", t0, fraction=float(frac),
                    tol=float(cfg_l.tol), rows=n_rows_l, streamed=streamed,
                    row_visits=visits)
        ptrace.levels.append(PolishLevelStats(
            fraction=frac, tol=cfg_l.tol, n_rows=n_rows_l, n_pad=n_pad_l,
            streamed=streamed, epochs=epochs_l, violations=violations,
            duality_gap=gaps, row_visits=visits, seconds=dt,
            stream_stats=sstats))

    return (res, ptrace) if return_trace else res


__all__ = ["PolishLevelStats", "PolishSchedule", "PolishTrace",
           "make_schedule", "solve_polished", "task_duality_gap"]
