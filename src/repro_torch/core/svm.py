"""Public LPD-SVM estimator (PyTorch port of the monolithic route of
``repro.core.svm``): the paper's two-stage algorithm behind one API.

    svm = LPDSVM(kernel=KernelParams("rbf", gamma=2**-7), C=2**5, budget=1000)
    svm.fit(x, y)           # stage 1 (factor G) + stage 2 (dual CA, OVO)
    svm.predict(x_test)

It runs on the card (``device=None`` means ``"cuda"``) through kernels B1
(gram) and B2 (SMO epoch), and raises where there is no card, unless the
caller asks for ``device="cpu"``, which runs the kernels' plain versions.

Out-of-core training routes as in the reference: ``stream=True`` forces it,
and a ``stream_config`` streams each stage whose monolithic working set
exceeds its device budget.  Stage 1 then builds G in pinned host memory
(kernel B3 on the int8 wire, ``core/streaming.py``) and stage 2 streams G's
row blocks through B2 (``core/solver_stream.py``).  ``polish=True`` (or a
``polish_schedule``) solves stage 2 as the reference's coarse-to-fine ladder
(``core/polish.py``), each level through B2, the final level routed as an
unpolished fit.  ``predict_from_factor`` scores the training rows from G;
``save`` / ``load`` persist a fitted model as a numpy archive.
``fit(trace=...)`` (or a ``StreamConfig.trace``, or an installed tracer)
records the ``fit`` / ``stage1`` and ``fit`` / ``stage2`` spans and the
streamed and polished paths' own (``core/trace.py``).
``fit(checkpoint_dir=, checkpoint_every=, resume=)`` folds into the
``StreamConfig`` and forces the streamed route: stage 1 keeps a resumable
copy of G and stage 2 snapshots its solver (``core/resilience.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.dual_solver import SolveResult, SolverConfig, solve_batch
from repro_torch.core.kernel_fn import KERNELS, KernelParams, gram
from repro_torch.core.nystrom import LowRankFactor, compute_factor
from repro_torch.core.ovo import (build_ovo_tasks, factor_decisions,
                                  ovo_decision_values, ovo_vote)
from repro_torch.core.polish import (PolishSchedule, PolishTrace, make_schedule,
                                     solve_polished)
from repro_torch.core.solver_stream import (Stage2StreamStats, route_stage2,
                                            solve_batch_streamed)
from repro_torch.core.streaming import Stage1StreamStats, StreamConfig, with_trace
from repro_torch.core.trace import resolve


@dataclasses.dataclass
class FitStats:
    """Timings of the stages (paper figure 3 breakdown)."""

    stage1_seconds: float = 0.0     # preparation + computation of G
    stage2_seconds: float = 0.0     # linear SVM training (SMO)
    n_tasks: int = 0
    epochs: Optional[np.ndarray] = None
    violations: Optional[np.ndarray] = None
    effective_rank: int = 0
    stage1_streamed: bool = False   # True -> G came from the out-of-core path
    stage1_stats: Optional[Stage1StreamStats] = None
    stage2_streamed: bool = False   # True -> the solver streamed G row blocks
    stage2_stats: Optional[Stage2StreamStats] = None
    polished: bool = False          # True -> stage 2 ran the polish ladder
    polish_trace: Optional[PolishTrace] = None


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card and none is available; pass "
            "device='cpu' to run the plain PyTorch versions of the kernels")
    return dev


class LPDSVM:
    def __init__(
        self,
        kernel: KernelParams = KernelParams("rbf", gamma=1.0),
        C: float = 1.0,
        budget: int = 1000,
        tol: float = 1e-2,
        max_epochs: int = 1000,
        shrink: bool = True,
        seed: int = 0,
        gram_fn: Callable = gram,
        solve_fn: Callable = solve_batch,
        stream: Optional[bool] = None,
        stream_config: Optional[StreamConfig] = None,
        polish: bool = False,
        polish_levels: int = 3,
        polish_schedule: Optional[PolishSchedule] = None,
        polish_gap_trace: bool = True,
        device=None,
    ):
        if stream_config is not None and not isinstance(stream_config, StreamConfig):
            raise TypeError("stream_config must be a repro_torch StreamConfig")
        self.device = resolve_device(device)
        self.kernel = kernel
        self.C = float(C)
        self.budget = int(budget)
        self.config = SolverConfig(tol=tol, max_epochs=max_epochs, shrink=shrink)
        self.seed = seed
        self.gram_fn = gram_fn
        self.solve_fn = solve_fn
        self.stream = stream
        self.stream_config = stream_config
        # polishing (core/polish.py): polish=True builds the geometric ladder
        # polish_levels deep; an explicit polish_schedule wins
        self.polish_schedule = (
            polish_schedule if polish_schedule is not None
            else make_schedule(levels=polish_levels) if polish else None)
        # per-level duality gaps in the trace: one sweep of G a task a level
        self.polish_gap_trace = polish_gap_trace
        # fitted state
        self.factor: Optional[LowRankFactor] = None
        self.classes_: Optional[np.ndarray] = None
        self.pairs_ = None
        self.W_: Optional[torch.Tensor] = None      # (T, B') per-pair weights
        self.alpha_: Optional[torch.Tensor] = None  # (T, n_pad)
        self.tasks_ = None
        self.stats = FitStats()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ stage 1
    def _tracer(self, trace):
        """The fit's tracer: ``trace`` > ``stream_config.trace`` > installed."""
        return resolve(trace if trace is not None
                       else getattr(self.stream_config, "trace", None))

    def prepare(self, x, trace=None) -> LowRankFactor:
        """Compute (or return the cached) low-rank factor G for `x`."""
        if self.factor is None:
            tr = self._tracer(trace)
            # routing keys off stream / stream_config alone: a config made
            # only to carry the trace goes where streaming is forced anyway
            cfg = (with_trace(self.stream_config, trace)
                   if self.stream_config is not None or self.stream else None)
            t0 = tr.begin()
            self.factor = compute_factor(
                x, self.kernel, self.budget, seed=self.seed,
                gram_fn=self.gram_fn, device=self.device, stream=self.stream,
                stream_config=cfg)
            self._sync()
            self.stats.stage1_seconds = tr.end(
                "fit", "stage1", t0, rows=len(x), budget=self.budget)
            self._factor_stats()
        return self.factor

    def _factor_stats(self) -> None:
        self.stats.effective_rank = self.factor.effective_rank
        self.stats.stage1_streamed = self.factor.streamed
        self.stats.stage1_stats = self.factor.stage1_stats

    # ------------------------------------------------------------------ stage 2
    def fit(self, x, y, factor: Optional[LowRankFactor] = None,
            warm_alpha=None, trace=None, checkpoint_dir=None,
            checkpoint_every=None, resume=None) -> "LPDSVM":
        """Two-stage fit on the estimator's device.  ``trace`` (a
        ``core.trace.Tracer``) records the run's timeline; it wins over
        ``StreamConfig.trace``, which wins over an installed tracer, and
        never changes which route runs.

        ``checkpoint_dir`` / ``checkpoint_every`` / ``resume`` fold into the
        ``StreamConfig`` as the reference folds them: stage 1 resumes its
        logged G chunks from ``<dir>/stage1_G.npy`` and stage 2 snapshots
        its solver every ``checkpoint_every`` full passes, resumable bit for
        bit after a kill.  Any of them forces the streamed route, where
        checkpoints exist."""
        if (checkpoint_dir is not None or checkpoint_every is not None
                or resume is not None):
            upd = {}
            if checkpoint_dir is not None:
                upd["checkpoint_dir"] = checkpoint_dir
            if checkpoint_every is not None:
                upd["checkpoint_every"] = int(checkpoint_every)
            if resume is not None:
                upd["resume"] = bool(resume)
            self.stream_config = dataclasses.replace(
                self.stream_config or StreamConfig(), **upd)
            if self.stream is None and self.stream_config.checkpoint_dir:
                self.stream = True
        y = np.asarray(y)
        self.classes_, labels = np.unique(y, return_inverse=True)
        n_classes = len(self.classes_)
        if n_classes < 2:
            raise ValueError("need at least two classes")
        if factor is not None:
            self.factor = factor
            self._factor_stats()
        self.prepare(x, trace=trace)
        tr = self._tracer(trace)

        warm = None if warm_alpha is None else [np.asarray(a) for a in warm_alpha]
        tasks, self.pairs_ = build_ovo_tasks(labels, n_classes, self.C,
                                             alpha0=warm, device=self.device)
        self.tasks_ = tasks
        t0 = tr.begin()
        res: SolveResult = self._solve_stage2(tasks, trace)
        self._sync()
        self.stats.stage2_seconds = tr.end("fit", "stage2", t0, tasks=tasks.n_tasks)
        self.stats.n_tasks = tasks.n_tasks
        self.stats.epochs = res.epochs.cpu().numpy()
        self.stats.violations = res.violation.cpu().numpy()
        self.W_ = res.w
        self.alpha_ = res.alpha
        return self

    def _solve_stage2(self, tasks, trace=None) -> SolveResult:
        """Stage-2 dispatch (``solver_stream.route_stage2``): the polish
        ladder when enabled, the streamed row-block solver when G is
        host-resident or must be, else ``solve_fn`` on G on the device.
        Routing reads ``self.stream_config``; ``trace`` only rides along."""
        self.stats.stage2_streamed = False     # a refit must not report the
        self.stats.stage2_stats = None         # previous fit's stream stats
        self.stats.polished = False
        self.stats.polish_trace = None
        if self.polish_schedule is not None:
            res, ptrace = solve_polished(
                self.factor, tasks, self.config, self.polish_schedule,
                stream=self.stream, stream_config=self.stream_config,
                solve_fn=self.solve_fn, gap_trace=self.polish_gap_trace,
                return_trace=True, trace=trace)
            self.stats.polished = True
            self.stats.polish_trace = ptrace
            self.stats.stage2_streamed = ptrace.final.streamed
            self.stats.stage2_stats = ptrace.final.stream_stats
            return res
        G = self.factor.G
        if route_stage2(self.factor, tasks, self.stream, self.stream_config,
                        self.solve_fn, solve_batch):
            res, self.stats.stage2_stats = solve_batch_streamed(
                G, tasks, self.config,
                stream_config=with_trace(self.stream_config, trace),
                return_stats=True)
            self.stats.stage2_streamed = True
            return res
        # a host G that is not to stream (stream=False, or a custom solve_fn)
        # goes to the device whole, as the caller asked
        return self.solve_fn(G.to(self.device), tasks, self.config)

    # --------------------------------------------------------------- prediction
    def decision_function(self, x) -> np.ndarray:
        if self.W_ is None:
            raise RuntimeError("fit first")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        feats = self.factor.features(x)
        return ovo_decision_values(feats, self.W_).cpu().numpy()

    def predict(self, x) -> np.ndarray:
        return self._vote(self.decision_function(x))

    def _vote(self, d: np.ndarray) -> np.ndarray:
        if len(self.classes_) == 2:
            pred = np.where(d[:, 0] > 0, 0, 1)
        else:
            pred = ovo_vote(d, self.pairs_, len(self.classes_))
        return self.classes_[pred]

    def predict_from_factor(self, rows=None) -> np.ndarray:
        """Predict TRAINING rows straight from the fitted factor's G, with no
        kernel evaluation and no dense x (the driver's ``--libsvm`` route
        scores its training rows this way).  The decisions are summed in fp64
        where G lies (``ovo.factor_decisions``), so a pinned host G, a card G
        and a spilled G (read from its shards) vote alike."""
        if self.W_ is None:
            raise RuntimeError("fit first")
        G = self.factor.G
        if G.shape[0] == 0:
            raise RuntimeError(
                "G is not persisted in checkpoints (it is recomputable from "
                "the landmarks); refit or use predict(x) on a loaded model")
        return self._vote(factor_decisions(
            G, self.W_, rows=None if rows is None else np.asarray(rows)))

    def score(self, x, y) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))

    def error(self, x, y) -> float:
        return 1.0 - self.score(x, y)

    # -------------------------------------------------------------- persistence
    def save(self, directory: str, step: int = 0) -> str:
        """Persist the fitted model as ``directory/step_%08d.npz``: the
        landmarks, projector, eigvals, per-pair weights W and classes, and the
        kernel parameters and C under ``meta/`` (the reference's keys, dtypes
        and shapes).  G is a training-time object (n x B', recomputable from
        the landmarks) and is NOT stored.  ``step`` versions successive saves;
        ``load`` picks the latest."""
        if self.W_ is None:
            raise RuntimeError("fit first")
        from repro_torch.checkpoint import save_checkpoint
        tree = {
            "landmarks": self.factor.landmarks,
            "projector": self.factor.projector,
            "eigvals": self.factor.eigvals,
            "W": self.W_,
            "classes": _narrow(np.asarray(self.classes_)),
            "meta": {
                "gamma": np.float32(self.kernel.gamma),
                "coef0": np.float32(self.kernel.coef0),
                "degree": np.int32(self.kernel.degree),
                "C": np.float32(self.C),
                "kind": np.int32(KERNELS.index(self.kernel.kind)),
            },
        }
        return save_checkpoint(directory, step, tree)

    @classmethod
    def load(cls, directory: str, step: Optional[int] = None, device=None) -> "LPDSVM":
        """A fitted estimator from ``save``'s newest step (or ``step``), its
        arrays on ``device`` (default the card).  Its factor has a (0, B') G:
        ``predict`` works, ``predict_from_factor`` raises."""
        from repro_torch.checkpoint import latest_step, read_checkpoint
        from repro_torch.convert import from_reference   # convert builds on this module
        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no step_*.npz under {directory}")
        flat = read_checkpoint(directory, step)
        meta = {k: flat[f"meta/{k}"] for k in ("kind", "gamma", "coef0", "degree", "C")}
        return from_reference(flat, meta, device=device)


def _narrow(a: np.ndarray) -> np.ndarray:
    """64-bit integers and floats as 32-bit ones, as the reference stores its
    arrays (JAX without x64)."""
    if a.dtype.kind in "iuf" and a.dtype.itemsize == 8:
        return a.astype(a.dtype.kind + "4")
    return a
