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
row blocks through B2 (``core/solver_stream.py``).  The polished,
checkpointed and traced routes of the reference are not ported yet: their
arguments raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.dual_solver import SolveResult, SolverConfig, solve_batch
from repro_torch.core.kernel_fn import KernelParams, gram
from repro_torch.core.nystrom import LowRankFactor, compute_factor
from repro_torch.core.ovo import build_ovo_tasks, ovo_decision_values, ovo_vote
from repro_torch.core.solver_stream import (Stage2StreamStats, route_stage2,
                                            solve_batch_streamed)
from repro_torch.core.streaming import Stage1StreamStats, StreamConfig


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


def _not_ported(**args) -> None:
    for name, set_ in args.items():
        if set_:
            raise NotImplementedError(
                f"LPDSVM: `{name}` is not ported to repro_torch yet; only the "
                "monolithic and the streamed fit -> predict routes are")


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
        polish_schedule=None,
        polish_gap_trace: bool = True,
        device=None,
    ):
        _not_ported(polish=bool(polish), polish_levels=polish_levels != 3,
                    polish_schedule=polish_schedule is not None,
                    polish_gap_trace=polish_gap_trace is not True)
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
    def prepare(self, x, trace=None) -> LowRankFactor:
        """Compute (or return the cached) low-rank factor G for `x`."""
        _not_ported(trace=trace is not None)
        if self.factor is None:
            t0 = time.perf_counter()
            self.factor = compute_factor(
                x, self.kernel, self.budget, seed=self.seed,
                gram_fn=self.gram_fn, device=self.device, stream=self.stream,
                stream_config=self.stream_config)
            self._sync()
            self.stats.stage1_seconds = time.perf_counter() - t0
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
        """Two-stage fit on the estimator's device."""
        _not_ported(trace=trace is not None,
                    checkpoint_dir=checkpoint_dir is not None,
                    checkpoint_every=checkpoint_every is not None,
                    resume=resume is not None)
        y = np.asarray(y)
        self.classes_, labels = np.unique(y, return_inverse=True)
        n_classes = len(self.classes_)
        if n_classes < 2:
            raise ValueError("need at least two classes")
        if factor is not None:
            self.factor = factor
            self._factor_stats()
        self.prepare(x)

        warm = None if warm_alpha is None else [np.asarray(a) for a in warm_alpha]
        tasks, self.pairs_ = build_ovo_tasks(labels, n_classes, self.C,
                                             alpha0=warm, device=self.device)
        self.tasks_ = tasks
        t0 = time.perf_counter()
        res: SolveResult = self._solve_stage2(tasks)
        self._sync()
        self.stats.stage2_seconds = time.perf_counter() - t0
        self.stats.n_tasks = tasks.n_tasks
        self.stats.epochs = res.epochs.cpu().numpy()
        self.stats.violations = res.violation.cpu().numpy()
        self.W_ = res.w
        self.alpha_ = res.alpha
        return self

    def _solve_stage2(self, tasks) -> SolveResult:
        """Stage-2 dispatch (``solver_stream.route_stage2``): the streamed
        row-block solver when G is host-resident or must be, else
        ``solve_fn`` on G on the device."""
        self.stats.stage2_streamed = False     # a refit must not report the
        self.stats.stage2_stats = None         # previous fit's stream stats
        G = self.factor.G
        if route_stage2(self.factor, tasks, self.stream, self.stream_config,
                        self.solve_fn, solve_batch):
            res, self.stats.stage2_stats = solve_batch_streamed(
                G, tasks, self.config, stream_config=self.stream_config,
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

    def score(self, x, y) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))

    def error(self, x, y) -> float:
        return 1.0 - self.score(x, y)
