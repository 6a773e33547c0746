"""Exact (non-approximate) dual SVM solver, the ThunderSVM / LIBSVM stand-in
(PyTorch port of the JAX package's ``baselines/exact_smo.py``).

Dual coordinate ascent on the FULL precomputed kernel matrix Q (n x n).  This
is the "nearly exact" reference LPD-SVM is compared against in Table 2: same
optimization scheme, but iteration cost O(n) instead of O(B) and O(n^2) memory
instead of O(nB) -- precisely the trade-off the paper's low-rank stage removes.
Only feasible for small/medium n (like ThunderSVM, it would OOM on ImageNet).

On the card K comes from kernel B1 (``ops.gram``), each epoch is one launch of
kernel E1 (``ops.exact_epoch``) and the decisions are B1 then a plain
product; on the CPU the same calls run the plain versions.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kernel_fn import KernelParams, full_fp32
from repro_torch.core.ovo import class_pairs, ovo_vote
from repro_torch.core.svm import resolve_device
from repro_torch.kernels import ops

Q_FLOOR = 1e-12


@full_fp32()
def solve_exact(K: torch.Tensor, y: torch.Tensor, C: float, alpha0: torch.Tensor,
                tol: float, max_epochs: int) -> Tuple[torch.Tensor, float, int]:
    """Coordinate ascent keeping the full gradient (O(n) a step), epochs until
    the largest |projected gradient| of an epoch is below ``tol`` or
    ``max_epochs``: returns (alpha, viol, epochs).  ``K`` is turned into Q in
    place (its entries' signs flipped by y_i y_j, which is exact)."""
    Q = K.mul_(y[:, None]).mul_(y[None, :])
    q_diag = torch.diagonal(Q).clamp(min=Q_FLOOR).contiguous()
    grad = 1.0 - Q @ alpha0                       # dD/dalpha
    alpha = alpha0.clone()
    viol, epochs = float("inf"), 0
    while viol >= tol and epochs < max_epochs:
        v, _ = ops.exact_epoch(Q, q_diag, C, alpha, grad)
        viol = float(v)                           # one host sync an epoch
        epochs += 1
    return alpha, viol, epochs


class ExactDualSVM:
    """Binary or OVO-multiclass exact kernel SVM (full Q precomputation).
    ``device=None`` means the card."""

    def __init__(self, kernel: KernelParams, C: float = 1.0, tol: float = 1e-2,
                 max_epochs: int = 2000, device=None):
        self.kernel, self.C, self.tol, self.max_epochs = kernel, float(C), tol, max_epochs
        self.device = resolve_device(device)
        self.x_: Optional[torch.Tensor] = None
        self.epochs_: List[int] = []
        self.violations_: List[float] = []

    def fit(self, x: np.ndarray, y: np.ndarray) -> "ExactDualSVM":
        x = np.asarray(x, np.float32)
        self.classes_, labels = np.unique(np.asarray(y), return_inverse=True)
        self.x_ = torch.as_tensor(x, device=self.device)
        self.models_ = []  # (a, b, sel rows, alpha, y_pm)
        self.epochs_, self.violations_ = [], []
        for a, b in itertools.combinations(range(len(self.classes_)), 2):
            sel = np.where((labels == a) | (labels == b))[0]
            y_pm = torch.as_tensor(np.where(labels[sel] == a, 1.0, -1.0),
                                   dtype=torch.float32, device=self.device)
            xs = self.x_[torch.as_tensor(sel, device=self.device)]
            K = ops.gram(xs, xs, self.kernel)
            alpha0 = torch.zeros((len(sel),), dtype=torch.float32, device=self.device)
            alpha, viol, epochs = solve_exact(K, y_pm, self.C, alpha0, self.tol,
                                              self.max_epochs)
            del K
            self.models_.append((a, b, sel, alpha, y_pm))
            self.epochs_.append(epochs)
            self.violations_.append(viol)
        return self

    @full_fp32()
    def decision_function(self, x: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        cols = []
        for a, b, sel, alpha, y_pm in self.models_:
            xs = self.x_[torch.as_tensor(sel, device=self.device)]
            cols.append((ops.gram(x, xs, self.kernel) @ (alpha * y_pm)).cpu().numpy())
        return np.stack(cols, axis=1)

    def predict(self, x: np.ndarray) -> np.ndarray:
        d = self.decision_function(x)
        if len(self.classes_) == 2:
            return self.classes_[np.where(d[:, 0] > 0, 0, 1)]
        pred = ovo_vote(d, class_pairs(len(self.classes_)), len(self.classes_))
        return self.classes_[pred]

    def error(self, x, y) -> float:
        return float(np.mean(self.predict(x) != np.asarray(y)))
