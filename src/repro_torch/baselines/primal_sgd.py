"""Primal mini-batch SGD baseline (Pegasos / EigenPro-like), PyTorch port of
the JAX package's ``baselines/primal_sgd.py``.

The paper argues (sec. 2, citing LIBLINEAR) that "primal solvers find rough
approximate solutions quickly, while dual methods are the method of choice
when the large margin principle is taken serious".  This baseline lets the
benchmark reproduce that trade-off: SGD on the primal hinge objective over the
SAME whitened low-rank features (whitening = the EigenPro trick, which here
comes for free from stage 1).

The steps are a handful of torch ops each (a gather, two products, the
update), some ten launches a step; the batch rows are drawn up front, from a
``torch.Generator`` on the device seeded with ``seed + 1``, or taken from
``fit(batch_idx=)`` (the reference's ``jax.random`` draws, for the tests).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.kernel_fn import KernelParams, full_fp32
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.svm import resolve_device


@full_fp32()
def sgd(G: torch.Tensor, y: torch.Tensor, lam: float, lr0: float,
        batch_idx: torch.Tensor) -> torch.Tensor:
    """Pegasos-style steps over the rows ``batch_idx`` (steps, batch) of G:
    the hinge subgradient on each batch, lr0 / (1 + 0.1 i) at step i."""
    steps, batch = batch_idx.shape
    dev = G.device
    lrs = lr0 / (1.0 + 0.1 * torch.arange(steps, dtype=torch.float32, device=dev))
    w = torch.zeros((G.shape[1],), dtype=torch.float32, device=dev)
    for i in range(steps):
        idx = batch_idx[i]
        xb, yb = G[idx], y[idx]
        margins = yb * (xb @ w)
        active = (margins < 1.0).to(torch.float32)
        grad = lam * w - (active * yb) @ xb / batch
        w = w - lrs[i] * grad
    return w


class PrimalSGDSVM:
    """``device=None`` means the card."""

    def __init__(self, kernel: KernelParams, C: float = 1.0, budget: int = 500,
                 batch: int = 64, steps: int = 2000, lr0: float = 1.0, seed: int = 0,
                 device=None):
        self.kernel, self.C = kernel, float(C)
        self.budget, self.batch, self.steps, self.lr0 = budget, batch, steps, lr0
        self.seed = seed
        self.device = resolve_device(device)

    def fit(self, x: np.ndarray, y: np.ndarray, factor=None,
            batch_idx: Optional[np.ndarray] = None) -> "PrimalSGDSVM":
        """``factor`` reuses a stage-1 factor (e.g. LPD-SVM's); ``batch_idx``
        (steps, batch) replaces the batch draws."""
        x = np.asarray(x, np.float32)
        self.classes_, labels = np.unique(np.asarray(y), return_inverse=True)
        if len(self.classes_) != 2:
            raise ValueError("binary only (benchmark baseline)")
        y_pm = torch.as_tensor(np.where(labels == 0, 1.0, -1.0), dtype=torch.float32,
                               device=self.device)
        self.factor = factor or compute_factor(x, self.kernel, self.budget,
                                               seed=self.seed, device=self.device)
        n = x.shape[0]
        if batch_idx is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
            batch_idx = torch.randint(0, n, (self.steps, self.batch), generator=gen,
                                      device=self.device)
        else:
            batch_idx = torch.tensor(np.asarray(batch_idx), dtype=torch.long,
                                        device=self.device)
            if tuple(batch_idx.shape) != (self.steps, self.batch):
                raise ValueError(f"batch_idx must be ({self.steps}, {self.batch}), got "
                                 f"{tuple(batch_idx.shape)}")
        lam = 1.0 / (self.C * n)
        self.w_ = sgd(self.factor.G, y_pm, lam, self.lr0, batch_idx)
        return self

    @full_fp32()
    def decision_function(self, x: np.ndarray) -> np.ndarray:
        feats = self.factor.features(torch.as_tensor(np.asarray(x, np.float32),
                                                     device=self.device))
        return (feats @ self.w_).cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.classes_[(self.decision_function(x) <= 0).astype(int)]

    def error(self, x, y) -> float:
        return float(np.mean(self.predict(x) != np.asarray(y)))
