"""LLSVM-style baseline (Zhang et al., 2012) as characterized by the paper
(PyTorch port of the JAX package's ``baselines/llsvm.py``).

Low-rank linearization with the *design decisions the paper criticizes*:
  * training iterates over the data set ONLY ONCE, in chunks (default 50,000
    points per chunk);
  * within each chunk, a FIXED number of epochs (30) is performed "irrespective
    of the achieved solution accuracy" -- no convergence check, no adaptive
    stopping ("It is of course easy to be fast if the job is not complete");
  * no shrinking, no warm starts.

Shares stage 1 (the Nystrom factor, kernel B1 on the card) with LPD-SVM so
the comparison isolates the *solver* differences, exactly like Table 2's
reading of the results.  A chunk's epoch is the reference's
``_chunk_epochs`` step over every row in order, which is kernel B2's full
pass with T = 1 (``ops.smo_epoch_flat``): every row with c > 0 is stepped
and the shrinking counters play no part.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kernel_fn import KernelParams, full_fp32
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.svm import resolve_device
from repro_torch.kernels import ops


def chunk_epochs(G_chunk: torch.Tensor, y_chunk: torch.Tensor, C: float, w: torch.Tensor,
                 epochs: int):
    """``epochs`` fixed coordinate-ascent passes over one chunk from alpha 0,
    no stopping: returns (alpha, w)."""
    n = G_chunk.shape[0]
    dev = G_chunk.device
    q = (G_chunk * G_chunk).sum(-1)              # B2 floors it at 1e-12
    c = torch.full((n,), C, dtype=torch.float32, device=dev)
    alpha = torch.zeros((n,), dtype=torch.float32, device=dev)
    unchanged = torch.zeros((n,), dtype=torch.int32, device=dev)
    for _ in range(epochs):
        alpha, unchanged, w, _ = ops.smo_epoch_flat(G_chunk, y_chunk, c, q, alpha,
                                                    unchanged, w, full_pass=True,
                                                    shrink_k=1)
    return alpha, w


class LLSVMStyle:
    """``device=None`` means the card."""

    def __init__(self, kernel: KernelParams, C: float = 1.0, budget: int = 100,
                 chunk_size: int = 50_000, epochs_per_chunk: int = 30, seed: int = 0,
                 device=None):
        self.kernel, self.C = kernel, float(C)
        self.budget, self.chunk_size = budget, chunk_size
        self.epochs_per_chunk = epochs_per_chunk
        self.seed = seed
        self.device = resolve_device(device)

    def fit(self, x: np.ndarray, y: np.ndarray, factor=None) -> "LLSVMStyle":
        """``factor`` replaces stage 1 (a factor of x's rows, e.g. one built
        on the reference's landmarks, or ``convert.factor_from_reference``'s),
        as ``PrimalSGDSVM.fit``'s does."""
        x = np.asarray(x, np.float32)
        self.classes_, labels = np.unique(np.asarray(y), return_inverse=True)
        if len(self.classes_) != 2:
            raise ValueError("LLSVM is not applicable to data sets with more "
                             "than two classes (paper, Table 2 caption)")
        y_pm = torch.as_tensor(np.where(labels == 0, 1.0, -1.0), dtype=torch.float32,
                               device=self.device)
        self.factor = factor or compute_factor(x, self.kernel, self.budget,
                                               seed=self.seed, device=self.device)
        G = self.factor.G
        w = torch.zeros((G.shape[1],), dtype=torch.float32, device=self.device)
        for s in range(0, x.shape[0], self.chunk_size):   # single pass over data
            _, w = chunk_epochs(G[s:s + self.chunk_size], y_pm[s:s + self.chunk_size],
                                self.C, w, self.epochs_per_chunk)
        self.w_ = w
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
