"""Kernel functions for LPD-SVM (PyTorch port of ``repro.core.kernel_fn``).

All kernels reduce to a blocked X @ Z.T plus an elementwise epilogue.  On a
CUDA tensor ``gram`` runs kernel B1 (``kernels/csrc/gram.cu``); on a CPU
tensor it runs the plain PyTorch version.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.kernels.gram import KERNELS, apply_epilogue
from repro_torch.kernels.ops import gram   # kernel B1 on CUDA, plain on CPU

__all__ = ["KERNELS", "KernelParams", "apply_epilogue", "full_fp32", "gram",
           "kernel_diag", "median_gamma"]


@contextlib.contextmanager
def full_fp32():
    """Run the plain products around the kernels (K_nm @ projector, the
    prediction features, w0, the decision values) in full fp32, as the
    reference does: TF32 keeps about three decimal digits.  The two TF32
    switches are turned off inside and restored on exit, so the caller's own
    setting is left alone.  Also usable as a decorator."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Hyperparameters of a kernel function."""

    kind: str = "rbf"
    gamma: float = 1.0     # rbf / poly / tanh scale
    coef0: float = 0.0     # poly / tanh offset
    degree: int = 3        # poly

    def __post_init__(self):
        if self.kind not in KERNELS:
            raise ValueError(f"unknown kernel {self.kind!r}; expected one of {KERNELS}")


def median_gamma(x: np.ndarray, sample: int = 256, seed: int = 0) -> float:
    """Median-squared-distance heuristic: gamma = 1 / median ||x_i - x_j||^2
    over a random row subsample (host-side numpy, data inspection).  Random
    rows, not the head: real datasets are often label-sorted."""
    x = np.asarray(x, np.float32)
    if x.shape[0] > sample:
        rows = np.random.default_rng(seed).choice(x.shape[0], sample,
                                                  replace=False)
        x = x[np.sort(rows)]
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    d2 = d2[d2 > 0]
    return float(1.0 / np.median(d2)) if d2.size else 1.0


def kernel_diag(x: torch.Tensor, params: KernelParams) -> torch.Tensor:
    """k(x_i, x_i) without forming the full matrix."""
    x_sq = (x.to(torch.float32) ** 2).sum(-1)
    if params.kind == "linear":
        return x_sq
    if params.kind == "rbf":
        return torch.ones_like(x_sq)
    if params.kind == "poly":
        return (params.gamma * x_sq + params.coef0) ** params.degree
    if params.kind == "tanh":
        return torch.tanh(params.gamma * x_sq + params.coef0)
    raise ValueError(params.kind)
