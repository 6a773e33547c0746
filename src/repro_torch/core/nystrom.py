"""Stage 1 of LPD-SVM: complete precomputation of the low-rank factor G
(PyTorch port of the monolithic route of ``repro.core.nystrom``).

Landmarks are a uniform random sample of B training rows; K_mm is
eigendecomposed (not Cholesky: kernel matrices are often only semi-definite),
eigenvalues below ``eig_rtol`` times the largest are dropped (with their
columns of the projector, so G has B' = effective_rank columns), and
G = K_nm @ V diag(lambda^-1/2) is computed in ``block_rows`` blocks, so that
G G^T ~= K.  K_mm, K_nm and the prediction features go through ``gram_fn``
(kernel B1 on CUDA).

With ``stream`` / ``stream_config`` the (n, B) part streams instead
(``core/streaming.py``): G is then a host tensor, pinned for the card, and
the factor says so (``streamed``, ``stage1_stats``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.kernel_fn import KernelParams, full_fp32, gram

# float32 machine epsilon is ~1.19e-7; the paper drops eigenvalues below a
# threshold close to machine precision times the largest eigenvalue.
DEFAULT_EIG_RTOL = 1e-6


@dataclasses.dataclass
class LowRankFactor:
    """The fully precomputed stage-1 artifact, shared across tasks."""

    G: torch.Tensor               # (n, B') feature rows; G G^T ~= K
    landmarks: torch.Tensor       # (B, p) landmark points
    projector: torch.Tensor       # (B, B') V * lambda^-1/2: maps K_xm -> features
    eigvals: torch.Tensor         # (B,) spectrum of K_mm (descending)
    effective_rank: int           # B' after eigenvalue dropping
    kernel: KernelParams
    streamed: bool = False        # True -> G is a host tensor (pinned for the
                                  # card) filled by the out-of-core pipeline
    stage1_stats: Optional[object] = None
                                  # streaming.Stage1StreamStats of the build

    @property
    def n(self) -> int:
        return self.G.shape[0]

    @property
    def rank(self) -> int:
        return self.G.shape[1]

    @full_fp32()
    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Map new points into the low-rank feature space (prediction path)."""
        return gram(x, self.landmarks, self.kernel) @ self.projector


def landmark_rows(n: int, budget: int, seed: int = 0) -> Optional[np.ndarray]:
    """Rows of a uniform random sample of ``budget`` of n rows, drawn from a
    ``torch.Generator`` seeded with ``seed``; None (all rows) if budget >= n.
    The monolithic and the streamed route draw the same rows for a seed."""
    if budget >= n:
        return None
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen)[:budget].numpy()


def select_landmarks(x: torch.Tensor, budget: int, seed: int = 0) -> torch.Tensor:
    """The ``landmark_rows`` sample of the rows of x (all of x if budget >= n)."""
    rows = landmark_rows(x.shape[0], budget, seed)
    return x if rows is None else x[torch.from_numpy(rows).to(x.device)]


def eig_projector(k_mm: torch.Tensor, rtol: float):
    """eigh of K_mm -> (projector with dropped dirs zeroed, eigvals desc, rank)."""
    k_mm = 0.5 * (k_mm + k_mm.T)   # the two triangles may round differently
    evals, evecs = torch.linalg.eigh(k_mm)          # ascending, float32
    evals = evals.flip(0)
    evecs = evecs.flip(1)
    lam_max = evals[0].clamp(min=0.0)
    keep = evals > rtol * lam_max                   # adaptive rank
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, evals, 1.0)),
                           0.0)
    projector = evecs * inv_sqrt[None, :]           # (B, B), dropped cols zeroed
    return projector, evals, int(keep.sum())


@full_fp32()
def compute_factor(
    x,
    params: KernelParams,
    budget: int,
    *,
    seed: int = 0,
    landmark_idx=None,
    eig_rtol: float = DEFAULT_EIG_RTOL,
    block_rows: int = 65536,
    gram_fn: Callable = gram,
    device=None,
    stream: Optional[bool] = None,
    stream_config=None,
) -> LowRankFactor:
    """Run stage 1: landmarks -> K_mm -> eigh (+drop) -> G = K_nm @ projector.

    ``landmark_idx`` (rows of x) replaces the random draw, so that a test can
    hand in the reference's landmarks.  ``x`` may be numpy or a tensor; it is
    moved to ``device`` (default: where a tensor already lies, else the card).

    Out-of-core routing, as the reference routes: ``stream=True`` forces the
    chunked pipeline (``streaming.compute_factor_streamed``); ``stream=None``
    with a ``stream_config`` streams when the monolithic working set exceeds
    the config's device budget; otherwise G is computed on the device.
    """
    from repro_torch.core import streaming   # streaming builds on this module

    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    n, p = x.shape
    if stream is None and stream_config is not None:
        stream = streaming.should_stream(n, p, min(budget, n), stream_config)
    if stream:
        return streaming.compute_factor_streamed(
            x, params, budget, seed=seed, landmark_idx=landmark_idx,
            eig_rtol=eig_rtol, config=stream_config or streaming.StreamConfig(),
            gram_fn=gram_fn, device=device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    n = x.shape[0]
    if landmark_idx is not None:
        landmarks = x[torch.tensor(np.asarray(landmark_idx), dtype=torch.long,
                                   device=x.device)]
    else:
        landmarks = select_landmarks(x, budget, seed)
    k_mm = gram_fn(landmarks, landmarks, params)
    projector, evals, rank = eig_projector(k_mm, eig_rtol)
    projector = projector[:, :rank].contiguous()    # eigvals descend: kept first

    blocks = [gram_fn(x[s:s + block_rows], landmarks, params) @ projector
              for s in range(0, n, block_rows)]
    G = torch.cat(blocks) if len(blocks) > 1 else blocks[0]
    return LowRankFactor(G=G, landmarks=landmarks, projector=projector,
                         eigvals=evals, effective_rank=rank, kernel=params)
