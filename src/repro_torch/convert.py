"""Carry the JAX package's fitted arrays across to the port.

The arrays arrive as numpy (``np.asarray`` of the reference's device arrays),
so this module needs nothing of the JAX package:

  * ``from_reference``: a fitted estimator from the reference's fitted state
    (the arrays its ``save`` writes: landmarks, projector, eigvals, W,
    classes, and the kernel parameters and C of its ``meta``);
  * ``factor_from_reference`` / ``tasks_from_reference``: a stage-1 factor G
    (device-resident, or host-resident for the streamed route) and a
    ``TaskBatch``, so stage 2 can be held against the reference on identical
    inputs.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.dual_solver import TaskBatch
from repro_torch.core.kernel_fn import KERNELS, KernelParams
from repro_torch.core.nystrom import LowRankFactor
from repro_torch.core.ovo import class_pairs
from repro_torch.core.streaming import host_buffer
from repro_torch.core.svm import LPDSVM, resolve_device


def _kernel_params(meta: Mapping) -> KernelParams:
    """``KernelParams`` from the reference's kernel fields; ``kind`` may be
    the name or the reference's saved index into ("rbf", "linear", "poly",
    "tanh")."""
    kind = meta["kind"]
    if not isinstance(kind, str):
        kind = KERNELS[int(kind)]
    return KernelParams(kind=kind, gamma=float(meta["gamma"]),
                        coef0=float(meta.get("coef0", 0.0)),
                        degree=int(meta.get("degree", 3)))


def _put(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)   # a copy


def factor_from_reference(state: Mapping[str, np.ndarray], kernel: KernelParams,
                          device=None, *, streamed: bool = False) -> LowRankFactor:
    """A ``LowRankFactor`` from the reference's landmarks, projector, eigvals
    and, where given, G (a fitted model loaded for prediction has none).

    ``streamed=True`` carries a streamed reference factor (its G is a host
    numpy buffer) across as a streamed port factor: G stays in host memory,
    pinned when the device is the card, and stage 2 streams it."""
    device = resolve_device(device)
    projector = _put(state["projector"], device)
    G = state.get("G")
    if G is None:
        G = torch.zeros((0, projector.shape[1]), device=device)
    elif streamed:
        src = torch.from_numpy(np.ascontiguousarray(G, np.float32))
        G = host_buffer(tuple(src.shape), torch.float32, device)
        G.copy_(src)
    else:
        G = _put(G, device)
    return LowRankFactor(G=G, landmarks=_put(state["landmarks"], device),
                         projector=projector, eigvals=_put(state["eigvals"], device),
                         effective_rank=projector.shape[1], kernel=kernel,
                         streamed=streamed)


def tasks_from_reference(idx, y, c, alpha0, device=None) -> TaskBatch:
    """The reference's ``TaskBatch`` fields as a port ``TaskBatch``."""
    device = resolve_device(device)
    return TaskBatch(idx=_put(idx, device, torch.int32), y=_put(y, device),
                     c=_put(c, device), alpha0=_put(alpha0, device))


def from_reference(state: Mapping[str, np.ndarray], kernel: Mapping,
                   device=None) -> LPDSVM:
    """A fitted port ``LPDSVM`` from the reference estimator's fitted arrays.

    ``kernel`` holds ``kind``, ``gamma``, ``coef0``, ``degree`` and ``C``, as
    the reference's saved ``meta`` does."""
    params = _kernel_params(kernel)
    svm = LPDSVM(kernel=params, C=float(kernel["C"]), device=device)
    svm.factor = factor_from_reference(state, params, svm.device)
    svm.W_ = _put(state["W"], svm.device)
    svm.classes_ = np.asarray(state["classes"])
    svm.pairs_ = class_pairs(len(svm.classes_))
    return svm
