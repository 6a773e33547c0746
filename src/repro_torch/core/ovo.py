"""One-versus-one multi-class handling, following LIBSVM (PyTorch port of
``repro.core.ovo``).

Task construction is host-side numpy index bookkeeping; the resulting
`TaskBatch` of tensors is solved by `dual_solver.solve_batch`.  For the pair
(a, b) with a < b, class a maps to +1.  Prediction is a majority vote with
ties broken towards the smaller class index.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import shards
from repro_torch.core.dual_solver import TaskBatch
from repro_torch.core.kernel_fn import full_fp32

PAD_MULTIPLE = 8     # tasks are padded to the largest pair, rounded up to this


def class_pairs(n_classes: int) -> List[Tuple[int, int]]:
    return list(itertools.combinations(range(n_classes), 2))


def ovo_arrays(
    labels: np.ndarray,
    n_classes: int,
    C: float,
    *,
    include_mask: Optional[np.ndarray] = None,
    n_pad: Optional[int] = None,
    pad_multiple: int = PAD_MULTIPLE,
    alpha0: Optional[Sequence[np.ndarray]] = None,
):
    """The host numpy arrays of ``build_ovo_tasks``: (idx, y, c, alpha0),
    each (T, n_pad), and the pairs.  Cross-validation stacks folds x Cs of
    them, so it builds them here and uploads the stack once."""
    labels = np.asarray(labels)
    if include_mask is None:
        include_mask = np.ones(labels.shape[0], dtype=bool)
    pairs = class_pairs(n_classes)
    sel = [np.where(include_mask & ((labels == a) | (labels == b)))[0]
           for a, b in pairs]
    max_n = max((len(s) for s in sel), default=1)
    if n_pad is None:
        n_pad = -(-max_n // pad_multiple) * pad_multiple
    if max_n > n_pad:
        raise ValueError(f"n_pad={n_pad} smaller than largest pair ({max_n})")

    T = len(pairs)
    idx = np.zeros((T, n_pad), dtype=np.int32)
    y = np.ones((T, n_pad), dtype=np.float32)
    c = np.zeros((T, n_pad), dtype=np.float32)
    a0 = np.zeros((T, n_pad), dtype=np.float32)
    for t, ((a, _), rows) in enumerate(zip(pairs, sel)):
        m = len(rows)
        idx[t, :m] = rows
        y[t, :m] = np.where(labels[rows] == a, 1.0, -1.0)
        c[t, :m] = C
        if alpha0 is not None and alpha0[t] is not None:
            a0[t, :m] = np.clip(alpha0[t][:m], 0.0, C)
    return (idx, y, c, a0), pairs


def build_ovo_tasks(
    labels: np.ndarray,
    n_classes: int,
    C: float,
    *,
    include_mask: Optional[np.ndarray] = None,
    n_pad: Optional[int] = None,
    pad_multiple: int = PAD_MULTIPLE,
    alpha0: Optional[Sequence[np.ndarray]] = None,
    device="cuda",
) -> Tuple[TaskBatch, List[Tuple[int, int]]]:
    """Build the padded one-vs-one task batch on ``device``.

    labels:        (n,) integer class labels, referring to rows of the shared G
    include_mask:  optional (n,) bool: rows to use (CV training folds)
    n_pad:         pad every task to this many rows (default: the largest
                   pair's size, rounded up to ``pad_multiple``); a pair
                   larger than an explicit n_pad raises ``ValueError``
    alpha0:        optional warm starts, one (task_size,) array per pair

    Padding rows have c = 0 and are inert.
    """
    arrays, pairs = ovo_arrays(labels, n_classes, C, include_mask=include_mask,
                               n_pad=n_pad, pad_multiple=pad_multiple,
                               alpha0=alpha0)
    idx, y, c, a0 = (torch.as_tensor(a, device=device) for a in arrays)
    return TaskBatch(idx=idx, y=y, c=c, alpha0=a0), pairs


@full_fp32()
def ovo_decision_values(features: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(m, B) features x (T, B) per-pair weights -> (m, T) decision values."""
    return features @ W.T


DECISION_BLOCK_ROWS = 8192   # rows of G in fp64 at a time (128 MiB at B' 2048)


def factor_decisions(g, W: torch.Tensor, rows=None) -> np.ndarray:
    """(m, B') rows of G x (T, B') per-pair weights -> (m, T) decision values
    as a host fp64 array, with no kernel evaluation: summed in fp64 where the
    rows lie (a host G stays on the host), W moved there once,
    ``DECISION_BLOCK_ROWS`` rows at a time.  So a card G and a host G of one
    factor vote alike.  ``rows`` (default all) selects rows of G.  ``g`` may
    be a ``shards.GShardView`` (a spilled G): its rows are then read from
    disk a block at a time, in the blocks a host G's rows are summed in, so
    it votes exactly as the host G does."""
    W = torch.as_tensor(W).to(g.device, torch.float64)
    m = g.shape[0] if rows is None else len(rows)
    out = np.empty((m, W.shape[0]), np.float64)
    step = DECISION_BLOCK_ROWS
    buf = torch.empty((min(step, m), g.shape[1]), dtype=torch.float64, device=g.device)
    for s in range(0, m, step):
        e = min(s + step, m)
        blk = (shards.rows_into(g, s, e, buf[:e - s]) if rows is None
               else shards.gather_into(g, rows[s:e], buf[:e - s]))
        out[s:e] = (blk @ W.T).cpu().numpy()
    return out


def ovo_vote(decisions: np.ndarray, pairs: List[Tuple[int, int]],
             n_classes: int) -> np.ndarray:
    """Majority vote over pairwise decisions -> (m,) class predictions."""
    decisions = np.asarray(decisions)
    m = decisions.shape[0]
    pa = np.asarray([p[0] for p in pairs], np.int64)
    pb = np.asarray([p[1] for p in pairs], np.int64)
    winner = np.where(decisions > 0, pa[None, :], pb[None, :])   # (m, T)
    votes = np.zeros((m, n_classes), dtype=np.int32)
    np.add.at(votes, (np.repeat(np.arange(m), len(pairs)), winner.ravel()), 1)
    # np.argmax breaks ties towards the smaller index (LIBSVM behaviour)
    return np.argmax(votes, axis=1)
