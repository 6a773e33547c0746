"""Shrinking with bucket compaction for one binary task (PyTorch port of
``repro.core.compact``).

In the paper shrinking is "a complete game-changer", partly because "after
removing many variables ... the memory demand for the relevant sub-matrix
of G reduces and the processor cache becomes more effective".  So after
every full pass the active rows are gathered on the device into the
smallest power-of-two bucket that holds them:

  * the cheap epochs until the next full pass sweep only ``bucket >=
    n_active`` rows of G (``CompactStats.rows_streamed``);
  * bucket sizes halve from n, so at most log2(n / tile) shapes occur;
  * every ``full_pass_period``-th epoch runs over all rows, which
    re-activates violating variables and takes the convergence test.

The epoch is one task's flat epoch, ``kernels.ops.smo_epoch_flat``: kernel
B2 with T = 1 on a CUDA tensor, its plain version on the CPU.  B2 already
skips inactive rows without reading them; the gather is what this module
measures.  Difference from the reference: the start's w = (alpha y) G is
summed in fp64 and rounded once, as ``dual_solver._init_w`` sums it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.dual_solver import INT32_MAX, SolverConfig
from repro_torch.core.kernel_fn import full_fp32
from repro_torch.kernels.ops import smo_epoch_flat


@dataclasses.dataclass
class CompactStats:
    epochs: int = 0
    full_passes: int = 0
    final_violation: float = float("inf")
    active_history: List[int] = dataclasses.field(default_factory=list)
    rows_streamed: int = 0           # sum of bucket sizes over epochs
    seconds: float = 0.0


def _bucket(n_active: int, n: int, tile: int) -> int:
    """Smallest power-of-two multiple of `tile` covering n_active (<= n)."""
    b = tile
    while b < n_active:
        b *= 2
    return min(b, n)


@full_fp32()
def solve_compact(
    G_rows,
    y,
    c,
    config: SolverConfig = SolverConfig(),
    *,
    epoch_fn: Optional[Callable] = None,
    alpha0=None,
    tile: int = 256,
):
    """Solve one binary task on its dense row matrix (n, B), on G_rows'
    device (numpy arrays go to the CPU).

    Returns (alpha, w, CompactStats).  ``epoch_fn`` has the reference's flat
    signature ``(G, y, c, q, alpha, unchanged, w, *, full_pass, shrink_k)
    -> (alpha, unchanged, w, viol)`` and defaults to
    ``kernels.ops.smo_epoch_flat``."""
    if epoch_fn is None:
        epoch_fn = smo_epoch_flat
    t0 = time.perf_counter()
    G_rows = torch.as_tensor(G_rows, dtype=torch.float32)
    dev = G_rows.device
    n, B = G_rows.shape
    tile = min(tile, n)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    c = torch.as_tensor(c, dtype=torch.float32, device=dev)
    q = (G_rows * G_rows).sum(1)
    alpha = (torch.zeros((n,), dtype=torch.float32, device=dev) if alpha0 is None
             else torch.minimum(torch.as_tensor(alpha0, dtype=torch.float32, device=dev)
                                .clamp(min=0.0), c))
    w = ((alpha * y).double() @ G_rows.double()).float()
    unchanged = torch.zeros((n,), dtype=torch.int32, device=dev)
    c_host = c.cpu().numpy()

    period = config.full_pass_period if config.shrink else 1
    shrink_k = config.shrink_k if config.shrink else INT32_MAX
    stats = CompactStats()
    cur: Optional[torch.Tensor] = None        # active row indices (device)
    sub = None                                # compacted alpha, unchanged

    for epoch in range(config.max_epochs):
        full = (epoch % period == 0) or not config.shrink
        if full:
            if cur is not None:
                # scatter the compacted state back before the full pass
                a_s, u_s = sub
                alpha[cur] = a_s[:len(cur)]
                unchanged[cur] = u_s[:len(cur)]
                cur, sub = None, None
            alpha, unchanged, w, viol = epoch_fn(
                G_rows, y, c, q, alpha, unchanged, w,
                full_pass=True, shrink_k=shrink_k)
            stats.full_passes += 1
            stats.rows_streamed += n
            viol = float(viol)
            stats.final_violation = viol
            stats.active_history.append(n)
            if viol < config.tol:
                stats.epochs = epoch + 1
                break
            # compact for the cheap epochs: a bucket of the active rows,
            # padded with inert (c = 0) copies of row 0
            act = np.where((unchanged.cpu().numpy() < shrink_k) & (c_host > 0))[0]
            if config.shrink and len(act) > 0:
                b = _bucket(len(act), n, tile)
                if b < n:
                    cur_full = torch.zeros((b,), dtype=torch.int64, device=dev)
                    cur_full[:len(act)] = torch.from_numpy(act).to(dev)
                    cur = cur_full[:len(act)]
                    a_s = alpha[cur_full]
                    a_s[len(act):] = 0.0
                    sub = (a_s, unchanged[cur_full])
                    G_sub = G_rows[cur_full]
                    y_sub = y[cur_full]
                    q_sub = q[cur_full]
                    c_sub = torch.zeros((b,), dtype=torch.float32, device=dev)
                    c_sub[:len(act)] = c[cur]
        elif cur is not None:
            a_s, u_s = sub
            a_s, u_s, w, viol = epoch_fn(
                G_sub, y_sub, c_sub, q_sub, a_s, u_s, w,
                full_pass=False, shrink_k=shrink_k)
            sub = (a_s, u_s)
            stats.rows_streamed += int(G_sub.shape[0])
            stats.active_history.append(int(G_sub.shape[0]))
        else:
            alpha, unchanged, w, viol = epoch_fn(
                G_rows, y, c, q, alpha, unchanged, w,
                full_pass=False, shrink_k=shrink_k)
            stats.rows_streamed += n
            stats.active_history.append(n)
        stats.epochs = epoch + 1

    if cur is not None:
        alpha[cur] = sub[0][:len(cur)]
    stats.seconds = time.perf_counter() - t0
    return alpha, w, stats


__all__ = ["CompactStats", "solve_compact"]
