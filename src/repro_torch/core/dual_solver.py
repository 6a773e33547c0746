"""Stage 2 of LPD-SVM: dual coordinate ascent on the precomputed factor G
(PyTorch port of ``repro.core.dual_solver``).

With the approximate kernel G G^T the dual SVM is a linear SVM on the rows of
G.  The solver is LIBLINEAR-style dual coordinate ascent with truncated
Newton steps, the paper's shrinking (a variable unchanged for ``shrink_k``
touches is skipped until the next full pass, every ``full_pass_period``-th
epoch), a stop when a full pass sees a largest KKT violation below ``tol``,
and warm starts through ``alpha0``.

The reference solves each task in its own ``while_loop`` under ``vmap``.
Here one epoch of every live task is one launch of kernel B2 (plain PyTorch
on the CPU); a task stops at its own full pass and then stays frozen, so
``epochs`` counts, per task, the epochs in which it was live.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.kernel_fn import full_fp32
from repro_torch.kernels.ops import smo_epoch, smo_epoch_scratch

INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    tol: float = 0.1               # max KKT violation on a full pass
    max_epochs: int = 1000
    shrink_k: int = 5              # paper: k = 5 consecutive no-change touches
    full_pass_period: int = 20     # paper: eta ~ 5% -> every 20th epoch is full
    shrink: bool = True


class TaskBatch(NamedTuple):
    """A batch of binary SVM tasks over a shared factor G (leading task axis)."""

    idx: torch.Tensor     # (T, n_pad) int32 rows of G
    y: torch.Tensor       # (T, n_pad) float32 in {-1, +1} (padding value is free)
    c: torch.Tensor       # (T, n_pad) float32 box bound; 0 for padding -> inert
    alpha0: torch.Tensor  # (T, n_pad) warm start

    @property
    def n_tasks(self) -> int:
        return self.idx.shape[0]


class SolveResult(NamedTuple):
    alpha: torch.Tensor          # (T, n_pad)
    w: torch.Tensor              # (T, B) primal weight in the low-rank space
    epochs: torch.Tensor         # (T,) epochs consumed
    violation: torch.Tensor      # (T,) max KKT violation at the last full pass
    dual_obj: torch.Tensor       # (T,)
    n_sv: torch.Tensor           # (T,) support-vector count


def _init_w(G, idx, y, alpha) -> torch.Tensor:
    """w_t = sum_i alpha_ti y_ti g_idx[t, i], one task at a time, so the
    (T, n_pad, B) gather of G is never materialised; zero for a cold start.
    The sum is taken in fp64 and rounded once, so the streamed solver, which
    sums the same terms block by block, starts from the same fp32 w."""
    w = torch.zeros((idx.shape[0], G.shape[1]), dtype=torch.float32,
                    device=G.device)
    if bool((alpha != 0).any()):
        for t in range(idx.shape[0]):
            coef = (alpha[t] * y[t]).double()
            w[t] = (coef @ G[idx[t].long()].double()).float()
    return w


def solve_batch(G: torch.Tensor, tasks: TaskBatch, config: SolverConfig) -> SolveResult:
    """Solve every task of the batch to convergence (shared G)."""
    idx = tasks.idx.to(torch.int32).contiguous()
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= G.shape[0]):
        raise ValueError(f"task indices must lie in [0, {G.shape[0]})")
    y = tasks.y.to(torch.float32).contiguous()
    c = tasks.c.to(torch.float32).contiguous()
    alpha = tasks.alpha0.to(torch.float32).clone()
    T = idx.shape[0]
    dev = G.device
    q = (G * G).sum(-1)                        # q_ii = <g_i, g_i>, once per row of G
    w = _init_w(G, idx, y, alpha)
    unchanged = torch.zeros_like(idx)
    period = config.full_pass_period if config.shrink else 1
    shrink_k = config.shrink_k if config.shrink else INT32_MAX
    epochs = torch.zeros((T,), dtype=torch.int32, device=dev)
    violation = torch.full((T,), float("inf"), dtype=torch.float32, device=dev)
    live = torch.ones((T,), dtype=torch.bool, device=dev)
    scratch = smo_epoch_scratch(T, idx.shape[1], dev)   # B2's active lists

    for epoch in range(config.max_epochs):
        full_pass = epoch % period == 0        # the same epoch for every live task
        viol = smo_epoch(G, q, idx, y, c, alpha, unchanged, w, live,
                         full_pass=full_pass, shrink_k=shrink_k, scratch=scratch)
        epochs += live.to(torch.int32)
        if full_pass:                          # the tol test is on full passes only
            violation = torch.where(live, viol, violation)
            live = live & ~(viol < config.tol)
            if not bool(live.any()):           # one host sync per full pass
                break

    dual = alpha.sum(-1) - 0.5 * (w * w).sum(-1)
    n_sv = (alpha > 0.0).sum(-1)
    return SolveResult(alpha, w, epochs, violation, dual, n_sv)


def solve_one(G, idx, y, c, alpha0, config: SolverConfig) -> SolveResult:
    """Solve a single binary task: ``solve_batch`` with T = 1."""
    res = solve_batch(G, TaskBatch(idx[None], y[None], c[None], alpha0[None]),
                      config)
    return SolveResult(*(t[0] for t in res))


# ----------------------------------------------------------------------------
# objective helpers (tests / benchmarks), one task: idx/y/c/alpha are (n_pad,)
# ----------------------------------------------------------------------------

def dual_objective(G, idx, y, alpha):
    w = _init_w(G, idx[None], y[None], alpha[None])[0]
    return alpha.sum() - 0.5 * torch.dot(w, w)


@full_fp32()
def primal_objective(G, idx, y, c, w):
    """P(w) = 1/2 ||w||^2 + C sum hinge (the dual's units), with lambda =
    1/(C n); the box c identifies the real examples (c > 0)."""
    real = c > 0.0
    n = real.sum()
    C = c.max()
    lam = 1.0 / (C * n)
    margins = y * (G[idx.long()] @ w)
    hinge = torch.where(real, torch.clamp(1.0 - margins, min=0.0), 0.0)
    return 0.5 * torch.dot(w, w) + C * hinge.sum(), lam, n


def duality_gap(G, idx, y, c, alpha):
    w = _init_w(G, idx[None], y[None], alpha[None])[0]
    p, _, _ = primal_objective(G, idx, y, c, w)
    return p - (alpha.sum() - 0.5 * torch.dot(w, w))
