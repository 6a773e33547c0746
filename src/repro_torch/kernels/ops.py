"""Public wrappers around the hand-written kernels: dispatch by device.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA tensor
goes to the kernel, or the kernel's wrapper raises.  There is no fallback
from CUDA to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gram import (gram_kernel, gram_plain, gram_q8_kernel,
                                      gram_q8_plain)
from repro_torch.kernels.smo import smo_epoch_kernel, smo_epoch_plain


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"repro_torch kernels run on cpu or cuda, not {t.device}")


def gram(x: torch.Tensor, z: torch.Tensor, params) -> torch.Tensor:
    """Batch kernel matrix K(x, z), any shapes; inputs are cast to fp32."""
    x = x.to(torch.float32)
    z = z.to(torch.float32)
    if _on_cpu(x):
        return gram_plain(x, z, params)
    return gram_kernel(x, z, params)


def gram_q8(values: torch.Tensor, scales: torch.Tensor, z: torch.Tensor,
            params, *, group: int) -> torch.Tensor:
    """Batch kernel matrix K(dequant(values, scales), z) from int8 codes and
    the compact (ceil(n / group), 2) scale table, any shapes and either
    codec (ragged edges are masked, never padded)."""
    z = z.to(torch.float32)
    if _on_cpu(values):
        return gram_q8_plain(values, scales, z, params, group)
    return gram_q8_kernel(values, scales, z, params, group)


def smo_epoch(G, q, idx, y, c, alpha, unchanged, w, live, *,
              full_pass: bool, shrink_k: int, lo=None, hi=None,
              row0: int = 0) -> torch.Tensor:
    """One shrinking-aware epoch over every live task, in place on alpha,
    unchanged and w; returns the per-task violation (see kernels/smo.py).
    ``lo`` / ``hi`` / ``row0`` give the window form over one row block."""
    fn = smo_epoch_plain if _on_cpu(G) else smo_epoch_kernel
    return fn(G, q, idx, y, c, alpha, unchanged, w, live,
              full_pass=full_pass, shrink_k=shrink_k, lo=lo, hi=hi, row0=row0)
