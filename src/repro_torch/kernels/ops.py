"""Public wrappers around the hand-written kernels: dispatch by device.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA tensor
goes to the kernel, or the kernel's wrapper raises.  There is no fallback
from CUDA to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gram import gram_kernel, gram_plain
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


def smo_epoch(G, q, idx, y, c, alpha, unchanged, w, live, *,
              full_pass: bool, shrink_k: int) -> torch.Tensor:
    """One shrinking-aware epoch over every live task, in place on alpha,
    unchanged and w; returns the per-task violation (see kernels/smo.py)."""
    fn = smo_epoch_plain if _on_cpu(G) else smo_epoch_kernel
    return fn(G, q, idx, y, c, alpha, unchanged, w, live,
              full_pass=full_pass, shrink_k=shrink_k)
