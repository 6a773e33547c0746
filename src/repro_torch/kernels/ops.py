"""Public wrappers around the hand-written kernels: dispatch by device.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA tensor
goes to the kernel, or the kernel's wrapper raises.  There is no fallback
from CUDA to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.exact import exact_epoch_kernel, exact_epoch_plain
from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention_kernel,
                                                 flash_attention_plain)
from repro_torch.kernels.gram import (gram_kernel, gram_plain, gram_q8_kernel,
                                      gram_q8_plain)
from repro_torch.kernels.smo import (epoch_scratch, smo_epoch_kernel,
                                     smo_epoch_plain)


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
              row0: int = 0, scratch=None) -> torch.Tensor:
    """One shrinking-aware epoch over every live task, in place on alpha,
    unchanged and w; returns the per-task violation (see kernels/smo.py).
    ``lo`` / ``hi`` / ``row0`` give the window form over one row block;
    ``scratch`` is the kernel's, from ``smo_epoch_scratch``."""
    if _on_cpu(G):
        return smo_epoch_plain(G, q, idx, y, c, alpha, unchanged, w, live,
                               full_pass=full_pass, shrink_k=shrink_k, lo=lo,
                               hi=hi, row0=row0)
    return smo_epoch_kernel(G, q, idx, y, c, alpha, unchanged, w, live,
                            full_pass=full_pass, shrink_k=shrink_k, lo=lo, hi=hi,
                            row0=row0, scratch=scratch)


def smo_epoch_flat(G, y, c, q, alpha, unchanged, w, *, full_pass: bool,
                   shrink_k: int):
    """One task's epoch over every row of G in order, with the reference's
    flat signature (``repro``'s ``kernels/ops.py`` ``smo_epoch``): y, c, q,
    alpha, unchanged (n,), w (B,).  ``smo_epoch`` with T = 1 on copies of
    alpha, unchanged and w, so that the inputs stay as they were; returns
    (alpha, unchanged, w, viol) with viol a 0-d tensor."""
    dev = G.device
    n = G.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=dev)[None]
    a = alpha.to(torch.float32).reshape(1, n).clone()
    u = unchanged.to(torch.int32).reshape(1, n).clone()
    wv = w.to(torch.float32).reshape(1, -1).clone()
    live = torch.ones((1,), dtype=torch.bool, device=dev)
    viol = smo_epoch(G.to(torch.float32).contiguous(), q.to(torch.float32).contiguous(),
                     idx, y.to(torch.float32).reshape(1, n).contiguous(),
                     c.to(torch.float32).reshape(1, n).contiguous(), a, u, wv, live,
                     full_pass=full_pass, shrink_k=shrink_k,
                     scratch=smo_epoch_scratch(1, n, dev))
    return a[0], u[0], wv[0], viol[0]


def smo_epoch_scratch(n_tasks: int, positions: int, device):
    """The scratch ``smo_epoch`` lists active rows in, for windows of up to
    ``positions`` positions per task: allocated once per solve on the card,
    None on the CPU (the plain version needs none)."""
    if torch.device(device).type == "cpu":
        return None
    return epoch_scratch(n_tasks, positions, device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Online-softmax attention in the model's layout: q (B, S, Hq, D), k and
    v (B, S, Hkv, D), query head h on kv head h // (Hq // Hkv); returns
    (B, S, Hq, D) in q's dtype (see kernels/flash_attention.py).  Ragged S is
    masked, never padded, causal or not.  A sliding window is not ported:
    ``window > 0`` raises on every device.  Where an input requires a
    gradient (and grad mode is on) the call goes through the autograd
    Function ``FlashAttention``: the same forward, and a backward that
    recomputes the unrounded attention block by block."""
    if window > 0:
        raise NotImplementedError(
            "flash_attention: sliding-window attention (window > 0) is not "
            "ported to repro_torch; no ported configuration has one")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    if _on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal)
    return flash_attention_kernel(q, k, v, causal=causal)


def exact_epoch(Q: torch.Tensor, q_diag: torch.Tensor, C: float, alpha: torch.Tensor,
                grad: torch.Tensor):
    """One sweep of the exact dual solver's coordinate ascent over the full Q,
    in place on alpha and grad; returns (viol, moved) as 0-d tensors (see
    kernels/exact.py)."""
    if _on_cpu(Q):
        return exact_epoch_plain(Q, q_diag, C, alpha, grad)
    return exact_epoch_kernel(Q, q_diag, C, alpha, grad)
