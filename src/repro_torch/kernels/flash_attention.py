"""Kernel B4, online-softmax (flash) attention: CUDA launch and plain version.

``flash_attention_kernel`` launches ``csrc/flash_attention.cu`` (it replaces
the TPU kernel ``src/repro/kernels/flash_attention.py:68``,
``flash_attention_pallas``, which is the TPU form of the model's
``models/attention.py::_flash``); ``flash_attention_plain`` is ``_flash``'s
arithmetic in PyTorch ops, tiled over kv with an fp32 running max,
normaliser and accumulator.  The plain version serves CPU tensors and the
comparisons; nothing on the CUDA path calls it.

Both take the model's layout, grouped-query heads included:

    q  (B, S, Hq, D)    k, v  (B, S, Hkv, D)    Hq a multiple of Hkv

query head h attends kv head h // (Hq // Hkv), over positions 0 .. S - 1 of
the same sequence (causal: key position <= query position).  The logits are
fp32 from the inputs upcast, times 1/sqrt(D); the output has q's dtype.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
KV_TILE = 1024                      # the plain version's kv tile (_flash's kv chunk)
HEAD_DIMS = (64, 128)               # the kernel's head widths
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535                 # Hq and B ride gridDim.y and gridDim.z


def softmax_scale(D: int) -> float:
    """1/sqrt(D) rounded once to fp32, as ``_flash`` computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(D)))


def _shapes(q, k, v, who: str):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{who}: q (B, S, Hq, D) and k, v (B, S, Hkv, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D or Hkv == 0 \
            or Hq % Hkv:
        raise ValueError(f"{who}: q {tuple(q.shape)} and k, v {tuple(k.shape)} "
                         "differ in B, S or D, or Hq is not a multiple of Hkv")
    return B, S, Hq, Hkv, D


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, kv_tile: int = KV_TILE) -> torch.Tensor:
    """``_flash``'s online softmax in PyTorch ops, one kv tile at a time."""
    B, S, Hq, Hkv, D = _shapes(q, k, v, "flash_attention_plain")
    G = Hq // Hkv
    scale = torch.tensor(softmax_scale(D), dtype=torch.float32, device=q.device)
    qf = q.to(torch.float32).reshape(B, S, Hkv, G, D)
    rows = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, G, S, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, S, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, kv_tile):
        kb = k[:, k0:k0 + kv_tile].to(torch.float32)
        vb = v[:, k0:k0 + kv_tile].to(torch.float32)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb) * scale
        if causal:
            cols = rows[k0:k0 + kv_tile]
            s = torch.where(rows[:, None] >= cols[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)                  # (B, Hkv, G, S, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True) -> torch.Tensor:
    """Launch kernel B4 on CUDA tensors; returns (B, S, Hq, D) in q's dtype.

    D must be 64 or 128 and q, k, v one dtype, fp32 or bf16."""
    B, S, Hq, Hkv, D = _shapes(q, k, v, "flash_attention_kernel")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_kernel: q, k, v must share one dtype of "
                        f"{tuple(DTYPES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_kernel: q, k and v must be CUDA tensors "
                         "on one device")
    if max(B, Hq) > MAX_GRID_YZ or S >= 2 ** 31:
        raise ValueError(f"flash_attention_kernel: {tuple(q.shape)} exceeds the "
                         "launch grid")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          B, S, Hq, Hkv, D, DTYPES[q.dtype], softmax_scale(D),
                          int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_kernel: launch failed with CUDA error {err}")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
