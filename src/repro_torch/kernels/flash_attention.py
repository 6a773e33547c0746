"""Kernel B4, online-softmax (flash) attention: CUDA launch and plain version.

``flash_attention_kernel`` launches ``csrc/flash_attention.cu`` (it replaces
the TPU kernel ``src/repro/kernels/flash_attention.py:68``,
``flash_attention_pallas``, which is the TPU form of the model's
``models/attention.py::_flash``): a tensor-core body for bf16, a SIMT body
for fp32.  ``flash_attention_plain`` computes the TPU kernel's function in
PyTorch ops, tiled over kv with an fp32 running max, normaliser and
accumulator, p rounded to the input type before p . v (a no-op for fp32).
The plain version serves CPU tensors and the comparisons; nothing on the
CUDA path calls it.

Both take the model's layout, grouped-query heads included:

    q  (B, S, Hq, D)    k, v  (B, S, Hkv, D)    Hq a multiple of Hkv

query head h attends kv head h // (Hq // Hkv), over positions 0 .. S - 1 of
the same sequence (causal: key position <= query position).  The logits are
fp32 from the inputs upcast, times 1/sqrt(D); the output has q's dtype.
The rounded p depends on the running max and so on the kv tile: given
``kv_tile=bf16_kv_tile()`` the plain version rounds p as the kernel does.
``flash_attention_rounding_slack`` bounds what a p rounded the other way
(logits that differ in the last bits) can move in the output.

``FlashAttention`` is the autograd Function that training goes through:
its forward is B4 on CUDA tensors and the plain version on the CPU; its
backward, ``flash_attention_grad_plain``, recomputes ``_flash``'s function
(fp32, p not rounded) one block of query rows at a time and differentiates
it, as the reference's remat does, so no (B, H, S, S) tensor outlives one
block.  The TPU kernel has no gradient either: the reference trains
through ``_flash`` (``src/repro/models/attention.py:90``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
KV_TILE = 1024                      # the plain version's kv tile (_flash's kv chunk)
Q_BLOCK = 512                       # query rows a block of the backward (_flash's q chunk)
HEAD_DIMS = (64, 128)               # the kernel's head widths
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535                 # Hq and B ride gridDim.y and gridDim.z
TMA_ALIGN = 16                      # bytes: the bf16 body loads q, k, v by TMA
# the logits' relative last-bit spread between two implementations (fp32
# sums in another order, exp against ex2.approx: about 2^-20 of p), with room
ROUNDING_REL = 2.0 ** -16


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


def _online_softmax(q, k, v, causal: bool, kv_tile: int, who: str, weigh):
    """The TPU kernel's online softmax, one kv tile at a time, with an fp32
    running max, normaliser and accumulator; ``weigh(p, v_tile)`` gives the
    two factors of the tile's product.  Returns acc / l as (B, S, Hq, D) fp32."""
    B, S, Hq, Hkv, D = _shapes(q, k, v, who)
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
        acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", *weigh(p, vb))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)                  # (B, Hkv, G, S, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, kv_tile: int = KV_TILE) -> torch.Tensor:
    """The TPU kernel's online softmax in PyTorch ops, one kv tile at a time:
    ``_flash``'s arithmetic, except that p is rounded to v's dtype before
    p . v (``src/repro/kernels/flash_attention.py:57``)."""
    out = _online_softmax(q, k, v, causal, kv_tile, "flash_attention_plain",
                          lambda p, vb: (p.to(v.dtype).to(torch.float32), vb))
    return out.to(q.dtype)                                 # the rounding: a no-op for fp32


def flash_attention_rounding_slack(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                   causal: bool = True, kv_tile: int = KV_TILE
                                   ) -> torch.Tensor:
    """How far ``flash_attention_plain``'s bf16 p . v / l can move when its
    logits move in the last bits: one rounding step of every p that lies
    within ``ROUNDING_REL`` (relative) of a rounding midpoint of v's dtype, times
    |v|, over l; (B, S, Hq, D) fp32, zero for fp32 inputs (p not rounded).
    A kernel that forms the same logits in another summation order, or p
    by another exp, may round exactly those p the other way."""
    if v.dtype == torch.float32:
        _shapes(q, k, v, "flash_attention_rounding_slack")
        return torch.zeros(q.shape, dtype=torch.float32, device=q.device)

    def step(p):
        lo, hi = (p * (1 - ROUNDING_REL)).to(v.dtype), (p * (1 + ROUNDING_REL)).to(v.dtype)
        return hi.to(torch.float32) - lo.to(torch.float32)
    return _online_softmax(q, k, v, causal, kv_tile, "flash_attention_rounding_slack",
                           lambda p, vb: (step(p), vb.abs()))


def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def bf16_kv_tile() -> int:
    """The kv tile of the kernel's bf16 body (builds the kernel at first use)."""
    return int(build.load("flash_attention").flash_attention_bf16_kv_tile())


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True) -> torch.Tensor:
    """Launch kernel B4 on CUDA tensors; returns (B, S, Hq, D) in q's dtype.

    D must be 64 or 128 and q, k, v one dtype, fp32 or bf16; bf16 runs on
    the tensor cores and needs 16-byte-aligned q, k and v (after
    ``.contiguous()``), fp32 runs the SIMT body."""
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
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % TMA_ALIGN for t in (q, k, v)):
        raise ValueError("flash_attention_kernel: the bf16 body reads q, k and v by TMA, "
                         f"which needs {TMA_ALIGN}-byte-aligned bases; got byte offsets "
                         f"{[t.data_ptr() % TMA_ALIGN for t in (q, k, v)]}")
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
    build.count_launch(flash_attention_kernel)
    return out


flash_attention_kernel.launches = 0


def flash_attention_grad_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               dout: torch.Tensor, *, causal: bool = True,
                               q_block: int = Q_BLOCK):
    """(dq, dk, dv) of ``_flash``'s function (fp32 softmax, p not rounded)
    at q, k, v for the output gradient ``dout`` (B, S, Hq, D), each in its
    input's dtype.  The scores are recomputed ``q_block`` query rows at a
    time; per block P = softmax(S), dv += P^T dO, dP = dO V^T,
    dS = P (dP - rowsum(P dP)), dq = dS K / sqrt(D), dk += dS^T Q / sqrt(D),
    the kv heads summed over the query heads they serve."""
    B, S, Hq, Hkv, D = _shapes(q, k, v, "flash_attention_grad_plain")
    G = Hq // Hkv
    scale = softmax_scale(D)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dq = torch.empty((B, S, Hq, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, S, Hkv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    cols = torch.arange(S, device=q.device)
    for s0 in range(0, S, q_block):
        s1 = min(S, s0 + q_block)
        qb = q[:, s0:s1].to(torch.float32).reshape(B, s1 - s0, Hkv, G, D)
        dob = dout[:, s0:s1].to(torch.float32).reshape(B, s1 - s0, Hkv, G, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf) * scale
        if causal:
            s = torch.where(cols[s0:s1, None] >= cols[None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)                         # (B, Hkv, G, L, S)
        del s
        dv += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vf)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        del p, dp
        dq[:, s0:s1] = (torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
                        ).reshape(B, s1 - s0, Hq, D)
        dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: B4 (or the plain version, on the CPU)
    forward, ``flash_attention_grad_plain`` backward from the saved inputs.
    The forward rounds p to the input type (the TPU kernel's function);
    the gradient is that of the unrounded attention (``_flash``'s)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal)
        return flash_attention_kernel(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_grad_plain(q, k, v, dout, causal=ctx.causal,
                                                q_block=Q_BLOCK)
        return dq, dk, dv, None
