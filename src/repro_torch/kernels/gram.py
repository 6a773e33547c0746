"""Kernel B1, the batch kernel (gram) matrix: CUDA launch and plain version.

``gram_kernel`` launches ``csrc/gram.cu`` (it replaces the TPU kernel
``src/repro/kernels/gram.py:70``, ``gram_pallas``); ``gram_plain`` is the same
function in PyTorch ops, the reference's arithmetic written out.  The plain
version serves CPU tensors and the comparisons; nothing on the CUDA path calls
it.  ``params`` is any object with ``kind``, ``gamma``, ``coef0`` and
``degree`` (``core.kernel_fn.KernelParams``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KERNELS = ("rbf", "linear", "poly", "tanh")   # index = kind code in gram.cu
MAX_TILES = 65535                             # gridDim.y limit, 128 z rows each


def apply_epilogue(dot: torch.Tensor, x_sq: torch.Tensor, z_sq: torch.Tensor,
                   params) -> torch.Tensor:
    """Turn a block of inner products (n, m) into kernel values."""
    if params.kind == "linear":
        return dot
    if params.kind == "rbf":
        d2 = x_sq[:, None] + z_sq[None, :] - 2.0 * dot
        return torch.exp(-params.gamma * torch.clamp(d2, min=0.0))
    if params.kind == "poly":
        return (params.gamma * dot + params.coef0) ** params.degree
    if params.kind == "tanh":
        return torch.tanh(params.gamma * dot + params.coef0)
    raise ValueError(params.kind)


def gram_plain(x: torch.Tensor, z: torch.Tensor, params) -> torch.Tensor:
    """K[i, j] = k(x_i, z_j) in plain PyTorch (full fp32 product)."""
    x = x.to(torch.float32)
    z = z.to(torch.float32)
    dot = x @ z.T
    return apply_epilogue(dot, (x * x).sum(-1), (z * z).sum(-1), params)


def _launcher():
    fn = build.load("gram").gram_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def gram_kernel(x: torch.Tensor, z: torch.Tensor, params) -> torch.Tensor:
    """Launch kernel B1 on CUDA tensors; returns the (n, m) fp32 matrix."""
    if not (x.is_cuda and z.is_cuda and x.device == z.device):
        raise ValueError("gram_kernel: x and z must be CUDA tensors on one device")
    if x.dtype != torch.float32 or z.dtype != torch.float32:
        raise TypeError(f"gram_kernel: fp32 only, got {x.dtype} and {z.dtype}")
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1]:
        raise ValueError(f"gram_kernel: shapes {tuple(x.shape)} and {tuple(z.shape)}")
    n, p = x.shape
    m = z.shape[0]
    if -(-m // 128) > MAX_TILES or max(n, m, p) >= 2 ** 31:
        raise ValueError(f"gram_kernel: ({n}, {m}, {p}) exceeds the launch grid")
    x = x.contiguous()
    z = z.contiguous()
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    norms = torch.empty((n + m,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            x.data_ptr(), z.data_ptr(), norms.data_ptr(), norms[n:].data_ptr(),
            out.data_ptr(), n, m, p, KERNELS.index(params.kind),
            float(params.gamma), float(params.coef0), int(params.degree), stream)
    if err != 0:
        raise RuntimeError(f"gram_kernel: launch failed with CUDA error {err}")
    gram_kernel.launches += 1
    return out


gram_kernel.launches = 0
