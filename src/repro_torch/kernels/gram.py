"""Kernels B1 and B3, the batch kernel (gram) matrix: CUDA launches and plain
versions.

``gram_kernel`` launches B1 in ``csrc/gram.cu`` (it replaces the TPU kernel
``src/repro/kernels/gram.py:70``, ``gram_pallas``); ``gram_q8_kernel``
launches B3, the same body with x arriving as int8 codes and the compact
scale table of the int8 codec (it replaces ``gram_pallas_q8``,
``src/repro/kernels/gram.py:157``).  ``gram_plain`` / ``gram_q8_plain`` are
the same functions in PyTorch ops, the reference's arithmetic written out.
The plain versions serve CPU tensors and the comparisons; nothing on the CUDA
path calls them.  ``params`` is any object with ``kind``, ``gamma``,
``coef0`` and ``degree`` (``core.kernel_fn.KernelParams``).
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


def dequant_rows(values: torch.Tensor, scales: torch.Tensor,
                 group: int) -> torch.Tensor:
    """int8 codes (n, p) and the compact (ceil(n / group), 2) scale / zero
    table -> fp32 rows: x = q * scale + zero, each group's entry repeated
    over its rows (the codec's device half, ``core/quant.py``)."""
    n = values.shape[0]
    s = scales.to(torch.float32).repeat_interleave(group, dim=0)[:n]
    return values.to(torch.float32) * s[:, :1] + s[:, 1:]


def gram_q8_plain(values: torch.Tensor, scales: torch.Tensor, z: torch.Tensor,
                  params, group: int) -> torch.Tensor:
    """K(dequant(values, scales), z) in plain PyTorch."""
    return gram_plain(dequant_rows(values, scales, group), z, params)


def _launcher(name: str, argtypes):
    fn = getattr(build.load("gram"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GRAM_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P]
_GRAM_Q8_ARGS = [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P]


def _check_grid(name: str, n: int, m: int, p: int) -> None:
    if -(-m // 128) > MAX_TILES or max(n, m, p) >= 2 ** 31:
        raise ValueError(f"{name}: ({n}, {m}, {p}) exceeds the launch grid")


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
    _check_grid("gram_kernel", n, m, p)
    x = x.contiguous()
    z = z.contiguous()
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    norms = torch.empty((n + m,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher("gram_launch", _GRAM_ARGS)(
            x.data_ptr(), z.data_ptr(), norms.data_ptr(), norms[n:].data_ptr(),
            out.data_ptr(), n, m, p, KERNELS.index(params.kind),
            float(params.gamma), float(params.coef0), int(params.degree), stream)
    if err != 0:
        raise RuntimeError(f"gram_kernel: launch failed with CUDA error {err}")
    gram_kernel.launches += 1
    return out


gram_kernel.launches = 0


def gram_q8_kernel(values: torch.Tensor, scales: torch.Tensor, z: torch.Tensor,
                   params, group: int) -> torch.Tensor:
    """Launch kernel B3 on CUDA tensors: int8 codes (n, p), the compact
    (ceil(n / group), 2) fp32 scale table and fp32 z (m, p); returns the
    (n, m) fp32 matrix.  Ragged n, m and p are masked in the kernel, so any
    codec (affine or symmetric) gives K(dequant(values), z)."""
    if not (values.is_cuda and scales.is_cuda and z.is_cuda
            and values.device == scales.device == z.device):
        raise ValueError("gram_q8_kernel: values, scales and z must be CUDA "
                         "tensors on one device")
    if values.dtype != torch.int8 or scales.dtype != torch.float32 \
            or z.dtype != torch.float32:
        raise TypeError(f"gram_q8_kernel: int8 values and fp32 scales and z, got "
                        f"{values.dtype}, {scales.dtype} and {z.dtype}")
    if values.ndim != 2 or z.ndim != 2 or values.shape[1] != z.shape[1]:
        raise ValueError(f"gram_q8_kernel: shapes {tuple(values.shape)} and "
                         f"{tuple(z.shape)}")
    n, p = values.shape
    m = z.shape[0]
    if group < 1 or tuple(scales.shape) != (-(-n // group), 2):
        raise ValueError(f"gram_q8_kernel: scales {tuple(scales.shape)} do not "
                         f"cover {n} rows in groups of {group}")
    _check_grid("gram_q8_kernel", n, m, p)
    values = values.contiguous()
    scales = scales.contiguous()
    z = z.contiguous()
    out = torch.empty((n, m), dtype=torch.float32, device=z.device)
    norms = torch.empty((n + m,), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher("gram_q8_launch", _GRAM_Q8_ARGS)(
            values.data_ptr(), scales.data_ptr(), int(group), z.data_ptr(),
            norms.data_ptr(), norms[n:].data_ptr(), out.data_ptr(), n, m, p,
            KERNELS.index(params.kind), float(params.gamma),
            float(params.coef0), int(params.degree), stream)
    if err != 0:
        raise RuntimeError(f"gram_q8_kernel: launch failed with CUDA error {err}")
    gram_q8_kernel.launches += 1
    return out


gram_q8_kernel.launches = 0
