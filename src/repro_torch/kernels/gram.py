"""Kernels B1 and B3, the batch kernel (gram) matrix: CUDA launches and plain
versions.

``gram_kernel`` launches B1 in ``csrc/gram.cu`` on the tensor cores (it
replaces the TPU kernel ``src/repro/kernels/gram.py:70``, ``gram_pallas``);
``gram_q8_kernel`` launches B3 in ``csrc/gram_q8.cu``, the same function
with x arriving as int8 codes and the compact scale table of the int8
codec (it replaces ``gram_pallas_q8``, ``src/repro/kernels/gram.py:157``).
Both take z split exactly into three bf16 pieces by a pre-pass
(``csrc/gram_tc.cuh``); B1 splits x the same way in registers.
``gram_plain`` / ``gram_q8_plain`` are the same functions in PyTorch ops,
the reference's arithmetic written out.  The plain versions serve CPU
tensors and the comparisons; nothing on the CUDA path calls them.
``split_bf16x3`` is that split in PyTorch, for the tests and
``chip_smoke.py``.  ``params`` is any object
with ``kind``, ``gamma``, ``coef0`` and ``degree``
(``core.kernel_fn.KernelParams``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KERNELS = ("rbf", "linear", "poly", "tanh")   # index = kind code in gram.cu
# rows of x, rows of z, k per tile: BM, BN and BK of csrc/gram.cu (B1) and
# csrc/gram_q8.cu (B3); tests/test_torch_gram.py and test_torch_gram_q8.py
# hold each equal to its source
B1_TILE = (128, 128, 64)
Q8_TILE = (192, 64, 64)


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


def split_bf16x3(z: torch.Tensor):
    """The pre-pass's split in PyTorch (B1 splits x alike): each row of fp32
    z (m, p) scaled by 2^-e_j, which brings its largest |z| into [1, 2), then
    split into three bf16 pieces w1 = bf16(w), w2 = bf16(w - w1),
    w3 = bf16(w - w1 - w2).  Returns the pieces (3, m, p) bf16 and the powers 2^e_j (m,) fp32, so that
    (w1 + w2 + w3) 2^e_j == z exactly for every element within 2^110 of its
    row's largest (subnormals included; a zero may come back as +0).  A row
    that is all zero or holds an infinity keeps e_j = 0."""
    z = z.to(torch.float32)
    # the largest |z| of each row, NaN ignored (as the kernel's fmaxf does)
    mag = z.abs().masked_fill(z.isnan(), 0.0)
    mag = mag.amax(dim=1) if z.shape[1] else mag.new_zeros(z.shape[0])
    e = torch.frexp(mag.double())[1] - 1
    e = torch.where((mag > 0) & torch.isfinite(mag), e, torch.zeros_like(e))
    w = (z.double() * torch.pow(2.0, -e.double())[:, None]).float()   # exact
    w1 = w.to(torch.bfloat16)
    r1 = w - w1.float()
    w2 = r1.to(torch.bfloat16)
    w3 = (r1 - w2.float()).to(torch.bfloat16)
    return torch.stack([w1, w2, w3]), torch.pow(2.0, e.double()).float()


def _launcher(lib: str, name: str, argtypes):
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GRAM_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P]
_GRAM_Q8_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P]
_SPLIT_ARGS = [_P, _P, _P, _I, _I, _I, _P]


def _padded(p: int) -> int:
    """The pieces' width: p rounded up to the k tile (at least one tile)."""
    k = B1_TILE[2]
    return max(1, -(-p // k)) * k


def _check_grid(name: str, tile, n: int, m: int, p: int) -> None:
    """B1's and B3's grids are one dimension of (x tile, z tile) pairs."""
    bm, bn, _ = tile
    if -(-n // bm) * -(-m // bn) >= 2 ** 31 or max(n, m, _padded(p)) >= 2 ** 31:
        raise ValueError(f"{name}: ({n}, {m}, {p}) exceeds the launch grid")


def gram_kernel(x: torch.Tensor, z: torch.Tensor, params) -> torch.Tensor:
    """Launch kernel B1 on CUDA tensors; returns the (n, m) fp32 matrix.
    Ragged n, m and p are masked in the kernel.  Its scratch, z's pieces
    (3, m, p rounded up to 64) bf16, 3 m fp32 and 2 n + m fp64 of row
    tables, is allocated here, per call."""
    if not (x.is_cuda and z.is_cuda and x.device == z.device):
        raise ValueError("gram_kernel: x and z must be CUDA tensors on one device")
    if x.dtype != torch.float32 or z.dtype != torch.float32:
        raise TypeError(f"gram_kernel: fp32 only, got {x.dtype} and {z.dtype}")
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1]:
        raise ValueError(f"gram_kernel: shapes {tuple(x.shape)} and {tuple(z.shape)}")
    n, p = x.shape
    m = z.shape[0]
    _check_grid("gram_kernel", B1_TILE, n, m, p)
    x = x.contiguous()
    z = z.contiguous()
    p_pad = _padded(p)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    pieces = torch.empty((3, m, p_pad), dtype=torch.bfloat16, device=x.device)
    zcol = torch.empty((3 * m,), dtype=torch.float32, device=x.device)
    xcol = torch.empty((2 * n + m,), dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher("gram", "gram_launch", _GRAM_ARGS)(
            x.data_ptr(), z.data_ptr(), pieces.data_ptr(), zcol.data_ptr(),
            xcol.data_ptr(), out.data_ptr(), n, m, p, p_pad,
            KERNELS.index(params.kind), float(params.gamma), float(params.coef0),
            int(params.degree), stream)
    if err != 0:
        raise RuntimeError(f"gram_kernel: launch failed with CUDA error {err}")
    build.count_launch(gram_kernel)
    return out


gram_kernel.launches = 0


def gram_q8_kernel(values: torch.Tensor, scales: torch.Tensor, z: torch.Tensor,
                   params, group: int) -> torch.Tensor:
    """Launch kernel B3 on CUDA tensors: int8 codes (n, p), the compact
    (ceil(n / group), 2) fp32 scale table and fp32 z (m, p); returns the
    (n, m) fp32 matrix.  Ragged n, m and p are masked in the kernel, so any
    codec (affine or symmetric) gives K(dequant(values), z).  Its scratch,
    z's pieces (3, m, p rounded up to 64) bf16 and (3 m + n) fp32 of row
    tables, is allocated here, per call."""
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
    _check_grid("gram_q8_kernel", Q8_TILE, n, m, p)
    values = values.contiguous()
    scales = scales.contiguous()
    z = z.contiguous()
    p_pad = _padded(p)
    out = torch.empty((n, m), dtype=torch.float32, device=z.device)
    pieces = torch.empty((3, m, p_pad), dtype=torch.bfloat16, device=z.device)
    tables = torch.empty((3 * m + n,), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher("gram_q8", "gram_q8_launch", _GRAM_Q8_ARGS)(
            values.data_ptr(), scales.data_ptr(), int(group), z.data_ptr(),
            pieces.data_ptr(), tables.data_ptr(), tables[3 * m:].data_ptr(),
            out.data_ptr(), n, m, p, p_pad, KERNELS.index(params.kind),
            float(params.gamma), float(params.coef0), int(params.degree), stream)
    if err != 0:
        raise RuntimeError(f"gram_q8_kernel: launch failed with CUDA error {err}")
    build.count_launch(gram_q8_kernel)
    return out


gram_q8_kernel.launches = 0


def piece_order(p_pad: int) -> torch.Tensor:
    """The k that position P of the pieces holds (the inverse of
    ``position`` in gram_tc.cuh, for B1 and B3): column c of k16 step kk of
    a 64-wide k tile holds element 16 ((c % 8) // 2) + 4 kk + c % 2 + 2 (c // 8)
    of the tile."""
    P = torch.arange(p_pad)
    r = P % B1_TILE[2]
    kk, c = r // 16, r % 16
    return P - r + 16 * ((c % 8) // 2) + 4 * kk + c % 2 + 2 * (c // 8)


def split_bf16x3_kernel(z: torch.Tensor):
    """B3's pre-pass alone on CUDA fp32 z (m, p): the pieces (3, m, p_pad)
    bf16 put back in k order (the kernel keeps them in ``piece_order``), zero
    from p on, and the powers 2^e_j (m,), as ``split_bf16x3`` gives them.
    For the tests and ``chip_smoke.py``; not a launch of B3."""
    if not z.is_cuda or z.dtype != torch.float32 or z.ndim != 2:
        raise ValueError("split_bf16x3_kernel: a 2-D fp32 CUDA tensor")
    m, p = z.shape
    _check_grid("split_bf16x3_kernel", Q8_TILE, 1, m, p)
    z = z.contiguous()
    p_pad = _padded(p)
    pieces = torch.empty((3, m, p_pad), dtype=torch.bfloat16, device=z.device)
    tables = torch.empty((3 * m,), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher("gram_q8", "gram_q8_split_launch", _SPLIT_ARGS)(
            z.data_ptr(), pieces.data_ptr(), tables.data_ptr(), m, p, p_pad, stream)
    if err != 0:
        raise RuntimeError(f"split_bf16x3_kernel: launch failed with CUDA error {err}")
    in_order = torch.empty_like(pieces)
    in_order[:, :, piece_order(p_pad).to(z.device)] = pieces
    return in_order, tables[2 * m:]
