"""int8 per-row-group wire codec of the streamed stages (numpy copy of
``repro.core.quant``, so the port needs nothing of the JAX package).

Rows are split into groups of ``group`` consecutive rows; each group gets one
(scale, zero) pair:

  * affine (default): scale = (max - min) / 254, zero = the midpoint, so
    q = round((x - zero) / scale) lies in [-127, 127] with no clipping loss;
  * symmetric: zero = 0, scale = absmax / 127, so zero values stay exact.

A constant group gets scale 1.0: every code is 0 and dequantisation returns
the midpoint (or 0) exactly.  The host half (``quantize_rows``,
``quantize_block``) runs in numpy and gives the reference's codes and tables
bit for bit.  The device half is fused into kernel B3's tile loads in stage
1, and ``dequant_rows`` is its plain PyTorch form; stage 2's int8 G blocks
are decoded on the card by ``dequant_into`` (the reference's jnp
``dequant_rows``, an elementwise pass and not a kernel of its own) before
kernel B2 reads them.

Wire cost of one (rows, cols) block: rows * cols bytes of codes plus
8 bytes (fp32 scale + zero) per group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.gram import dequant_rows

__all__ = ["GROUP_ROWS", "SCALE_FIELDS", "BYTES_SCALE", "n_groups",
           "quant_bytes", "quant_scale_bytes", "QuantBlock", "group_scales",
           "expand_scales", "encode_rows", "quantize_rows", "quantize_block",
           "dequantize_rows", "dequantize_rows_range", "max_quant_error",
           "dequant_rows", "dequant_into"]

GROUP_ROWS = 32           # rows per scale group (the reference's default)
SCALE_FIELDS = 2          # (scale, zero) per group, both fp32
BYTES_SCALE = SCALE_FIELDS * 4


def n_groups(rows: int, group: int = GROUP_ROWS) -> int:
    return -(-rows // group)


def quant_bytes(rows: int, cols: int, group: int = GROUP_ROWS) -> int:
    """Total wire bytes of one quantised (rows, cols) block, scales included."""
    return rows * cols + n_groups(rows, group) * BYTES_SCALE


def quant_scale_bytes(rows: int, group: int = GROUP_ROWS) -> int:
    """Just the scale-table bytes of one quantised block."""
    return n_groups(rows, group) * BYTES_SCALE


@dataclasses.dataclass(frozen=True)
class QuantBlock:
    """One quantised wire block: int8 codes and the (ng, 2) fp32 table."""

    values: np.ndarray            # (rows, cols) int8
    scales: np.ndarray            # (ng, 2) fp32: [:, 0] scale, [:, 1] zero
    group: int = GROUP_ROWS

    @property
    def nbytes(self) -> int:
        return self.values.nbytes + self.scales.nbytes

    @property
    def scale_bytes(self) -> int:
        return self.scales.nbytes

    @property
    def shape(self):
        return self.values.shape


def group_scales(x: np.ndarray, group: int = GROUP_ROWS, *,
                 symmetric: bool = False) -> np.ndarray:
    """Per-row-group (scale, zero) table of a (n, p) fp32 block: (ng, 2)."""
    x = np.ascontiguousarray(x, np.float32)
    n = x.shape[0]
    if n == 0:
        return np.zeros((0, SCALE_FIELDS), np.float32)
    ng = n_groups(n, group)
    starts = np.arange(0, n, group)
    mn = np.minimum.reduceat(x.min(axis=1), starts)
    mx = np.maximum.reduceat(x.max(axis=1), starts)
    if symmetric:
        scale = np.maximum(np.abs(mn), np.abs(mx)) / 127.0
        zero = np.zeros((ng,), np.float32)
    else:
        scale = (mx - mn) / 254.0
        zero = (0.5 * (mx + mn)).astype(np.float32)
    scale = np.where(scale > 0.0, scale, 1.0).astype(np.float32)
    return np.stack([scale, zero], axis=1).astype(np.float32)


def expand_scales(scales: np.ndarray, group: int, n: int) -> np.ndarray:
    """(ng, 2) group table -> (n, 2) per-row table."""
    return np.repeat(scales, group, axis=0)[:n]


ENCODE_ROWS = 1024        # rows encoded at a time: the temporaries stay in cache


def encode_rows(x: np.ndarray, row_scales: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """int8 codes of (n, p) fp32 rows under a per-row (n, 2) scale table:
    clip(rint((x - zero) / scale), -127, 127), the reference's arithmetic,
    ``ENCODE_ROWS`` rows at a time into ``out`` (allocated when None)."""
    n, p = x.shape
    out = np.empty((n, p), np.int8) if out is None else out
    tmp = np.empty((min(ENCODE_ROWS, n), p), np.float32)
    for s in range(0, n, ENCODE_ROWS):
        e = min(s + ENCODE_ROWS, n)
        t = tmp[:e - s]
        np.subtract(x[s:e], row_scales[s:e, 1:2], out=t)
        np.divide(t, row_scales[s:e, 0:1], out=t)
        np.rint(t, out=t)
        np.clip(t, -127, 127, out=t)
        np.copyto(out[s:e], t, casting="unsafe")
    return out


def quantize_rows(x: np.ndarray, group: int = GROUP_ROWS, *,
                  symmetric: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Quantise a (n, p) fp32 block to (int8 values, (ng, 2) fp32 scales)."""
    x = np.ascontiguousarray(x, np.float32)
    scales = group_scales(x, group, symmetric=symmetric)
    if x.shape[0] == 0:
        return np.zeros((0, x.shape[1]), np.int8), scales
    return encode_rows(x, expand_scales(scales, group, x.shape[0])), scales


def quantize_block(x: np.ndarray, group: int = GROUP_ROWS, *,
                   symmetric: bool = False) -> QuantBlock:
    v, s = quantize_rows(x, group, symmetric=symmetric)
    return QuantBlock(values=v, scales=s, group=group)


def dequantize_rows(values: np.ndarray, scales: np.ndarray,
                    group: int = GROUP_ROWS) -> np.ndarray:
    """Host (numpy) dequantisation, the codec's oracle."""
    n = values.shape[0]
    s = np.repeat(scales[:, 0], group)[:n, None]
    z = np.repeat(scales[:, 1], group)[:n, None]
    return values.astype(np.float32) * s + z


def dequantize_rows_range(values: np.ndarray, scales: np.ndarray, lo: int,
                          hi: int, group: int = GROUP_ROWS) -> np.ndarray:
    """Host dequantisation of rows [lo, hi) only, touching just the scale
    groups that overlap them: ``dequantize_rows(values, scales, group)[lo:hi]``."""
    lo = max(0, lo)
    hi = min(values.shape[0], hi)
    if hi <= lo:
        return np.zeros((0, values.shape[1]), np.float32)
    g0 = lo // group
    sub = np.repeat(scales[g0:n_groups(hi, group)], group, axis=0)
    s = sub[lo - g0 * group:lo - g0 * group + (hi - lo)]
    return values[lo:hi].astype(np.float32) * s[:, 0:1] + s[:, 1:2]


def dequant_into(values: torch.Tensor, scales: torch.Tensor, group: int,
                 out: torch.Tensor) -> torch.Tensor:
    """``dequant_rows(values, scales, group)`` written into ``out`` (fp32,
    the shape of ``values``), with no fp32 temporary of the block: the same
    two roundings, x = fp32(q) * scale, then + zero."""
    s = scales.repeat_interleave(group, dim=0)[:values.shape[0]]
    torch.mul(values, s[:, :1], out=out)
    return out.add_(s[:, 1:])


def max_quant_error(scales: np.ndarray) -> float:
    """Worst-case absolute reconstruction error promised by a scale table."""
    return float(0.5 * scales[:, 0].max()) if scales.size else 0.0
