"""int8 per-row-group wire codec of the streamed stage 1 (numpy copy of
``repro.core.quant``, so the port needs nothing of the JAX package).

Rows are split into groups of ``group`` consecutive rows; each group gets one
(scale, zero) pair:

  * affine (default): scale = (max - min) / 254, zero = the midpoint, so
    q = round((x - zero) / scale) lies in [-127, 127] with no clipping loss;
  * symmetric: zero = 0, scale = absmax / 127, so zero values stay exact.

A constant group gets scale 1.0: every code is 0 and dequantisation returns
the midpoint (or 0) exactly.  The host half (``quantize_rows``) runs in
numpy and gives the reference's codes and tables bit for bit; the device
half is fused into kernel B3's tile loads, and ``dequant_rows`` is its plain
PyTorch form.

Wire cost of one (rows, cols) block: rows * cols bytes of codes plus
8 bytes (fp32 scale + zero) per group.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.kernels.gram import dequant_rows

__all__ = ["GROUP_ROWS", "SCALE_FIELDS", "BYTES_SCALE", "n_groups",
           "quant_bytes", "quant_scale_bytes", "QuantBlock", "group_scales",
           "expand_scales", "encode_rows", "quantize_rows", "dequantize_rows",
           "max_quant_error", "dequant_rows"]

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


def encode_rows(x: np.ndarray, row_scales: np.ndarray) -> np.ndarray:
    """int8 codes of (n, p) fp32 rows under a per-row (n, 2) scale table."""
    q = np.rint((x - row_scales[:, 1:2]) / row_scales[:, 0:1])
    return np.clip(q, -127, 127).astype(np.int8)


def quantize_rows(x: np.ndarray, group: int = GROUP_ROWS, *,
                  symmetric: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Quantise a (n, p) fp32 block to (int8 values, (ng, 2) fp32 scales)."""
    x = np.ascontiguousarray(x, np.float32)
    scales = group_scales(x, group, symmetric=symmetric)
    if x.shape[0] == 0:
        return np.zeros((0, x.shape[1]), np.int8), scales
    return encode_rows(x, expand_scales(scales, group, x.shape[0])), scales


def dequantize_rows(values: np.ndarray, scales: np.ndarray,
                    group: int = GROUP_ROWS) -> np.ndarray:
    """Host (numpy) dequantisation, the codec's oracle."""
    n = values.shape[0]
    s = np.repeat(scales[:, 0], group)[:n, None]
    z = np.repeat(scales[:, 1], group)[:n, None]
    return values.astype(np.float32) * s + z


def max_quant_error(scales: np.ndarray) -> float:
    """Worst-case absolute reconstruction error promised by a scale table."""
    return float(0.5 * scales[:, 0].max()) if scales.size else 0.0
