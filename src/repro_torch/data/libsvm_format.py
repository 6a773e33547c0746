"""LIBSVM sparse text format reader / writer (numpy port of
``repro.data.libsvm_format``; the port keeps its own copy, the results are
the same bit for bit).

The paper's data sets ship in this format.  The card's tensor cores want
dense tiles, so the data is ingested sparse and densified a block at a time:
a CSR triple is kept, and the densify-block-by-block path never materialises
the full dense matrix for wide data.

Two out-of-core ingest paths feed ``core.streaming.stream_factor_blocks``:

  * ``CSRData.iter_dense_blocks(rows)``: the CSR triple fits host RAM and
    blocks are densified on their way to the card
    (``core.streaming.compute_factor_streamed_csr``);
  * ``read_libsvm_blocks(path, rows, n_features)``: even the CSR does not;
    the file is parsed chunkwise and each (dense rows, labels) block is
    yielded without any global structure being built.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Tuple

import numpy as np


def _scatter_dense(n_rows: int, n_features: int, indptr: np.ndarray,
                   indices: np.ndarray, values: np.ndarray) -> np.ndarray:
    """One flat scatter instead of a per-row Python loop (ingest hot path)."""
    out = np.zeros((n_rows, n_features), dtype=np.float32)
    if len(indices):
        if indices.max() >= n_features:
            raise ValueError(
                f"feature index {int(indices.max()) + 1} exceeds "
                f"n_features={n_features}")
        rows = np.repeat(np.arange(n_rows, dtype=np.int64),
                         np.diff(indptr).astype(np.int64))
        out.ravel()[rows * n_features + indices] = values
    return out


@dataclasses.dataclass
class CSRData:
    indptr: np.ndarray    # (n+1,) int64
    indices: np.ndarray   # (nnz,) int32
    values: np.ndarray    # (nnz,) float32
    n_features: int
    labels: np.ndarray    # (n,) float64 (raw labels as written)

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    def densify(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        stop = self.n if stop is None else min(stop, self.n)
        lo, hi = int(self.indptr[start]), int(self.indptr[stop])
        return _scatter_dense(stop - start, self.n_features,
                              self.indptr[start:stop + 1] - lo,
                              self.indices[lo:hi], self.values[lo:hi])

    def densify_rows(self, rows) -> np.ndarray:
        """Gather arbitrary rows (any order) to dense: landmark selection."""
        rows = np.asarray(rows)
        out = np.zeros((len(rows), self.n_features), dtype=np.float32)
        for i, r in enumerate(rows):
            lo, hi = int(self.indptr[r]), int(self.indptr[r + 1])
            out[i, self.indices[lo:hi]] = self.values[lo:hi]
        return out

    def iter_dense_blocks(self, rows: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (dense rows, labels) blocks of at most ``rows`` rows; feeds
        ``core.streaming.stream_factor_blocks`` so stage 1 never materialises
        the full dense (n, p) matrix."""
        if rows < 1:
            raise ValueError("rows must be positive")
        for s in range(0, self.n, rows):
            e = min(s + rows, self.n)
            yield self.densify(s, e), self.labels[s:e]


class BadRowError(ValueError):
    """A malformed or non-finite LIBSVM line under ``on_bad_row="raise"``."""


@dataclasses.dataclass
class IngestStats:
    """Row accounting for validated ingest (filled in place when passed to a
    reader): streamed training jobs surface how much input was dropped instead
    of silently folding NaN rows into G."""

    rows_read: int = 0
    rows_skipped: int = 0


# _parse_line outcome codes
_BLANK, _DATA, _SKIPPED = 0, 1, 2


def _parse_line(line: str, lineno: int, labels, indices, values,
                on_bad_row: str = "raise") -> Tuple[int, int]:
    """Parse one `label idx:val ...` line into the accumulators; returns
    (outcome code, max feature index seen + 1).

    Malformed tokens, 0-based indices and non-finite labels / values either
    raise ``BadRowError`` (``on_bad_row="raise"``, the default) or drop the
    ROW atomically (``"skip"``: partially parsed values are rolled back, so a
    bad tail never leaves a half-row in the CSR accumulators).
    """
    line = line.strip()
    if not line or line.startswith("#"):
        return _BLANK, 0
    n0 = len(indices)
    parts = line.split()
    try:
        lab = float(parts[0])
        if not math.isfinite(lab):
            raise ValueError(f"non-finite label {parts[0]!r}")
        hi = 0
        for tok in parts[1:]:
            i, sep, v = tok.partition(":")
            if not sep:
                raise ValueError(f"malformed token {tok!r} (expected idx:val)")
            idx = int(i) - 1
            if idx < 0:
                raise ValueError(f"feature index {i!r} is not 1-based")
            val = float(v)
            if not math.isfinite(val):
                raise ValueError(f"non-finite value in token {tok!r}")
            if idx >= hi:
                hi = idx + 1
            indices.append(idx)
            values.append(val)
    except ValueError as exc:
        del indices[n0:], values[n0:]   # atomic row rollback
        if on_bad_row == "skip":
            return _SKIPPED, 0
        raise BadRowError(f"line {lineno}: {exc}") from None
    labels.append(lab)
    return _DATA, hi


def _check_bad_row_mode(on_bad_row: str) -> None:
    if on_bad_row not in ("raise", "skip"):
        raise ValueError(f"on_bad_row must be 'raise' or 'skip', "
                         f"got {on_bad_row!r}")


def read_libsvm(path: str, n_features: Optional[int] = None,
                on_bad_row: str = "raise",
                stats: Optional[IngestStats] = None) -> CSRData:
    """Parse `label idx:val idx:val ...` lines (1-based indices).

    ``on_bad_row``: "raise" (default) raises ``BadRowError`` naming the line;
    "skip" drops bad rows and counts them in ``stats.rows_skipped`` (pass an
    ``IngestStats`` to read the counter back).
    """
    _check_bad_row_mode(on_bad_row)
    st = stats if stats is not None else IngestStats()
    labels, indptr, indices, values = [], [0], [], []
    max_idx = 0
    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            out, hi = _parse_line(line, lineno, labels, indices, values,
                                  on_bad_row)
            if out == _DATA:
                st.rows_read += 1
                max_idx = max(max_idx, hi)
                indptr.append(len(indices))
            elif out == _SKIPPED:
                st.rows_skipped += 1
    nf = n_features if n_features is not None else max_idx
    return CSRData(
        indptr=np.asarray(indptr, np.int64),
        indices=np.asarray(indices, np.int32),
        values=np.asarray(values, np.float32),
        n_features=nf,
        labels=np.asarray(labels),
    )


def read_libsvm_blocks(path: str, rows: int, n_features: int,
                       on_bad_row: str = "raise",
                       stats: Optional[IngestStats] = None,
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream a LIBSVM file as (dense rows, labels) blocks of ``rows`` rows.

    Nothing global is ever built, so data sets larger than host RAM stream
    through stage 1 directly.  ``n_features`` must be given (the global
    largest index is unknown until the end of a single pass).  Validation is
    ``read_libsvm``'s: with ``on_bad_row="skip"`` a bad line shrinks the
    block instead of poisoning G with NaN rows, and ``stats.rows_skipped``
    keeps the count.
    """
    if rows < 1:
        raise ValueError("rows must be positive")
    _check_bad_row_mode(on_bad_row)
    st = stats if stats is not None else IngestStats()

    def emit(labels, indptr, indices, values):
        dense = _scatter_dense(len(labels), n_features,
                               np.asarray(indptr, np.int64),
                               np.asarray(indices, np.int32),
                               np.asarray(values, np.float32))
        return dense, np.asarray(labels)

    labels, indptr, indices, values = [], [0], [], []
    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            out, _ = _parse_line(line, lineno, labels, indices, values,
                                 on_bad_row)
            if out == _DATA:
                st.rows_read += 1
                indptr.append(len(indices))
            elif out == _SKIPPED:
                st.rows_skipped += 1
            if len(labels) == rows:
                yield emit(labels, indptr, indices, values)
                labels, indptr, indices, values = [], [0], [], []
    if labels:
        yield emit(labels, indptr, indices, values)


def read_libsvm_rows_range(path: str, lo: int, hi: int, n_features: int,
                           on_bad_row: str = "raise",
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ONLY data rows [lo, hi) (row numbers after skipping) to dense.

    The shard store's rebuild path: when one shard fails its checksum, just
    that shard's row range is parsed again from the source text, not the
    whole file.  Row numbering matches the streamed ingest exactly: blank and
    comment lines do not count, and with ``on_bad_row="skip"`` neither do
    dropped rows, so row i here is row i of ``read_libsvm_blocks``' output.
    Returns (dense (hi-lo, n_features) f32, labels (hi-lo,) f64).
    """
    _check_bad_row_mode(on_bad_row)
    if lo < 0 or hi < lo:
        raise ValueError(f"bad row range [{lo}, {hi})")
    labels, indptr, indices, values = [], [0], [], []
    seen = 0
    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            if seen >= hi:
                break
            out, _ = _parse_line(line, lineno, labels, indices, values,
                                 on_bad_row)
            if out != _DATA:
                continue
            seen += 1
            if seen <= lo:
                # before the window: drop the parsed row again
                del labels[:], indices[:], values[:]
                continue
            indptr.append(len(indices))
    if seen < hi:
        raise ValueError(f"row range [{lo}, {hi}) exceeds the {seen} data "
                         f"rows in {path}")
    dense = _scatter_dense(len(labels), n_features,
                           np.asarray(indptr, np.int64),
                           np.asarray(indices, np.int32),
                           np.asarray(values, np.float32))
    return dense, np.asarray(labels)


def count_libsvm_rows(path: str) -> int:
    """Cheap first pass: number of data rows (landmark sampling needs n)."""
    n = 0
    with open(path, "r") as f:
        for line in f:
            s = line.strip()
            if s and not s.startswith("#"):
                n += 1
    return n


def write_libsvm(path: str, x: np.ndarray, y: np.ndarray,
                 drop_zeros: bool = True) -> None:
    """Write rows as `label idx:val ...` lines, values in ``%g``; with
    ``drop_zeros`` only the nonzero (or NaN) elements are visited."""
    with open(path, "w") as f:
        for row, label in zip(np.asarray(x), np.asarray(y)):
            cols = np.flatnonzero(row != 0.0) if drop_zeros else np.arange(len(row))
            # Python scalars format several times faster than numpy's
            toks = [f"{label:g}"] + [f"{j + 1}:{v:g}" for j, v in
                                     zip(cols.tolist(), row[cols].tolist())]
            f.write(" ".join(toks) + "\n")
