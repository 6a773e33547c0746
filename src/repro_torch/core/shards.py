"""The disk tier: a checksummed binary shard store (PyTorch port of
``repro.core.shards``; it imports nothing of the JAX package).

The paper's "more RAM!" is a memory hierarchy; this module takes it one tier
below host RAM.  LIBSVM text is parsed once into binary shards, and every
later run streams those shards (``open_or_ingest``); stage 1 can spill G
into f32 shards (``ShardSpillSink``), so that the streamed stage 2 reads G
from disk (``GShardView``) where host RAM cannot hold an (n, B') G.

  * Every write is atomic: a shard file and the manifest are written to a
    temporary file, fsynced, then ``os.replace``d, and the manifest is
    written last.  A kill at any point leaves a whole store or no manifest.
  * Every read is verified: each shard ends in an 8-byte digest of its
    header and payload, and the manifest pins each shard's digest and a
    whole-store fingerprint.  A torn, rotten or stale file is found on its
    first read.
  * Corruption is recoverable: a mismatch moves the file under
    ``quarantine/`` and, with a ``rebuilder`` attached, makes the shard again
    from its source (that row range of the LIBSVM text, or those rows of G)
    and checks that the rebuild reproduces the manifest's digest.  A failed
    checksum with no rebuilder raises.  Transient IO errors are retried
    (``faults.classify_error``).
  * Every fault is injectable: the sites ``shard_write``, ``shard_read`` and
    ``shard_corrupt`` of ``core/faults.py`` (the last flips a byte of the
    file in place, for the checksum to catch).

Shard file layout (fixed offsets, the reference's byte for byte up to the
footer)::

    [0:64)    header "<8sIIQQQQQQ": magic "LPDSHRD1", version 1, dtype code
              (0 f32, 1 int8), rows, cols, group, the byte counts of the
              values, scales and labels sections
    [64:...)  values   rows * cols of f32 or int8
              scales   (ng, 2) f32 (scale, zero) a group, int8 shards only
              labels   (rows,) f64, data set shards only
    [-8:]     footer: u64 digest of header + payload

The digest is always CRC32 (``zlib.crc32``) as the reference's fallback
computes it: ``(crc << 32) | (length mod 2^32)``, and the manifest says
``"hash": "crc32"``.  The reference writes xxh64 where ``xxhash`` imports;
the port needs nothing beyond the standard library for its digests, so a
store whose manifest names another hash is refused (``ShardError``) and
``open_or_ingest`` ingests it again, never trusting it unverified.

int8 shards use ``core/quant.py``'s symmetric codec with scale groups that
start at the shard's first row; ``shard_rows`` is a multiple of
``GROUP_ROWS``, so every group is aligned to global rows, as the streamed
wires' groups are.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import time
import zlib
from collections import OrderedDict
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.faults import check as fault_check
from repro_torch.core.faults import classify_error
from repro_torch.core.quant import (GROUP_ROWS, QuantBlock, dequantize_rows,
                                    dequantize_rows_range, quantize_rows)
from repro_torch.core.quant import group_scales as quant_group_scales
from repro_torch.core.trace import resolve

HASH_NAME = "crc32"
MAGIC = b"LPDSHRD1"
VERSION = 1
MANIFEST_NAME = "manifest.json"
QUARANTINE_DIR = "quarantine"
#: magic(8) version(u32) dtype(u32) rows cols group values scales labels (u64)
_HEADER = struct.Struct("<8sIIQQQQQQ")
_FOOTER = struct.Struct("<Q")
HEADER_BYTES = _HEADER.size
FOOTER_BYTES = _FOOTER.size
_DTYPE_CODES = {"f32": 0, "int8": 1}
_DTYPE_NAMES = {v: k for k, v in _DTYPE_CODES.items()}
SHARD_DTYPES = tuple(_DTYPE_CODES)
GATHER_ROWS = 4096        # rows a view gathers into a caller's tensor at a time


class ShardError(Exception):
    """A structural problem of a shard store (no manifest, a bad layout, a
    hash the port does not compute, a rebuild that does not reproduce the
    manifest's digest, ...)."""


class ShardCorruptionError(ShardError):
    """A shard's bytes do not match its digest (bit rot, a torn or foreign
    file) and no rebuilder could restore it."""


@dataclasses.dataclass
class ShardStoreStats:
    """Counters of one store's disk traffic and recovery."""

    shards_written: int = 0
    shards_read: int = 0
    bytes_written: int = 0
    bytes_read: int = 0
    verifications: int = 0        # digests computed on reads
    checksum_failures: int = 0    # reads whose digest did not match
    quarantined: int = 0          # corrupt files moved to quarantine/
    rebuilt: int = 0              # shards made again from their source
    retries: int = 0              # transient read errors retried
    read_seconds: float = 0.0     # host time in file reads
    write_seconds: float = 0.0    # host time in atomic writes
    verify_seconds: float = 0.0   # host time computing read digests

    @property
    def read_gbps(self) -> float:
        return self.bytes_read / max(self.read_seconds, 1e-12) / 1e9


def shard_name(i: int) -> str:
    return f"shard_{i:05d}.bin"


class Crc32Hasher:
    """The 8-byte digest of a store: zlib's CRC32 in the high word, the
    byte count modulo 2^32 in the low word (the reference's fallback)."""

    def __init__(self):
        self._state = 0
        self._length = 0

    def update(self, buf) -> None:
        self._state = zlib.crc32(buf, self._state)
        self._length = (self._length + len(buf)) & 0xFFFFFFFF

    def intdigest(self) -> int:
        return (self._state << 32) | self._length


def _digest(buffers) -> int:
    h = Crc32Hasher()
    for b in buffers:
        h.update(b)
    return h.intdigest()


def _fsync_write(path: str, buffers) -> int:
    """Temporary file, fsync, atomic rename; returns the bytes written."""
    tmp = f"{path}.tmp.{os.getpid()}"
    nbytes = 0
    with open(tmp, "wb") as f:
        for b in buffers:
            f.write(b)
            nbytes += len(b)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return nbytes


def _pack_shard(values: np.ndarray, scales: Optional[np.ndarray],
                labels: Optional[np.ndarray], dtype: str,
                group: int) -> Tuple[List[bytes], int]:
    """One shard as (buffers ending in the footer, its digest)."""
    vb = np.ascontiguousarray(values).tobytes()
    sb = (np.ascontiguousarray(scales, np.float32).tobytes()
          if scales is not None else b"")
    lb = (np.ascontiguousarray(labels, np.float64).tobytes()
          if labels is not None else b"")
    header = _HEADER.pack(MAGIC, VERSION, _DTYPE_CODES[dtype],
                          values.shape[0], values.shape[1], group,
                          len(vb), len(sb), len(lb))
    digest = _digest((header, vb, sb, lb))
    return [header, vb, sb, lb, _FOOTER.pack(digest)], digest


def _parse_shard(buf, path: str, *, verify: bool) -> Dict[str, object]:
    """Decode one shard file's bytes; any structural or digest mismatch
    raises ``ShardCorruptionError`` (nothing partly trusted is returned)."""
    if len(buf) < HEADER_BYTES + FOOTER_BYTES:
        raise ShardCorruptionError(f"{path}: truncated ({len(buf)} bytes)")
    magic, version, code, rows, cols, group, nv, ns, nl = _HEADER.unpack_from(buf)
    if magic != MAGIC or version != VERSION or code not in _DTYPE_NAMES:
        raise ShardCorruptionError(f"{path}: bad shard header")
    if len(buf) != HEADER_BYTES + nv + ns + nl + FOOTER_BYTES:
        raise ShardCorruptionError(f"{path}: size {len(buf)} does not match header sections")
    payload_end = HEADER_BYTES + nv + ns + nl
    if verify:
        (expect,) = _FOOTER.unpack_from(buf, payload_end)
        if _digest((memoryview(buf)[:payload_end],)) != expect:
            raise ShardCorruptionError(f"{path}: checksum mismatch")
    dtype = _DTYPE_NAMES[code]
    if nv != rows * cols * (1 if dtype == "int8" else 4):
        raise ShardCorruptionError(f"{path}: values section does not hold rows x cols")
    o = HEADER_BYTES
    values = np.frombuffer(buf, np.int8 if dtype == "int8" else np.float32,
                           count=rows * cols, offset=o).reshape(rows, cols)
    o += nv
    scales = np.frombuffer(buf, np.float32, count=ns // 4, offset=o).reshape(-1, 2) if ns else None
    o += ns
    labels = np.frombuffer(buf, np.float64, count=nl // 8, offset=o) if nl else None
    return dict(values=values, scales=scales, labels=labels, rows=int(rows),
                cols=int(cols), dtype=dtype, group=int(group), digest=expect if verify else None)


def source_fingerprint(path: str) -> Dict[str, object]:
    """Content identity of an ingest source: its size and the digest of its
    first and last MiB (no mtime, so copying the file keeps the store)."""
    size = os.path.getsize(path)
    h = Crc32Hasher()
    with open(path, "rb") as f:
        h.update(f.read(1 << 20))
        if size > (1 << 20):
            f.seek(max(size - (1 << 20), 1 << 20))
            h.update(f.read(1 << 20))
    return {"size": int(size), "digest": f"{h.intdigest():016x}"}


class ShardWriter:
    """Buffers rows and writes fixed-size checksummed shard files.

    Every shard but the last holds ``shard_rows`` rows, so shard i covers
    global rows [i * shard_rows, (i + 1) * shard_rows).  ``finish`` writes
    the manifest last, atomically: until it lands there is no store.  The
    rows a call leaves pending are copied, so a caller may reuse its buffer
    (the spill sink's bounce buffers)."""

    def __init__(self, directory: str, cols: int, *, shard_rows: int = 4096,
                 dtype: str = "f32", group: int = GROUP_ROWS,
                 kind: str = "dataset", with_labels: bool = False,
                 source: Optional[Dict[str, object]] = None,
                 extra: Optional[Dict[str, object]] = None,
                 stats: Optional[ShardStoreStats] = None, trace=None):
        if dtype not in _DTYPE_CODES:
            raise ValueError(f"shard dtype must be one of {SHARD_DTYPES}, got {dtype!r}")
        if shard_rows < 1 or shard_rows % GROUP_ROWS:
            # int8 scale groups start at global rows that are group multiples
            raise ValueError(f"shard_rows must be a positive multiple of "
                             f"{GROUP_ROWS}, got {shard_rows}")
        self.directory = directory
        self.cols = int(cols)
        self.shard_rows = int(shard_rows)
        self.dtype = dtype
        self.group = int(group)
        self.kind = kind
        self.with_labels = with_labels
        self.source = source
        self.extra = dict(extra or {})
        self.stats = stats if stats is not None else ShardStoreStats()
        self.trace = resolve(trace)
        self._pending: List[np.ndarray] = []
        self._pending_labels: List[np.ndarray] = []
        self._buffered = 0
        self._shards: List[Dict[str, object]] = []
        self._n = 0
        self._finished = False
        os.makedirs(directory, exist_ok=True)
        # a re-ingest must never leave the old manifest validating new shards
        try:
            os.remove(os.path.join(directory, MANIFEST_NAME))
        except FileNotFoundError:
            pass

    def append(self, rows: np.ndarray, labels: Optional[np.ndarray] = None) -> None:
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.cols:
            raise ValueError(f"expected (r, {self.cols}) rows, got {rows.shape}")
        if self.with_labels:
            if labels is None or len(labels) != rows.shape[0]:
                raise ValueError("labels must accompany every row")
            self._pending_labels.append(np.asarray(labels, np.float64))
        self._pending.append(rows)
        self._buffered += rows.shape[0]
        while self._buffered >= self.shard_rows:
            self._emit(self.shard_rows)
        # earlier pieces were copied by their own call; the last may be the
        # caller's memory
        if self._pending:
            self._pending[-1] = np.array(self._pending[-1])
        if self._pending_labels:
            self._pending_labels[-1] = np.array(self._pending_labels[-1])

    def _take(self, count: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        rows = np.concatenate(self._pending) if len(self._pending) > 1 else self._pending[0]
        labels = None
        if self.with_labels:
            labels = (np.concatenate(self._pending_labels) if len(self._pending_labels) > 1
                      else self._pending_labels[0])
            self._pending_labels = [labels[count:]] if count < len(labels) else []
            labels = labels[:count]
        self._pending = [rows[count:]] if count < rows.shape[0] else []
        self._buffered -= count
        return rows[:count], labels

    def _emit(self, count: int) -> None:
        block, labels = self._take(count)
        i = len(self._shards)
        fault_check("shard_write", shard=i)
        if self.dtype == "int8":
            values, scales = quantize_rows(block, self.group, symmetric=True)
        else:
            values, scales = block, None
        buffers, digest = _pack_shard(values, scales, labels, self.dtype, self.group)
        path = os.path.join(self.directory, shard_name(i))
        t0 = self.trace.begin()
        nbytes = _fsync_write(path, buffers)
        self.stats.write_seconds += self.trace.end("disk", "shard_write", t0, shard=i,
                                                   bytes=nbytes)
        self.stats.shards_written += 1
        self.stats.bytes_written += nbytes
        self._shards.append({"name": shard_name(i), "rows": int(count),
                             "digest": f"{digest:016x}", "nbytes": int(nbytes)})
        self._n += count

    def finish(self) -> Dict[str, object]:
        """Write the tail shard, then publish the manifest atomically."""
        if self._finished:
            raise ShardError("ShardWriter.finish called twice")
        if self._buffered:
            self._emit(self._buffered)
        self._finished = True
        manifest = {
            "version": VERSION, "kind": self.kind, "hash": HASH_NAME,
            "n": int(self._n), "cols": self.cols,
            "shard_rows": self.shard_rows, "dtype": self.dtype,
            "group": self.group, "labels": self.with_labels,
            "shards": self._shards,
            "fingerprint": store_fingerprint(self._n, self.cols, self.dtype, self._shards),
        }
        if self.source is not None:
            manifest["source"] = self.source
        manifest.update(self.extra)
        _fsync_write(os.path.join(self.directory, MANIFEST_NAME),
                     [json.dumps(manifest, indent=1).encode()])
        # shard files of an earlier, larger store are unreachable now
        names = {s["name"] for s in self._shards}
        for f in os.listdir(self.directory):
            if f.startswith("shard_") and f.endswith(".bin") and f not in names:
                try:
                    os.remove(os.path.join(self.directory, f))
                except OSError:
                    pass
        return manifest


def store_fingerprint(n: int, cols: int, dtype: str, shards: List[Dict[str, object]]) -> str:
    """Whole-store identity: the digest of the dimensions and of every
    shard's digest.  Any change of the data, of the ingest parameters or of
    a shard changes it; a checkpoint records it (``GShardView.g_fingerprint``)
    so that a resume against another store is refused."""
    h = Crc32Hasher()
    h.update(f"{n}:{cols}:{dtype}".encode())
    for s in shards:
        h.update(str(s["digest"]).encode())
    return f"{h.intdigest():016x}"


class ShardStore:
    """Verified reader of a directory that ``ShardWriter`` wrote.

    Each read recomputes the footer digest (``verify=True``; ``verify=False``
    trusts the bytes and is the caller's choice alone), retries transient
    read errors ``retries`` times with a backoff doubled each time, and
    sends a mismatch through quarantine and, with a ``rebuilder`` (``(lo,
    hi) -> rows f32[, labels]`` over global rows), rebuild.  Decoded shards
    are kept in an LRU of ``cache_shards``; a lock makes the store safe to
    read from several threads."""

    def __init__(self, directory: str, *, verify: bool = True,
                 retries: int = 0, retry_backoff: float = 0.05,
                 rebuilder: Optional[Callable] = None, cache_shards: int = 2,
                 stats: Optional[ShardStoreStats] = None, trace=None):
        self.directory = directory
        self.verify = verify
        self.retries = int(retries)
        self.retry_backoff = float(retry_backoff)
        self.rebuilder = rebuilder
        self.stats = stats if stats is not None else ShardStoreStats()
        self.trace = resolve(trace)
        self._lock = threading.RLock()
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._cache_shards = max(0, int(cache_shards))
        self._labels: Optional[np.ndarray] = None
        mpath = os.path.join(directory, MANIFEST_NAME)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise ShardError(
                f"no shard manifest at {mpath}: the store was never completed "
                f"(an interrupted ingest?); re-ingest to rebuild it")
        except (OSError, json.JSONDecodeError) as exc:
            raise ShardError(f"unreadable shard manifest at {mpath}: {exc}")
        for key in ("n", "cols", "shard_rows", "dtype", "shards", "fingerprint"):
            if key not in manifest:
                raise ShardError(f"{mpath}: manifest missing {key!r}")
        if manifest.get("hash") != HASH_NAME:
            raise ShardError(
                f"{mpath}: the store's digests are {manifest.get('hash')!r}, and this "
                f"package computes only {HASH_NAME!r}; re-ingest to rebuild it")
        self.manifest = manifest
        missing = [s["name"] for s in manifest["shards"]
                   if not os.path.exists(os.path.join(directory, s["name"]))]
        if missing and rebuilder is None:
            raise ShardError(f"store at {directory} is missing {len(missing)} shard(s) "
                             f"to rebuild: {', '.join(missing)}")

    # -- identity ----------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.manifest["n"])

    @property
    def cols(self) -> int:
        return int(self.manifest["cols"])

    @property
    def dtype(self) -> str:
        return str(self.manifest["dtype"])

    @property
    def group(self) -> int:
        return int(self.manifest.get("group", GROUP_ROWS))

    @property
    def shard_rows(self) -> int:
        return int(self.manifest["shard_rows"])

    @property
    def n_shards(self) -> int:
        return len(self.manifest["shards"])

    @property
    def fingerprint(self) -> str:
        return str(self.manifest["fingerprint"])

    def shard_range(self, i: int) -> Tuple[int, int]:
        lo = i * self.shard_rows
        return lo, min(lo + self.shard_rows, self.n)

    # -- the verified read ---------------------------------------------------
    def _read_bytes(self, i: int, path: str) -> np.ndarray:
        attempt = 0
        while True:
            try:
                fault_check("shard_read", shard=i)
                fault_check("shard_corrupt", shard=i, path=path)
                t0 = self.trace.begin()
                with open(path, "rb") as f:
                    # a writable buffer that the parsed arrays view (no copy;
                    # np.empty, unlike bytearray, does not zero it first)
                    buf = np.empty(os.fstat(f.fileno()).st_size, np.uint8)
                    if f.readinto(memoryview(buf)) != len(buf):
                        raise ShardCorruptionError(f"{path}: short read")
                self.stats.read_seconds += self.trace.end("disk", "shard_read", t0, shard=i,
                                                          bytes=len(buf))
                self.stats.shards_read += 1
                self.stats.bytes_read += len(buf)
                if attempt:
                    self.trace.instant("recovery", "shard_read_ok", shard=i,
                                       attempts=attempt + 1)
                return buf
            except FileNotFoundError:
                raise                       # not transient: a rebuild's case
            except Exception as exc:
                retryable = isinstance(exc, OSError) or classify_error(exc) == "transient"
                if not retryable or attempt >= self.retries:
                    raise
                self.stats.retries += 1
                self.trace.instant("fault", "shard_read_retry", shard=i,
                                   error=type(exc).__name__)
                time.sleep(self.retry_backoff * (2 ** attempt))
                attempt += 1

    def _read_verified(self, i: int, entry: Dict[str, object], path: str) -> Dict[str, object]:
        buf = self._read_bytes(i, path)
        t0 = time.perf_counter()
        if self.verify:
            self.stats.verifications += 1
        try:
            parsed = _parse_shard(buf, path, verify=self.verify)
        except ShardCorruptionError:
            if self.verify:
                self.stats.checksum_failures += 1
            raise
        finally:
            if self.verify:
                self.stats.verify_seconds += time.perf_counter() - t0
        lo, hi = self.shard_range(i)
        ok = (parsed["rows"] == hi - lo and parsed["cols"] == self.cols
              and parsed["dtype"] == self.dtype)
        if self.verify:
            # the footer matched the bytes; the bytes must be the manifest's
            ok = ok and f"{parsed['digest']:016x}" == entry["digest"]
        if not ok:
            # consistent in itself, but not the shard the manifest promised
            # (a stale or foreign file): recovered as bit rot is
            self.stats.checksum_failures += 1
            raise ShardCorruptionError(f"{path}: contents do not match the manifest entry")
        return parsed

    def _quarantine(self, i: int, path: str) -> None:
        qdir = os.path.join(self.directory, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        try:
            os.replace(path, os.path.join(qdir, os.path.basename(path)))
        except FileNotFoundError:
            pass
        self.stats.quarantined += 1

    def _rebuild(self, i: int, entry: Dict[str, object], path: str) -> None:
        lo, hi = self.shard_range(i)
        out = self.rebuilder(lo, hi)
        rows, labels = out if isinstance(out, tuple) else (out, None)
        rows = np.asarray(rows, np.float32)
        if rows.shape != (hi - lo, self.cols):
            raise ShardError(f"rebuilder returned {rows.shape} for shard {i} "
                             f"(rows [{lo}, {hi}) of {self.cols} cols)")
        if self.dtype == "int8":
            values, scales = quantize_rows(rows, self.group, symmetric=True)
        else:
            values, scales = rows, None
        if self.manifest.get("labels") and labels is None:
            raise ShardError(f"rebuilder returned no labels for shard {i} of a labelled store")
        buffers, digest = _pack_shard(
            values, scales, np.asarray(labels, np.float64) if labels is not None else None,
            self.dtype, self.group)
        if f"{digest:016x}" != entry["digest"]:
            raise ShardError(f"rebuild of shard {i} does not reproduce the manifest digest: "
                             f"the source changed since ingest; re-ingest instead of resuming")
        nbytes = _fsync_write(path, buffers)
        self.stats.shards_written += 1
        self.stats.bytes_written += nbytes
        self.stats.rebuilt += 1
        self.trace.instant("recovery", "shard_rebuilt", shard=i)

    def _load(self, i: int) -> Dict[str, object]:
        """The parsed payload of shard i after verify, retry and rebuild."""
        return self._load_counted(i)[0]

    def _load_counted(self, i: int) -> Tuple[Dict[str, object], bool]:
        """``_load``'s payload and whether shard i was rebuilt on the way."""
        entry = self.manifest["shards"][i]
        path = os.path.join(self.directory, str(entry["name"]))
        last: Optional[BaseException] = None
        for attempt in range(2):   # the read, then one read after a rebuild
            try:
                return self._read_verified(i, entry, path), bool(attempt)
            except FileNotFoundError as exc:
                last, reason = exc, "missing"
            except ShardCorruptionError as exc:
                last, reason = exc, "corrupt"
                self.trace.instant("fault", "shard_corrupt", shard=i, path=path)
                self._quarantine(i, path)
            if attempt or self.rebuilder is None:
                break
            self._rebuild(i, entry, path)
        raise ShardCorruptionError(
            f"shard {entry['name']} of {self.directory} is {reason}"
            + ("" if self.rebuilder is not None
               else " and no rebuilder is attached; rebuild it from source or re-ingest")
        ) from last

    # -- decoded access ------------------------------------------------------
    def _decoded(self, i: int) -> np.ndarray:
        """The f32 rows of shard i, through the LRU of decoded shards."""
        with self._lock:
            hit = self._cache.get(i)
            if hit is not None:
                self._cache.move_to_end(i)
                return hit
            parsed = self._load(i)
            if parsed["dtype"] == "int8":
                rows = dequantize_rows(parsed["values"], parsed["scales"], parsed["group"])
            else:
                rows = parsed["values"]       # a view of the shard's own buffer
            if self._cache_shards:
                self._cache[i] = rows
                while len(self._cache) > self._cache_shards:
                    self._cache.popitem(last=False)
            return rows

    def _decoded_slice(self, i: int, a: int, b: int) -> np.ndarray:
        """f32 rows [a, b) of shard i.  With the LRU off (``cache_shards=0``)
        only the groups of the rows asked for are decoded."""
        with self._lock:
            hit = self._cache.get(i)
            if hit is not None:
                self._cache.move_to_end(i)
                return hit[a:b]
            if self._cache_shards:
                return self._decoded(i)[a:b]
            parsed = self._load(i)
            if parsed["dtype"] == "int8":
                return dequantize_rows_range(parsed["values"], parsed["scales"], a, b,
                                             parsed["group"])
            return np.array(parsed["values"][a:b], np.float32)

    def read_shard(self, i: int, *, wire: bool = False) -> Union[np.ndarray, QuantBlock]:
        """One shard's rows: decoded f32, or (``wire=True``, int8 stores) the
        stored codes and table as a ``QuantBlock``, for the int8 wire."""
        if wire:
            if self.dtype != "int8":
                raise ShardError("wire=True requires an int8 store")
            with self._lock:
                parsed = self._load(i)
            # the table copied: its offset in the file need not be 4-aligned
            return QuantBlock(values=parsed["values"],
                              scales=np.array(parsed["scales"], np.float32),
                              group=parsed["group"])
        return self._decoded(i)

    def iter_blocks(self, *, wire: bool = False) -> Iterator[Union[np.ndarray, QuantBlock]]:
        """The shards in row order: the blocks ``stream_factor_blocks``
        takes."""
        for i in range(self.n_shards):
            yield self.read_shard(i, wire=wire)

    def read_rows(self, lo: int, hi: int) -> np.ndarray:
        """f32 rows [lo, hi), across shard boundaries."""
        lo = max(0, lo)
        hi = min(self.n, hi)
        if hi <= lo:
            return np.empty((0, self.cols), np.float32)
        first, last = lo // self.shard_rows, (hi - 1) // self.shard_rows
        if first == last:
            base = first * self.shard_rows
            return self._decoded_slice(first, lo - base, hi - base)
        out = np.empty((hi - lo, self.cols), np.float32)
        for i in range(first, last + 1):
            s, e = self.shard_range(i)
            a, b = max(s, lo), min(e, hi)
            out[a - lo:b - lo] = self._decoded_slice(i, a - s, b - s)
        return out

    def gather_rows(self, rows) -> np.ndarray:
        """f32 rows at any global indices (landmarks, a compaction's union,
        validation folds)."""
        rows = np.asarray(rows)
        if rows.ndim == 0:
            rows = rows[None]
        rows = np.where(rows < 0, rows + self.n, rows).astype(np.int64)
        if rows.size and (rows.min() < 0 or rows.max() >= self.n):
            raise IndexError(f"row index out of range for n={self.n}")
        out = np.empty((len(rows), self.cols), np.float32)
        shard = rows // self.shard_rows
        for i in np.unique(shard):
            lo, _ = self.shard_range(int(i))
            mask = shard == i
            out[mask] = self._decoded(int(i))[rows[mask] - lo]
        return out

    def labels(self) -> np.ndarray:
        """The shards' label vectors end to end (data set stores)."""
        if not self.manifest.get("labels"):
            raise ShardError(f"store at {self.directory} carries no labels")
        with self._lock:
            if self._labels is None:
                parts = []
                for i in range(self.n_shards):
                    parsed = self._load(i)
                    if parsed["labels"] is None:
                        raise ShardCorruptionError(f"shard {i} is missing its label section")
                    parts.append(parsed["labels"])
                self._labels = np.concatenate(parts)
            return self._labels

    def verify_all(self) -> List[int]:
        """Read every shard; returns the indices of the shards that had to
        be rebuilt (or raises naming the first that could not be)."""
        rebuilt = []
        for i in range(self.n_shards):
            with self._lock:
                if self._load_counted(i)[1]:
                    rebuilt.append(i)
        return rebuilt


class GShardView:
    """Read-only (n, B') view of G spilled to an f32 shard store.

    It serves what the streamed stage 2 asks of a host G: row slices for the
    shared passes, gathers for a compaction (``gather_into`` writes them
    straight into the caller's pinned buffer), ``group_scales`` for the int8
    wire, computed shard by shard, and ``g_fingerprint`` (the manifest's) for
    checkpoints.  Every row it serves passed a checksum.  The streamed paths
    never materialise it; ``to(device)`` reads it whole for a caller that
    asked for the monolithic route."""

    is_shard_view = True
    device = torch.device("cpu")

    def __init__(self, store: ShardStore):
        if store.dtype != "f32":
            raise ShardError("G spill shards must be f32: the stage-2 wires encode from f32")
        self.store = store
        self.shape = (store.n, store.cols)
        self.dtype = np.dtype(np.float32)
        self.ndim = 2

    @property
    def nbytes(self) -> int:
        return self.shape[0] * self.shape[1] * 4

    @property
    def g_fingerprint(self) -> float:
        # the top 52 bits of the manifest's fingerprint: exact in a float64
        return float(int(self.store.fingerprint[:13], 16))

    @property
    def rebuilder(self):
        return self.store.rebuilder

    @rebuilder.setter
    def rebuilder(self, fn) -> None:
        self.store.rebuilder = fn

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key) -> np.ndarray:
        if isinstance(key, slice):
            lo, hi, step = key.indices(self.shape[0])
            if step != 1:
                return self.store.gather_rows(np.arange(lo, hi, step))
            return self.store.read_rows(lo, hi)
        if isinstance(key, (int, np.integer)):
            return self.store.gather_rows([int(key)])[0]
        return self.store.gather_rows(key)

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self.store.read_rows(0, self.shape[0])
        return out if dtype is None else out.astype(dtype)

    def to(self, device) -> torch.Tensor:
        """G whole as a tensor on ``device`` (the monolithic route's copy)."""
        return torch.from_numpy(np.asarray(self)).to(device)

    def rows_into(self, lo: int, hi: int, out: torch.Tensor) -> torch.Tensor:
        """``G[lo:hi]`` written into the host tensor ``out`` (any float
        dtype), shard by shard, from the decoded shards themselves."""
        sr = self.store.shard_rows
        for i in range(lo // sr, -(-hi // sr)):
            a, b = max(lo, i * sr), min(hi, (i + 1) * sr)
            out[a - lo:b - lo].copy_(torch.from_numpy(self.store.read_rows(a, b)))
        return out

    def gather_into(self, rows, out: torch.Tensor) -> torch.Tensor:
        """``G[rows]`` written into the host tensor ``out`` (any float dtype),
        ``GATHER_ROWS`` rows at a time, so no temporary holds them all."""
        rows = np.asarray(rows, np.int64)
        for s in range(0, len(rows), GATHER_ROWS):
            e = min(s + GATHER_ROWS, len(rows))
            out[s:e].copy_(torch.from_numpy(self.store.gather_rows(rows[s:e])))
        return out

    def group_scales(self, group: int = GROUP_ROWS, *, symmetric: bool = False) -> np.ndarray:
        """The global-row-aligned (scale, zero) table, shard by shard: equal to
        ``quant.group_scales`` over the whole G, as shard boundaries are
        group multiples."""
        if group < 1 or self.store.shard_rows % group:
            return quant_group_scales(np.asarray(self), group, symmetric=symmetric)
        parts = [quant_group_scales(self.store.read_shard(i), group, symmetric=symmetric)
                 for i in range(self.store.n_shards)]
        return np.concatenate(parts) if parts else np.zeros((0, 2), np.float32)


def is_shard_view(G) -> bool:
    return getattr(G, "is_shard_view", False)


# Row access to G wherever it lies, so that its consumers need not know
# whether G is a tensor (host or card) or a spilled ``GShardView``.

def rows_into(G, lo: int, hi: int, out: torch.Tensor) -> torch.Tensor:
    """``G[lo:hi]`` written into ``out`` (any float dtype, on G's device)."""
    if is_shard_view(G):
        return G.rows_into(lo, hi, out)
    return out.copy_(G[lo:hi])


def gather_into(G, rows, out: torch.Tensor) -> torch.Tensor:
    """``G[rows]`` written into ``out`` (any float dtype, on G's device)."""
    if is_shard_view(G):
        return G.gather_into(rows, out)
    idx = torch.as_tensor(np.asarray(rows, np.int64)).to(G.device)
    if out.dtype == G.dtype:
        return torch.index_select(G, 0, idx, out=out)
    return out.copy_(G.index_select(0, idx))


def numpy_rows(G):
    """G as numpy row slicing and gathers read it: a tensor's host array, a
    spilled G's view itself (its rows read from the shards on demand)."""
    return G if is_shard_view(G) else G.cpu().numpy()


def group_scales(G, group: int = GROUP_ROWS, *, symmetric: bool = False) -> np.ndarray:
    """``quant.group_scales`` of G: a spilled G's shard by shard."""
    if is_shard_view(G):
        return G.group_scales(group, symmetric=symmetric)
    return quant_group_scales(numpy_rows(G), group, symmetric=symmetric)


class ShardSpillSink:
    """The stage-1 ``out=`` that spills G's row chunks to f32 shards.

    ``stream_factor_blocks`` drains its chunks first in, first out, so the
    rows arrive as contiguous slices in order; the writer cuts them into
    shards, and ``finish`` returns the ``GShardView`` stage 2 reads."""

    def __init__(self, directory: str, n: int, rank: int, *, shard_rows: int = 4096,
                 stats: Optional[ShardStoreStats] = None, trace=None):
        self.shape = (n, rank)
        self.trace = trace
        self.stats = stats if stats is not None else ShardStoreStats()
        self._writer = ShardWriter(directory, rank, shard_rows=shard_rows, dtype="f32",
                                   kind="g", stats=self.stats, trace=trace)
        self.directory = directory
        self._next = 0

    def __setitem__(self, key, value) -> None:
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError("the spill sink takes contiguous row slices only")
        lo, hi, _ = key.indices(self.shape[0])
        if lo != self._next:
            raise ShardError(f"spill writes must come in order: got rows [{lo}, {hi}) "
                             f"after {self._next}")
        self._writer.append(np.asarray(value, np.float32))
        self._next = hi

    def finish(self, *, rebuilder: Optional[Callable] = None, verify: bool = True,
               retries: int = 0, retry_backoff: float = 0.05) -> GShardView:
        if self._next != self.shape[0]:
            raise ShardError(f"the spill received {self._next} of {self.shape[0]} rows")
        self._writer.finish()
        store = ShardStore(self.directory, verify=verify, retries=retries,
                           retry_backoff=retry_backoff, rebuilder=rebuilder,
                           stats=self.stats, trace=self.trace)
        return GShardView(store)


# -- LIBSVM ingest: one parse ----------------------------------------------

def ingest_libsvm_shards(path: str, directory: str, *, n_features: Optional[int] = None,
                         shard_rows: int = 4096, dtype: str = "f32",
                         group: int = GROUP_ROWS, on_bad_row: str = "raise",
                         stats: Optional[ShardStoreStats] = None,
                         trace=None) -> ShardStore:
    """Parse a LIBSVM text file once into a labelled shard store.

    With ``n_features`` the parse streams (``read_libsvm_blocks``: the dense
    matrix never exists whole); without it one ``read_libsvm`` pass finds
    the width.  The manifest keeps the row counts and the source's
    fingerprint, so that ``open_or_ingest`` can reuse the store with no
    parse."""
    from repro_torch.data import libsvm_format as lf
    ing = lf.IngestStats()
    src = source_fingerprint(path)
    extra = {"on_bad_row": on_bad_row, "source_path": os.path.abspath(path)}

    def writer(cols):
        return ShardWriter(directory, cols, shard_rows=shard_rows, dtype=dtype, group=group,
                           kind="dataset", with_labels=True, source=src, extra=extra,
                           stats=stats, trace=trace)

    if n_features:
        w = writer(n_features)
        for dense, labels in lf.read_libsvm_blocks(path, rows=shard_rows,
                                                   n_features=n_features,
                                                   on_bad_row=on_bad_row, stats=ing):
            w.append(dense, labels)
    else:
        data = lf.read_libsvm(path, on_bad_row=on_bad_row, stats=ing)
        w = writer(data.n_features)
        for dense, labels in data.iter_dense_blocks(shard_rows):
            w.append(dense, labels)
    w.extra = extra              # the counts below land in the manifest
    extra["rows_read"] = ing.rows_read
    extra["rows_skipped"] = ing.rows_skipped
    w.finish()
    store = ShardStore(directory, stats=stats, trace=trace)
    attach_source_rebuilder(store, path, on_bad_row=on_bad_row)
    return store


def attach_source_rebuilder(store: ShardStore, path: str, *,
                            on_bad_row: str = "raise") -> ShardStore:
    """Arm a data set store to make any shard again by parsing its row range
    from the LIBSVM text (the codec is deterministic and its groups are
    shard-aligned, so the codes come out bit for bit)."""
    from repro_torch.data import libsvm_format as lf
    cols = store.cols

    def rebuild(lo: int, hi: int):
        return lf.read_libsvm_rows_range(path, lo, hi, cols, on_bad_row=on_bad_row)

    store.rebuilder = rebuild
    return store


def open_or_ingest(path: str, directory: str, *, n_features: Optional[int] = None,
                   shard_rows: int = 4096, dtype: str = "f32", group: int = GROUP_ROWS,
                   on_bad_row: str = "raise", verify: bool = True, retries: int = 0,
                   retry_backoff: float = 0.05, stats: Optional[ShardStoreStats] = None,
                   trace=None) -> Tuple[ShardStore, bool]:
    """Reuse a matching shard store, or ingest the text once to build it.

    Returns ``(store, ingested)``.  Reuse needs the manifest's source
    fingerprint and ingest parameters to match, and its hash to be the
    port's; anything else (edited text, other shard_rows / dtype / width, a
    store with xxh64 digests) ingests again.  A reused store parses no text:
    n, the width, the labels and the row counts come from the store."""
    try:
        store = ShardStore(directory, verify=verify, retries=retries,
                           retry_backoff=retry_backoff, stats=stats, trace=trace)
        m = store.manifest
        if (m.get("kind") == "dataset" and m.get("labels")
                and m.get("source") == source_fingerprint(path)
                and store.shard_rows == shard_rows and store.dtype == dtype
                and (not n_features or store.cols == n_features)):
            attach_source_rebuilder(store, path, on_bad_row=on_bad_row)
            return store, False
    except ShardError:
        pass
    store = ingest_libsvm_shards(path, directory, n_features=n_features,
                                 shard_rows=shard_rows, dtype=dtype, group=group,
                                 on_bad_row=on_bad_row, stats=stats, trace=trace)
    store.verify = verify
    store.retries = int(retries)
    store.retry_backoff = float(retry_backoff)
    return store, True


__all__ = ["GShardView", "HASH_NAME", "ShardCorruptionError", "ShardError",
           "ShardSpillSink", "ShardStore", "ShardStoreStats", "ShardWriter",
           "attach_source_rebuilder", "ingest_libsvm_shards", "is_shard_view",
           "open_or_ingest", "shard_name", "source_fingerprint", "store_fingerprint"]
