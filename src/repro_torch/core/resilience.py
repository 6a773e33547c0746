"""Checkpoints, resume and graceful degradation of the streamed stages (port
of ``repro.core.resilience``; it imports nothing of the JAX package).

* ``snapshot_solver`` / ``restore``: the streamed stage 2's state at a
  full-pass boundary (the reference's ``snapshot_engines`` /
  ``restore_engines``, over ``solve_batch_streamed``'s state instead of its
  engines).  Per task: alpha, the shrink counters, w, its epoch count, its
  violation and its live / pending / done flags, in the tasks' own layout
  (not the solver's sorted one, so a snapshot does not depend on the tile);
  q over G's rows; the next epoch, the queue depth and the stats carry.  The
  compaction and the block cache are functions of that state and are
  rebuilt on restore (a cold cache).  A snapshot is keyed by the solve's
  task indices, so the farm (``core/distributed.py``) restores it onto any
  split of the tasks over any number of workers.
* ``StreamGuard``: a snapshot every ``checkpoint_every`` full passes, the
  newest ``checkpoint_keep`` kept, and resume from the newest.  Snapshots
  are ``step_%08d.npz`` archives written atomically by
  ``repro_torch.checkpoint`` (the reference writes msgpack).  With
  ``degrade=True`` (the farm under ``fail_fast=False``) it also keeps the
  newest boundary's snapshot in memory (``mem``), from which the farm
  re-splits a lost device's tasks over the survivors (``adopt_mem``).
* ``WatchdogTimeout`` / ``WorkerStuckError``: the farm's barrier or reader
  starved past ``StreamConfig.watchdog_seconds``; a worker thread still
  alive when the farm closes.
* ``Stage1Progress`` / ``stage1_memmap``: resumable stage 1.  Each drained
  chunk's rows of G are written to ``<dir>/stage1_G.npy`` and flushed, then
  the chunk is logged; a resumed stage 1 reads the logged chunks back.
"""
from __future__ import annotations

import os
import re
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.ckpt import (latest_step, read_checkpoint,
                                         save_checkpoint)
from repro_torch.core.trace import NULL


class WatchdogTimeout(RuntimeError):
    """The farm's barrier or its shared reader starved past
    ``StreamConfig.watchdog_seconds``: raised with every worker's state
    instead of hanging."""


class WorkerStuckError(RuntimeError):
    """A farm worker thread was still alive after its join timeout when the
    farm closed."""

# ---------------------------------------------------------------------------
# stream-stats carry: the counters of the segments before a resume
# ---------------------------------------------------------------------------

_CARRY_SUM = ("bytes_h2d", "bytes_d2h", "bytes_g", "bytes_scales", "bytes_hit",
              "bytes_put", "bytes_miss", "blocks_streamed", "rows_streamed", "kernel_calls",
              "coord_visits", "cache_hits", "cache_misses", "cache_evictions",
              "full_passes", "snapshots")
_CARRY_SUM_F = ("put_seconds", "drain_seconds", "h2d_seconds", "seconds",
                "encode_seconds", "compact_seconds", "init_seconds",
                "snapshot_seconds")
_CARRY_MAX = ("epochs", "prefetch_final", "cache_resident_bytes",
              "snapshot_bytes")
_CARRY_LIST = ("epoch_bytes", "epoch_hit_bytes", "epoch_miss_bytes",
               "active_history")


def stats_to_carry(stats) -> Dict[str, np.ndarray]:
    """The carried fields of a ``Stage2StreamStats`` as arrays."""
    out: Dict[str, np.ndarray] = {}
    for f in _CARRY_SUM + _CARRY_MAX:
        out[f] = np.asarray(getattr(stats, f), np.int64)
    for f in _CARRY_SUM_F:
        out[f] = np.asarray(getattr(stats, f), np.float64)
    for f in _CARRY_LIST:
        out[f] = np.asarray(getattr(stats, f), np.int64)
    return out


def add_carry(carry: Dict[str, np.ndarray],
              base: Optional[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """An earlier segment's carry (``base``) folded under ``carry``:
    counters sum, peaks take the larger, per-epoch lists concatenate (base
    first)."""
    if base is None:
        return carry
    out = dict(carry)
    for f in _CARRY_SUM:
        out[f] = np.asarray(int(carry.get(f, 0)) + int(base.get(f, 0)), np.int64)
    for f in _CARRY_SUM_F:
        out[f] = np.asarray(float(carry[f]) + float(base[f]), np.float64)
    for f in _CARRY_MAX:
        out[f] = np.asarray(max(int(carry[f]), int(base[f])), np.int64)
    for f in _CARRY_LIST:
        out[f] = np.concatenate([np.asarray(base[f], np.int64),
                                 np.asarray(carry[f], np.int64)])
    return out


def apply_carry(stats, carry: Optional[Dict[str, np.ndarray]]):
    """Fold a carry into the resumed segment's stats, so that they read as
    one uninterrupted run's."""
    if carry is None:
        return stats
    for f in _CARRY_SUM:
        setattr(stats, f, getattr(stats, f) + int(carry.get(f, 0)))
    for f in _CARRY_SUM_F:
        setattr(stats, f, getattr(stats, f) + float(carry[f]))
    for f in _CARRY_MAX:
        setattr(stats, f, max(getattr(stats, f), int(carry[f])))
    for f in _CARRY_LIST:
        setattr(stats, f, [int(v) for v in carry[f]] + getattr(stats, f))
    return stats


# ---------------------------------------------------------------------------
# stage-2 snapshot
# ---------------------------------------------------------------------------

#: the per-task and per-row arrays of a snapshot (``solve_batch_streamed``'s
#: ``state()``): alpha, unchanged (T, n_pad) in the tasks' layout, w
#: (T, B'), epochs, violation, live, pending, done (T,), q (n,)
STATE_KEYS = ("alpha", "unchanged", "w", "epochs", "violation", "live",
              "pending", "done", "q")


def g_fingerprint(G) -> float:
    """Cheap content stamp of the factor, so that a snapshot is not resumed
    onto another G (another gamma's checkpoint directory).  A spilled G
    (``shards.GShardView``) gives its own, from its store manifest's shard
    digests: a resume against a store that was ingested again, or spilled
    at another gamma, is refused without reading a row."""
    fp = getattr(G, "g_fingerprint", None)
    if fp is not None:
        return float(fp)
    n = G.shape[0]
    if n == 0:
        return 0.0
    return float(np.float64(np.asarray(G[0]).sum()) + np.float64(np.asarray(G[-1]).sum())
                 + np.float64(n) * G.shape[1])


def snapshot_solver(state: Dict[str, np.ndarray], sizes, *, epoch_next: int,
                    init_done: bool, prefetch: int, carry: Dict[str, np.ndarray],
                    n: int, rank: int, g_fp: float, q_summed: bool = True) -> Dict:
    """The snapshot tree of one streamed stage-2 solve at a full-pass
    boundary: ``state`` (``STATE_KEYS``), ``sizes[t]`` task t's real rows,
    and the loop's position.  ``q_summed`` is False only in a farm's
    in-memory snapshot from before its first pass over G."""
    missing = [k for k in STATE_KEYS if k not in state]
    if missing:
        raise KeyError(f"snapshot state lacks {missing}")
    return {
        "meta": {
            "epoch_next": np.asarray(epoch_next, np.int64),
            "init_done": np.asarray(int(init_done), np.int64),
            "prefetch": np.asarray(prefetch, np.int64),
            "n": np.asarray(n, np.int64),
            "rank": np.asarray(rank, np.int64),
            "T": np.asarray(len(sizes), np.int64),
            "g_fp": np.asarray(g_fp, np.float64),
            "q_summed": np.asarray(int(q_summed), np.int64),
        },
        "sizes": np.asarray(sizes, np.int64),
        "state": {k: np.asarray(state[k]) for k in STATE_KEYS},
        "stats": carry,
    }


def validate_snapshot(snap: Dict, *, n: int, rank: int, sizes,
                      g_fp: float) -> None:
    meta = snap["meta"]
    if int(meta["n"]) != n or int(meta["rank"]) != rank:
        raise ValueError(
            f"checkpoint shape mismatch: saved (n={int(meta['n'])}, "
            f"rank={int(meta['rank'])}), solve has (n={n}, rank={rank})")
    sizes = np.asarray(sizes, np.int64)
    if int(meta["T"]) != len(sizes) or not np.array_equal(
            np.asarray(snap["sizes"], np.int64), sizes):
        raise ValueError("checkpoint task structure does not match this solve")
    if abs(float(meta["g_fp"]) - g_fp) > 1e-6 * max(1.0, abs(g_fp)):
        raise ValueError("checkpoint factor fingerprint does not match G — "
                         "resuming against a different factor?")


def load_snapshot(directory: str, step: Optional[int] = None) -> Optional[Dict]:
    """A snapshot written by ``StreamGuard`` (the newest when ``step`` is
    None; None when there is none), as a nested dict."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    out: Dict = {}
    for key, arr in read_checkpoint(directory, step).items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


# ---------------------------------------------------------------------------
# the solver-side guard
# ---------------------------------------------------------------------------

class StreamGuard:
    """Checkpoint policy and state of ONE streamed stage-2 solve.  The driver
    calls ``on_start`` / ``mark_init`` / ``on_boundary`` with callables that
    give the solve's state (``STATE_KEYS``, plus ``q_summed``), its stats so
    far and its queue depth; the solve reads ``start_epoch``, ``init_done``
    and ``carry`` after ``adopt``.  ``degrade=True`` keeps the newest
    boundary's snapshot in ``mem`` (also before the first one: at the start
    and after the init pass), for ``adopt_mem``."""

    def __init__(self, cfg, *, n: int, rank: int, sizes, g_fp: float,
                 degrade: bool = False):
        self.cfg = cfg
        self.dir = cfg.checkpoint_dir
        self.every = cfg.checkpoint_every if self.dir else 0
        self.degrade = degrade
        self.n, self.rank, self.g_fp = n, rank, g_fp
        self.sizes = np.asarray(sizes, np.int64)
        self.start_epoch = 0
        self.init_done = False
        self.carry: Optional[Dict[str, np.ndarray]] = None
        self.mem: Optional[Dict] = None   # the newest boundary's snapshot
        self.saved_steps: List[int] = []
        self.last_bytes = 0              # the newest snapshot's file
        self.last_seconds = 0.0          # and the time it took to write
        self._fulls = 0
        self._t0 = time.perf_counter()

    # -- resume -------------------------------------------------------------
    def try_resume(self) -> Optional[Dict]:
        if not self.dir:
            return None
        snap = load_snapshot(self.dir)
        if snap is None:
            return None
        validate_snapshot(snap, n=self.n, rank=self.rank, sizes=self.sizes,
                          g_fp=self.g_fp)
        return snap

    def adopt(self, snap: Dict) -> None:
        """Continue from ``snap``: the loop starts at its boundary and the
        counters so far ride ``carry``."""
        self.start_epoch = int(snap["meta"]["epoch_next"])
        self.init_done = bool(int(snap["meta"]["init_done"]))
        self.carry = snap.get("stats")
        if self.degrade:
            self.mem = snap

    def adopt_mem(self) -> None:
        """Continue from the newest in-memory snapshot (a device was lost)."""
        if self.mem is None:
            raise RuntimeError("no boundary snapshot to re-split from")
        self.adopt(self.mem)

    def _snapshot(self, state: Callable, stats: Callable, prefetch: int,
                  epoch_next: int, t0: float) -> Dict:
        cur = stats()
        cur.seconds = t0 - self._t0
        carry = add_carry(stats_to_carry(cur), self.carry)
        st = dict(state())
        q_summed = bool(st.pop("q_summed", True))
        return snapshot_solver(st, self.sizes, epoch_next=epoch_next,
                               init_done=self.init_done, prefetch=prefetch,
                               carry=carry, n=self.n, rank=self.rank, g_fp=self.g_fp,
                               q_summed=q_summed)

    # -- driver hooks -------------------------------------------------------
    def on_start(self, state: Optional[Callable] = None, stats: Optional[Callable] = None,
                 prefetch: Optional[Callable] = None) -> None:
        """The segment's clock starts (its stats' ``seconds``); a degrading
        guard takes its first in-memory snapshot."""
        self._t0 = time.perf_counter()
        if self.degrade and self.mem is None:
            self.mem = self._snapshot(state, stats, prefetch(), self.start_epoch,
                                      self._t0)

    def mark_init(self, state: Optional[Callable] = None, stats: Optional[Callable] = None,
                  prefetch: Optional[Callable] = None) -> None:
        self.init_done = True
        if self.degrade:
            self.mem = self._snapshot(state, stats, prefetch(), self.start_epoch,
                                      time.perf_counter())

    def on_boundary(self, epoch: int, state: Callable[[], Dict[str, np.ndarray]],
                    stats: Callable[[], object], prefetch: int, trace=NULL) -> bool:
        """After a full pass's epoch has been accounted: every
        ``checkpoint_every``-th boundary writes ``step_{epoch + 1}`` from
        ``state()`` and ``stats()`` (the segment's stats so far, ``seconds``
        not yet set), then prunes; a degrading guard keeps every boundary's
        snapshot in ``mem``.  True when it wrote."""
        self._fulls += 1
        write = bool(self.every and self._fulls % self.every == 0)
        if not (write or self.degrade):
            return False
        t0 = time.perf_counter()
        snap = self._snapshot(state, stats, prefetch, epoch + 1, t0)
        if self.degrade:
            self.mem = snap
        if not write:
            return False
        path = save_checkpoint(self.dir, epoch + 1, snap)
        self.saved_steps.append(epoch + 1)
        self.last_bytes = os.path.getsize(path)
        trace.instant("recovery", "checkpoint", epoch=epoch, step=epoch + 1,
                      bytes=self.last_bytes)
        self._prune()
        self.last_seconds = time.perf_counter() - t0
        return True

    def _prune(self) -> None:
        """Keep the newest ``checkpoint_keep`` snapshots (0: all), deleting
        the oldest first and only after the new one has landed."""
        keep = int(self.cfg.checkpoint_keep)
        if keep <= 0 or not self.dir:
            return
        steps = sorted(int(m.group(1)) for f in os.listdir(self.dir)
                       if (m := re.match(r"step_(\d+)\.npz$", f)))
        for s in steps[:-keep]:
            try:
                os.remove(os.path.join(self.dir, f"step_{s:08d}.npz"))
            except OSError:
                pass


# ---------------------------------------------------------------------------
# resumable stage-1 factor streaming
# ---------------------------------------------------------------------------

class Stage1Progress:
    """Append-only row-range log of completed stage-1 chunks.

    ``mark(s, e, flush)`` flushes the G copy FIRST, then writes and fsyncs
    the "s e" line, so every logged range is durably on disk.  The header
    pins (n, rank); a mismatch (another data set, kernel or budget), or
    ``resume=False``, starts the log anew."""

    def __init__(self, path: str, n: int, rank: int, resume: bool = True):
        self.path = path
        self.n, self.rank = n, rank
        self._ranges: List = []
        header = f"{n} {rank}"
        if os.path.exists(path):
            keep = False
            if resume:
                with open(path, "r") as f:
                    lines = [ln.strip() for ln in f if ln.strip()]
                if lines and lines[0] == header:
                    keep = True
                    for ln in lines[1:]:
                        s, e = ln.split()
                        self._ranges.append((int(s), int(e)))
            if not keep:
                os.remove(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fresh = not os.path.exists(self.path)
        self._f = open(self.path, "a")
        if fresh:
            self._f.write(header + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    @property
    def rows_done(self) -> int:
        return sum(e - s for s, e in self._ranges)

    def covered(self, s: int, e: int) -> bool:
        return any(rs <= s and e <= re_ for rs, re_ in self._ranges)

    def mark(self, s: int, e: int, flush=None) -> None:
        if flush is not None:
            flush()
        self._f.write(f"{s} {e}\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._ranges.append((s, e))

    def close(self) -> None:
        self._f.close()


def stage1_memmap(directory: str, n: int, rank: int,
                  resume: bool) -> np.ndarray:
    """The on-disk copy of G under the checkpoint directory; a shape or
    dtype mismatch, or ``resume=False``, makes it anew."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "stage1_G.npy")
    if resume and os.path.exists(path):
        try:
            out = np.lib.format.open_memmap(path, mode="r+")
            if out.shape == (n, rank) and out.dtype == np.float32:
                return out
        except (ValueError, OSError):
            pass
    return np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                     shape=(n, rank))


__all__ = ["STATE_KEYS", "Stage1Progress", "StreamGuard", "WatchdogTimeout",
           "WorkerStuckError", "add_carry",
           "apply_carry", "g_fingerprint", "load_snapshot",
           "snapshot_solver", "stage1_memmap", "stats_to_carry",
           "validate_snapshot"]
