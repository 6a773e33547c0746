"""The card-resident hot-row block cache of the streamed stage 2 (port of
``repro.core.block_cache``; it imports nothing of the JAX package).

After a few full passes of shrinking the active rows are few and stable, yet
every cheap epoch between two full passes ships the same compacted union of
them over the bus again.  This cache pins compacted blocks on the card under
a byte budget: a cheap epoch looks each block up first, a hit is decoded
from the pinned payload and no G byte crosses the bus, and a miss ships as
before and is kept when the plan wants it.

A payload is the wire arrays the copy produced (the f32 rows, the bf16 rows,
or the int8 codes and their row table), decoded per use by the same ops as a
shipped block, so a hit is bit-identical to a miss by construction.

Which blocks to pin is chosen by violation recency: at each compaction
(``plan``) the blocks whose rows most recently moved (smallest ``unchanged``
counters) pin first, until the budget is full; entries whose key left the
plan are evicted there.  Keys are the global row ids a block carries (and
the wire), so a stable union keeps its entries across compactions, and a
union that shifts by one row re-keys every later block.

The planner is host bookkeeping with opaque payloads; ``plan``, the scores
and the budget model equal the reference's on the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.streaming import BYTES_F32, StreamConfig


def block_key(rows: np.ndarray, wire: str) -> bytes:
    """Content-addressed key of one compacted block: the global row ids it
    carries and the wire dtype (an f32 and an int8 encoding of the same rows
    are different payloads)."""
    return wire.encode() + b"|" + np.ascontiguousarray(rows, np.int64).tobytes()


@dataclasses.dataclass
class CacheEntry:
    """One pinned block: its device payload and the wire bytes it replaces
    (its residency on the card for every wire)."""

    payload: object
    nbytes: int


class HotRowBlockCache:
    """Block cache with violation-recency pinning.

    Per compaction: ``plan(keys, nbytes, scores)`` ranks the compacted blocks
    (ascending score pins first), pins greedily under ``budget_bytes`` and
    evicts entries that fell out of the plan; surviving entries keep their
    payloads.  Cheap epochs then ``lookup`` each block: a hit returns the
    entry, a miss ships and ``put``s the payload if the plan wants it.

    Invariants: resident bytes never exceed the budget, and every hit is a
    planned key."""

    def __init__(self, budget_bytes: int):
        self.budget = max(0, int(budget_bytes))
        self._entries: Dict[bytes, CacheEntry] = {}
        self._pinned: set = set()
        self.resident_bytes = 0
        self.peak_resident_bytes = 0
        self.evictions = 0

    # ------------------------------------------------------------- planning
    def plan(self, keys: Sequence[bytes], nbytes: Sequence[int],
             scores: Sequence[float]) -> set:
        """The pin set of a new compaction: blocks in ascending ``scores``
        (ties in block order) while their wire bytes fit the budget; entries
        outside it are evicted.  Returns the planned keys."""
        order = np.argsort(np.asarray(scores, np.float64), kind="stable")
        pinned: set = set()
        total = 0
        for i in order:
            nb = int(nbytes[i])
            if total + nb <= self.budget:
                pinned.add(keys[i])
                total += nb
        self._pinned = pinned
        for key in [k for k in self._entries if k not in pinned]:
            self.resident_bytes -= self._entries.pop(key).nbytes
            self.evictions += 1
        return pinned

    def invalidate(self) -> None:
        """Drop everything (the union grew back to all of G, or nothing is
        live)."""
        self.plan([], [], [])

    # ------------------------------------------------------------ hit / miss
    def lookup(self, key: bytes) -> Optional[CacheEntry]:
        return self._entries.get(key)

    def wants(self, key: bytes, nbytes: int) -> bool:
        """Whether ``put(key, ..., nbytes)`` would store: the plan pins the
        key, it is not resident yet, and it fits.  Lets a miss copy straight
        into memory the cache will own."""
        return (key in self._pinned and key not in self._entries
                and self.resident_bytes + nbytes <= self.budget)

    def put(self, key: bytes, payload: object, nbytes: int) -> bool:
        """Pin a block's payload if the plan wants it and it fits; True when
        stored.  A second ``put`` of a key is a no-op (the first payload
        stays; both decode alike)."""
        if not self.wants(key, nbytes):
            return False
        self._entries[key] = CacheEntry(payload=payload, nbytes=int(nbytes))
        self.resident_bytes += int(nbytes)
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self.resident_bytes)
        return True

    # ----------------------------------------------------------- observability
    @property
    def n_entries(self) -> int:
        return len(self._entries)

    @property
    def planned_keys(self) -> set:
        return set(self._pinned)

    def planned_fraction(self, keys: Sequence[bytes],
                         nbytes: Sequence[int]) -> float:
        """Share of the given blocks' wire bytes the plan pins: the cheap
        epochs' hit rate once the cache is warm."""
        total = int(np.sum(np.asarray(nbytes, np.int64))) if len(nbytes) else 0
        if total == 0:
            return 0.0
        hit = sum(int(nb) for k, nb in zip(keys, nbytes) if k in self._pinned)
        return hit / total


def violation_recency_scores(union: np.ndarray, tile: int,
                             unchanged: np.ndarray,
                             active_masks: np.ndarray) -> List[float]:
    """A score a block of the compacted ``union``: ``unchanged`` and
    ``active_masks`` are (T_live, n); a row's recency is its smallest counter
    over the tasks it is active for, a block's the smallest of its rows.
    Lower is hotter."""
    if len(union) == 0:
        return []
    u = np.where(active_masks[:, union], unchanged[:, union],
                 np.iinfo(np.int64).max).min(axis=0)
    return [float(u[s:s + tile].min()) for s in range(0, len(union), tile)]


def violation_recency_scores_tasks(union: np.ndarray, tile: int,
                                   u_windows: Sequence[np.ndarray],
                                   id_windows: Sequence[np.ndarray],
                                   ) -> List[float]:
    """``violation_recency_scores`` from each live task's (counters, global
    ids) of its active rows, in O(sum of active rows)."""
    if len(union) == 0:
        return []
    best = np.full(len(union), np.iinfo(np.int64).max, np.int64)
    for u, ids in zip(u_windows, id_windows):
        if len(ids):
            np.minimum.at(best, np.searchsorted(union, ids),
                          np.asarray(u, np.int64))
    return [float(best[s:s + tile].min())
            for s in range(0, len(union), tile)]


def stage2_cache_budget(rank: int, n_tasks: int, tile: int,
                        prefetch: int, cfg: StreamConfig) -> int:
    """The cache's bytes: an explicit ``cache_budget_bytes``, else what
    ``device_budget_bytes`` leaves after the task weights and ``prefetch``
    blocks in flight; 0 with the cache off."""
    from repro_torch.core.solver_stream import (stage2_block_bytes,
                                                stage2_resident_bytes)

    if not cfg.cache_blocks:
        return 0
    if cfg.cache_budget_bytes is not None:
        return max(0, int(cfg.cache_budget_bytes))
    rem = (cfg.device_budget_bytes
           - stage2_resident_bytes(rank, n_tasks)
           - max(1, prefetch) * stage2_block_bytes(tile, rank, n_tasks))
    return max(0, int(rem))


def block_wire_nbytes(tile: int, rank: int, wire: str, group: int) -> int:
    """Wire (and cached) bytes of one (tile, rank) block: compacted int8
    blocks carry a table entry a row, whatever ``group``."""
    from repro_torch.core.quant import quant_scale_bytes

    if wire == "bf16":
        return tile * rank * (BYTES_F32 // 2)
    if wire == "int8":
        return tile * rank + quant_scale_bytes(tile, 1)
    return tile * rank * BYTES_F32
