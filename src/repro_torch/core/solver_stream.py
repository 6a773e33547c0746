"""Out-of-core stage 2: stream G row blocks from pinned host memory through
kernel B2 (PyTorch port of ``repro.core.solver_stream``).

The paper's layout: the task state on the card, G in host RAM.

    host RAM (pinned)                      card
    G      (n, B')   read-only             every task's idx, y, c, alpha,
    act_G  (U, B')   the active-row union  unchanged (T, n_pad) and w (T, B');
                     after a full pass     per block in flight: (tile, B') rows

The task state is O(sum of task sizes) and stays on the card for the whole
solve; only G blocks cross the bus.  Each task's real rows are kept in sorted
global order (``sidx``), so the sweep order is the monolithic one and the
trajectory with it.  A block is ONE launch of B2 over every live task in its
window form: task t sweeps its positions ``lo[t]:hi[t]`` (a precomputed
``block_windows`` table, on the card) and reads block row
``sidx[t, i] - row0``.  q (n floats) is summed on the card from the blocks
of the first pass and kept there, bit for bit ``solve_batch``'s q, and w
stays in the kernel's hands across blocks, so a block costs no gather, no
scatter and no host sync.

Shrinking cuts the bytes, as in the reference: after every full pass the
union of the rows still active for a live task is gathered from G into a
pinned buffer (and their q on the card), and the cheap epochs until the next
full pass stream only that union.  A compacted index table maps each
position to its row in the union; an inactive position takes the next
active one's row, so the table stays monotone and every window contiguous
(the kernel skips inactive positions without reading them).  The ``tol``
test runs on full passes, and a warm start accumulates w0 block by block in
a streamed init pass first: fp64 products of the warm tasks' coefficients
with the block, rounded once at the end.

The task axis can carry C ladders (``chain_next``, the grid task farm of
``core/cv.py``): a successor task starts dormant; when its predecessor
converges at a full pass it takes the converged alphas clipped into its own
box (on the card), sums its w0 from the blocks of the next pass, which that
promotes to a full pass, and sweeps from the epoch after.  The live, pending
and done flags come to the host once per full pass with the convergence
test; alpha, w and the counters never leave the card.

The solve is split as the reference splits it: an engine a worker
(``_Stage2Engine``: its tasks' state on its device, its streams, ring and
block cache), one shared reader (``_SharedReader``: each block of G read and
staged once a shared pass, however many engines consume it) and one
lockstep driver (``drive_streamed_engines``) that runs the epoch schedule.
``solve_batch_streamed`` is the one-engine instance, on the caller's thread
and stream; ``core/distributed.py``'s task farm drives an engine a device
entry, each on a host thread of its own, and ``solve_streamed_auto`` routes
to it where there is more than one device.

Blocks go through a ring of ``prefetch`` device slots: the H2D stream fills
a slot, the compute stream waits for that copy by event and launches B2, and
before a slot is filled again the host waits on the event recorded after the
launch that read it.  bf16 blocks are cast on the host into one of the
reader's pinned buffers and upcast on the card into one fp32 buffer of the
compute stream.

int8 blocks (the reference's wire): a shared-pass block is encoded on the
host each pass with scale groups of ``wire_group(tile)`` rows, which divide
the tile, so every group is global-row-aligned; a ragged tail is padded
after encoding (``encode_block``).  A compaction encodes its active rows
once, each row under its global group's (scale, zero) with one entry a row
(``encode_compacted``), so a row decodes alike in a full pass and in a
cheap epoch.  The ring ships codes and scale table and dequantises them on
the card (``quant.dequant_into``) into the fp32 buffer before B2 reads it;
every pass uses that one op sequence.  ``bytes_h2d``, ``bytes_g`` and
``epoch_bytes`` count codes plus tables (``bytes_scales`` the tables).

The block cache (``core/block_cache.py``, ``StreamConfig.cache_blocks``):
each compaction also plans which of the union's blocks to keep on the card
(violation recency, under ``stage2_cache_budget``); a cheap epoch looks each
block up, decodes a hit from its pinned wire arrays by the ops a shipped
block goes through (``_Ring.decode``), and ships a miss, into memory the
cache then owns when the plan wants it.  Shared passes never touch it.
Evictions happen at a compaction, after the full pass's flags have been read
back, so no queued launch reads an evicted payload.

Checkpoints (``core/resilience.py``): with ``checkpoint_dir`` the solver's
state is snapshot at full-pass boundaries; a resume restores it, re-runs
the compaction (the cache starts cold) and continues at the next epoch, bit
for bit.  Fault sites (``core/faults.py``): "reader" before the shared
reader stages a block, "h2d" before a worker's copies of a block (its
``device`` name), "epoch_boundary" after each epoch.

The disk tier (``core/shards.py``): G may be a ``GShardView`` of a G that
stage 1 spilled to f32 shards.  Every shared pass then reads G's shards
from disk, checks their digests and stages the rows through the reader's
pinned buffers; a compaction gathers the union's rows into the pinned
``act_G`` (on the int8 wire it encodes them there, under a table computed
shard by shard).  The cheap epochs read ``act_G`` and the card's cache,
never the disk.  A shard that fails its checksum is rebuilt from stage 1's
chunks (``streaming._g_rebuilder``) before its rows are used.

Under a tracer (``StreamConfig.trace``, else an installed one) the host
spans are the reference's: ``h2d`` / ``put_block`` (their sum is
``put_seconds``), ``drain`` (``block_wait``, ``flags``, ``result``),
``encode`` / ``stage2_quant``, the reader's ``read`` / ``stage_block`` (a
block cast, encoded or read from shards into its pinned buffer),
``compact`` / ``recompact`` and ``epoch`` / ``epoch_{k}`` (its attrs summed
over the engines, ``devices`` the live ones) with the counters
``stage2/epoch_bytes``,
``stage2/active_rows`` and ``stage2/row_visits``; on the card the H2D copies
(``h2d`` / ``copy_block``) and the launches (``kernel``: ``smo_block``
around each B2 launch with its rows and tasks, ``row_sq``, ``init_sums``,
``dequant``, ``upcast``) are device spans.  An epoch's ``viol`` attribute is
read where the full pass already syncs; a cheap epoch has none, and its
``hit_bytes`` / ``miss_bytes`` split its compacted bytes.  The cache's
instants are ``cache`` / ``plan``, ``hit``, ``miss``, ``invalidate``; a
resume is the span ``recovery`` / ``resume``, a snapshot the instant
``recovery`` / ``checkpoint``, a retried copy ``fault`` / ``h2d_retry``.  On
the farm each worker's spans lie on its own host thread's row and its
device spans on its own rows (``cuda:0/w1 compute``, ``cuda:0/w1 h2d``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.block_cache import (HotRowBlockCache, block_key,
                                          block_wire_nbytes, stage2_cache_budget,
                                          violation_recency_scores_tasks)
from repro_torch.core.dual_solver import (INT32_MAX, SolveResult, SolverConfig,
                                          TaskBatch)
from repro_torch.core.faults import check as fault_check
from repro_torch.core.faults import classify_error
from repro_torch.core.kernel_fn import full_fp32
from repro_torch.core.quant import (ENCODE_ROWS, QuantBlock, dequant_into,
                                    encode_rows, quantize_block)
from repro_torch.core import shards
from repro_torch.core.streaming import (BYTES_F32, Lanes, StreamConfig,
                                        StreamTimes, check_host, host_buffer,
                                        tune_prefetch, wait, worker_context)
from repro_torch.core.trace import NULL, resolve
from repro_torch.kernels.ops import smo_epoch, smo_epoch_scratch

WIRE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


# ---------------------------------------------------------------------------
# the stage-2 byte model (the reference's)
# ---------------------------------------------------------------------------

def stage2_resident_bytes(rank: int, n_tasks: int) -> int:
    """Device-resident stage-2 state: one (B,) weight vector per task."""
    return n_tasks * rank * BYTES_F32


def stage2_block_bytes(tile: int, rank: int, n_tasks: int) -> int:
    """Working set of ONE in-flight block: the G tile plus, per task, the
    five input vectors (y, c, q, alpha, unchanged) and two outputs."""
    return tile * (rank + 7 * n_tasks) * BYTES_F32


def stage2_monolithic_bytes(n: int, rank: int, n_tasks: int, n_pad: int) -> int:
    """Device working set of `solve_batch`: full G + per-task vectors."""
    return (n * rank + n_tasks * (7 * n_pad + 2 * rank)) * BYTES_F32


def should_stream_stage2(n: int, rank: int, n_tasks: int, n_pad: int,
                         cfg: StreamConfig) -> bool:
    """True when the monolithic stage-2 working set blows the device budget."""
    return stage2_monolithic_bytes(n, rank, n_tasks, n_pad) > cfg.device_budget_bytes


def route_stage2(factor, tasks: TaskBatch, stream,
                 stream_config: Optional[StreamConfig],
                 solve_fn, default_solve_fn) -> bool:
    """The stage-2 routing predicate: stream G row blocks when G is already
    host-resident (``factor.streamed``), streaming is forced, or the
    monolithic working set exceeds the device budget.  A custom ``solve_fn``
    is always respected, and ``stream=False`` pins the monolithic path."""
    if solve_fn is not default_solve_fn or stream is False:
        return False
    if stream or getattr(factor, "streamed", False):
        return True
    if stream_config is None:
        return False
    n, rank = factor.G.shape
    return should_stream_stage2(n, rank, tasks.n_tasks, tasks.idx.shape[1],
                                stream_config)


def auto_tile_rows(n: int, rank: int, n_tasks: int, cfg: StreamConfig) -> int:
    """Largest row tile whose ``prefetch`` in-flight blocks fit the budget,
    floored at ``min_chunk_rows`` and rounded to a multiple of 8.  An
    explicit ``cache_budget_bytes`` is carved out of the budget first (with
    the cache on); the derived cache budget is what this leaves, so it never
    shrinks the tile."""
    if cfg.tile_rows is not None:
        return max(8, -(-min(cfg.tile_rows, n) // 8) * 8)
    free = cfg.device_budget_bytes - stage2_resident_bytes(rank, n_tasks)
    if cfg.cache_blocks and cfg.cache_budget_bytes:
        free -= cfg.cache_budget_bytes
    per_row = cfg.prefetch * (rank + 7 * n_tasks) * BYTES_F32
    rows = (free // per_row) // 8 * 8 if free > 0 else 0   # round down: budget
    return int(min(-(-n // 8) * 8, max(cfg.min_chunk_rows, rows, 8)))


def wire_group(tile: int, cfg: StreamConfig) -> int:
    """Rows of an int8 scale group for a block tile: gcd(tile, requested),
    so that group boundaries align with block boundaries and a row's group
    is the same in a shared-pass block and in a compacted one."""
    return math.gcd(tile, max(1, cfg.quant_group_rows))


def pad_quant_block(qb: QuantBlock, tile: int) -> QuantBlock:
    """A quantised block padded to ``tile`` rows: zero codes, and inert
    (scale 1, zero 0) entries for the scale groups that hold only pad
    rows, which then decode to exact zeros (the reference's)."""
    cnt, ng = qb.values.shape[0], qb.scales.shape[0]
    values = np.zeros((tile, qb.values.shape[1]), np.int8)
    values[:cnt] = qb.values
    scales = np.zeros((-(-tile // qb.group), 2), np.float32)
    scales[:ng] = qb.scales
    scales[ng:, 0] = 1.0
    return QuantBlock(values=values, scales=scales, group=qb.group)


def encode_block(gb: np.ndarray, tile: int, group: int) -> QuantBlock:
    """A shared-pass G block on the int8 wire (the reference's
    ``prep_block``): quantised from its real rows in groups of ``group``
    rows, then padded to ``tile`` rows."""
    qb = quantize_block(np.asarray(gb, np.float32), group)
    return qb if gb.shape[0] == tile else pad_quant_block(qb, tile)


def encode_compacted(G: np.ndarray, gscales: np.ndarray, group: int,
                     union: np.ndarray, tile: int, codes: np.ndarray,
                     table: np.ndarray) -> int:
    """The compacted rows ``G[union]`` on the int8 wire (the reference's
    ``_encode_compacted``, its blocks laid end to end), written into
    ``codes`` (int8) and ``table`` (fp32, a row an entry): each row under its
    global group's (scale, zero) from ``gscales = group_scales(G, group)``,
    the tail padded to whole tiles as ``pad_quant_block`` pads it.  Rows
    are gathered ``quant.ENCODE_ROWS`` at a time.  Returns the padded row
    count."""
    U = len(union)
    u_pad = -(-max(U, 1) // tile) * tile
    table[:U] = gscales[union // group]
    table[U:u_pad] = (1.0, 0.0)
    codes[U:u_pad] = 0
    for s in range(0, U, ENCODE_ROWS):
        e = min(s + ENCODE_ROWS, U)
        encode_rows(G[union[s:e]], table[s:e], out=codes[s:e])
    return u_pad


def block_windows(ids: np.ndarray, tile: int, n_blocks: int) -> np.ndarray:
    """Boundary table of a task's SORTED global row ids against the block
    grid: entry b is the first position in ``ids`` at or past row b * tile,
    so block b's window is the slice bounds[b]:bounds[b + 1]."""
    edges = np.arange(n_blocks + 1, dtype=np.int64) * tile
    return np.searchsorted(np.asarray(ids, np.int64), edges, side="left")


# ---------------------------------------------------------------------------
# stats and the block ring
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Stage2StreamStats(StreamTimes):
    """Traffic and convergence accounting of one streamed stage-2 solve.

    ``bytes_h2d`` counts the G blocks plus the index tables; on the int8
    wire a block's bytes are its codes plus its scale table.  On the farm a
    shared-pass block counts once in ``bytes_h2d`` (the reader staged it
    once) and once a worker in ``bytes_put`` (each worker copied it).

    Every block of a compacted (cheap) epoch is a hit or a miss of the block
    cache, never both: ``bytes_miss`` crossed the bus (inside ``bytes_g``),
    ``bytes_hit`` was decoded from the card instead.  With the cache off
    every such block is a miss, so a cached solve's ``bytes_hit +
    bytes_miss`` is the uncached one's ``bytes_miss``, and its ``bytes_h2d``
    the uncached one's less ``bytes_hit``.  After a resume the counters
    include the segments before it (``resilience.apply_carry``)."""

    tile_rows: int = 0
    epochs: int = 0                   # epochs run (the longest task's)
    full_passes: int = 0
    blocks_streamed: int = 0
    rows_streamed: int = 0            # G rows over all blocks and passes
    kernel_calls: int = 0             # B2 launches: one per block, all tasks
    coord_visits: int = 0             # task rows inside the windows swept
    bytes_g: int = 0                  # the G-block part of bytes_h2d
    bytes_d2h: int = 0                # shrink counters, live flags per full pass
    epoch_bytes: List[int] = dataclasses.field(default_factory=list)
    # ^ G bytes each epoch streamed (a warm start's init pass comes before)
    active_history: List[int] = dataclasses.field(default_factory=list)
    # ^ active-row union size at each compaction
    block_dtype: str = "f32"
    bytes_scales: int = 0             # int8 scale tables (inside bytes_g)
    encode_seconds: float = 0.0       # host time in the int8 encoder
    compact_seconds: float = 0.0      # host time building compactions
    init_seconds: float = 0.0         # a warm start's init pass, to its end
    prefetch_final: int = 0           # queue depth after autotune
    scratch_bytes: int = 0            # B2's active-list scratch on the card
    bytes_hit: int = 0                # compacted G bytes served by the cache
    bytes_miss: int = 0               # compacted G bytes shipped
    cache_hits: int = 0               # the same in blocks
    cache_misses: int = 0             # (counted with the cache on only)
    cache_evictions: int = 0
    cache_resident_bytes: int = 0     # the cache's peak on the card
    epoch_hit_bytes: List[int] = dataclasses.field(default_factory=list)
    epoch_miss_bytes: List[int] = dataclasses.field(default_factory=list)
    # ^ per epoch, index-aligned with epoch_bytes
    snapshots: int = 0                # checkpoints written
    snapshot_seconds: float = 0.0     # host time writing them
    snapshot_bytes: int = 0           # the newest one's file size
    resumed_from: int = -1            # the epoch a resume started at
    resume_seconds: float = 0.0       # loading, restoring, recompacting
    # -- the multi-device farm (core/distributed.py) --------------------------
    n_devices: int = 1                # workers (device entries) that solved
    bytes_put: int = 0                # physical H2D bytes: every worker's copy
                                      # of a shared block counts (bytes_h2d
                                      # counts it once); == bytes_h2d at one
    resplits: int = 0                 # device losses re-split onto survivors
    per_device: Optional[List["Stage2StreamStats"]] = None   # a worker's own

    @property
    def epoch_hit_rate(self) -> List[float]:
        """Per epoch, the cache's share of the compacted G bytes (0.0 where
        an epoch had none, full passes for one)."""
        return [h / (h + m) if h + m else 0.0
                for h, m in zip(self.epoch_hit_bytes, self.epoch_miss_bytes)]


class _Ring:
    """``prefetch`` device slots of (tile, B') wire rows, fed from host rows.

    ``load`` fills the next slot (after the event of the launch that last
    read it) and returns the block as fp32 on the card; ``release`` records
    that event once the block's launches are queued.  On the int8 wire a
    slot also holds a scale table, and ``load`` takes (codes, table) host
    tensors padded to the tile and decodes them into the fp32 buffer.
    ``load(..., shared=True)`` is a copy of a block the shared reader staged
    and counted: only ``bytes_put`` counts it here.

    ``load(..., keep=True)`` copies into new device tensors instead of a
    slot and returns them: the block cache's payload, which the ring never
    reuses.  ``decode`` turns wire arrays on the card into the fp32 block by
    the one op sequence of a shipped block and of a cached one.

    Each block's copies pass fault site "h2d" (``device``: the worker's
    name, ``epoch``, ``block``) before they are issued; with ``retries`` a
    transient fault is retried after ``backoff`` seconds, doubled each time,
    and the copies are issued again whole, so a retried block is the block.
    A persistent fault (the device is lost) is raised: the farm re-splits
    the worker's tasks over its survivors, a lone worker has none."""

    def __init__(self, tile: int, rank: int, wire: str, device,
                 prefetch: int, lanes: Lanes, st: Stage2StreamStats, tr=NULL,
                 retries: int = 0, backoff: float = 0.0, name: str = ""):
        self.tile, self.rank, self.device = tile, rank, device
        self.wire = WIRE[wire]
        self.quant = wire == "int8"
        self.prefetch = prefetch
        self.lanes, self.st, self.tr = lanes, st, tr
        self.retries, self.backoff = retries, backoff
        self.name = name
        self.epoch = -1                      # the fault site's epoch attr
        self.slots: List[dict] = []
        self.count = 0
        self.upcast = (torch.empty((tile, rank), dtype=torch.float32, device=device)
                       if self.wire != torch.float32 else None)

    def _slot(self, k: int) -> dict:
        while k >= len(self.slots):          # autotune may deepen the ring
            dev = [torch.empty((self.tile, self.rank), dtype=self.wire,
                               device=self.device)]
            if self.quant:                   # one table entry a row at most
                dev.append(torch.empty((self.tile, 2), dtype=torch.float32,
                                       device=self.device))
            self.slots.append(dict(dev=dev, stage=[None] * len(dev), done=None))
            self.lanes.claim()
        return self.slots[k]

    def _stage(self, slot: dict, j: int, src) -> torch.Tensor:
        """``src`` as the slot's wire dtype in memory the copy may read
        without blocking: as it is when it already is (pinned on the card),
        else through the slot's pinned staging buffer."""
        want = slot["dev"][j].dtype
        if src.dtype == want and not (self.lanes.cuda and not src.is_pinned()):
            return src
        if slot["stage"][j] is None:
            slot["stage"][j] = host_buffer(tuple(slot["dev"][j].shape), want,
                                           self.device)
        staged = slot["stage"][j][:src.shape[0]]
        staged.copy_(src)
        return staged

    def _copy(self, devs, srcs, block: int) -> None:
        attempt = 0
        while True:
            try:
                fault_check("h2d", device=self.name, epoch=self.epoch, block=block)
                for d, a in zip(devs, srcs):
                    self.lanes.put(d, a, "copy_block")
            except Exception as exc:
                if attempt >= self.retries or classify_error(exc) != "transient":
                    raise
                self.tr.instant("fault", "h2d_retry", device=self.name, epoch=self.epoch,
                                block=block, attempt=attempt, error=type(exc).__name__)
                delay = self.backoff * (2.0 ** attempt)
                if delay > 0:
                    time.sleep(delay)
                attempt += 1
                continue
            if attempt:
                self.tr.instant("recovery", "h2d_retry_ok", device=self.name,
                                epoch=self.epoch, block=block, attempts=attempt)
            return

    def load(self, src, rows: Optional[int] = None, group: int = 1,
             block: int = 0, keep: bool = False, shared: bool = False):
        """The next block on the card: (fp32 rows, its slot or None, its
        wire arrays on the card).  ``src`` is a host tensor of rows, or on
        the int8 wire a (codes, table) pair with ``group`` rows a table
        entry; ``rows`` of it are real."""
        tr, st = self.tr, self.st
        srcs = src if self.quant else (src,)
        r = srcs[0].shape[0] if rows is None else rows
        if keep:
            # new memory the cache owns, for host rows already in the wire
            # dtype (a compaction's): the H2D stream waits for the compute
            # stream's queued work, which may still read the memory the
            # allocator hands out (Lanes.claim)
            slot = None
            devs = [torch.empty(a.shape, dtype=a.dtype, device=self.device)
                    for a in srcs]
            self.lanes.claim()
            t0 = tr.begin()
        else:
            k = self.count % self.prefetch
            self.count += 1
            slot = self._slot(k)
            t0 = tr.begin()
            wait(slot["done"])
            st.drain_seconds += tr.end("drain", "block_wait", t0)
            t0 = tr.begin()
            srcs = [self._stage(slot, j, a) for j, a in enumerate(srcs)]
            devs = [slot["dev"][j][:a.shape[0]] for j, a in enumerate(srcs)]
        self._copy(devs, srcs, block)
        nbytes = sum(a.nbytes for a in srcs)
        st.put_seconds += tr.end("h2d", "put_block", t0, bytes=nbytes, rows=r)
        st.bytes_put += nbytes
        if not shared:
            st.bytes_h2d += nbytes
            st.bytes_g += nbytes
            st.blocks_streamed += 1
            st.rows_streamed += r
            if self.quant:
                st.bytes_scales += srcs[1].nbytes
        return self.decode(devs, r, group), slot, devs

    def decode(self, devs, r: int, group: int) -> torch.Tensor:
        """The fp32 block of ``r`` rows from its wire arrays on the card."""
        tr = self.tr
        if self.upcast is None:
            return devs[0][:r]
        if self.quant:
            g = self.upcast[:devs[0].shape[0]]
            with tr.device_span("kernel", "dequant", self.device, rows=r):
                dequant_into(devs[0], devs[1], group, g)
            return g[:r]
        g = self.upcast[:r]
        with tr.device_span("kernel", "upcast", self.device, rows=r):
            g.copy_(devs[0][:r])
        return g

    def release(self, slot) -> None:
        if slot is not None:
            slot["done"] = self.lanes.mark()


# ---------------------------------------------------------------------------
# the shared block reader
# ---------------------------------------------------------------------------

class _Staged:
    """A host block the shared reader staged once for ``users`` workers (its
    pinned buffers, ``bufs``): free again when each of them has issued its
    copy out of it and, on the card, that copy has completed.  A feed that
    is skipped (the farm failed) releases it too."""

    def __init__(self, bufs: List[torch.Tensor]):
        self.bufs = bufs
        self.cond = threading.Condition()
        self.users = 0
        self.events: List = []

    def arm(self, users: int) -> None:
        with self.cond:
            self.users, self.events = users, []

    def release(self, event=None) -> None:
        with self.cond:
            if event is not None:
                self.events.append(event)
            self.users -= 1
            self.cond.notify_all()

    def wait_free(self, watchdog: float, diagnose) -> None:
        deadline = time.monotonic() + watchdog if watchdog > 0 else None
        with self.cond:
            while self.users > 0:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    break
                self.cond.wait(left)
            starved, users = self.users > 0, self.users
            events, self.events = self.events, []
        if starved:
            from repro_torch.core.resilience import WatchdogTimeout
            raise WatchdogTimeout(
                f"shared reader starved past {watchdog:.1f}s: a staged block is "
                f"still held by {users} worker(s); worker states:\n" + diagnose())
        for ev in events:
            wait(ev)


class _SharedReader:
    """The shared block reader of the streamed stage 2 (the reference's
    ``iter_shared_blocks``): each (tile, B') row block of G is read and
    staged ONCE a shared pass, however many workers consume it, and counted
    once in its record (``st``: ``bytes_h2d``, ``bytes_g``, ``epoch_bytes``
    of the shared passes).  A block of an in-memory G on the f32 wire is
    G's own pinned rows; a bf16 block is cast, an int8 block encoded
    (``encode_block``) and a spilled G's rows are read from its shards, into
    one of ``depth`` pinned buffers, reused once every worker's copy out of
    it has completed.  Fault site "reader" (``block``) comes before each
    block's staging."""

    def __init__(self, G, tile: int, cfg: StreamConfig, cuda: bool, tr=NULL,
                 depth: int = 2, diagnose=lambda: ""):
        self.G, self.G_np = G, shards.numpy_rows(G)
        self.view = shards.is_shard_view(G)
        self.n, self.rank = G.shape
        self.tile = tile
        self.n_blocks = -(-self.n // tile)
        self.wire = cfg.block_dtype
        self.quant = self.wire == "int8"
        self.group = wire_group(tile, cfg) if self.quant else 1
        self.pin = "cuda" if cuda else "cpu"
        self.tr = tr
        self.watchdog = cfg.watchdog_seconds
        self.diagnose = diagnose
        self.st = Stage2StreamStats(tile_rows=tile, block_dtype=cfg.block_dtype)
        self.pool: List[Optional[_Staged]] = [None] * max(2, depth)
        self.k = 0

    def _buffer(self) -> _Staged:
        k = self.k % len(self.pool)
        self.k += 1
        if self.pool[k] is None:
            shapes = [((self.tile, self.rank), WIRE[self.wire])]
            if self.quant:
                shapes.append(((self.tile, 2), torch.float32))
            self.pool[k] = _Staged([host_buffer(s, d, self.pin) for s, d in shapes])
        else:
            self.pool[k].wait_free(self.watchdog, self.diagnose)
        return self.pool[k]

    def blocks(self, users: int):
        """Yield ``(b, s, e, src, group, staged)`` for every block of G:
        ``src`` the host wire rows (a (codes, table) pair on the int8 wire),
        ``staged`` the ``_Staged`` each of the ``users`` workers releases
        after its copy (None for G's own rows)."""
        tr, st, tile = self.tr, self.st, self.tile
        for b in range(self.n_blocks):
            s, e = b * tile, min((b + 1) * tile, self.n)
            fault_check("reader", block=b)
            staged = None
            if self.quant:
                t0 = tr.begin()
                qb = encode_block(self.G_np[s:e], tile, self.group)
                st.encode_seconds += tr.end("encode", "stage2_quant", t0, rows=e - s)
                t0 = tr.begin()
                staged = self._buffer()
                codes, table = staged.bufs
                codes.copy_(torch.from_numpy(qb.values))
                ng = qb.scales.shape[0]
                table[:ng].copy_(torch.from_numpy(qb.scales))
                src = (codes, table[:ng])
            elif self.view or self.wire != "f32":
                t0 = tr.begin()
                staged = self._buffer()
                src = shards.rows_into(self.G, s, e, staged.bufs[0][:e - s])
            else:
                src = self.G[s:e]
            srcs = src if self.quant else (src,)
            nbytes = sum(a.nbytes for a in srcs)
            if staged is not None:
                staged.arm(users)
                tr.end("read", "stage_block", t0, bytes=nbytes, rows=e - s, block=b)
            st.bytes_h2d += nbytes
            st.bytes_g += nbytes
            st.blocks_streamed += 1
            st.rows_streamed += e - s
            if self.quant:
                st.bytes_scales += srcs[1].nbytes
            yield b, s, e, src, self.group, staged


class _Scales:
    """The int8 wire's global group table of G, computed once for every
    worker of a solve (``shards.group_scales``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.table: Optional[np.ndarray] = None

    def get(self, G, group: int) -> np.ndarray:
        with self._lock:
            if self.table is None:
                self.table = shards.group_scales(G, group)
            return self.table


# ---------------------------------------------------------------------------
# the streamed solver: one engine a worker, one lockstep driver
# ---------------------------------------------------------------------------

# torch's CUDA row sum of a (rows, B') tensor takes its lane layout from B'
# alone once it sums 16 rows or more (block height min(pow2(rows), 16)); on
# fewer rows it widens the lanes per row and adds in another order.
ROW_SQ_MIN_ROWS = 16

# the warm-start sums' products: rows of a block by pending tasks at a time
INIT_ROWS = 1024
INIT_TASKS = 16


def _row_sq(gb: torch.Tensor, out: torch.Tensor, piece: int = 1024) -> None:
    """q = ||g_r||^2 of every row of a block, in the order of ``solve_batch``'s
    q = (G * G).sum(-1) over the whole G.  The block is summed ``piece`` rows
    at a time, so that the squares never hold a second block's worth of
    device memory, and no sum covers fewer than ``ROW_SQ_MIN_ROWS`` rows: a
    short tail joins the piece before it, and a block that short is summed
    zero-padded.  Writes the (rows,) result into ``out``."""
    r = gb.shape[0]
    if r < ROW_SQ_MIN_ROWS:
        padded = gb.new_zeros((ROW_SQ_MIN_ROWS, gb.shape[1]))
        padded[:r] = gb
        out.copy_((padded * padded).sum(-1)[:r])
        return
    starts = list(range(0, r, piece))
    if len(starts) > 1 and r - starts[-1] < ROW_SQ_MIN_ROWS:
        starts.pop()
    for s, e in zip(starts, starts[1:] + [r]):
        rows = gb[s:e]
        torch.sum(rows * rows, dim=-1, out=out[s:e])


def _sorted_layout(idx: np.ndarray, c: np.ndarray):
    """Per task: its real (c > 0) positions in sorted global row order,
    then the rest.  Returns the permutation (T, n_pad) and real counts."""
    T, n_pad = idx.shape
    perm = np.empty((T, n_pad), np.int64)
    m = np.zeros((T,), np.int64)
    for t in range(T):
        real = np.where(c[t] > 0.0)[0]
        order = np.argsort(idx[t][real], kind="stable")
        rest = np.where(~(c[t] > 0.0))[0]
        perm[t] = np.concatenate([real[order], rest])
        m[t] = len(real)
    return perm, m


def _upload(a: np.ndarray, device, st: Stage2StreamStats) -> torch.Tensor:
    st.bytes_h2d += a.nbytes
    st.bytes_put += a.nbytes
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _compaction(sidx: np.ndarray, m: np.ndarray, active: np.ndarray,
                tile: int):
    """The cheap epochs' view of the active rows (see the module docstring):
    the union, the compacted index table (T, n_pad), its window table
    (n_blocks + 1, T) and the active positions inside each window."""
    T, n_pad = sidx.shape
    union = np.unique(np.concatenate(
        [sidx[t, :m[t]][active[t, :m[t]]] for t in range(T)]
        + [np.zeros((0,), sidx.dtype)]))
    U = len(union)
    n_blocks = -(-U // tile)
    edges = np.minimum(np.arange(n_blocks + 1, dtype=np.int64) * tile, U)
    cidx = np.full((T, n_pad), U, np.int64)
    bounds = np.zeros((n_blocks + 1, T), np.int64)
    visits = np.zeros((n_blocks, T), np.int64)
    for t in range(T):
        act_t = active[t, :m[t]]
        col = np.full((m[t],), U, np.int64)
        col[act_t] = np.searchsorted(union, sidx[t, :m[t]][act_t])
        # inactive positions take the next active one's row: monotone
        col = np.minimum.accumulate(col[::-1])[::-1]
        cidx[t, :m[t]] = col
        bounds[:, t] = np.searchsorted(col, edges, side="left")
        seen = np.concatenate([[0], np.cumsum(act_t)])
        visits[:, t] = seen[bounds[1:, t]] - seen[bounds[:-1, t]]
    return union, cidx.astype(np.int32), bounds.astype(np.int32), visits


def _chain(chain_next, T: int, perm: np.ndarray, m: np.ndarray,
           sidx: np.ndarray) -> np.ndarray:
    """``chain_next`` as a (T,) int64 table (-1: no successor), checked: a
    successor is another task of the batch and covers its predecessor's rows
    in the same sorted layout, so that seeding copies alphas position for
    position."""
    nxt = np.full((T,), -1, np.int64)
    if chain_next is None:
        return nxt
    nxt[:] = np.asarray(chain_next, np.int64).reshape(T)
    for t in np.flatnonzero(nxt >= 0):
        s = int(nxt[t])
        if s >= T or s == t:
            raise ValueError(f"chain_next[{t}] = {s} is not another task of {T}")
        if (m[s] != m[t] or not np.array_equal(perm[s], perm[t])
                or not np.array_equal(sidx[s, :m[t]], sidx[t, :m[t]])):
            raise ValueError(f"chain_next[{t}] = {s}: a successor must cover its "
                             f"predecessor's rows in the same layout")
    return nxt


@dataclasses.dataclass
class _Compacted:
    """The cheap epochs' view after a compaction: the union's rows in pinned
    memory (a (codes, table) pair on the int8 wire), their q, the compacted
    index and window tables, the active positions a window, and the block
    cache's keys and wire bytes a block (None with the cache off)."""

    act: object
    q: torch.Tensor
    cidx: torch.Tensor
    bounds: torch.Tensor
    visits: np.ndarray
    keys: Optional[List[bytes]] = None
    sizes: Optional[List[int]] = None


def host_factor(G, devices):
    """G as the streamed stage 2 reads it: a spilled G's view as it is, else
    a host fp32 tensor, pinned when a device is the card (pageable memory
    raises; a G on the card is first copied to pinned memory)."""
    if shards.is_shard_view(G):
        return G
    cuda = [torch.device(d) for d in devices if torch.device(d).type == "cuda"]
    if not isinstance(G, torch.Tensor):
        G = torch.as_tensor(np.asarray(G, np.float32))
    elif G.is_cuda:                    # a device factor, streamed on request
        G = host_buffer(tuple(G.shape), G.dtype, G.device).copy_(G)
    for d in cuda[:1] or [torch.device("cpu")]:
        check_host(G, d, "G")
    if G.dtype != torch.float32:
        raise TypeError(f"G must be fp32, got {G.dtype}")
    return G


class _Stage2Engine:
    """One worker's streamed stage 2: its share of the tasks, their state on
    its device, its copy and compute streams, its block ring and its block
    cache (the reference's ``_Stage2Engine``).

    The driver (``drive_streamed_engines``) owns the epoch schedule and the
    shared reader; per pass it calls ``begin_pass``, ``feed_block`` with
    each block the reader staged and ``end_pass``, or ``cheap_epoch`` over
    the engine's own compacted union, then ``finish_epoch``.  A farm runs
    each engine's calls on a host thread of its own (``own_stream``: a
    compute stream of its own, so that workers sharing a card overlap, and
    ``tag``, its rows on the tracer); a lone engine runs on the caller's
    thread and stream.  ``task_ids`` are the solve's task indices of this
    engine's tasks, the key of the snapshots."""

    def __init__(self, G, tasks: TaskBatch, config: SolverConfig, cfg: StreamConfig, *,
                 tile: int, chain_next=None, name: Optional[str] = None,
                 tag: Optional[str] = None, task_ids=None,
                 scales: Optional[_Scales] = None, own_stream: bool = False):
        dev = tasks.idx.device
        self.dev = dev
        self.config, self.cfg, self.tile = config, cfg, tile
        self.name = name if name is not None else f"{dev}/w0"
        self.tag = tag
        self.tr = tr = resolve(cfg.trace)
        self.cuda = dev.type == "cuda"
        self.stream = None
        if own_stream and self.cuda:
            self.stream = torch.cuda.Stream(dev)
            self.stream.wait_stream(torch.cuda.current_stream(dev))
        self.G, self.G_np = G, shards.numpy_rows(G)
        n, rank = G.shape
        T, n_pad = tasks.idx.shape
        self.n, self.rank, self.T, self.n_pad = n, rank, T, n_pad
        self.task_ids = (np.arange(T, dtype=np.int64) if task_ids is None
                         else np.asarray(task_ids, np.int64))
        self.scales = scales if scales is not None else _Scales()
        n_blocks = -(-n // tile)
        self.st = st = Stage2StreamStats(tile_rows=tile, block_dtype=cfg.block_dtype)
        with self.on():
            self.lanes = Lanes(dev, tr)
            self.ring = _Ring(tile, rank, cfg.block_dtype, dev, cfg.prefetch, self.lanes,
                              st, tr, retries=0 if cfg.fail_fast else cfg.max_retries,
                              backoff=cfg.retry_backoff, name=self.name)
            self.quant = self.ring.quant
            self.group = wire_group(tile, cfg)
            self.cache = (HotRowBlockCache(stage2_cache_budget(rank, T, tile,
                                                               cfg.prefetch, cfg))
                          if cfg.cache_blocks else None)

            # one-time host bookkeeping: the sorted layout and the window tables
            idx_h = tasks.idx.cpu().numpy().astype(np.int64)
            c_h = tasks.c.cpu().numpy()
            real = c_h > 0.0
            if real.any() and (idx_h[real].min() < 0 or idx_h[real].max() >= n):
                raise ValueError(f"task indices must lie in [0, {n})")
            perm_h, m = _sorted_layout(idx_h, c_h)
            self.m = m
            self.sidx_h = sidx_h = np.take_along_axis(idx_h, perm_h, axis=1)
            self.nxt_h = _chain(chain_next, T, perm_h, m, sidx_h)
            self.bounds_h = np.stack([block_windows(sidx_h[t, :m[t]], tile, n_blocks)
                                      for t in range(T)], axis=1).astype(np.int32)
            self.perm = perm = _upload(perm_h, dev, st)
            self.bounds = _upload(self.bounds_h, dev, st)
            # B2 lists a block's active rows in a scratch sized by the widest
            # window of the shared passes; a wider compacted window is swept
            # in segments
            self.scratch = smo_epoch_scratch(
                T, int(np.diff(self.bounds_h, axis=0).max(initial=1)), dev)
            st.scratch_bytes = 0 if self.scratch is None else self.scratch.numel()
            self.sidx = torch.gather(tasks.idx.to(torch.int32), 1, perm).contiguous()
            self.y = torch.gather(tasks.y.to(torch.float32), 1, perm).contiguous()
            self.c = c = torch.gather(tasks.c.to(torch.float32), 1, perm).contiguous()
            self.alpha = alpha = torch.gather(tasks.alpha0.to(torch.float32), 1,
                                              perm).contiguous()
            self.unchanged = torch.zeros_like(self.sidx)
            self.w = torch.zeros((T, rank), dtype=torch.float32, device=dev)
            # the task states, on the host: B2 sees only ``live`` (its copy on
            # the card); a pending task sums its w0 in the next pass over all
            # of G; a dormant successor (no flag set) waits for its predecessor
            nxt_h = self.nxt_h
            self.chained = bool((nxt_h >= 0).any())
            succ = np.zeros((T,), bool)
            succ[nxt_h[nxt_h >= 0]] = True
            warm = ((alpha != 0) & (c > 0)).any(1).cpu().numpy()
            self.pending_h = ~succ & warm
            self.live_h = ~succ & ~warm
            self.done_h = np.zeros((T,), bool)
            self.live = torch.as_tensor(self.live_h, device=dev)
            self.q = torch.empty((n,), dtype=torch.float32, device=dev)  # from pass one
            self.epochs = torch.zeros((T,), dtype=torch.int32, device=dev)
            self.violation = torch.full((T,), float("inf"), dtype=torch.float32,
                                        device=dev)
        self.q_summed = False
        self.period = config.full_pass_period if config.shrink else 1
        self.shrink_k = config.shrink_k if config.shrink else INT32_MAX
        self.comp: Optional[_Compacted] = None
        self.act_buf = None
        self.tuned = not cfg.autotune_prefetch
        self.finished = False
        self._pend = _NO_TASKS
        self._w0 = None

    def on(self):
        """The engine's stream and tracer rows, around each of its calls."""
        return worker_context(self.stream, self.tr, self.tag)

    def _sync(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()
        elif self.cuda:
            torch.cuda.synchronize(self.dev)

    # -- a shared pass: begin_pass, feed_block per block, end_pass ---------
    def begin_pass(self, kind: str) -> None:
        """A pass over all of G: the pending tasks (on "init" and "full"
        passes) sum their w0 (in fp64, as ``dual_solver._init_w``) from its
        blocks, and on "full" and "cheap" passes the live tasks sweep them.
        The first pass sums q.  The block cache is not consulted."""
        with self.on():
            T, dev = self.T, self.dev
            self._kind = kind
            self._pend = (np.flatnonzero(self.pending_h) if kind in ("init", "full")
                          else _NO_TASKS)
            pend = self._pend
            self._viol = torch.zeros((T,), dtype=torch.float32, device=dev)
            self._w0 = torch.zeros((-(-len(pend) // INIT_TASKS) * INIT_TASKS, self.rank),
                                   dtype=torch.float64, device=dev)
            self._ps = _upload(pend, dev, self.st) if len(pend) else None
            self._sweep = kind != "init" and bool(self.live_h.any())

    def _init_sums(self, b: int, gb: torch.Tensor, s: int) -> None:
        """w0 += (alpha * y) @ G over the pending tasks' windows of block b:
        a coefficient matrix, zero off each task's rows, times the block in
        fp64.  The products run ``INIT_ROWS`` rows of the block by
        ``INIT_TASKS`` tasks at a time (the last group zero-padded), so every
        product has one shape and a task's sum does not depend on which
        other tasks are pending with it."""
        pend, ps, w0, dev = self._pend, self._ps, self._w0, self.dev
        width = int((self.bounds_h[b + 1, pend] - self.bounds_h[b, pend]).max(initial=0))
        if width == 0:
            return
        pos = self.bounds[b, ps].long()[:, None] + torch.arange(width, device=dev)
        inside = pos < self.bounds[b + 1, ps].long()[:, None]
        pos = pos.clamp(max=self.n_pad - 1)
        rows = torch.where(inside, self.sidx[ps].gather(1, pos).long() - s, 0)
        vals = torch.where(inside, (self.alpha[ps] * self.y[ps]).gather(1, pos).double(),
                           0.0)
        groups = -(-len(pend) // INIT_TASKS)
        coef = torch.zeros((groups * INIT_TASKS, gb.shape[0]), dtype=torch.float64,
                           device=dev)
        coef[:len(pend)].scatter_add_(1, rows, vals)
        coef = coef.view(groups, INIT_TASKS, -1)
        sums = w0.view(groups, INIT_TASKS, -1)
        for p0 in range(0, gb.shape[0], INIT_ROWS):
            g64 = gb[p0:p0 + INIT_ROWS].double()
            for k in range(groups):
                sums[k] += coef[k, :, p0:p0 + INIT_ROWS] @ g64

    def feed_block(self, blk):
        """One block the shared reader staged, ``(b, s, e, src, group)``:
        copied into this engine's ring and swept.  Returns the event of its
        copy (None on the CPU), after which the reader may reuse ``src``."""
        b, s, e, src, group = blk
        tr, dev = self.tr, self.dev
        with self.on():
            gb, slot, _ = self.ring.load(src, e - s, group, block=b, shared=True)
            if not self.q_summed:
                with tr.device_span("kernel", "row_sq", dev, rows=e - s):
                    _row_sq(gb, self.q[s:e])
            if self._ps is not None:
                with tr.device_span("kernel", "init_sums", dev, tasks=len(self._pend)):
                    self._init_sums(b, gb, s)
            if self._sweep:
                bh = self.bounds_h
                swept = int((bh[b + 1] - bh[b])[self.live_h].sum())
                with tr.device_span("kernel", "smo_block", dev, rows=swept,
                                    tasks=int(self.live_h.sum())):
                    v = smo_epoch(gb, self.q[s:e], self.sidx, self.y, self.c, self.alpha,
                                  self.unchanged, self.w, self.live,
                                  full_pass=self._kind == "full", shrink_k=self.shrink_k,
                                  lo=self.bounds[b], hi=self.bounds[b + 1], row0=s,
                                  scratch=self.scratch)
                self.st.kernel_calls += 1
                self.st.coord_visits += swept
                if self._kind == "full":
                    self._viol = torch.maximum(self._viol, v)
            self.ring.release(slot)
            return self.lanes.last_copy()

    def end_pass(self) -> None:
        self.q_summed = True

    def finish_init(self) -> None:
        """After the init pass: the warm tasks take their w0 and go live."""
        with self.on():
            self.promote(self._pend, self._w0)
            self._w0 = None
            self.live.copy_(torch.from_numpy(self.live_h))
            self._sync()

    # -- a cheap epoch over the engine's own compacted union ----------------
    def cheap_epoch(self) -> None:
        """A cheap epoch over the compacted union: each block is a cache hit
        (decoded on the card, no G byte on the bus) or a miss (shipped, and
        kept when the plan wants it)."""
        comp, st, tr, tile, cache = self.comp, self.st, self.tr, self.tile, self.cache
        with self.on():
            U = comp.q.shape[0]
            for b in range(comp.visits.shape[0]):
                s, e = b * tile, min((b + 1) * tile, U)
                key = None if comp.keys is None else comp.keys[b]
                hit = None if key is None else cache.lookup(key)
                slot = None
                if hit is not None:
                    st.bytes_hit += hit.nbytes
                    st.cache_hits += 1
                    tr.instant("cache", "hit", bytes=hit.nbytes, block=b)
                    gb = self.ring.decode(hit.payload, e - s, 1)
                else:
                    src = ((comp.act[0][s:s + tile], comp.act[1][s:s + tile])
                           if self.quant else comp.act[s:e])   # int8: whole tiles
                    keep = key is not None and cache.wants(key, comp.sizes[b])
                    gb, slot, wire = self.ring.load(src, e - s, 1, block=b, keep=keep)
                    nbytes = sum(a.nbytes for a in wire)
                    st.bytes_miss += nbytes
                    if cache is not None:
                        st.cache_misses += 1
                        tr.instant("cache", "miss", bytes=nbytes, block=b)
                        if keep and cache.put(key, wire, nbytes):
                            st.cache_resident_bytes = cache.peak_resident_bytes
                swept = int(comp.visits[b][self.live_h].sum())
                with tr.device_span("kernel", "smo_block", self.dev, rows=swept,
                                    tasks=int(self.live_h.sum())):
                    smo_epoch(gb, comp.q[s:e], comp.cidx, self.y, self.c, self.alpha,
                              self.unchanged, self.w, self.live, full_pass=False,
                              shrink_k=self.shrink_k, lo=comp.bounds[b],
                              hi=comp.bounds[b + 1], row0=s, scratch=self.scratch)
                st.kernel_calls += 1
                st.coord_visits += swept
                self.ring.release(slot)

    # -- epoch bookkeeping ---------------------------------------------------
    def start_epoch(self, epoch: int, full: bool) -> None:
        st = self.st
        self.ring.epoch = epoch
        self._full = full
        self._marks = (st.bytes_g, st.bytes_hit, st.bytes_miss, st.put_seconds,
                       st.drain_seconds)
        self.cv0 = st.coord_visits
        self.act_rows = self.n if self.comp is None or full else self.comp.q.shape[0]

    @property
    def shares(self) -> bool:
        """This epoch reads G through the shared reader (a full pass, or a
        cheap one with nothing compacted)."""
        return self._full or self.comp is None

    def finish_epoch(self, epoch: int) -> None:
        """After the epoch's pass: epoch counts; on a full pass the tol test
        (one host sync), ladder seeds and w0 promotions, then the compaction
        and the autotune; ``finished`` once no task is live or pending."""
        st, full = self.st, self._full
        mark, hit0, miss0, put0, drain0 = self._marks
        with self.on():
            self.epochs += self.live.to(torch.int32)
            st.epochs = epoch + 1
            if full:
                st.full_passes += 1
                self.violation = torch.where(self.live, self._viol, self.violation)
                flags = [self.live & (self._viol < self.config.tol)]
                if self.chained:            # would a task seed nonzero alphas?
                    flags.append(((self.alpha > 0.0) & (self.c > 0.0)).any(1))
                t0 = self.tr.begin()
                flags_h = torch.stack(flags).cpu().numpy()   # one host sync per full pass
                st.drain_seconds += self.tr.end("drain", "flags", t0)
                st.bytes_d2h += flags_h.nbytes
                self.live_h &= ~flags_h[0]
                self.done_h |= flags_h[0]
                if self.chained:
                    self.seed(flags_h[0], flags_h[1])
                self.promote(self._pend, self._w0)
                self._w0 = None
                self.live.copy_(torch.from_numpy(self.live_h))
            st.epoch_bytes.append(st.bytes_g - mark)
            st.epoch_hit_bytes.append(st.bytes_hit - hit0)
            st.epoch_miss_bytes.append(st.bytes_miss - miss0)
            if not full:
                return
            if not (self.live_h.any() or self.pending_h.any()):
                self.finished = True
                return
            if self.config.shrink:
                self.comp = self.recompact() if self.live_h.any() else self.drop_cache()
            if not self.tuned:
                self.tuned = True
                comp, cache = self.comp, self.cache
                planned = (cache.planned_fraction(comp.keys, comp.sizes)
                           if cache is not None and comp is not None else 0.0)
                _autotune(self.ring, self.cfg, self.rank, self.T, self.tile,
                          st.put_seconds - put0, st.drain_seconds - drain0, planned)

    def drop_cache(self, record: bool = True) -> None:
        """Nothing compacted to serve (the union is all of G, or no task is
        live): the cache lets go of every payload.  Called after a full
        pass's flags were read back, so no queued launch still reads one."""
        if self.cache is not None:
            self.cache.invalidate()
            self.st.cache_evictions = self.cache.evictions
            if record:
                self.tr.instant("cache", "invalidate", evictions=self.cache.evictions)

    def recompact(self, record: bool = True) -> Optional[_Compacted]:
        """After a full pass: the union of rows active for a live task,
        gathered once into pinned memory, on the int8 wire encoded there,
        and the cache's plan for its blocks (None: stream all of G).
        ``record=False`` (a restore) leaves ``active_history`` and the trace
        as the snapshot's boundary left them."""
        st, tr, tile, rank, dev = self.st, self.tr, self.tile, self.rank, self.dev
        cache, m, sidx_h = self.cache, self.m, self.sidx_h
        t0 = tr.begin()
        u = self.unchanged.cpu().numpy()     # syncs: no launch reads an evictee
        st.bytes_d2h += u.nbytes
        active = (u < self.shrink_k) & self.live_h[:, None]
        union, cidx_h, cb_h, visits = _compaction(sidx_h, m, active, tile)
        U = len(union)
        if record:
            st.active_history.append(U)
        if U == self.n:
            self.drop_cache(record)
            st.compact_seconds += tr.end("compact", "recompact", t0, union=U)
            return None
        if self.quant:
            u_pad = -(-max(U, 1) // tile) * tile
            if self.act_buf is None or self.act_buf[0].shape[0] < u_pad:
                self.act_buf = (host_buffer((u_pad, rank), torch.int8, dev),
                                host_buffer((u_pad, 2), torch.float32, dev))
            t1 = tr.begin()
            gscales = self.scales.get(self.G, self.group)   # the shared passes' groups
            encode_compacted(self.G_np, gscales, self.group, union, tile,
                             self.act_buf[0].numpy(), self.act_buf[1].numpy())
            st.encode_seconds += tr.end("encode", "stage2_quant", t1, rows=U)
            act = self.act_buf
        else:
            if self.act_buf is None or self.act_buf.shape[0] < U:
                self.act_buf = host_buffer((max(U, 1), rank), self.ring.wire, dev)
            act = shards.gather_into(self.G, union, self.act_buf[:U])
        keys = sizes = None
        if cache is not None:
            # keys are the blocks' global rows; violation recency ranks them
            # from the counters this compaction reads anyway
            nb = -(-U // tile)
            keys = [block_key(union[b * tile:(b + 1) * tile], self.cfg.block_dtype)
                    for b in range(nb)]
            sizes = [block_wire_nbytes(tile if self.quant else min(tile, U - b * tile),
                                       rank, self.cfg.block_dtype, 1) for b in range(nb)]
            scores = violation_recency_scores_tasks(
                union, tile, [u[t, :m[t]][active[t, :m[t]]] for t in range(self.T)],
                [sidx_h[t, :m[t]][active[t, :m[t]]] for t in range(self.T)])
            cache.plan(keys, sizes, scores)
            st.cache_evictions = cache.evictions
            if record:
                tr.instant("cache", "plan", blocks=nb, evictions=cache.evictions,
                           resident_bytes=cache.resident_bytes)
        comp = _Compacted(act, self.q[_upload(union, dev, st)], _upload(cidx_h, dev, st),
                          _upload(cb_h, dev, st), visits, keys, sizes)
        st.compact_seconds += tr.end("compact", "recompact", t0, union=U)
        return comp

    def promote(self, pend: np.ndarray, w0) -> None:
        """The tasks whose w0 a pass summed take it, rounded once, and sweep
        from the next epoch."""
        if len(pend):
            self.w[_upload(pend, self.dev, self.st)] = w0[:len(pend)].float()
            self.pending_h[pend] = False
            self.live_h[pend] = True

    def seed(self, conv_h: np.ndarray, seeds_alpha: np.ndarray) -> None:
        """Each task that converged in this full pass seeds its dormant
        successor, in task order: its alphas clipped into the successor's
        box, the successor's counters reset.  Seeded with zero alphas, a
        successor sweeps from the next epoch (its w0 is 0); else it first
        sums its w0 in the next pass, which that promotes to a full one."""
        frm, to = [], []
        for t in np.flatnonzero(conv_h & (self.nxt_h >= 0)):
            s = int(self.nxt_h[t])
            if self.live_h[s] or self.done_h[s] or self.pending_h[s]:
                continue
            frm.append(t)
            to.append(s)
            if seeds_alpha[t]:
                self.pending_h[s] = True
            else:
                self.live_h[s] = True
        if to:
            src = _upload(np.asarray(frm, np.int64), self.dev, self.st)
            dst = _upload(np.asarray(to, np.int64), self.dev, self.st)
            box = self.c[dst]
            self.alpha[dst] = torch.where(
                box > 0.0, torch.minimum(self.alpha[src].clamp(min=0.0), box),
                self.alpha[dst])
            self.unchanged[dst] = 0

    # -- snapshots -------------------------------------------------------------
    def state(self) -> dict:
        """The snapshot's arrays (``resilience.STATE_KEYS``) of this engine's
        tasks, in the tasks' own layout, as copies."""
        with self.on():
            perm = self.perm

            def own(a):
                return torch.empty_like(a).scatter_(1, perm, a).cpu().numpy()
            return dict(alpha=own(self.alpha), unchanged=own(self.unchanged),
                        w=self.w.cpu().numpy().copy(), epochs=self.epochs.cpu().numpy().copy(),
                        violation=self.violation.cpu().numpy().copy(),
                        live=self.live_h.astype(np.uint8),
                        pending=self.pending_h.astype(np.uint8),
                        done=self.done_h.astype(np.uint8),
                        q=self.q.cpu().numpy().copy(), q_summed=self.q_summed)

    def restore(self, snap: dict) -> None:
        """Take this engine's tasks' state from a snapshot of the solve (any
        split of its tasks), then redo the boundary's compaction (the cache
        starts cold)."""
        sv, meta, dev, perm = snap["state"], snap["meta"], self.dev, self.perm
        ids = self.task_ids

        def ours(a, dtype):
            return torch.gather(torch.as_tensor(np.asarray(a)[ids], dtype=dtype,
                                                device=dev), 1, perm)
        with self.on():
            self.alpha.copy_(ours(sv["alpha"], torch.float32))
            self.unchanged.copy_(ours(sv["unchanged"], torch.int32))
            self.w.copy_(torch.as_tensor(np.asarray(sv["w"])[ids], device=dev))
            self.epochs.copy_(torch.as_tensor(np.asarray(sv["epochs"])[ids], device=dev))
            self.violation.copy_(torch.as_tensor(np.asarray(sv["violation"])[ids],
                                                 device=dev))
            if bool(int(meta.get("q_summed", 1))):
                self.q.copy_(torch.as_tensor(sv["q"], device=dev))
                self.q_summed = True
            self.live_h[:] = np.asarray(sv["live"])[ids].astype(bool)
            self.pending_h[:] = np.asarray(sv["pending"])[ids].astype(bool)
            self.done_h[:] = np.asarray(sv["done"])[ids].astype(bool)
            self.live.copy_(torch.from_numpy(self.live_h))
            self.ring.prefetch = int(meta["prefetch"])
            self.tuned = self.tuned or int(meta["epoch_next"]) > 0   # the first full pass is behind it
            if self.config.shrink:   # the boundary's compaction; a cold cache
                self.comp = self.recompact(record=False) if self.live_h.any() else None

    def segment_stats(self) -> Stage2StreamStats:
        return dataclasses.replace(self.st, h2d_seconds=self.lanes.h2d_seconds(),
                                   prefetch_final=self.ring.prefetch)

    def result(self):
        """This engine's ``SolveResult`` on its device, laid out as
        ``solve_batch``'s, and its stats record."""
        st, tr = self.st, self.tr
        with self.on():
            t0 = tr.begin()
            epochs = torch.where(torch.as_tensor(self.done_h, device=self.dev), self.epochs,
                                 self.config.max_epochs).to(torch.int32)
            out_alpha = torch.empty_like(self.alpha).scatter_(1, self.perm, self.alpha)
            dual = out_alpha.sum(-1) - 0.5 * (self.w * self.w).sum(-1)
            n_sv = (out_alpha > 0.0).sum(-1)
            self._sync()
            st.drain_seconds += tr.end("drain", "result", t0)
            st.h2d_seconds = self.lanes.h2d_seconds()
            st.prefetch_final = self.ring.prefetch
        return SolveResult(out_alpha, self.w, epochs, self.violation, dual, n_sv), st


_NO_TASKS = np.zeros((0,), np.int64)


class _Feed:
    """A worker's job for one staged block: feed it, then release the
    reader's buffer (also when the job is skipped)."""

    __slots__ = ("engine", "blk", "staged", "attrs")

    def __init__(self, engine: _Stage2Engine, blk):
        b, s, e, src, group, staged = blk
        self.engine, self.blk, self.staged = engine, (b, s, e, src, group), staged
        self.attrs = dict(block=b, epoch=engine.ring.epoch)

    def __call__(self):
        ev = None
        try:
            ev = self.engine.feed_block(self.blk)
        finally:
            if self.staged is not None:
                self.staged.release(ev)

    def skip(self):
        if self.staged is not None:
            self.staged.release()


class _InlineFanout:
    """One engine: its calls run on the caller's thread, at once."""

    def submit(self, engine, fn):
        fn()

    def barrier(self):
        pass

    def close(self, suppress: bool = False):
        pass


def _snapshot_state(engines: List[_Stage2Engine]) -> dict:
    """The solve's snapshot arrays assembled from its engines' tasks."""
    parts = [e.state() for e in engines]
    if len(engines) == 1:
        return parts[0]
    T = sum(e.T for e in engines)
    out = {}
    for k in ("alpha", "unchanged", "w", "epochs", "violation", "live", "pending", "done"):
        a = parts[0][k]
        out[k] = np.zeros((T,) + a.shape[1:], a.dtype)
        for e, p in zip(engines, parts):
            out[k][e.task_ids] = p[k]
    summed = [p for p in parts if p["q_summed"]]
    out["q"] = (summed or parts)[0]["q"]
    out["q_summed"] = bool(summed)
    return out


def drive_streamed_engines(engines: List[_Stage2Engine], reader: _SharedReader,
                           config: SolverConfig, cfg: StreamConfig, *, fanout=None,
                           guard=None, start: int = 0) -> None:
    """The lockstep epoch driver over one or more engines (the reference's
    ``drive_streamed_engines``): the shared reader stages each block of G
    once a shared pass (a warm start's init pass, full passes, cheap epochs
    of engines with nothing compacted) and ``fanout`` hands it to every
    engine of the pass (inline for one engine, a host worker each on the
    farm); engines with a compaction run their cheap epochs on their own,
    concurrently.  ``guard`` (``resilience.StreamGuard``) snapshots at
    full-pass boundaries; the loop starts at ``start`` (a resume's)."""
    fan = fanout or _InlineFanout()
    tr, rst = reader.tr, reader.st
    period = config.full_pass_period if config.shrink else 1

    def shared_pass(group, kind):
        for e in group:
            fan.submit(e, functools.partial(e.begin_pass, kind))
        g0 = rst.bytes_g
        for blk in reader.blocks(len(group)):
            for e in group:
                fan.submit(e, _Feed(e, blk))
        for e in group:
            fan.submit(e, e.end_pass)
        return rst.bytes_g - g0

    def state():
        return _snapshot_state(engines)

    def stats():
        return merge_stream_stats(rst, [e.segment_stats() for e in engines],
                                  seconds=0.0, n_devices=len(engines))

    def prefetch():
        return max(e.ring.prefetch for e in engines)

    ok = False
    try:
        if guard is not None:
            guard.on_start(state, stats, prefetch)
        init = [e for e in engines if e.pending_h.any()]
        if init and not (guard is not None and guard.init_done):
            t0 = tr.begin()           # warm roots: an init pass first
            n_pend = int(sum(e.pending_h.sum() for e in init))
            shared_pass(init, "init")
            for e in init:
                fan.submit(e, e.finish_init)
            fan.barrier()
            rst.init_seconds = tr.end("init", "init_pass", t0, tasks=n_pend)
        if guard is not None:
            guard.mark_init(state, stats, prefetch)
        for epoch in range(start, config.max_epochs):
            live = [e for e in engines if not e.finished]
            if not live:
                break
            # a pending task needs a pass over all of G: it promotes the epoch
            full = epoch % period == 0 or any(bool(e.pending_h.any()) for e in live)
            te0 = tr.begin()
            for e in live:
                e.start_epoch(epoch, full)
            cv0 = sum(e.cv0 for e in live)
            for e in live:
                if not e.shares:
                    fan.submit(e, e.cheap_epoch)
            shared = [e for e in live if e.shares]
            rst.epoch_bytes.append(shared_pass(shared, "full" if full else "cheap")
                                   if shared else 0)
            for e in live:
                fan.submit(e, functools.partial(e.finish_epoch, epoch))
            fan.barrier()
            if tr.enabled:
                _trace_epoch(tr, te0, epoch, full, rst, live, cv0)
            if full:
                if all(e.finished for e in engines):
                    break
                if guard is not None and guard.on_boundary(epoch, state, stats,
                                                           prefetch(), tr):
                    rst.snapshots += 1
                    rst.snapshot_seconds += guard.last_seconds
                    rst.snapshot_bytes = guard.last_bytes
            fault_check("epoch_boundary", epoch=epoch)
        ok = True
    finally:
        fan.close(suppress=not ok)


def _trace_epoch(tr, t0: float, epoch: int, full: bool, rst: Stage2StreamStats,
                 live: List[_Stage2Engine], cv0: int) -> None:
    """Close an epoch's span (the ``--verbose`` printer and the trace's epoch
    row read its attrs) and sample its counters: the shared reader's bytes
    and every live engine's, summed.  The violations are read on full
    passes only, whose flags have just synced the engines."""
    eb = rst.epoch_bytes[-1] + sum(e.st.epoch_bytes[-1] for e in live)
    rows = sum(e.st.coord_visits for e in live) - cv0
    active = sum(e.act_rows for e in live)
    attrs = dict(epoch=epoch, kind="full" if full else "cheap", bytes=int(eb),
                 hit_bytes=int(sum(e.st.epoch_hit_bytes[-1] for e in live)),
                 miss_bytes=int(sum(e.st.epoch_miss_bytes[-1] for e in live)),
                 rows=int(rows), active=int(active), devices=len(live))
    if full:
        v = np.concatenate([e.violation.cpu().numpy() for e in live])
        v = v[np.isfinite(v)]
        if v.size:
            attrs["viol"] = float(v.max())
    tr.end("epoch", f"epoch_{epoch}", t0, **attrs)
    tr.counter("stage2/epoch_bytes", eb)
    tr.counter("stage2/active_rows", active)
    tr.counter("stage2/row_visits", rows)


def _autotune(ring: _Ring, cfg: StreamConfig, rank: int, T: int, tile: int,
              put: float, drain: float, planned: float = 0.0) -> None:
    """Deepen the block queue from the first full pass's put and drain
    times, but never past what the byte model fits in the budget less an
    explicit cache carve.  ``planned`` is the share of the coming cheap
    epochs' bytes the cache's plan pins: above one half most blocks never
    cross the bus, and the depth stays."""
    free = cfg.device_budget_bytes - stage2_resident_bytes(rank, T)
    if cfg.cache_blocks and cfg.cache_budget_bytes:
        free -= cfg.cache_budget_bytes
    per_block = stage2_block_bytes(tile, rank, T)
    fit = free // per_block if per_block > 0 else cfg.prefetch_cap
    cap = max(ring.prefetch, min(cfg.prefetch_cap, int(fit)))
    if planned > 0.5:
        cap = ring.prefetch
    ring.prefetch = tune_prefetch(put, drain, ring.prefetch, cap)


_SUMMED = ("bytes_h2d", "put_seconds", "drain_seconds", "h2d_seconds", "blocks_streamed",
           "rows_streamed", "kernel_calls", "coord_visits", "bytes_g", "bytes_d2h",
           "bytes_scales", "encode_seconds", "compact_seconds", "init_seconds",
           "scratch_bytes", "bytes_hit", "bytes_miss", "cache_hits", "cache_misses",
           "cache_evictions", "cache_resident_bytes", "snapshots", "snapshot_seconds",
           "bytes_put", "resplits")


def _elementwise_sum(lists) -> List[int]:
    out: List[int] = []
    for li in lists:
        for i, v in enumerate(li):
            if i < len(out):
                out[i] += v
            else:
                out.append(v)
    return out


def merge_stream_stats(reader: Stage2StreamStats, per_dev: List[Stage2StreamStats], *,
                       seconds: float, n_devices: int, carry=None) -> Stage2StreamStats:
    """The solve's record from the shared reader's and each engine's (the
    reference's ``merge_stream_stats``): a shared block counts once in
    ``bytes_h2d`` (the reader's), every copy of it in ``bytes_put`` (the
    engines'); partitioned traffic (index tables, compactions, the caches)
    sums over engines, per-epoch lists sum element by element, ``epochs``
    and ``full_passes`` are the longest engine's.  At one engine this is its
    record with the shared passes' traffic in it.  ``carry`` (the segments
    before a resume or a re-split) is folded in last."""
    out = Stage2StreamStats(tile_rows=reader.tile_rows, block_dtype=reader.block_dtype,
                            n_devices=n_devices)
    recs = [reader] + list(per_dev)
    for f in _SUMMED:
        setattr(out, f, sum(getattr(s, f) for s in recs))
    out.epochs = max((s.epochs for s in recs), default=0)
    out.full_passes = max((s.full_passes for s in recs), default=0)
    out.prefetch_final = max((s.prefetch_final for s in recs), default=0)
    out.snapshot_bytes = max((s.snapshot_bytes for s in recs), default=0)
    out.resumed_from = reader.resumed_from
    out.resume_seconds = reader.resume_seconds
    out.epoch_bytes = _elementwise_sum([s.epoch_bytes for s in recs])
    out.epoch_hit_bytes = _elementwise_sum([s.epoch_hit_bytes for s in per_dev])
    out.epoch_miss_bytes = _elementwise_sum([s.epoch_miss_bytes for s in per_dev])
    # engines' unions may share rows: the sum is the rows each cheap epoch
    # streams farm-wide, an upper bound on the union of the unions
    out.active_history = _elementwise_sum([s.active_history for s in per_dev])
    out.seconds = seconds
    out.per_device = list(per_dev) if n_devices > 1 else None
    if carry is not None:
        from repro_torch.core.resilience import apply_carry
        apply_carry(out, carry)
    return out


def resume_engines(guard, snap: dict, engines: List[_Stage2Engine],
                   reader: _SharedReader, T: int, n_pad: int, n: int) -> int:
    """Continue from ``snap`` (a boundary's snapshot of the whole solve):
    every engine takes its tasks' state; returns the epoch to start at."""
    tr = reader.tr
    t0 = tr.begin()
    guard.adopt(snap)
    sv = snap["state"]
    if sv["alpha"].shape != (T, n_pad) or sv["q"].shape != (n,):
        raise ValueError("checkpoint task layout does not match this solve")
    for e in engines:
        e.restore(snap)
    start = guard.start_epoch
    reader.st.resumed_from = start
    reader.st.resume_seconds = tr.end("recovery", "resume", t0, epoch=start)
    return start


@full_fp32()
def solve_batch_streamed(
    G,
    tasks: TaskBatch,
    config: SolverConfig = SolverConfig(),
    *,
    stream_config: Optional[StreamConfig] = None,
    chain_next=None,
    return_stats: bool = False,
):
    """Drop-in ``solve_batch`` over a host G, on the device of ``tasks``.

    ``G`` is a pinned CPU tensor when the tasks are on the card (pageable
    memory raises; a G on the card is first copied to pinned memory) and a
    CPU tensor or array on the CPU, or a ``shards.GShardView`` of a spilled
    G on either: its rows are read from disk, verified, for every pass (a
    shared pass's blocks go through the reader's pinned buffers, a
    compaction's rows are gathered into the pinned union buffer, the int8
    table is computed shard by shard) and it is never materialised; the
    result is bit-equal to the solve over the same G in memory.  Returns a
    ``SolveResult`` on the tasks' device, laid out as ``solve_batch``'s, and
    a ``Stage2StreamStats`` with ``return_stats=True``.  Each task's real
    rows must be unique; sorted rows (what ``build_ovo_tasks`` gives) make
    the trajectory the monolithic one.

    ``chain_next[t] = s`` (-1: none) makes task s the warm-start successor
    of task t over the same rows, the C ladder of
    ``cv.build_cv_grid_tasks`` (see the module docstring).  A task that
    never converged, or was never seeded, reports ``max_epochs``.

    With ``stream_config.cache_blocks`` (the default) the cheap epochs look
    each compacted block up in a ``block_cache.HotRowBlockCache`` on the
    card (``stage2_cache_budget`` bytes), planned at each compaction; the
    result is bit-equal to the uncached solve's.  With ``checkpoint_dir`` a
    ``resilience.StreamGuard`` snapshots the solver every
    ``checkpoint_every`` full passes, and ``resume`` continues from the
    newest snapshot: after a kill the result is bit-equal to an
    uninterrupted run's, and the cache restarts cold.  With ``fail_fast``
    off a transient H2D fault is retried (``_Ring``); a lost device has no
    survivor to move to here, and its error is raised.  This is one engine
    of the driver; ``solve_streamed_auto`` farms a solve over several
    devices (``core/distributed.py``)."""
    t_start = time.perf_counter()
    cfg = stream_config or StreamConfig()
    dev = tasks.idx.device
    G = host_factor(G, [dev])
    n, rank = G.shape
    T, n_pad = tasks.idx.shape
    tile = auto_tile_rows(n, rank, T, cfg)
    eng = _Stage2Engine(G, tasks, config, cfg, tile=tile, chain_next=chain_next)
    reader = _SharedReader(G, tile, cfg, eng.cuda, eng.tr, depth=cfg.prefetch + 2)
    guard = None
    start = 0
    if cfg.checkpoint_dir:
        from repro_torch.core.resilience import StreamGuard, g_fingerprint
        guard = StreamGuard(cfg, n=n, rank=rank, sizes=eng.m, g_fp=g_fingerprint(eng.G_np))
        snap = guard.try_resume() if cfg.resume else None
        if snap is not None:
            start = resume_engines(guard, snap, [eng], reader, T, n_pad, n)
    drive_streamed_engines([eng], reader, config, cfg, guard=guard, start=start)
    res, est = eng.result()
    st = merge_stream_stats(reader.st, [est], seconds=time.perf_counter() - t_start,
                            n_devices=1, carry=guard.carry if guard else None)
    return (res, st) if return_stats else res


def local_devices(device) -> list:
    """The devices a routed streamed stage 2 on ``device`` farms over: every
    card of the host when ``device`` is a card, else ``[device]``."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def solve_streamed_auto(
    G,
    tasks: TaskBatch,
    config: SolverConfig = SolverConfig(),
    *,
    stream_config: Optional[StreamConfig] = None,
    chain_next=None,
    return_stats: bool = False,
    resume: Optional[bool] = None,
):
    """The streamed stage-2 entry every routed caller goes through
    (``LPDSVM.fit``, ``core/cv.py``, the polish ladder's final level, the
    driver): ``distributed.solve_tasks_streamed`` over the local devices
    (``local_devices``), which farms where more than one device is listed
    and there is more than one task (overlapped behind one shared reader, or
    serial with ``StreamConfig.overlap_devices`` off), and is else the
    one-device stream.  ``resume`` overrides ``StreamConfig.resume``."""
    from repro_torch.core.distributed import solve_tasks_streamed

    cfg = stream_config or StreamConfig()
    if resume is not None and resume != cfg.resume:
        cfg = dataclasses.replace(cfg, resume=bool(resume))
    return solve_tasks_streamed(G, tasks, config, devices=local_devices(tasks.idx.device),
                                stream_config=cfg, overlap=cfg.overlap_devices,
                                chain_next=chain_next, return_stats=return_stats)


__all__ = ["Stage2StreamStats", "auto_tile_rows", "block_windows",
           "drive_streamed_engines", "encode_block", "encode_compacted", "host_factor",
           "local_devices", "merge_stream_stats", "pad_quant_block", "route_stage2",
           "should_stream_stage2", "solve_batch_streamed", "solve_streamed_auto",
           "wire_group", "stage2_block_bytes", "stage2_monolithic_bytes",
           "stage2_resident_bytes"]
