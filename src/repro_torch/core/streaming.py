"""Out-of-core stage 1: stream the Nyström factor G in row chunks (PyTorch
port of the stage-1 half of ``repro.core.streaming``).

The paper's "more RAM" ingredient: the data set and the (n, B') factor G live
in host memory, and the card holds only a working set:

    host RAM                               card
    x   (n, p)  numpy, read-only           landmarks (B, p), projector (B, B')
    G   (n, B') pinned, filled in place    per chunk in flight: its wire
                                           arrays, K_chunk (r, B), G_chunk (r, B')

Per chunk: the host slices x, or densifies the chunk's rows of a LIBSVM CSR
triple (``compute_factor_streamed_csr``: x is then never dense whole), and
on the int8 wire encodes the rows with the symmetric codec of
``core/quant.py``, so scale groups restart at every chunk; it copies the
wire arrays into a pinned staging slot and issues a non-blocking copy on the
H2D stream.  The compute stream waits for that copy (an event, not the
host), runs kernel B3 on the int8 wire or B1 on the f32 wire, then
``@ projector`` (a plain fp32 product, as the reference leaves it to XLA),
and the D2H stream copies the G chunk, non-blocking, into its rows of the
pinned G.  At most ``prefetch`` chunks are in flight: before a slot is
reused the host waits on the event of the oldest chunk only, and before the
first copy into a new slot the H2D stream waits for the compute stream
(``Lanes.claim``).

Under a tracer (``StreamConfig.trace``, else an installed one) the host
spans are the reference's: ``read`` / ``stage1_rows`` (slicing or
densifying a block), ``encode`` / ``stage1_quant``, ``h2d`` / ``stage1_put``
(their sum is ``put_seconds``) and ``drain`` / ``stage1_fetch``; on the card
the H2D copies (``h2d`` / ``stage1_copy``) and each chunk's kernel and
product (``kernel`` / ``stage1_chunk``) are device spans (``core/trace.py``).

The disk tier (``core/shards.py``): ``compute_factor_streamed_shards``
streams a checksummed shard store, a shard a chunk, an int8 store's codes
going to the wire as stored; with ``StreamConfig.spill_g`` the G chunks
come back into a pinned bounce buffer of their slot and go to f32 shards in
row order, and the factor's G is a ``shards.GShardView`` (no host G of n
rows exists).

Over several devices (``devices=``, the reference's ``stream_factor_rows(...,
devices=)``; ``core/distributed.py`` ``stream_factor_over_mesh``): the
chunks are handed out round-robin, each device entry with its own streams,
slots and landmark / projector replica, and drained in row order, so G is
one device's bit for bit.  One card may be listed more than once (two
entries with a compute stream each).

On the CPU (``device="cpu"``) the same loop runs the kernels' plain versions
and the copies are plain copies; a CPU-only PyTorch cannot pin.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import time
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.faults import check as fault_check
from repro_torch.core.kernel_fn import KernelParams, full_fp32, gram
from repro_torch.core.quant import GROUP_ROWS, QuantBlock, dequantize_rows, quantize_rows
from repro_torch.core.shards import ShardSpillSink
from repro_torch.core.trace import NULL, resolve
from repro_torch.kernels.ops import gram_q8

BYTES_F32 = 4

WIRE_DTYPES = ("f32", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs of the streamed pipelines (all sizes in rows / bytes).

    ``device_budget_bytes`` is the working-set allowance on the card, not its
    memory size.  Stage 2 reads ``tile_rows`` and ``block_dtype``; both
    stages read the rest."""

    device_budget_bytes: int = 2 << 30   # 2 GiB working-set allowance
    chunk_rows: Optional[int] = None     # None -> derived from the budget
    prefetch: int = 2                    # chunks / blocks in flight
    min_chunk_rows: int = 256
    tile_rows: Optional[int] = None      # stage-2 G block rows (None -> derived)
    block_dtype: str = "f32"             # stage-2 wire: "f32", "bf16" or "int8"
    stage1_dtype: str = "f32"            # stage-1 wire: "f32" or "int8"
    quant_group_rows: int = GROUP_ROWS   # rows per int8 scale group
    overlap_devices: bool = True         # more than one device: the farm's
                                         # workers share one block reader
                                         # (False: each re-reads G in turn)
    autotune_prefetch: bool = True       # deepen the queue when H2D lags
    prefetch_cap: int = 8                # autotune ceiling on queue depth
    trace: Optional[object] = None       # core.trace.Tracer recording the
                                         # timeline; None -> the installed
                                         # tracer, else the no-op fast path
    cache_blocks: bool = True            # pin compacted stage-2 blocks on the
                                         # card (core/block_cache.py); a hit
                                         # decodes as the shipped block would
    cache_budget_bytes: Optional[int] = None  # the cache's bytes; None -> what
                                         # the budget leaves after the blocks
                                         # in flight
    # -- checkpoints and faults (core/resilience.py, core/faults.py) --------
    checkpoint_dir: Optional[str] = None  # stage-2 snapshots and the stage-1
                                         # G copy live here; None -> off
    checkpoint_every: int = 0            # full passes between stage-2
                                         # snapshots (0: never)
    resume: bool = False                 # continue from checkpoint_dir
    fail_fast: bool = True               # False: a transient H2D fault
                                         # retries with backoff, and the farm
                                         # re-splits a lost device's tasks
                                         # over its survivors from the last
                                         # full-pass boundary
    max_retries: int = 3                 # retries of one copy (fail_fast off)
    retry_backoff: float = 0.05          # seconds, doubled each retry
    watchdog_seconds: float = 0.0        # the farm's barriers and its reader
                                         # raise resilience.WatchdogTimeout
                                         # with the workers' states after
                                         # this long (0: wait for ever)
    checkpoint_keep: int = 3             # snapshots kept (0: all)
    # -- the disk tier (core/shards.py) -------------------------------------
    shard_dir: Optional[str] = None      # root of the shard stores; None -> off
    shard_rows: int = 4096               # rows a shard file (a multiple of
                                         # GROUP_ROWS: int8 groups stay aligned
                                         # to global rows)
    spill_g: bool = False                # stage 1 writes G to f32 shards under
                                         # shard_dir and stage 2 reads it back
                                         # (no host G of n rows)
    verify_shards: bool = True           # check each shard's digest on every
                                         # read (False trusts the bytes)

    def __post_init__(self):
        if self.prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        if self.chunk_rows is not None and self.chunk_rows < 1:
            raise ValueError("chunk_rows must be positive")
        if self.tile_rows is not None and self.tile_rows < 1:
            raise ValueError("tile_rows must be positive")
        if self.block_dtype not in WIRE_DTYPES:
            raise ValueError(f"block_dtype must be one of {WIRE_DTYPES}, "
                             f"got {self.block_dtype!r}")
        if self.stage1_dtype not in ("f32", "int8"):
            raise ValueError(f"stage1_dtype must be 'f32' or 'int8', "
                             f"got {self.stage1_dtype!r}")
        if self.quant_group_rows < 1:
            raise ValueError("quant_group_rows must be >= 1")
        if self.prefetch_cap < 1:
            raise ValueError("prefetch_cap must be >= 1")
        if self.cache_budget_bytes is not None and self.cache_budget_bytes < 0:
            raise ValueError("cache_budget_bytes must be >= 0")
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_backoff < 0:
            raise ValueError("retry_backoff must be >= 0")
        if self.watchdog_seconds < 0:
            raise ValueError("watchdog_seconds must be >= 0")
        if self.checkpoint_keep < 0:
            raise ValueError("checkpoint_keep must be >= 0")
        if self.shard_rows < 1 or self.shard_rows % GROUP_ROWS:
            raise ValueError(f"shard_rows must be a positive multiple of "
                             f"{GROUP_ROWS}, got {self.shard_rows}")
        if self.spill_g and not self.shard_dir:
            raise ValueError("spill_g=True requires shard_dir")
        if self.resume and not self.checkpoint_dir:
            raise ValueError("resume=True requires checkpoint_dir")


def with_trace(cfg: Optional[StreamConfig], trace) -> Optional[StreamConfig]:
    """``cfg`` carrying ``trace`` (an explicit tracer wins over
    ``cfg.trace``), for a call whose route was already chosen on ``cfg``
    itself: a trace never changes which path runs."""
    if trace is None:
        return cfg
    return dataclasses.replace(cfg or StreamConfig(), trace=trace)


def tune_prefetch(h2d_seconds: float, compute_seconds: float, prefetch: int,
                  cap: int = 8) -> int:
    """Overlap autotune shared by both streamed stages: when the first
    pipeline window spent more time putting than draining, transfer lags
    compute, so double the queue depth (bounded by ``cap``)."""
    if h2d_seconds > compute_seconds and prefetch < cap:
        return min(cap, max(prefetch * 2, prefetch + 1))
    return prefetch


@dataclasses.dataclass
class StreamTimes:
    """The wire bytes and host / copy times both streamed stages keep."""

    bytes_h2d: int = 0
    put_seconds: float = 0.0          # host time staging, issuing copies
    drain_seconds: float = 0.0        # host time blocked on the card
    h2d_seconds: float = 0.0          # the copies themselves (CUDA events)
    seconds: float = 0.0

    @property
    def h2d_gbps(self) -> float:
        """Rate of the H2D copies (GB/s): on the card over their own device
        time, since a non-blocking put returns before its copy runs."""
        return self.bytes_h2d / max(self.h2d_seconds, 1e-12) / 1e9

    @property
    def overlap_efficiency(self) -> float:
        """Stall-free fraction of the wall clock: 1 minus the share spent in
        puts and drains, clamped to [0, 1]."""
        if self.seconds <= 0.0:
            return 0.0
        busy = (self.put_seconds + self.drain_seconds) / self.seconds
        return min(1.0, max(0.0, 1.0 - busy))


@dataclasses.dataclass
class Stage1StreamStats(StreamTimes):
    """Traffic accounting of one streamed stage-1 factor build.

    ``bytes_h2d`` counts the chunk wire bytes (int8 scale tables included,
    broken out in ``bytes_scales``), as the reference does; the one-time
    landmark and projector copies are not counted.  ``drain_seconds`` is the
    host's wait on the oldest chunk."""

    chunks: int = 0
    rows: int = 0
    chunks_skipped: int = 0           # chunks a resumed stage 1 read back
    rows_resumed: int = 0             # from the checkpoint's G copy
    bytes_scales: int = 0
    encode_seconds: float = 0.0       # host time in the int8 encoder
    source_seconds: float = 0.0       # host time making the row blocks (a
                                      # slice of x, or densified CSR rows)
    alloc_seconds: float = 0.0        # host time allocating (pinning) G
    wire_dtype: str = "f32"
    prefetch_final: int = 0           # queue depth after autotune
    device_chunks: List[int] = dataclasses.field(default_factory=list)
    # ^ chunks each device entry computed (one B1 or B3 launch each on the card)


def resident_bytes(p: int, budget: int) -> int:
    """Device-resident stage-1 state: landmark block + projector."""
    return (budget * p + budget * budget) * BYTES_F32


def chunk_bytes(rows: int, p: int, budget: int) -> int:
    """Working set of ONE in-flight chunk: input rows, K block, G block."""
    return rows * (p + 2 * budget) * BYTES_F32


def monolithic_bytes(n: int, p: int, budget: int) -> int:
    """Device working set of the one-shot path: x, K_nm, G all live at once."""
    return (n * p + 2 * n * budget) * BYTES_F32 + resident_bytes(p, budget)


def should_stream(n: int, p: int, budget: int, cfg: StreamConfig) -> bool:
    """True when the monolithic stage-1 working set blows the device budget."""
    return monolithic_bytes(n, p, budget) > cfg.device_budget_bytes


def auto_chunk_rows(n: int, p: int, budget: int, cfg: StreamConfig) -> int:
    """Largest chunk whose ``prefetch`` in-flight copies fit the budget,
    clamped to [min_chunk_rows, n]."""
    if cfg.chunk_rows is not None:
        return min(cfg.chunk_rows, n)
    free = cfg.device_budget_bytes - resident_bytes(p, budget)
    per_row = cfg.prefetch * (p + 2 * budget) * BYTES_F32
    rows = free // per_row if free > 0 else 0
    return int(min(n, max(cfg.min_chunk_rows, rows)))


def host_buffer(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A host tensor the card copies to and from without blocking: pinned
    when ``device`` is CUDA, a plain CPU tensor on the CPU.  Raises rather
    than hand back pageable memory for the card, which would make every
    copy synchronous."""
    pin = torch.device(device).type == "cuda"
    t = torch.empty(shape, dtype=dtype, pin_memory=pin)
    if pin and not t.is_pinned():
        raise RuntimeError("host_buffer: the host buffer could not be pinned")
    return t


def check_host(t: torch.Tensor, device, name: str) -> None:
    """A host buffer the streamed pipelines copy through must be a CPU
    tensor, and pinned when the card is the device."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu":
        raise TypeError(f"{name} must be a host (CPU) tensor")
    if torch.device(device).type == "cuda" and not t.is_pinned():
        raise ValueError(f"{name} must be pinned for the card: pageable memory "
                         "would make every copy synchronous (see host_buffer)")


class Lanes:
    """The copy streams of a streamed pass beside the compute (current)
    stream, or plain copies on the CPU.

    ``put`` copies host rows to the card on the H2D stream and makes the
    compute stream wait for it; ``fetch`` copies a device result to host on
    the D2H stream once the compute stream has produced it; ``mark`` records
    an event on the compute stream.  The H2D copies are timed with CUDA
    events, read by ``h2d_seconds`` once the pass has synchronised; a
    tracer gets the same event pairs as device spans on the H2D row."""

    def __init__(self, device, trace=NULL):
        self.device = device
        self.cuda = torch.device(device).type == "cuda"
        self.copies: List = []
        self.cpu_copy_seconds = 0.0
        self.trace = trace
        if self.cuda:
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)
            trace.anchor(device)

    def put(self, dst: torch.Tensor, src: torch.Tensor, name: str = "copy") -> None:
        if not self.cuda:
            t0 = time.perf_counter()
            dst.copy_(src)
            self.cpu_copy_seconds += time.perf_counter() - t0
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.h2d):
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
        torch.cuda.current_stream().wait_event(end)
        self.copies.append((start, end))
        self.trace.device_events("h2d", name, start, end, self.device, "h2d",
                                 bytes=src.nbytes)

    def claim(self) -> None:
        """Call after allocating a device buffer that ``put`` will fill: the
        H2D stream waits for the work queued on the compute stream so far.
        The caching allocator hands the compute stream memory that its
        queued kernels may still read (a freed K block, a kernel's scratch);
        a copy on another stream would overwrite it under them."""
        if self.cuda:
            self.h2d.wait_event(self.mark())

    def fetch(self, dst: torch.Tensor, src: torch.Tensor):
        """Copy ``src`` (device) into ``dst`` (host); returns the event that
        marks the copy done (None on the CPU, where it is done at once)."""
        if not self.cuda:
            dst.copy_(src)
            return None
        ready = self.mark()
        self.d2h.wait_event(ready)
        with torch.cuda.stream(self.d2h):
            dst.copy_(src, non_blocking=True)
            src.record_stream(self.d2h)
            done = torch.cuda.Event()
            done.record()
        return done

    def mark(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def last_copy(self):
        """The end event of the newest H2D copy (None on the CPU, where a
        copy is done when ``put`` returns): once it has passed, the host rows
        it read may be written again."""
        return self.copies[-1][1] if self.cuda and self.copies else None

    def h2d_seconds(self) -> float:
        """Device time of the H2D copies so far (CPU: host copy time).  On
        the card every copy must have completed."""
        if not self.cuda:
            return self.cpu_copy_seconds
        return sum(s.elapsed_time(e) for s, e in self.copies) / 1e3


def wait(event) -> None:
    if event is not None:
        event.synchronize()


@contextlib.contextmanager
def worker_context(stream, tr, tag: Optional[str]):
    """A device entry's compute stream (None: the caller's) and tracer rows
    (``Tracer.row_tag``; None: the untagged rows) around its calls."""
    with contextlib.ExitStack() as stack:
        if stream is not None:
            stack.enter_context(torch.cuda.stream(stream))
        if tag is not None:
            stack.enter_context(tr.row_tag(tag))
        yield


class _Lane:
    """One device entry of a streamed stage 1: its copy streams (``Lanes``),
    its landmark and projector replica, its free slots and, where several
    entries stream at once (``own_stream``), a compute stream and tracer
    rows (``tag``) of its own, so that two entries of one card overlap."""

    def __init__(self, device, landmarks: torch.Tensor, projector: torch.Tensor,
                 tr, own_stream: bool, tag: Optional[str]):
        self.device = torch.device(device)
        self.tr, self.tag = tr, tag
        self.stream = None
        if own_stream and self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self.on():
            self.lanes = Lanes(self.device, tr)
            self.landmarks = landmarks.to(self.device)
            self.projector = projector.to(self.device)
        if self.landmarks.device != landmarks.device and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)    # the replicas have landed
        self.free: List[_Slot] = []
        self.chunks = 0

    def on(self):
        return worker_context(self.stream, self.tr, self.tag)


class _Slot:
    """Pinned staging and device buffers of one chunk in flight, grown to
    the largest wire array they have carried, and (for a spill) the pinned
    bounce buffer its G rows come back to."""

    def __init__(self):
        self.host: List[torch.Tensor] = []
        self.dev: List[torch.Tensor] = []
        self.bounce: Optional[torch.Tensor] = None

    def rows_back(self, r: int, rank: int, device) -> torch.Tensor:
        if self.bounce is None or self.bounce.shape[0] < r:
            self.bounce = host_buffer((r, rank), torch.float32, device)
        return self.bounce[:r]

    def put(self, arrays, lanes: Lanes, device, name: str = "copy") -> List[torch.Tensor]:
        out = []
        for j, a in enumerate(arrays):
            a = torch.from_numpy(np.ascontiguousarray(a))
            r = a.shape[0]
            if (j == len(self.host) or self.host[j].shape[0] < r
                    or self.host[j].shape[1:] != a.shape[1:]
                    or self.host[j].dtype != a.dtype):
                buf = (host_buffer(a.shape, a.dtype, device),
                       torch.empty(a.shape, dtype=a.dtype, device=device))
                lanes.claim()
                if j == len(self.host):
                    self.host.append(buf[0])
                    self.dev.append(buf[1])
                else:
                    self.host[j], self.dev[j] = buf
            host, dev = self.host[j][:r], self.dev[j][:r]
            host.copy_(a)
            lanes.put(dev, host, name)
            out.append(dev)
        return out


@full_fp32()
def stream_factor_blocks(
    blocks: Iterable,
    n: int,
    landmarks: torch.Tensor,
    projector: torch.Tensor,
    params: KernelParams,
    *,
    prefetch: int = 2,
    out=None,
    wire_dtype: str = "f32",
    quant_group_rows: int = GROUP_ROWS,
    autotune_prefetch: bool = False,
    prefetch_cap: int = 8,
    stats: Optional[Stage1StreamStats] = None,
    gram_fn: Callable = gram,
    trace=None,
    progress=None,
    durable: Optional[np.ndarray] = None,
    devices=None,
) -> torch.Tensor:
    """Fill a host G = K(x, landmarks) @ projector from an iterator of
    (rows, p) fp32 row blocks totalling ``n`` rows (see the module
    docstring).  A block may be a ``quant.QuantBlock`` (an int8 shard's
    stored codes): on the int8 wire its codes and table go to the card as
    they are, with no host encode, and on the f32 wire it is decoded on the
    host first.  ``out`` is the host G, allocated (pinned for the card) when
    not given, or a ``shards.ShardSpillSink``: then no host G exists, each
    chunk comes back into its slot's pinned bounce buffer and goes to the
    sink in row order once its copy is done.  ``autotune_prefetch`` deepens
    the queue after the first window when putting took longer than draining
    (``tune_prefetch``).  ``trace`` records the spans of the module
    docstring (``resolve``).

    ``progress`` (a ``resilience.Stage1Progress``) with ``durable`` (the
    on-disk G copy, ``resilience.stage1_memmap``) makes the stream
    resumable: a chunk the log covers is read back from ``durable`` into
    ``out`` and not computed (``chunks_skipped``, ``rows_resumed``), and each
    drained chunk is written to ``durable`` and flushed before its log line.
    Each computed chunk passes the fault site "stage1" (``chunk``: its
    index).

    ``devices`` (a list of device entries; one device may be listed more
    than once) hands the chunks out round-robin: each entry has its own
    streams, slots and landmark / projector replica, and at most
    ``prefetch`` chunks in flight; chunks are drained in row order whoever
    computed them, so G (and a spill, and the resume log) fills as with one
    device, bit for bit."""
    dev = landmarks.device
    rank = projector.shape[1]
    if wire_dtype not in ("f32", "int8"):
        raise ValueError(f"stage-1 wire_dtype must be 'f32' or 'int8', "
                         f"got {wire_dtype!r}")
    quant = wire_dtype == "int8"
    st = stats if stats is not None else Stage1StreamStats()
    st.wire_dtype = wire_dtype
    tr = resolve(trace)
    t_start = time.perf_counter()
    spill = isinstance(out, ShardSpillSink)
    if out is None:
        out = host_buffer((n, rank), torch.float32, dev)
        st.alloc_seconds += time.perf_counter() - t_start
    if not spill:
        check_host(out, dev, "out")
    if tuple(out.shape) != (n, rank):
        raise ValueError(f"out buffer {tuple(out.shape)} != {(n, rank)}")

    entries = [dev] if devices is None else list(devices)
    many = len(entries) > 1
    lanes_of = [_Lane(d, landmarks, projector, tr, own_stream=many,
                      tag=f"w{j}" if many else None) for j, d in enumerate(entries)]
    inflight = collections.deque()   # (lane, slot, done event, first row, end row)

    def drain_one():
        lane, slot, done, s0, e0 = inflight.popleft()
        t0 = tr.begin()
        wait(done)                         # this chunk's G rows are in `out`
        st.drain_seconds += tr.end("drain", "stage1_fetch", t0, rows=e0 - s0,
                                   bytes=(e0 - s0) * rank * BYTES_F32)
        if spill:                          # or in the slot's bounce buffer
            out[s0:e0] = slot.bounce[:e0 - s0].numpy()
        if progress is not None:           # durable before it is logged
            durable[s0:e0] = out[s0:e0].numpy()
            progress.mark(s0, e0, flush=durable.flush)
        lane.free.append(slot)

    tuned = not autotune_prefetch
    s = 0
    blocks = iter(blocks)
    for i in itertools.count():
        t0 = tr.begin()
        xb = next(blocks, None)
        if xb is None:
            st.source_seconds += time.perf_counter() - t0
            break
        st.source_seconds += tr.end("read", "stage1_rows", t0, rows=xb.shape[0])
        pre = isinstance(xb, QuantBlock)
        if pre and not quant:
            xb = dequantize_rows(xb.values, xb.scales, xb.group)
            pre = False
        if not pre:
            xb = np.asarray(xb, np.float32)
        e = s + xb.shape[0]
        if e > n:
            raise ValueError(f"block iterator produced more than {n} rows")
        if progress is not None and progress.covered(s, e):
            out[s:e].copy_(torch.from_numpy(np.asarray(durable[s:e])))
            st.chunks_skipped += 1
            st.rows_resumed += e - s
            s = e
            continue
        fault_check("stage1", chunk=i)
        lane = lanes_of[i % len(lanes_of)]
        group = quant_group_rows
        if pre:                            # the stored codes, as they are
            vals, scales, group = xb.values, xb.scales, xb.group
        elif quant:
            t0 = tr.begin()
            vals, scales = quantize_rows(xb, quant_group_rows, symmetric=True)
            st.encode_seconds += tr.end("encode", "stage1_quant", t0, rows=e - s,
                                        bytes=vals.nbytes + scales.nbytes)
        if quant:
            wire = (vals, scales)
            st.bytes_scales += scales.nbytes
        else:
            wire = (xb,)
        slot = lane.free.pop() if lane.free else _Slot()
        nbytes = sum(a.nbytes for a in wire)
        with lane.on():
            t0 = tr.begin()
            on_card = slot.put(wire, lane.lanes, lane.device, "stage1_copy")
            st.put_seconds += tr.end("h2d", "stage1_put", t0, bytes=nbytes)
            st.bytes_h2d += nbytes
            with tr.device_span("kernel", "stage1_chunk", lane.device, rows=e - s):
                if quant:
                    k = gram_q8(on_card[0], on_card[1], lane.landmarks, params, group=group)
                else:
                    k = gram_fn(on_card[0], lane.landmarks, params)
                g = k @ lane.projector
            del k
            dst = slot.rows_back(e - s, rank, lane.device) if spill else out[s:e]
            inflight.append((lane, slot, lane.lanes.fetch(dst, g), s, e))
            del g
        lane.chunks += 1
        st.chunks += 1
        st.rows += e - s
        if len(inflight) >= prefetch * len(lanes_of):
            drain_one()
            if not tuned:
                tuned = True
                prefetch = tune_prefetch(st.put_seconds, st.drain_seconds,
                                         prefetch, prefetch_cap)
        s = e
    while inflight:
        drain_one()
    if s != n:
        raise ValueError(f"block iterator produced {s} rows, expected {n}")
    st.device_chunks = [lane.chunks for lane in lanes_of]
    st.h2d_seconds += sum(lane.lanes.h2d_seconds() for lane in lanes_of)
    st.prefetch_final = prefetch
    st.seconds = time.perf_counter() - t_start
    return out


def row_blocks(x: np.ndarray, chunk_rows: int):
    """Consecutive row slices of the host array ``x``, ``chunk_rows`` rows
    each (the last one shorter)."""
    n = x.shape[0]
    return (x[s:min(s + chunk_rows, n)] for s in range(0, n, chunk_rows))


def stream_factor_rows(x, landmarks: torch.Tensor, projector: torch.Tensor,
                       params: KernelParams, *, chunk_rows: int,
                       **kwargs) -> torch.Tensor:
    """Fill a host G = K(x, landmarks) @ projector, ``chunk_rows`` rows of
    the host array ``x`` at a time; keyword arguments go to
    ``stream_factor_blocks``."""
    x = np.asarray(x, np.float32)
    return stream_factor_blocks(row_blocks(x, chunk_rows), x.shape[0], landmarks,
                                projector, params, **kwargs)


def host_rows(x) -> np.ndarray:
    """The data set as a host fp32 array (a tensor on the card is copied
    back: the streamed route reads x from host memory)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _landmark_rows(n: int, budget: int, seed: int, landmark_idx):
    """``landmark_idx`` when given, else the ``nystrom.landmark_rows`` draw
    (None: every row is a landmark)."""
    from repro_torch.core import nystrom   # nystrom routes back into here
    if landmark_idx is not None:
        return np.asarray(landmark_idx)
    return nystrom.landmark_rows(n, budget, seed)


def compute_factor_streamed(
    x,
    params: KernelParams,
    budget: int,
    *,
    seed: int = 0,
    landmark_idx=None,
    eig_rtol: Optional[float] = None,
    config: StreamConfig = StreamConfig(),
    gram_fn: Callable = gram,
    device=None,
    devices=None,
):
    """Out-of-core stage 1: the artifact of ``nystrom.compute_factor``, with
    G a host tensor (pinned for the card) filled by the chunked pipeline.

    The landmarks are the rows of the same ``torch.Generator`` draw as
    ``nystrom.select_landmarks`` (gathered on the host, so x never goes to
    the card whole), or ``landmark_idx`` when given; K_mm and its eigh are
    those of the monolithic route.  Only the (n, B) part streams, over
    ``devices`` where given (``stream_factor_blocks``: G bit-equal to one
    device's)."""
    x = host_rows(x)
    n, p = x.shape
    rows = _landmark_rows(n, budget, seed, landmark_idx)
    return _streamed_factor_from_landmarks(
        x if rows is None else x[rows], lambda chunk: row_blocks(x, chunk), n, p,
        params, eig_rtol=eig_rtol, config=config, gram_fn=gram_fn, device=device,
        devices=devices, row_provider=lambda s, e: x[s:e])


def compute_factor_streamed_csr(
    data,
    params: KernelParams,
    budget: int,
    *,
    seed: int = 0,
    landmark_idx=None,
    eig_rtol: Optional[float] = None,
    config: StreamConfig = StreamConfig(),
    gram_fn: Callable = gram,
    device=None,
    devices=None,
):
    """Out-of-core stage 1 straight from a ``data.CSRData`` (LIBSVM) data set.

    The sparse triple stays the only full-data host object: the landmarks
    are gathered row by row from the CSR storage, and the (n, p) dense matrix
    only ever exists one ``auto_chunk_rows`` block at a time, on its way to a
    pinned staging slot (``CSRData.iter_dense_blocks`` ->
    ``stream_factor_blocks``).  The landmark rows, chunk boundaries and tail
    are ``compute_factor_streamed``'s, so the factor is that of
    ``compute_factor_streamed(data.densify(), ...)`` bit for bit, on either
    wire."""
    n, p = data.n, data.n_features
    rows = _landmark_rows(n, budget, seed, landmark_idx)
    landmarks = data.densify() if rows is None else data.densify_rows(rows)
    return _streamed_factor_from_landmarks(
        landmarks, lambda chunk: (blk for blk, _ in data.iter_dense_blocks(chunk)),
        n, p, params, eig_rtol=eig_rtol, config=config, gram_fn=gram_fn,
        device=device, devices=devices, row_provider=lambda s, e: data.densify(s, e))


def compute_factor_streamed_shards(
    store,
    params: KernelParams,
    budget: int,
    *,
    seed: int = 0,
    landmark_idx=None,
    eig_rtol: Optional[float] = None,
    config: StreamConfig = StreamConfig(),
    gram_fn: Callable = gram,
    device=None,
    devices=None,
):
    """Out-of-core stage 1 from a checksummed ``shards.ShardStore``: the
    LIBSVM text was parsed once into the store, and every run streams its
    verified shards.  A shard is one chunk (``chunk_rows`` is pinned to
    ``store.shard_rows``), so

      * an f32 store gives the chunks of ``compute_factor_streamed`` on the
        same rows at ``chunk_rows = shard_rows``, and the factor bit for bit,
        on either wire;
      * an int8 store puts its stored codes on the int8 wire as they are
        (no host encode: ``encode_seconds`` stays 0); their groups lie where
        the host encoder would put them.

    The landmark rows are gathered from the store (decoded, for an int8
    store), from ``landmark_idx`` or the seeded draw."""
    n, p = store.n, store.cols
    rows = _landmark_rows(n, budget, seed, landmark_idx)
    landmarks = store.read_rows(0, n) if rows is None else store.gather_rows(rows)
    wire = store.dtype == "int8"

    def row_provider(s, e):
        if wire:
            return store.read_shard(s // store.shard_rows, wire=True)
        return store.read_rows(s, e)

    return _streamed_factor_from_landmarks(
        landmarks, lambda chunk: store.iter_blocks(wire=wire), n, p, params,
        eig_rtol=eig_rtol, config=dataclasses.replace(config, chunk_rows=store.shard_rows),
        gram_fn=gram_fn, device=device, devices=devices, row_provider=row_provider)


def _g_rebuilder(row_provider, chunk: int, n: int, landmarks: torch.Tensor,
                 projector: torch.Tensor, params: KernelParams, config: StreamConfig,
                 gram_fn: Callable, devices=None):
    """The rebuilder of a spilled G's shards: G rows [lo, hi) computed again
    from whole chunks of the first pass (the same rows, wire and groups), so
    the rebuilt shard is bit-equal to the spilled one and its digest holds."""
    def rebuild(lo: int, hi: int) -> np.ndarray:
        c0 = (lo // chunk) * chunk
        c1 = min(n, -(-hi // chunk) * chunk)
        blocks = (row_provider(s, min(s + chunk, c1)) for s in range(c0, c1, chunk))
        sub = stream_factor_blocks(
            blocks, c1 - c0, landmarks, projector, params, prefetch=config.prefetch,
            wire_dtype=config.stage1_dtype, quant_group_rows=config.quant_group_rows,
            gram_fn=gram_fn, trace=config.trace, devices=devices)
        return sub.numpy()[lo - c0:hi - c0]

    return rebuild


def _streamed_factor_from_landmarks(landmarks: np.ndarray, make_blocks, n: int, p: int,
                                    params: KernelParams, *, eig_rtol: Optional[float],
                                    config: StreamConfig, gram_fn: Callable, device,
                                    devices=None, row_provider=None):
    """The shared tail of the streamed stage-1 constructors: the host
    landmark rows go to the card, K_mm and its eigh, then
    ``make_blocks(chunk_rows)``'s row blocks stream into the host G, or with
    ``config.spill_g`` into f32 shards under ``<shard_dir>/g_spill``, which
    stage 2 then reads as a ``shards.GShardView`` (the spill takes the place
    of the stage-1 checkpoint copy: the store is G's durable copy).
    ``row_provider(s, e)`` gives the input rows [s, e) again, for the
    rebuild of a spilled shard that fails its checksum.  ``devices`` spreads
    the chunks over device entries (``stream_factor_blocks``); K_mm and its
    eigh run on ``device`` (default: the first entry, else the card)."""
    from repro_torch.core import nystrom   # nystrom routes back into here

    if device is None and devices:
        device = devices[0]
    device = torch.device("cuda" if device is None else device)
    if eig_rtol is None:
        eig_rtol = nystrom.DEFAULT_EIG_RTOL
    landmarks = torch.as_tensor(landmarks, device=device)
    k_mm = gram_fn(landmarks, landmarks, params)
    projector, evals, rank = nystrom.eig_projector(k_mm, eig_rtol)
    projector = projector[:, :rank].contiguous()

    chunk = auto_chunk_rows(n, p, landmarks.shape[0], config)
    stats = Stage1StreamStats()
    progress = durable = sink = None
    if config.spill_g:
        sink = ShardSpillSink(os.path.join(config.shard_dir, "g_spill"), n, rank,
                              shard_rows=config.shard_rows, trace=config.trace)
    elif config.checkpoint_dir:
        # resumable: G stays a pinned host tensor for stage 2, and each
        # drained chunk is also written to <dir>/stage1_G.npy and logged
        from repro_torch.core.resilience import Stage1Progress, stage1_memmap
        durable = stage1_memmap(config.checkpoint_dir, n, rank, config.resume)
        progress = Stage1Progress(
            os.path.join(config.checkpoint_dir, "stage1_progress.log"), n, rank,
            resume=config.resume)
    try:
        G = stream_factor_blocks(
            make_blocks(chunk), n, landmarks, projector, params, out=sink,
            prefetch=config.prefetch, wire_dtype=config.stage1_dtype,
            quant_group_rows=config.quant_group_rows,
            autotune_prefetch=config.autotune_prefetch,
            prefetch_cap=config.prefetch_cap, stats=stats, gram_fn=gram_fn,
            trace=config.trace, progress=progress, durable=durable, devices=devices)
    finally:
        if progress is not None:
            progress.close()
    if sink is not None:
        rebuilder = (None if row_provider is None else
                     _g_rebuilder(row_provider, chunk, n, landmarks, projector, params,
                                  config, gram_fn, devices))
        G = sink.finish(rebuilder=rebuilder, verify=config.verify_shards,
                        retries=0 if config.fail_fast else config.max_retries,
                        retry_backoff=config.retry_backoff)
    return nystrom.LowRankFactor(
        G=G, landmarks=landmarks, projector=projector, eigvals=evals,
        effective_rank=rank, kernel=params, streamed=True, stage1_stats=stats)
