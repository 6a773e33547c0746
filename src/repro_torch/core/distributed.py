"""The multi-device task farm of LPD-SVM (PyTorch port of
``repro.core.distributed``; it imports nothing of the JAX package).

The paper's hardware mapping, "many cores driving multiple GPUs out of a
large-RAM host": stage 2 is a task farm (OVO pairs x CV folds x grid cells
are independent binary problems), and stage 1 is row-parallel.

The port runs one process with one host worker thread per device entry, as
the reference does (``_DeviceWorkers``); it uses no ``torch.distributed``,
since the farm has no collectives and all of its traffic is host -> device.
A device list may name one device more than once (``[cuda:0, cuda:0]``,
``[cpu] * 4``): the port's counterpart of XLA's
``--xla_force_host_platform_device_count``.  Each entry gets its own engine
(``solver_stream._Stage2Engine``), its own copy and compute streams on its
device, its own block ring and block cache and its own
``device_budget_bytes``.

* ``solve_tasks_streamed``: the out-of-core farm over a host G.  The tasks
  are split over the entries by their real-row counts (LPT,
  ``balance_task_split``; C-ladder chains whole, ``balance_chain_split``).
  Overlapped (the default), one shared reader stages each block of G once a
  shared pass, in pinned memory, and pushes it into every live worker's
  bounded queue, so the pass's ``bytes_h2d`` is one device's while
  ``bytes_put`` counts every copy; serial (``overlap=False``), each entry's
  share streams G on its own, one after the other.  A task's trajectory
  does not depend on which worker runs it, so the farm gives one device's
  alphas, w and epochs.  ``solver_stream.solve_streamed_auto`` routes here
  where more than one local device is listed.
* Faults: a worker's error surfaces at the next barrier with its worker's
  name.  Under ``fail_fast=False`` an error ``classify_error`` calls
  persistent quarantines the worker: the tasks are split again over the
  survivors and the solve continues from the last full-pass boundary's
  in-memory snapshot (``StreamGuard(degrade=True)``), bit-equal to a clean
  run on the survivors; the re-split is counted (``resplits``), traced and
  printed.  ``watchdog_seconds`` bounds every barrier and the reader's
  waits (``WatchdogTimeout``, with each worker's state); ``close`` reports
  a worker that is still alive (``WorkerStuckError``).
* ``solve_tasks_sharded``: the device-resident farm: G replicated on each
  device, each device's share of the (padded, ``pad_tasks``) tasks through
  the monolithic ``solve_batch`` (kernel B2), a thread a device.
* ``stream_factor_over_mesh`` / ``compute_factor_streamed_mesh``: stage 1
  over devices, chunks handed out round-robin (``core/streaming.py``).

The ``*_mesh`` names stay the reference's; each takes a sequence of devices
where the reference takes a ``Mesh``.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import shards
from repro_torch.core.dual_solver import (SolveResult, SolverConfig, TaskBatch,
                                          solve_batch)
from repro_torch.core.faults import check as fault_check
from repro_torch.core.faults import classify_error
from repro_torch.core.kernel_fn import KernelParams, full_fp32, gram
from repro_torch.core.resilience import (StreamGuard, WatchdogTimeout, WorkerStuckError,
                                         g_fingerprint)
from repro_torch.core.solver_stream import (Stage2StreamStats, _Scales, _SharedReader,
                                            _Stage2Engine, auto_tile_rows,
                                            drive_streamed_engines, host_factor,
                                            merge_stream_stats, resume_engines,
                                            solve_batch_streamed)
from repro_torch.core.streaming import (StreamConfig, compute_factor_streamed,
                                        stream_factor_rows)
from repro_torch.core.trace import resolve


def _devices(devices) -> List[torch.device]:
    """The entries as ``torch.device``s, a card always with its index (its
    worker's name, e.g. ``cuda:0/w1``, is the fault sites' ``device``)."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def _select(tasks: TaskBatch, part: np.ndarray, device) -> TaskBatch:
    """The tasks ``part`` of a batch, on ``device``."""
    return TaskBatch(*(a[torch.as_tensor(part, device=a.device)].to(device)
                       for a in tasks))


# ---------------------------------------------------------------------------
# the device-resident farm
# ---------------------------------------------------------------------------

def pad_tasks(tasks: TaskBatch, multiple: int) -> Tuple[TaskBatch, int]:
    """Pad the task axis to a multiple of the device count with inert
    (c = 0) tasks; returns the padded batch and the real task count."""
    T = tasks.n_tasks
    T_pad = -(-T // multiple) * multiple
    if T_pad == T:
        return tasks, T

    def pad(a):
        return torch.cat([a, a.new_zeros((T_pad - T,) + tuple(a.shape[1:]))])

    return TaskBatch(*(pad(a) for a in tasks)), T


@full_fp32()
def solve_tasks_sharded(G: torch.Tensor, tasks: TaskBatch, config: SolverConfig,
                        devices: Sequence) -> SolveResult:
    """Solve a batch with the task axis split over ``devices`` and G
    replicated on each (the reference's ``shard_map`` farm): the padded task
    axis is cut into equal contiguous shares, each solved by
    ``dual_solver.solve_batch`` on its device from a thread of its own (on a
    stream of its own on the card).  The result lies on the tasks' device."""
    devices = _devices(devices)
    padded, T = pad_tasks(tasks, len(devices))
    per = padded.n_tasks // len(devices)
    out_dev = tasks.idx.device

    def run(j: int) -> SolveResult:
        d = devices[j]
        sub = TaskBatch(*(a[j * per:(j + 1) * per] for a in padded))
        if d.type != "cuda":
            return solve_batch(G.to(d), _select(sub, np.arange(per), d), config)
        stream = torch.cuda.Stream(d)
        stream.wait_stream(torch.cuda.current_stream(d))
        with torch.cuda.stream(stream):
            res = solve_batch(G.to(d), _select(sub, np.arange(per), d), config)
        stream.synchronize()
        return res

    with ThreadPoolExecutor(len(devices), thread_name_prefix="sharded") as ex:
        results = list(ex.map(run, range(len(devices))))
    return SolveResult(*(torch.cat([getattr(r, f).to(out_dev) for r in results])[:T]
                         for f in SolveResult._fields))


# ---------------------------------------------------------------------------
# the task split (the reference's, on numpy)
# ---------------------------------------------------------------------------

def balance_task_split(row_counts: Sequence[int], n_parts: int) -> List[np.ndarray]:
    """Partition tasks over ``n_parts`` devices balanced by real-row count:
    LPT greedy (tasks by count, descending, each to the lightest part), so
    one fat OVO pair cannot serialise the farm.  Empty parts are dropped;
    each part is a sorted task-index array."""
    counts = np.asarray(row_counts, np.int64)
    order = np.argsort(-counts, kind="stable")
    loads = np.zeros(max(1, n_parts), np.int64)
    parts: List[List[int]] = [[] for _ in range(max(1, n_parts))]
    for t in order:
        k = int(np.argmin(loads))
        parts[k].append(int(t))
        loads[k] += max(int(counts[t]), 1)   # inert tasks still spread
    return [np.sort(np.asarray(p, np.int64)) for p in parts if p]


def balance_chain_split(row_counts: Sequence[int], chain_next,
                        n_parts: int) -> List[np.ndarray]:
    """``balance_task_split`` over C-ladder chains: a chain (task t, its
    ``chain_next[t]`` successor, ...) stays on one device, since the
    successor is seeded from its predecessor's alphas inside the engine,
    and weighs the sum of its members' row counts."""
    counts = np.asarray(row_counts, np.int64)
    nxt = np.asarray(chain_next, np.int64)
    has_pred = np.zeros(len(counts), bool)
    for s in nxt:
        if s >= 0:
            has_pred[s] = True
    chains: List[List[int]] = []
    for t in range(len(counts)):
        if has_pred[t]:
            continue
        chain, u = [], t
        while u >= 0:
            chain.append(u)
            u = int(nxt[u])
        chains.append(chain)
    weights = [sum(max(int(counts[t]), 1) for t in ch) for ch in chains]
    groups = balance_task_split(weights, n_parts)
    return [np.sort(np.concatenate([np.asarray(chains[int(ci)], np.int64)
                                    for ci in g])) for g in groups]


def _local_chain(chain_next, part: np.ndarray) -> Optional[np.ndarray]:
    """The global ``chain_next`` remapped onto one share's task indices."""
    if chain_next is None:
        return None
    nxt = np.asarray(chain_next, np.int64)
    local = {int(g): i for i, g in enumerate(part)}
    return np.array([local.get(int(nxt[int(g)]), -1) for g in part], np.int64)


def _split(row_counts, chain_next, n_parts: int) -> List[np.ndarray]:
    if chain_next is not None:
        return balance_chain_split(row_counts, chain_next, n_parts)
    return balance_task_split(row_counts, n_parts)


# ---------------------------------------------------------------------------
# the host workers
# ---------------------------------------------------------------------------

class _DeviceWorkers:
    """One host worker thread per engine for the overlapped farm.

    The driver pushes each engine's calls into the engine's bounded queue;
    the worker runs them in order, so the engine's sequence of blocks (and
    its trajectory) is the one-device one, while copies and launches of
    different workers overlap.  The bound is backpressure: the reader
    waits instead of staging without end when a worker falls behind.  A
    worker's error is kept with its name (``failed``) and raised at the next
    barrier; the worker then skips the rest of its jobs (a skipped block
    still releases the reader's buffer).

    Under an enabled tracer the two stalls are spans: the reader's
    ``queue/backpressure`` (blocked on a full queue: that worker is the
    bottleneck) and each worker's ``queue/worker_idle`` (waiting for the
    reader), with a ``queue_depth/<name>`` gauge.  ``watchdog`` > 0 bounds
    the barrier and the reader's waits: past it a ``WatchdogTimeout`` names
    every worker's state.  ``close`` reports a worker still alive after its
    join timeout (``WorkerStuckError``; a warning while an error unwinds,
    after at most a second).  Fault site "stall" is where a worker takes a
    job (``device``, and a block's ``block`` and ``epoch``)."""

    def __init__(self, engines, depth: int, trace=None,
                 names: Optional[Sequence[str]] = None,
                 watchdog: float = 0.0, join_timeout: float = 60.0):
        self._tr = resolve(trace)
        if names is None:
            names = [f"dev{i}" for i in range(len(engines))]
        self._names = {id(e): nm for e, nm in zip(engines, names)}
        self._queues = {id(e): queue.Queue(maxsize=max(2, depth)) for e in engines}
        self._errors: List[Tuple[str, BaseException]] = []
        self._closing = False
        self._watchdog = watchdog
        self._join_timeout = join_timeout
        self._last = {nm: ("spawned", time.monotonic()) for nm in names}
        self._threads = []
        for e in engines:
            nm = self._names[id(e)]
            th = threading.Thread(target=self._loop, args=(self._queues[id(e)], nm),
                                  name=f"worker/{nm}", daemon=True)
            th.start()
            self._threads.append(th)

    def _loop(self, q, name):
        tr = self._tr
        while True:
            t0 = tr.begin()
            job = q.get()
            try:
                if job is None:
                    self._last[name] = ("exited", time.monotonic())
                    return
                if tr.enabled:
                    tr.end("queue", "worker_idle", t0, device=name)
                    tr.counter(f"queue_depth/{name}", q.qsize())
                fault_check("stall", device=name, **getattr(job, "attrs", {}))
                self._last[name] = ("running", time.monotonic())
                if self._errors:
                    skip = getattr(job, "skip", None)
                    if skip is not None:
                        skip()
                else:
                    job()
                self._last[name] = ("idle", time.monotonic())
            except BaseException as exc:   # noqa: BLE001 - raised at the barrier
                self._errors.append((name, exc))
                self._last[name] = (f"error:{type(exc).__name__}", time.monotonic())
                tr.instant("fault", "worker_error", device=name, error=type(exc).__name__)
            finally:
                q.task_done()
            if self._closing and q.empty():   # closed on a full queue
                self._last[name] = ("exited", time.monotonic())
                return

    def submit(self, engine, fn) -> None:
        q = self._queues[id(engine)]
        tr = self._tr
        t0 = tr.begin() if tr.enabled and q.full() else None
        try:
            q.put(fn, timeout=self._watchdog if self._watchdog > 0 else None)
        except queue.Full:
            raise WatchdogTimeout(
                f"worker {self._names[id(engine)]}'s queue stayed full past "
                f"{self._watchdog:.1f}s; worker states:\n" + self.diagnose()) from None
        if t0 is not None:      # the reader waited on a full queue
            tr.end("queue", "backpressure", t0, device=self._names[id(engine)])

    def failed(self):
        """Worker name -> its first error (the quarantine's input)."""
        out = {}
        for nm, exc in self._errors:
            out.setdefault(nm, exc)
        return out

    def diagnose(self) -> str:
        now = time.monotonic()
        lines = []
        for q, th in zip(self._queues.values(), self._threads):
            nm = th.name.split("/", 1)[-1]
            state, when = self._last.get(nm, ("unknown", now))
            lines.append(f"  {th.name}: alive={th.is_alive()} queued={q.qsize()} "
                         f"unfinished={q.unfinished_tasks} last={state} "
                         f"{now - when:.1f}s ago")
        return "\n".join(lines)

    def barrier(self) -> None:
        if self._watchdog > 0:
            deadline = time.monotonic() + self._watchdog
            for q in self._queues.values():
                starved = False
                with q.all_tasks_done:
                    while q.unfinished_tasks:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            starved = True
                            break
                        q.all_tasks_done.wait(left)
                if starved:
                    # raised outside the queue's lock: diagnose reads qsize()
                    raise WatchdogTimeout(
                        f"farm barrier starved past {self._watchdog:.1f}s; worker "
                        "states:\n" + self.diagnose())
        else:
            for q in self._queues.values():
                q.join()
        if self._errors:
            raise self._errors[0][1]

    def close(self, suppress: bool = False) -> None:
        self._closing = True
        for q in self._queues.values():
            try:
                q.put_nowait(None)
            except queue.Full:       # a stuck worker: it exits once it drains
                pass
        join = min(self._join_timeout, 1.0) if suppress else self._join_timeout
        stuck = []
        for th in self._threads:
            th.join(timeout=join)
            if th.is_alive():
                stuck.append(th.name)
        if stuck:
            msg = (f"worker threads still alive after {join:.1f}s join: "
                   f"{', '.join(stuck)}\n" + self.diagnose())
            self._tr.instant("fault", "worker_leak", threads=len(stuck))
            if suppress:
                # an error is already unwinding: a raise here would replace it
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
            else:
                raise WorkerStuckError(msg)


# ---------------------------------------------------------------------------
# the streamed farm
# ---------------------------------------------------------------------------

def _scatter_results(parts: Sequence[np.ndarray], results, T: int, n_pad: int,
                     rank: int, device) -> SolveResult:
    """The shares' results back in the batch's task order, on ``device``."""
    r0 = results[0]
    out = [torch.zeros((T, n_pad), dtype=r0.alpha.dtype, device=device),
           torch.zeros((T, rank), dtype=r0.w.dtype, device=device)]
    out += [torch.zeros((T,), dtype=getattr(r0, f).dtype, device=device)
            for f in SolveResult._fields[2:]]
    for p, r in zip(parts, results):
        ix = torch.as_tensor(p, device=device)
        for o, v in zip(out, r):
            o[ix] = v.to(device)
    return SolveResult(*out)


def _serial_farm(G, tasks, config, cfg, devices, chain_next, parts, t0):
    """Each entry's share streamed on its own, one after the other: G is
    read once per entry (the reference's baseline for the shared reader).
    Each share checkpoints into a directory of its own,
    ``<checkpoint_dir>/w{j}of{k}`` (the split over k entries is a function
    of the tasks, so a resume on k entries finds each share's snapshots)."""
    results, per_dev = [], []
    for j, (d, p) in enumerate(zip(devices, parts)):
        sc = cfg
        if cfg.checkpoint_dir:
            sc = dataclasses.replace(cfg, checkpoint_dir=os.path.join(
                cfg.checkpoint_dir, f"w{j}of{len(parts)}"))
        r, s = solve_batch_streamed(G, _select(tasks, p, d), config, stream_config=sc,
                                    chain_next=_local_chain(chain_next, p),
                                    return_stats=True)
        results.append(r)
        per_dev.append(s)
    res = _scatter_results(parts, results, tasks.n_tasks, tasks.idx.shape[1],
                           G.shape[1], tasks.idx.device)
    reader0 = Stage2StreamStats(tile_rows=per_dev[0].tile_rows, block_dtype=cfg.block_dtype)
    return res, merge_stream_stats(reader0, per_dev, seconds=time.perf_counter() - t0,
                                   n_devices=len(parts))


@full_fp32()
def solve_tasks_streamed(G, tasks: TaskBatch, config: SolverConfig, *, devices: Sequence,
                         stream_config: Optional[StreamConfig] = None,
                         overlap: bool = True, return_stats: bool = False,
                         chain_next=None):
    """The out-of-core stage-2 task farm over ``devices`` (see the module
    docstring); G is a host tensor (pinned where a device is the card), an
    array, or a spilled G's ``GShardView``.  Returns a ``SolveResult`` on the
    tasks' device, laid out as ``solve_batch``'s, and with ``return_stats``
    the farm's ``Stage2StreamStats`` (``n_devices``, ``per_device``,
    ``bytes_put``).  With one device or one task it is
    ``solve_batch_streamed`` on the first device.

    Each engine keeps its own block cache over its share's compacted union;
    shared passes never consult the caches.  The overlapped farm's
    checkpoints (``checkpoint_dir``) are of the whole solve, keyed by task,
    so it resumes on any number of workers; the serial farm's are a share's
    each, in a directory a share, and resume on the same number."""
    t0 = time.perf_counter()
    cfg = stream_config or StreamConfig()
    devices = _devices(devices)
    T, n_pad = tasks.idx.shape
    out_dev = tasks.idx.device
    if len(devices) <= 1 or T <= 1:
        dev = devices[0] if devices else out_dev
        sub = tasks if dev == out_dev else _select(tasks, np.arange(T), dev)
        out = solve_batch_streamed(G, sub, config,
                                   stream_config=cfg, chain_next=chain_next,
                                   return_stats=return_stats)
        res, st = out if return_stats else (out, None)
        res = SolveResult(*(v.to(out_dev) for v in res))
        return (res, st) if return_stats else res

    G = host_factor(G, devices)
    n, rank = G.shape
    row_counts = (tasks.c > 0.0).sum(1).cpu().numpy().astype(np.int64)
    if not overlap:
        res, st = _serial_farm(G, tasks, config, cfg, devices, chain_next,
                               _split(row_counts, chain_next, len(devices)), t0)
        return (res, st) if return_stats else res

    tr = resolve(cfg.trace)
    guard = snap = None
    if cfg.checkpoint_dir or not cfg.fail_fast:
        guard = StreamGuard(cfg, n=n, rank=rank, sizes=row_counts,
                            g_fp=g_fingerprint(shards.numpy_rows(G)),
                            degrade=not cfg.fail_fast)
        if cfg.checkpoint_dir and cfg.resume:
            snap = guard.try_resume()
    cuda = any(d.type == "cuda" for d in devices)
    scales = _Scales()                  # one int8 table for every engine
    avail = list(range(len(devices)))   # entry indices: names stay stable
    resplits = 0
    while True:
        parts = _split(row_counts, chain_next, len(avail))
        # one tile for every engine (the reader stages each block once),
        # sized by the largest share
        tile = auto_tile_rows(n, rank, max(len(p) for p in parts), cfg)
        engines = [_Stage2Engine(G, _select(tasks, p, devices[j]), config, cfg, tile=tile,
                                 chain_next=_local_chain(chain_next, p),
                                 name=f"{devices[j]}/w{j}", tag=f"w{j}", task_ids=p,
                                 scales=scales, own_stream=True)
                   for j, p in zip(avail, parts)]
        reader = _SharedReader(G, tile, cfg, cuda, tr, depth=max(2, cfg.prefetch) + 2)
        start = 0
        if snap is not None:
            start = resume_engines(guard, snap, engines, reader, T, n_pad, n)
        workers = _DeviceWorkers(engines, depth=max(2, cfg.prefetch), trace=tr,
                                 names=[e.name for e in engines],
                                 watchdog=cfg.watchdog_seconds)
        reader.diagnose = workers.diagnose
        try:
            drive_streamed_engines(engines, reader, config, cfg, fanout=workers,
                                   guard=guard, start=start)
            break
        except Exception:
            failed = workers.failed()
            if (cfg.fail_fast or guard is None or not failed
                    or any(classify_error(e) != "persistent" for e in failed.values())):
                raise
            keep = [k for k, e in enumerate(engines) if e.name not in failed]
            if not keep:
                raise
            # quarantine the lost workers; the solve rolls back to the last
            # boundary's snapshot and the next lap splits every task over the
            # survivors (a task's trajectory does not depend on its worker)
            snap = guard.mem
            resplits += 1
            lost = [f"{nm} ({type(exc).__name__})" for nm, exc in failed.items()]
            epoch_next = int(snap["meta"]["epoch_next"])
            tr.instant("recovery", "quarantine", lost=len(lost), survivors=len(keep),
                       resume_epoch=epoch_next)
            print(f"stage2 farm: lost {', '.join(lost)}; re-split {T} tasks over "
                  f"{len(keep)} worker(s) from epoch {epoch_next}", file=sys.stderr)
            avail = [avail[k] for k in keep]
    pairs = [e.result() for e in engines]
    res = _scatter_results(parts, [p[0] for p in pairs], T, n_pad, rank, out_dev)
    if not return_stats:
        return res
    st = merge_stream_stats(reader.st, [p[1] for p in pairs],
                            seconds=time.perf_counter() - t0, n_devices=len(engines),
                            carry=guard.carry if guard else None)
    st.resplits += resplits
    return res, st


def solve_tasks_streamed_mesh(devices: Sequence, G, tasks: TaskBatch, config: SolverConfig,
                              *, stream_config: Optional[StreamConfig] = None,
                              overlap: bool = True, return_stats: bool = False,
                              chain_next=None):
    """``solve_tasks_streamed`` over ``devices`` (the reference's
    ``Mesh``'s local devices)."""
    return solve_tasks_streamed(G, tasks, config, devices=devices,
                                stream_config=stream_config, overlap=overlap,
                                chain_next=chain_next, return_stats=return_stats)


# ---------------------------------------------------------------------------
# stage 1 over devices
# ---------------------------------------------------------------------------

def stream_factor_over_mesh(devices: Sequence, x, landmarks: torch.Tensor,
                            projector: torch.Tensor, params: KernelParams, *,
                            chunk_rows: int, prefetch: int = 2, gram_fn=None, out=None,
                            **kwargs) -> torch.Tensor:
    """A host G = K(x, landmarks) @ projector, ``chunk_rows`` rows at a time,
    the chunks handed out round-robin over ``devices`` (each entry with its
    own streams and landmark / projector replica; no collectives): the
    stage-1 half of the farm, bit-equal to one device's G."""
    return stream_factor_rows(x, landmarks, projector, params, chunk_rows=chunk_rows,
                              prefetch=prefetch, gram_fn=gram_fn or gram, out=out,
                              devices=_devices(devices), **kwargs)


def compute_factor_streamed_mesh(devices: Sequence, x, params: KernelParams, budget: int,
                                 *, seed: int = 0, landmark_idx=None,
                                 stream_config: Optional[StreamConfig] = None,
                                 gram_fn=None):
    """``streaming.compute_factor_streamed`` with the chunks spread over
    ``devices`` (K_mm and its eigh on the first)."""
    devices = _devices(devices)
    return compute_factor_streamed(x, params, budget, seed=seed, landmark_idx=landmark_idx,
                                   config=stream_config or StreamConfig(),
                                   gram_fn=gram_fn or gram, device=devices[0],
                                   devices=devices)


__all__ = ["balance_chain_split", "balance_task_split", "compute_factor_streamed_mesh",
           "pad_tasks", "solve_tasks_sharded", "solve_tasks_streamed",
           "solve_tasks_streamed_mesh", "stream_factor_over_mesh"]
