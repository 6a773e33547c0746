"""Process-wide span / counter tracer for the streamed pipelines (PyTorch
port of ``repro.core.trace``).

The stats dataclasses (``Stage1StreamStats``, ``Stage2StreamStats``, ...)
stay the assertable totals; the tracer is the timeline over the same
measurements: every host ``perf_counter`` pair that feeds a stats field
becomes a span ``(category, name, t_start, dur, row, attrs)`` whose duration
is what the field is fed, plus instant events and counter samples.

Record layout (one immutable tuple a record, the reference's):
``(ph, category, name, t_abs, dur, tid, attrs)``; ph is "X" (span), "i"
(instant) or "C" (counter), t_abs and dur are ``perf_counter`` seconds.

Device spans.  On the card a launch, a kernel or an H2D copy on the
``Lanes`` stream returns to the host before the device runs it, so a host
``perf_counter`` pair around it times the enqueue only.  Under an enabled
tracer such work is recorded as a pair of ``torch.cuda.Event(
enable_timing=True)`` on the stream that runs it (``device_span`` around
the launch; ``device_events`` for a pair the caller already keeps, as
``Lanes`` does for its copies).  The pairs stay pending: nothing waits for
them while the run goes on.  ``events()``, ``export()`` and ``summary()``
resolve them with one ``torch.cuda.synchronize`` and place them on the
host's clock through one anchor event a device, recorded on an idle device
(a synchronisation at the first device span of the tracer) beside one
``perf_counter`` reading: t = t_anchor + anchor.elapsed_time(start).  Each
(device, stream role) is a row of its own (``cuda:0 compute``,
``cuda:0 h2d``; a farm worker's under its ``row_tag``, ``cuda:0/w1
compute``), so Perfetto shows the device's rows under the host threads'
(each farm worker's thread is a host row of its own), and ``overlap_efficiency(device=True)`` is the share of the H2D
copies' device time that lies under device compute on another row.  On the
CPU a device span is a host span: the plain kernels are synchronous there.

The NULL tracer is the fast path every call site sees by default: its
``begin`` / ``end`` still return ``perf_counter`` readings, so every stats
field keeps its meaning, and it records nothing, makes no CUDA event, takes
no lock and adds no synchronisation; a traced run is bit-equal to an
untraced one.

Usage::

    tr = Tracer()
    t0 = tr.begin()
    ...
    stats.put_seconds += tr.end("h2d", "put_block", t0, bytes=nbytes)
    with tr.device_span("kernel", "smo_block", device, rows=m):
        launch()
    tr.export("trace.json"); print(tr.summary())

Call sites resolve their tracer by ``resolve(explicit)``: an explicit
tracer wins, else the process-wide one set by ``install()``, else ``NULL``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Tracer", "NullTracer", "NULL", "ProgressPrinter",
    "install", "uninstall", "active", "resolve",
]

_SPAN, _INSTANT, _COUNTER = "X", "i", "C"

_TRANSFER_CATEGORIES = ("read", "h2d")     # host staging / put time, H2D copies
_COMPUTE_CATEGORIES = ("kernel", "drain")  # device compute / result fetch


class _NullSpan:
    """Shared no-op context manager of ``NullTracer``'s span forms."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled-mode tracer: ``begin`` / ``end`` bracket the region with
    ``perf_counter`` so durations fed to stats fields keep their meaning;
    nothing is recorded, no CUDA event is made, no lock is taken."""

    __slots__ = ()
    enabled = False

    def begin(self) -> float:
        return time.perf_counter()

    def end(self, category: str, name: str, t0: float, **attrs) -> float:
        return time.perf_counter() - t0

    def span(self, category: str, name: str, **attrs):
        return _NULL_SPAN

    def device_span(self, category: str, name: str, device, row: str = "compute",
                    **attrs):
        return _NULL_SPAN

    def device_events(self, category: str, name: str, start, end, device,
                      row: str, **attrs) -> None:
        pass

    def anchor(self, device) -> None:
        pass

    def row_tag(self, tag: str):
        return _NULL_SPAN

    def instant(self, category: str, name: str, **attrs) -> None:
        pass

    def counter(self, name: str, value) -> None:
        pass

    def add_listener(self, fn: Callable) -> None:
        pass


NULL = NullTracer()


class _Span:
    """Context-manager host span for sites that do not feed a stats field."""

    __slots__ = ("_tracer", "category", "name", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", category: str, name: str, attrs: dict):
        self._tracer = tracer
        self.category = category
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def set(self, **attrs):
        """Attach attrs found mid-span (e.g. result sizes)."""
        self.attrs.update(attrs)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._record(_SPAN, self.category, self.name, self._t0,
                             t1 - self._t0, self.attrs)
        return False


class _DeviceSpan(_Span):
    """A span of device work: an event pair on the device's current stream,
    resolved later (see the module docstring)."""

    __slots__ = ("_device", "_row", "_start")

    def __init__(self, tracer, category, name, attrs, device, row):
        super().__init__(tracer, category, name, attrs)
        self._device = device
        self._row = row

    def __enter__(self):
        self._start = self._tracer._device_event(self._device)
        return self

    def __exit__(self, *exc):
        end = self._tracer._device_event(self._device)
        self._tracer.device_events(self.category, self.name, self._start, end,
                                   self._device, self._row, **self.attrs)
        return False


class _RowTag:
    """``Tracer.row_tag``'s context manager (thread-local, nestable)."""

    __slots__ = ("_tls", "_tag", "_prev")

    def __init__(self, tls, tag: str):
        self._tls, self._tag = tls, tag

    def __enter__(self):
        self._prev = getattr(self._tls, "tag", None)
        self._tls.tag = self._tag
        return self

    def __exit__(self, *exc):
        self._tls.tag = self._prev
        return False


class Tracer:
    """Thread-safe in-memory recorder of host spans, device spans (CUDA
    event pairs), instants and counter samples."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[tuple] = []
        self._pending: List[tuple] = []      # unresolved device event pairs
        self._thread_names: Dict[int, str] = {}
        self._device_rows: Dict[Tuple[int, str], int] = {}
        self._anchors: Dict[int, tuple] = {}  # device index -> (event, t_host)
        self._listeners: List[Callable] = []
        self._tls = threading.local()        # the calling thread's row tag
        self.pid = os.getpid()
        self.t0 = time.perf_counter()

    # ---- recording ------------------------------------------------------
    def begin(self) -> float:
        """Start a stats-feeding span; pair with ``end``."""
        return time.perf_counter()

    def end(self, category: str, name: str, t0: float, **attrs) -> float:
        """Close a ``begin`` span, record it and return its duration, so a
        call site feeds its stats field in the same expression."""
        t1 = time.perf_counter()
        self._record(_SPAN, category, name, t0, t1 - t0, attrs)
        return t1 - t0

    def span(self, category: str, name: str, **attrs) -> _Span:
        """Context-manager host span for regions that feed no stats field."""
        return _Span(self, category, name, attrs)

    def device_span(self, category: str, name: str, device, row: str = "compute",
                    **attrs) -> _Span:
        """Context-manager span of the device work queued inside it on
        ``device``'s current stream (row ``row``); a host span on the CPU."""
        import torch
        device = torch.device(device)
        if device.type != "cuda":
            return _Span(self, category, name, attrs)
        return _DeviceSpan(self, category, name, attrs, device, row)

    def row_tag(self, tag: str):
        """Context manager: the device spans this thread records inside it
        go to rows of their own, ``cuda:0/<tag> compute`` and ``cuda:0/<tag>
        h2d`` (a farm worker's, e.g. ``w1``), beside the untagged ones."""
        return _RowTag(self._tls, tag)

    def device_events(self, category: str, name: str, start, end, device,
                      row: str, **attrs) -> None:
        """Record the device work between two timing events the caller has
        recorded on one stream of ``device`` (row ``row``, under the calling
        thread's ``row_tag``)."""
        idx = self.anchor(device)
        tag = getattr(self._tls, "tag", None)
        key = row if tag is None else f"{tag} {row}"
        with self._lock:
            tid = self._device_rows.get((idx, key))
            if tid is None:
                tid = len(self._device_rows) + 1   # thread idents are addresses
                self._device_rows[(idx, key)] = tid
                self._thread_names[tid] = (f"cuda:{idx} {row}" if tag is None
                                           else f"cuda:{idx}/{tag} {row}")
            self._pending.append((category, name, start, end, idx, tid, attrs))

    def instant(self, category: str, name: str, **attrs) -> None:
        """Point event."""
        self._record(_INSTANT, category, name, time.perf_counter(), 0.0, attrs)

    def counter(self, name: str, value) -> None:
        """Gauge sample (active rows, bytes an epoch, ...)."""
        self._record(_COUNTER, "counter", name, time.perf_counter(), 0.0,
                     {"value": float(value)})

    def add_listener(self, fn: Callable) -> None:
        """Subscribe ``fn(event_tuple)`` to every record (the per-epoch
        progress printer).  Listeners run on the recording thread, outside
        the lock; device spans reach them when they are resolved."""
        self._listeners.append(fn)

    def _record(self, ph: str, category: str, name: str, t_abs: float,
                dur: float, attrs: dict) -> None:
        tid = threading.get_ident()
        ev = (ph, category, name, t_abs, dur, tid, attrs)
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append(ev)
        for fn in self._listeners:
            fn(ev)

    # ---- device events --------------------------------------------------
    @staticmethod
    def _index(device) -> int:
        import torch
        device = torch.device(device)
        return device.index if device.index is not None else torch.cuda.current_device()

    def anchor(self, device) -> int:
        """The device's index.  At the first call for a device, its anchor
        event, recorded once the device is idle, beside a ``perf_counter``
        reading; a caller that records its own event pairs for
        ``device_events`` calls this before the first of them."""
        import torch
        idx = self._index(device)
        if idx not in self._anchors:
            torch.cuda.synchronize(idx)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(idx))
            self._anchors[idx] = (ev, time.perf_counter())
        return idx

    def _device_event(self, device):
        import torch
        self.anchor(device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def _resolve(self) -> None:
        """Place the pending device spans on the host's clock: one
        synchronisation a device, then their event times."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        import torch
        for idx in sorted({p[4] for p in pending}):
            torch.cuda.synchronize(idx)
        evs = []
        for category, name, start, end, idx, tid, attrs in pending:
            anchor, t_anchor = self._anchors[idx]
            t_abs = t_anchor + anchor.elapsed_time(start) / 1e3
            evs.append((_SPAN, category, name, t_abs,
                        start.elapsed_time(end) / 1e3, tid, attrs))
        with self._lock:
            self._events.extend(evs)
        for ev in evs:
            for fn in self._listeners:
                fn(ev)

    def device_tids(self) -> Dict[int, str]:
        """Timeline rows of device streams: tid -> row name."""
        with self._lock:
            return {tid: self._thread_names[tid]
                    for tid in self._device_rows.values()}

    # ---- introspection --------------------------------------------------
    @property
    def n_events(self) -> int:
        with self._lock:
            return len(self._events) + len(self._pending)

    def events(self) -> List[tuple]:
        """Snapshot of all records, device spans resolved."""
        self._resolve()
        with self._lock:
            return list(self._events)

    def categories(self) -> Dict[str, int]:
        """Record count per category."""
        out: Dict[str, int] = {}
        for ev in self.events():
            out[ev[1]] = out.get(ev[1], 0) + 1
        return out

    def busy(self, row: str, t_lo: float = float("-inf"),
             t_hi: float = float("inf")) -> Tuple[float, List[Tuple[float, float]]]:
        """Busy seconds of the timeline row named ``row`` inside [t_lo, t_hi),
        and its idle gaps there, largest first."""
        tids = {tid for tid, nm in self._names().items() if nm == row}
        spans = [(max(e[3], t_lo), min(e[3] + e[4], t_hi)) for e in self.events()
                 if e[0] == _SPAN and e[5] in tids]
        merged = _merge_intervals([(a, b) for a, b in spans if b > a])
        if not merged:
            return 0.0, []
        lo = merged[0][0] if t_lo == float("-inf") else t_lo
        hi = merged[-1][1] if t_hi == float("inf") else t_hi
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        return (sum(b - a for a, b in merged),
                sorted(gaps, key=lambda g: g[0] - g[1]))

    def _names(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._thread_names)

    # ---- export ---------------------------------------------------------
    def export(self, path: str) -> None:
        """Write Chrome-trace / Perfetto JSON (ui.perfetto.dev or
        chrome://tracing): timestamps in µs from the tracer's creation, a
        row a recording thread and a row a device stream, each named."""
        events = self.events()
        names = self._names()
        out = []
        for tid, tname in sorted(names.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                        "tid": tid, "args": {"name": tname}})
        for ph, cat, name, t_abs, dur, tid, attrs in events:
            ev = {"ph": ph, "cat": cat, "name": name,
                  "ts": (t_abs - self.t0) * 1e6, "pid": self.pid, "tid": tid}
            if ph == _SPAN:
                ev["dur"] = dur * 1e6
                if attrs:
                    ev["args"] = attrs
            elif ph == _INSTANT:
                ev["s"] = "t"
                if attrs:
                    ev["args"] = attrs
            else:
                ev["args"] = attrs
            out.append(ev)
        payload = {"traceEvents": out, "displayTimeUnit": "ms",
                   "otherData": {"tool": "repro_torch.core.trace"}}
        with open(path, "w") as f:
            json.dump(payload, f, default=_json_default)

    # ---- aggregation ----------------------------------------------------
    def summary(self) -> str:
        """Text view: seconds and records per category of the host's spans,
        effective H2D GB/s, rows/s and the overlap efficiency, as the
        reference prints them; then, where device spans exist, each device
        row's spans, busy seconds and idle share, and the device overlap."""
        events = self.events()
        if not events:
            return "trace: no events recorded"
        dev_tids = self.device_tids()
        spans = [e for e in events if e[0] == _SPAN and e[5] not in dev_tids]
        by_cat: Dict[str, List[tuple]] = {}
        for e in spans:
            by_cat.setdefault(e[1], []).append(e)
        t_lo = min(e[3] for e in events)
        t_hi = max(e[3] + e[4] for e in events)
        wall = max(t_hi - t_lo, 1e-12)

        lines = [f"trace summary ({len(events)} events, "
                 f"{len(self._names())} threads, wall {wall:.3f}s)"]
        for cat in sorted(by_cat):
            lines.append(_category_line(cat, by_cat[cat]))
        h2d = by_cat.get("h2d", [])
        h2d_secs = sum(e[4] for e in h2d)
        h2d_bytes = sum(e[6].get("bytes", 0) for e in h2d)
        if h2d_bytes:
            lines.append(f"  effective H2D: "
                         f"{h2d_bytes / max(h2d_secs, 1e-12) / 1e9:.2f} GB/s "
                         f"({h2d_bytes / 1e9:.3f} GB in {h2d_secs:.3f}s)")
        kern = by_cat.get("kernel", []) or [e for e in events if e[1] == "kernel"
                                            and e[5] in dev_tids]
        rows = sum(e[6].get("rows", 0) for e in kern)
        if rows:
            lines.append(f"  rows/s: {rows / wall:,.0f} "
                         f"({rows:,} row visits in {wall:.3f}s wall)")
        ov = self.overlap_efficiency()
        if ov is not None:
            lines.append(f"  overlap efficiency: {ov:.2f} "
                         f"(fraction of read/h2d time hidden under "
                         f"compute on other threads)")
        for cat, label in (("cache", "cache events"), ("fault", "fault events"),
                           ("recovery", "recovery events")):
            inst: Dict[str, int] = {}
            for e in events:
                if e[0] == _INSTANT and e[1] == cat:
                    inst[e[2]] = inst.get(e[2], 0) + 1
            if inst:
                lines.append(f"  {label}: " + ", ".join(
                    f"{k}={v}" for k, v in sorted(inst.items())))
        if dev_tids:
            lines.append("  device rows (CUDA events):")
            for tid, row in sorted(dev_tids.items(), key=lambda kv: kv[1]):
                evs = [e for e in events if e[0] == _SPAN and e[5] == tid]
                busy, gaps = self.busy(row)
                lo = min(e[3] for e in evs)
                hi = max(e[3] + e[4] for e in evs)
                idle = 1.0 - busy / max(hi - lo, 1e-12)
                lines.append(f"    {row}: busy {busy:.3f}s of {hi - lo:.3f}s "
                             f"(idle {idle:.3f}), largest gap "
                             f"{(gaps[0][1] - gaps[0][0]) if gaps else 0.0:.4f}s")
                cats: Dict[Tuple[str, str], List[tuple]] = {}
                for e in evs:
                    cats.setdefault((e[1], e[2]), []).append(e)
                for (cat, name), grp in sorted(cats.items()):
                    lines.append("  " + _category_line(f"{cat}/{name}", grp))
            dov = self.overlap_efficiency(device=True)
            if dov is not None:
                lines.append(f"  device overlap: {dov:.2f} (fraction of the H2D "
                             f"copies' device time under device compute)")
        return "\n".join(lines)

    def overlap_efficiency(self, device: Optional[bool] = None) -> Optional[float]:
        """Fraction of transfer (read / h2d) span time that overlaps compute
        (kernel / drain) spans on other rows; None without transfer spans,
        0.0 where everything ran on one row.  ``device=True`` takes the
        device rows' spans only (H2D copies under device compute)."""
        spans = [e for e in self.events() if e[0] == _SPAN]
        if device:
            dev_tids = self.device_tids()
            spans = [e for e in spans if e[5] in dev_tids]
        xfer = [e for e in spans if e[1] in _TRANSFER_CATEGORIES]
        comp = [(e[3], e[3] + e[4], e[5]) for e in spans
                if e[1] in _COMPUTE_CATEGORIES]
        if not xfer:
            return None
        total = sum(e[4] for e in xfer)
        if total <= 0.0:
            return 0.0
        hidden = 0.0
        merged_cache: Dict[int, List[Tuple[float, float]]] = {}
        for ph, cat, name, t_abs, dur, tid, attrs in xfer:
            if tid not in merged_cache:
                merged_cache[tid] = _merge_intervals(
                    [(a, b) for a, b, ctid in comp if ctid != tid])
            hidden += _overlap_with(t_abs, t_abs + dur, merged_cache[tid])
        return min(1.0, hidden / total)


def _category_line(label: str, evs: Sequence[tuple]) -> str:
    secs = sum(e[4] for e in evs)
    nbytes = sum(e[6].get("bytes", 0) for e in evs)
    line = f"  {label:<8s} {len(evs):6d} spans  {secs:9.3f}s"
    if nbytes:
        line += (f"  {nbytes / 1e9:8.3f} GB"
                 f"  {nbytes / max(secs, 1e-12) / 1e9:7.2f} GB/s")
    return line


def _merge_intervals(iv: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of half-open intervals, sorted and non-overlapping."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap_with(a: float, b: float,
                  merged: Sequence[Tuple[float, float]]) -> float:
    """Length of [a, b) covered by a merged interval list."""
    cov = 0.0
    for lo, hi in merged:
        if hi <= a:
            continue
        if lo >= b:
            break
        cov += min(b, hi) - max(a, lo)
    return cov


def _json_default(o):
    """numpy scalars and other non-JSON attrs degrade gracefully."""
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


class ProgressPrinter:
    """Event listener printing one line per stage-2 epoch (``--verbose``),
    from the attrs of the streamed solver's ``epoch`` spans: active rows,
    bytes moved, row visits, the largest KKT violation (full passes only)."""

    def __init__(self, stream=None):
        import sys
        self._out = stream if stream is not None else sys.stderr

    def __call__(self, ev) -> None:
        ph, cat, name, t_abs, dur, tid, attrs = ev
        if ph != _SPAN or cat != "epoch":
            return
        a = attrs
        hit = a.get("hit_bytes", 0)
        miss = a.get("miss_bytes", 0)
        rate = hit / (hit + miss) if hit + miss else 0.0
        rows = a.get("rows", 0)
        viol = a.get("viol")
        viol_s = f"{viol:9.3e}" if viol is not None else "      n/a"
        print(f"epoch {a.get('epoch', '?'):>4} [{a.get('kind', '?'):<5s}] "
              f"active={a.get('active', 0):>8,} "
              f"bytes={a.get('bytes', 0) / 1e6:9.2f}MB "
              f"hit={rate:5.1%} "
              f"rows/s={rows / max(dur, 1e-12):12,.0f} "
              f"viol={viol_s} "
              f"({dur:.3f}s)", file=self._out, flush=True)


# ---- process-wide tracer ------------------------------------------------
_active: Optional[Tracer] = None


def install(tracer: Optional[Tracer]) -> None:
    """Set the process-wide tracer that ``resolve`` returns everywhere."""
    global _active
    _active = tracer


def uninstall() -> None:
    """Clear the process-wide tracer (back to the no-op fast path)."""
    install(None)


def active() -> Optional[Tracer]:
    """The installed process-wide tracer, or None."""
    return _active


def resolve(tracer=None):
    """Tracer for a call site: explicit argument > installed > NULL."""
    if tracer is not None:
        return tracer
    return _active if _active is not None else NULL
