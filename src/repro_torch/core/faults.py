"""Deterministic fault injection and the streaming error taxonomy (port of
``repro.core.faults``; it imports nothing of the JAX package).

A fault fires when a *site* is reached with matching attributes (a chunk or
block index, an epoch), never on a timer, so every recovery path can be
tested without wall-clock randomness.  The streamed pipelines call
``check(site, **attrs)`` at their injection points; with no plan installed
that is one ``None`` test.

Sites of the port (one card):

    "h2d"             a stage-2 block copy, before it is issued; attrs:
                      epoch (-1: a warm start's init pass), block
    "epoch_boundary"  the stage-2 loop after each epoch (after a full pass's
                      snapshot); attrs: epoch
    "stage1"          a stage-1 chunk before its copy; attrs: chunk
    "shard_write"     the shard writer before a shard lands (core/shards.py);
                      attrs: shard
    "shard_read"      the shard reader before a file read; attrs: shard
    "shard_corrupt"   the same point; attrs: shard, path.  The "corrupt" kind
                      flips one byte of the file in place and returns: the
                      checksum must catch it, not the injector

The reference's other sites ("reader", "stall") belong to its multi-device
farm, which is not ported; the plan accepts them all the same.

The taxonomy is also the real one: ``classify_error`` decides between a
bounded retry (transient), device quarantine (persistent) and re-raise
(fatal).  On one card a persistent error has no survivor to move to and is
raised.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional


class FaultError(Exception):
    """Base class of injected (and injectable) streaming faults."""


class TransientH2DError(FaultError):
    """A transfer failure worth retrying (a spurious DMA hiccup)."""


class DeviceLostError(FaultError):
    """A device is gone for good."""


class InjectedIOError(OSError, FaultError):
    """Reader-side IO failure (disk or page-cache error while staging)."""


class SimulatedKill(BaseException):
    """Stands in for SIGKILL mid-run.  A BaseException on purpose: recovery
    code that catches ``Exception`` must not swallow it."""


#: substrings of real runtime errors that are worth one more try
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED",
                      "transient")
#: substrings that mean the device itself is gone
_PERSISTENT_MARKERS = ("DEVICE_LOST", "device lost", "INTERNAL: Failed to",
                       "NCCL", "DATA_LOSS")


def classify_error(exc: BaseException) -> str:
    """Map an exception to the recovery taxonomy: "transient" (bounded
    retry), "persistent" (the device is lost) or "fatal" (re-raise)."""
    if isinstance(exc, TransientH2DError):
        return "transient"
    if isinstance(exc, DeviceLostError):
        return "persistent"
    msg = str(exc)
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return "transient"
    if any(m in msg for m in _PERSISTENT_MARKERS):
        return "persistent"
    return "fatal"


@dataclasses.dataclass
class FaultSpec:
    """One deterministic fault: fires at ``site`` when every key of ``at``
    equals the ``check`` attribute of that name, up to ``times`` times.

    ``kind``: "transient" -> TransientH2DError, "persistent" ->
    DeviceLostError, "io" -> InjectedIOError, "kill" -> SimulatedKill,
    "stall" -> wait on the plan's Event until ``FaultPlan.release``,
    "corrupt" -> flip one byte of the file named by the ``path`` attr in
    place and return."""

    site: str
    kind: str = "transient"
    at: Dict[str, object] = dataclasses.field(default_factory=dict)
    times: int = 1
    fired: int = 0

    def matches(self, site: str, attrs: Dict[str, object]) -> bool:
        if site != self.site or self.fired >= self.times:
            return False
        return all(k in attrs and attrs[k] == v for k, v in self.at.items())


class FaultPlan:
    """A set of ``FaultSpec``s and the shared stall Event; thread-safe."""

    def __init__(self, specs: Optional[List[FaultSpec]] = None):
        self.specs: List[FaultSpec] = list(specs or [])
        self._lock = threading.Lock()
        self._stall = threading.Event()
        self.fired: List[Dict[str, object]] = []   # audit log for tests

    def add(self, site: str, kind: str = "transient", times: int = 1,
            **at) -> "FaultPlan":
        self.specs.append(FaultSpec(site=site, kind=kind, at=dict(at),
                                    times=times))
        return self

    def release(self) -> None:
        """Un-stall every "stall" fault."""
        self._stall.set()

    def check(self, site: str, attrs: Dict[str, object]) -> None:
        hit = None
        with self._lock:
            for spec in self.specs:
                if spec.matches(site, attrs):
                    spec.fired += 1
                    self.fired.append(dict(site=site, kind=spec.kind, **attrs))
                    hit = spec
                    break
        if hit is None:
            return
        if hit.kind == "stall":
            self._stall.wait()
            return
        if hit.kind == "corrupt":
            _flip_byte(str(attrs["path"]))
            return
        where = f"{site} {attrs}"
        if hit.kind == "transient":
            raise TransientH2DError(f"injected transient fault at {where}")
        if hit.kind == "persistent":
            raise DeviceLostError(f"injected device loss at {where}")
        if hit.kind == "io":
            raise InjectedIOError(f"injected IO error at {where}")
        if hit.kind == "kill":
            raise SimulatedKill(f"injected kill at {where}")
        raise ValueError(f"unknown fault kind {hit.kind!r}")


def _flip_byte(path: str, offset: Optional[int] = None) -> None:
    """Deterministic in-place bit rot: XOR one byte of ``path`` (mid-file
    by default)."""
    size = os.path.getsize(path)
    if size == 0:
        return
    pos = size // 2 if offset is None else offset % size
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0x01]))
        f.flush()
        os.fsync(f.fileno())


_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-wide (tests; uninstall in a finally)."""
    global _PLAN
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    if _PLAN is not None:
        _PLAN.release()   # never leave a thread parked on a stall Event
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


def check(site: str, **attrs) -> None:
    """Injection point: one ``None`` test unless a plan is installed."""
    if _PLAN is None:
        return
    _PLAN.check(site, attrs)
