"""Event streaming layer.

The paper streams PBS hook events (``queuejob``, ``runjob``, ``jobobit``)
through a Redis stream: the scheduler is the producer, SchedTwin the
consumer.  This module provides an in-process event bus with the same
stream semantics (append-only log, independent consumer offsets, replay)
so the twin's consumption logic is identical whether the producer is our
cluster emulator or a real scheduler hook.

Events are plain host-side records — they cross the host/accelerator
boundary only when the twin synchronizes its tensor mirror state.

Resilience layer (DESIGN.md §12): real producers misbehave, so this
module also carries the stream-sanitization primitives the hardened
twin pump is built from — ``validate_event`` (malformed-event triage
for the dead-letter queue), ``SeqTracker`` (duplicate / out-of-order /
gap classification against the per-consumer ``seq`` stamps, with a
bounded reorder window so permanently dropped events are eventually
declared lost instead of pending forever), ``read_with_retry``
(bounded exponential backoff over transient ``BusReadError``), and
subscriber isolation in ``publish`` (a raising callback is counted in
``EventBus.health()`` instead of propagating into the producer).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import math
import threading
import time
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Set)


class EventKind(enum.IntEnum):
    """PBS-hook-equivalent event kinds (§3.1 of the paper)."""

    QUEUEJOB = 0   # job submitted  (paper: hollow triangle)
    RUNJOB = 1     # job started    (paper: half triangle)
    JOBOBIT = 2    # job completed  (paper: filled triangle)
    NODEFAIL = 3   # node(s) failed           (beyond paper: fault tolerance)
    NODEUP = 4     # node(s) recovered/added  (beyond paper: elasticity)


@dataclasses.dataclass(frozen=True)
class Event:
    """A single scheduler event.

    ``time`` is physical-system time in seconds.  ``job_id`` is the dense
    job-slot index assigned at submission (also the twin's array slot).
    ``payload`` carries kind-specific metadata (job size, walltimes, node
    counts for NODEFAIL/NODEUP, ...).
    """

    kind: EventKind
    time: float
    job_id: int = -1
    payload: Dict[str, float] = dataclasses.field(default_factory=dict)
    seq: int = -1  # assigned by the bus on publish

    # -- snapshot serialization (checkpoint extra is JSON) -------------
    def to_dict(self) -> Dict:
        return {"kind": int(self.kind), "time": float(self.time),
                "job_id": int(self.job_id),
                "payload": {str(k): float(v)
                            for k, v in self.payload.items()},
                "seq": int(self.seq)}

    @classmethod
    def from_dict(cls, d: Dict) -> "Event":
        kind = int(d["kind"])
        try:
            kind = EventKind(kind)
        except ValueError:
            pass  # quarantined (corrupted) events carry unknown kinds
        return cls(kind=kind, time=float(d["time"]),
                   job_id=int(d.get("job_id", -1)),
                   payload=dict(d.get("payload", {})),
                   seq=int(d.get("seq", -1)))


# ----------------------------------------------------------------------
# Malformed-event triage (the dead-letter queue's gatekeeper).
# ----------------------------------------------------------------------

_JOB_KINDS = (EventKind.QUEUEJOB, EventKind.RUNJOB, EventKind.JOBOBIT)
_NODE_KINDS = (EventKind.NODEFAIL, EventKind.NODEUP)


def validate_event(ev, max_jobs: Optional[int] = None) -> Optional[str]:
    """Triage one event BEFORE it reaches ``sync.apply_event``: returns
    ``None`` for a well-formed event, else a short reason string the
    dead-letter queue records.  Checks are the corruption modes a real
    hook stream exhibits (and ``cluster.chaos`` injects): unknown kind,
    non-finite/negative time, job events without a valid ``job_id``
    (out of the mirror's slot range when ``max_jobs`` is given), and
    kind-specific payload fields that are missing, non-numeric,
    non-finite, or out of range."""
    try:
        kind = EventKind(ev.kind)
    except (ValueError, TypeError):
        return f"unknown kind {ev.kind!r}"
    t = ev.time
    if not isinstance(t, (int, float)) or not math.isfinite(t) or t < 0.0:
        return f"bad time {t!r}"
    if kind in _JOB_KINDS:
        jid = ev.job_id
        if not isinstance(jid, int) or jid < 0:
            return f"bad job_id {jid!r}"
        if max_jobs is not None and jid >= max_jobs:
            return f"job_id {jid} out of range (max_jobs={max_jobs})"
    required = {EventKind.QUEUEJOB: ("nodes", "est_runtime"),
                EventKind.NODEFAIL: ("nodes",),
                EventKind.NODEUP: ("nodes",)}.get(kind, ())
    for field in required:
        v = ev.payload.get(field)
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            return f"bad payload {field}={v!r}"
        if v < 0.0 or (kind == EventKind.QUEUEJOB and field == "nodes"
                       and v < 1.0):
            return f"bad payload {field}={v!r}"
    return None


class DeadLetter(NamedTuple):
    """One quarantined event + why it was rejected."""
    event: Event
    reason: str


# ----------------------------------------------------------------------
# Sequence tracking: duplicate / reorder / gap classification.
# ----------------------------------------------------------------------

class SeqObservation(NamedTuple):
    """What ``SeqTracker.observe`` concluded about one delivery.
    ``status`` ∈ {'new', 'duplicate', 'reordered'}; ``new_gaps`` counts
    seqs newly detected as missing (holes opened by a jump past the
    high-water mark); ``newly_lost`` counts holes abandoned this
    observation because they aged past the reorder window (the stream
    will never heal them — resync territory)."""
    status: str
    new_gaps: int
    newly_lost: int


class SeqTracker:
    """Classify per-consumer ``seq`` stamps under duplication, reordering
    and loss, in O(pending holes) memory.

    Invariant: every seq < ``max_seen`` is either APPLIED (seen),
    PENDING (in ``holes`` — expected to arrive late within
    ``reorder_window`` of the high-water mark), or LOST (was a hole,
    aged out).  A delivery is a *duplicate* iff its seq was already
    applied or declared lost, *reordered* iff it fills a pending hole,
    *new* otherwise.  The bounded window is what keeps a permanently
    dropped seq from pinning memory and from deferring the
    loss-triggered resync forever."""

    def __init__(self, reorder_window: int = 64):
        if reorder_window < 1:
            raise ValueError("reorder_window must be >= 1")
        self.window = int(reorder_window)
        self.max_seen = -1
        self.holes: Set[int] = set()
        self.lost: Set[int] = set()

    def observe(self, seq: int) -> SeqObservation:
        if seq <= self.max_seen:
            if seq in self.holes:
                self.holes.discard(seq)
                return SeqObservation("reordered", 0, self._age_out())
            return SeqObservation("duplicate", 0, self._age_out())
        gaps = range(self.max_seen + 1, seq)
        self.holes.update(gaps)
        self.max_seen = seq
        return SeqObservation("new", len(gaps), self._age_out())

    def flush(self) -> int:
        """Declare every pending hole lost (end-of-stream: nothing can
        fill them anymore).  Returns how many were newly declared."""
        n = len(self.holes)
        self.lost |= self.holes
        self.holes = set()
        return n

    def _age_out(self) -> int:
        horizon = self.max_seen - self.window
        aged = {h for h in self.holes if h < horizon}
        self.holes -= aged
        self.lost |= aged
        return len(aged)

    # -- snapshot serialization ----------------------------------------
    def to_dict(self) -> Dict:
        return {"window": self.window, "max_seen": self.max_seen,
                "holes": sorted(self.holes), "lost": sorted(self.lost)}

    @classmethod
    def from_dict(cls, d: Dict) -> "SeqTracker":
        t = cls(reorder_window=int(d["window"]))
        t.max_seen = int(d["max_seen"])
        t.holes = {int(h) for h in d.get("holes", [])}
        t.lost = {int(h) for h in d.get("lost", [])}
        return t


# ----------------------------------------------------------------------
# Bounded retry over transient read failures.
# ----------------------------------------------------------------------

class BusReadError(RuntimeError):
    """A transient bus read failure (network blip, Redis timeout — or
    ``cluster.chaos`` injecting one).  Retryable."""


def read_with_retry(bus, consumer: str,
                    max_events: Optional[int] = None, *,
                    retries: int = 3, backoff_s: float = 0.01,
                    sleep: Callable[[float], None] = time.sleep,
                    on_retry: Optional[Callable[[int, Exception], None]]
                    = None) -> List[Event]:
    """``bus.read`` with bounded exponential backoff over
    ``BusReadError``: up to ``retries`` re-reads, sleeping
    ``backoff_s · 2^attempt`` between them (injectable ``sleep`` keeps
    tests and the chaos benchmark instant).  ``on_retry(attempt, exc)``
    fires per retry so the twin can count them.  Exhausting every
    retry re-raises the last error — the caller decides whether that
    aborts the pump or just skips a beat."""
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            return bus.read(consumer, max_events)
        except BusReadError as exc:
            last = exc
            if attempt == retries:
                break
            if on_retry is not None:
                on_retry(attempt, exc)
            sleep(backoff_s * (2.0 ** attempt))
    raise last  # type: ignore[misc]


class EventBus:
    """Append-only event log with per-consumer offsets (Redis-stream-like).

    The bus is deliberately synchronous and deterministic: tests and the
    co-simulation loop rely on replayable ordering.  A Redis-backed
    implementation would only need to reimplement ``publish`` / ``read``.
    """

    def __init__(self) -> None:
        self._log: List[Event] = []
        self._offsets: Dict[str, int] = {}
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._subscribers: List[Callable[[Event], None]] = []
        self._callback_failures = 0
        self._last_callback_error = ""

    # -- producer side -------------------------------------------------
    def publish(self, event: Event) -> Event:
        with self._lock:
            stamped = dataclasses.replace(event, seq=next(self._seq))
            self._log.append(stamped)
        for cb in self._subscribers:
            # Subscriber isolation: a consumer's bug must never crash
            # the PRODUCER (the physical scheduler hook).  Failures are
            # counted and surfaced via health(); the event stays in the
            # log, so a pull-mode reader can still recover it.
            try:
                cb(stamped)
            except Exception as exc:  # noqa: BLE001 — isolation boundary
                with self._lock:
                    self._callback_failures += 1
                    self._last_callback_error = (
                        f"{type(exc).__name__}: {exc}")
        return stamped

    def health(self) -> Dict:
        """Producer-visible bus vitals: log length, consumer offsets,
        and the subscriber-isolation counters."""
        with self._lock:
            return {"events": len(self._log),
                    "consumers": dict(self._offsets),
                    "subscribers": len(self._subscribers),
                    "callback_failures": self._callback_failures,
                    "last_callback_error": self._last_callback_error}

    # -- consumer side -------------------------------------------------
    def read(self, consumer: str, max_events: Optional[int] = None) -> List[Event]:
        """Read new events for ``consumer`` and advance its offset."""
        with self._lock:
            start = self._offsets.get(consumer, 0)
            end = len(self._log) if max_events is None else min(
                len(self._log), start + max_events)
            out = self._log[start:end]
            self._offsets[consumer] = end
        return out

    def subscribe(self, callback: Callable[[Event], None]) -> None:
        """Push-mode delivery (used by the co-simulation loop)."""
        self._subscribers.append(callback)

    @property
    def has_listeners(self) -> bool:
        """Anyone push-subscribed or pull-reading this bus — producers
        that cannot stream (the emulator's ``fast=True`` replay) must
        refuse rather than silently starve them."""
        return bool(self._subscribers) or bool(self._offsets)

    def replay(self) -> Iterator[Event]:
        """Full-log replay (recovery after a twin restart)."""
        return iter(list(self._log))

    def __len__(self) -> int:
        return len(self._log)

    # -- recovery ------------------------------------------------------
    def snapshot_offsets(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._offsets)

    def restore_offsets(self, offsets: Dict[str, int]) -> None:
        with self._lock:
            self._offsets.update(offsets)

    def dump(self) -> List[Dict]:
        """Whole log as JSON-safe dicts (cross-process resume)."""
        with self._lock:
            return [ev.to_dict() for ev in self._log]

    @classmethod
    def from_dump(cls, events: List[Dict]) -> "EventBus":
        """Rebuild a bus whose log (and next seq) match ``dump``."""
        bus = cls()
        bus._log = [Event.from_dict(d) for d in events]
        bus._seq = itertools.count(len(bus._log))
        return bus
