"""Chaos layer: deterministic fault injection for the twin's event feed —
port of ``repro/cluster/chaos.py`` (pure Python: the same delivered
stream for every seed and spec).

``ChaosBus`` wraps a real ``events.EventBus`` and corrupts ONLY the
consumer-facing ``read()`` view — the producer's append-only log (and
therefore the emulator's ground truth and ``recover()``'s full-log
replay) stays intact, exactly like a flaky transport between a durable
stream and a subscriber.  Injected faults:

  - **drops**       — an event never reaches the consumer,
  - **duplicates**  — an event is delivered twice,
  - **reordering**  — an event is held back and delivered late, behind
                      newer sequence numbers,
  - **corruption**  — the delivered copy is mangled (bad time / job id /
                      kind / payload) so ``validate_event`` must
                      quarantine it,
  - **read failures** — ``read()`` raises a transient ``BusReadError``.

Every decision is a PURE function of ``(spec.seed, event.seq)`` (read
failures: of the read-call count), via a splitmix64-style hash — no
sequential RNG state.  That is what makes the chaos benchmark's
mid-run kill + ``SchedTwin.restore()`` gate meaningful: the resumed
twin observes the *identical* corrupted stream, so any decision
divergence is the twin's fault, not the harness's.

``failure_storm`` builds the emulator-side half of the default chaos
profile: a burst of correlated ``FailureSpec`` waves (rack/power-domain
style), stressing NODEFAIL/NODEUP ingestion and capacity collapse at
the same time the bus is misbehaving.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.cluster.emulator import FailureSpec
from repro_torch.core.events import BusReadError, Event, EventBus

_M64 = (1 << 64) - 1

# Per-fault hash tags so one event's drop/duplicate/... draws are
# independent of each other.
_TAG_DROP = 0xD209
_TAG_DUP = 0xD4B1
_TAG_REORDER = 0x2E02
_TAG_DELAY = 0xDE1A
_TAG_CORRUPT = 0xC022
_TAG_MODE = 0x30DE
_TAG_READ = 0x2EAD


def _unit(seed: int, *keys: int) -> float:
    """Deterministic uniform in [0, 1) from integer keys (splitmix64)."""
    x = (seed * 0x9E3779B97F4A7C15) & _M64
    for k in keys:
        x ^= (k + 0x9E3779B97F4A7C15 + ((x << 6) & _M64) + (x >> 2)) & _M64
        x = (x * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return x / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Fault-injection profile.  All probabilities are per-event (read
    failures: per read call); ``reorder_delay`` is how many later
    sequence numbers must be delivered before a held-back event is
    released (1 = swap with its successor)."""

    drop_prob: float = 0.0
    duplicate_prob: float = 0.0
    reorder_prob: float = 0.0
    reorder_delay: int = 3
    corrupt_prob: float = 0.0
    read_failure_prob: float = 0.0
    seed: int = 0

    def __post_init__(self):
        for f in ("drop_prob", "duplicate_prob", "reorder_prob",
                  "corrupt_prob", "read_failure_prob"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.reorder_delay < 1:
            raise ValueError("reorder_delay must be >= 1")


# The profile benchmarks/chaos.py gates CI on: every fault class active
# at rates aggressive enough to exercise every hardened path on a
# paper-scale trace, mild enough that resyncs keep the mirror usable.
DEFAULT_PROFILE = ChaosSpec(drop_prob=0.05, duplicate_prob=0.05,
                            reorder_prob=0.10, reorder_delay=3,
                            corrupt_prob=0.03, read_failure_prob=0.05,
                            seed=0)


def failure_storm(start: float, waves: int = 3, nodes: int = 4,
                  spacing_s: float = 200.0,
                  duration_s: float = 400.0) -> List[FailureSpec]:
    """A correlated node-failure storm: ``waves`` back-to-back outages
    of ``nodes`` nodes each, ``spacing_s`` apart, each healing after
    ``duration_s`` — the emulator-side companion to bus-level chaos."""
    return [FailureSpec(time=start + w * spacing_s, nodes=nodes,
                        duration=duration_s) for w in range(waves)]


class ChaosBus:
    """``EventBus`` facade that injects ``spec``'s faults into ``read``.

    Everything else (``publish``, ``replay``, offsets, ``health`` …)
    delegates to the wrapped bus untouched.  ``stats`` counts what was
    actually injected so tests and the chaos benchmark can assert the
    run exercised every fault class rather than silently passing on a
    calm draw.
    """

    def __init__(self, inner: EventBus, spec: ChaosSpec):
        self.inner = inner
        self.spec = spec
        self._held: List[Event] = []     # reordered, awaiting release
        self._read_calls = 0
        self._released_until = -1        # highest seq delivered in order
        self.stats: Dict[str, int] = {
            "drops": 0, "duplicates": 0, "reorders": 0,
            "corruptions": 0, "read_failures": 0,
        }

    # -- the one corrupted surface -------------------------------------
    def read(self, consumer: str,
             max_events: Optional[int] = None) -> List[Event]:
        spec = self.spec
        self._read_calls += 1
        if _unit(spec.seed, _TAG_READ, self._read_calls) \
                < spec.read_failure_prob:
            # Raised BEFORE consuming: the inner offset is untouched, so
            # a retry (``read_with_retry``) re-reads the same window.
            self.stats["read_failures"] += 1
            raise BusReadError(
                f"chaos: transient read failure (call {self._read_calls})")

        fresh = self.inner.read(consumer, max_events)
        out: List[Event] = []
        for ev in fresh:
            s = int(ev.seq)
            self._released_until = max(self._released_until, s)
            if _unit(spec.seed, _TAG_DROP, s) < spec.drop_prob:
                self.stats["drops"] += 1
                continue
            if _unit(spec.seed, _TAG_REORDER, s) < spec.reorder_prob:
                self.stats["reorders"] += 1
                self._held.append(ev)
                continue
            out.extend(self._deliver(ev))
        # Release held-back events whose delay has elapsed — AFTER the
        # fresh batch, i.e. behind newer seqs: a genuine reordering.
        still: List[Event] = []
        for ev in self._held:
            if int(ev.seq) + spec.reorder_delay <= self._released_until:
                out.extend(self._deliver(ev))
            else:
                still.append(ev)
        self._held = still
        return out

    def _deliver(self, ev: Event) -> List[Event]:
        """Apply corruption/duplication to one surviving event."""
        spec = self.spec
        s = int(ev.seq)
        if _unit(spec.seed, _TAG_CORRUPT, s) < spec.corrupt_prob:
            self.stats["corruptions"] += 1
            ev = self._corrupt(ev)
        if _unit(spec.seed, _TAG_DUP, s) < spec.duplicate_prob:
            self.stats["duplicates"] += 1
            return [ev, ev]
        return [ev]

    def _corrupt(self, ev: Event) -> Event:
        """Mangle the delivered copy so ``validate_event`` rejects it.
        The good copy is gone (realistic transport corruption) — the
        twin must heal through quarantine + gap-triggered resync."""
        mode = int(_unit(self.spec.seed, _TAG_MODE, int(ev.seq)) * 4)
        if mode == 0:
            return dataclasses.replace(ev, time=float("nan"))
        if mode == 1:
            return dataclasses.replace(ev, job_id=10 ** 9)
        if mode == 2:
            return dataclasses.replace(ev, kind=99)  # unknown kind
        return dataclasses.replace(
            ev, payload={k: float("inf") for k in ev.payload} or
            {"nodes": -1.0})

    # -- everything else is the real bus -------------------------------
    def __getattr__(self, name: str):
        return getattr(self.inner, name)

    def __len__(self) -> int:
        return len(self.inner)
