"""Deadline guard + degradation ladder (DESIGN.md §12).

The paper's real-time contract is that the twin keeps "a few seconds
per scheduling cycle" of overhead against a live stream — but a racing
fan cycle's latency is workload-dependent, and a decision that arrives
after the physical scheduler needed it is worth nothing.  The guard
puts every decision cycle under a configurable wall-clock budget and
walks a **degradation ladder** when the budget comes under pressure,
so ``qrun`` is ALWAYS fed a decision on time — a cheaper decision
beats a late one:

  level 0  full decision (race / fan / ensemble, as configured)
  level 1  shrunk race: ``budget_ms`` and fan F cut to fit the margin
  level 2  static fallback pool (the paper's §4.1 {WFP, FCFS, SJF}),
           single-future decide — the paper's own baseline twin
  level 3  hold the incumbent: re-issue the last chosen policy with
           one k=1 schedule pass (no pool comparison at all)

The controller is *predictive + reactive*: it keeps a per-level EWMA
of observed cycle latencies and refuses to run a level whose estimate
exceeds ``safety × budget`` (predictive — the cycle that WOULD have
missed is degraded before it runs), and any actual overrun escalates
immediately (reactive).  De-escalation is hysteretic: only after
``recover_after`` consecutive comfortable cycles does the guard step
back down one level, so a borderline workload doesn't oscillate.

Determinism: the guard's decisions are a pure function of the observed
latency sequence, and the clock is injectable (the same seam
``race.run_race`` exposes), so tests drive the whole ladder with a
fake clock and the chaos benchmark's kill+resume gate can reproduce
ladder decisions bitwise — the guard state is snapshot-serializable
via ``to_dict``/``from_dict``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["GuardSpec", "DeadlineGuard", "LEVEL_NAMES"]

LEVEL_NAMES = ("full", "shrunk_race", "static_pool", "hold_incumbent")


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """Deadline-guard configuration.

    ``budget_s <= 0`` disables the guard entirely (every cycle runs at
    level 0, nothing is stamped as guarded).  ``safety`` is the
    fraction of the budget a level's latency estimate must fit inside
    to be allowed to run (and to count as a comfortable cycle for
    recovery).  ``shrink`` is the factor applied to the race
    ``budget_ms`` / fan F at level 1."""

    budget_s: float = 0.0       # wall-clock budget per decision cycle
    safety: float = 0.8         # planning headroom fraction
    ewma_alpha: float = 0.4     # latency-estimate smoothing
    recover_after: int = 3      # comfy cycles before stepping down
    max_level: int = 3          # deepest ladder level the guard may use
    shrink: float = 0.25        # level-1 race-budget / fan-F factor

    def __post_init__(self) -> None:
        if not 0.0 < self.safety <= 1.0:
            raise ValueError("safety must be in (0, 1]")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.recover_after < 1:
            raise ValueError("recover_after must be >= 1")
        if not 0 <= self.max_level <= 3:
            raise ValueError("max_level must be in [0, 3]")
        if not 0.0 < self.shrink <= 1.0:
            raise ValueError("shrink must be in (0, 1]")

    @property
    def enabled(self) -> bool:
        return self.budget_s > 0.0


class DeadlineGuard:
    """The ladder controller.  One instance per twin; host-side only."""

    def __init__(self, spec: GuardSpec):
        self.spec = spec
        self.level = 0                       # current operating level
        self._est: Dict[int, float] = {}     # per-level latency EWMA
        self._comfy = 0                      # consecutive easy cycles
        self.misses = 0
        self.engagements = 0                 # cycles planned at level>0

    # -- planning (before the cycle runs) ------------------------------
    def plan(self) -> int:
        """Level this cycle must run at.  Escalates past any level whose
        latency estimate exceeds the safety margin; never skips levels
        it has no estimate for (optimism: an untried level gets one
        chance to prove itself before the reactive path escalates)."""
        if not self.spec.enabled:
            return 0
        lvl = self.level
        headroom = self.spec.safety * self.spec.budget_s
        while (lvl < self.spec.max_level
               and self._est.get(lvl, 0.0) > headroom):
            lvl += 1
        self.level = lvl
        if lvl > 0:
            self.engagements += 1
        return lvl

    # -- observation (after the cycle ran) ------------------------------
    def observe(self, level: int,
                seconds: float) -> Tuple[bool, float]:
        """Record one cycle's wall time at ``level``.  Returns
        ``(missed, margin_s)``; escalates on a miss, steps down one
        level after ``recover_after`` consecutive comfortable cycles."""
        if not self.spec.enabled:
            return False, 0.0
        a = self.spec.ewma_alpha
        prev = self._est.get(level)
        self._est[level] = (seconds if prev is None
                            else (1.0 - a) * prev + a * seconds)
        margin = self.spec.budget_s - seconds
        missed = margin < 0.0
        if missed:
            self.misses += 1
            self.level = min(level + 1, self.spec.max_level)
            self._comfy = 0
        elif seconds <= self.spec.safety * self.spec.budget_s:
            self._comfy += 1
            if self.level > 0 and self._comfy >= self.spec.recover_after:
                self.level -= 1
                self._comfy = 0
        else:
            self._comfy = 0      # made it, but without headroom
        return missed, margin

    # -- snapshot serialization (JSON-safe) -----------------------------
    def to_dict(self) -> Dict:
        return {"level": self.level,
                "est": {str(k): v for k, v in self._est.items()},
                "comfy": self._comfy, "misses": self.misses,
                "engagements": self.engagements}

    def restore(self, d: Optional[Dict]) -> "DeadlineGuard":
        if d:
            self.level = int(d["level"])
            self._est = {int(k): float(v)
                         for k, v in d.get("est", {}).items()}
            self._comfy = int(d.get("comfy", 0))
            self.misses = int(d.get("misses", 0))
            self.engagements = int(d.get("engagements", 0))
        return self
