"""Twin telemetry: per-cycle latency, decisions, policy mix (Table 1)."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class CycleRecord:
    time: float                # virtual (cluster) time of the cycle
    wall_seconds: float        # host wall time of the decision
    policy: str                # winning policy name
    costs: Dict[str, float]    # per-policy objective cost
    n_started: int             # jobs qrun this cycle
    started_jobs: List[int]
    # the goal this cycle minimized (objective grammar spec) and its
    # per-term cost breakdown for ALL k forks (policy -> term -> cost),
    # as computed on device by Objective.cost_terms — reports consume
    # these instead of recomputing costs from raw metrics on the host.
    objective: str = "score"
    term_costs: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    # fan/ensemble uncertainty, stamped on DEVICE by decide_fan /
    # decide_ensemble (DESIGN.md §10) — never recomputed on the host.
    # cost_ci: per-policy 95% CI half-width of the member-cost mean;
    # fan_width: per-policy member-cost spread (worst − best member);
    # fan_size: member count F (1 = single-future decision, no fan).
    cost_ci: Dict[str, float] = dataclasses.field(default_factory=dict)
    fan_width: Dict[str, float] = dataclasses.field(default_factory=dict)
    fan_size: int = 1
    # racing accounting (DESIGN.md §11), stamped by SchedTwin(race=...):
    # rungs the race executed, (s, φ, p) member triples actually
    # replayed (vs fan_size·k for a fixed fan), the achieved winner
    # separation (rival CI lower bound − winner upper bound; > 0 means
    # the decision was statistically settled), and why the race ended
    # ('separated' | 'budget_ms' | 'max_members' | 'exhausted'; ""
    # for non-raced cycles).
    race_rungs: int = 0
    race_members: int = 0
    race_separation: float = 0.0
    race_stopped: str = ""
    # deadline guard accounting (DESIGN.md §12), stamped by
    # SchedTwin(guard=...): the degradation-ladder level this cycle ran
    # at (0 = full decision, 1 = shrunk race/fan, 2 = static fallback
    # pool, 3 = hold incumbent), the wall-clock budget it ran under
    # (0 = unguarded), the remaining margin (budget − wall_seconds;
    # negative on a miss), and whether the cycle overran its budget.
    guard_level: int = 0
    deadline_s: float = 0.0
    margin_s: float = 0.0
    deadline_miss: bool = False


@dataclasses.dataclass
class IngestStats:
    """Hardened-ingestion counters (DESIGN.md §12), bumped by the twin's
    pump path as it sanitizes the stream: events quarantined to the
    dead-letter queue, duplicate/out-of-order ``seq`` deliveries
    absorbed idempotently, sequence gaps detected (and those abandoned
    as lost after the reorder window), probe resyncs triggered, and
    bus-read retry/backoff activity."""

    quarantined: int = 0     # malformed events sent to the DLQ
    duplicates: int = 0      # already-applied seq, dropped idempotently
    reordered: int = 0       # events that arrived behind a newer seq
    gaps: int = 0            # seq gaps first observed (pending holes)
    lost: int = 0            # holes abandoned after the reorder window
    resyncs: int = 0         # authoritative probe reconciliations
    read_retries: int = 0    # bus reads retried after transient failure
    read_failures: int = 0   # reads that exhausted every retry

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Telemetry:
    cycles: List[CycleRecord] = dataclasses.field(default_factory=list)
    # job_id -> policy that started it (paper Table 1 attributes each
    # *job start* to the policy selected in that cycle)
    job_start_policy: Dict[int, str] = dataclasses.field(default_factory=dict)
    # §3.2 estimate-vs-true runtime residuals: one (estimated, actual)
    # walltime pair per observed JOBOBIT, recorded by the twin as
    # ground truth reveals itself.  ``fan.FanSpec.from_history`` fits
    # its lognormal runtime-noise σ to these (ROADMAP residual (b)).
    runtime_residuals: List[tuple] = dataclasses.field(default_factory=list)
    # hardened-ingestion counters, owned here so one resilience report
    # covers both the guard (per-cycle records) and the pump (stream
    # sanitization) — the twin bumps these in place.
    ingest: IngestStats = dataclasses.field(default_factory=IngestStats)

    def record(self, rec: CycleRecord) -> None:
        self.cycles.append(rec)
        for j in rec.started_jobs:
            self.job_start_policy[j] = rec.policy

    def record_residual(self, est: float, actual: float) -> None:
        """One revealed (estimated, actual) runtime pair."""
        self.runtime_residuals.append((float(est), float(actual)))

    # ---- Table 1 ------------------------------------------------------
    def policy_start_distribution(self) -> Dict[str, float]:
        """Percentage of job starts attributed to each policy."""
        total = max(len(self.job_start_policy), 1)
        counts: Dict[str, int] = {}
        for p in self.job_start_policy.values():
            counts[p] = counts.get(p, 0) + 1
        return {p: 100.0 * c / total for p, c in sorted(counts.items())}

    # ---- objective breakdown (DESIGN.md §8) ---------------------------
    def objective_breakdown(self) -> Dict[str, Dict[str, float]]:
        """Mean per-term objective cost per policy across all recorded
        cycles (policy -> term -> mean cost) — the device-computed
        decomposition of what each candidate would have cost under the
        administrator's goal, ready for radar/summary reports with no
        host-side recomputation."""
        sums: Dict[str, Dict[str, float]] = {}
        counts: Dict[str, int] = {}
        for c in self.cycles:
            for pol, terms in c.term_costs.items():
                acc = sums.setdefault(pol, {})
                counts[pol] = counts.get(pol, 0) + 1
                for term, v in terms.items():
                    acc[term] = acc.get(term, 0.0) + v
        return {pol: {term: s / counts[pol] for term, s in acc.items()}
                for pol, acc in sums.items()}

    # ---- fan uncertainty (DESIGN.md §10/§11) --------------------------
    def confidence_stats(self) -> Dict[str, Dict[str, float]]:
        """Mean device-computed uncertainty per policy across all fan
        cycles (policy -> {mean_ci, mean_width, mean_sigma, mean_fan,
        min_fan, max_fan, n}); cycles whose CI is infinite (a fan
        member deadlocked) are counted separately as ``n_inf`` rather
        than polluting the means.  Empty when no cycle ran a
        fan/ensemble.

        Racing makes the per-cycle fan size F variable (a policy
        eliminated at rung r carries the CI of F_r members, a survivor
        that of F_max), so a raw mean of CI half-widths conflates noise
        with sample size.  ``mean_sigma`` de-scales each cycle's CI back
        to the member-cost standard deviation (ci·√F/1.96), an
        F-independent noise estimate comparable across cycles of any
        fan size; ``min_fan``/``max_fan``/``mean_fan`` report the fan
        sizes actually used."""
        acc: Dict[str, Dict[str, float]] = {}
        for c in self.cycles:
            if c.fan_size <= 1 or not c.cost_ci:
                continue
            for pol, ci in c.cost_ci.items():
                st = acc.setdefault(
                    pol, {"mean_ci": 0.0, "mean_width": 0.0,
                          "mean_sigma": 0.0, "mean_fan": 0.0,
                          "min_fan": float(c.fan_size),
                          "max_fan": float(c.fan_size),
                          "n": 0, "n_inf": 0})
                width = c.fan_width.get(pol, float("inf"))
                if ci == float("inf") or width == float("inf"):
                    st["n_inf"] += 1
                    continue
                st["mean_ci"] += ci
                st["mean_width"] += width
                st["mean_sigma"] += ci * (c.fan_size ** 0.5) / 1.96
                st["mean_fan"] += c.fan_size
                st["min_fan"] = min(st["min_fan"], float(c.fan_size))
                st["max_fan"] = max(st["max_fan"], float(c.fan_size))
                st["n"] += 1
        for st in acc.values():
            n = max(int(st["n"]), 1)
            st["mean_ci"] /= n
            st["mean_width"] /= n
            st["mean_sigma"] /= n
            st["mean_fan"] /= n
        return acc

    # ---- resilience (DESIGN.md §12) -----------------------------------
    def resilience_stats(self) -> Dict[str, float]:
        """One flat report of how hard the runtime had to fight: deadline
        misses and ladder engagements from the per-cycle guard stamps,
        plus the ingestion counters.  ``ladder_engaged`` counts cycles
        decided at level > 0 (the guard degraded the decision to make
        the deadline); ``miss_rate`` is misses over guarded cycles
        (cycles with a budget), 0.0 when nothing was guarded."""
        guarded = [c for c in self.cycles if c.deadline_s > 0.0]
        misses = sum(1 for c in guarded if c.deadline_miss)
        engaged = sum(1 for c in self.cycles if c.guard_level > 0)
        out: Dict[str, float] = {
            "cycles": len(self.cycles),
            "guarded_cycles": len(guarded),
            "deadline_misses": misses,
            "miss_rate": misses / len(guarded) if guarded else 0.0,
            "ladder_engaged": engaged,
            "max_level": max((c.guard_level for c in self.cycles),
                             default=0),
            "min_margin_s": min((c.margin_s for c in guarded),
                                default=0.0),
        }
        for lvl in range(1, 4):
            out[f"level{lvl}_cycles"] = sum(
                1 for c in self.cycles if c.guard_level == lvl)
        out.update(self.ingest.as_dict())
        return out

    # ---- overhead (paper: "a few seconds per scheduling cycle") -------
    def cycle_latency_stats(self) -> Dict[str, float]:
        if not self.cycles:
            return {"mean_s": 0.0, "max_s": 0.0, "p50_s": 0.0, "n": 0}
        ws = sorted(c.wall_seconds for c in self.cycles)
        n = len(ws)
        return {
            "mean_s": sum(ws) / n,
            "max_s": ws[-1],
            "p50_s": ws[n // 2],
            "n": n,
        }


class StopWatch:
    """Wall-clock context manager.  ``clock`` is injectable so the
    deadline guard's ladder decisions are reproducible under a fake
    clock in tests (the same seam ``race.run_race`` exposes)."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock

    def __enter__(self) -> "StopWatch":
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.seconds = self._clock() - self._t0
        return None
