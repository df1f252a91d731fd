"""SchedTwin orchestrator — port of ``repro/core/twin.py``.

The paper's workflow (Figure 2): ① physical event → ② event bus → ③ the
twin consumes → ④ synchronization (``sync``) → ⑤ parallel what-if DES
(``engine``) → ⑥ policy selection → ⑥A next job-run events → ⑦ ``qrun``.

Where the tensors live: the mirror (``self.state``) stays on the host.
Ingestion reads scalars from it on every event (the job's lifecycle
state, ``now``, a start time), and on the host those reads are free; on
the card each would be a device-to-host copy.  A decision cycle copies
the mirror to the engine's device once, drains there, and reads the
decision back once.

Hardened ingestion (dead letters, sequence tracking, retries, probe
resyncs) and the deadline-guard ladder are as in the reference.  Not
ported yet: ensemble, fan and race decisions (ROADMAP A6/A7) and
crash-safe ``snapshot``/``restore`` (A9).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sync, telemetry
from repro_torch.core.engine import DrainEngine
from repro_torch.core.events import (BusReadError, DeadLetter, Event, EventBus,
                                     EventKind, SeqTracker, read_with_retry,
                                     validate_event)
from repro_torch.core.guard import DeadlineGuard, GuardSpec
from repro_torch.core.objective import ObjectiveLike, resolve_goal
from repro_torch.core.policies import (PAPER_POOL, PolicyPool, PolicySpec,
                                       PoolLike, normalize_pool)
from repro_torch.core.scoring import ScoreWeights
from repro_torch.core.state import QUEUED, SimState, empty_state
from repro_torch.device import DeviceLike

_NOT_PORTED = "is not yet ported to repro_torch"


def _fork_pool(pool: PolicyPool, p: int) -> PolicyPool:
    """Pool member p as a k=1 pool (one schedule pass, no comparison)."""
    return PolicyPool(
        spec=PolicySpec(pool.spec.family[p:p + 1],
                        pool.spec.theta[p:p + 1]),
        names=(pool.names[p],))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class SchedTwin:
    """Real-time digital twin for adaptive scheduling.

    Parameters are the reference's (see ``repro.core.twin.SchedTwin``),
    plus ``device``: where the what-if engine runs when no ``engine`` is
    given (default ``cuda``).  ``ensemble > 1``, ``fan`` and ``race``
    raise ``NotImplementedError``; the ensemble's ``ensemble_noise`` and
    ``seed`` are left out until then.
    """

    CONSUMER = "schedtwin"

    def __init__(self,
                 bus: EventBus,
                 qrun: Callable[[List[int], float], None],
                 total_nodes: int,
                 max_jobs: int = 256,
                 pool: PoolLike = PAPER_POOL,
                 objective: ObjectiveLike = None,
                 weights: Optional[ScoreWeights] = None,
                 free_nodes_probe: Optional[Callable[[], int]] = None,
                 ensemble: int = 1,
                 fan=None,
                 race=None,
                 engine: Optional[DrainEngine] = None,
                 guard=None,
                 jobs_probe: Optional[Callable[[], dict]] = None,
                 fallback_pool: PoolLike = PAPER_POOL,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep,
                 reorder_window: int = 64,
                 read_retries: int = 3,
                 read_backoff_s: float = 0.01,
                 device: DeviceLike = "cuda") -> None:
        if ensemble > 1:
            raise NotImplementedError(f"ensemble decisions {_NOT_PORTED} "
                                      f"(ROADMAP A6)")
        if fan is not None:
            raise NotImplementedError(f"fan decisions {_NOT_PORTED} "
                                      f"(ROADMAP A7)")
        if race is not None:
            raise NotImplementedError(f"race decisions {_NOT_PORTED} "
                                      f"(ROADMAP A7)")
        self.bus = bus
        self.qrun = qrun
        self.engine = (engine if engine is not None
                       else DrainEngine(device=device))
        self.pool = normalize_pool(pool)
        self.fallback_pool = normalize_pool(fallback_pool)
        # the pools' device copies, made once: no per-cycle upload
        self._pool_spec = self.pool.spec.to(self.engine.device)
        self._fallback_spec = self.fallback_pool.spec.to(self.engine.device)
        self.objective = resolve_goal(objective, weights)
        self.max_jobs = max_jobs
        self.state: SimState = empty_state(max_jobs, total_nodes,
                                           device="cpu")
        self.telemetry = telemetry.Telemetry()
        self.free_nodes_probe = free_nodes_probe
        if isinstance(guard, DeadlineGuard):
            self.guard: Optional[DeadlineGuard] = guard
        elif isinstance(guard, GuardSpec):
            self.guard = DeadlineGuard(guard)
        elif guard is not None:
            self.guard = DeadlineGuard(GuardSpec(budget_s=float(guard)))
        else:
            self.guard = None
        self.jobs_probe = jobs_probe
        self.dead_letters: List[DeadLetter] = []
        self._tracker = SeqTracker(reorder_window)
        self._clock = clock
        self._sleep = sleep
        self.read_retries = read_retries
        self.read_backoff_s = read_backoff_s
        self._incumbent: Optional[Tuple[str, int]] = None

    # ------------------------------------------------------------------
    def pump(self) -> int:
        """③ consume pending events; run a decision cycle if any event
        opened a scheduling opportunity.  Returns #events consumed."""
        ing = self.telemetry.ingest

        def _count_retry(attempt: int, exc: Exception) -> None:
            ing.read_retries += 1

        try:
            events = read_with_retry(
                self.bus, self.CONSUMER, retries=self.read_retries,
                backoff_s=self.read_backoff_s, sleep=self._sleep,
                on_retry=_count_retry)
        except BusReadError:
            ing.read_failures += 1
            return 0
        needs_cycle = False
        lost_any = False
        t_latest = float(self.state.now)
        for ev in events:
            applied, cycle, gap, lost = self._ingest(ev)
            needs_cycle |= cycle
            lost_any |= lost
            if gap or lost:
                needs_cycle = True   # something is missing — resync+look
            if applied:
                t_latest = max(t_latest, float(ev.time))
        if lost_any and self.jobs_probe is not None:
            self.state = sync.resync_jobs(self.state, self.jobs_probe())
            ing.resyncs += 1
            t_latest = max(t_latest, float(self.state.now))
        if needs_cycle:
            self._decision_cycle(t_latest)
        return len(events)

    def on_event(self, ev: Event) -> None:
        """Push-mode entry point (bus.subscribe)."""
        self.bus.read(self.CONSUMER)  # keep offset in step with pushes
        applied, needs_cycle, gap, lost = self._ingest(ev)
        if lost and self.jobs_probe is not None:
            self.state = sync.resync_jobs(self.state, self.jobs_probe())
            self.telemetry.ingest.resyncs += 1
        if needs_cycle or gap or lost:
            self._decision_cycle(float(ev.time) if applied
                                 else float(self.state.now))

    def _ingest(self, ev: Event) -> Tuple[bool, bool, bool, bool]:
        """Sanitize + apply ONE event.  Returns ``(applied, needs_cycle,
        gap_detected, losses_declared)``; never raises."""
        ing = self.telemetry.ingest
        reason = validate_event(ev, self.max_jobs)
        if reason is not None:
            self.dead_letters.append(DeadLetter(ev, reason))
            ing.quarantined += 1
            return False, False, False, False
        gap = lost = False
        if ev.seq >= 0:
            obs = self._tracker.observe(ev.seq)
            if obs.new_gaps:
                ing.gaps += obs.new_gaps
                gap = True
            if obs.newly_lost:
                ing.lost += obs.newly_lost
                lost = True
            if obs.status == "duplicate":
                ing.duplicates += 1
                return False, False, gap, lost
            if obs.status == "reordered":
                ing.reordered += 1
        self._capture_residual(ev)
        try:
            self.state, cycle = sync.apply_event(self.state, ev,
                                                 idempotent=True)
        except Exception as exc:  # noqa: BLE001 — quarantine boundary
            self.dead_letters.append(
                DeadLetter(ev, f"apply failed: {type(exc).__name__}: "
                               f"{exc}"))
            ing.quarantined += 1
            return False, False, gap, lost
        return True, cycle, gap, lost

    def _capture_residual(self, ev: Event) -> None:
        """§3.2 estimate-vs-true runtime residual, recorded on JOBOBIT."""
        if ev.kind != EventKind.JOBOBIT or ev.job_id < 0:
            return
        start = float(self.state.jobs.start_t[ev.job_id])
        if start < 0.0:  # never started in the mirror — no ground truth
            return
        est = float(self.state.jobs.est_runtime[ev.job_id])
        self.telemetry.record_residual(est, ev.time - start)

    # ------------------------------------------------------------------
    def _decide_at_level(self, level: int):
        """One decision at the given ladder level.  Returns
        ``(decision, names, source)``.  With no ensemble/fan/race
        configured, level 1 has nothing to shrink and falls through to
        the static pool (level 2), as in the reference."""
        if level >= 3 and self._incumbent is not None:
            # hold the incumbent: one k=1 schedule pass, no comparison
            src, idx = self._incumbent
            base = self.pool if src == "pool" else self.fallback_pool
            pool1 = _fork_pool(base, idx)
            decision = self.engine.decide(self.state, pool1.spec,
                                          self.objective)
            return decision, pool1.names, self._incumbent
        if level >= 1:
            decision = self.engine.decide(self.state, self._fallback_spec,
                                          self.objective)
            return decision, self.fallback_pool.names, ("fallback", None)
        decision = self.engine.decide(self.state, self._pool_spec,
                                      self.objective)
        return decision, self.pool.names, ("pool", None)

    def _decision_cycle(self, t: float) -> None:
        """④→⑦ : sync, simulate, select, feed back."""
        if self.free_nodes_probe is not None:
            self.state = sync.resync_free_nodes(
                self.state, self.free_nodes_probe())

        level = self.guard.plan() if self.guard is not None else 0
        with telemetry.StopWatch(self._clock) as sw:
            decision, names, source = self._decide_at_level(level)
            run_mask = _host(decision.run_mask)  # waits for the device
        guard_fields = {}
        if self.guard is not None:
            missed, margin = self.guard.observe(level, sw.seconds)
            guard_fields = dict(
                guard_level=level,
                deadline_s=self.guard.spec.budget_s,
                margin_s=margin, deadline_miss=missed)

        job_ids = [int(j) for j in np.nonzero(run_mask)[0]]
        win_idx = int(decision.policy_index)
        winner = names[win_idx]
        src, idx = source
        self._incumbent = (src, win_idx) if idx is None else (src, idx)
        costs = {name: float(c)
                 for name, c in zip(names, _host(decision.costs))}
        term_arrays = {term: _host(v)
                       for term, v in (decision.cost_terms or {}).items()}
        term_costs = {name: {term: float(v[i])
                             for term, v in term_arrays.items()}
                      for i, name in enumerate(names)}
        self.telemetry.record(telemetry.CycleRecord(
            time=t, wall_seconds=sw.seconds, policy=winner,
            costs=costs, n_started=len(job_ids), started_jobs=job_ids,
            objective=str(self.objective), term_costs=term_costs,
            **guard_fields))

        if job_ids:
            # ⑦ qrun — the physical system emits RUNJOB events that flow
            # back through the bus and insert predicted-end events.
            self.qrun(job_ids, t)

    def flush(self) -> bool:
        """End-of-stream reconcile (the emulator's ``on_quiesce`` hook):
        declare pending holes lost, resync from the probe, and run one
        more cycle if queued work remains.  Returns True iff a cycle
        ran."""
        ing = self.telemetry.ingest
        newly = self._tracker.flush()
        if newly:
            ing.lost += newly
        if self.jobs_probe is not None:
            self.state = sync.resync_jobs(self.state, self.jobs_probe())
            ing.resyncs += 1
        if bool((self.state.jobs.state == QUEUED).any()):
            self._decision_cycle(float(self.state.now))
            return True
        return False

    # ------------------------------------------------------------------
    def recover(self) -> None:
        """Rebuild the mirror from a full bus replay (twin restart)."""
        self.state = empty_state(self.state.jobs.capacity,
                                 int(self.state.total_nodes), device="cpu")
        for ev in self.bus.replay():
            self.state, _ = sync.apply_event(self.state, ev)
