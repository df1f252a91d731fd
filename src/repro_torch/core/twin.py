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
resyncs), the deadline-guard ladder and the Monte-Carlo decision modes
(``ensemble``, ``fan``, ``race``, with their level-1 shrink) are as in
the reference.  The ensemble's key chain is the reference's threefry
(``prng``): the twin splits its key before every ensemble decision, so a
co-simulation draws the same members.  ``snapshot``/``restore`` make the
twin crash-safe through ``checkpoint.CheckpointManager`` on the
reference's format: a twin of either package restores the other's
snapshot and makes the uninterrupted run's remaining decisions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng, sync, telemetry
from repro_torch.core.engine import DrainEngine
from repro_torch.core.events import (BusReadError, DeadLetter, Event, EventBus,
                                     EventKind, SeqTracker, read_with_retry,
                                     validate_event)
from repro_torch.core.fan import FanSpec, normalize_fan
from repro_torch.core.guard import DeadlineGuard, GuardSpec
from repro_torch.core.objective import ObjectiveLike, resolve_goal
from repro_torch.core.policies import (PAPER_POOL, PolicyPool, PolicySpec,
                                       PoolLike, normalize_pool)
from repro_torch.core.race import RaceSpec, normalize_race
from repro_torch.core.scoring import ScoreWeights
from repro_torch.core.state import QUEUED, SimState, empty_state
from repro_torch.device import DeviceLike


def _jsonable(x):
    """Snapshot extras with numpy and torch scalars turned into Python
    ones (``.item()`` round-trips f32 exactly)."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    return arr.item() if arr.ndim == 0 else arr.tolist()


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
    are mutually exclusive decision modes.
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
                 ensemble_noise: float = 0.3,
                 fan: Optional[FanSpec] = None,
                 race: Optional[RaceSpec] = None,
                 engine: Optional[DrainEngine] = None,
                 seed: int = 0,
                 guard=None,
                 jobs_probe: Optional[Callable[[], dict]] = None,
                 fallback_pool: PoolLike = PAPER_POOL,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep,
                 reorder_window: int = 64,
                 read_retries: int = 3,
                 read_backoff_s: float = 0.01,
                 device: DeviceLike = "cuda") -> None:
        if fan is not None and ensemble > 1:
            raise ValueError("fan= and ensemble>1 are mutually exclusive")
        if race is not None and (fan is not None or ensemble > 1):
            raise ValueError(
                "race= is mutually exclusive with fan= and ensemble>1")
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
        self.ensemble = ensemble
        self.ensemble_noise = ensemble_noise
        self.fan = normalize_fan(fan) if fan is not None else None
        self.race = normalize_race(race) if race is not None else None
        self._key = prng.PRNGKey(seed)
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
        """One decision at the given ladder level.  Returns ``(decision,
        race_out, names, source)``: ``names`` label the decision's forks
        and ``source`` says which pool the winning index refers to (the
        incumbent bookkeeping).  Level 0 is the configured mode; level 1
        shrinks a race, fan or ensemble by the guard's ``shrink`` and a
        mode with nothing to shrink falls through to the static pool."""
        if level >= 3 and self._incumbent is not None:
            # hold the incumbent: one k=1 schedule pass, no comparison
            src, idx = self._incumbent
            base = self.pool if src == "pool" else self.fallback_pool
            pool1 = _fork_pool(base, idx)
            decision = self.engine.decide(self.state, pool1.spec,
                                          self.objective)
            return decision, None, pool1.names, self._incumbent
        if level >= 2 or (level == 1 and self.race is None
                          and self.fan is None and self.ensemble <= 1):
            decision = self.engine.decide(self.state, self._fallback_spec,
                                          self.objective)
            return (decision, None, self.fallback_pool.names,
                    ("fallback", None))
        race, fan, n_ens = self.race, self.fan, self.ensemble
        if level == 1:
            shrink = self.guard.spec.shrink
            if race is not None:
                fan1 = dataclasses.replace(
                    race.fan, n=max(race.f0, int(np.ceil(race.fan.n
                                                         * shrink))))
                bm = (race.budget_ms * shrink if race.budget_ms
                      else race.budget_ms)
                race = dataclasses.replace(race, fan=fan1, budget_ms=bm)
            elif fan is not None:
                fan = dataclasses.replace(
                    fan, n=max(1, int(np.ceil(fan.n * shrink))))
            else:
                n_ens = max(2, int(np.ceil(n_ens * shrink)))
        if race is not None:
            # the host pool: the race indexes its survivors there
            decision, race_out = self.engine.decide_race(
                self.state, self.pool.spec, race, objective=self.objective)
            return decision, race_out, self.pool.names, ("pool", None)
        if fan is not None:
            decision = self.engine.decide_fan(
                self.state, self._pool_spec, fan, objective=self.objective)
            return decision, None, self.pool.names, ("pool", None)
        if n_ens > 1:
            # the key is split before every ensemble decision, shrunk
            # ones too, as the reference consumes it
            self._key, sub = prng.split(self._key)
            decision = self.engine.decide_ensemble(
                self.state, self._pool_spec, sub, n_ens=n_ens,
                noise=self.ensemble_noise, objective=self.objective)
            return decision, None, self.pool.names, ("pool", None)
        decision = self.engine.decide(self.state, self._pool_spec,
                                      self.objective)
        return decision, None, self.pool.names, ("pool", None)

    def _decision_cycle(self, t: float) -> None:
        """④→⑦ : sync, simulate, select, feed back."""
        if self.free_nodes_probe is not None:
            self.state = sync.resync_free_nodes(
                self.state, self.free_nodes_probe())

        level = self.guard.plan() if self.guard is not None else 0
        # the ``decision`` span (a root in ``telemetry.SPANS``) holds the
        # interval ``CycleRecord.wall_seconds`` times and the drain's spans
        with telemetry.SPANS.span("decision"), \
                telemetry.StopWatch(self._clock) as sw:
            decision, race_out, names, source = self._decide_at_level(
                level)
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
        # fan/ensemble decisions carry device-computed per-policy
        # uncertainty; recorded as-is, no host math
        cost_ci = ({name: float(c) for name, c in
                    zip(names, _host(decision.cost_ci))}
                   if decision.cost_ci is not None else {})
        fan_width = ({name: float(w) for name, w in
                      zip(names, _host(decision.fan_width))}
                     if decision.fan_width is not None else {})
        race_fields = {}
        if race_out is not None:
            race_fields = dict(
                race_rungs=len(race_out.rungs),
                race_members=int(race_out.members),
                race_separation=float(np.min(race_out.separation)),
                race_stopped=race_out.stopped)
        self.telemetry.record(telemetry.CycleRecord(
            time=t, wall_seconds=sw.seconds, policy=winner,
            costs=costs, n_started=len(job_ids), started_jobs=job_ids,
            objective=str(self.objective), term_costs=term_costs,
            cost_ci=cost_ci, fan_width=fan_width,
            fan_size=decision.fan_size, **race_fields, **guard_fields))

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

    # -- crash-safe snapshots (DESIGN.md §12) ---------------------------
    def snapshot(self, manager, step: Optional[int] = None,
                 app_extra: Optional[Dict] = None) -> str:
        """Serialize the decision-relevant twin runtime through
        ``checkpoint.CheckpointManager``: the SimState mirror and the
        PRNG key (as uint32 words) in the array tree; the consumer
        offset, SeqTracker, guard ladder, incumbent, dead letters and
        telemetry in the JSON ``extra``.  A twin built with the same
        configuration and ``restore``d from it makes the uninterrupted
        run's remaining decisions, bitwise.  ``step`` defaults to the
        number of recorded cycles; ``app_extra`` rides in the same
        manifest (``twin_loop`` puts the emulator and the bus there)."""
        step = len(self.telemetry.cycles) if step is None else int(step)
        tm = self.telemetry
        extra = {
            "consumer_offset": int(
                self.bus.snapshot_offsets().get(self.CONSUMER, 0)),
            "tracker": self._tracker.to_dict(),
            "guard": (self.guard.to_dict()
                      if self.guard is not None else None),
            "incumbent": (list(self._incumbent)
                          if self._incumbent is not None else None),
            "dead_letters": [[dl.event.to_dict(), dl.reason]
                             for dl in self.dead_letters],
            "telemetry": {
                "cycles": [dataclasses.asdict(c) for c in tm.cycles],
                "job_start_policy": {str(k): v for k, v in
                                     tm.job_start_policy.items()},
                "runtime_residuals": [[e, a] for e, a
                                      in tm.runtime_residuals],
                "ingest": tm.ingest.as_dict(),
            },
        }
        if app_extra is not None:
            extra["app"] = app_extra
        tree = {"state": self.state, "key": prng.key_words(self._key)}
        return manager.save(step, tree, _jsonable(extra))

    def restore(self, manager,
                step: Optional[int] = None) -> Tuple[int, Optional[Dict]]:
        """Inverse of ``snapshot``, on a twin built with the same
        configuration (pool, objective, fan, race, guard and engine are
        code, not payload).  Rewinds the bus consumer offset, so the next
        ``pump()`` resumes where the snapshot cut.  Returns
        ``(step_restored, app_extra_or_None)``."""
        step = manager.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint to restore under {manager.root!r}")
        target = {"state": self.state, "key": self._key}
        tree, extra = manager.restore(step, target, device="cpu")
        self.state = tree["state"]
        self._key = tree["key"]
        self.bus.restore_offsets(
            {self.CONSUMER: int(extra["consumer_offset"])})
        self._tracker = SeqTracker.from_dict(extra["tracker"])
        if self.guard is not None:
            self.guard.restore(extra.get("guard"))
        inc = extra.get("incumbent")
        self._incumbent = (inc[0], int(inc[1])) if inc else None
        self.dead_letters = [
            DeadLetter(Event.from_dict(e), r)
            for e, r in extra.get("dead_letters", [])]
        tmd = extra.get("telemetry", {})
        tm = telemetry.Telemetry()
        tm.cycles = [telemetry.CycleRecord(**c)
                     for c in tmd.get("cycles", [])]
        tm.job_start_policy = {int(k): v for k, v in
                               tmd.get("job_start_policy", {}).items()}
        tm.runtime_residuals = [(float(e), float(a)) for e, a in
                                tmd.get("runtime_residuals", [])]
        tm.ingest = telemetry.IngestStats(**tmd.get("ingest", {}))
        self.telemetry = tm
        return step, extra.get("app")
