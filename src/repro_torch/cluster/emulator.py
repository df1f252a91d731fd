"""PBS-like cluster emulator — port of ``repro/cluster/emulator.py``.

The *physical* half of the twin loop: it owns the ground truth (true
runtimes, real node counts), emits the PBS hook events (``queuejob`` /
``runjob`` / ``jobobit``) and accepts ``qrun`` feedback (§3.5).

Two scheduler modes, as in the reference:
  * static — the emulator schedules with one fixed policy through a k=1
    ``DrainEngine`` pass (the twin's own pass).  ``run(..., fast=True)``
    runs the whole trace as one device replay instead
    (``DrainEngine.replay``, DESIGN.md §6): the same results bit for bit,
    this host loop being the oracle it is held against;
  * twin   — scheduling authority is delegated: only jobs the twin
    selects via ``qrun`` start.

Scheduling reasons over *predicted* ends (start + user estimate) while
completions happen at the true runtime (§3.2).  Job fields are quantized
to f32 at ingestion and end times are rounded to f32 in f64 host
arithmetic, exactly as the reference does, so both packages see the same
event times, and the host loop and the device replay agree bitwise.

``snapshot_state``/``restore_state`` carry the ground truth and the
event heap through JSON, so ``run`` continues from where a snapshot cut
(``twin_loop --snapshot-dir/--resume``); the format is the reference's.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cluster.workload import JobSpec, make_scenario
from repro_torch.core.des import SLOWDOWN_TAU
from repro_torch.core.engine import DrainEngine
from repro_torch.core.events import Event, EventBus, EventKind
from repro_torch.core.state import (DONE, INVALID, QUEUED, RUNNING, JobTable,
                                    SimState)
from repro_torch.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """Take ``nodes`` down at ``time`` for ``duration`` seconds."""
    time: float
    nodes: int
    duration: float


@dataclasses.dataclass
class RunReport:
    start_t: np.ndarray
    end_t: np.ndarray
    submit_t: np.ndarray
    nodes: np.ndarray
    true_runtime: np.ndarray
    est_runtime: np.ndarray
    n_jobs: int
    total_nodes: int
    makespan: float
    avg_wait: float
    max_wait: float
    avg_slowdown: float
    max_slowdown: float
    utilization: float
    n_events: int
    n_restarts: int = 0
    # The administrator goal this run was evaluated under (grammar
    # spec), stamped when ``run`` is given ``objective=``; scored
    # through the SAME compiled cost semantics as device decisions.
    # ``objective_cost`` is the scalar cost for elementwise goals
    # (score/weighted) and None for rank-based goals (lex/constrained:
    # a single candidate's composed rank is identically 0 — only the
    # per-term values in ``objective_terms`` carry information).
    objective: Optional[str] = None
    objective_cost: Optional[float] = None
    objective_terms: Optional[Dict[str, float]] = None

    def metric_dict(self) -> Dict[str, float]:
        return {
            "avg_wait": self.avg_wait, "max_wait": self.max_wait,
            "avg_slowdown": self.avg_slowdown,
            "max_slowdown": self.max_slowdown,
            "utilization": self.utilization, "makespan": self.makespan,
        }


_ARRIVAL, _END, _FAIL, _RECOVER = 0, 1, 2, 3


class ClusterEmulator:
    def __init__(self,
                 trace: Sequence[JobSpec],
                 total_nodes: int,
                 bus: Optional[EventBus] = None,
                 max_jobs: Optional[int] = None,
                 failures: Sequence[FailureSpec] = (),
                 check_invariants: bool = False,
                 engine: Optional[DrainEngine] = None,
                 device: DeviceLike = "cuda") -> None:
        self.trace = list(trace)
        self.bus = bus if bus is not None else EventBus()
        self._external_bus = bus is not None
        self.engine = (engine if engine is not None
                       else DrainEngine(device=device))
        self.total_nodes = int(total_nodes)
        self.capacity_nodes = int(total_nodes)  # shrinks on failures
        self.free_nodes = int(total_nodes)
        n = len(self.trace)
        self.max_jobs = max_jobs if max_jobs is not None else max(
            64, 1 << int(np.ceil(np.log2(max(n, 1) + 1))))
        if n > self.max_jobs:
            raise ValueError(f"trace has {n} jobs > capacity {self.max_jobs}")
        self.failures = list(failures)
        self.check_invariants = check_invariants

        # ground-truth job arrays
        m = self.max_jobs
        self.submit_t = np.full(m, -1.0, dtype=np.float64)
        self.nodes = np.zeros(m, dtype=np.int64)
        self.est = np.zeros(m, dtype=np.float64)
        self.true_rt = np.zeros(m, dtype=np.float64)
        self.start_t = np.full(m, -1.0, dtype=np.float64)
        self.end_t = np.full(m, -1.0, dtype=np.float64)
        self.state = np.full(m, INVALID, dtype=np.int64)
        self.remaining = np.zeros(m, dtype=np.float64)  # for restarts
        self.now = 0.0
        self.n_events = 0
        self.n_restarts = 0
        self._heap: List[Tuple[float, int, int, int]] = []
        self._seq = 0
        self._end_seq = np.full(m, -1, dtype=np.int64)  # stale-end guards

        # capacity timeline for utilization accounting: (time, capacity)
        self._capacity_log: List[Tuple[float, int]] = [(0.0, int(total_nodes))]

        for spec in self.trace:
            if spec.nodes > total_nodes:
                raise ValueError(
                    f"job {spec.job_id} requests {spec.nodes} > cluster "
                    f"{total_nodes} nodes")
            # arrival times quantized to f32 (see module docstring)
            self._push(float(np.float32(spec.submit_t)), _ARRIVAL,
                       spec.job_id)
        for i, f in enumerate(self.failures):
            self._push(f.time, _FAIL, i)

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: int, ident: int) -> None:
        heapq.heappush(self._heap, (t, self._seq, kind, ident))
        self._seq += 1

    def _publish(self, kind: EventKind, t: float, job_id: int = -1,
                 **payload: float) -> None:
        self.bus.publish(Event(kind=kind, time=t, job_id=job_id,
                               payload=payload))

    # ------------------------------------------------------------------
    # qrun: decision feedback from the twin (§3.5)
    def qrun(self, job_ids: List[int], t: float) -> None:
        for j in job_ids:
            if self.state[j] != QUEUED:
                continue  # stale decision (already started/finished)
            if self.nodes[j] > self.free_nodes:
                raise RuntimeError(
                    f"qrun job {j}: needs {self.nodes[j]} nodes, "
                    f"only {self.free_nodes} free — twin/mirror divergence")
            self._start_job(j, t)

    def _start_job(self, j: int, t: float) -> None:
        self.state[j] = RUNNING
        self.start_t[j] = t
        self.free_nodes -= int(self.nodes[j])
        run = self.remaining[j] if self.remaining[j] > 0 else self.true_rt[j]
        self._end_seq[j] = self._seq
        # end times quantize to f32 like every other event time: the
        # f64 sum of f32-representable operands is exact, so the cast
        # equals the device replay's f32 add bit-for-bit
        end = float(np.float32(t + run))
        self.end_t[j] = end
        self._push(end, _END, j)
        self._publish(EventKind.RUNJOB, t, j)

    # ------------------------------------------------------------------
    # static-mode scheduling: same pass as the twin's simulator
    def _mirror_state(self) -> SimState:
        """SimState view with *predicted* ends (start + estimate)."""
        running = self.state == RUNNING
        pred_end = np.where(running, self.start_t + self.est, self.end_t)
        f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))
        i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))
        jobs = JobTable(
            submit_t=f32(self.submit_t),
            nodes=i32(self.nodes),
            est_runtime=f32(self.est),
            start_t=f32(self.start_t),
            end_t=f32(pred_end),
            state=i32(self.state),
        )
        return SimState(
            jobs=jobs,
            free_nodes=i32(self.free_nodes),
            total_nodes=i32(self.capacity_nodes),
            now=f32(self.now),
        )

    def jobs_view(self) -> Dict:
        """Authoritative full job-table probe — the ``qstat`` analogue
        of the ``free_nodes`` probe, consumed by ``sync.resync_jobs``
        when the twin declares stream events LOST (DESIGN.md §12).
        Exposes exactly what a scheduler CLI would: submit/start times,
        node counts, USER estimates (never true runtimes — the §3.2
        asymmetry), actual ends for finished jobs only, and the current
        capacity/availability scalars."""
        return {
            "submit_t": self.submit_t.copy(),
            "nodes": self.nodes.copy(),
            "est_runtime": self.est.copy(),
            "start_t": self.start_t.copy(),
            "end_t": np.where(self.state == DONE, self.end_t, -1.0),
            "state": self.state.copy(),
            "free_nodes": int(self.free_nodes),
            "total_nodes": int(self.capacity_nodes),
        }

    # -- crash-safe co-simulation resume (DESIGN.md §12) ----------------
    def snapshot_state(self) -> Dict:
        """JSON-serializable ground-truth snapshot: job arrays, event
        heap, stale-end guards, and capacity log — everything ``run``
        needs to continue mid-trace after a process restart (used by
        ``twin_loop --snapshot-dir/--resume``)."""
        return {
            "submit_t": self.submit_t.tolist(),
            "nodes": self.nodes.tolist(),
            "est": self.est.tolist(),
            "true_rt": self.true_rt.tolist(),
            "start_t": self.start_t.tolist(),
            "end_t": self.end_t.tolist(),
            "state": self.state.tolist(),
            "remaining": self.remaining.tolist(),
            "now": float(self.now),
            "n_events": int(self.n_events),
            "n_restarts": int(self.n_restarts),
            "free_nodes": int(self.free_nodes),
            "capacity_nodes": int(self.capacity_nodes),
            "heap": [list(item) for item in self._heap],
            "seq": int(self._seq),
            "end_seq": self._end_seq.tolist(),
            "capacity_log": [list(item) for item in self._capacity_log],
        }

    def restore_state(self, d: Dict) -> None:
        """Inverse of ``snapshot_state`` on an emulator built with the
        same trace/failures; ``run`` then resumes the event loop from
        exactly where the snapshot cut."""
        self.submit_t[:] = np.asarray(d["submit_t"], dtype=np.float64)
        self.nodes[:] = np.asarray(d["nodes"], dtype=np.int64)
        self.est[:] = np.asarray(d["est"], dtype=np.float64)
        self.true_rt[:] = np.asarray(d["true_rt"], dtype=np.float64)
        self.start_t[:] = np.asarray(d["start_t"], dtype=np.float64)
        self.end_t[:] = np.asarray(d["end_t"], dtype=np.float64)
        self.state[:] = np.asarray(d["state"], dtype=np.int64)
        self.remaining[:] = np.asarray(d["remaining"], dtype=np.float64)
        self.now = float(d["now"])
        self.n_events = int(d["n_events"])
        self.n_restarts = int(d["n_restarts"])
        self.free_nodes = int(d["free_nodes"])
        self.capacity_nodes = int(d["capacity_nodes"])
        self._heap = [(float(t), int(s), int(k), int(i))
                      for t, s, k, i in d["heap"]]
        heapq.heapify(self._heap)
        self._seq = int(d["seq"])
        self._end_seq[:] = np.asarray(d["end_seq"], dtype=np.int64)
        self._capacity_log = [(float(t), int(c))
                              for t, c in d["capacity_log"]]

    def _static_schedule(self, policy) -> None:
        started = self.engine.schedule_pass_starts(
            self._mirror_state(), policy).cpu().numpy()
        for j in np.nonzero(started)[0]:
            self._start_job(int(j), self.now)

    # ------------------------------------------------------------------
    def run(self,
            policy_id=None,
            on_event: Optional[Callable[[], None]] = None,
            fast: bool = False,
            objective=None,
            on_quiesce: Optional[Callable[[], bool]] = None) -> RunReport:
        """Run the full trace.

        static mode: pass ``policy_id`` — a legacy integer id or a
        parametric ``policies.PolicySpec`` fork (e.g. ``wfp_spec(a=2)``
        to baseline one sweep point); both run through the same k=1
        engine pass as the twin's simulator.  ``fast=True`` replays the
        whole trace on the engine's device in one batched replay
        (bitwise the host loop; supports neither failures nor a bus
        that anyone may observe).
        twin mode:   pass ``on_event`` = twin.pump (the co-simulation
        hook called after every published event).

        ``objective`` (an ``objective.Objective`` or grammar string)
        stamps the report with the run's cost under that goal
        (``RunReport.objective`` / ``objective_cost``) — scheduling
        itself is unaffected (static mode runs ONE fixed policy; twin
        mode's goal lives on the ``SchedTwin``).

        ``on_quiesce`` (twin mode only, e.g. ``twin.flush``) fires when
        the event heap empties while queued jobs remain — which on a
        clean stream never happens, but under a lossy bus (chaos
        testing, real deployments) means the consumer missed the events
        that would have started them.  If the hook returns True (it
        reconciled and issued qruns, pushing fresh end events) the loop
        resumes; otherwise the run ends and ``_report`` raises as
        before.
        """
        if (policy_id is None) == (on_event is None):
            raise ValueError("exactly one of policy_id / on_event required")
        if on_quiesce is not None and on_event is None:
            raise ValueError("on_quiesce requires twin (on_event) mode")
        return self._stamp_objective(
            self._run(policy_id, on_event, fast, on_quiesce), objective)

    def _stamp_objective(self, report: RunReport, objective) -> RunReport:
        if objective is not None:
            from repro_torch.core.objective import (metrics_from_rows,
                                                    normalize_objective,
                                                    report_costs)
            goal = normalize_objective(objective)
            row = report.metric_dict()
            report.objective = str(goal)
            if goal.elementwise:
                report.objective_cost = float(
                    report_costs(goal, [row])[0])
            report.objective_terms = {
                term: float(v[0]) for term, v in
                goal.cost_terms(metrics_from_rows([row])).items()}
        return report

    def _run(self,
             policy_id,
             on_event: Optional[Callable[[], None]],
             fast: bool,
             on_quiesce: Optional[Callable[[], bool]] = None) -> RunReport:
        if fast:
            if policy_id is None:
                raise ValueError("fast=True requires static mode")
            if self.failures:
                raise ValueError(
                    "fast=True does not support failure scenarios; "
                    "run the host event loop instead")
            if self._external_bus or self.bus.has_listeners:
                raise ValueError(
                    "fast=True does not stream bus events, but this "
                    "emulator has an attached bus (someone may consume "
                    "it, even after the run); run the host event loop "
                    "instead")
            return self._run_fast(policy_id)
        while self._heap:
            t, seq, kind, ident = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            self.n_events += 1

            if kind == _ARRIVAL:
                spec = self.trace[ident]
                j = spec.job_id
                self.submit_t[j] = np.float32(spec.submit_t)
                self.nodes[j] = spec.nodes
                self.est[j] = np.float32(spec.est_runtime)
                self.true_rt[j] = np.float32(spec.true_runtime)
                self.state[j] = QUEUED
                self._publish(EventKind.QUEUEJOB, t, j,
                              nodes=float(spec.nodes),
                              est_runtime=float(spec.est_runtime))
            elif kind == _END:
                j = ident
                # stale end events (the job was killed and restarted):
                # each end event carries the sequence number of the run
                # instance that pushed it, so a restart whose new end
                # collides with the stale time cannot mis-retire (a
                # float-epsilon time check here used to stand in for
                # this and misfired on collisions).
                if self.state[j] != RUNNING or seq != self._end_seq[j]:
                    self.n_events -= 1
                    continue
                self.state[j] = DONE
                self.end_t[j] = t
                self.remaining[j] = 0.0
                self.free_nodes += int(self.nodes[j])
                self._publish(EventKind.JOBOBIT, t, j)
            elif kind == _FAIL:
                self._handle_failure(self.failures[ident], t)
            elif kind == _RECOVER:
                nodes = ident
                self.capacity_nodes += nodes
                self.free_nodes += nodes
                self._capacity_log.append((t, self.capacity_nodes))
                self._publish(EventKind.NODEUP, t, nodes=float(nodes))
            else:  # pragma: no cover
                raise AssertionError(kind)

            if policy_id is not None:
                self._static_schedule(policy_id)
            else:
                on_event()

            if self.check_invariants:
                self._assert_invariants()

            if not self._heap and on_quiesce is not None and \
                    bool((self.state == QUEUED).any()):
                # Stream quiesced with jobs stuck in QUEUED: on a lossy
                # bus the consumer may have missed the very events that
                # would have started them (and no future event will
                # re-prompt it).  Let it reconcile; any qruns it issues
                # push fresh end events and the loop resumes.
                on_quiesce()

        return self._report()

    # ------------------------------------------------------------------
    def _run_fast(self, policy) -> RunReport:
        """Static mode on the device: one batched replay instead of one
        engine pass per host event.  Writes the replayed ground truth
        back into the host arrays, so that ``_report`` is the same numpy
        code as after a host-loop run."""
        scen = make_scenario(self.trace, self.total_nodes,
                             max_jobs=self.max_jobs)
        out = self.engine.replay(scen, policy)
        host = lambda t: t.detach().cpu().numpy()           # noqa: E731
        n = len(self.trace)
        # f32 device times are exact in the f64 host arrays (ingestion
        # quantizes to f32, and all sums stay in f32-exact range)
        self.start_t[:] = host(out.start_t[0]).astype(np.float64)
        self.end_t[:] = host(out.end_t[0]).astype(np.float64)
        self.state[:] = host(out.result.state.jobs.state[0]).astype(np.int64)
        self.submit_t[:n] = scen.submit_t[0, :n]
        self.nodes[:n] = scen.nodes[0, :n]
        self.est[:n] = scen.est_runtime[0, :n]
        self.true_rt[:n] = scen.true_runtime[0, :n]
        self.free_nodes = self.total_nodes
        if n:
            self.now = float(self.end_t[:n].max())
        # one arrival + one completion per job, as the host loop counts
        self.n_events = 2 * n
        return self._report()

    # ------------------------------------------------------------------
    def _handle_failure(self, f: FailureSpec, t: float) -> None:
        """NODEFAIL: shrink capacity; kill+requeue victims if needed."""
        self.capacity_nodes -= f.nodes
        self.free_nodes -= f.nodes
        self._capacity_log.append((t, self.capacity_nodes))
        victims: List[int] = []
        # free deficit -> kill running jobs (largest first = fewest kills)
        running = [int(j) for j in np.nonzero(self.state == RUNNING)[0]]
        running.sort(key=lambda j: -self.nodes[j])
        while self.free_nodes < 0 and running:
            v = running.pop(0)
            victims.append(v)
            self.free_nodes += int(self.nodes[v])
            # full rerun on restart (no app checkpoint assumed)
            self.remaining[v] = self.true_rt[v]
            self.state[v] = QUEUED
            self.start_t[v] = -1.0
            self.end_t[v] = -1.0
            self.n_restarts += 1
        first_victim = victims[0] if victims else -1
        self._publish(EventKind.NODEFAIL, t, nodes=float(f.nodes),
                      victim_job=float(first_victim))
        for v in victims[1:]:
            self._publish(EventKind.NODEFAIL, t, nodes=0.0,
                          victim_job=float(v))
        if f.duration > 0:
            self._push(t + f.duration, _RECOVER, f.nodes)

    # ------------------------------------------------------------------
    def _assert_invariants(self) -> None:
        used = int(self.nodes[self.state == RUNNING].sum())
        assert used + self.free_nodes == self.capacity_nodes, (
            used, self.free_nodes, self.capacity_nodes)
        assert self.free_nodes >= 0
        started = self.start_t >= 0
        assert np.all(self.start_t[started] >= self.submit_t[started] - 1e-9)

    def _available_node_seconds(self, t0: float, t1: float) -> float:
        """∫ capacity(t) dt over [t0, t1] along the failure timeline —
        the utilization denominator.  Dividing by the original
        ``total_nodes`` overstates availability whenever ``FailureSpec``s
        shrink ``capacity_nodes`` (permanently for duration=0 failures).
        Reduces to ``total_nodes * (t1 - t0)`` with no failures."""
        if len(self._capacity_log) == 1:
            return self.total_nodes * (t1 - t0)
        total = 0.0
        for i, (t_seg, cap) in enumerate(self._capacity_log):
            t_next = (self._capacity_log[i + 1][0]
                      if i + 1 < len(self._capacity_log) else t1)
            lo, hi = max(t_seg, t0), min(t_next, t1)
            if hi > lo:
                total += cap * (hi - lo)
        return total

    def _report(self) -> RunReport:
        done = self.state == DONE
        if not np.all(done[:len(self.trace)]):
            stuck = np.nonzero(~done[:len(self.trace)])[0]
            raise RuntimeError(f"jobs never completed: {stuck[:8]}...")
        n = len(self.trace)
        s, e = self.start_t[:n], self.end_t[:n]
        sub, rt = self.submit_t[:n], self.true_rt[:n]
        wait = np.maximum(s - sub, 0.0)
        sd = np.maximum((wait + rt) / np.maximum(rt, SLOWDOWN_TAU), 1.0)
        makespan = float(e.max() - sub.min())
        avail = self._available_node_seconds(float(sub.min()), float(e.max()))
        util = float((self.nodes[:n] * rt).sum() / max(avail, 1e-9))
        return RunReport(
            start_t=s.copy(), end_t=e.copy(), submit_t=sub.copy(),
            nodes=self.nodes[:n].copy(), true_runtime=rt.copy(),
            est_runtime=self.est[:n].copy(),
            n_jobs=n, total_nodes=self.total_nodes, makespan=makespan,
            avg_wait=float(wait.mean()), max_wait=float(wait.max()),
            avg_slowdown=float(sd.mean()), max_slowdown=float(sd.max()),
            utilization=min(util, 1.0), n_events=self.n_events,
            n_restarts=self.n_restarts)
