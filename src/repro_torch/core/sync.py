"""Synchronization stage (§3.2) — port of ``repro/core/sync.py``.

Keeps the mirror consistent with the physical scheduler:
  * RUNJOB  -> insert the predicted end (start + user estimate); no cycle;
  * JOBOBIT -> pull back / push forward to the actual end; cycle;
  * QUEUEJOB-> add the job to the wait queue; cycle;
  * NODEFAIL/NODEUP -> resize capacity, requeue victims; cycle.

``apply_event(..., idempotent=True)`` guards every job handler on the
job's current mirror state, so duplicate and out-of-order deliveries
degrade to monotone fill-ins.  ``resync_free_nodes`` / ``resync_jobs``
overwrite the mirror from an authoritative probe.  The twin keeps its
mirror on the host, so these run on CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.events import Event, EventKind
from repro_torch.core.state import (DONE, INVALID, QUEUED, RUNNING,
                                    TIME_NONE, JobTable, SimState, _set,
                                    add_job, end_job, requeue_job,
                                    resize_cluster, start_job)


def _t(ev: Event, like: torch.Tensor) -> torch.Tensor:
    """The event time as an f32 scalar (``jnp.float32(ev.time)``)."""
    return torch.tensor(ev.time, dtype=torch.float32, device=like.device)


def apply_event(state: SimState, ev: Event,
                idempotent: bool = False) -> Tuple[SimState, bool]:
    """Returns (new mirror state, needs_decision_cycle)."""
    if idempotent and ev.kind in (EventKind.QUEUEJOB, EventKind.RUNJOB,
                                  EventKind.JOBOBIT):
        return _apply_job_event_idempotent(state, ev)
    if ev.kind == EventKind.QUEUEJOB:
        state = add_job(state, ev.job_id, submit_t=_t(ev, state.now),
                        nodes=int(ev.payload["nodes"]),
                        est_runtime=float(ev.payload["est_runtime"]))
        return state, True

    if ev.kind == EventKind.RUNJOB:
        return start_job(state, ev.job_id, _t(ev, state.now)), False

    if ev.kind == EventKind.JOBOBIT:
        return end_job(state, ev.job_id, _t(ev, state.now)), True

    if ev.kind == EventKind.NODEFAIL:
        state = resize_cluster(state, -int(ev.payload["nodes"]))
        victim = int(ev.payload.get("victim_job", -1))
        if victim >= 0:
            state = requeue_job(state, victim, _t(ev, state.now))
        state = state._replace(now=torch.maximum(state.now,
                                                 _t(ev, state.now)))
        return state, True

    if ev.kind == EventKind.NODEUP:
        state = resize_cluster(state, int(ev.payload["nodes"]))
        state = state._replace(now=torch.maximum(state.now,
                                                 _t(ev, state.now)))
        return state, True

    raise ValueError(f"unknown event kind: {ev.kind}")


def _apply_job_event_idempotent(state: SimState,
                                ev: Event) -> Tuple[SimState, bool]:
    """State-guarded job-event handlers: each transition fires only from
    the lifecycle state it is valid from."""
    cur = int(state.jobs.state[ev.job_id])
    t = _t(ev, state.now)

    if ev.kind == EventKind.QUEUEJOB:
        if cur != INVALID:          # already known (duplicate / late)
            return state, False
        state = add_job(state, ev.job_id, submit_t=t,
                        nodes=int(ev.payload["nodes"]),
                        est_runtime=float(ev.payload["est_runtime"]))
        return state, True

    if ev.kind == EventKind.RUNJOB:
        if cur == QUEUED:           # the one valid transition
            return start_job(state, ev.job_id, t), False
        if cur == DONE:             # arrived after its JOBOBIT: backfill
            jobs = state.jobs      # start_t only — no resource effect
            jobs = jobs._replace(start_t=_set(jobs.start_t, ev.job_id, t))
            return state._replace(jobs=jobs), False
        return state, False         # RUNNING duplicate / unknown job

    # EventKind.JOBOBIT
    if cur == RUNNING:              # the one valid transition
        return end_job(state, ev.job_id, t), True
    if cur == QUEUED:
        # RUNJOB never arrived: the job is over, but this mirror never
        # charged its nodes — mark DONE without freeing anything.
        jobs = state.jobs
        jobs = jobs._replace(end_t=_set(jobs.end_t, ev.job_id, t),
                             state=_set(jobs.state, ev.job_id, DONE))
        return state._replace(jobs=jobs,
                              now=torch.maximum(state.now, t)), True
    return state, False              # DONE duplicate / unknown job


def resync_free_nodes(state: SimState, authoritative_free: int) -> SimState:
    """Overwrite mirror free-node count from the physical system."""
    return state._replace(free_nodes=torch.tensor(
        int(authoritative_free), dtype=torch.int32,
        device=state.free_nodes.device))


def resync_jobs(state: SimState, view: dict) -> SimState:
    """Full job-table reconcile from an authoritative probe
    (``ClusterEmulator.jobs_view()``); running jobs get predicted ends
    ``start + estimate``, only DONE jobs carry their actual end."""
    dev = state.now.device
    as_f32 = lambda k: torch.as_tensor(view[k], dtype=torch.float32,
                                       device=dev)
    st = torch.as_tensor(view["state"], dtype=torch.int32, device=dev)
    submit, est = as_f32("submit_t"), as_f32("est_runtime")
    start, end = as_f32("start_t"), as_f32("end_t")
    nodes = torch.as_tensor(view["nodes"], dtype=torch.int32, device=dev)
    valid = st != INVALID
    pred_end = torch.where(st == RUNNING, start + est, end)
    jobs = JobTable(
        submit_t=torch.where(valid, submit, TIME_NONE),
        nodes=torch.where(valid, nodes, 0),
        est_runtime=torch.where(valid, est, 0.0),
        start_t=torch.where(st == QUEUED, TIME_NONE,
                            torch.where(valid, start, TIME_NONE)),
        end_t=torch.where((st == RUNNING) | (st == DONE), pred_end,
                          TIME_NONE),
        state=st,
    )
    i32 = lambda v: torch.tensor(int(v), dtype=torch.int32, device=dev)
    return state._replace(jobs=jobs, free_nodes=i32(view["free_nodes"]),
                          total_nodes=i32(view["total_nodes"]))
