"""Struct-of-array job/cluster state — the twin's tensor mirror.

Port of ``repro/core/state.py``.  Fixed-capacity tensors (``max_jobs``
slots) so every simulation has a static shape: slot ``i`` is job ``i``
for the lifetime of a trace.  The same structures serve (a) the twin's
mirror of the physical system, (b) each what-if fork (with a leading
fork axis on every leaf), and (c) the emulator's static-mode view.

dtypes are the reference's: node counts and lifecycle codes ``int32``,
times and estimates ``float32``.  The functional updates return new
tensors and never write into their input, as the JAX versions do.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.device import DeviceLike, resolve_device

# Job lifecycle states.
INVALID = 0   # empty slot
QUEUED = 1
RUNNING = 2
DONE = 3

# Sentinel for "not yet" times.
TIME_NONE = -1.0
INF = float("inf")

F32 = torch.float32
I32 = torch.int32


class JobTable(NamedTuple):
    """All tensors have shape (..., max_jobs); ``est_runtime`` is the
    user walltime estimate, the only runtime the twin ever sees."""

    submit_t: torch.Tensor    # f32 — submission time
    nodes: torch.Tensor       # i32 — node request
    est_runtime: torch.Tensor # f32 — user walltime estimate
    start_t: torch.Tensor     # f32 — TIME_NONE until started
    end_t: torch.Tensor       # f32 — predicted (running) or actual (done) end
    state: torch.Tensor       # i32 — INVALID/QUEUED/RUNNING/DONE

    @property
    def capacity(self) -> int:
        return self.submit_t.shape[-1]


class SimState(NamedTuple):
    """One simulation instance (or the twin's live mirror)."""

    jobs: JobTable
    free_nodes: torch.Tensor   # i32 scalar (or (k,) batched)
    total_nodes: torch.Tensor  # i32 scalar (or (k,) batched)
    now: torch.Tensor          # f32 scalar (or (k,) batched)

    def to(self, device: DeviceLike) -> "SimState":
        return map_state(lambda x: x.to(device), self)


def map_state(fn: Callable[[torch.Tensor], torch.Tensor],
              state: SimState) -> SimState:
    """Apply ``fn`` to every leaf (the port's ``jax.tree.map``)."""
    return SimState(jobs=JobTable(*(fn(x) for x in state.jobs)),
                    free_nodes=fn(state.free_nodes),
                    total_nodes=fn(state.total_nodes),
                    now=fn(state.now))


def empty_jobs(max_jobs: int, device: DeviceLike = "cuda") -> JobTable:
    dev = resolve_device(device)
    f = torch.full((max_jobs,), TIME_NONE, dtype=F32, device=dev)
    return JobTable(
        submit_t=f,
        nodes=torch.zeros((max_jobs,), dtype=I32, device=dev),
        est_runtime=torch.zeros((max_jobs,), dtype=F32, device=dev),
        start_t=f.clone(),
        end_t=f.clone(),
        state=torch.zeros((max_jobs,), dtype=I32, device=dev),
    )


def empty_state(max_jobs: int, total_nodes: int,
                device: DeviceLike = "cuda") -> SimState:
    dev = resolve_device(device)
    return SimState(
        jobs=empty_jobs(max_jobs, dev),
        free_nodes=torch.tensor(total_nodes, dtype=I32, device=dev),
        total_nodes=torch.tensor(total_nodes, dtype=I32, device=dev),
        now=torch.tensor(0.0, dtype=F32, device=dev),
    )


# --- functional updates ------------------------------------------------

def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=like.device)


def _set(arr: torch.Tensor, idx: int, value) -> torch.Tensor:
    """``arr.at[idx].set(value)``: a copy with one element replaced."""
    out = arr.clone()
    out[idx] = value
    return out


def add_job(state: SimState, job_id, submit_t, nodes,
            est_runtime) -> SimState:
    """QUEUEJOB: place a job in its slot."""
    jobs = state.jobs
    submit = _f32(submit_t, state.now)
    jobs = jobs._replace(
        submit_t=_set(jobs.submit_t, job_id, submit),
        nodes=_set(jobs.nodes, job_id, int(nodes)),
        est_runtime=_set(jobs.est_runtime, job_id,
                         _f32(est_runtime, state.now)),
        start_t=_set(jobs.start_t, job_id, TIME_NONE),
        end_t=_set(jobs.end_t, job_id, TIME_NONE),
        state=_set(jobs.state, job_id, QUEUED),
    )
    return state._replace(jobs=jobs, now=torch.maximum(state.now, submit))


def start_job(state: SimState, job_id, t) -> SimState:
    """RUNJOB: mark running; predicted end = t + user estimate (§3.2)."""
    jobs = state.jobs
    t = _f32(t, state.now)
    predicted_end = t + jobs.est_runtime[job_id]
    jobs = jobs._replace(
        start_t=_set(jobs.start_t, job_id, t),
        end_t=_set(jobs.end_t, job_id, predicted_end),
        state=_set(jobs.state, job_id, RUNNING),
    )
    return state._replace(
        jobs=jobs,
        free_nodes=state.free_nodes - jobs.nodes[job_id],
        now=torch.maximum(state.now, t),
    )


def end_job(state: SimState, job_id, t) -> SimState:
    """JOBOBIT: actual completion — §3.2 pull-back / push-forward."""
    jobs = state.jobs
    t = _f32(t, state.now)
    jobs = jobs._replace(
        end_t=_set(jobs.end_t, job_id, t),
        state=_set(jobs.state, job_id, DONE),
    )
    return state._replace(
        jobs=jobs,
        free_nodes=state.free_nodes + jobs.nodes[job_id],
        now=torch.maximum(state.now, t),
    )


def requeue_job(state: SimState, job_id, t) -> SimState:
    """Node failure kills a running job: release nodes, back to queue."""
    jobs = state.jobs
    was_running = jobs.state[job_id] == RUNNING
    freed = torch.where(was_running, jobs.nodes[job_id],
                        torch.zeros_like(jobs.nodes[job_id]))
    jobs = jobs._replace(
        start_t=_set(jobs.start_t, job_id, TIME_NONE),
        end_t=_set(jobs.end_t, job_id, TIME_NONE),
        state=_set(jobs.state, job_id,
                   torch.where(was_running,
                               torch.tensor(QUEUED, dtype=I32,
                                            device=was_running.device),
                               jobs.state[job_id])),
    )
    return state._replace(
        jobs=jobs, free_nodes=state.free_nodes + freed,
        now=torch.maximum(state.now, _f32(t, state.now)))


def resize_cluster(state: SimState, delta_nodes) -> SimState:
    """NODEFAIL (negative delta) / NODEUP (positive delta)."""
    delta = int(delta_nodes)
    return state._replace(
        total_nodes=state.total_nodes + delta,
        free_nodes=state.free_nodes + delta,
    )


def queued_mask(jobs: JobTable) -> torch.Tensor:
    return jobs.state == QUEUED


def running_mask(jobs: JobTable) -> torch.Tensor:
    return jobs.state == RUNNING


def validate_invariants(state: SimState) -> dict:
    """Host-side invariant check used by tests and the emulator.

    Returns a dict of boolean invariants; all must be True.
    """
    jobs = state.jobs
    used = torch.where(running_mask(jobs), jobs.nodes, 0).sum()
    started = jobs.start_t >= 0
    valid = jobs.state != INVALID
    return {
        "free_plus_used_is_total": bool(
            (state.free_nodes + used) == state.total_nodes),
        "free_nonnegative": bool(state.free_nodes >= 0),
        "no_start_before_submit": bool(torch.all(
            ~(valid & started) | (jobs.start_t >= jobs.submit_t))),
        "running_have_start": bool(torch.all(
            ~running_mask(jobs) | started)),
        "done_have_end": bool(torch.all(
            (jobs.state != DONE) | (jobs.end_t >= 0))),
    }
