"""Discrete-event simulation engine (§3.3) — port of ``repro/core/des.py``.

* ``simulate_to_drain`` — the scalar oracle: one what-if fork advanced
  event to event.  The port's own reference for the batched drain.
* ``simulate_to_drain_batched`` — the hot path: all k forks carried as
  a leading axis and advanced in lock-step with per-fork done/dead
  masks.  Keys, argsort and the scheduling pass run once per event for
  the whole batch, the pass through a pluggable backend
  (``repro_torch.core.engine``).

Future arrivals are not simulated (§3.2): the horizon holds only
predicted job ends.  The loop bound is ``max_jobs + 1``.

The reference loops on the device (``lax.while_loop``).  Here the loop
is a Python ``while`` whose condition costs exactly one device-to-host
read per iteration (``bool(active.any())``); the body launches only
asynchronous work.  The trace replay (``simulate_replay_batched``) is
not ported yet (ROADMAP A5).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.backfill import schedule_pass
from repro_torch.core.state import DONE, QUEUED, RUNNING, SimState, map_state


class DrainResult(NamedTuple):
    state: SimState              # all previously-queued jobs DONE (or dead)
    first_started: torch.Tensor  # bool (..., J) — jobs started at t=now(0)
    iters: torch.Tensor          # i32 — events processed (per fork)
    deadlocked: torch.Tensor     # bool — a queued job can never fit
    pass_invocations: torch.Tensor  # i32 — scheduling passes executed


def _advance(st: SimState, active: torch.Tensor, dead: torch.Tensor):
    """Move every active fork to its next predicted completion and
    retire the jobs ending there; returns (state, dead)."""
    jobs = st.jobs
    running = jobs.state == RUNNING
    has_queued = (jobs.state == QUEUED).any(-1)
    ends = torch.where(running, jobs.end_t, torch.inf)
    # stale predicted ends (before the snapshot instant) are processed at
    # the current time: virtual time never rewinds
    t_next = torch.maximum(ends.amin(-1), st.now)
    finite = torch.isfinite(t_next)
    can_advance = active & has_queued & finite
    dead = dead | (active & has_queued & ~finite)
    ending = (running & (jobs.end_t <= t_next[..., None])
              & can_advance[..., None])
    freed = torch.where(ending, jobs.nodes, 0).sum(-1, dtype=torch.int32)
    jobs = jobs._replace(state=torch.where(ending, DONE, jobs.state))
    st = st._replace(jobs=jobs, free_nodes=st.free_nodes + freed,
                     now=torch.where(can_advance, t_next, st.now))
    return st, dead


def simulate_to_drain(state: SimState, policy) -> DrainResult:
    """Scalar oracle: drain one fork under one policy."""
    max_iters = state.jobs.capacity + 1
    dev = state.now.device
    st = state
    first = torch.zeros_like(state.jobs.state, dtype=torch.bool)
    dead = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while (it < max_iters and not bool(dead)
           and bool((st.jobs.state == QUEUED).any())):
        res = schedule_pass(st, policy)
        st = res.state
        if it == 0:
            first = res.started
        st, dead = _advance(st, torch.ones((), dtype=torch.bool,
                                           device=dev), dead)
        it += 1
    n = torch.tensor(it, dtype=torch.int32, device=dev)
    return DrainResult(state=st, first_started=first, iters=n,
                       deadlocked=dead, pass_invocations=n)


# A batched pass: (batched SimState, order (k, J) i32, rank limit — an i32
# tensor of one element or None for the full bound) -> started (k, J) bool.
BatchedPassFn = Callable[[SimState, torch.Tensor, Optional[torch.Tensor]],
                         torch.Tensor]


def pass_rank_limit(states: SimState, fork_mask: torch.Tensor
                    ) -> torch.Tensor:
    """Dynamic pass bound: the batch-max queued count over live forks,
    an i32 tensor of one element, left on the device.  Every order the
    engine produces is queued-first, so ranks at or past it cannot start
    anything and truncating the rank walks there is bit-exact."""
    n_queued = (states.jobs.state == QUEUED).sum(1, dtype=torch.int32)
    return torch.where(fork_mask, n_queued, 0).amax().reshape(1)


def broadcast_state(state: SimState, k: int) -> SimState:
    """Fan one snapshot out to k forks.  Unlike the reference's lazy
    broadcast this makes k contiguous copies (once per cycle): the pass
    kernel reads contiguous rows."""
    return map_state(
        lambda x: x.expand((k,) + tuple(x.shape)).contiguous(), state)


def apply_starts(st: SimState, started: torch.Tensor) -> SimState:
    """Apply a batched pass's start decisions (k, J): start at ``now``,
    predicted end = now + estimate (§3.2), nodes claimed."""
    jobs = st.jobs
    now_col = st.now[:, None]
    jobs = jobs._replace(
        start_t=torch.where(started, now_col, jobs.start_t),
        end_t=torch.where(started, now_col + jobs.est_runtime, jobs.end_t),
        state=torch.where(started, RUNNING, jobs.state),
    )
    return st._replace(
        jobs=jobs,
        free_nodes=st.free_nodes
        - torch.where(started, jobs.nodes, 0).sum(1, dtype=torch.int32),
    )


def simulate_to_drain_batched(states: SimState,
                              order_fn: Callable[[SimState], torch.Tensor],
                              pass_fn: BatchedPassFn,
                              dynamic_bounds: bool = True) -> DrainResult:
    """Drain all k forks of ``states`` (leading axis on every leaf) in
    lock-step.  ``order_fn`` maps the batched state to the (k, J)
    priority order; ``pass_fn`` runs the greedy/backfill pass up to the
    rank limit.  A fork that drains or deadlocks freezes while the rest
    keep stepping, so the result is the stack of k scalar drains."""
    k, J = states.jobs.state.shape
    dev = states.now.device
    max_iters = J + 1
    st = states
    first = torch.zeros((k, J), dtype=torch.bool, device=dev)
    dead = torch.zeros((k,), dtype=torch.bool, device=dev)
    iters = torch.zeros((k,), dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters:
        active = ~dead & (st.jobs.state == QUEUED).any(1)
        if not bool(active.any()):      # the loop's one host read
            break
        order = order_fn(st)
        limit = pass_rank_limit(st, active) if dynamic_bounds else None
        started = pass_fn(st, order, limit) & active[:, None]
        st = apply_starts(st, started)
        if it == 0:
            first = started
        st, dead = _advance(st, active, dead)
        iters = iters + active.to(torch.int32)
        it += 1
    return DrainResult(state=st, first_started=first, iters=iters,
                       deadlocked=dead,
                       pass_invocations=torch.full((k,), it,
                                                   dtype=torch.int32,
                                                   device=dev))


class DrainMetrics(NamedTuple):
    avg_wait: torch.Tensor
    max_wait: torch.Tensor
    avg_slowdown: torch.Tensor
    max_slowdown: torch.Tensor
    makespan: torch.Tensor
    utilization: torch.Tensor


SLOWDOWN_TAU = 10.0  # bounded-slowdown floor (seconds), standard practice


def drain_metrics(result: DrainResult, eval_mask: torch.Tensor,
                  runtime: Optional[torch.Tensor] = None) -> DrainMetrics:
    """User/system metrics over ``eval_mask`` jobs (§3.4: the jobs
    waiting in the queue at decision time)."""
    return state_metrics(result.state, eval_mask, runtime)


def state_metrics(state: SimState, eval_mask: torch.Tensor,
                  runtime: Optional[torch.Tensor] = None) -> DrainMetrics:
    """The metrics over any final state, reduced over the last axis (so a
    batched state gives (k,) metrics against one shared ``eval_mask``).
    f32 sums run in torch's order, not XLA's: agreement with the
    reference is to a tolerance, not bitwise."""
    jobs = state.jobs
    rt = jobs.est_runtime if runtime is None else runtime
    n = eval_mask.sum(-1).clamp_min(1)

    wait = torch.where(eval_mask, jobs.start_t - jobs.submit_t, 0.0)
    wait = wait.clamp_min(0.0)
    sd = (wait + rt) / rt.clamp_min(SLOWDOWN_TAU)
    sd = sd.clamp_min(1.0)
    sd = torch.where(eval_mask, sd, 0.0)

    makespan = torch.where(eval_mask, jobs.end_t, 0.0).amax(-1)
    node_seconds = torch.where(eval_mask, jobs.nodes * rt, 0.0).sum(-1)
    span = (makespan - torch.where(eval_mask, jobs.submit_t,
                                   torch.inf).amin(-1)).clamp_min(1e-6)
    util = node_seconds / (state.total_nodes.to(torch.float32) * span)

    return DrainMetrics(
        avg_wait=wait.sum(-1) / n,
        max_wait=wait.amax(-1),
        avg_slowdown=sd.sum(-1) / n,
        max_slowdown=torch.where(eval_mask, sd, 1.0).amax(-1),
        makespan=makespan,
        utilization=util.clamp(0.0, 1.0),
    )


def quantile_index(q: float, n: int) -> int:
    """Nearest-rank quantile index into an ascending sort of ``n``
    values: ``ceil(q·n) - 1`` clamped to ``[0, n-1]``."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile must be in (0, 1], got {q!r}")
    return min(n - 1, max(0, math.ceil(q * n) - 1))


def cvar_tail_count(alpha: float, n: int) -> int:
    """How many worst members the CVaR_α tail averages:
    ``max(1, ceil((1-α)·n))``."""
    if not 0.0 <= alpha < 1.0:
        raise ValueError(f"cvar alpha must be in [0, 1), got {alpha!r}")
    return max(1, min(n, math.ceil((1.0 - alpha) * n)))
