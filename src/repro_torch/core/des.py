"""Discrete-event simulation engine (§3.3) — port of ``repro/core/des.py``.

* ``simulate_to_drain`` — the scalar oracle: one what-if fork advanced
  event to event.  The port's own reference for the batched drain.
* ``simulate_to_drain_batched`` — the hot path: all k forks carried as
  a leading axis and advanced in lock-step with per-fork done/dead
  masks.  Keys, argsort, the scheduling pass and the step (starts,
  advance, the next rank limit) run once per event for the whole batch,
  each through an entry of the engine's backend
  (``repro_torch.core.engine``).  Future arrivals are not simulated
  (§3.2): the horizon holds only predicted job ends.  The loop bound is
  ``max_jobs + 1``.
* ``simulate_replay_batched`` — the drain generalized into a trace
  replay (DESIGN.md §6): each fork also carries an arrival cursor into
  its own arrival timeline and the ground-truth runtimes.  Every step
  advances one fork-local event, ``min(next arrival, next actual
  end)``; completions retire at their true ends while the pass keeps
  reasoning over predicted ends.  Bitwise the host emulator's static
  mode.

The reference loops on the device (``lax.while_loop``).  Here both loops
are Python loops.  The drain's condition costs one device-to-host read
per iteration (the rank limit, which is above 0 while a fork is active),
recorded as a ``drain.read`` span; everything the drain does after the
pass is one step entry of the engine's backend (``kernels.drain_step``).
The replay runs blocks of ``REPLAY_BLOCK`` iterations and reads its
condition once per block: its body carries the condition as a device
flag and changes nothing once the flag is down, so no iteration inside a
block waits for the host.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import telemetry
from repro_torch.core.backfill import priority_order, schedule_pass
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


def simulate_to_drain(state: SimState, policy,
                      pass_fn: Optional["BatchedPassFn"] = None
                      ) -> DrainResult:
    """Scalar oracle: drain one fork under one policy.  ``pass_fn`` (a
    batched pass, as an engine backend gives it, run at k=1 with the full
    rank bound) replaces the plain pass; it starts the same jobs."""
    max_iters = state.jobs.capacity + 1
    dev = state.now.device
    st = state
    first = torch.zeros_like(state.jobs.state, dtype=torch.bool)
    dead = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while (it < max_iters and not bool(dead)
           and bool((st.jobs.state == QUEUED).any())):
        if pass_fn is None:
            res = schedule_pass(st, policy)
            st, started = res.state, res.started
        else:
            one = map_state(lambda x: x[None], st)
            started = pass_fn(one, priority_order(one, policy), None)
            st = map_state(lambda x: x[0], apply_starts(one, started))
            started = started[0]
        if it == 0:
            first = started
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


# A drain step: (the loop's own batched SimState, started (k, J) bool,
# active (k,) bool, dead (k,) bool, iters (k,) i32, limit — an i32 tensor
# of one element) -> None.  It masks ``started`` with ``active``, applies
# the starts, advances every active fork to its next predicted end, counts
# the iteration and leaves the next ``active`` and rank limit, all in
# place (``kernels.drain_step``).
DrainStepFn = Callable[[SimState, torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor], None]


def simulate_to_drain_batched(states: SimState,
                              order_fn: Callable[[SimState], torch.Tensor],
                              pass_fn: BatchedPassFn,
                              step_fn: DrainStepFn) -> DrainResult:
    """Drain all k forks of ``states`` (leading axis on every leaf) in
    lock-step.  ``order_fn`` maps the batched state to the (k, J)
    priority order; ``pass_fn`` runs the greedy/backfill pass up to the
    rank limit (``pass_rank_limit``); ``step_fn`` applies its starts and
    advances the forks, in place on the loop's own copy of the fields it
    writes (made once, at entry: ``states`` is never written).  A fork
    that drains or deadlocks freezes while the rest keep stepping, so the
    result is the stack of k scalar drains.

    The loop runs while the rank limit is above 0, which is while some
    fork is active: the limit is the largest queued count of an active
    fork.  It records a ``drain`` span (``core.telemetry``; a root of its
    own outside a decision) holding one ``drain.read`` span around each
    iteration's read of the limit (the host's wait for the card), and
    counts ``drain.steps``, the iterations dispatched."""
    k, J = states.jobs.state.shape
    dev = states.now.device
    max_iters = J + 1

    def own(x):
        return x.clone(memory_format=torch.contiguous_format)
    jobs = states.jobs
    st = states._replace(
        jobs=jobs._replace(start_t=own(jobs.start_t), end_t=own(jobs.end_t),
                           state=own(jobs.state)),
        free_nodes=own(states.free_nodes), now=own(states.now))
    first = torch.zeros((k, J), dtype=torch.bool, device=dev)
    dead = torch.zeros((k,), dtype=torch.bool, device=dev)
    iters = torch.zeros((k,), dtype=torch.int32, device=dev)
    active = ~dead & (st.jobs.state == QUEUED).any(1)
    limit = pass_rank_limit(st, active)
    it = 0
    spans = telemetry.SPANS
    with spans.span("drain"):
        while it < max_iters:
            with spans.span("drain.read"):
                more = int(limit) > 0       # the loop's one host read
            if not more:
                break
            order = order_fn(st)
            started = pass_fn(st, order, limit)
            step_fn(st, started, active, dead, iters, limit)
            if it == 0:
                first = started
            it += 1
        spans.count("drain.steps", it)
    return DrainResult(state=st, first_started=first, iters=iters,
                       deadlocked=dead,
                       pass_invocations=torch.full((k,), it,
                                                   dtype=torch.int32,
                                                   device=dev))


# ----------------------------------------------------------------------
# Scenario-vectorized trace replay (DESIGN.md §6).
# ----------------------------------------------------------------------

#: Iterations the replay runs between two reads of its end condition.
REPLAY_BLOCK = 32

_ORD_NONE = 2**31 - 1     # start order of a slot that has not started


class ReplayResult(NamedTuple):
    state: SimState              # final state: start_t/end_t are ACTUAL
    events: torch.Tensor         # i32 (k,) — events processed per fork
    iters: torch.Tensor          # i32 scalar — lock-step iterations
    deadlocked: torch.Tensor     # bool (k,) — a queued job can never run
    pass_invocations: torch.Tensor  # i32 scalar — scheduling passes the
                                    # reference runs (elision counted)


class ReplayCarry(NamedTuple):
    """The replay loop's state, all of it on the device."""
    st: SimState
    cursor: torch.Tensor      # i64 (k,) — next arrival slot
    true_end: torch.Tensor    # f32 (k, J) — actual end of started jobs
    start_ord: torch.Tensor   # i32 (k, J) — it·(J+1) + slot at start
    it: torch.Tensor          # i32 scalar — iterations where work was left
    dead: torch.Tensor        # bool (k,)
    events: torch.Tensor      # i32 (k,)
    passes: torch.Tensor      # i32 scalar


def replay_init(states: SimState) -> ReplayCarry:
    k, J = states.jobs.state.shape
    dev = states.now.device
    return ReplayCarry(
        st=states,
        cursor=torch.zeros((k,), dtype=torch.int64, device=dev),
        true_end=torch.full((k, J), torch.inf, dtype=torch.float32,
                            device=dev),
        start_ord=torch.full((k, J), _ORD_NONE, dtype=torch.int32,
                             device=dev),
        it=torch.zeros((), dtype=torch.int32, device=dev),
        dead=torch.zeros((k,), dtype=torch.bool, device=dev),
        events=torch.zeros((k,), dtype=torch.int32, device=dev),
        passes=torch.zeros((), dtype=torch.int32, device=dev))


def _next_arrival(cursor: torch.Tensor, arrival_t: torch.Tensor):
    J = arrival_t.shape[1]
    cur = cursor.clamp(0, J - 1)
    t = torch.gather(arrival_t, 1, cur[:, None])[:, 0]
    return torch.where(cursor < J, t, torch.inf), cur


def _work_left(c: ReplayCarry, next_arr: torch.Tensor,
               running_any: torch.Tensor, queued_any: torch.Tensor
               ) -> torch.Tensor:
    work = torch.isfinite(next_arr) | running_any | queued_any
    max_iters = 2 * c.true_end.shape[1] + 2
    return (c.it < max_iters) & (work & ~c.dead).any()


def replay_cond(c: ReplayCarry, arrival_t: torch.Tensor) -> torch.Tensor:
    """The reference's loop condition as a device bool: some live fork
    has an arrival ahead, a running job or a queued job, and fewer than
    2·J + 2 iterations ran.  Monotone: once down it stays down, and a
    step taken while it is down changes nothing."""
    jstate = c.st.jobs.state
    return _work_left(c, _next_arrival(c.cursor, arrival_t)[0],
                      (jstate == RUNNING).any(1), (jstate == QUEUED).any(1))


def make_replay_step(arrival_t: torch.Tensor, true_rt: torch.Tensor,
                     order_fn: Callable[[SimState], torch.Tensor],
                     pass_fn: BatchedPassFn
                     ) -> Callable[[ReplayCarry], ReplayCarry]:
    """One lock-step replay iteration as a function of the carry.  It
    reads nothing back to the host and its shapes never depend on the
    data, so a block of steps queues on the device without a wait.

    Elision: the reference skips keys, argsort and pass behind
    ``lax.cond(limit > 0)``.  Here they run on every step and the starts
    are masked with ``live`` (the pass starts only queued jobs, so when
    no live fork has one the mask empties it: the same bits).
    ``pass_invocations`` still counts the reference's passes: steps
    where the condition held and ``limit > 0``.

    Under a profiler the step's parts are ranges
    (``telemetry.SpanRecorder.phase``):
    ``replay.event``, ``replay.apply``, ``replay.pass`` (the rank limit,
    ``replay.order`` inside it, then the pass) and ``replay.starts``."""
    J = arrival_t.shape[1]
    slots = torch.arange(J, dtype=torch.int32, device=arrival_t.device)
    phase = telemetry.SPANS.phase

    def step(c: ReplayCarry) -> ReplayCarry:
        jobs = c.st.jobs
        with phase("replay.event"):
            next_arr, cur = _next_arrival(c.cursor, arrival_t)
            running = jobs.state == RUNNING
            queued_any = (jobs.state == QUEUED).any(1)
            go = _work_left(c, next_arr, running.any(1), queued_any)  # flag

            # ---- pick each fork's next event -------------------------
            te = torch.where(running, c.true_end, torch.inf)
            next_end = te.amin(1)
            # among simultaneous actual ends, retire the earliest started
            # (the host heap pops end events in push == start order)
            at_min = running & (te <= next_end[:, None])
            j_end = torch.argmin(torch.where(at_min, c.start_ord,
                                             _ORD_NONE), 1)
            is_arr = next_arr <= next_end      # equal times: arrival first
            t_ev = torch.minimum(next_arr, next_end)
            has_event = torch.isfinite(t_ev)
            dead = c.dead | (go & ~has_event & queued_any)
            live = has_event & ~dead & go

        with phase("replay.apply"):
            # ---- inject the arrival (slot = cursor) ------------------
            arr = live & is_arr
            hit_arr = (slots[None, :] == cur[:, None]) & arr[:, None]
            jstate = torch.where(hit_arr, QUEUED, jobs.state)
            cursor = c.cursor + arr.to(torch.int64)

            # ---- retire the completion at its TRUE end time ----------
            fin = live & ~is_arr
            hit_end = (slots[None, :] == j_end[:, None]) & fin[:, None]
            jstate = torch.where(hit_end, DONE, jstate)
            end_t = torch.where(hit_end, c.true_end, jobs.end_t)
            freed = torch.where(hit_end, jobs.nodes, 0).sum(
                1, dtype=torch.int32)
            st = c.st._replace(
                jobs=jobs._replace(state=jstate, end_t=end_t),
                free_nodes=c.st.free_nodes + freed,
                now=torch.where(live, t_ev, c.st.now))

        # ---- one scheduling pass on the whole batch ------------------
        with phase("replay.pass"):
            limit = pass_rank_limit(st, live)
            with phase("replay.order"):
                order = order_fn(st)
            started = pass_fn(st, order, limit) & live[:, None]
        with phase("replay.starts"):
            st = apply_starts(st, started)
            true_end = torch.where(started, st.now[:, None] + true_rt,
                                   c.true_end)
            start_ord = torch.where(started, c.it * (J + 1) + slots[None, :],
                                    c.start_ord)
            ran = go & (limit[0] > 0)
            return ReplayCarry(
                st=st, cursor=cursor, true_end=true_end, start_ord=start_ord,
                it=c.it + go.to(torch.int32), dead=dead,
                events=c.events + live.to(torch.int32),
                passes=c.passes + ran.to(torch.int32))
    return step


def simulate_replay_batched(states: SimState, arrival_t: torch.Tensor,
                            true_rt: torch.Tensor,
                            order_fn: Callable[[SimState], torch.Tensor],
                            pass_fn: BatchedPassFn) -> ReplayResult:
    """Replay k trace forks event by event in lock-step.

    ``states`` is a batched ``SimState`` whose job table is preloaded
    (submit_t/nodes/est_runtime filled for every slot) but entirely
    INVALID: slots become visible to the scheduler only when their
    arrival is injected.  ``arrival_t`` (k, J) is each fork's arrival
    timeline (non-decreasing, ``inf`` on padding) and ``true_rt`` (k, J)
    the ground-truth runtimes the scheduler never sees.

    Each iteration processes one event per live fork, with the host
    emulator's heap order: arrivals win ties with ends, simultaneous
    ends retire in start order, completions retire at ``start +
    true_rt`` while running jobs keep advertising ``start + est`` to
    the pass.  A fork with no next event freezes: done if nothing is
    queued, deadlocked if a queued job remains.  The bound is 2·J + 2
    iterations.  The host runs blocks of ``REPLAY_BLOCK`` steps, never
    past that bound, and reads the condition once after each block.

    It records a ``replay`` span (``core.telemetry``) holding one
    ``replay.read`` span a block around the read alone (the host's wait
    for the card), and counts ``replay.steps`` (steps dispatched) and,
    as a device tensor, ``replay.iters``."""
    J = states.jobs.capacity
    max_iters = 2 * J + 2
    spans = telemetry.SPANS
    with spans.span("replay"):
        step = make_replay_step(arrival_t, true_rt, order_fn, pass_fn)
        c = replay_init(states)
        done = 0
        while done < max_iters:
            n = min(REPLAY_BLOCK, max_iters - done)
            for _ in range(n):
                c = step(c)
            done += n
            flag = replay_cond(c, arrival_t)
            with spans.span("replay.read"):
                more = bool(flag)                 # the block's one read
            if not more:
                break
        spans.count("replay.steps", done)
        spans.count("replay.iters", c.it)
    return ReplayResult(state=c.st, events=c.events, iters=c.it,
                        deadlocked=c.dead, pass_invocations=c.passes)


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
