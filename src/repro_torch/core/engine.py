"""Policy-batched drain engine with pluggable scheduling-pass backends —
port of ``repro/core/engine.py``.

Every decision cycle forks the synchronized snapshot into k what-if
simulations, one per candidate policy, and drains them all in lock-step
(``des.simulate_to_drain_batched``).  Per event:

  1. priority keys are computed and argsorted once for the whole batch
     (time-invariant forks are hoisted out of the loop, ``hoist_static``);
  2. the sequential greedy + EASY-backfill pass runs through a
     registered backend on the batch axis;
  3. starts are applied and each fork advances to its next predicted end.

Backends (``PASS_BACKENDS``):

  * ``reference`` — the plain batched pass, ``backfill.schedule_pass_batched``;
  * ``cuda``      — K1, ``kernels.policy_eval.policy_eval_pass_batched``
    (on CPU tensors it runs the same plain pass);
  * ``auto``      — ``cuda`` on a CUDA device, ``reference`` on the CPU.

The engine owns a device (default ``cuda``): ``decide``/``drain`` copy
their state and pool there.  It also hosts the scenario-vectorized
replay (DESIGN.md §6): ``replay`` / ``replay_grid`` drive
``des.simulate_replay_batched`` over a ``workload.ScenarioSet``, with an
S-scenario axis stacked on the P-policy fork axis (fork f = s·P + p), so
a whole baseline grid is one batched replay.  Ensembles (ROADMAP A6),
fans and races (A7), the sharded streamers (A8) and θ training (A9) are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import scoring
from repro_torch.core.backfill import (priority_order, schedule_pass_batched,
                                       static_priority_order)
from repro_torch.core.des import (DrainMetrics, DrainResult, ReplayResult,
                                  broadcast_state, simulate_replay_batched,
                                  simulate_to_drain_batched, state_metrics)
from repro_torch.core.objective import (DEFAULT_OBJECTIVE, Objective,
                                        ObjectiveLike, resolve_goal)
from repro_torch.core.policies import PolicySpec, time_invariant_mask
from repro_torch.core.state import (QUEUED, TIME_NONE, JobTable, SimState,
                                    map_state)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import policy_eval as _pe

logger = logging.getLogger(__name__)

#: A pool as the engine takes it: a ``PolicySpec`` with a leading fork
#: axis, or a legacy (k,) int id vector (the oracle path).
EnginePool = Union[PolicySpec, torch.Tensor]


def pool_size(pool: EnginePool) -> int:
    if isinstance(pool, PolicySpec):
        return pool.family.shape[0]
    return pool.shape[0]


def tile_pool(pool: EnginePool, n: int) -> EnginePool:
    """Repeat a pool n times along the fork axis (one pool copy per
    replay scenario)."""
    if isinstance(pool, PolicySpec):
        return PolicySpec(pool.family.repeat(n), pool.theta.repeat(n, 1))
    return pool.repeat(n)


def as_pool(policy) -> EnginePool:
    """Lift one policy (a scalar ``PolicySpec`` or an integer id) into a
    k=1 pool; pools pass through."""
    if isinstance(policy, PolicySpec):
        if policy.family.ndim == 0:
            return PolicySpec(policy.family.reshape(1),
                              policy.theta.reshape(1, -1))
        return policy
    arr = torch.as_tensor(policy, dtype=torch.int32)
    return arr.reshape(1) if arr.ndim == 0 else arr


def _pool_to(pool: EnginePool, device: torch.device) -> EnginePool:
    if isinstance(pool, PolicySpec):
        return pool.to(device)
    return torch.as_tensor(pool, dtype=torch.int32).to(device)


class Decision(NamedTuple):
    """One scheduling cycle's outcome (tensors on the engine's device)."""
    policy_index: torch.Tensor   # index into the pool (NOT the policy id)
    costs: torch.Tensor          # (k,) per-policy objective cost
    run_mask: torch.Tensor       # bool (max_jobs,) jobs to start now
    metrics: DrainMetrics        # (k,)-leading metrics for telemetry
    deadlocked: torch.Tensor     # (k,) bool
    cost_terms: Optional[Dict[str, torch.Tensor]] = None  # term -> (k,)


class ReplayOutcome(NamedTuple):
    """A replayed (scenario × policy) grid (DESIGN.md §6).

    Leading axes are (S, P) from ``replay_grid`` (fork f = s·P + p) and
    (P,) from ``replay``.  ``start_t``/``end_t`` are ACTUAL times;
    ``metrics`` score true outcomes over each scenario's real slots;
    ``costs`` are the goal's costs over the policy axis (deadlocked
    forks at +inf) and ``best`` its per-scenario argmin."""
    start_t: torch.Tensor        # f32 (..., J)
    end_t: torch.Tensor          # f32 (..., J)
    metrics: DrainMetrics        # (...)-leading
    deadlocked: torch.Tensor     # bool (...)
    events: torch.Tensor         # i32 (...) — events processed per fork
    result: ReplayResult         # the raw flat (k = S·P) replay result
    costs: Optional[torch.Tensor] = None   # (..., P)
    best: Optional[torch.Tensor] = None    # per-scenario pool index


# ----------------------------------------------------------------------
# Pass backends: (batched SimState, order (k, J), rank limit) -> started
# ----------------------------------------------------------------------

PassFn = Callable[[SimState, torch.Tensor, Optional[torch.Tensor]],
                  torch.Tensor]
PASS_BACKENDS: Dict[str, Callable[["DrainEngine"], PassFn]] = {}


def register_backend(name: str):
    """Register a pass-backend factory under ``name``."""
    def deco(factory: Callable[["DrainEngine"], PassFn]):
        PASS_BACKENDS[name] = factory
        return factory
    return deco


def _pass_inputs(states: SimState, order: torch.Tensor, limit):
    jobs = states.jobs
    return (order, jobs.state, jobs.nodes, jobs.est_runtime, jobs.end_t,
            states.free_nodes, states.now, limit)


@register_backend("reference")
def _reference_backend(engine: "DrainEngine") -> PassFn:
    """The plain batched pass (the port's oracle)."""
    def pass_fn(states: SimState, order: torch.Tensor, limit):
        return schedule_pass_batched(*_pass_inputs(states, order, limit))[0]
    return pass_fn


@register_backend("cuda")
def _cuda_backend(engine: "DrainEngine") -> PassFn:
    """K1, the hand-written CUDA pass (one block per fork)."""
    def pass_fn(states: SimState, order: torch.Tensor, limit):
        return _pe.policy_eval_pass_batched(
            *_pass_inputs(states, order, limit))[0]
    return pass_fn


def batched_priority_order(states: SimState, pool: EnginePool
                           ) -> torch.Tensor:
    """(k, J) priority order for the whole fork batch: one batched key
    evaluation and one stable argsort per event."""
    return priority_order(states, pool)


# ----------------------------------------------------------------------
# Static-key hoisting: forks whose keys never depend on the clock get
# their argsort computed once, outside the event loop.
# ----------------------------------------------------------------------

#: Per-fork "keys are time-invariant" bools decided on the host, or None.
HoistPlan = Optional[Tuple[bool, ...]]


def hoist_plan(pool: EnginePool, enabled: bool = True) -> HoistPlan:
    """The static hoist plan of a pool (None when disabled or when no
    fork qualifies)."""
    if not enabled:
        return None
    mask = time_invariant_mask(pool)
    if not mask.any():
        return None
    return tuple(bool(b) for b in mask)


def _index_pool(pool: EnginePool, idx: torch.Tensor) -> EnginePool:
    if isinstance(pool, PolicySpec):
        return PolicySpec(pool.family[idx], pool.theta[idx])
    return pool[idx]


def _compact_queued_first(order: torch.Tensor,
                          queued: torch.Tensor) -> torch.Tensor:
    """Stable-partition each fork's rank order so QUEUED slots take the
    leading ranks (a cumsum and a row scatter, no sort), which restores
    ``des.pass_rank_limit``'s queued-first contract for hoisted orders."""
    q = torch.gather(queued, 1, order.long())
    nq = torch.cumsum(q, 1, dtype=torch.int32)
    pos = torch.where(q, nq - 1,
                      nq[:, -1:] + torch.cumsum(~q, 1, dtype=torch.int32) - 1)
    return torch.zeros_like(order).scatter(1, pos.long(), order)


def hoisted_orders(states0: SimState, pool: EnginePool, plan: HoistPlan,
                   ever_queued: torch.Tensor) -> torch.Tensor:
    """The (n_ti, J) static orders of ``plan``'s time-invariant forks."""
    ti_idx = torch.as_tensor(np.nonzero(np.asarray(plan, dtype=bool))[0],
                             device=ever_queued.device)
    states_ti = map_state(lambda x: x[ti_idx], states0)
    return static_priority_order(states_ti, _index_pool(pool, ti_idx),
                                 ever_queued[ti_idx])


def make_order_fn(states0: SimState, pool: EnginePool, plan: HoistPlan,
                  ever_queued: torch.Tensor,
                  ) -> Callable[[SimState], torch.Tensor]:
    """The per-event order stage, with static-key forks hoisted: their
    rows are ranked once over ``ever_queued`` and re-compacted
    queued-first per event; the other forks re-sort every event."""
    if plan is None:
        return lambda st: batched_priority_order(st, pool)
    dev = ever_queued.device
    plan_arr = np.asarray(plan, dtype=bool)
    ti_idx = torch.as_tensor(np.nonzero(plan_arr)[0], device=dev)
    hoisted = hoisted_orders(states0, pool, plan, ever_queued)

    if plan_arr.all():
        return lambda st: _compact_queued_first(hoisted,
                                                st.jobs.state == QUEUED)

    tv_idx = torch.as_tensor(np.nonzero(~plan_arr)[0], device=dev)
    pool_tv = _index_pool(pool, tv_idx)
    perm = np.concatenate([np.nonzero(plan_arr)[0],
                           np.nonzero(~plan_arr)[0]])
    inv = torch.as_tensor(np.argsort(perm), device=dev)

    def order_fn(st: SimState) -> torch.Tensor:
        compacted = _compact_queued_first(
            hoisted, (st.jobs.state == QUEUED)[ti_idx])
        st_tv = map_state(lambda x: x[tv_idx], st)
        fresh = batched_priority_order(st_tv, pool_tv)
        return torch.cat([compacted, fresh], 0)[inv]
    return order_fn


# ----------------------------------------------------------------------
# The engine.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DrainEngine:
    """Pluggable, policy-batched what-if engine on one device.

    backend : "reference" | "cuda" | "auto" (cuda on a CUDA device,
        reference on the CPU; the choice is logged).
    device : where the drains run (default "cuda"; raises if absent).
    dynamic_bounds : truncate the pass's rank walks at the deepest live
        queued rank each event (``des.pass_rank_limit``) — bit-exact.
    hoist_static : hoist the argsort of time-invariant forks out of the
        event loop — bit-exact.
    elide_empty : count a replay iteration's pass only where some live
        fork has a queued job (the reference skips the others; here
        they run, masked, which gives the same bits) — bit-exact.
    """

    backend: str = "auto"
    device: DeviceLike = "cuda"
    dynamic_bounds: bool = True
    hoist_static: bool = True
    elide_empty: bool = True

    def __post_init__(self) -> None:
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        if self.backend == "auto":
            resolved = "cuda" if dev.type == "cuda" else "reference"
            logger.info("DrainEngine backend='auto' resolved to %r "
                        "(device %s)", resolved, dev)
            object.__setattr__(self, "backend", resolved)
        if self.backend not in PASS_BACKENDS:
            raise ValueError(
                f"unknown pass backend {self.backend!r}; "
                f"registered: {sorted(PASS_BACKENDS)}")

    def pass_fn(self) -> PassFn:
        return PASS_BACKENDS[self.backend](self)

    def plan(self, pool: EnginePool) -> HoistPlan:
        return hoist_plan(pool, enabled=self.hoist_static)

    # -- drains --------------------------------------------------------
    def drain(self, state: SimState, pool: EnginePool) -> DrainResult:
        """Fork one snapshot across the pool and drain all forks."""
        plan = self.plan(pool)
        return _drain_impl(self, broadcast_state(state.to(self.device),
                                                 pool_size(pool)),
                           _pool_to(pool, self.device), plan)

    # -- decision cycles ----------------------------------------------
    def decide(self, state: SimState, pool: EnginePool,
               objective: ObjectiveLike = None, *,
               weights: Optional[scoring.ScoreWeights] = None) -> Decision:
        """One decision cycle under ``objective``: fork, drain, score,
        select, and the winner's first-event starts as ``run_mask``."""
        goal = resolve_goal(objective, weights)
        plan = self.plan(pool)      # host mask, memoized per pool
        return _decide_impl(self, state.to(self.device),
                            _pool_to(pool, self.device), goal, plan)

    # -- single pass (k=1) — the emulator's static baseline mode -------
    def schedule_pass_starts(self, state: SimState, policy) -> torch.Tensor:
        """Started mask (J,) for ONE policy on an unbatched state —
        deliberately uncompacted (full rank bound, fresh sort)."""
        pool = _pool_to(as_pool(policy), self.device)
        states = broadcast_state(state.to(self.device), 1)
        order = batched_priority_order(states, pool)
        return self.pass_fn()(states, order, None)[0]

    # -- trace replay (DESIGN.md §6) -----------------------------------
    def replay(self, scenario, pool, objective: ObjectiveLike = None, *,
               weights: Optional[scoring.ScoreWeights] = None
               ) -> ReplayOutcome:
        """Replay ONE scenario (an S=1 ``workload.ScenarioSet``) under
        every fork of ``pool``: a (P,)-leading outcome, bitwise P host
        emulator static-mode runs.  ``objective`` drives ``costs`` and
        ``best`` (the times do not depend on it)."""
        S = int(scenario.total_nodes.shape[0])
        if S != 1:
            raise ValueError(
                f"replay takes one scenario (got {S}); use replay_grid")
        return self._replay(scenario, pool, objective, weights, grid=False)

    def replay_grid(self, scenarios, pool, objective: ObjectiveLike = None,
                    *, weights: Optional[scoring.ScoreWeights] = None
                    ) -> ReplayOutcome:
        """The full (scenario × policy) grid, S·P forks in one batched
        replay: fork f = s·P + p, outcome axes (S, P); ``best[s]`` is the
        pool index the goal picks for scenario s."""
        return self._replay(scenarios, pool, objective, weights, grid=True)

    def _replay(self, scenarios, pool, objective, weights, grid: bool
                ) -> ReplayOutcome:
        goal = resolve_goal(objective, weights)
        pool = as_pool(pool)
        S = int(scenarios.total_nodes.shape[0])
        P = pool_size(pool)
        plan = self.plan(pool)                 # fork f = s·P + p
        res, metrics = _replay_impl(
            self, *replay_inputs(scenarios, pool, self.device),
            plan * S if plan is not None else None)
        costs, best = grid_select(goal, metrics, res.deadlocked, P)
        return _shape_outcome(res, metrics, (S, P) if grid else (P,),
                              costs, best)


def _drain_impl(engine: DrainEngine, states: SimState, pool: EnginePool,
                plan: HoistPlan = None) -> DrainResult:
    # mid-drain no new jobs appear: only slots queued at entry can ever
    # be queued — the tightest hoist domain
    order_fn = make_order_fn(states, pool, plan,
                             ever_queued=states.jobs.state == QUEUED)
    return simulate_to_drain_batched(states, order_fn, engine.pass_fn(),
                                     dynamic_bounds=engine.dynamic_bounds)


def _decide_impl(engine: DrainEngine, state: SimState, pool: EnginePool,
                 objective: Objective = DEFAULT_OBJECTIVE,
                 plan: HoistPlan = None) -> Decision:
    k = pool_size(pool)
    eval_mask = state.jobs.state == QUEUED
    res = _drain_impl(engine, broadcast_state(state, k), pool, plan)
    metrics = state_metrics(res.state, eval_mask)
    costs = objective.costs(metrics)
    costs = torch.where(res.deadlocked, torch.inf, costs)
    best = scoring.select_policy(costs)
    return Decision(
        policy_index=best,
        costs=costs,
        run_mask=res.first_started[best],
        metrics=metrics,
        deadlocked=res.deadlocked,
        # sorted like the reference's jitted dict output
        cost_terms=dict(sorted(objective.cost_terms(metrics).items())),
    )


# ----------------------------------------------------------------------
# Scenario-vectorized replay (DESIGN.md §6).
# ----------------------------------------------------------------------

def _assemble_replay_inputs(submit, nodes, est, true_rt, valid, totals,
                            pool: EnginePool, P: int):
    """Scenario-row tensors (S, J) -> the flat (k = S·P) replay inputs:
    each row repeats P times (fork f = s·P + p), the pool tiles once per
    row, and the job table is preloaded but fully INVALID."""
    rep = lambda x: x.repeat_interleave(P, dim=0)          # noqa: E731
    submit = rep(submit)                                    # (S*P, J)
    valid = rep(valid)
    k, J = submit.shape
    dev = submit.device
    jobs = JobTable(
        submit_t=submit,
        nodes=rep(nodes),
        est_runtime=rep(est),
        start_t=torch.full((k, J), TIME_NONE, dtype=torch.float32,
                           device=dev),
        end_t=torch.full((k, J), TIME_NONE, dtype=torch.float32,
                         device=dev),
        state=torch.zeros((k, J), dtype=torch.int32, device=dev),  # INVALID
    )
    states = SimState(jobs=jobs, free_nodes=rep(totals),
                      total_nodes=rep(totals),
                      now=torch.zeros((k,), dtype=torch.float32, device=dev))
    arrival_t = torch.where(valid, submit, torch.inf)
    S = totals.shape[0]
    return states, arrival_t, rep(true_rt), tile_pool(pool, S), valid


#: Per-``ScenarioSet`` memo of the host-to-device conversions of its six
#: arrays, one entry per device.  Keyed on object identity and evicted by
#: ``weakref.finalize`` when the set dies, never on a reused id.  Callers
#: must not mutate a set's arrays after its first replay.
_SCENARIO_ARRAY_CACHE: Dict[Tuple[int, str], Tuple] = {}


def _scenario_arrays(scenarios, device: torch.device) -> Tuple:
    key = (id(scenarios), str(device))
    hit = _SCENARIO_ARRAY_CACHE.get(key)
    if hit is not None:
        return hit
    cvt = lambda x, dt: torch.tensor(                      # noqa: E731
        np.asarray(x), dtype=dt, device=device)
    arrs = (cvt(scenarios.submit_t, torch.float32),
            cvt(scenarios.nodes, torch.int32),
            cvt(scenarios.est_runtime, torch.float32),
            cvt(scenarios.true_runtime, torch.float32),
            cvt(scenarios.valid, torch.bool),
            cvt(scenarios.total_nodes, torch.int32))
    try:
        weakref.finalize(scenarios, _SCENARIO_ARRAY_CACHE.pop, key, None)
    except TypeError:
        return arrs          # not weak-referenceable: serve uncached
    _SCENARIO_ARRAY_CACHE[key] = arrs
    return arrs


def replay_inputs(scenarios, pool: EnginePool, device: DeviceLike):
    """Device inputs of the flat (k = S·P) replay batch from a
    ``workload.ScenarioSet``-shaped object: (states, arrival_t, true_rt,
    tiled pool, valid).  The conversion of the scenario arrays is
    memoized per set (``_scenario_arrays``); the tiling runs per call."""
    dev = torch.device(device)
    return _assemble_replay_inputs(*_scenario_arrays(scenarios, dev),
                                   _pool_to(pool, dev), pool_size(pool))


def grid_select(objective: Objective, metrics: DrainMetrics,
                deadlocked: torch.Tensor, P: int):
    """Per-objective selection over a flat (k = S·P) replay batch: the
    metric fields reshaped to (S, P), the goal's costs over the policy
    axis (deadlocked forks at +inf), and the argmin per scenario."""
    grid = DrainMetrics(*(m.reshape(-1, P) for m in metrics))
    costs = objective.costs(grid)                               # (S, P)
    costs = torch.where(deadlocked.reshape(-1, P), torch.inf, costs)
    return costs, torch.argmin(costs, dim=-1)


def _replay_impl(engine: DrainEngine, states: SimState,
                 arrival_t: torch.Tensor, true_rt: torch.Tensor,
                 pool: EnginePool, valid: torch.Tensor,
                 plan: HoistPlan = None):
    # every slot with a finite arrival will be queued at some point (plus
    # any slot already queued at entry): the hoist domain
    ever_queued = torch.isfinite(arrival_t) | (states.jobs.state == QUEUED)
    order_fn = make_order_fn(states, pool, plan, ever_queued=ever_queued)
    res = simulate_replay_batched(
        states, arrival_t, true_rt, order_fn, engine.pass_fn(),
        dynamic_bounds=engine.dynamic_bounds,
        elide_empty=engine.elide_empty)
    return res, state_metrics(res.state, valid, true_rt)


def _shape_outcome(res: ReplayResult, metrics: DrainMetrics, shape,
                   costs: torch.Tensor, best: torch.Tensor) -> ReplayOutcome:
    rs = lambda x: x.reshape(shape + x.shape[1:])          # noqa: E731
    return ReplayOutcome(
        start_t=rs(res.state.jobs.start_t),
        end_t=rs(res.state.jobs.end_t),
        metrics=DrainMetrics(*(rs(m) for m in metrics)),
        deadlocked=rs(res.deadlocked),
        events=rs(res.events),
        result=res,
        costs=costs.reshape(shape),
        best=best.reshape(shape[:-1]),
    )
