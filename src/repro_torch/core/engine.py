"""Policy-batched drain engine with a table of backends —
port of ``repro/core/engine.py``.

Every decision cycle forks the synchronized snapshot into k what-if
simulations, one per candidate policy, and drains them all in lock-step
(``des.simulate_to_drain_batched``).  Per event:

  1. the order stage (``OrderStage``): each fork's priority keys and
     stable argsort, or, for a time-invariant fork, its order hoisted
     out of the loop and compacted queued-first;
  2. the sequential greedy + EASY-backfill pass on the batch axis;
  3. the step: starts are applied, each fork advances to its next
     predicted end, and the next rank limit is left on the device.

A backend (``BACKENDS``) names the entry of each stage; the order entries
share ``kernels.priority_order``'s signature, the pass entries
``backfill.schedule_pass_batched``'s and the step entries
``kernels.drain_step``'s (the drain's alone: the replay keeps its own
plain step):

  * ``reference`` — the plain versions, ``priority_order_plain``,
    ``schedule_pass_batched`` and ``drain_step_plain``;
  * ``cuda``      — the order kernel, ``kernels.priority_order``, K1,
    ``kernels.policy_eval.policy_eval_pass_batched``, and the step
    kernel, ``kernels.drain_step.drain_step`` (on CPU tensors all three
    run their plain versions);
  * ``auto``      — ``cuda`` on a CUDA device, ``reference`` on the CPU.

The engine owns a device (default ``cuda``): ``decide``/``drain`` copy
their state and pool there.  It also hosts the scenario-vectorized
replay (DESIGN.md §6): ``replay`` / ``replay_grid`` drive
``des.simulate_replay_batched`` over a ``workload.ScenarioSet``, with an
S-scenario axis stacked on the P-policy fork axis (fork f = s·P + p), so
a whole baseline grid is one batched replay.

Monte-Carlo decisions ride the same fork axis (DESIGN.md §§10-11):
``decide_ensemble`` (fork f = e·k + p, estimate noise from a threefry
key), ``decide_fan`` (f = φ·k + p, the ``fan.FanSpec`` perturbations),
``fan_grid``/``fan_window_grid`` (f = (s·F + φ)·P + p, the fan expanded
on the device from the base scenarios) and the races over them
(``core/race.py``).  Every fork of them runs the same backend, so on
``cuda`` each step is one order launch and one K1 launch at k = F·P or
S·F·P, and each drain iteration one step launch besides.  The fleet
entry points (``core/whatif.py``'s ``sharded_*``) split these grids
into fixed-shape blocks and shards over a
``launch.mesh.FleetMesh`` and run each piece through ``replay_run``;
``shard_local_plan`` gives a shard its hoist plan.
"""
from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import backfill as _bf
from repro_torch.core import prng, scoring, telemetry
from repro_torch.core.backfill import priority_order, static_priority_order
from repro_torch.core.des import (BatchedPassFn, DrainMetrics, DrainResult,
                                  DrainStepFn, ReplayResult, broadcast_state,
                                  simulate_replay_batched,
                                  simulate_to_drain_batched, state_metrics)
from repro_torch.core.fan import (FanSpec, _member_draws, failure_downs,
                                  lognormal_scale, normalize_fan,
                                  perturb_window)
from repro_torch.core.objective import (DEFAULT_OBJECTIVE, Objective,
                                        ObjectiveLike, as_distributional,
                                        resolve_goal)
from repro_torch.core.policies import PolicySpec, time_invariant_mask
from repro_torch.core.state import (QUEUED, TIME_NONE, JobTable, SimState,
                                    map_state)
from repro_torch.device import DeviceLike, resolve_device, upload
from repro_torch.kernels import drain_step as _ds
from repro_torch.kernels import policy_eval as _pe
from repro_torch.kernels import priority_order as _po

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
    """One scheduling cycle's outcome (tensors on the engine's device).

    Fan and ensemble decisions also stamp per-policy uncertainty
    computed on the device from the member costs: ``cost_ci`` the 95%
    normal CI half-width of the member mean (``1.96·σ/√F``; +inf when a
    member deadlocked), ``fan_width`` the worst − best member spread and
    ``fan_size`` the member count.  Single-future decisions leave them
    None/1."""
    policy_index: torch.Tensor   # index into the pool (NOT the policy id)
    costs: torch.Tensor          # (k,) per-policy objective cost
    run_mask: torch.Tensor       # bool (max_jobs,) jobs to start now
    metrics: DrainMetrics        # (k,)-leading metrics for telemetry
    deadlocked: torch.Tensor     # (k,) bool
    cost_terms: Optional[Dict[str, torch.Tensor]] = None  # term -> (k,)
    cost_ci: Optional[torch.Tensor] = None    # (k,) 95% CI half-width
    fan_width: Optional[torch.Tensor] = None  # (k,) member-cost spread
    fan_size: int = 1                         # members behind the costs


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


class FanOutcome(NamedTuple):
    """A (scenario × fan member × policy) Monte-Carlo grid (DESIGN.md
    §10) from ``DrainEngine.fan_grid``: leading axes (S, F, P), flat fork
    ``f = (s·F + φ)·P + p``, member φ=0 the unperturbed future.
    ``member_costs`` is the inner goal per member (deadlocked members at
    +inf), ``costs`` its distributional reduction over the fan axis,
    ``best`` the per-scenario argmin, ``cost_ci``/``fan_width`` the
    ``member_uncertainty`` stamps."""
    start_t: torch.Tensor        # f32 (S, F, P, J) — actual start times
    end_t: torch.Tensor          # f32 (S, F, P, J)
    metrics: DrainMetrics        # (S, F, P)-leading
    deadlocked: torch.Tensor     # bool (S, F, P)
    events: torch.Tensor         # i32 (S, F, P)
    result: Optional[ReplayResult]  # raw flat replay; None when the
                                    # outcome was assembled from pieces
    member_costs: torch.Tensor   # (S, F, P) inner costs per member
    costs: torch.Tensor          # (S, P) reduced distributional costs
    best: torch.Tensor           # (S,) per-scenario winning pool index
    cost_ci: torch.Tensor        # (S, P) 95% CI half-width
    fan_width: torch.Tensor      # (S, P) worst − best member cost


# ----------------------------------------------------------------------
# Backends: each names its order entry, its pass entry and its step entry.
# ----------------------------------------------------------------------

class Backend(NamedTuple):
    """A backend's three entries: ``order`` with the order kernel's
    signature (``kernels.priority_order``), ``pass_`` with the plain
    pass's (``backfill.schedule_pass_batched``), ``step`` with the drain
    step's (``kernels.drain_step``)."""
    order: Callable[..., torch.Tensor]
    pass_: Callable[..., Tuple]
    step: DrainStepFn


#: Each entry is looked up on its module at every call, so that a caller
#: that replaces a module's function sees each launch (``twinbench``'s
#: trace window and ``chip_smoke.py``'s spies wrap K1's entry).
BACKENDS: Dict[str, Backend] = {
    "reference": Backend(lambda *a: _po.priority_order_plain(*a),
                         lambda *a: _bf.schedule_pass_batched(*a),
                         lambda *a: _ds.drain_step_plain(*a)),
    "cuda": Backend(lambda *a: _po.priority_order(*a),
                    lambda *a: _pe.policy_eval_pass_batched(*a),
                    lambda *a: _ds.drain_step(*a)),
}


# ----------------------------------------------------------------------
# Static-key hoisting: forks whose keys never depend on the clock get
# their argsort computed once, outside the event loop.
# ----------------------------------------------------------------------

#: Per-fork "keys are time-invariant" bools decided on the host, or None.
HoistPlan = Optional[Tuple[bool, ...]]


def hoist_plan(pool: EnginePool) -> HoistPlan:
    """The static hoist plan of a pool (None when no fork qualifies)."""
    mask = time_invariant_mask(pool)
    if not mask.any():
        return None
    return tuple(bool(b) for b in mask)


def shard_local_plan(plan: HoistPlan, n_shards: int) -> HoistPlan:
    """A full-pool hoist plan cut for shards that each see one
    contiguous chunk of the fork axis: the common chunk when every
    shard's chunk is the same (a replay grid's plan is periodic in P, so
    its chunks always agree), else None — per-event sorting for all
    forks, which gives the same bits."""
    if plan is None or n_shards <= 1:
        return plan
    k = len(plan)
    if k % n_shards:
        return None
    chunk = k // n_shards
    first = plan[:chunk]
    for i in range(1, n_shards):
        if plan[i * chunk:(i + 1) * chunk] != first:
            return None
    return first if any(first) else None


def _index_pool(pool: EnginePool, idx) -> EnginePool:
    if isinstance(pool, PolicySpec):
        return PolicySpec(pool.family[idx], pool.theta[idx])
    return pool[idx]


class OrderStage:
    """The per-event order stage of the forks of ``states0``: one call of
    a backend's order entry (``order``, with the signature of
    ``kernels.priority_order``) on the job table as it stands.  The
    pool's rows, ``plan``'s static orders (ranked once over
    ``ever_queued``) and each fork's row among them are made once, here;
    the other forks re-sort every event."""

    def __init__(self, states0: SimState, pool: EnginePool, plan: HoistPlan,
                 ever_queued: torch.Tensor,
                 order: Callable[..., torch.Tensor]):
        dev = ever_queued.device
        k, J = states0.jobs.state.shape
        self.family, self.theta = _po.pool_rows(pool, dev)
        if plan is None:
            self.hoisted = torch.empty((0, J), dtype=torch.int32, device=dev)
            rows = np.full(k, -1)
        else:
            hoist = np.asarray(plan, dtype=bool)
            ti = upload(np.nonzero(hoist)[0], dev)
            self.hoisted = static_priority_order(
                map_state(lambda x: x[ti], states0), _index_pool(pool, ti),
                ever_queued[ti])
            rows = np.where(hoist, np.cumsum(hoist) - 1, -1)
        self.hoist_row = upload(rows, dev, torch.int32)
        self.order = order

    def __call__(self, st: SimState) -> torch.Tensor:
        jobs = st.jobs
        return self.order(jobs.state, jobs.submit_t, jobs.est_runtime,
                          jobs.nodes, st.now, self.family, self.theta,
                          self.hoisted, self.hoist_row)


# ----------------------------------------------------------------------
# The engine.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DrainEngine:
    """Policy-batched what-if engine on one device.

    backend : "reference" | "cuda" | "auto" (cuda on a CUDA device,
        reference on the CPU; the choice is logged): the row of
        ``BACKENDS`` whose entries run the order stage, the pass and
        the drain's step.
    device : where the drains run (default "cuda"; raises if absent).
    """

    backend: str = "auto"
    device: DeviceLike = "cuda"

    def __post_init__(self) -> None:
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        if self.backend == "auto":
            resolved = "cuda" if dev.type == "cuda" else "reference"
            logger.info("DrainEngine backend='auto' resolved to %r "
                        "(device %s)", resolved, dev)
            object.__setattr__(self, "backend", resolved)
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown pass backend {self.backend!r}; "
                f"known: {sorted(BACKENDS)}")
        object.__setattr__(self, "_entries", BACKENDS[self.backend])

    def pass_fn(self) -> BatchedPassFn:
        """The backend's pass entry on a batched ``SimState``."""
        run = self._entries.pass_

        def pass_fn(states: SimState, order: torch.Tensor, limit):
            jobs = states.jobs
            return run(order, jobs.state, jobs.nodes, jobs.est_runtime,
                       jobs.end_t, states.free_nodes, states.now, limit)[0]
        return pass_fn

    def step_fn(self) -> DrainStepFn:
        """The backend's drain step entry."""
        return self._entries.step

    def plan(self, pool: EnginePool) -> HoistPlan:
        return hoist_plan(pool)

    def order_fn(self, states0: SimState, pool: EnginePool, plan: HoistPlan,
                 ever_queued: torch.Tensor) -> OrderStage:
        """The per-event order stage over the forks of ``states0``, run
        by the backend's order entry."""
        return OrderStage(states0, pool, plan, ever_queued,
                          self._entries.order)

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
        order = priority_order(states, pool)
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

    # -- Monte-Carlo decisions (DESIGN.md §10) -------------------------
    def decide_ensemble(self, state: SimState, pool: EnginePool,
                        key: torch.Tensor, n_ens: int = 8,
                        noise: float = 0.3,
                        objective: ObjectiveLike = None, *,
                        weights: Optional[scoring.ScoreWeights] = None,
                        ) -> Decision:
        """One cycle over ``n_ens`` estimate-noise members: fork
        f = e·k + p drains policy p with member e's lognormal
        walltime-estimate factors, drawn from the (2,) threefry ``key``
        (``prng.PRNGKey``/``prng.split``).  The cost is the goal of the
        member-mean metrics; the qrun set comes from member 0."""
        goal = resolve_goal(objective, weights)
        d = _decide_ensemble(self, state.to(self.device),
                             _pool_to(pool, self.device),
                             key.to(self.device), n_ens, noise, goal,
                             self.plan(pool))
        return d._replace(fan_size=n_ens)

    def decide_fan(self, state: SimState, pool: EnginePool, fan,
                   objective: ObjectiveLike = None, *,
                   weights: Optional[scoring.ScoreWeights] = None
                   ) -> Decision:
        """One cycle over a fan of F perturbed futures per policy: fork
        f = φ·k + p drains policy p under member φ's estimate-noise and
        node-failure draws (member 0 exact; arrival warps do not apply
        to a drain).  Selection is the goal's distributional reduction
        of the member costs; the decision carries
        ``cost_ci``/``fan_width``/``fan_size``.  ``fan`` is a
        ``FanSpec`` or a bare int F."""
        goal = resolve_goal(objective, weights)
        spec = normalize_fan(fan)
        d = _decide_fan(self, state.to(self.device),
                        _pool_to(pool, self.device), spec, goal,
                        self.plan(pool))
        return d._replace(fan_size=spec.n)

    def fan_grid(self, scenarios, pool, fan,
                 objective: ObjectiveLike = None, *,
                 weights: Optional[scoring.ScoreWeights] = None
                 ) -> FanOutcome:
        """The Monte-Carlo fan grid: every (scenario, policy) cell of
        ``replay_grid`` under F perturbed futures, S·F·P forks in one
        batched replay, the fan expanded on the device from the base
        scenarios (fork ``f = (s·F + φ)·P + p``).  Any degenerate spec,
        ``FanSpec(n=1)`` included, is bitwise ``replay_grid``."""
        spec = normalize_fan(fan)
        return self._fan(scenarios, pool, spec, objective, weights,
                         0, spec.n)

    def fan_window_grid(self, scenarios, pool, fan,
                        objective: ObjectiveLike = None, *,
                        lo: int = 0, width: Optional[int] = None,
                        weights: Optional[scoring.ScoreWeights] = None
                        ) -> FanOutcome:
        """Replay only members ``φ ∈ [lo, lo+width)`` of the fan — the
        racing and pruning suffix.  Each member is bitwise the same
        member of the full ``fan_grid``; the outcome's reduction treats
        the window as the whole fan."""
        spec = normalize_fan(fan)
        if width is None:
            width = spec.n - lo
        if not (0 <= lo and lo + width <= spec.n and width >= 1):
            raise ValueError(
                f"member window [{lo}, {lo + width}) outside fan of "
                f"size {spec.n}")
        return self._fan(scenarios, pool, spec, objective, weights,
                         lo, width)

    def generation_costs(self, scenarios, pool,
                         objective: ObjectiveLike = None,
                         fan=None) -> torch.Tensor:
        """Per-(scenario, candidate) costs (S, P): ``replay_grid``'s, or
        with ``fan`` the distributional costs of ``fan_grid``."""
        if fan is None:
            return self.replay_grid(scenarios, pool, objective).costs
        return self.fan_grid(scenarios, pool, fan, objective).costs

    # -- adaptive racing (DESIGN.md §11) -------------------------------
    def race_grid(self, scenarios, pool, race,
                  objective: ObjectiveLike = None):
        """Successive-halving fan grid (``core/race.py``): a
        ``race.RaceOutcome``."""
        from repro_torch.core.race import race_grid as _race_grid
        return _race_grid(scenarios, pool, race, objective, engine=self)

    def decide_race(self, state: SimState, pool: EnginePool, race,
                    objective: ObjectiveLike = None):
        """One raced decision cycle: ``(Decision, race.RaceOutcome)``."""
        from repro_torch.core.race import decide_race as _decide_race
        return _decide_race(state, pool, race, objective, engine=self)

    def _fan(self, scenarios, pool, spec: FanSpec, objective, weights,
             lo: int, width: int) -> FanOutcome:
        goal = resolve_goal(objective, weights)
        pool = as_pool(pool)
        S = int(scenarios.total_nodes.shape[0])
        P = pool_size(pool)
        plan = self.plan(pool)            # fork f = (s·width + w)·P + p
        r = torch.arange(S * width, device=self.device)
        rows = perturb_window(*_scenario_arrays(scenarios, self.device),
                              spec, r, lo, width, S)
        res, metrics = _replay_impl(
            self, *_assemble_replay_inputs(
                *rows, _pool_to(pool, self.device), P),
            plan * (S * width) if plan is not None else None)
        member, costs, best, ci, cwidth = fan_select(
            goal, metrics, res.deadlocked, width, P)
        rs = lambda x: x.reshape((S, width, P) + x.shape[1:])  # noqa: E731
        return FanOutcome(
            start_t=rs(res.state.jobs.start_t),
            end_t=rs(res.state.jobs.end_t),
            metrics=DrainMetrics(*(rs(m) for m in metrics)),
            deadlocked=rs(res.deadlocked),
            events=rs(res.events),
            result=res,
            member_costs=member, costs=costs, best=best,
            cost_ci=ci, fan_width=cwidth)

    def _replay(self, scenarios, pool, objective, weights, grid: bool
                ) -> ReplayOutcome:
        """One grid, recorded as a ``grid`` span (``core.telemetry``)
        around the ``replay`` span of its loop."""
        with telemetry.SPANS.span("grid"):
            goal = resolve_goal(objective, weights)
            pool = as_pool(pool)
            S = int(scenarios.total_nodes.shape[0])
            P = pool_size(pool)
            plan = self.plan(pool)             # fork f = s·P + p
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
    order_fn = engine.order_fn(states, pool, plan,
                               ever_queued=states.jobs.state == QUEUED)
    return simulate_to_drain_batched(states, order_fn, engine.pass_fn(),
                                     engine.step_fn())


def _decide_impl(engine: DrainEngine, state: SimState, pool: EnginePool,
                 objective: Objective = DEFAULT_OBJECTIVE,
                 plan: HoistPlan = None) -> Decision:
    k = pool_size(pool)
    res = _drain_impl(engine, broadcast_state(state, k), pool, plan)
    return select_decision(res, state.jobs.state == QUEUED, objective)


def select_decision(res: DrainResult, eval_mask: torch.Tensor,
                    objective: Objective) -> Decision:
    """Score the k drained forks of ``res`` over ``eval_mask`` (the
    jobs queued at decision time), select the goal's argmin and take the
    winner's first-event starts."""
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


def _decide_ensemble(engine: DrainEngine, state: SimState, pool: EnginePool,
                     key: torch.Tensor, n_ens: int, noise: float,
                     objective: Objective = DEFAULT_OBJECTIVE,
                     plan: HoistPlan = None) -> Decision:
    """k·n_ens forks through one drain, fork f = e·k + p.  Member e's
    estimates are scaled by ``exp(noise·ε_e − noise²/2)``, with ``ε_0``
    set to 0 — as in the reference, whose member 0 therefore keeps the
    factor ``exp(−noise²/2)`` (ROADMAP C10)."""
    k = pool_size(pool)
    cap = state.jobs.capacity
    eps = prng.normal(key, (n_ens, cap))
    eps = torch.cat([torch.zeros_like(eps[:1]), eps[1:]])
    scale = prng.exp_f32(prng._fma(eps, noise, -(0.5 * noise * noise)))
    est_b = scale.repeat_interleave(k, 0) * state.jobs.est_runtime[None, :]

    states = broadcast_state(state, n_ens * k)
    states = states._replace(jobs=states.jobs._replace(est_runtime=est_b))
    eval_mask = state.jobs.state == QUEUED
    res = _drain_impl(engine, states, tile_pool(pool, n_ens),
                      plan * n_ens if plan is not None else None)
    member_metrics = DrainMetrics(*(
        m.reshape(n_ens, k) for m in state_metrics(res.state, eval_mask)))
    mean_metrics = DrainMetrics(*(m.mean(0) for m in member_metrics))
    member_dead = res.deadlocked.reshape(n_ens, k)
    dead = member_dead.any(0)
    costs = torch.where(dead, torch.inf, objective.costs(mean_metrics))
    best = scoring.select_policy(costs)
    # member costs back the CI/width stamps only: selection is the cost
    # of the MEAN metrics
    member_costs = torch.where(member_dead, torch.inf,
                               objective.costs(member_metrics))
    ci, width = member_uncertainty(member_costs, axis=0)
    return Decision(
        policy_index=best,
        costs=costs,
        run_mask=res.first_started.reshape(n_ens, k, cap)[0, best],
        metrics=mean_metrics,
        deadlocked=dead,
        cost_terms=dict(sorted(objective.cost_terms(mean_metrics).items())),
        cost_ci=ci,
        fan_width=width,
    )


def _fan_drain(engine: DrainEngine, state: SimState, pool: EnginePool,
               spec: FanSpec, objective: Objective, plan: HoistPlan,
               lo: int, width: int):
    """Members ``φ ∈ [lo, lo+width)`` of a drain-side fan through one
    drain, fork f = w·k + p (member φ = lo + w).  The draws are the
    replay fan's ``_member_draws`` chains at s=0 (a decision has one base
    snapshot): ``runtime_noise`` scales the walltime ESTIMATES (the
    drain's predicted ends) and ``failure_prob`` takes nodes away.
    Returns (result, member metrics, member deadlocks, member costs),
    each (width, k)-leading."""
    k = pool_size(pool)
    dist = as_distributional(objective)
    dev = state.now.device
    phi = lo + torch.arange(width, device=dev)
    states = broadcast_state(state, width * k)
    if not spec.degenerate:
        z, _, u = _member_draws(spec.seed, torch.zeros_like(phi), phi,
                                state.jobs.capacity)
        exact = phi == 0
        if spec.runtime_noise > 0.0:
            scale = lognormal_scale(z, spec.runtime_noise)   # (W, J)
            est = state.jobs.est_runtime[None, :]
            est_m = torch.where(exact[:, None], est, est * scale)
            states = states._replace(jobs=states.jobs._replace(
                est_runtime=est_m.repeat_interleave(k, 0)))
        if spec.failure_prob > 0.0:
            down = failure_downs(spec, torch.zeros_like(phi), phi, u,
                                 state.total_nodes.expand(width))
            down_b = down.repeat_interleave(k)
            states = states._replace(
                free_nodes=torch.clamp(states.free_nodes - down_b, min=0),
                total_nodes=torch.clamp(states.total_nodes - down_b, min=1))
    eval_mask = state.jobs.state == QUEUED
    res = _drain_impl(engine, states, tile_pool(pool, width),
                      plan * width if plan is not None else None)
    member_metrics = DrainMetrics(*(
        m.reshape(width, k) for m in state_metrics(res.state, eval_mask)))
    member_dead = res.deadlocked.reshape(width, k)
    member_costs = torch.where(member_dead, torch.inf,
                               dist.member_costs(member_metrics))
    return res, member_metrics, member_dead, member_costs


def _decide_fan(engine: DrainEngine, state: SimState, pool: EnginePool,
                spec: FanSpec, objective: Objective = DEFAULT_OBJECTIVE,
                plan: HoistPlan = None) -> Decision:
    """k·F forks through one drain (``_fan_drain`` over all F members);
    deadlocked members cost +inf, so a policy whose tail deadlocks is as
    bad as the reduction is risk-averse."""
    k = pool_size(pool)
    dist = as_distributional(objective)
    res, member_metrics, member_dead, member_costs = _fan_drain(
        engine, state, pool, spec, objective, plan, 0, spec.n)
    costs = dist.reduce_fan(member_costs)                    # (k,)
    best = scoring.select_policy(costs)
    ci, width = member_uncertainty(member_costs, axis=0)
    mean_metrics = DrainMetrics(*(m.mean(0) for m in member_metrics))
    return Decision(
        policy_index=best,
        costs=costs,
        run_mask=res.first_started.reshape(
            spec.n, k, state.jobs.capacity)[0, best],
        metrics=mean_metrics,
        deadlocked=member_dead.any(0),
        cost_terms=dict(sorted(dist.cost_terms(mean_metrics).items())),
        cost_ci=ci,
        fan_width=width,
    )


def _decide_fan_window(engine: DrainEngine, state: SimState,
                       pool: EnginePool, spec: FanSpec,
                       objective: Objective, plan: HoistPlan, lo: int,
                       width: int):
    """The drain-side racing rung: members ``[lo, lo+width)``, each
    bitwise the full fan's.  Returns (member costs (W, k), member
    deadlocks, member metrics, member 0's first-event starts (k, J)) for
    the race controller to accumulate."""
    k = pool_size(pool)
    res, member_metrics, member_dead, member_costs = _fan_drain(
        engine, state.to(engine.device), _pool_to(pool, engine.device),
        spec, objective, plan, lo, width)
    first0 = res.first_started.reshape(width, k, -1)[0]
    return member_costs, member_dead, member_metrics, first0


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


def scenario_arrays(scenarios, device: torch.device) -> Tuple:
    """The six scenario arrays of a ``ScenarioSet``-shaped object on
    ``device``, uncached (each upload waits for nothing on a card)."""
    return (upload(scenarios.submit_t, device, torch.float32),
            upload(scenarios.nodes, device, torch.int32),
            upload(scenarios.est_runtime, device, torch.float32),
            upload(scenarios.true_runtime, device, torch.float32),
            upload(scenarios.valid, device, torch.bool),
            upload(scenarios.total_nodes, device, torch.int32))


def _scenario_arrays(scenarios, device: torch.device) -> Tuple:
    key = (id(scenarios), str(device))
    hit = _SCENARIO_ARRAY_CACHE.get(key)
    if hit is not None:
        return hit
    arrs = scenario_arrays(scenarios, device)
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


def member_uncertainty(member_costs: torch.Tensor, axis: int = -2):
    """``(ci, width)`` over the fan axis of per-member costs: the 95%
    normal CI half-width of the member mean, ``1.96·σ/√F`` (population
    σ), and the worst − best spread.  A non-finite member (a deadlocked
    future) poisons both to +inf."""
    F = member_costs.shape[axis]
    fin = torch.isfinite(member_costs)
    finite = fin.all(axis)
    safe = torch.where(fin, member_costs, 0.0)
    dev = safe - safe.mean(axis, keepdim=True)
    std = prng.sqrt_f32((dev * dev).mean(axis))
    ci = 1.96 * std / float(np.sqrt(F))
    width = member_costs.amax(axis) - member_costs.amin(axis)
    return (torch.where(finite, ci, torch.inf),
            torch.where(finite, width, torch.inf))


def fan_select(objective: ObjectiveLike, metrics: DrainMetrics,
               deadlocked: torch.Tensor, F: int, P: int):
    """Distributional selection over a flat (k = S·F·P) fan batch: the
    inner goal per member (deadlocked members at +inf), the goal's
    reduction over the fan axis (plain goals lift to ``mean:``) and the
    argmin per scenario.  Returns ``(member_costs (S, F, P), costs
    (S, P), best (S,), ci, width)``."""
    dist = as_distributional(objective)
    grid = DrainMetrics(*(m.reshape(-1, F, P) for m in metrics))
    member = torch.where(deadlocked.reshape(-1, F, P), torch.inf,
                         dist.member_costs(grid))
    costs = dist.reduce_fan(member)
    ci, width = member_uncertainty(member, axis=-2)
    return member, costs, torch.argmin(costs, dim=-1), ci, width


def replay_run(engine: DrainEngine, states: SimState,
               arrival_t: torch.Tensor, true_rt: torch.Tensor,
               pool: EnginePool, plan: HoistPlan = None) -> ReplayResult:
    """The batched replay of prepared inputs on their device, under
    ``engine``'s backend."""
    # every slot with a finite arrival will be queued at some point (plus
    # any slot already queued at entry): the hoist domain
    ever_queued = torch.isfinite(arrival_t) | (states.jobs.state == QUEUED)
    order_fn = engine.order_fn(states, pool, plan, ever_queued=ever_queued)
    return simulate_replay_batched(states, arrival_t, true_rt, order_fn,
                                   engine.pass_fn())


def _replay_impl(engine: DrainEngine, states: SimState,
                 arrival_t: torch.Tensor, true_rt: torch.Tensor,
                 pool: EnginePool, valid: torch.Tensor,
                 plan: HoistPlan = None):
    res = replay_run(engine, states, arrival_t, true_rt, pool, plan)
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
