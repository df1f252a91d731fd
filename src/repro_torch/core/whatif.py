"""Parallel what-if exploration (§3.3) — port of ``repro/core/whatif.py``.

The paper forks k simulator processes (one per policy) sharing one
database; here the forks are a leading batch axis drained in lock-step
by ``engine.DrainEngine``.  The public entry points:

  * ``decide`` / ``decide_ensemble`` — one scheduling cycle (the
    ensemble members ride the same batch axis: k·n_ens forks in one
    drain);
  * ``sharded_whatif`` — the fork axis split over the shards of a
    ``launch.mesh.FleetMesh``: each shard drains its contiguous chunk of
    the pool with its own hoist plan and pass bound, and selection runs
    on the concatenated result on the mesh's first device, so the winner
    keeps ``select_policy``'s first-occurrence tie-break over the whole
    pool;
  * ``sharded_replay_grid`` / ``sharded_fan_grid`` /
    ``sharded_race_grid`` / ``sharded_generation_costs`` — the fleet
    grids (DESIGN.md §9): the scenario (or fan-member, or race-window)
    axis cut into fixed-shape blocks, each block split over the shards,
    every piece a whole replay on its shard's device.  The pieces meet
    on the first device, and the metrics, costs and winners are computed
    once over the concatenated rows, exactly as the one-shot grid
    computes them, so every block size and shard count gives the
    one-shot grid's bits;
  * ``decide_legacy_vmap`` — the pre-engine path (the scalar DES once
    per pool entry), kept as a regression oracle of the batched engine.

The shards of a mesh run one after the other.
"""
from __future__ import annotations

import itertools
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.cluster.workload import (ScenarioSet, pad_scenarios,
                                          slice_scenarios)
from repro_torch.core import scoring
from repro_torch.core.des import (DrainMetrics, DrainResult, ReplayResult,
                                  broadcast_state, simulate_to_drain,
                                  state_metrics)
from repro_torch.core.engine import (Decision, DrainEngine, EnginePool,
                                     FanOutcome, ReplayOutcome,
                                     _assemble_replay_inputs, _drain_impl,
                                     _index_pool, _pool_to, _scenario_arrays,
                                     _shape_outcome, as_pool, fan_select,
                                     grid_select, pool_size, replay_run,
                                     scenario_arrays, select_decision,
                                     shard_local_plan)
from repro_torch.core.fan import normalize_fan, perturb_block, perturb_window
from repro_torch.core.objective import ObjectiveLike, resolve_goal
from repro_torch.core.policies import (PAPER_POOL, PolicyPool, PolicySpec,
                                       parse_pool)
from repro_torch.core.state import QUEUED, JobTable, SimState, map_state
from repro_torch.data.pipeline import prefetch
from repro_torch.device import DeviceLike, upload
from repro_torch.launch.mesh import FleetMesh

__all__ = ["Decision", "PolicyPool", "decide", "decide_ensemble",
           "decide_legacy_vmap", "sharded_whatif", "sharded_replay_grid",
           "sharded_fan_grid", "sharded_generation_costs",
           "sharded_race_grid", "paper_pool", "pool_array"]

#: Anything ``decide`` takes as a pool.
PoolArg = Union[PolicyPool, PolicySpec, str, torch.Tensor]


def _engine_pool(pool: PoolArg) -> EnginePool:
    if isinstance(pool, PolicyPool):
        return pool.spec
    if isinstance(pool, str):
        return parse_pool(pool).spec
    return pool  # PolicySpec stack or legacy id tensor


def decide(state: SimState, pool: PoolArg,
           objective: ObjectiveLike = None, *,
           weights: Optional[scoring.ScoreWeights] = None,
           engine: Optional[DrainEngine] = None,
           device: DeviceLike = "cuda") -> Decision:
    """One scheduling cycle: fork k sims, score, select, extract the
    qrun set.  Runs on ``engine`` if given, else on a new engine on
    ``device``."""
    engine = engine if engine is not None else DrainEngine(device=device)
    return engine.decide(state, _engine_pool(pool), objective,
                         weights=weights)


def decide_ensemble(state: SimState, pool: PoolArg, key: torch.Tensor,
                    n_ens: int = 8, noise: float = 0.3,
                    objective: ObjectiveLike = None, *,
                    weights: Optional[scoring.ScoreWeights] = None,
                    engine: Optional[DrainEngine] = None,
                    device: DeviceLike = "cuda") -> Decision:
    """Uncertainty-aware cycle: each of ``n_ens`` members rescales every
    job's estimate by a lognormal factor (σ = ``noise``) drawn from the
    (2,) threefry ``key`` (``prng.PRNGKey``); the policy cost is the goal
    of the member-mean metrics and the qrun set comes from member 0."""
    engine = engine if engine is not None else DrainEngine(device=device)
    return engine.decide_ensemble(
        state, _engine_pool(pool), key, n_ens=n_ens, noise=noise,
        objective=objective, weights=weights)


# ----------------------------------------------------------------------
# Legacy path: the scalar DES once per pool entry (pre-engine).  A
# regression oracle only — new code should use the engine.
# ----------------------------------------------------------------------

def decide_legacy_vmap(state: SimState, pool: PoolArg,
                       weights: scoring.ScoreWeights = scoring.PAPER_WEIGHTS,
                       *, engine: Optional[DrainEngine] = None,
                       device: DeviceLike = "cuda") -> Decision:
    """The reference's ``jax.vmap`` of the scalar ``des.simulate_to_drain``
    over the pool, as a loop: one scalar drain per entry, its pass the
    backend of ``engine`` (else of a new engine on ``device``: K1 on a
    card), the results stacked, scored with the paper's ``weights`` and
    the argmin selected.  It is independent of the batched engine's
    machinery (lock-step forks, hoisting, pass bounds) only: its pass is
    the engine's own, so it does not check K1 against the plain pass."""
    engine = engine if engine is not None else DrainEngine(device=device)
    pool = _pool_to(_engine_pool(pool), engine.device)
    state = state.to(engine.device)
    eval_mask = state.jobs.state == QUEUED
    pass_fn = engine.pass_fn()
    runs = [simulate_to_drain(state, _index_pool(pool, i), pass_fn)
            for i in range(pool_size(pool))]
    metrics = DrainMetrics(*(torch.stack(m) for m in zip(
        *(state_metrics(r.state, eval_mask) for r in runs))))
    dead = torch.stack([r.deadlocked for r in runs])
    costs = torch.where(dead, torch.inf,
                        scoring.policy_cost(metrics, weights))
    best = scoring.select_policy(costs)
    return Decision(
        policy_index=best,
        costs=costs,
        run_mask=torch.stack([r.first_started for r in runs])[best],
        metrics=metrics,
        deadlocked=dead,
    )


# ----------------------------------------------------------------------
# Fleet scale: shards and fixed-shape blocks (DESIGN.md §9).
# ----------------------------------------------------------------------

def _shards(mesh: FleetMesh, axis: str):
    """The devices that split the fork axis: one per shard of ``mesh``'s
    ``data`` axis.  ``axis`` keeps the reference's signature; a fleet
    mesh shards on ``data`` alone, so any other name is refused."""
    if axis != "data":
        raise ValueError(f"a FleetMesh shards on its 'data' axis only, "
                         f"not {axis!r}")
    return mesh.devices


def _mesh_engine(mesh: FleetMesh, engine: Optional[DrainEngine]
                 ) -> DrainEngine:
    """The engine whose backend every shard runs: the caller's, or the
    default one on the mesh's first device."""
    return engine if engine is not None else DrainEngine(device=mesh.home)


def _upload_pool(pool: EnginePool, dev: torch.device) -> EnginePool:
    if isinstance(pool, PolicySpec):
        return PolicySpec(upload(pool.family, dev), upload(pool.theta, dev))
    return upload(pool, dev, torch.int32)


def _cat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return xs[0] if len(xs) == 1 else torch.cat(list(xs))


def _cat_states(states: Sequence[SimState]) -> SimState:
    return SimState(
        jobs=JobTable(*(_cat(leaf) for leaf in zip(*(s.jobs
                                                     for s in states)))),
        free_nodes=_cat([s.free_nodes for s in states]),
        total_nodes=_cat([s.total_nodes for s in states]),
        now=_cat([s.now for s in states]))


def _decide_fleet(engine: DrainEngine, devices, state: SimState,
                  pool: EnginePool, objective, plan) -> Decision:
    """The sharded decision cycle: shard i forks the snapshot over its
    chunk of the pool and drains it on its device (shard-local hoist
    plan and pass bound); the drained forks meet on the first device,
    where selection runs over the whole pool."""
    k_local = pool_size(pool) // len(devices)
    home = devices[0]
    parts = []
    for i, dev in enumerate(devices):
        chunk = _pool_to(_index_pool(pool, slice(i * k_local,
                                                 (i + 1) * k_local)), dev)
        res = _drain_impl(engine, broadcast_state(state.to(dev), k_local),
                          chunk, plan)
        parts.append(DrainResult(res.state.to(home),
                                 *(x.to(home) for x in res[1:])))
    res = DrainResult(_cat_states([r.state for r in parts]),
                      *(_cat([getattr(r, f) for r in parts])
                        for f in DrainResult._fields[1:]))
    return select_decision(res, state.to(home).jobs.state == QUEUED,
                           objective)


def sharded_whatif(mesh: FleetMesh, axis: str = "data",
                   engine: Optional[DrainEngine] = None,
                   objective: ObjectiveLike = None, *,
                   weights: Optional[scoring.ScoreWeights] = None
                   ) -> Callable[[SimState, PoolArg], Decision]:
    """Fleet-scale what-if: the fork (policy) axis split over ``axis``
    of ``mesh``.  Returns a function with ``decide``'s signature whose
    pool size must be divisible by the shard count; bitwise ``decide``.
    A θ sweep splits like any pool: a ``PolicySpec`` stack's family and
    θ rows are cut together.  Static-key hoisting is shard-local
    (``engine.shard_local_plan``): every shard hoists its own chunk's
    time-invariant forks when the chunks agree, else every fork sorts
    per event — the same bits either way."""
    eng = _mesh_engine(mesh, engine)
    goal = resolve_goal(objective, weights)
    devices = _shards(mesh, axis)
    n_shards = len(devices)

    def wrapper(state: SimState, pool: PoolArg) -> Decision:
        pool = _engine_pool(pool)
        k = pool_size(pool)
        if k % n_shards:
            raise ValueError(f"pool size k={k} not divisible by "
                             f"{n_shards}-way '{axis}' axis")
        plan = shard_local_plan(eng.plan(pool), n_shards)
        return _decide_fleet(eng, devices, state, pool, goal, plan)

    return wrapper


class _Rows(NamedTuple):
    """Replayed fork rows gathered on the first device, with the inputs
    their metrics need."""
    res: ReplayResult
    true_rt: torch.Tensor
    valid: torch.Tensor


def _cat_rows(parts: Sequence[_Rows]) -> _Rows:
    """Concatenate pieces along the fork axis; ``iters`` and
    ``pass_invocations`` sum over them, as the reference sums them over
    (shard, block)."""
    res = ReplayResult(
        state=_cat_states([p.res.state for p in parts]),
        events=_cat([p.res.events for p in parts]),
        iters=sum(p.res.iters for p in parts),
        deadlocked=_cat([p.res.deadlocked for p in parts]),
        pass_invocations=sum(p.res.pass_invocations for p in parts))
    return _Rows(res, _cat([p.true_rt for p in parts]),
                 _cat([p.valid for p in parts]))


def _trim(rows: _Rows, n: int) -> _Rows:
    """The first ``n`` forks of a block (padding rows are the last)."""
    if rows.valid.shape[0] == n:
        return rows
    cut = lambda x: x[:n]                                   # noqa: E731
    res = rows.res._replace(state=map_state(cut, rows.res.state),
                            events=cut(rows.res.events),
                            deadlocked=cut(rows.res.deadlocked))
    return _Rows(res, cut(rows.true_rt), cut(rows.valid))


def _run_block(engine: DrainEngine, devices, plan, shard_inputs,
               n_keep: int) -> _Rows:
    """One fixed-shape block: shard i replays ``shard_inputs(i, device)``
    (its contiguous chunk of the block's forks, on its device) with the
    shard-local hoist plan, its own pass bound and its own early exit;
    the pieces meet on the first device and the block is trimmed to its
    first ``n_keep`` forks."""
    home = devices[0]
    parts = []
    for i, dev in enumerate(devices):
        states, arrival_t, true_rt, pool, valid = shard_inputs(i, dev)
        res = replay_run(engine, states, arrival_t, true_rt, pool, plan)
        parts.append(_Rows(
            ReplayResult(res.state.to(home), *(x.to(home) for x in res[1:])),
            true_rt.to(home), valid.to(home)))
    return _trim(_cat_rows(parts), n_keep)


def _scored(blocks: Sequence[_Rows]):
    """The streamed rows as one replay result and its metrics, computed
    over all rows at once, as the one-shot grid computes them."""
    rows = _cat_rows(blocks)
    return rows.res, state_metrics(rows.res.state, rows.valid, rows.true_rt)


def _synchronize(devices) -> None:
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _block_plan(plan_P, per_shard: int):
    """The hoist plan of one shard's piece: the pool's plan once per
    scenario row (the replay's plan is periodic in P)."""
    return plan_P * per_shard if plan_P is not None else None


def sharded_replay_grid(mesh: FleetMesh, axis: str = "data",
                        engine: Optional[DrainEngine] = None,
                        objective: ObjectiveLike = None, *,
                        weights: Optional[scoring.ScoreWeights] = None,
                        block_size: Optional[int] = None,
                        prefetch_depth: int = 2):
    """Fleet-scale replay: the SCENARIO axis of ``replay_grid`` split
    over ``axis`` of ``mesh`` and streamed in fixed-size blocks.

    Fork f = s·P + p, so cutting by scenario rows keeps each scenario's
    P policy forks on one shard.  ``block_size`` (scenarios a block,
    rounded up to the shard count) bounds every replay; ``None`` is one
    block of the whole set.  Any S works: the last block is padded with
    inert rows (``workload.pad_scenarios``) that are dropped before
    selection.  ``scenarios`` is a ``workload.ScenarioSet`` or an
    iterable of them (pre-cut blocks of one job capacity J, each at most
    the block size).

    With ``prefetch_depth > 0`` the ingest of block i+1 (slicing and
    padding, numpy only, plus whatever the iterable computes) runs on
    ``data.pipeline.prefetch``'s thread while block i replays; the
    upload to the devices and every torch call stay on this thread.
    ``prefetch_depth <= 0`` ingests inline and synchronises after every
    block (the ablation baseline).  The result is the same at any depth.

    Returns ``(scenarios, pool) -> ReplayOutcome``, bitwise
    ``replay_grid``'s, with ``iters``/``pass_invocations`` of the raw
    result summed over (shard, block) as the reference sums them."""
    eng = _mesh_engine(mesh, engine)
    goal = resolve_goal(objective, weights)
    devices = _shards(mesh, axis)
    n_shards = len(devices)

    def wrapper(scenarios, pool: PoolArg) -> ReplayOutcome:
        pool = as_pool(_engine_pool(pool))
        P = pool_size(pool)
        if isinstance(scenarios, ScenarioSet):
            S = scenarios.n_scenarios
            B = _round_up(block_size or S, n_shards)
            raw = (slice_scenarios(scenarios, lo, min(lo + B, S))
                   for lo in range(0, S, B))
        else:
            raw = iter(scenarios)
            try:
                head = next(raw)
            except StopIteration:
                raise ValueError("no scenario blocks") from None
            B = _round_up(block_size or head.n_scenarios, n_shards)
            raw = itertools.chain([head], raw)
        b = B // n_shards
        plan = _block_plan(eng.plan(pool), b)
        pools = {dev: _upload_pool(pool, dev) for dev in set(devices)}
        n_reals: List[int] = []

        def ingest():
            # numpy only on this thread: the uploads and the replay run
            # on the consumer's
            for blk in raw:
                n = blk.n_scenarios
                if n > B:
                    raise ValueError(
                        f"scenario block of {n} > block size {B}")
                n_reals.append(n)
                yield pad_scenarios(blk, B)

        stream = ingest()
        if prefetch_depth > 0:
            stream = prefetch(stream, depth=prefetch_depth)
        blocks = []
        for padded in stream:
            def shard_inputs(i, dev, padded=padded):
                rows = slice_scenarios(padded, i * b, (i + 1) * b)
                return _assemble_replay_inputs(*scenario_arrays(rows, dev),
                                               pools[dev], P)
            blocks.append(_run_block(eng, devices, plan, shard_inputs,
                                     n_reals[len(blocks)] * P))
            if prefetch_depth <= 0:
                _synchronize(devices)
        if not blocks:
            raise ValueError("no scenario blocks")
        res, metrics = _scored(blocks)
        costs, best = grid_select(goal, metrics, res.deadlocked, P)
        return _shape_outcome(res, metrics, (sum(n_reals), P), costs, best)

    return wrapper


def sharded_fan_grid(mesh: FleetMesh, axis: str = "data",
                     engine: Optional[DrainEngine] = None,
                     objective: ObjectiveLike = None, *,
                     fan=None, block_size: Optional[int] = None):
    """Fleet-scale Monte-Carlo fans (DESIGN.md §§9-10): ``fan_grid``'s
    pseudo-scenario axis (``g = s·F + φ``, G = S·F rows) split over the
    shards and streamed in fixed-size blocks.  Each shard expands its
    rows of a block on its device from the one uploaded base
    (``fan.perturb_block``; ids past S·F are inert padding), so there is
    no host ingest to overlap.  Member draws are keyed per (s, φ), so
    any block size gives ``fan_grid``'s bits.  ``fan`` is a ``FanSpec``
    or a bare int F; ``block_size`` counts pseudo-scenarios a block,
    rounded up to the shard count.  Returns ``(scenarios, pool) ->
    FanOutcome``."""
    eng = _mesh_engine(mesh, engine)
    goal = resolve_goal(objective)
    spec = normalize_fan(fan if fan is not None else 1)
    devices = _shards(mesh, axis)
    n_shards = len(devices)

    def wrapper(scenarios, pool: PoolArg) -> FanOutcome:
        pool = as_pool(_engine_pool(pool))
        P = pool_size(pool)
        S = int(scenarios.total_nodes.shape[0])
        F = spec.n
        G = S * F
        B = _round_up(block_size or G, n_shards)
        b = B // n_shards
        plan = _block_plan(eng.plan(pool), b)
        bases = {dev: _scenario_arrays(scenarios, dev)
                 for dev in set(devices)}
        pools = {dev: _upload_pool(pool, dev) for dev in set(devices)}
        blocks = []
        for lo in range(0, G, B):
            def shard_inputs(i, dev, lo=lo):
                g = lo + i * b + torch.arange(b, device=dev)
                rows = perturb_block(*bases[dev], spec, g, S)
                return _assemble_replay_inputs(*rows, pools[dev], P)
            blocks.append(_run_block(eng, devices, plan, shard_inputs,
                                     (min(lo + B, G) - lo) * P))
        res, metrics = _scored(blocks)
        member, costs, best, ci, width = fan_select(
            goal, metrics, res.deadlocked, F, P)
        rs = lambda x: x.reshape((S, F, P) + x.shape[1:])   # noqa: E731
        return FanOutcome(
            start_t=rs(res.state.jobs.start_t),
            end_t=rs(res.state.jobs.end_t),
            metrics=DrainMetrics(*(rs(m) for m in metrics)),
            deadlocked=rs(res.deadlocked),
            events=rs(res.events),
            result=res,
            member_costs=member, costs=costs, best=best,
            cost_ci=ci, fan_width=width)

    return wrapper


def sharded_generation_costs(mesh: FleetMesh, axis: str = "data",
                             engine: Optional[DrainEngine] = None,
                             objective: ObjectiveLike = None, *,
                             fan=None, block_size: Optional[int] = None,
                             prefetch_depth: int = 2):
    """The fleet twin of ``engine.generation_costs`` for the ``learn``
    trainer's ``eval_fn``: ``(scenarios, pool) -> (S, P) costs`` through
    ``sharded_replay_grid`` (``fan=None``) or ``sharded_fan_grid``, both
    bitwise the one-shot entry."""
    if fan is None:
        run = sharded_replay_grid(mesh, axis, engine, objective,
                                  block_size=block_size,
                                  prefetch_depth=prefetch_depth)
    else:
        run = sharded_fan_grid(mesh, axis, engine, objective, fan=fan,
                               block_size=block_size)
    return lambda scenarios, pool: run(scenarios, pool).costs


def sharded_race_grid(mesh: FleetMesh, axis: str = "data",
                      engine: Optional[DrainEngine] = None,
                      objective: ObjectiveLike = None, *,
                      race=None, block_size: Optional[int] = None):
    """Fleet-scale adaptive racing (DESIGN.md §§9-11): each rung of the
    successive-halving race streams its ``S·width`` member-window rows
    (row ``r = s·width + w`` is member ``lo + w`` of scenario s) through
    the same block runner, and ``race.run_race`` eliminates and stops
    between rungs exactly as ``race_grid`` does.  Window rows are keyed
    per (s, φ), so any block size on any mesh gives ``race_grid``'s
    rungs, members and winners.  ``race`` is a ``RaceSpec``, a
    ``FanSpec`` or a bare int F_max; ``block_size`` counts window rows a
    block, rounded up to the shard count.  Returns ``(scenarios, pool)
    -> race.RaceOutcome``."""
    from repro_torch.core.race import _sub_pool, normalize_race, run_race

    eng = _mesh_engine(mesh, engine)
    goal = resolve_goal(objective)
    spec = normalize_race(race if race is not None else 1)
    devices = _shards(mesh, axis)
    n_shards = len(devices)

    def wrapper(scenarios, pool: PoolArg):
        pool_full = as_pool(_engine_pool(pool))
        P = pool_size(pool_full)
        S = int(scenarios.total_nodes.shape[0])
        bases = {dev: _scenario_arrays(scenarios, dev)
                 for dev in set(devices)}
        sub_pools: dict = {}
        passes = [0]

        def eval_window(active, lo, hi):
            sub = _sub_pool(pool_full, active, P, sub_pools)
            Pa = pool_size(sub)
            width = hi - lo
            R = S * width
            B = _round_up(block_size or R, n_shards)
            b = B // n_shards
            plan = _block_plan(eng.plan(sub), b)
            pools = {dev: _upload_pool(sub, dev) for dev in set(devices)}
            blocks = []
            for blo in range(0, R, B):
                def shard_inputs(i, dev, blo=blo):
                    r = blo + i * b + torch.arange(b, device=dev)
                    rows = perturb_window(*bases[dev], spec.fan, r, lo,
                                          width, S)
                    return _assemble_replay_inputs(*rows, pools[dev], Pa)
                blocks.append(_run_block(eng, devices, plan, shard_inputs,
                                         (min(blo + B, R) - blo) * Pa))
            res, metrics = _scored(blocks)
            member = fan_select(goal, metrics, res.deadlocked, width, Pa)[0]
            # the rung's one read: member costs and the pass count together
            block = torch.cat([member.reshape(-1),
                               res.pass_invocations.reshape(1).float()])
            block = block.cpu().numpy()
            passes[0] += int(block[-1])
            return block[:-1].reshape(member.shape)

        out = run_race(spec, S, P, goal, eval_window)
        return out._replace(passes=passes[0])

    return wrapper


def paper_pool() -> torch.Tensor:
    return torch.tensor(PAPER_POOL, dtype=torch.int32)


def pool_array(ids: Sequence[int]) -> torch.Tensor:
    """Legacy id pool in the CALLER's order (position = tie-break)."""
    return torch.tensor(list(ids), dtype=torch.int32)
