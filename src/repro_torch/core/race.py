"""Adaptive fan racing: successive halving over the fan (DESIGN.md §11)
— port of ``repro/core/race.py``.

A fixed-F fan spends ``S·F·P`` members per decision however obvious the
winner.  A race starts every policy at a low rung ``F₀``; after each rung
the per-policy costs and CIs over the members so far are computed
(``rung_stats``: the goal's distributional reduction plus
``engine.member_uncertainty``); policies whose CI lower bound exceeds
the incumbent's CI upper bound are eliminated; the fan doubles for the
survivors.  Member draws key on (seed, s, φ) only, so rung i+1 replays
only the new member suffix (``engine.fan_window_grid`` /
``engine._decide_fan_window``) and concatenates it with the members
already paid for: no (scenario, policy, member) triple is replayed
twice.

Elimination rule (per scenario s, incumbent i = argmin cost):

    drop p  iff  cost[s,p] − z·σₚ/√f  >  cost[s,i] + z·σᵢ/√f   (strict)

Exact ties never eliminate each other, and a non-finite bound (a +inf
member poisons the CI) never eliminates.  A policy leaves the replay
rectangle only when eliminated in every scenario, and a scenario's
incumbent is never eliminated there, so with an unbounded budget the
race returns the full fan's argmin whenever the CI rule held.

The race is anytime: it stops when every scenario's winner separates
from all surviving rivals, or when ``RaceSpec.budget_ms`` /
``max_members`` runs out, returning the current best with its achieved
confidence.  Each rung reads its member costs to the host once: that
read is where the host clock of ``budget_ms`` meets the device, and the
race adds no other.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fan import FanSpec, normalize_fan

__all__ = [
    "RaceSpec", "RungRecord", "RaceOutcome", "normalize_race",
    "rung_stats", "race_grid", "decide_race",
]


@dataclasses.dataclass(frozen=True)
class RaceSpec:
    """Racing schedule over a ``FanSpec``'s members: ``fan.n`` is F_max,
    the fidelity survivors reach when nothing separates."""

    fan: FanSpec = FanSpec(n=64)
    f0: int = 8                # rung-0 members (capped at fan.n)
    growth: int = 2            # fan multiplier between rungs
    z: float = 1.96            # CI multiplier for elimination/separation
    budget_ms: Optional[float] = None   # wall-clock budget per race
    max_members: Optional[int] = None   # (s, φ, p) triple budget per race

    def __post_init__(self) -> None:
        if self.f0 < 1:
            raise ValueError(f"f0 must be >= 1, got {self.f0}")
        if self.growth < 2:
            raise ValueError(f"growth must be >= 2, got {self.growth}")
        if self.z <= 0.0:
            raise ValueError("z must be positive")
        if self.budget_ms is not None and self.budget_ms <= 0.0:
            raise ValueError("budget_ms must be positive")
        if self.max_members is not None and self.max_members < 1:
            raise ValueError("max_members must be >= 1")

    @property
    def f_max(self) -> int:
        return self.fan.n

    def rungs(self) -> Tuple[Tuple[int, int], ...]:
        """The fixed member windows ``[(0, F₀), (F₀, F₀·g), ...]``,
        capped at F_max: rung i replays only ``[lo, hi)``."""
        hi = min(self.f0, self.f_max)
        out = [(0, hi)]
        while hi < self.f_max:
            lo, hi = hi, min(hi * self.growth, self.f_max)
            out.append((lo, hi))
        return tuple(out)


def normalize_race(race) -> RaceSpec:
    """A ``RaceSpec``, a ``FanSpec`` (raced to ``spec.n`` under the
    default schedule) or a bare int F_max (degenerate fan)."""
    if isinstance(race, RaceSpec):
        return race
    return RaceSpec(fan=normalize_fan(race))


class RungRecord(NamedTuple):
    """Accounting for one executed rung."""
    lo: int                      # member window replayed: [lo, hi)
    hi: int
    active: Tuple[int, ...]      # full-pool indices evaluated this rung
    members: int                 # (s, φ, p) triples replayed this rung
    eliminated: Tuple[int, ...]  # indices dropped from the rectangle
    separation: float            # min-scenario rival_lb − winner_ub
    wall_s: float


class RaceOutcome(NamedTuple):
    """What a race decided and what it paid (numpy: the controller is a
    host loop over device rungs).  Policy columns cover the surviving
    rectangle ``keep``; ``best`` is mapped back to full-pool indices."""
    member_costs: np.ndarray     # (S, fan_size, len(keep)) accumulated
    costs: np.ndarray            # (S, len(keep)) reduced at fan_size
    best: np.ndarray             # (S,) winners as FULL-pool indices
    cost_ci: np.ndarray          # (S, len(keep)) z-scaled CI half-width
    fan_width: np.ndarray        # (S, len(keep)) member-cost spread
    keep: np.ndarray             # surviving full-pool indices
    rungs: Tuple[RungRecord, ...]
    members: int                 # triples replayed across all rungs
    members_full: int            # S·F_max·P — the fixed-F bill
    fan_size: int                # members behind costs (last rung's hi)
    separated: bool              # every scenario separated at the end
    separation: np.ndarray       # (S,) achieved rival_lb − winner_ub
    stopped: str  # 'separated' | 'budget_ms' | 'max_members' | 'exhausted'
    passes: int = 0              # scheduling passes across all rungs


def rung_stats(objective, member, z: float = 1.96):
    """Per-policy decision stats over the (S, f, Pa) members so far: the
    goal's distributional reduction, and the z-scaled CI half-width and
    member spread (``engine.member_uncertainty`` gives ``1.96·σ/√f``).
    Runs on the host copy of the members; a +inf member poisons its
    cell's CI and width to +inf."""
    from repro_torch.core.engine import member_uncertainty
    from repro_torch.core.objective import as_distributional
    # C order, as the engine's fan_select reduces it: torch sums a
    # transposed layout in another order (numpy's fancy indexing of the
    # member buffer returns one)
    m = torch.as_tensor(np.ascontiguousarray(member, np.float32))
    costs = as_distributional(objective).reduce_fan(m)
    ci, width = member_uncertainty(m, axis=-2)
    return costs.numpy(), (ci * (z / 1.96)).numpy(), width.numpy()


def _separation(costs: np.ndarray, ci: np.ndarray) -> np.ndarray:
    """(S,) how far the winner's CI upper bound sits below every rival's
    lower bound; positive ⇒ settled at z confidence.  +inf with a single
    column; non-finite bound arithmetic counts as unseparated."""
    S, Pa = costs.shape
    if Pa == 1:
        return np.full(S, np.inf, np.float32)
    with np.errstate(invalid="ignore"):
        lb = costs - ci
        ub = costs + ci
        rows = np.arange(S)
        inc = np.argmin(costs, axis=1)
        lb_rivals = lb.copy()
        lb_rivals[rows, inc] = np.inf
        sep = lb_rivals.min(axis=1) - ub[rows, inc]
    return np.where(np.isnan(sep), -np.inf, sep).astype(np.float32)


def run_race(spec: RaceSpec, S: int, P: int, objective,
             eval_window: Callable[[np.ndarray, int, int], np.ndarray],
             on_rung: Optional[Callable] = None,
             clock: Callable[[], float] = time.perf_counter
             ) -> RaceOutcome:
    """The racing controller shared by the grid and drain surfaces.
    ``eval_window(active, lo, hi)`` replays only members ``φ ∈ [lo, hi)``
    for the full-pool indices ``active`` and returns their (S, hi−lo,
    len(active)) member costs on the host; accumulation, elimination,
    separation and budgets happen here.  ``on_rung(active, costs, ci,
    width)`` (after the rung, before the drop) lets callers keep the
    stats of eliminated columns.  ``clock`` is injectable for tests."""
    schedule = spec.rungs()
    active = np.arange(P)
    elim = np.zeros((S, P), bool)        # per-scenario CI eliminations
    buf = np.full((S, spec.f_max, P), np.nan, np.float32)
    rungs = []
    spent = 0
    rows = np.arange(S)
    t0 = clock()
    stopped = "exhausted"
    costs = ci = width = None
    f_done = 0

    for lo, hi in schedule:
        w = hi - lo
        if lo > 0:       # rung 0 always runs: anytime ⇒ SOME answer
            if (spec.budget_ms is not None
                    and (clock() - t0) * 1e3 >= spec.budget_ms):
                stopped = "budget_ms"
                break
            if (spec.max_members is not None
                    and spent + S * w * len(active) > spec.max_members):
                stopped = "max_members"
                break
        t_r = clock()
        # the window being paid for has never been evaluated: no
        # (s, φ, p) triple is replayed twice, enforced on every surface
        if not np.isnan(buf[:, lo:hi, :][:, :, active]).all():
            raise RuntimeError(
                f"racing window [{lo}, {hi}) would replay an already-"
                f"evaluated member")
        mc = np.asarray(eval_window(active, lo, hi), np.float32)
        buf[:, lo:hi, active] = mc
        spent += S * w * len(active)
        f_done = hi
        cur = buf[:, :hi, :][:, :, active]           # (S, hi, Pa)
        costs, ci, width = rung_stats(objective, cur, spec.z)
        if on_rung is not None:
            on_rung(active, costs, ci, width)

        # strict ``>`` (ties survive) on possibly non-finite bounds
        # (``nan > x`` is False); each scenario's incumbent is immune
        inc = np.argmin(costs, axis=1)
        with np.errstate(invalid="ignore"):
            kill = (costs - ci) > (costs + ci)[rows, inc][:, None]
        kill[rows, inc] = False
        el = elim[:, active] | kill
        elim[:, active] = el
        survives = ~el.all(axis=0)                   # (Pa,)
        dropped = active[~survives]
        sep = _separation(costs, ci)
        rungs.append(RungRecord(
            lo=lo, hi=hi, active=tuple(int(i) for i in active),
            members=S * w * len(active),
            eliminated=tuple(int(i) for i in dropped),
            separation=float(sep.min()), wall_s=clock() - t_r))

        # carry only the survivors' stats, so a budget stop on the next
        # rung still reports a consistent rectangle
        active = active[survives]
        costs, ci, width = (x[:, survives] for x in (costs, ci, width))
        if len(active) == 1 or sep.min() > 0.0:
            stopped = "separated"
            break

    sep = _separation(costs, ci)
    best_col = np.argmin(costs, axis=1)
    return RaceOutcome(
        member_costs=buf[:, :f_done, :][:, :, active],
        costs=costs,
        best=active[best_col],
        cost_ci=ci,
        fan_width=width,
        keep=active,
        rungs=tuple(rungs),
        members=spent,
        members_full=S * spec.f_max * P,
        fan_size=f_done,
        separated=bool((sep > 0.0).all()),
        separation=sep,
        stopped=stopped,
    )


def _sub_pool(pool, active: np.ndarray, P: int, cache: dict):
    """The pool restricted to the ascending full-pool indices ``active``
    (memoized per rectangle, so each survivor set is indexed once)."""
    from repro_torch.core import engine as _eng
    key = tuple(int(i) for i in active)
    sub = cache.get(key)
    if sub is None:
        dev = getattr(pool, "family", pool).device
        sub = (pool if len(active) == P else _eng._index_pool(
            pool, torch.as_tensor(active, device=dev)))
        cache[key] = sub
    return sub


# ----------------------------------------------------------------------
# Grid surface: the raced replay grid.
# ----------------------------------------------------------------------

def race_grid(scenarios, pool, race, objective=None, *,
              engine=None, clock: Callable[[], float] = time.perf_counter
              ) -> RaceOutcome:
    """Race the (scenario × policy) fan grid: rung suffixes come from
    ``engine.fan_window_grid`` over the surviving sub-pool (ascending
    indices, so the argmin tie-break matches the full pool's)."""
    from repro_torch.core import engine as _eng
    from repro_torch.core.objective import resolve_goal
    eng = engine if engine is not None else _eng.DrainEngine()
    spec = normalize_race(race)
    goal = resolve_goal(objective)
    pool = _eng.as_pool(pool)
    P = _eng.pool_size(pool)
    S = int(scenarios.total_nodes.shape[0])
    sub_pools = {}
    passes = [0]

    def eval_window(active, lo, hi):
        sub = _sub_pool(pool, active, P, sub_pools)
        out = eng.fan_window_grid(scenarios, sub, spec.fan, goal,
                                  lo=lo, width=hi - lo)
        # the rung's one read: member costs and the pass count together
        block = torch.cat([out.member_costs.reshape(-1),
                           out.result.pass_invocations.reshape(1).float()])
        block = block.cpu().numpy()
        passes[0] += int(block[-1])
        return block[:-1].reshape(out.member_costs.shape)

    out = run_race(spec, S, P, goal, eval_window, clock=clock)
    return out._replace(passes=passes[0])


# ----------------------------------------------------------------------
# Drain surface: the raced decision cycle.
# ----------------------------------------------------------------------

def decide_race(state, pool, race, objective=None, *, engine=None,
                clock: Callable[[], float] = time.perf_counter):
    """One raced decision cycle: ``decide_fan``'s member fan grown rung by
    rung (``engine._decide_fan_window``).  Returns ``(Decision,
    RaceOutcome)``: the decision spans the full pool (eliminated
    policies keep the costs/CI of their elimination rung), ``fan_size``
    is the fidelity the survivors reached, and the qrun set comes from
    member 0 of the winner (member 0 is exact and always in rung 0)."""
    from repro_torch.core import engine as _eng
    from repro_torch.core.des import DrainMetrics
    from repro_torch.core.objective import as_distributional, resolve_goal
    eng = engine if engine is not None else _eng.DrainEngine()
    spec = normalize_race(race)
    goal = resolve_goal(objective)
    dist = as_distributional(goal)
    pool = _eng.as_pool(pool)
    k = _eng.pool_size(pool)
    n_metrics = len(DrainMetrics._fields)

    sub_pools = {}
    full = {"costs": np.full(k, np.inf, np.float32),
            "ci": np.full(k, np.inf, np.float32),
            "width": np.full(k, np.inf, np.float32)}
    dead = np.zeros(k, bool)
    msum = np.zeros((n_metrics, k), np.float64)
    mcount = np.zeros(k, np.int64)
    first0 = {}

    def eval_window(active, lo, hi):
        sub = _sub_pool(pool, active, k, sub_pools)
        W, Pa = hi - lo, len(active)
        mc, md, mm, f0 = _eng._decide_fan_window(
            eng, state, sub, spec.fan, goal, eng.plan(sub), lo, W)
        # the rung's one read: member costs, deadlocks, metrics and
        # member 0's starts travel as one f32 block
        parts = [mc, md.float(), torch.stack(tuple(mm))]
        if lo == 0:
            parts.append(f0.float())
        block = torch.cat([x.reshape(-1) for x in parts]).cpu().numpy()
        mc = block[:W * Pa].reshape(W, Pa)
        md = block[W * Pa:2 * W * Pa].reshape(W, Pa) > 0.5
        end = (2 + n_metrics) * W * Pa
        mm = block[2 * W * Pa:end].reshape(n_metrics, W, Pa)
        if lo == 0:
            first0["mask"] = block[end:].reshape(k, -1) > 0.5
        dead[active] |= md.any(axis=0)
        _scatter_add(msum, active, mm.sum(axis=1, dtype=np.float64))
        mcount[active] += W
        return mc[None]                      # (S=1, W, Pa)

    def on_rung(active, costs, ci, width):
        full["costs"][active] = costs[0]
        full["ci"][active] = ci[0]
        full["width"][active] = width[0]

    out = run_race(spec, 1, k, goal, eval_window, on_rung=on_rung,
                   clock=clock)

    dev = eng.device
    mean = msum / np.maximum(mcount, 1)
    mean_metrics = DrainMetrics(*(
        torch.as_tensor(row, dtype=torch.float32, device=dev)
        for row in mean))
    best = int(out.best[0])
    as_dev = lambda a: torch.as_tensor(a, device=dev)     # noqa: E731
    decision = _eng.Decision(
        policy_index=as_dev(best),
        costs=as_dev(full["costs"]),
        run_mask=as_dev(first0["mask"][best]),
        metrics=mean_metrics,
        deadlocked=as_dev(dead),
        # the goal's own term order: the reference assembles this
        # decision outside a compiled function, which keeps it
        cost_terms=dist.cost_terms(mean_metrics),
        cost_ci=as_dev(full["ci"]),
        fan_width=as_dev(full["width"]),
        fan_size=out.fan_size,
    )
    return decision, out


def _scatter_add(acc: np.ndarray, idx: np.ndarray, val: np.ndarray):
    """``acc[:, idx] += val`` in place (metric sums per policy column)."""
    np.add.at(acc, (slice(None), idx), val)
