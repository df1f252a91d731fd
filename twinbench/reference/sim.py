"""The twin's what-if semantics in plain PyTorch: the candidate pool, the
priority keys, one greedy + EASY-backfill pass, the drain of a decision
fork, the trace replay of a scenario fork, the metrics, the paper's score
and the fan's CVaR.

Every fork carries the job table of ``max_jobs`` slots (slot j is job j):
submission, nodes, walltime estimate, start and end times in float32,
node counts and lifecycle codes in int32, exactly as the twin's contract
states them.  The backfill pass is written from its definition (greedy in
priority order until the first job that does not fit, the head; its
reservation from running jobs sorted by (predicted end, slot); later jobs
start iff they fit now and end by the reservation or fit the surplus), with
a sort in place of the quadratic count.  Nothing here is tuned: keys are
sorted afresh on every event, every rank is walked, every fork runs every
step.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from twinbench.reference import draws

INVALID, QUEUED, RUNNING, DONE = 0, 1, 2, 3
TIME_NONE = -1.0
INT32_MAX = 2**31 - 1
SLOWDOWN_TAU = 10.0
EST_FLOOR = 1.0
AGING_CAP = 30.0
WT_SCALE = 1.0 / 60.0

# ----------------------------------------------------------------------
# The pool: (family, theta) rows.  Theta holds the six linear feature
# weights (wait, est, nodes, area, xfactor, submit), then a, b, tau.
# ----------------------------------------------------------------------
FAM_LIN, FAM_WFP, FAM_EXP = 0, 1, 2
FEATURES = ("wait", "est", "nodes", "area", "xfactor", "submit")
TH_A, TH_B, TH_TAU = 6, 7, 8
_FAMILY_PARAMS = {"a": TH_A, "b": TH_B, "tau": TH_TAU}


def _theta(**kw) -> np.ndarray:
    th = np.zeros(9, dtype=np.float32)
    th[TH_TAU] = np.inf
    for k, v in kw.items():
        th[_FAMILY_PARAMS.get(k, None) or FEATURES.index(k)] = v
    return th


STATIC = {   # name: (family, theta)
    "WFP": (FAM_WFP, _theta(a=3.0, b=1.0)),
    "FCFS": (FAM_LIN, _theta(submit=1.0)),
    "SJF": (FAM_LIN, _theta(est=1.0)),
    "SAF": (FAM_LIN, _theta(area=1.0)),
    "LJF": (FAM_LIN, _theta(est=-1.0)),
    "LXF": (FAM_LIN, _theta(xfactor=-1.0)),
    "EXPF": (FAM_EXP, _theta(tau=3600.0)),
}
GROUPS = {"paper": ("WFP", "FCFS", "SJF"),
          "extended": ("WFP", "FCFS", "SJF", "SAF", "LJF", "LXF", "EXPF")}


class Pool(NamedTuple):
    family: torch.Tensor   # i32 (k,)
    theta: torch.Tensor    # f32 (k, 9)
    names: Tuple[str, ...]

    def to(self, device) -> "Pool":
        return Pool(self.family.to(device), self.theta.to(device),
                    self.names)

    def tile(self, n: int) -> "Pool":
        """The pool repeated n times: fork f = w·k + p."""
        return Pool(self.family.repeat(n), self.theta.repeat(n, 1),
                    self.names * n)


def _sweep(text: str) -> List[float]:
    if ".." not in text:
        return [float(text)]
    lo, rest = text.split("..", 1)
    hi, n = rest.rsplit("x", 1)
    return [float(v) for v in np.linspace(float(lo), float(hi), int(n))]


def pool(spec: str) -> Pool:
    """The pool a configuration names: comma-separated terms, each a group
    (``paper``, ``extended``), a static name, or a WFP sweep such as
    ``wfp:a=1..5x5:tau=600..7200x5`` (every combination, ``a`` outer)."""
    fam, th, names = [], [], []
    for term in filter(None, (t.strip() for t in spec.split(","))):
        head, *assigns = term.split(":")
        if not assigns:
            for name in GROUPS.get(head.lower(), (head.upper(),)):
                f, t = STATIC[name]
                fam.append(f), th.append(t), names.append(name)
            continue
        if head.lower() != "wfp":
            raise ValueError(f"the reference sweeps only wfp, not {term!r}")
        keys = [a.split("=", 1)[0] for a in assigns]
        grids = [_sweep(a.split("=", 1)[1]) for a in assigns]
        for combo in itertools.product(*grids):
            kw = dict(zip(keys, combo))
            fam.append(FAM_WFP)
            th.append(_theta(**{"a": 3.0, "b": 1.0, **kw}))
            names.append("wfp[" + ",".join(f"{k}={v:g}" for k, v in
                                            zip(keys, combo)) + "]")
    return Pool(torch.tensor(fam, dtype=torch.int32),
                torch.from_numpy(np.stack(th)), tuple(names))


# ----------------------------------------------------------------------
# Forks: a batch of job tables with a leading fork axis.
# ----------------------------------------------------------------------
class Forks(NamedTuple):
    submit: torch.Tensor   # f32 (k, J)
    nodes: torch.Tensor    # i32 (k, J)
    est: torch.Tensor      # f32 (k, J)
    start: torch.Tensor    # f32 (k, J)
    end: torch.Tensor      # f32 (k, J)
    state: torch.Tensor    # i32 (k, J)
    free: torch.Tensor     # i32 (k,)
    total: torch.Tensor    # i32 (k,)
    now: torch.Tensor      # f32 (k,)


def _pow(x, p):
    return torch.where(p == 1.0, x,
           torch.where(p == 2.0, x * x,
           torch.where(p == 3.0, x * x * x, torch.pow(x, p))))


def keys(f: Forks, pl: Pool) -> torch.Tensor:
    """Priority keys (k, J), lower runs first: the linear feature term
    plus the family's negated utility."""
    wait = (f.now[:, None] - f.submit).clamp_min(0.0)
    est = f.est.clamp_min(EST_FLOOR)
    nodes = f.nodes.to(torch.float32)
    cols = [wait, est, nodes, nodes * est, (wait + est) / est, f.submit]
    th = pl.theta
    lin = cols[0] * th[:, 0, None]
    for c in range(1, 6):
        lin = lin + cols[c] * th[:, c, None]
    aged = (wait / th[:, TH_TAU, None]).clamp_max(AGING_CAP)
    wfp = -(_pow(wait / est, th[:, TH_A, None])
            * _pow(nodes, th[:, TH_B, None]) * torch.exp(aged))
    fam = pl.family[:, None]
    nl = torch.where(fam == FAM_WFP, wfp,
         torch.where(fam == FAM_EXP, -torch.expm1(aged),
                     torch.zeros_like(wfp)))
    return lin + nl


def order(f: Forks, pl: Pool) -> torch.Tensor:
    """Queued slots by key (ties by slot), every other slot after them."""
    k = torch.where(f.state == QUEUED, keys(f, pl), torch.inf)
    return torch.argsort(k, dim=1, stable=True)


def easy_pass(f: Forks, idx: torch.Tensor) -> torch.Tensor:
    """The slots each fork starts now under priority order ``idx``."""
    k, J = idx.shape
    dev = idx.device
    ranks = torch.arange(J, device=dev)
    q = torch.gather(f.state == QUEUED, 1, idx)
    n_rank = torch.gather(f.nodes, 1, idx)
    # greedy: a queued rank starts iff the queued demand up to it fits
    need = torch.cumsum(torch.where(q, n_rank, 0), 1)
    fits = need <= f.free[:, None]
    blocked = q & ~fits
    head_found = blocked.any(1)
    head_rank = torch.where(blocked, ranks, J).amin(1)
    greedy = q & fits
    free1 = f.free - torch.where(greedy, n_rank, 0).sum(1).to(torch.int32)
    head_nodes = torch.where(
        head_found,
        torch.gather(n_rank, 1, head_rank.clamp_max(J - 1)[:, None])[:, 0],
        0)
    # reservation: running and just-started jobs by (predicted end, slot)
    started0 = torch.zeros_like(greedy).scatter(1, idx, greedy)
    running = (f.state == RUNNING) | started0
    end_eff = torch.where(started0, f.now[:, None] + f.est, f.end)
    end_eff = torch.where(running, end_eff, torch.inf)
    by_end = torch.argsort(end_eff, dim=1, stable=True)
    e_sorted = torch.gather(end_eff, 1, by_end)
    cum = free1[:, None] + torch.cumsum(
        torch.gather(torch.where(running, f.nodes, 0), 1, by_end), 1)
    feasible = (cum >= head_nodes[:, None]) & torch.isfinite(e_sorted)
    any_feasible = feasible.any(1)
    first = torch.where(feasible, ranks, J).amin(1).clamp_max(J - 1)
    shadow = torch.where(head_found & any_feasible,
                         torch.gather(e_sorted, 1, first[:, None])[:, 0],
                         torch.inf)
    cum_first = torch.gather(cum, 1, first[:, None])[:, 0]
    extra = torch.where(head_found & any_feasible, cum_first - head_nodes,
                        torch.where(head_found, 0, INT32_MAX // 2))
    # backfill: later queued jobs, in priority order
    cond_a = (f.now[:, None] + torch.gather(f.est, 1, idx)) <= shadow[:, None]
    cand = (head_found[:, None] & (ranks > head_rank[:, None]) & q & ~greedy
            & (n_rank <= free1[:, None])
            & (cond_a | (n_rank <= extra[:, None])))
    n_cand = int(cand.sum(1).max()) if k else 0
    walk = torch.argsort((~cand).to(torch.int8), dim=1, stable=True)
    walk = walk[:, :n_cand]
    c_live = torch.gather(cand, 1, walk)
    c_nodes = torch.gather(n_rank, 1, walk)
    c_a = torch.gather(cond_a, 1, walk)
    free = free1.to(torch.int64)
    extra = extra.to(torch.int64)
    took = torch.zeros_like(c_live)
    for c in range(n_cand):
        nd = c_nodes[:, c]
        go = c_live[:, c] & (nd <= free) & (c_a[:, c] | (nd <= extra))
        free = free - torch.where(go, nd, 0)
        extra = extra - torch.where(go & ~c_a[:, c], nd, 0)
        took[:, c] = go
    started_rank = greedy.clone()
    started_rank.scatter_(1, walk, took | torch.gather(greedy, 1, walk))
    return torch.zeros_like(greedy).scatter(1, idx, started_rank)


def apply_starts(f: Forks, started: torch.Tensor) -> Forks:
    now = f.now[:, None]
    return f._replace(
        start=torch.where(started, now, f.start),
        end=torch.where(started, now + f.est, f.end),
        state=torch.where(started, RUNNING, f.state),
        free=f.free - torch.where(started, f.nodes, 0).sum(1).to(
            torch.int32))


def broadcast(mirror: Dict[str, np.ndarray], k: int, device) -> Forks:
    """k copies of one mirror (the dict ``mirror.Mirror.arrays`` gives)."""
    row = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(  # noqa
        device).expand(k, -1).contiguous()
    one = lambda v, dt: torch.full((k,), v, dtype=dt, device=device)  # noqa
    return Forks(row(mirror["submit"], torch.float32),
                 row(mirror["nodes"], torch.int32),
                 row(mirror["est"], torch.float32),
                 row(mirror["start"], torch.float32),
                 row(mirror["end"], torch.float32),
                 row(mirror["state"], torch.int32),
                 one(int(mirror["free"]), torch.int32),
                 one(int(mirror["total"]), torch.int32),
                 one(float(mirror["now"]), torch.float32))


def stack(mirrors: Sequence[Dict[str, np.ndarray]], device) -> Forks:
    """One fork for each mirror, in order."""
    row = lambda f, dt: torch.as_tensor(  # noqa: E731
        np.stack([np.asarray(m[f]) for m in mirrors]), dtype=dt).to(device)
    return Forks(row("submit", torch.float32), row("nodes", torch.int32),
                 row("est", torch.float32), row("start", torch.float32),
                 row("end", torch.float32), row("state", torch.int32),
                 row("free", torch.int32), row("total", torch.int32),
                 row("now", torch.float32))


def first_starts(mirrors: Sequence[Dict[str, np.ndarray]], pl: Pool,
                 chosen: Sequence[int], device) -> torch.Tensor:
    """The slots each mirror's chosen policy starts now (bool (n, J)): the
    first pass of a decision's member 0, which is the mirror itself."""
    f = stack(mirrors, device)
    idx = torch.as_tensor(list(chosen), dtype=torch.long)
    one = Pool(pl.family[idx], pl.theta[idx],
               tuple(pl.names[i] for i in chosen)).to(device)
    active = (f.state == QUEUED).any(1)
    return easy_pass(f, order(f, one)) & active[:, None]


class Drained(NamedTuple):
    forks: Forks
    first: torch.Tensor      # bool (k, J): starts at the decision instant
    dead: torch.Tensor       # bool (k,)


def drain(f: Forks, pl: Pool) -> Drained:
    """Run every fork to an empty queue: a pass at each event, then a move
    to the next predicted end, where the jobs ending then retire.  No new
    jobs arrive.  A fork whose queued job can never fit is deadlocked."""
    k, J = f.state.shape
    dead = torch.zeros(k, dtype=torch.bool, device=f.state.device)
    first = None
    for _ in range(J + 1):
        active = ~dead & (f.state == QUEUED).any(1)
        if not bool(active.any()):
            break
        started = easy_pass(f, order(f, pl)) & active[:, None]
        f = apply_starts(f, started)
        first = started if first is None else first
        running = f.state == RUNNING
        ends = torch.where(running, f.end, torch.inf)
        t_next = torch.maximum(ends.amin(1), f.now)
        finite = torch.isfinite(t_next)
        has_q = (f.state == QUEUED).any(1)
        go = active & has_q & finite
        dead = dead | (active & has_q & ~finite)
        ending = running & (f.end <= t_next[:, None]) & go[:, None]
        f = f._replace(
            state=torch.where(ending, DONE, f.state),
            free=f.free + torch.where(ending, f.nodes, 0).sum(1).to(
                torch.int32),
            now=torch.where(go, t_next, f.now))
    if first is None:
        first = torch.zeros_like(f.state, dtype=torch.bool)
    return Drained(f, first, dead)


# ----------------------------------------------------------------------
# Metrics, the paper's score, the CVaR of a fan.
# ----------------------------------------------------------------------
METRICS = ("avg_wait", "max_wait", "avg_slowdown", "max_slowdown",
           "makespan", "utilization")


def metrics(f: Forks, mask: torch.Tensor,
            runtime: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Per-fork metrics over the jobs in ``mask`` (waits in seconds)."""
    rt = f.est if runtime is None else runtime
    n = mask.sum(-1).clamp_min(1)
    wait = torch.where(mask, f.start - f.submit, 0.0).clamp_min(0.0)
    sd = ((wait + rt) / rt.clamp_min(SLOWDOWN_TAU)).clamp_min(1.0)
    sd = torch.where(mask, sd, 0.0)
    makespan = torch.where(mask, f.end, 0.0).amax(-1)
    node_s = torch.where(mask, f.nodes * rt, 0.0).sum(-1)
    span = (makespan - torch.where(mask, f.submit, torch.inf).amin(-1)
            ).clamp_min(1e-6)
    util = node_s / (f.total.to(torch.float32) * span)
    return {"avg_wait": wait.sum(-1) / n, "max_wait": wait.amax(-1),
            "avg_slowdown": sd.sum(-1) / n,
            "max_slowdown": torch.where(mask, sd, 1.0).amax(-1),
            "makespan": makespan, "utilization": util.clamp(0.0, 1.0)}


def score_terms(m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The paper's score, a quarter each of max and mean wait (minutes)
    and max and mean bounded slowdown, term by term."""
    return {"avg_slowdown": 0.25 * m["avg_slowdown"],
            "avg_wait": 0.25 * m["avg_wait"] * WT_SCALE,
            "max_slowdown": 0.25 * m["max_slowdown"],
            "max_wait": 0.25 * m["max_wait"] * WT_SCALE}


def score(m: Dict[str, torch.Tensor]) -> torch.Tensor:
    t = score_terms(m)
    return t["max_wait"] + t["max_slowdown"] + t["avg_wait"] \
        + t["avg_slowdown"]


def cvar(member_costs: torch.Tensor, alpha: float) -> torch.Tensor:
    """Mean of the worst ``max(1, ceil((1-alpha)·F))`` of the F members
    (axis 0)."""
    F = member_costs.shape[0]
    m = max(1, min(F, math.ceil((1.0 - alpha) * F)))
    return torch.sort(member_costs, dim=0).values[F - m:].mean(0)


def spread(member_costs: torch.Tensor):
    """(95% CI half-width of the member mean, worst − best) over axis 0;
    +inf where a member deadlocked."""
    F = member_costs.shape[0]
    fin = torch.isfinite(member_costs)
    safe = torch.where(fin, member_costs, 0.0)
    dev = safe - safe.mean(0, keepdim=True)
    ci = 1.96 * draws.sqrt_f32((dev * dev).mean(0)) / float(np.sqrt(F))
    width = member_costs.amax(0) - member_costs.amin(0)
    ok = fin.all(0)
    return (torch.where(ok, ci, torch.inf), torch.where(ok, width, torch.inf))


def cvar_alpha(goal: str) -> float:
    """The alpha of a ``cvar:<alpha>:score`` goal."""
    head, alpha, inner = goal.split(":")
    if head != "cvar" or inner != "score":
        raise ValueError(f"the reference decides cvar:<alpha>:score, not "
                         f"{goal!r}")
    return float(alpha)


# ----------------------------------------------------------------------
# A decision over a fan of perturbed futures.
# ----------------------------------------------------------------------
def decide_fan(mirror: Dict[str, np.ndarray], pl: Pool, fan: Dict,
               goal: str, device) -> Dict:
    """One decision on the mirror: F members × k policies, fork
    f = phi·k + p.  Member 0 is the mirror itself; member phi scales the
    walltime estimates by its lognormal factors and loses its failure
    draw's nodes.  Returns the per-policy costs (the CVaR of the member
    scores), their spread, the score terms of the
    member-mean metrics, the winner and its member-0 first starts."""
    alpha = cvar_alpha(goal)
    k, F = len(pl.names), int(fan["n"])
    J = len(mirror["state"])
    base = broadcast(mirror, F * k, device)
    phi = torch.arange(F, device=device)
    z, u = draws.member_draws(int(fan["seed"]), torch.zeros_like(phi), phi,
                              J)
    est = base.est[:1]
    sigma = float(fan.get("runtime_noise", 0.0))
    if sigma > 0.0:
        est_m = torch.where((phi == 0)[:, None], est,
                            est * draws.lognormal_scale(z, sigma))
        base = base._replace(est=est_m.repeat_interleave(k, 0))
    prob = float(fan.get("failure_prob", 0.0))
    if prob > 0.0:
        down = draws.failure_downs(prob, float(fan.get("failure_frac", 0.25)),
                                   phi, u, base.total[:F])
        down = down.repeat_interleave(k)
        base = base._replace(free=torch.clamp(base.free - down, min=0),
                             total=torch.clamp(base.total - down, min=1))
    res = drain(base, pl.to(device).tile(F))
    mask = base.state[0] == QUEUED
    m = {n: v.reshape(F, k) for n, v in metrics(res.forks, mask).items()}
    dead = res.dead.reshape(F, k)
    member = torch.where(dead, torch.inf, score(m))
    costs = cvar(member, alpha)
    ci, width = spread(member)
    mean = {n: v.mean(0) for n, v in m.items()}
    best = int(torch.argmin(costs))
    return {"names": pl.names, "costs": costs, "ci": ci, "width": width,
            "terms": score_terms(mean), "best": best,
            "run": res.first.reshape(F, k, J)[0, best]}


# ----------------------------------------------------------------------
# Trace replay of a (scenario × policy) grid.
# ----------------------------------------------------------------------
def replay(rows: Dict[str, torch.Tensor], pl: Pool) -> Dict:
    """Replay every scenario row under every pool member: fork f = s·P + p.
    Each step takes each live fork's next event (an arrival wins a tie
    with an end; simultaneous ends retire in start order), retires a
    completion at its TRUE end, and runs one pass whose reservation
    reasons over predicted ends.  Returns the final forks, deadlocks,
    events per fork, metrics over each scenario's jobs (true runtimes)
    and the score per (scenario, policy) with each scenario's winner."""
    P = len(pl.names)
    rep = lambda x: x.repeat_interleave(P, 0)                # noqa: E731
    submit, valid, true_rt = rep(rows["submit"]), rep(rows["valid"]), \
        rep(rows["true"])
    k, J = submit.shape
    dev = submit.device
    f = Forks(submit, rep(rows["nodes"]), rep(rows["est"]),
              torch.full((k, J), TIME_NONE, device=dev),
              torch.full((k, J), TIME_NONE, device=dev),
              torch.zeros((k, J), dtype=torch.int32, device=dev),
              rep(rows["total"]), rep(rows["total"]),
              torch.zeros(k, device=dev))
    tiled = pl.to(dev).tile(submit.shape[0] // P)
    arrival = torch.where(valid, submit, torch.inf)
    slots = torch.arange(J, device=dev)
    cursor = torch.zeros(k, dtype=torch.long, device=dev)
    true_end = torch.full((k, J), torch.inf, device=dev)
    start_ord = torch.full((k, J), INT32_MAX, dtype=torch.int64, device=dev)
    dead = torch.zeros(k, dtype=torch.bool, device=dev)
    events = torch.zeros(k, dtype=torch.int32, device=dev)
    for it in range(2 * J + 2):
        running = f.state == RUNNING
        queued_any = (f.state == QUEUED).any(1)
        cur = cursor.clamp(0, J - 1)
        next_arr = torch.where(cursor < J,
                               torch.gather(arrival, 1, cur[:, None])[:, 0],
                               torch.inf)
        work = torch.isfinite(next_arr) | running.any(1) | queued_any
        if not bool((work & ~dead).any()):
            break
        te = torch.where(running, true_end, torch.inf)
        next_end = te.amin(1)
        at_min = running & (te <= next_end[:, None])
        j_end = torch.argmin(torch.where(at_min, start_ord, INT32_MAX), 1)
        is_arr = next_arr <= next_end
        t_ev = torch.minimum(next_arr, next_end)
        has_event = torch.isfinite(t_ev)
        dead = dead | (~has_event & queued_any)
        live = has_event & ~dead
        arr = live & is_arr
        hit_arr = (slots[None, :] == cur[:, None]) & arr[:, None]
        fin = live & ~is_arr
        hit_end = (slots[None, :] == j_end[:, None]) & fin[:, None]
        f = f._replace(
            state=torch.where(hit_end, DONE,
                              torch.where(hit_arr, QUEUED, f.state)),
            end=torch.where(hit_end, true_end, f.end),
            free=f.free + torch.where(hit_end, f.nodes, 0).sum(1).to(
                torch.int32),
            now=torch.where(live, t_ev, f.now))
        cursor = cursor + arr.to(torch.long)
        started = easy_pass(f, order(f, tiled)) & live[:, None]
        f = apply_starts(f, started)
        true_end = torch.where(started, f.now[:, None] + true_rt, true_end)
        start_ord = torch.where(started, it * (J + 1) + slots[None, :],
                                start_ord)
        events = events + live.to(torch.int32)
    m = metrics(f, valid, true_rt)
    cost = torch.where(dead, torch.inf, score(m)).reshape(-1, P)
    return {"forks": f, "dead": dead, "events": events, "metrics": m,
            "costs": cost, "best": torch.argmin(cost, 1)}
