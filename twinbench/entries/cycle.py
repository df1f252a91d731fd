"""The live twin's decision cycle: events in, ``SchedTwin.pump()``, a
decision over a fan of futures, ``qrun`` out.

The window runs episodes of ``episode_cycles`` cycles, whole, so every
run measures the same mix of early and late cycles.  An episode draws its
backlog and its fan's seed from the run's seed and its number, builds a
twin on the configuration's cluster, job table and pool with the mix's
fan and goal, and publishes the backlog (the twin's job table gives every
job its own slot, so one twin holds one backlog).  The timed unit is one
cycle of the closed loop: the stand-in scheduler (``gen/scheduler.py``)
ends the running jobs due first, its events (with the RUNJOBs of the last
``qrun``) are published, and the cycle is timed from the first
publication to the ``qrun`` callback (or to ``pump``'s return when the
decision starts nothing).  Building an episode's twin is no part of a
cycle.  Set-up runs the mix's warm cycles in an episode of their own;
the traced window lies in the first cycle of an episode, the backlog as
published.

The check rebuilds each episode's mirror from its published events after
every cycle; holds every cycle's ``qrun`` set to the reference's first
pass of the program's winner on that mirror; and re-decides the sampled
cycles of the window with the plain reference on its own mirror: winner,
and each policy's cost, CI half-width, spread and score terms.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from twinbench.compare import Check, bits_diff, rel_gap
from twinbench.gen import scheduler, traces
from twinbench.reference import mirror, sim

TERMS = ("avg_slowdown", "avg_wait", "max_slowdown", "max_wait")


def draw_episode(cfg: Dict, tr: Dict, seed: int, e: int):
    """Episode ``e``'s stand-in scheduler (holding its backlog) and fan."""
    rng = np.random.default_rng([seed, e])
    backlog = traces.draw(dict(tr["backlog"], scenarios=1), rng,
                          cfg["total_nodes"])
    fan = dict(tr["fan"], seed=int(rng.integers(0, 2**31)))
    sched = scheduler.StandIn({k: v[0] for k, v in backlog.items()},
                              cfg["total_nodes"], tr["obits"])
    return sched, fan


def _episode(st) -> None:
    from repro_torch.core.events import EventBus
    from repro_torch.core.fan import FanSpec
    from repro_torch.core.twin import SchedTwin

    cfg, tr = st.cfg, st.tr
    sched, fan = draw_episode(cfg, tr, st.seed, len(st.fans))

    def on_qrun(jobs: List[int], t: float) -> None:
        st.t_qrun = time.perf_counter()
        sched.qrun(jobs, t)

    st.sched, st.cycles = sched, 0
    st.fans.append(fan)
    st.twin = SchedTwin(
        bus=EventBus(), qrun=on_qrun, total_nodes=cfg["total_nodes"],
        max_jobs=cfg["max_jobs"], pool=cfg["pool"], objective=tr["goal"],
        engine=st.engine, device=st.device,
        fan=FanSpec(n=fan["n"], runtime_noise=fan["runtime_noise"],
                    failure_prob=fan["failure_prob"], seed=fan["seed"]))


def setup(run):
    from repro_torch.core.engine import DrainEngine
    from twinbench.harness import Recorder

    st = SimpleNamespace(cfg=run.cell.config, tr=run.cell.traffic,
                         seed=run.seed, device=run.device, fans=[], log=[],
                         t_qrun=None, engine=DrainEngine(device=run.device))
    _episode(st)
    for _ in range(st.tr["warm_cycles"]):
        _cycle(st, Recorder())
    st.n_warm = len(st.log)
    return st


def unit(st, rec) -> int:
    """One episode: a fresh twin on the next backlog, run for its cycles."""
    _episode(st)
    for _ in range(st.tr["episode_cycles"]):
        _cycle(st, rec)
    return st.tr["episode_cycles"]


def _cycle(st, rec) -> None:
    from repro_torch.core.events import Event, EventKind
    from repro_torch.kernels import policy_eval
    if st.cycles:
        st.sched.finish_due()
    evs = st.sched.take()
    events = [Event(EventKind(k), t, j, p) for k, t, j, p in evs]
    twin = st.twin
    n_cycles = len(twin.telemetry.cycles)
    before = policy_eval.LAUNCHES
    st.t_qrun = None
    t0 = time.perf_counter()
    for ev in events:
        twin.bus.publish(ev)
    twin.pump()
    t1 = st.t_qrun or time.perf_counter()
    if len(twin.telemetry.cycles) != n_cycles + 1:
        raise RuntimeError("pump() ran no decision cycle")
    cyc = twin.telemetry.cycles[-1]
    rec.span("unit", t1 - t0)
    rec.span("decide", cyc.wall_seconds)
    rec.count("k1", policy_eval.LAUNCHES - before)
    st.cycles += 1
    st.log.append((len(st.fans) - 1, evs, twin.state, cyc))


def _mirror(state) -> Dict[str, np.ndarray]:
    j = state.jobs
    h = lambda x: x.detach().cpu().numpy()       # noqa: E731
    return {"submit": h(j.submit_t), "nodes": h(j.nodes),
            "est": h(j.est_runtime), "start": h(j.start_t),
            "end": h(j.end_t), "state": h(j.state),
            "free": h(state.free_nodes), "total": h(state.total_nodes),
            "now": h(state.now)}


def _decision(cyc) -> Dict:
    names = list(cyc.costs)
    return {"names": tuple(names),
            "costs": np.array([cyc.costs[n] for n in names], np.float32),
            "ci": np.array([cyc.cost_ci[n] for n in names], np.float32),
            "width": np.array([cyc.fan_width[n] for n in names], np.float32),
            "terms": {t: np.array([cyc.term_costs[n][t] for n in names],
                                  np.float32) for t in TERMS},
            "best": names.index(cyc.policy)}


def reference(cfg: Dict, tr: Dict, episodes, fans, chosen, device,
              winners=None, quantize=None) -> Dict:
    """The reference's mirror after every cycle, its decisions at the
    ``chosen`` cycles, and every cycle's ``qrun`` set under ``winners``
    (by default its own, which needs every cycle chosen).  ``episodes``
    holds each cycle's episode and events, ``fans`` each episode's fan;
    ``quantize`` rounds every time the mirror holds (the control)."""
    mirrors = []
    m, at = None, None
    for e, evs in episodes:
        if e != at:
            m, at = mirror.Mirror(cfg["max_jobs"], cfg["total_nodes"]), e
        for ev in evs:
            m.apply(*ev)
        arr = m.arrays()
        if quantize is not None:
            for f in ("submit", "est", "start", "end", "now"):
                arr[f] = quantize(arr[f])
        mirrors.append(arr)
    pl = sim.pool(cfg["pool"])
    h = lambda x: x.detach().cpu().numpy()       # noqa: E731
    decisions = {}
    for i in chosen:
        d = sim.decide_fan(mirrors[i], pl, fans[episodes[i][0]], tr["goal"],
                           device)
        decisions[i] = {
            "names": d["names"], "costs": h(d["costs"]), "ci": h(d["ci"]),
            "width": h(d["width"]),
            "terms": {t: h(v) for t, v in d["terms"].items()},
            "best": d["best"]}
    if winners is None:
        winners = [decisions[i]["best"] for i in range(len(mirrors))]
    run = h(sim.first_starts(mirrors, pl, winners, device))
    return {"mirrors": mirrors, "decisions": decisions,
            "winners": list(winners),
            "runs": [np.nonzero(r)[0].tolist() for r in run]}


def compare(prog: Dict, ref: Dict, limits: Dict):
    """The cell's checks, the parts of ``exact_diff`` and the number of
    cycles found wrong.  ``exact_diff`` counts what has to agree bit for
    bit and does not: mirror elements and ``qrun`` jobs after every
    cycle, winners of the checked cycles; ``cost_gap`` is the largest
    relative gap of a checked policy's cost, CI half-width, spread or
    score term."""
    bad = set()
    parts = {"mirror": 0, "winner": 0, "qrun": 0}
    for i, (p, r) in enumerate(zip(prog["mirrors"], ref["mirrors"])):
        d = sum(bits_diff(p[f], r[f]) for f in r)
        q = len(set(prog["runs"][i]) ^ set(ref["runs"][i]))
        parts["mirror"] += d
        parts["qrun"] += q
        if d or q:
            bad.add(i)
    parts["mirror"] += abs(len(prog["mirrors"]) - len(ref["mirrors"]))
    gap = 0.0
    for i, r in ref["decisions"].items():
        p = prog["decisions"][i]
        w = int(p["names"] != r["names"]) + int(p["best"] != r["best"])
        g = max([rel_gap(p[k], r[k]) for k in ("costs", "ci", "width")]
                + [rel_gap(p["terms"][t], r["terms"][t]) for t in TERMS])
        parts["winner"] += w
        gap = max(gap, g)
        if w or not g <= limits["cost_gap"]:
            bad.add(i)
    checks = [Check("exact_diff", sum(parts.values()), limits["exact_diff"]),
              Check("cost_gap", gap, limits["cost_gap"])]
    return checks, parts, len(bad)


def check(st, run) -> List[Check]:
    cfg, tr = run.cell.config, run.cell.traffic
    window = list(range(st.n_warm, st.n_warm + run.attempted))
    rng = np.random.default_rng([run.seed, 7])
    n = min(int(tr["check"]["cycles"]), len(window))
    chosen = sorted(int(i) for i in rng.choice(window, n, replace=False))
    prog = {"mirrors": [_mirror(s) for _, _, s, _ in st.log],
            "winners": [list(c.costs).index(c.policy)
                        for _, _, _, c in st.log],
            "runs": [sorted(c.started_jobs) for _, _, _, c in st.log],
            "decisions": {i: _decision(st.log[i][3]) for i in chosen}}
    episodes = [(e, evs) for e, evs, _, _ in st.log]
    st.twin = st.engine = st.log = None
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cfg, tr, episodes, st.fans, chosen, run.device,
                    winners=prog["winners"])
    checks, parts, bad = compare(prog, ref, tr["limits"])
    run.failed += bad
    run.extra["exact_parts"] = parts
    return checks
