"""A what-if farm: one-shot ``DrainEngine.replay_grid`` over S traces ×
the configuration's pool, grid after grid over the same traces.

Set-up draws the traces from the seed in bulk and hands them to the
program as its own trace type (lists of ``JobSpec``), then runs one warm
grid.  A unit is one grid: the program stacks the traces into its
scenario tables (``workload.stack_scenarios``, which sizes the job table
to the traces: the ``stack`` span), replays every (scenario, policy)
fork, and the unit ends when the winners and costs are read back.

The check compares the last grid's scenario tables with the benchmark's
own stacking of the traces at the table's width, replays a seeded sample of its scenarios
with the plain reference (start and end times, deadlocks, events,
metrics, costs, winners), and holds every grid's winners and costs to
the last grid's.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from twinbench.compare import Check, bits_diff, rel_gap
from twinbench.gen import traces
from twinbench.reference import sim

FIELDS = ("submit", "nodes", "est", "true", "valid", "total")
METRICS = sim.METRICS


def setup(run):
    from repro_torch.cluster.workload import JobSpec
    from repro_torch.core.engine import DrainEngine
    from repro_torch.core.policies import normalize_pool

    cfg, tr = run.cell.config, run.cell.traffic
    if tr["goal"] != "score":
        raise ValueError("the reference scores a farm by the paper's score")
    rng = np.random.default_rng(run.seed)
    drawn = traces.draw(tr["traces"], rng, cfg["total_nodes"])
    S = drawn["nodes"].shape[0]
    cols = [drawn[k].tolist() for k in ("submit", "nodes", "est", "true")]
    pool = normalize_pool(cfg["pool"])
    st = SimpleNamespace(
        drawn=drawn,
        jobs=[[JobSpec(j, *job) for j, job in
               enumerate(zip(*(c[s] for c in cols)))] for s in range(S)],
        engine=DrainEngine(device=run.device),
        pool=pool.spec.to(run.device), cfg=cfg, goal=tr["goal"],
        device=run.device, last=None, grids=[])
    from twinbench.harness import Recorder
    unit(st, Recorder())
    return st


def unit(st, rec) -> None:
    from repro_torch.cluster.workload import stack_scenarios
    from repro_torch.kernels import policy_eval
    st.last = None
    if st.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = policy_eval.LAUNCHES
    t0 = time.perf_counter()
    scen = stack_scenarios(st.jobs, st.cfg["total_nodes"])
    t1 = time.perf_counter()
    out = st.engine.replay_grid(scen, st.pool, st.goal)
    best, costs = out.best.cpu(), out.costs.cpu()
    t2 = time.perf_counter()
    rec.span("unit", t2 - t0)
    rec.span("stack", t1 - t0)
    rec.count("k1", policy_eval.LAUNCHES - before)
    rec.count("forks", int(costs.numel()))
    if st.device == "cuda":
        rec.count("peak_bytes", torch.cuda.max_memory_allocated())
    st.last = (scen, out)
    st.grids.append((best.numpy(), costs.numpy()))


def program_outputs(st, sidx) -> Dict:
    scen, out = st.last
    S, P = out.costs.shape
    h = lambda x: x[sidx].detach().cpu().numpy()          # noqa: E731
    jobs = out.result.state.jobs
    fork = lambda x: x.reshape(S, P, -1)                   # noqa: E731
    return {
        "scen": {"submit": scen.submit_t, "nodes": scen.nodes,
                 "est": scen.est_runtime, "true": scen.true_runtime,
                 "valid": scen.valid, "total": scen.total_nodes},
        "inputs": {"submit": h(fork(jobs.submit_t)),
                   "nodes": h(fork(jobs.nodes)),
                   "est": h(fork(jobs.est_runtime))},
        "start": h(out.start_t), "end": h(out.end_t),
        "dead": h(out.deadlocked), "events": h(out.events),
        "metrics": {m: h(getattr(out.metrics, m)) for m in METRICS},
        "costs": h(out.costs), "best": h(out.best), "grids": st.grids}


def reference(cfg: Dict, rows: Dict[str, np.ndarray], sidx, device,
              quantize=None) -> Dict:
    """The reference's replay of the sampled scenarios; ``quantize``
    rounds every time of the traces (the control)."""
    rows = dict(rows)
    if quantize is not None:
        for f in ("submit", "est", "true"):
            rows[f] = quantize(rows[f])
    sub = {f: torch.as_tensor(rows[f][sidx]).to(device) for f in FIELDS}
    pl = sim.pool(cfg["pool"])
    P = len(pl.names)
    r = sim.replay(sub, pl)
    f = r["forks"]
    h = lambda x: x.detach().cpu().numpy()                 # noqa: E731
    fork = lambda x: h(x).reshape(len(sidx), P, -1)        # noqa: E731
    return {
        "scen": rows,
        "inputs": {"submit": fork(f.submit), "nodes": fork(f.nodes),
                   "est": fork(f.est)},
        "start": fork(f.start), "end": fork(f.end),
        "dead": h(r["dead"]).reshape(-1, P),
        "events": h(r["events"]).reshape(-1, P),
        "metrics": {m: h(v).reshape(-1, P) for m, v in r["metrics"].items()},
        "costs": h(r["costs"]), "best": h(r["best"])}


def compare(prog: Dict, ref: Dict, limits: Dict):
    """The cell's checks, the parts of ``exact_diff`` and the number of
    grids found wrong.  ``exact_diff`` counts what has to agree bit for
    bit and does not: scenario-table elements, the sampled forks' start
    and end times, deadlocks, event counts and winners, and every grid's
    winners and costs against the last grid's; ``cost_gap`` is the
    largest relative gap of a sampled fork's metric or cost."""
    parts = {
        "scenarios": (sum(bits_diff(prog["scen"][f], ref["scen"][f])
                          for f in FIELDS)
                      + sum(bits_diff(prog["inputs"][f], ref["inputs"][f])
                            for f in ref["inputs"])),
        "times": (bits_diff(prog["start"], ref["start"])
                  + bits_diff(prog["end"], ref["end"])),
        "forks": (bits_diff(prog["dead"], ref["dead"])
                  + bits_diff(prog["events"], ref["events"])),
        "winners": bits_diff(prog["best"], ref["best"])}
    gap = max([rel_gap(prog["metrics"][m], ref["metrics"][m])
               for m in METRICS] + [rel_gap(prog["costs"], ref["costs"])])
    checked_wrong = bool(sum(parts.values())
                         or not gap <= limits["cost_gap"])
    last_best, last_costs = prog["grids"][-1]
    drift = [bits_diff(b, last_best) + bits_diff(c, last_costs)
             for b, c in prog["grids"][:-1]]
    parts["drift"] = sum(drift)
    checks = [Check("exact_diff", sum(parts.values()), limits["exact_diff"]),
              Check("cost_gap", gap, limits["cost_gap"])]
    return checks, parts, int(checked_wrong) + sum(1 for d in drift if d)


def check(st, run) -> List[Check]:
    tr = run.cell.traffic
    S, J = st.last[0].valid.shape
    rows = traces.padded(st.drawn, J, st.cfg["total_nodes"])
    rng = np.random.default_rng([run.seed, 7])
    n = min(int(tr["check"]["scenarios"]), S)
    sidx = np.sort(rng.choice(S, n, replace=False))
    prog = program_outputs(st, sidx)
    st.last = st.engine = st.jobs = None
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    ref = reference(st.cfg, rows, sidx, run.device)
    checks, parts, bad = compare(prog, ref, tr["limits"])
    run.failed += bad
    run.extra["exact_parts"] = parts
    return checks
