"""The paper's loop as a CLI: twin + PBS-emulator co-simulation.

    python -m repro_torch.launch.twin_loop                 # paper §4.1, on cuda
    python -m repro_torch.launch.twin_loop --device cpu \\
        --trace poisson --jobs 30 --nodes 16 --seed 3
    python -m repro_torch.launch.twin_loop --failures 2     # fault injection
    python -m repro_torch.launch.twin_loop \\
        --pool "extended,wfp:a=1..5x5:tau=600..7200x5"     # k=32 DRAS sweep

Port of the co-simulation mode of ``repro.launch.twin_loop``: same
flags, same trace generators and the same printed report.  ``--device``
(default ``cuda``) picks where the what-if engine runs; ``--backend
auto`` takes the CUDA kernel on ``cuda`` and the plain pass on ``cpu``.
The replay grid, training, fans, races, ensembles, chaos and snapshots
are not ported yet and are rejected.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from repro_torch.cluster.emulator import (ClusterEmulator, FailureSpec,
                                          RunReport)
from repro_torch.cluster.workload import (JobSpec, bursty_trace,
                                          paper_synthetic_trace,
                                          poisson_trace)
from repro_torch.core.engine import PASS_BACKENDS, DrainEngine
from repro_torch.core.events import EventBus
from repro_torch.core.objective import Objective, validate_objective
from repro_torch.core.policies import parse_pool
from repro_torch.core.twin import SchedTwin

#: Flags of the reference CLI whose modes are not ported yet, with the
#: ROADMAP item that brings each.
_UNPORTED = {"replay_grid": "--replay-grid (A5)", "train": "--train (A9)",
             "fan": "--fan (A7)", "race": "--race (A7)",
             "ensemble": "--ensemble (A6)", "chaos": "--chaos (A9)",
             "snapshot_dir": "--snapshot-dir (A9)"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="SchedTwin co-simulation on PyTorch (cuda or cpu)")
    ap.add_argument("--trace", choices=("paper", "poisson", "bursty"),
                    default="paper")
    ap.add_argument("--jobs", type=int, default=150)
    ap.add_argument("--nodes", type=int, default=32)
    ap.add_argument("--pool", default="paper",
                    help="pool grammar (policies.parse_pool), e.g. "
                         "'paper', 'extended', 'wfp:a=1..5x5'")
    ap.add_argument("--objective", default="score",
                    help="optimization goal grammar "
                         "(objective.parse_objective)")
    ap.add_argument("--failures", type=int, default=0)
    ap.add_argument("--budget-s", type=float, default=0.0, metavar="S",
                    help="wall-clock budget per decision cycle "
                         "(guard.DeadlineGuard)")
    ap.add_argument("--backend", choices=sorted(PASS_BACKENDS) + ["auto"],
                    default="auto",
                    help="scheduling-pass backend (auto: the CUDA kernel "
                         "on cuda, the plain pass on cpu)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the what-if engine runs")
    ap.add_argument("--seed", type=int, default=0)
    # reference modes not ported yet: accepted only to be rejected
    ap.add_argument("--replay-grid", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--train", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--fan", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--race", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--ensemble", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--chaos", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--snapshot-dir", default="", help=argparse.SUPPRESS)
    return ap


def make_trace(args) -> List[JobSpec]:
    if args.trace == "paper":
        return paper_synthetic_trace(seed=args.seed)
    if args.trace == "bursty":
        return bursty_trace(args.jobs, args.nodes, 8.0, (1, args.nodes),
                            (30.0, 900.0), seed=args.seed)
    return poisson_trace(args.jobs, args.nodes, 8.0, (1, args.nodes),
                         (30.0, 900.0), seed=args.seed)


def make_failures(args, trace: List[JobSpec]) -> List[FailureSpec]:
    rng = np.random.default_rng(args.seed)
    makespan_guess = len(trace) * 8.0
    return [FailureSpec(time=float(rng.uniform(0.2, 0.8) * makespan_guess),
                        nodes=max(1, args.nodes // 8), duration=300.0)
            for _ in range(args.failures)]


def co_simulate(args, engine: Optional[DrainEngine] = None):
    """Run the twin against the emulator; returns (report, twin, bus)."""
    engine = engine if engine is not None else DrainEngine(
        backend=args.backend, device=args.device)
    pool = parse_pool(args.pool)
    goal = validate_objective(args.objective)
    trace = make_trace(args)
    bus = EventBus()
    em = ClusterEmulator(trace, args.nodes, bus=bus,
                         failures=make_failures(args, trace),
                         check_invariants=True, engine=engine)
    twin = SchedTwin(
        bus=bus, qrun=em.qrun, total_nodes=args.nodes,
        max_jobs=em.max_jobs, pool=pool, objective=goal,
        free_nodes_probe=lambda: em.free_nodes,
        jobs_probe=em.jobs_view, guard=args.budget_s or None,
        engine=engine)
    report = em.run(on_event=twin.pump, objective=goal,
                    on_quiesce=twin.flush)
    return report, twin, bus


def print_report(report: RunReport, twin: SchedTwin, bus: EventBus) -> None:
    print(f"jobs={report.n_jobs} events={report.n_events} "
          f"restarts={report.n_restarts}")
    for k, v in report.metric_dict().items():
        print(f"  {k:14s} {v:10.2f}")
    if report.objective_cost is not None:
        print(f"objective cost ({report.objective}): "
              f"{report.objective_cost:.3f}")
    else:
        terms = " ".join(f"{t}={v:.2f}"
                         for t, v in (report.objective_terms or {}).items())
        print(f"objective terms ({report.objective}): {terms}")
    for name, terms in twin.telemetry.objective_breakdown().items():
        parts = " ".join(f"{t}={v:.2f}" for t, v in terms.items())
        print(f"  whatif breakdown {name:>10s}: {parts}")
    print("policy mix:", {k: f"{v:.1f}%" for k, v in
                          twin.telemetry.policy_start_distribution().items()})
    lat = twin.telemetry.cycle_latency_stats()
    print(f"cycle latency: mean {lat['mean_s'] * 1e3:.1f} ms, "
          f"p50 {lat['p50_s'] * 1e3:.1f} ms over {lat['n']} cycles")
    res = twin.telemetry.resilience_stats()
    print(f"resilience: miss_rate={res['miss_rate']:.3f} "
          f"(misses={res['deadline_misses']}/{res['cycles']}, "
          f"ladder_engaged={res['ladder_engaged']}, "
          f"max_level={res['max_level']}), ingest: "
          f"quarantined={res['quarantined']} dup={res['duplicates']} "
          f"reordered={res['reordered']} gaps={res['gaps']} "
          f"lost={res['lost']} resyncs={res['resyncs']} "
          f"read_retries={res['read_retries']}")
    print(f"bus health: {bus.health()}")


def main(argv: Optional[List[str]] = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    for dest, flag in _UNPORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            ap.error(f"{flag} is not yet ported to repro_torch")
    try:
        goal: Objective = validate_objective(args.objective)
    except ValueError as e:
        raise SystemExit(str(e))
    engine = DrainEngine(backend=args.backend, device=args.device)
    pool = parse_pool(args.pool)
    print(f"pool: k={len(pool)} forks "
          f"[{', '.join(pool.names[:8])}{', ...' if len(pool) > 8 else ''}] "
          f"backend={engine.backend} device={engine.device}")
    print(f"objective: {goal} ({type(goal).__name__})")
    report, twin, bus = co_simulate(args, engine)
    print_report(report, twin, bus)


if __name__ == "__main__":
    main()
