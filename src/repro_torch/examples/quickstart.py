"""Quickstart: SchedTwin on PyTorch, end to end.

Builds the paper's §4.1 setup — a PBS-like 32-node cluster emulator, a
four-phase synthetic workload and the real-time digital twin — runs the
co-simulation and prints the adaptive-vs-static comparison, after the
replay grids (one-shot and fleet-streamed), a Monte-Carlo fan, a race,
a chaos run and a short training run.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from repro_torch.cluster import ClusterEmulator, paper_synthetic_trace
from repro_torch.cluster.chaos import DEFAULT_PROFILE, ChaosBus
from repro_torch.cluster.workload import split_scenarios, stack_scenarios
from repro_torch.core import EventBus, SchedTwin
from repro_torch.core.engine import DrainEngine
from repro_torch.core.fan import FanSpec
from repro_torch.core.policies import FCFS, SJF, WFP, parse_pool, policy_name
from repro_torch.core.race import RaceSpec, race_grid
from repro_torch.core.scoring import radar_report
from repro_torch.core.whatif import sharded_replay_grid
from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh
from repro_torch.learn import TrainConfig, train


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    engine = DrainEngine(device=args.device)
    trace = paper_synthetic_trace(seed=0)          # 150 jobs, 4 phases

    # --- static baselines (the schedulers the paper compares against) --
    # fast=True replays the whole trace as one batched device replay
    # (bitwise the per-event host loop, DESIGN.md §6)
    per_policy = {}
    for pid in (FCFS, WFP, SJF):
        emulator = ClusterEmulator(trace, total_nodes=32, engine=engine)
        report = emulator.run(policy_id=pid, fast=True)
        per_policy[policy_name(pid)] = report.metric_dict()

    # --- a whole (scenario x policy) grid in one shot ------------------
    # S traces x the 7-policy pool: one batched replay, per-(s, p)
    # metrics; the objective (DESIGN.md §8) drives the per-scenario
    # selection — here: minimize avg wait subject to >= 70% utilization.
    scenarios = stack_scenarios([paper_synthetic_trace(seed=s)
                                 for s in range(4)], total_nodes=32)
    pool7 = parse_pool("extended")
    grid = engine.replay_grid(scenarios, pool7.spec,
                              "min:avg_wait@util>=0.7")
    print("grid avg_wait (S=4 x P=7):\n",
          grid.metrics.avg_wait.cpu().numpy())
    print("per-scenario picks:", [pool7.names[int(b)] for b in grid.best])

    # --- fleet scale: the same grid, sharded + streamed ----------------
    # The fleet engine (DESIGN.md §9) splits the SCENARIO axis over the
    # local devices and streams it in fixed-size blocks, the host-side
    # ingest of block i+1 overlapping the replay of block i
    # (prefetch_depth); bitwise replay_grid, for any S (inert padding
    # fills the last block).  CLI:
    #     python -m repro_torch.launch.twin_loop --replay-grid 1024 \
    #         --shard 0 --block-size 128 --prefetch 2
    mesh = (make_fleet_mesh() if args.device == "cuda"
            else FleetMesh(["cpu"]))
    fleet = sharded_replay_grid(mesh, engine=engine,
                                objective="min:avg_wait@util>=0.7",
                                block_size=2, prefetch_depth=2)
    big = stack_scenarios([paper_synthetic_trace(seed=s)
                           for s in range(6)], total_nodes=32)
    out = fleet(big, pool7.spec)
    print("fleet picks (S=6, blocks of 2):",
          [pool7.names[int(b)] for b in out.best])

    # --- risk-aware: a Monte-Carlo fan of perturbed futures ------------
    # F perturbed futures per (scenario, policy) grown on the device from
    # the one uploaded base (runtime noise, node failures; member 0
    # exact), selected by a distributional goal (DESIGN.md §10).  CLI:
    # twin_loop --fan 256 --fan-noise 0.3 [--prune]
    fan = engine.fan_grid(
        scenarios, pool7.spec,
        FanSpec(n=64, runtime_noise=0.3, failure_prob=0.1),
        "cvar:0.9:avg_wait")
    print("risk-averse picks (S=4, F=64 futures):",
          [pool7.names[int(b)] for b in fan.best])
    print("p0 CI half-widths:", np.round(fan.cost_ci[0].cpu().numpy(), 1))

    # --- adaptive fan racing: pay only for open decisions --------------
    # Every policy starts at f0 members; policies whose CI clears the
    # incumbent's are eliminated and survivors' fans double up to F_max,
    # each rung replaying only the new member suffix (DESIGN.md §11).
    # CLI: twin_loop --fan 64 --race --race-f0 4 [--budget-ms 500]
    race = race_grid(scenarios, pool7.spec,
                     RaceSpec(fan=FanSpec(n=64, runtime_noise=0.3,
                                          failure_prob=0.1), f0=4),
                     "cvar:0.9:avg_wait", engine=engine)
    print(f"raced picks ({race.members} of {race.members_full} members, "
          f"{len(race.rungs)} rungs, stopped={race.stopped}):",
          [pool7.names[int(b)] for b in race.best])

    # --- the twin: simulation-in-the-loop adaptive scheduling ----------
    # ``pool`` takes the sweep grammar (DESIGN.md §5), e.g.
    #     pool="extended,wfp:a=1..5x5:tau=600..7200x5"   # k=32 forks
    # and ``objective`` the administrator's goal (DESIGN.md §8).
    bus = EventBus()
    emulator = ClusterEmulator(trace, total_nodes=32, bus=bus,
                               engine=engine)
    twin = SchedTwin(bus=bus, qrun=emulator.qrun,     # §3.5 feedback
                     total_nodes=32, max_jobs=emulator.max_jobs,
                     pool="paper", objective="score", engine=engine,
                     free_nodes_probe=lambda: emulator.free_nodes)
    report = emulator.run(on_event=twin.pump)         # ①→⑦ per event
    per_policy["SchedTwin"] = report.metric_dict()

    # --- resilience: chaos on the twin's reads (DESIGN.md §12) ---------
    # CLI: twin_loop --chaos --budget-s 1.0 --snapshot-dir CK [--resume]
    bus = EventBus()
    emulator = ClusterEmulator(trace, total_nodes=32, bus=bus,
                               engine=engine)
    view = ChaosBus(bus, DEFAULT_PROFILE)             # chaos on reads only
    twin2 = SchedTwin(bus=view, qrun=emulator.qrun, total_nodes=32,
                      max_jobs=emulator.max_jobs, guard=1.0, engine=engine,
                      free_nodes_probe=lambda: emulator.free_nodes,
                      jobs_probe=emulator.jobs_view)  # loss -> resync
    report2 = emulator.run(on_event=twin2.pump, on_quiesce=twin2.flush)
    stats = twin2.telemetry.resilience_stats()
    print(f"\nchaos survival: {report2.n_jobs} jobs, "
          f"injected={dict(view.stats)}")
    print(f"quarantined={stats['quarantined']} resyncs={stats['resyncs']} "
          f"miss_rate={stats['miss_rate']:.3f} "
          f"ladder_engaged={stats['ladder_engaged']}")

    # --- train, then deploy: closing the θ loop (DESIGN.md §13) --------
    # Full walkthrough: python -m repro_torch.examples.train_policy
    rng = np.random.default_rng(0)
    tr, held = split_scenarios(rng, lambda r: paper_synthetic_trace(rng=r),
                               n_train=3, n_heldout=2, total_nodes=32)
    res = train(tr, held, TrainConfig(family="lin", population=8,
                                      generations=4, objective="avg_wait",
                                      seed=0),
                engine=engine)
    print(f"\ntrained {res.best_desc}: held-out {res.best_heldout:.1f} "
          f"({res.generations_run} generations)")

    # --- Figure-3-style comparison --------------------------------------
    areas = radar_report(per_policy)
    print(f"{'method':10s} {'radar area':>10s} {'avg wait':>9s} "
          f"{'max wait':>9s} {'util':>6s}")
    for name, m in per_policy.items():
        print(f"{name:10s} {areas[name]:10.2f} {m['avg_wait']:9.1f} "
              f"{m['max_wait']:9.1f} {m['utilization']:6.3f}")
    print("\npolicy mix (Table 1):",
          twin.telemetry.policy_start_distribution())
    print("cycle latency:", twin.telemetry.cycle_latency_stats())


if __name__ == "__main__":
    main()
