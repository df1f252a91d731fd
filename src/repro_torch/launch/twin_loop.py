"""The paper's loop as a CLI: twin + PBS-emulator co-simulation.

    python -m repro_torch.launch.twin_loop                 # paper §4.1, on cuda
    python -m repro_torch.launch.twin_loop --device cpu \\
        --trace poisson --jobs 30 --nodes 16 --seed 3
    python -m repro_torch.launch.twin_loop --failures 2     # fault injection
    python -m repro_torch.launch.twin_loop \\
        --pool "extended,wfp:a=1..5x5:tau=600..7200x5"     # k=32 DRAS sweep
    python -m repro_torch.launch.twin_loop --replay-grid 8 \\
        --trace poisson --jobs 48 --pool extended          # S x P grid
    python -m repro_torch.launch.twin_loop --replay-grid 1024 \\
        --shard 0 --block-size 128 --prefetch 2            # fleet grid
    python -m repro_torch.launch.twin_loop --fan 64 --fan-noise 0.3 \\
        --objective "p95:avg_wait"     # Monte-Carlo fan, tail objective
    python -m repro_torch.launch.twin_loop --fan 64 --race --budget-ms 500
    python -m repro_torch.launch.twin_loop --ensemble 8
    python -m repro_torch.launch.twin_loop --replay-grid 8 --fan 128 \\
        --fan-fail 0.2 --objective "cvar:0.9:score" --prune
    python -m repro_torch.launch.twin_loop --chaos \\
        --snapshot-dir snap --kill-after-cycle 20   # crash mid-run ...
    python -m repro_torch.launch.twin_loop --chaos \\
        --snapshot-dir snap --resume                # ... and resume it
    python -m repro_torch.launch.twin_loop --train 24 --train-family lin \\
        --train-dir ckpt/policy       # learn θ (DESIGN.md §13) ...
    python -m repro_torch.launch.twin_loop --pool trained:ckpt/policy,paper

Port of ``repro.launch.twin_loop``: same flags, same trace generators
and the same printed report.  ``--replay-grid S`` skips the
co-simulation and evaluates the (S scenarios × pool) baseline grid in
one batched replay (``engine.replay_grid``), printing per-policy metrics
over the scenarios and each scenario's winner under ``--objective``.
``--fan F`` judges every policy over an on-device fan of F perturbed
futures (``--fan-noise``, ``--fan-burst``, ``--fan-fail``, keyed by
``--fan-seed``): in twin mode each decision gains confidence stamps, in
``--replay-grid`` mode the grid becomes S × F × P and ``--prune`` drops
dominated policies after a low-F pre-pass.  ``--race`` races the fan by
successive halving up to F_max = ``--fan`` (``--race-f0``,
``--budget-ms``, ``--race-members``); ``--ensemble N`` decides over N
estimate-noise members.  ``--chaos`` reads the bus through
``cluster.chaos.ChaosBus`` (drops, duplicates, reordering, corruption,
read failures); ``--snapshot-dir`` persists crash-safe twin snapshots
(every ``--snapshot-every`` cycles and at the end), ``--kill-after-cycle
K`` snapshots and exits after cycle K, and ``--resume`` continues from
the latest snapshot with the same flags.  ``--train G`` runs the policy
learner (``repro_torch.learn``) for G generations on a deterministic
scenario split instead of the co-simulation, checkpoints to
``--train-dir`` and scores the incumbent against ``--pool`` on the
held-out scenarios; ``--pool trained:<dir>`` deploys it.  ``--shard N``
(0: every local device), ``--block-size B`` and ``--prefetch D`` run a
``--replay-grid`` (fan or race too) through the fleet engine
(``core.whatif.sharded_*``): the scenario axis split over N shards and
streamed in blocks of B, the next block's ingest D blocks ahead on a
host thread; the grid is the same.  ``--device`` (default ``cuda``)
picks where the engine runs (with ``cpu``, ``--shard N`` runs N shards
on the host); ``--backend auto`` takes the CUDA kernel on ``cuda`` and
the plain pass on ``cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.cluster.chaos import DEFAULT_PROFILE, ChaosBus
from repro_torch.cluster.emulator import (ClusterEmulator, FailureSpec,
                                          RunReport)
from repro_torch.cluster.workload import (JobSpec, bursty_trace,
                                          paper_synthetic_trace,
                                          poisson_trace, split_scenarios)
from repro_torch.configs.schedtwin import ReplayGridConfig
from repro_torch.core.engine import BACKENDS, DrainEngine
from repro_torch.core.events import EventBus
from repro_torch.core.fan import FanSpec, pruned_fan_grid
from repro_torch.core.objective import Objective, validate_objective
from repro_torch.core.policies import parse_pool
from repro_torch.core.race import RaceSpec, race_grid
from repro_torch.core.twin import SchedTwin
from repro_torch.core.whatif import (sharded_fan_grid, sharded_race_grid,
                                     sharded_replay_grid)
from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh


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
    ap.add_argument("--ensemble", type=int, default=1,
                    help="decide over N estimate-noise members")
    ap.add_argument("--fan", type=int, default=0, metavar="F",
                    help="decide over an on-device Monte-Carlo fan of F "
                         "perturbed futures per policy; works in twin "
                         "mode and with --replay-grid")
    ap.add_argument("--fan-noise", type=float, default=0.3,
                    help="lognormal runtime-noise sigma for fan members "
                         "(mean-preserving; member 0 stays exact)")
    ap.add_argument("--fan-burst", type=float, default=0.0,
                    help="arrival-burst warp amplitude in [0,1) for fan "
                         "members (replay mode only)")
    ap.add_argument("--fan-fail", type=float, default=0.0,
                    help="per-member node-failure probability")
    ap.add_argument("--fan-seed", type=int, default=0,
                    help="fan PRNG seed (draws keyed per (scenario, "
                         "member))")
    ap.add_argument("--race", action="store_true",
                    help="race the --fan by successive halving up to "
                         "F_max = --fan")
    ap.add_argument("--race-f0", type=int, default=8, metavar="F0",
                    help="rung-0 fan size for --race (default 8)")
    ap.add_argument("--budget-ms", type=float, default=0.0, metavar="MS",
                    help="anytime wall-clock budget per race")
    ap.add_argument("--race-members", type=int, default=0, metavar="M",
                    help="anytime (scenario, member, policy) triple "
                         "budget per race")
    ap.add_argument("--prune", action="store_true",
                    help="goal-conditioned pool pruning for --replay-grid "
                         "--fan (low-F pre-pass, then the full fan on the "
                         "survivors)")
    ap.add_argument("--failures", type=int, default=0)
    ap.add_argument("--budget-s", type=float, default=0.0, metavar="S",
                    help="wall-clock budget per decision cycle "
                         "(guard.DeadlineGuard)")
    ap.add_argument("--chaos", action="store_true",
                    help="read the bus through cluster.chaos.ChaosBus "
                         "with the default fault profile (drops, dups, "
                         "reordering, corruption, transient read "
                         "failures)")
    ap.add_argument("--snapshot-dir", default="", metavar="DIR",
                    help="persist crash-safe twin snapshots (SimState, "
                         "consumer offset, PRNG key, telemetry, "
                         "emulator and bus state) under DIR")
    ap.add_argument("--snapshot-every", type=int, default=25, metavar="N",
                    help="snapshot every N decision cycles (with "
                         "--snapshot-dir; default 25)")
    ap.add_argument("--kill-after-cycle", type=int, default=0, metavar="K",
                    help="simulate a crash: snapshot and exit after "
                         "decision cycle K (requires --snapshot-dir); "
                         "rerun with --resume to continue")
    ap.add_argument("--resume", action="store_true",
                    help="resume the co-simulation from the latest "
                         "snapshot in --snapshot-dir (same flags as the "
                         "original run), or --train from --train-dir")
    ap.add_argument("--backend", choices=sorted(BACKENDS) + ["auto"],
                    default="auto",
                    help="engine backend: its order stage and pass "
                         "(auto: the CUDA kernels on cuda, their plain "
                         "versions on cpu)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the what-if engine runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replay-grid", type=int, default=0, metavar="S",
                    help="evaluate an S-scenario x pool baseline grid in "
                         "one batched replay instead of running the twin "
                         "co-simulation")
    ap.add_argument("--train", type=int, default=0, metavar="G",
                    help="train θ for G generations (repro_torch.learn) "
                         "instead of running the twin: each generation "
                         "is one batched replay grid with the candidate "
                         "population on the fork axis")
    ap.add_argument("--train-family", choices=("lin", "wfp", "expf"),
                    default="lin",
                    help="policy family whose θ is searched")
    ap.add_argument("--train-strategy", choices=("cem", "es"),
                    default="cem",
                    help="search strategy: cross-entropy (cem) or "
                         "evolution strategy (es)")
    ap.add_argument("--train-pop", type=int, default=16, metavar="N",
                    help="candidate population per generation")
    ap.add_argument("--train-scenarios", type=int, default=8, metavar="S",
                    help="training scenarios (drawn with --trace/--seed)")
    ap.add_argument("--train-heldout", type=int, default=4, metavar="S",
                    help="held-out scenarios for model selection and "
                         "early stopping")
    ap.add_argument("--train-dir", default="", metavar="DIR",
                    help="checkpoint directory for the trained policy "
                         "(deploy with --pool trained:DIR); empty trains "
                         "in memory only")
    ap.add_argument("--shard", type=int, default=1, metavar="N",
                    help="shard the --replay-grid scenario axis over N "
                         "devices (0: all local devices; with --device cpu "
                         "N host shards) via the fleet engine "
                         "(whatif.sharded_replay_grid)")
    ap.add_argument("--block-size", type=int, default=0, metavar="B",
                    help="stream the --replay-grid in blocks of B "
                         "scenarios (0: one shot); bounds device memory "
                         "at fleet scale")
    ap.add_argument("--prefetch", type=int, default=2, metavar="D",
                    help="host-side ingestion lookahead for block "
                         "streaming (0: ingest inline, no overlap)")
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


def make_fan(args) -> Optional[FanSpec]:
    """The ``FanSpec`` of the --fan* flags (None when off)."""
    if not args.fan:
        return None
    return FanSpec(n=args.fan, runtime_noise=args.fan_noise,
                   burst_amplitude=args.fan_burst,
                   failure_prob=args.fan_fail, seed=args.fan_seed)


def make_race(args) -> Optional[RaceSpec]:
    """The ``RaceSpec`` of --race/--race-f0/--budget-ms/--race-members
    over the --fan* spec (None when --race is off)."""
    if not args.race:
        return None
    return RaceSpec(fan=make_fan(args), f0=args.race_f0,
                    budget_ms=args.budget_ms or None,
                    max_members=args.race_members or None)


def co_simulate(args, engine: Optional[DrainEngine] = None):
    """Run the twin against the emulator; returns (report, twin, bus).
    With --snapshot-dir it snapshots as the reference does, with
    --resume it starts from the latest snapshot, and with
    --kill-after-cycle it raises ``SystemExit`` after that cycle."""
    engine = engine if engine is not None else DrainEngine(
        backend=args.backend, device=args.device)
    pool = parse_pool(args.pool)
    goal = validate_objective(args.objective)
    trace = make_trace(args)
    bus = EventBus()
    manager = (CheckpointManager(args.snapshot_dir) if args.snapshot_dir
               else None)
    app = None
    if args.resume:
        # the bus log is needed before the emulator and twin are built;
        # twin.restore() reads the rest of the same step
        step = manager.latest_step()
        if step is None:
            raise SystemExit(f"--resume: no snapshot under "
                             f"{args.snapshot_dir!r}")
        app = manager.manifest(step).get("extra", {}).get("app", {})
        bus = EventBus.from_dump(app.get("bus", []))
    em = ClusterEmulator(trace, args.nodes, bus=bus,
                         failures=make_failures(args, trace),
                         check_invariants=True, engine=engine)
    race = make_race(args)
    view = bus
    if args.chaos:
        view = ChaosBus(bus, dataclasses.replace(DEFAULT_PROFILE,
                                                 seed=args.seed))
        print(f"chaos: {view.spec}")
    twin = SchedTwin(
        bus=view, qrun=em.qrun, total_nodes=args.nodes,
        max_jobs=em.max_jobs, pool=pool, objective=goal,
        free_nodes_probe=lambda: em.free_nodes,
        jobs_probe=em.jobs_view, guard=args.budget_s or None,
        ensemble=args.ensemble, fan=None if race else make_fan(args),
        race=race, engine=engine)
    if args.resume:
        step, app = twin.restore(manager)
        em.restore_state(app["emulator"])
        print(f"resumed from snapshot step {step} "
              f"({len(twin.telemetry.cycles)} cycles already decided)")

    def take_snapshot():
        twin.snapshot(manager, app_extra={
            "emulator": em.snapshot_state(), "bus": bus.dump()})

    snap_next = [args.snapshot_every]

    def pump():
        twin.pump()
        cyc = len(twin.telemetry.cycles)
        if manager is not None and cyc >= snap_next[0]:
            take_snapshot()
            snap_next[0] = cyc + args.snapshot_every
        if args.kill_after_cycle and cyc >= args.kill_after_cycle:
            take_snapshot()
            raise SystemExit(
                f"killed after cycle {cyc} (snapshot persisted under "
                f"{args.snapshot_dir!r}; rerun with --resume)")

    report = em.run(on_event=pump, objective=goal, on_quiesce=twin.flush)
    if manager is not None:
        take_snapshot()
    return report, twin, bus


def print_report(report: RunReport, twin: SchedTwin, bus: EventBus,
                 race: Optional[RaceSpec] = None) -> None:
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
    conf = twin.telemetry.confidence_stats()
    if conf:
        # device-computed fan uncertainty; racing makes the fan size
        # vary per cycle, so the range actually used is reported
        fmin = min(st["min_fan"] for st in conf.values())
        fmax = max(st["max_fan"] for st in conf.values())
        f_txt = (f"F={fmin:.0f}" if fmin == fmax
                 else f"F={fmin:.0f}..{fmax:.0f}")
        parts = " ".join(
            f"{n}=±{st['mean_ci']:.2f}(w{st['mean_width']:.1f})"
            for n, st in sorted(conf.items()))
        print(f"fan confidence ({f_txt}, mean 95% CI half-width, "
              f"member spread): {parts}")
    if race is not None and twin.telemetry.cycles:
        cs = [c for c in twin.telemetry.cycles if c.race_stopped]
        if cs:
            memb = sum(c.race_members for c in cs)
            full = len(cs) * race.f_max * len(twin.pool)
            stops = {}
            for c in cs:
                stops[c.race_stopped] = stops.get(c.race_stopped, 0) + 1
            print(f"race: {memb} members over {len(cs)} cycles vs "
                  f"{full} fixed-F ({full / max(memb, 1):.1f}x "
                  f"reduction), mean {memb / len(cs):.1f}/cycle, "
                  f"stops {stops}")
    lat = twin.telemetry.cycle_latency_stats()
    print(f"cycle latency: mean {lat['mean_s'] * 1e3:.1f} ms, "
          f"p50 {lat['p50_s'] * 1e3:.1f} ms, "
          f"p95 {lat['p95_s'] * 1e3:.1f} ms over {lat['n']} cycles")
    res = twin.telemetry.resilience_stats()
    print(f"resilience: miss_rate={res['miss_rate']:.3f} "
          f"(misses={res['deadline_misses']}/{res['cycles']}, "
          f"ladder_engaged={res['ladder_engaged']}, "
          f"max_level={res['max_level']}), ingest: "
          f"quarantined={res['quarantined']} dup={res['duplicates']} "
          f"reordered={res['reordered']} gaps={res['gaps']} "
          f"lost={res['lost']} resyncs={res['resyncs']} "
          f"read_retries={res['read_retries']}")
    chaos = twin.bus.stats if isinstance(twin.bus, ChaosBus) else None
    print(f"bus health: {bus.health()}"
          + (f", chaos injected: {chaos}" if chaos is not None else ""))
    if twin.dead_letters:
        print(f"dead letters: {len(twin.dead_letters)} quarantined "
              f"(first: {twin.dead_letters[0].reason})")


def _host(t):
    return t.detach().cpu().numpy()


def fleet_mesh(args) -> Optional[FleetMesh]:
    """The mesh of --shard/--block-size (None: the one-shot grid).  On
    ``cuda`` the first N local cards (0: every one); on ``cpu`` N host
    shards (0: one)."""
    if args.shard == 1 and not args.block_size:
        return None
    if args.device == "cpu":
        return FleetMesh(["cpu"] * max(args.shard, 1))
    return make_fleet_mesh(None if args.shard == 0 else args.shard)


def raced_grid(args, engine: DrainEngine, goal: Objective, pool,
               scen) -> None:
    """--replay-grid --race: the raced S × F × P grid.  Eliminated
    policies never reach full fidelity, so the report is the race ledger
    (rungs, members, separation), not the per-policy metric table."""
    race = make_race(args)
    mesh = fleet_mesh(args)
    t0 = time.perf_counter()
    if mesh is not None:
        out = sharded_race_grid(mesh, engine=engine, objective=goal,
                                race=race,
                                block_size=args.block_size or None)(
            scen, pool.spec)
        mode = (f"{mesh.shape['data']} shard(s), "
                f"block={args.block_size or 'whole rung'}")
    else:
        out = race_grid(scen, pool.spec, race, goal, engine=engine)
        mode = "one device per rung"
    wall = time.perf_counter() - t0
    S = int(out.costs.shape[0])
    print(f"raced grid: S={S} scenarios x F_max={race.f_max} x "
          f"P={len(pool)} policies ({mode}) in {wall:.2f}s")
    print(f"members: {out.members} of {out.members_full} fixed-F "
          f"({out.members_full / max(out.members, 1):.1f}x reduction), "
          f"{len(out.rungs)} rungs, stopped={out.stopped}")
    for r in out.rungs:
        el = ([pool.names[i] for i in r.eliminated]
              if r.eliminated else "-")
        print(f"  rung [{r.lo:3d},{r.hi:3d}) x {len(r.active)} "
              f"policies: {r.members} members, sep={r.separation:+.2f}, "
              f"eliminated {el}")
    names = [pool.names[int(i)] for i in out.keep]
    print(f"survivors at F={out.fan_size}: {names}")
    print(f"objective {goal}: per-scenario winners "
          f"{[pool.names[int(b)] for b in out.best]}")


def replay_grid(args, engine: DrainEngine, goal: Objective) -> None:
    """--replay-grid: the S × P baseline grid as one batched replay, with
    the per-scenario policy selection under ``goal`` (S × F × P with
    --fan: every policy judged over F perturbed futures)."""
    cfg = ReplayGridConfig(scenarios=args.replay_grid, trace=args.trace,
                           n_jobs=args.jobs, total_nodes=args.nodes,
                           pool=args.pool, objective=goal, seed=args.seed,
                           backend=engine.backend, device=engine.device)
    pool = cfg.make_pool()
    scen = cfg.make_scenarios()
    if args.race:
        return raced_grid(args, engine, cfg.make_objective(), pool, scen)
    fan = make_fan(args)
    mesh = fleet_mesh(args)
    prune_info = None
    t0 = time.perf_counter()
    if mesh is not None:
        # the fleet engine: the scenario axis split over the mesh and
        # streamed in fixed-size blocks (DESIGN.md §§9-10)
        if fan is not None:
            run = sharded_fan_grid(mesh, engine=engine,
                                   objective=cfg.make_objective(), fan=fan,
                                   block_size=args.block_size or None)
        else:
            run = sharded_replay_grid(mesh, engine=engine,
                                      objective=cfg.make_objective(),
                                      block_size=args.block_size or None,
                                      prefetch_depth=args.prefetch)
        out = run(scen, pool.spec)
        mode = (f"{mesh.shape['data']} shard(s), "
                f"block={args.block_size or 'whole set'}, "
                f"prefetch={args.prefetch}")
    elif fan is not None and args.prune:
        out, prune_info = pruned_fan_grid(scen, pool.spec, fan,
                                          cfg.make_objective(),
                                          engine=engine)
        mode = "one device computation, pruned"
    elif fan is not None:
        out = engine.fan_grid(scen, pool.spec, fan, cfg.make_objective())
        mode = "one device computation"
    else:
        out = engine.replay_grid(scen, pool.spec, cfg.make_objective())
        mode = "one device computation"
    _host(out.end_t)                                       # wait for it
    wall = time.perf_counter() - t0
    S = int(out.deadlocked.shape[0])
    P = int(out.deadlocked.shape[-1])
    fan_txt = f" x F={fan.n} fan members" if fan is not None else ""
    print(f"replay grid: S={S} scenarios{fan_txt} x P={P} policies "
          f"({int(np.prod(out.deadlocked.shape))} forks, {mode}) "
          f"in {wall:.2f}s")
    names = pool.names
    if prune_info is not None:
        names = [pool.names[int(i)] for i in prune_info.keep]
        print(f"prune: pre-pass F={prune_info.pre_members.shape[1]} "
              f"dropped {prune_info.rate * 100:.0f}% of the pool; "
              f"kept {names}")
    print(f"{'policy':>16s} {'avg_wait':>9s} {'max_wait':>9s} "
          f"{'avg_sd':>7s} {'util':>6s} {'dead':>5s} {'picked':>7s}")
    # (S, P), or (S, F, P) under --fan: flattened to rows of P
    m = {k: _host(v).reshape(-1, P) for k, v in out.metrics._asdict().items()}
    dead, best = _host(out.deadlocked).reshape(-1, P), _host(out.best)
    for p, name in enumerate(names):
        print(f"{name:>16s} "
              f"{float(np.mean(m['avg_wait'][:, p])):9.1f} "
              f"{float(np.mean(m['max_wait'][:, p])):9.1f} "
              f"{float(np.mean(m['avg_slowdown'][:, p])):7.2f} "
              f"{float(np.mean(m['utilization'][:, p])):6.3f} "
              f"{int(dead[:, p].sum()):5d} "
              f"{int((best == p).sum()):4d}/{S}")
    if fan is not None:
        # device-computed per-policy uncertainty, scenario-averaged
        ci, wd = _host(out.cost_ci), _host(out.fan_width)
        parts = " ".join(
            f"{n}={np.mean(ci[:, p]):.2f}±w{np.mean(wd[:, p]):.1f}"
            for p, n in enumerate(names))
        print(f"fan confidence (mean 95% CI half-width ± member "
              f"spread): {parts}")
    print(f"objective {goal}: per-scenario winners "
          f"{[names[int(b)] for b in best]}")


def train_mode(args, engine: DrainEngine, goal: Objective,
               floor_pool) -> None:
    """--train: the learner on a deterministic scenario split,
    checkpointed to --train-dir, then the incumbent scored against the
    --pool statics on the held-out scenarios (the comparison ``--pool
    trained:<dir>,<statics>`` deploys live)."""
    from repro_torch.learn import TrainConfig, train

    rng = np.random.default_rng(args.seed)
    if args.trace == "paper":
        trace_fn = lambda r: paper_synthetic_trace(rng=r)  # noqa: E731
    elif args.trace == "bursty":
        trace_fn = lambda r: bursty_trace(  # noqa: E731
            args.jobs, args.nodes, 8.0, (1, args.nodes), (30.0, 900.0),
            rng=r)
    else:
        trace_fn = lambda r: poisson_trace(  # noqa: E731
            args.jobs, args.nodes, 8.0, (1, args.nodes), (30.0, 900.0),
            rng=r)
    train_scen, heldout = split_scenarios(
        rng, trace_fn, args.train_scenarios, args.train_heldout,
        args.nodes)
    cfg = TrainConfig(family=args.train_family,
                      strategy=args.train_strategy,
                      population=args.train_pop, generations=args.train,
                      objective=goal, seed=args.seed, fan=make_fan(args))
    print(f"train: {cfg.strategy}/{cfg.family} pop={cfg.population} x "
          f"{args.train_scenarios} train scenarios "
          f"(+{args.train_heldout} held-out), goal {goal}")
    t0 = time.perf_counter()
    res = train(train_scen, heldout, cfg, engine=engine,
                checkpoint_dir=args.train_dir or None,
                resume=args.resume, log_fn=print)
    wall = time.perf_counter() - t0
    print(f"trained {res.generations_run} generations in {wall:.1f}s"
          f"{' (early stop)' if res.stopped_early else ''}: "
          f"{res.best_desc}")

    # held-out scoreboard: the incumbent and the --pool statics in one
    # grid (within-pool, so rank-based goals compare like with like)
    board = res.pool + floor_pool
    costs = _host(engine.generation_costs(heldout, board.spec, goal))
    agg = np.asarray(costs, np.float64).mean(axis=0)
    print(f"{'policy':>16s} {'held-out cost':>14s}")
    for p, name in enumerate(board.names):
        mark = " <- trained" if p == 0 else ""
        print(f"{name:>16s} {agg[p]:14.4f}{mark}")
    if args.train_dir:
        print(f"deploy: --pool trained:{args.train_dir}"
              f"{',' + args.pool if args.pool else ''}")


def check_flags(ap: argparse.ArgumentParser, args) -> None:
    """Refuse the reference's flag combinations that do not apply."""
    if (args.shard != 1 or args.block_size or args.prefetch != 2) \
            and not args.replay_grid:
        ap.error("--shard/--block-size/--prefetch apply to --replay-grid")
    if args.replay_grid and (args.failures or args.ensemble > 1):
        ap.error("--replay-grid evaluates static baselines; --failures "
                 "and --ensemble do not apply (run the co-simulation "
                 "for those)")
    if args.fan and args.ensemble > 1:
        ap.error("--fan and --ensemble are mutually exclusive "
                 "(the fan subsumes the estimate-noise ensemble)")
    if args.prune and not (args.fan and args.replay_grid):
        ap.error("--prune applies to --replay-grid --fan")
    if args.race and not args.fan:
        ap.error("--race needs --fan F (F is the race's F_max)")
    if args.race and args.prune:
        ap.error("--race subsumes --prune (elimination is per rung)")
    if (args.race_f0 != 8 or args.budget_ms or args.race_members) \
            and not args.race:
        ap.error("--race-f0/--budget-ms/--race-members apply to --race")
    if args.replay_grid and (args.chaos or args.snapshot_dir
                             or args.budget_s):
        ap.error("--chaos/--snapshot-dir/--budget-s apply to the twin "
                 "co-simulation, not --replay-grid")
    if args.train:
        if args.replay_grid:
            ap.error("--train and --replay-grid are mutually exclusive")
        if (args.failures or args.ensemble > 1 or args.race
                or args.chaos or args.snapshot_dir or args.budget_s
                or args.prune or args.kill_after_cycle):
            ap.error("--train runs the learning loop; co-simulation and "
                     "racing flags do not apply")
        if args.resume and not args.train_dir:
            ap.error("--train --resume requires --train-dir")
    elif (args.train_dir or args.train_pop != 16
          or args.train_scenarios != 8 or args.train_heldout != 4):
        ap.error("--train-* flags apply to --train G")
    if (args.kill_after_cycle or args.resume) and not (
            args.snapshot_dir or args.train):
        ap.error("--kill-after-cycle/--resume require --snapshot-dir "
                 "(or --train --train-dir)")


def main(argv: Optional[List[str]] = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    check_flags(ap, args)
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
    if args.replay_grid:
        return replay_grid(args, engine, goal)
    if args.train:
        return train_mode(args, engine, goal, pool)
    report, twin, bus = co_simulate(args, engine)
    print_report(report, twin, bus, make_race(args))


if __name__ == "__main__":
    main()
