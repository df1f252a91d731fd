"""Train a scheduler on the twin, then deploy it — end to end.

The θ loop (DESIGN.md §13): a CEM population of candidate policy
parameters rides the fork axis of one batched replay grid per
generation.  Static fixed points warm-start generation 0, held-out
scenarios gate acceptance, and the result is checkpointed where the
pool grammar (``trained:<ckpt>``) deploys it live.

    python -m repro_torch.examples.train_policy [--device cpu] [--ckpt DIR]

Without ``--ckpt`` the checkpoint goes to a temporary directory that is
removed at the end.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional

import numpy as np

from repro_torch.cluster import ClusterEmulator, paper_synthetic_trace
from repro_torch.cluster.workload import split_scenarios
from repro_torch.core import EventBus, SchedTwin
from repro_torch.core.engine import DrainEngine
from repro_torch.core.policies import parse_pool
from repro_torch.learn import TrainConfig, train


def run(engine: DrainEngine, ckpt: str) -> None:
    # --- scenarios: one rng, deterministic train/held-out split --------
    rng = np.random.default_rng(0)
    train_scen, heldout = split_scenarios(
        rng, lambda r: paper_synthetic_trace(rng=r),
        n_train=6, n_heldout=3, total_nodes=32)

    # --- train: CEM over the linear-scorer family ----------------------
    # Each generation = one replay grid: (train scenarios) x (population
    # + warm-start statics on the fork axis).  Fitness is any DESIGN.md
    # §8 objective; pass fan=FanSpec(...) to train on Monte-Carlo fans.
    res = train(train_scen, heldout,
                TrainConfig(family="lin", strategy="cem", population=16,
                            generations=12, objective="avg_wait", seed=0),
                engine=engine, checkpoint_dir=ckpt, log_fn=print)
    print(f"\ntrained {res.label}: {res.best_desc}")
    print(f"held-out cost {res.best_heldout:.2f} "
          f"({res.generations_run} generations"
          f"{', stopped early' if res.stopped_early else ''})")

    # --- score it against the paper's static pool on held-out ----------
    board = res.pool + parse_pool("paper")
    costs = np.asarray(engine.generation_costs(
        heldout, board.spec, "avg_wait").cpu().numpy(), np.float64)
    print("\nheld-out avg_wait (mean over scenarios):")
    for name, c in zip(board.names, costs.mean(axis=0)):
        print(f"  {name:14s} {c:8.2f}")

    # --- deploy: the checkpoint IS a pool term -------------------------
    # CLI: python -m repro_torch.launch.twin_loop --pool trained:<ckpt>,paper
    bus = EventBus()
    emulator = ClusterEmulator(paper_synthetic_trace(seed=7),
                               total_nodes=32, bus=bus, engine=engine)
    twin = SchedTwin(bus=bus, qrun=emulator.qrun, total_nodes=32,
                     max_jobs=emulator.max_jobs,
                     pool=f"trained:{ckpt},paper", objective="avg_wait",
                     free_nodes_probe=lambda: emulator.free_nodes,
                     engine=engine)
    report = emulator.run(on_event=twin.pump)
    print(f"\nlive deploy ({report.n_jobs} jobs): policy mix",
          twin.telemetry.policy_start_distribution())


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt", default="", metavar="DIR",
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args(argv)
    engine = DrainEngine(device=args.device)
    if args.ckpt:
        return run(engine, args.ckpt)
    with tempfile.TemporaryDirectory(prefix="schedtwin_trained_") as ckpt:
        run(engine, ckpt)


if __name__ == "__main__":
    main()
