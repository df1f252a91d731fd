"""SchedTwin as an accelerator-fleet scheduler.

The twin is architecture-agnostic: jobs here are training, prefill and
decode workloads of the ten model architectures, with pod footprints
from ``cluster.workload.arch_job_mix``.  A 32-pod fleet is scheduled
adaptively with a pod failure mid-run: the twin replans from the
NODEFAIL event, the victims restart, everything completes.

    python -m repro_torch.examples.fleet_twin [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.cluster.emulator import ClusterEmulator, FailureSpec
from repro_torch.cluster.workload import arch_job_mix
from repro_torch.core.engine import DrainEngine
from repro_torch.core.events import EventBus
from repro_torch.core.policies import EXTENDED_POOL
from repro_torch.core.twin import SchedTwin

TOTAL_PODS = 32


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    engine = DrainEngine(device=args.device)

    jobs = arch_job_mix(n_jobs=120, total_pods=TOTAL_PODS, seed=1,
                        mean_gap=25.0)
    print(f"fleet workload: {len(jobs)} jobs over {TOTAL_PODS} pods")
    by_class = {}
    for j in jobs:
        cls = j.tag.split(":")[1]
        by_class[cls] = by_class.get(cls, 0) + 1
    print("  job classes:", by_class)

    failures = [FailureSpec(time=900.0, nodes=4, duration=600.0)]  # 4 pods

    bus = EventBus()
    emulator = ClusterEmulator(jobs, TOTAL_PODS, bus=bus, failures=failures,
                               check_invariants=True, engine=engine)
    twin = SchedTwin(bus=bus, qrun=emulator.qrun, total_nodes=TOTAL_PODS,
                     max_jobs=emulator.max_jobs,
                     pool=EXTENDED_POOL,          # wider pool than the paper
                     free_nodes_probe=lambda: emulator.free_nodes,
                     ensemble=4, ensemble_noise=0.3,   # runtime uncertainty
                     engine=engine)
    report = emulator.run(on_event=twin.pump)

    print(f"\ncompleted {report.n_jobs} jobs, {report.n_restarts} "
          f"restarted after the pod failure")
    print(f"avg wait {report.avg_wait:8.1f} s   max wait "
          f"{report.max_wait:8.1f} s")
    print(f"avg slowdown {report.avg_slowdown:5.2f}   utilization "
          f"{report.utilization:.3f}")
    print("policy mix:", {k: f"{v:.0f}%" for k, v in
                          twin.telemetry.policy_start_distribution().items()})
    lat = twin.telemetry.cycle_latency_stats()
    print(f"decision latency p50 {lat['p50_s'] * 1e3:.1f} ms, "
          f"p95 {lat['p95_s'] * 1e3:.1f} ms over "
          f"{lat['n']} cycles (paper: 'a few seconds')")


if __name__ == "__main__":
    main()
