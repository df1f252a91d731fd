"""Physical-system side: PBS-like cluster emulator, workloads, failures."""
from repro_torch.cluster.emulator import ClusterEmulator, FailureSpec, RunReport
from repro_torch.cluster.workload import (JobSpec, Phase, ScenarioSet,
                                          arch_job_mix, bursty_trace,
                                          make_scenario,
                                          paper_synthetic_trace,
                                          poisson_trace, stack_scenarios,
                                          trace_to_arrays)
from repro_torch.cluster.chaos import (ChaosBus, ChaosSpec, DEFAULT_PROFILE,
                                       failure_storm)

__all__ = [
    "JobSpec", "Phase", "paper_synthetic_trace", "poisson_trace",
    "bursty_trace", "arch_job_mix", "trace_to_arrays", "ScenarioSet", "stack_scenarios",
    "make_scenario", "ClusterEmulator", "FailureSpec", "RunReport",
    "ChaosBus", "ChaosSpec", "DEFAULT_PROFILE", "failure_storm",
]
